"""Device meshes and time-sharded message passing (the port of
``behavenet_tpu/parallel/mesh.py``'s ``make_mesh`` and of
``behavenet_tpu/parallel/seq.py``'s HMM passes)."""

from behavenet_tpu_torch.parallel.mesh import Mesh, make_mesh, on_device, per_device  # noqa: F401
