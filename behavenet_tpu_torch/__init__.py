"""BehaveNet in PyTorch on NVIDIA Hopper: the port of ``behavenet_tpu``.

The package mirrors ``behavenet_tpu``'s module names so each piece sits
beside its JAX counterpart. It imports ``torch`` and never ``jax`` or
``behavenet_tpu``: what it needs from the JAX package's numpy-only modules
it keeps as its own copy.

So far it serves a fitted conv autoencoder (``serving.load_version``):
``encode`` and ``reconstruct`` on raw uint8 frames, with the convolutions
run by hand-written CUDA kernels (``kernels/``) on a GPU. Entry points run
on ``'cuda'`` unless the caller passes ``device='cpu'``.
"""

__version__ = '0.1.0'
