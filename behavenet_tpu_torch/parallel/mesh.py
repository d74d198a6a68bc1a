"""A 1-D device mesh for one controlling process (the port of
``behavenet_tpu/parallel/mesh.py:23 make_mesh``).

The JAX package drives every device of a ``jax.sharding.Mesh`` from one
Python call; the port keeps that API. A :class:`Mesh` is an ordered list
of ``torch.device``s, one per shard: shard i of a sharded axis lives on
``devices[i]``. A device may repeat, and then its shards run one after
another on it (an n-way mesh on one card, or ``'cpu'`` n times, as the CPU
tests run it). There is no process group: what crosses between shards is
copied with ``Tensor.to``.
"""

import contextlib

import torch

__all__ = ['Mesh', 'make_mesh', 'on_device', 'per_device']


class Mesh:
    """``devices`` (a sequence of ``torch.device`` or names, one per shard)
    along the one axis ``axis_names[0]``; what the JAX code reads of a
    ``jax.sharding.Mesh``: ``axis_names``, ``shape[axis]`` and ``size``
    (JAX's ``mesh.devices.size``)."""

    def __init__(self, devices, axis_names=('sp',)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError('a Mesh has one axis, got %s' % (self.axis_names,))
        if not self.devices:
            raise ValueError('a Mesh needs at least one device')
        self.shape = {self.axis_names[0]: len(self.devices)}

    @property
    def size(self):
        """The number of shards."""
        return len(self.devices)


def make_mesh(n_devices=None, axis_name='dp'):
    """A mesh over the first ``n_devices`` CUDA devices (default: all), one
    shard each, as JAX's ``make_mesh`` takes the first devices; raises when
    there is no CUDA device or fewer than ``n_devices``. A mesh that repeats
    a device or names ``'cpu'`` is built with :class:`Mesh` directly."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError('make_mesh: no CUDA device is available; build a Mesh of '
                           '"cpu" devices to run on the CPU')
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError('make_mesh: asked for %s devices, %d are available' % (n_devices, count))
    return Mesh(['cuda:%d' % i for i in range(n)], (axis_name,))


def on_device(device):
    """The context in which a shard's launches run on ``device``:
    ``torch.cuda.device(device)`` for a CUDA device (the kernels launch on
    the current device's stream), nothing for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == 'cuda' else contextlib.nullcontext()


def per_device(fn, items, *per_item):
    """[fn(item, *its entries of ``per_item``) for each of ``items``] (each
    with a ``device``: a shard or an EM part), each call under
    ``on_device(item.device)``."""
    out = []
    for item, *rest in zip(items, *per_item):
        with on_device(item.device):
            out.append(fn(item, *rest))
    return out
