"""The device an entry point of the port runs on."""

import torch

__all__ = ['resolve_device']


def resolve_device(device=None):
    """``None`` means ``'cuda'``. A CUDA device with no GPU present raises:
    the port never falls back to the CPU unless the caller asks for it.
    ``'tpu'`` (the JAX package's compute configs) raises too."""
    if device == 'tpu':
        raise ValueError('device "tpu" is the JAX package\'s; the PyTorch port runs '
                         'on device "cuda" (the default) or "cpu"')
    dev = torch.device('cuda' if device is None else device)
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError('the port runs on "cuda" or "cpu", not %r' % (device,))
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           'to run on the CPU')
    return dev
