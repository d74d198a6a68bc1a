"""Load pickled models written by either package, without the JAX one.

The JAX package's ARHMM CLI pickles its model into ``best_val_model.pt``
(``behavenet_tpu/fitting/arhmm_grid_search.py:188``): an instance of
``behavenet_tpu.models.arhmm.ARHMM`` whose state holds only numpy arrays and
builtins (its ``__getstate__``). :class:`Unpickler` maps that class to the
port's :class:`~behavenet_tpu_torch.models.arhmm.ARHMM` and refuses every
other name of ``behavenet_tpu``, ``jax`` or ``jaxlib``, so loading never
imports them.
"""

import pickle

__all__ = ['Unpickler', 'load', 'load_arhmm']

_MAPPED = {('behavenet_tpu.models.arhmm', 'ARHMM'):
           ('behavenet_tpu_torch.models.arhmm', 'ARHMM')}
_REFUSED = ('behavenet_tpu', 'jax', 'jaxlib')


class Unpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that reads the JAX package's ARHMM as the port's."""

    def find_class(self, module, name):
        module, name = _MAPPED.get((module, name), (module, name))
        if module.split('.')[0] in _REFUSED:
            raise pickle.UnpicklingError(
                'the pickle needs %s.%s, which the port does not load' % (module, name))
        return super().find_class(module, name)


def load(path, device=None):
    """Unpickle ``path`` with :class:`Unpickler`; an ARHMM in it comes back
    with its parameters on ``device`` (``None`` means ``'cuda'``)."""
    from behavenet_tpu_torch.models.arhmm import UNPICKLE_DEVICE
    token = UNPICKLE_DEVICE.set(device)
    try:
        with open(path, 'rb') as f:
            return Unpickler(f).load()
    finally:
        UNPICKLE_DEVICE.reset(token)


def load_arhmm(path, device=None):
    """A fitted ARHMM (``best_val_model.pt`` of either package's ARHMM CLI)
    as the port's ``ARHMM`` on ``device`` (``None`` means ``'cuda'``), in
    the dtype it was fitted in (a float64 model's parameters stay float64)."""
    from behavenet_tpu_torch.models.arhmm import ARHMM
    model = load(path, device=device)
    if not isinstance(model, ARHMM):
        raise TypeError('%s holds a %s, not an ARHMM' % (path, type(model).__name__))
    return model
