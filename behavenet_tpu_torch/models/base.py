"""Checkpoint io in the JAX package's format, and the model protocol.

``best_val_model.pt`` as the JAX package writes it
(behavenet_tpu/models/base.py:87-107) is a pickle of
``{'params': numpy pytree, **extra}``: nested dicts of numpy arrays keyed by
the JAX layer names (``encoder/conv_0/w`` in HWIO, ...). The port reads and
writes that file as it is; ``utils/weights.py`` turns the pytree into the
port's state dict.
"""

import pickle

import numpy as np
import torch.nn as nn

__all__ = ['save_params', 'load_params', 'BaseModel']


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_params(params, filepath, extra=None):
    """Write a numpy parameter pytree as the JAX package's checkpoint."""
    payload = {'params': _to_numpy(params)}
    if extra is not None:
        payload.update(extra)
    with open(filepath, 'wb') as f:
        pickle.dump(payload, f)


def load_params(filepath):
    """Read a checkpoint written by :func:`save_params` or by the JAX
    package; returns (numpy params pytree, dict of the other entries)."""
    with open(filepath, 'rb') as f:
        payload = pickle.load(f)
    params = _to_numpy(payload['params'])
    return params, {k: v for k, v in payload.items() if k != 'params'}


class BaseModel(nn.Module):
    """Protocol of the port's models.

    Subclasses are built from an hparams dict, hold their weights as
    parameters named as the reference's torch modules name them, and define
    ``forward(x) -> outputs`` on NHWC batches.
    """

    model_class = None

    def forward(self, x):
        raise NotImplementedError
