"""Initializers, checkpoint io in the JAX package's format, and the model
protocol.

``best_val_model.pt`` as the JAX package writes it
(behavenet_tpu/models/base.py:87-107) is a pickle of
``{'params': numpy pytree, **extra}``: nested dicts of numpy arrays keyed by
the JAX layer names (``encoder/conv_0/w`` in HWIO, ...). The port reads and
writes that file as it is; ``utils/weights.py`` turns the pytree into the
port's state dict and back.

The initializers draw torch's default init, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weights and biases, as the JAX package's do
(behavenet_tpu/models/base.py:22-58), from an explicit ``torch.Generator``:
the distribution is the JAX package's, the numbers are not.
"""

import pickle

import numpy as np
import torch
import torch.nn as nn

__all__ = ['uniform_fan_in_', 'init_conv', 'init_conv_transpose', 'init_linear',
           'init_batch_norm',
           'init_diag_linear', 'diag_linear', 'orthogonal_matrix', 'params_finite',
           'save_params', 'load_params', 'BaseModel']


def uniform_fan_in_(t, fan_in, generator):
    """Fill ``t`` in place from U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / np.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def init_conv(weight, bias, generator):
    """torch Conv2d's default init of a weight (O, I, kh, kw) and its bias:
    fan_in = I * kh * kw."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    uniform_fan_in_(weight, fan_in, generator)
    uniform_fan_in_(bias, fan_in, generator)


def init_conv_transpose(weight, bias, generator):
    """torch ConvTranspose2d's default init of a weight (I, O, kh, kw) and
    its bias: torch computes fan_in from dim 1, so fan_in = O * kh * kw."""
    init_conv(weight, bias, generator)


def init_linear(weight, bias, generator):
    """torch Linear's default init of a weight (out, in) and its bias:
    fan_in = in."""
    uniform_fan_in_(weight, weight.shape[1], generator)
    uniform_fan_in_(bias, weight.shape[1], generator)


def init_batch_norm(layer):
    """A batch-norm layer's init (JAX: models/aes.py:51 _init_bn): gamma 1,
    beta 0 and, when it tracks running statistics, mean 0, variance 1 and a
    batch count of 0. It draws nothing, so the other layers' draws keep
    their order."""
    with torch.no_grad():
        layer.weight.fill_(1.0)
        layer.bias.zero_()
        if layer.track:
            layer.running_mean.zero_()
            layer.running_var.fill_(1.0)
            layer.num_batches_tracked.zero_()


def init_diag_linear(weight, bias, generator):
    """The diagonal map ``y = x * d + b`` of the PS-VAE's label head (JAX:
    models/base.py:61; reference base.py:70 DiagLinear): both (dim,) from
    U(-1/sqrt(dim), 1/sqrt(dim))."""
    uniform_fan_in_(weight, weight.shape[0], generator)
    uniform_fan_in_(bias, weight.shape[0], generator)


def diag_linear(x, weight, bias):
    """Apply the diagonal map (JAX: models/base.py:71)."""
    return x * weight + bias


def orthogonal_matrix(dim, seed):
    """The fixed random orthogonal (dim, dim) float32 matrix of the PS-VAE's
    heads, drawn exactly as the JAX package draws it
    (behavenet_tpu/models/vaes.py:207-210), so both packages get the same
    bits from one ``rng_seed_model``."""
    from scipy.stats import ortho_group
    rng = np.random.RandomState(seed)
    return ortho_group.rvs(dim=dim, random_state=rng).astype(np.float32)


def params_finite(params):
    """True when every leaf of a (nested dict) parameter pytree is finite."""
    if isinstance(params, dict):
        return all(params_finite(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return bool(torch.isfinite(params).all())
    return bool(np.isfinite(np.asarray(params)).all())


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
