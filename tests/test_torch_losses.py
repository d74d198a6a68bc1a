"""The port's masked MSE (value and gradient) against the JAX package's.

``behavenet_tpu_torch.ops.losses.mse`` runs its plain pieces on the CPU (the
arithmetic kernel K5 holds on the card) and is held against
``jax.value_and_grad(behavenet_tpu.ops.losses.mse)``. Tolerance: float32,
rtol 1e-5 on the loss and atol 1e-7 * max(1, |ref|) plus rtol 1e-4 on the
gradient (sums of a few thousand squares in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import losses as jlosses
from behavenet_tpu_torch.ops import losses as tlosses

SHAPE = (6, 8, 7, 2)


def _inputs(seed, masks, frame_mask, uint8):
    rng = np.random.RandomState(seed)
    y = rng.rand(*SHAPE).astype(np.float32)
    t = rng.randint(0, 256, SHAPE).astype(np.uint8) if uint8 \
        else rng.rand(*SHAPE).astype(np.float32)
    m = (rng.rand(*SHAPE) > 0.3).astype(np.float32) if masks else None
    fm = np.array([1, 1, 0, 1, 1, 0], np.float32) if frame_mask else None
    return y, t, m, fm


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize('masks', [False, True])
@pytest.mark.parametrize('frame_mask', [False, True])
@pytest.mark.parametrize('uint8', [False, True])
def test_mse_value_and_grad_match_jax(masks, frame_mask, uint8):
    y, t, m, fm = _inputs(0, masks, frame_mask, uint8)
    jt = jnp.asarray(t, jnp.float32) / 255.0 if uint8 else jnp.asarray(t)
    ref, ref_g = jax.value_and_grad(
        lambda a: jlosses.mse(a, jt, _j(m), frame_mask=_j(fm)))(jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_()
    loss = tlosses.mse(yt, _t(t), _t(m), _t(fm))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-7 * max(1.0, np.abs(ref_g).max()))


@pytest.mark.parametrize('frame_mask', [False, True])
def test_sigmoid_output_grad_is_the_sigmoid_inputs(frame_mask):
    """With ``sigmoid_output`` the gradient is the sigmoid input's, as JAX
    differentiates ``mse(sigmoid(u), t)``."""
    rng = np.random.RandomState(1)
    u = rng.randn(*SHAPE).astype(np.float32)
    _, t, _, fm = _inputs(2, False, frame_mask, True)
    jt = jnp.asarray(t, jnp.float32) / 255.0
    ref, ref_g = jax.value_and_grad(
        lambda a: jlosses.mse(jax.nn.sigmoid(a), jt, frame_mask=_j(fm)))(jnp.asarray(u))
    ut = torch.from_numpy(u).requires_grad_()
    y = torch.sigmoid(ut).detach().requires_grad_()
    loss = tlosses.mse(y, _t(t), None, _t(fm), sigmoid_output=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-7 * max(1.0, np.abs(ref_g).max()))


def test_padded_batch_loss_is_the_unpadded_loss():
    y, t, _, _ = _inputs(3, False, False, True)
    fm = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    padded = tlosses.mse(torch.from_numpy(y), torch.from_numpy(t), frame_mask=fm)
    unpadded = tlosses.mse(torch.from_numpy(y[:4]), torch.from_numpy(t[:4]))
    np.testing.assert_allclose(padded.item(), unpadded.item(), rtol=1e-6)


def test_targets_get_no_gradient():
    y = torch.rand(SHAPE, requires_grad=True)
    with pytest.raises(ValueError, match='data'):
        tlosses.mse(y, torch.rand(SHAPE, requires_grad=True))


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        tlosses.mse_cuda(torch.rand(SHAPE), torch.rand(SHAPE))
