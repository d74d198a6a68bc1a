"""The port's full-covariance Gaussian NLL (value and gradients) against the
JAX package's ``gaussian_neg_log_prob``.

``behavenet_tpu_torch.ops.losses.gaussian_neg_log_prob`` runs its plain
pieces on the CPU (the arithmetic K12 holds on the card for a per-frame
covariance with d <= 16; ``torch.linalg`` for a shared one and for d > 16)
and is held against ``jax.value_and_grad`` of the JAX function, compiled
once per case (at LLVM optimization level 0: the same XLA program, built in
a third of the time for the unrolled d = 16 factor). Covariances are
``M M^T / d + I / 2`` (condition number below ~10), so float32 in two
operation orders agrees to ~1e-7: values
within rtol 1e-5, gradients within 1e-5 of max|JAX|. For d <= 16 JAX's
gradient in ``cov`` is lower-triangular (its unrolled Cholesky reads only
the lower triangle), for d = 17 symmetric (``jnp.linalg.cholesky``
symmetrizes); the port gives each.
"""

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import losses as jlosses
from behavenet_tpu_torch.ops import losses as tlosses

B = 12


def _inputs(d, shared, seed=0):
    rs = np.random.RandomState(seed)
    y_pred = rs.randn(B, d).astype(np.float32)
    y_true = rs.randn(B, d).astype(np.float32)
    m = rs.randn(d, d) if shared else rs.randn(B, d, d)
    cov = (m @ np.swapaxes(m, -1, -2) / d + 0.5 * np.eye(d)).astype(np.float32)
    fm = np.ones(B, np.float32)
    fm[:3] = 0.0     # a lag border and bucket padding
    fm[-2:] = 0.0
    return y_pred, y_true, cov, fm


def _jax(y_pred, y_true, cov, fm):
    def f(a, c):
        return jlosses.gaussian_neg_log_prob(a, y_true, c, frame_mask=fm)
    compiled = jax.jit(jax.value_and_grad(f, argnums=(0, 1))).lower(y_pred, cov).compile(
        {'xla_backend_optimization_level': 0})
    value, (g_y, g_cov) = compiled(y_pred, cov)
    return float(value), np.asarray(g_y), np.asarray(g_cov)


def _port(y_pred, y_true, cov, fm):
    a = torch.from_numpy(y_pred).requires_grad_()
    c = torch.from_numpy(cov).requires_grad_()
    loss = tlosses.gaussian_neg_log_prob(
        a, torch.from_numpy(y_true), c, None if fm is None else torch.from_numpy(fm))
    loss.backward()
    return loss.item(), a.grad.numpy(), c.grad.numpy()


@pytest.mark.parametrize('d,shared,masked', [
    (3, False, False), (3, False, True), (9, False, True), (16, False, True),
    (17, False, True), (3, True, False), (9, True, True)],
    ids=['d3', 'd3-mask', 'd9-mask', 'd16-mask', 'd17-mask', 'shared-d3',
         'shared-d9-mask'])
def test_value_and_grads_match_jax(d, shared, masked):
    y_pred, y_true, cov, fm = _inputs(d, shared)
    fm = fm if masked else None
    want, want_gy, want_gc = _jax(y_pred, y_true, cov, fm)
    got, got_gy, got_gc = _port(y_pred, y_true, cov, fm)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_gy, want_gy, rtol=0, atol=1e-5 * np.abs(want_gy).max())
    np.testing.assert_allclose(got_gc, want_gc, rtol=0, atol=1e-5 * np.abs(want_gc).max())
    # the gradient convention of each branch, as JAX's
    upper = np.triu(np.ones((d, d), bool), 1)
    if shared or d > 16:
        np.testing.assert_allclose(got_gc, np.swapaxes(got_gc, -1, -2), rtol=0,
                                   atol=1e-6 * np.abs(got_gc).max())
    else:
        assert (got_gc[..., upper] == 0).all()
    if masked and not shared:
        assert (got_gc[fm == 0] == 0).all() and (got_gy[fm == 0] == 0).all()


def test_masked_rows_cannot_give_nans():
    """Padding's covariance is garbage; a masked row's is replaced by I."""
    y_pred, y_true, cov, fm = _inputs(4, False, seed=1)
    cov[fm == 0] = np.nan
    got, got_gy, got_gc = _port(y_pred, y_true, cov, fm)
    clean = _port(y_pred[fm > 0], y_true[fm > 0], cov[fm > 0], None)
    np.testing.assert_allclose(got, clean[0], rtol=1e-6)
    assert np.isfinite(got_gy).all() and np.isfinite(got_gc).all()
    assert (got_gc[fm == 0] == 0).all()


def test_cuda_path_is_the_kernel_or_nothing(monkeypatch):
    """On a tensor the dispatcher takes for the card's, the forward and
    backward are K12's wrappers (routed here to the plain versions with a
    count); the wrappers themselves refuse CPU tensors."""
    calls = []

    def counted(fn, name):
        def wrapper(*args):
            calls.append(name)
            return fn(*args)
        return wrapper
    monkeypatch.setattr(tlosses, 'gaussian_neg_log_prob_cuda',
                        counted(tlosses.gaussian_neg_log_prob_plain, 'fwd'))
    monkeypatch.setattr(tlosses, 'gaussian_neg_log_prob_grad_cuda',
                        counted(tlosses.gaussian_neg_log_prob_grad_plain, 'bwd'))
    y_pred, y_true, cov, fm = _inputs(5, False, seed=2)
    want = _port(y_pred, y_true, cov, fm)
    monkeypatch.setattr(tlosses, '_on_cpu', lambda t: False)
    got = _port(y_pred, y_true, cov, fm)
    assert calls == ['fwd', 'bwd']
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.undo()
    t = [torch.from_numpy(a) for a in (y_pred, y_true, cov)]
    with pytest.raises(ValueError, match='CUDA'):
        tlosses.gaussian_neg_log_prob_cuda(*t)
    with pytest.raises(ValueError, match='data'):
        tlosses.gaussian_neg_log_prob(t[0], t[1].requires_grad_(), t[2])
