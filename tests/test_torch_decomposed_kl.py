"""The port's KL terms against the JAX package's.

``decomposed_kl`` (forward, and its backward written out as K7 computes it)
and its plain autograd twin against ``behavenet_tpu.ops.losses.decomposed_kl``
and ``jax.grad``; ``gaussian_ll`` and ``kl_div_to_std_normal`` against theirs.
Tolerance: float32 sums of B * D terms in another order, rtol 1e-5 (atol
1e-5 beside it for values near zero); gradients within 1e-5 of their largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import losses as jlosses
from behavenet_tpu_torch.ops import losses as tlosses
from tests.jax_low import jit_low


def _inputs(b, d, masked, seed=0):
    rs = np.random.RandomState(seed)
    z = rs.randn(b, d).astype(np.float32)
    mu = (z + 0.5 * rs.randn(b, d)).astype(np.float32)
    lv = (0.5 * rs.randn(b, d)).astype(np.float32)
    fm = None
    if masked:   # the last rows are padding, as in a bucketed trial
        fm = np.ones(b, np.float32)
        fm[-max(1, b // 8):] = 0.0
    return z, mu, lv, fm



def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a.copy()).requires_grad_(grad)


def _assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30))


UP = np.array([0.7, -1.3, 2.1], np.float32)   # upstream dMI, dTC, dDWKL
CASES = [(b, d, masked) for b in (8, 40) for d in (1, 3, 8) for masked in (False, True)]


@pytest.fixture(scope='module')
def jax_refs():
    """(b, d, masked) -> JAX's terms and their gradients in z, mu and
    logvar at upstream UP, every case from one program."""
    def all_cases(inputs):
        out = {}
        for case in CASES:
            z, mu, lv, fm = inputs[case]

            def jf(z_, mu_, lv_, fm=fm):
                terms = jlosses.decomposed_kl(z_, mu_, lv_, frame_mask=_j(fm))
                return sum(float(u) * t for u, t in zip(UP, terms)), terms
            out[case] = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(z, mu, lv)
        return out
    return jit_low(all_cases, {case: _inputs(*case) for case in CASES})


@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('d', [1, 3, 8])
@pytest.mark.parametrize('b', [8, 40])
def test_decomposed_kl_and_grads_match_jax(b, d, masked, jax_refs):
    z, mu, lv, fm = _inputs(b, d, masked)
    up = UP
    (_, ref), ref_g = jax_refs[b, d, masked]

    zt, mut, lvt = _t(z, True), _t(mu, True), _t(lv, True)
    terms = tlosses.decomposed_kl(zt, mut, lvt, _t(fm))
    np.testing.assert_allclose([t.item() for t in terms], np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    sum(float(u) * t for u, t in zip(up, terms)).backward()
    _assert_grads([zt.grad.numpy(), mut.grad.numpy(), lvt.grad.numpy()], ref_g)

    # the plain version under autograd gives the same gradients
    zp, mup, lvp = _t(z, True), _t(mu, True), _t(lv, True)
    plain = tlosses.decomposed_kl_plain(zp, mup, lvp, _t(fm))
    sum(float(u) * t for u, t in zip(up, plain)).backward()
    _assert_grads([zp.grad.numpy(), mup.grad.numpy(), lvp.grad.numpy()], ref_g)


def test_padded_rows_drop_out_and_get_no_gradient():
    """A padded batch gives the unpadded batch's terms, finite, and its
    padded rows get zero gradients."""
    z, mu, lv, _ = _inputs(12, 4, False, seed=3)
    fm = np.ones(16, np.float32)
    fm[12:] = 0.0
    pad = np.full((4, 4), 50.0, np.float32)   # far-off junk in the padded rows
    zt, mut, lvt = (_t(np.concatenate([a, pad]), True) for a in (z, mu, lv))
    padded = tlosses.decomposed_kl(zt, mut, lvt, _t(fm))
    unpadded = tlosses.decomposed_kl(_t(z), _t(mu), _t(lv))
    np.testing.assert_allclose([t.item() for t in padded], [t.item() for t in unpadded],
                               rtol=1e-5, atol=1e-5)
    sum(padded).backward()
    for g in (zt.grad, mut.grad, lvt.grad):
        assert torch.isfinite(g).all()
        assert torch.equal(g[12:], torch.zeros_like(g[12:]))


@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
def test_kl_div_to_std_normal_matches_jax(masked):
    _, mu, lv, fm = _inputs(16, 5, masked, seed=1)
    ref = jlosses.kl_div_to_std_normal(jnp.asarray(mu), jnp.asarray(lv),
                                       frame_mask=_j(fm))
    got = tlosses.kl_div_to_std_normal(_t(mu), _t(lv), _t(fm))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize('masks,masked,uint8', [
    (False, False, False), (True, True, False), (False, True, True)],
    ids=['plain', 'masks_fm', 'uint8_fm'])
def test_gaussian_ll_and_grad_match_jax(masks, masked, uint8):
    rs = np.random.RandomState(2)
    shape = (8, 6, 5, 2)
    y = rs.rand(*shape).astype(np.float32)
    t = rs.randint(0, 256, shape).astype(np.uint8) if uint8 \
        else rs.rand(*shape).astype(np.float32)
    m = (rs.rand(*shape) > 0.3).astype(np.float32) if masks else None
    fm = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32) if masked else None
    jt = jnp.asarray(t, jnp.float32) / 255.0 if uint8 else jnp.asarray(t)
    ref, ref_g = jit_low(jax.value_and_grad(
        lambda a: jlosses.gaussian_ll(jt, a, _j(m), frame_mask=_j(fm))), y)
    yt = torch.from_numpy(y).requires_grad_()
    ll = tlosses.gaussian_ll(yt, torch.from_numpy(t), _t(m), frame_mask=_t(fm))
    ll.backward()
    np.testing.assert_allclose(ll.item(), float(ref), rtol=1e-6)
    _assert_grads([yt.grad.numpy()], [ref_g])


def test_kernel_wrappers_refuse_what_they_do_not_take():
    z = torch.zeros(8, 3)
    with pytest.raises(ValueError, match='CUDA'):
        tlosses.decomposed_kl_cuda(z, z, z)
    with pytest.raises(ValueError, match='frame_mask'):
        tlosses.decomposed_kl(z, z, z, torch.ones(8, requires_grad=True))
