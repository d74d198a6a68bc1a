"""The ARHMM M-step's weighted sums (``behavenet_tpu_torch.models.arhmm``
``mstep_stats`` / ``mstep_cov``, K31's plain versions), the recurrent and
dof M-steps (``recurrent_mstep`` / ``nu_mstep``, K40's and K41's plain
versions) and the port's ``ARHMM._m_step`` against the JAX package's, on
the CPU, in float32 and in float64, at K = 3 states, D = 3 and three trials
of unequal length (20, 14, 17 frames: the mask, the padding and the
wrapped lag history all run).

The JAX references are the JAX package's own contraction formulas
(``behavenet_tpu/models/arhmm.py:504-546``, ``_make_lagged``) and its
``ARHMM._m_step``, run on the same numpy arrays; float64 ones inside
``jax.enable_x64(True)`` (never ``jax.config.update``: pytest-xdist runs
many test files in one worker process). Tolerances: float32, max |d| within 1e-5 of the largest
entry of the reference (sums of up to 51 products in another order);
float64, within 1e-12 of it. ``_m_step``'s parameters: float32 within 1e-5
of each parameter's largest entry (the solve and the nu Newton steps
after the sums), float64 within 1e-10. With recurrent transitions JAX's
``_m_step`` also runs ``_m_step_recurrent`` (25 Adam steps on the pairwise
posteriors of its own E-step; the port's come from its plain E-step), held
there to atol 1e-5 for ``log_Ps``, ``Rs`` and ``r`` in float32 (the Adam
steps amplify the two E-steps' roundoff), and as above in float64; the dofs
as above in both (the float32 ones differ by 3.5e-6 of the largest).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.models.arhmm import _make_lagged
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.models import arhmm
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.ops import hmm
from tests.jax_low import compile_low

K, D = 3, 3
LENGTHS = (20, 14, 17)
T_MAX = max(LENGTHS)
DTYPES = {'float32': (np.float32, torch.float32, 1e-5),
          'float64': (np.float64, torch.float64, 1e-12)}
# case -> (lags, diagonal, robust, ragged)
CASES = {'ar': (1, False, False, True), 'ar_lags2': (2, False, False, True),
         'gaussian': (0, False, False, True), 'diagonal_ar': (1, True, False, True),
         'robust_ar': (1, False, True, True), 'unmasked': (1, False, False, False)}


def x64(dtype):
    """JAX's x64 mode for a float64 reference, nothing for a float32 one."""
    return jax.enable_x64(True) if dtype == 'float64' else contextlib.nullcontext()


def make_inputs(np_dtype, lags, ragged, seed=0):
    """x (N, T, D) zero past each trial's length, mask (N, T), gammas (N, T,
    K) normalized over states, tau (N, T, K) and beta (K, D lags + 1, D)."""
    rs = np.random.RandomState(seed)
    N = len(LENGTHS)
    lengths = LENGTHS if ragged else (T_MAX,) * N
    mask = (np.arange(T_MAX)[None] < np.array(lengths)[:, None]).astype(np_dtype)
    x = (rs.randn(N, T_MAX, D) * mask[:, :, None]).astype(np_dtype)
    g = rs.rand(N, T_MAX, K) + 0.1
    gammas = (g / g.sum(axis=2, keepdims=True) * mask[:, :, None]).astype(np_dtype)
    tau = (0.5 + rs.rand(N, T_MAX, K)).astype(np_dtype)
    beta = (0.3 * rs.randn(K, D * lags + 1, D)).astype(np_dtype)
    return x, mask, gammas, tau, beta


def jax_sums(x, mask, gammas, tau, beta, lags, diagonal):
    """The JAX package's weighted sums (models/arhmm.py:504-546), the
    covariance before its division by wsum."""
    w = gammas * mask[:, :, None]
    if tau is not None:
        w = w * tau
    ones = jnp.ones(x.shape[:2] + (1,), dtype=x.dtype)
    if lags > 0:
        w = w * (jnp.arange(x.shape[1]) >= lags)[None, :, None]
        feats = jax.vmap(lambda xi: _make_lagged(xi, lags))(x)
        Xd = jnp.concatenate([feats, ones], axis=2)
    else:
        Xd = ones
    Xf, Yf, Wf = Xd.reshape(-1, Xd.shape[2]), x.reshape(-1, D), w.reshape(-1, K)
    XtWX = jnp.einsum('np,nk,nq->kpq', Xf, Wf, Xf)
    XtWY = jnp.einsum('np,nk,nd->kpd', Xf, Wf, Yf)
    resid = Yf[:, None, :] - jnp.einsum('np,kpd->nkd', Xf, beta)
    if diagonal:
        cov = jnp.einsum('nk,nkd->kd', Wf, resid ** 2)
    else:
        cov = jnp.einsum('nk,nkd,nke->kde', Wf, resid, resid)
    return XtWX, XtWY, jnp.sum(Wf, axis=0), cov


def assert_close(got, want, rel, name):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (name, np.abs(got - want).max(), scale)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('case', list(CASES))
def test_plain_sums_match_jax(case, dtype):
    """``mstep_stats`` and ``mstep_cov`` on the CPU (K31's plain versions)
    give the JAX package's XtWX, XtWY, wsum and residual sums."""
    lags, diagonal, robust, ragged = CASES[case]
    np_dtype, _, rel = DTYPES[dtype]
    x, mask, gammas, tau, beta = make_inputs(np_dtype, lags, ragged)
    tau = tau if robust else None
    with x64(dtype):
        want = compile_low(lambda *a: jax_sums(*a, lags=lags, diagonal=diagonal),
                           x, mask, gammas, tau, beta)(x, mask, gammas, tau, beta)
    t = [None if a is None else torch.from_numpy(a) for a in (x, mask, gammas, tau, beta)]
    got = arhmm.mstep_stats(*t[:4], lags) + (arhmm.mstep_cov(*t, lags, diagonal),)
    for name, g, w in zip(('XtWX', 'XtWY', 'wsum', 'cov'), got, want):
        assert_close(g, w, rel, name)


def jax_model(obs, transitions, dtype):
    m = JaxARHMM(K, D, lags=1, observations=obs, transitions=transitions, kappa=5.0,
                 rng_seed=3, dtype=dtype)
    rs = np.random.RandomState(4)
    np_dtype = DTYPES[dtype][0]
    m.params = dict(m.params,
                    As=jnp.asarray(0.5 * np.eye(D)[None] + 0.1 * rs.randn(K, D, D), np_dtype),
                    bs=jnp.asarray(0.2 * rs.randn(K, D), np_dtype))
    if transitions.startswith('recurrent'):
        # a drive that moves log_P from step to step, and an r the
        # 'recurrent' M-step must leave as it is
        m.params = dict(m.params, Rs=jnp.asarray(0.5 * rs.randn(K, D), np_dtype),
                        r=jnp.asarray(0.3 * rs.randn(K), np_dtype))
    return m


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('obs,transitions', [('ar', 'sticky'), ('robust_ar', 'stationary'),
                                             ('robust_ar', 'recurrent'),
                                             ('diagonal_robust_ar', 'recurrent_only')])
def test_m_step_matches_jax(obs, transitions, dtype):
    """The port's ``_m_step`` (K31's plain versions, K11's plain solve, the
    dof's Newton steps: K41's plain version) against JAX's ``_m_step`` on
    the same gammas, xi sums and, robust, tau from the same params; with
    recurrent transitions the port's ``_m_step_recurrent`` (K40's plain
    version) on the pairwise posteriors of its plain E-step under those
    params, against the transitions of JAX's ``_m_step``."""
    np_dtype, torch_dtype, _ = DTYPES[dtype]
    rel = 1e-5 if dtype == 'float32' else 1e-10
    recurrent = transitions.startswith('recurrent')
    x, mask, gammas, _, _ = make_inputs(np_dtype, 1, True, seed=1)
    xi_sums = (np.random.RandomState(2).rand(len(LENGTHS), K, K) * 5).astype(np_dtype)
    with x64(dtype):
        j = jax_model(obs, transitions, dtype)
        args = (j.params, x, mask, gammas, xi_sums)
        want = compile_low(j._m_step, *args)(*args)
        params = {k: np.array(v) for k, v in j.params.items()}
    t = ARHMM(K, D, lags=1, observations=obs, transitions=transitions, kappa=5.0, rng_seed=3,
              dtype=dtype, device='cpu')
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt, mt, gt = (torch.from_numpy(a) for a in (x, mask, gammas))
    ll, tau = t._log_likes(p, xt, mt, with_tau=True)
    got = t._m_step(p, xt, mt, gt, torch.from_numpy(xi_sums), tau)
    if recurrent:
        xis = hmm.expected_transitions_plain(p['log_pi0'], t._log_P(p, xt), ll, mt)
        got.update(t._m_step_recurrent(p, xt, xis))
        # the parameter the objective does not read keeps its value
        kept = 'r' if transitions == 'recurrent' else 'log_Ps'
        assert torch.equal(got[kept], p[kept]), kept
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch_dtype, key
        if recurrent and dtype == 'float32' and key in ('log_Ps', 'Rs', 'r'):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
        else:
            assert_close(got[key], want[key], rel, key)


def test_cuda_wrappers_refuse_cpu_tensors_and_mixed_dtypes():
    """K31's, K40's and K41's wrappers take CUDA tensors of one float dtype
    only; a refused call launches and counts nothing."""
    before = dict(build.LAUNCHES)
    x, mask, gammas, tau, beta = (torch.from_numpy(a) for a in
                                  make_inputs(np.float32, 1, True))
    calls = (lambda: arhmm.mstep_stats_cuda(x, mask, gammas, tau, 1),
             lambda: arhmm.mstep_cov_cuda(x, mask, gammas, None, beta, 1, False))
    for call in calls:
        with pytest.raises(ValueError, match='CUDA'):
            call()
    for call in (lambda: arhmm.mstep_stats_cuda(x, mask, gammas.double(), tau, 1),
                 lambda: arhmm.mstep_cov_cuda(x.double(), mask.double(), gammas.double(),
                                              None, beta, 1, True),
                 lambda: arhmm.mstep_stats_cuda(x.half(), mask.half(), gammas.half(), None, 1)):
        with pytest.raises(ValueError, match='float32 or all float64'):
            call()
    # K40's and K41's wrappers likewise, one part or two
    N, T = mask.shape
    log_Ps, Rs, r = torch.zeros(K, K), torch.zeros(K, D), torch.zeros(K)
    xis = torch.full((N, T - 1, K, K), 1.0 / K ** 2)
    nus = torch.full((K,), 4.0)
    for call in (lambda: arhmm.recurrent_mstep_cuda(log_Ps, Rs, r, [x], [xis], 'recurrent'),
                 lambda: arhmm.recurrent_mstep_cuda(log_Ps, Rs, r, [x[:1], x[1:]],
                                                    [xis[:1], xis[1:]], 'recurrent_only'),
                 lambda: arhmm.nu_mstep_cuda(nus, [(mask, gammas, tau)], D),
                 lambda: arhmm.nu_mstep_cuda(nus, [(mask[:1], gammas[:1], tau[:1]),
                                                   (mask[1:], gammas[1:], tau[1:])], D)):
        with pytest.raises(ValueError, match='CUDA'):
            call()
    for call in (lambda: arhmm.recurrent_mstep_cuda(log_Ps, Rs.double(), r, [x], [xis],
                                                    'recurrent'),
                 lambda: arhmm.nu_mstep_cuda(nus.half(), [(mask, gammas, tau)], D)):
        with pytest.raises(ValueError, match='float32 or all float64'):
            call()
    assert build.LAUNCHES == before
