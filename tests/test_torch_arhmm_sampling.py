"""The port's ARHMM state sampling and parallel-scan EM against the JAX
package's, on the CPU (plain versions of K13-K16).

``ops.hmm.sample_posterior_plain`` and ``sample_states_plain`` take their
uniforms explicitly: fed the uniforms that JAX's ``sample_posterior`` and
``sample_states`` draw from their keys (``jax.random.categorical`` is the
argmax of logits plus -log(-log u), u uniform in [tiny, 1)), they give
JAX's paths exactly. The port's own draws are held to the posterior
marginals; ``ARHMM.sample`` / ``sample_x`` run, and their observations
given the states equal JAX's ``sample_x`` on the same params, prefix and
(JAX's) noise; three EM iterations with ``parallel_scan`` match JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.ops import hmm
from behavenet_tpu_torch.utils import pickles

N, T, K = 3, 40, 4
SHORT = 29
TINY = float(np.finfo(np.float32).tiny)


def _chain(seed, tv):
    rs = np.random.RandomState(seed)
    pi0 = rs.dirichlet(np.ones(K))
    size = (N, T - 1, K) if tv else (K,)
    P = 0.6 * np.eye(K) + 0.4 * rs.dirichlet(np.ones(K), size=size)
    log_lik = rs.randn(N, T, K) * 1.5
    mask = np.ones((N, T))
    mask[1, SHORT:] = 0.0
    log_lik = log_lik * mask[:, :, None]
    f32 = np.float32
    return (np.log(pi0).astype(f32), np.log(P).astype(f32), log_lik.astype(f32),
            mask.astype(f32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _compiled(fn, *args):
    """``fn(*args)`` through ``jax.jit``, compiled at LLVM optimization
    level 0 (the same XLA program, built in less time)."""
    compiled = jax.jit(fn).lower(*args).compile({'xla_backend_optimization_level': 0})
    return compiled(*args)


def _uniform(key, shape):
    return jax.random.uniform(key, shape, minval=TINY, maxval=1.0)


@pytest.fixture(scope='module', params=['stationary', 'time_varying'])
def posterior_case(request):
    """A chain, one key per trial, the uniforms JAX's ``sample_posterior``
    draws from each (``split(key)`` into the last state's and the maps'),
    and JAX's paths, sequential and parallel: one vmapped, compiled function
    for the module's case."""
    tv = request.param == 'time_varying'
    chain = _chain(4 if tv else 3, tv)
    keys = jax.random.split(jax.random.PRNGKey(11), N)

    def one(key, pi0, lp, ll, m):
        k_last, k_maps = jax.random.split(key)
        return (_uniform(k_last, (K,)), _uniform(k_maps, (T - 1, K, K)),
                jhmm.sample_posterior(key, pi0, lp, ll, m, parallel=False),
                jhmm.sample_posterior(key, pi0, lp, ll, m, parallel=True))
    out = _compiled(jax.vmap(one, in_axes=(0, None, 0 if tv else None, 0, 0)), keys, *chain)
    u_last, u_maps, seq, par = (np.asarray(v) for v in out)
    return chain, u_last, u_maps, {False: seq, True: par}


@pytest.mark.parametrize('parallel', [False, True])
def test_sample_posterior_equals_jax_from_its_uniforms(posterior_case, parallel):
    chain, u_last, u_maps, paths = posterior_case
    got = hmm.sample_posterior_plain(*_t(*chain), *_t(u_last, u_maps), parallel=parallel)
    assert got.dtype == torch.int32 and got.shape == (N, T)
    np.testing.assert_array_equal(got.numpy(), paths[parallel])
    # a padded frame carries the state of the last real one
    assert np.all(got.numpy()[1, SHORT:] == got.numpy()[1, SHORT - 1])


def test_sample_states_equals_jax_from_its_uniforms():
    """``sample_states_plain`` of 5 chains from the uniforms JAX's
    ``sample_states`` draws (``split(key)``, then one key per step)."""
    rs = np.random.RandomState(5)
    log_pi0 = np.log(rs.dirichlet(np.ones(K))).astype(np.float32)
    log_P = np.log(0.5 * np.eye(K) + 0.5 * rs.dirichlet(np.ones(K), size=K)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)

    def one(key):
        k0, k_scan = jax.random.split(key)
        u = jax.vmap(lambda k: _uniform(k, (K,)))(jax.random.split(k_scan, T - 1))
        return (_uniform(k0, (K,)), u,
                jhmm.sample_states(key, jnp.asarray(log_pi0), jnp.asarray(log_P), T))
    u0, u, want = (np.asarray(v) for v in _compiled(jax.vmap(one), keys))
    got = hmm.sample_states_plain(*_t(log_pi0, log_P, u0, u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('parallel', [False, True])
def test_posterior_draws_follow_the_marginals(parallel):
    """400 port draws of one trial (the trial repeated over N, one call):
    each frame's state frequencies within 5 standard errors of gamma (plus
    one draw's worth, 1/400, for the discreteness of a count)."""
    pi0, lp, ll, m = _chain(6, False)
    n = 400
    ll = np.repeat(ll[:1], n, axis=0)
    m = np.repeat(m[:1], n, axis=0)
    args = _t(pi0, lp, ll, m)
    gamma = hmm.forward_backward(*args)[0][0].numpy()
    gen = torch.Generator().manual_seed(0)
    paths = hmm.sample_posterior(*args, parallel=parallel, generator=gen).numpy()
    freq = np.stack([(paths == k).mean(axis=0) for k in range(K)], axis=1)
    se = np.sqrt(gamma * (1 - gamma) / n)
    assert np.all(np.abs(freq - gamma) <= 5 * se + 1.0 / n)
    # the same generator seed gives the same draws
    again = hmm.sample_posterior(*args, parallel=parallel,
                                 generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(again, paths)


def test_stationary_sample_and_sample_x():
    m = ARHMM(K, 3, lags=2, device='cpu', rng_seed=1)
    gen = torch.Generator().manual_seed(2)
    zs, xs = m.sample(50, generator=gen)
    assert zs.dtype == np.int32 and zs.shape == (50,) and 0 <= zs.min() and zs.max() < K
    assert xs.dtype == np.float32 and xs.shape == (50, 3) and np.isfinite(xs).all()
    zs2, xs2 = m.sample(50, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(zs2, zs)
    np.testing.assert_array_equal(xs2, xs)
    # without noise, x_t is the AR mean of the state's dynamics, the prefix
    # standing in for the history before frame 0
    prefix = [np.ones(3), 2 * np.ones(3)]
    x = m.sample_x(zs, generator=gen, prefix=prefix, with_noise=False)
    assert x.dtype == np.float32 and x.shape == (50, 3)
    A, b = m.params['As'].numpy(), m.params['bs'].numpy()
    k0, k1 = zs[0], zs[1]
    np.testing.assert_allclose(x[0], A[k0][:, :3] @ prefix[-1] + A[k0][:, 3:] @ prefix[-2]
                               + b[k0], rtol=1e-5)
    np.testing.assert_allclose(x[1], A[k1][:, :3] @ x[0] + A[k1][:, 3:] @ prefix[-1] + b[k1],
                               rtol=1e-5)


@pytest.mark.parametrize('transitions', ['recurrent', 'recurrent_only'])
def test_recurrent_sample_runs(transitions):
    m = ARHMM(K, 3, lags=1, transitions=transitions, observations='robust_ar', device='cpu')
    zs, xs = m.sample(30, generator=torch.Generator().manual_seed(0))
    assert zs.dtype == np.int32 and zs.shape == (30,) and 0 <= zs.min() and zs.max() < K
    assert xs.dtype == np.float32 and xs.shape == (30, 3) and np.isfinite(xs).all()


def test_posterior_sample_of_a_model():
    """``ARHMM.posterior_sample`` of one trial: (T,) int32 states, the same
    from the same generator seed, with and without ``parallel_scan``."""
    x = np.random.RandomState(0).randn(30, 3).astype(np.float32)
    for parallel in (False, True):
        m = ARHMM(K, 3, device='cpu', parallel_scan=parallel)
        z = m.posterior_sample(x, generator=torch.Generator().manual_seed(1))
        assert z.dtype == np.int32 and z.shape == (30,) and 0 <= z.min() and z.max() < K
        np.testing.assert_array_equal(
            z, m.posterior_sample(x, generator=torch.Generator().manual_seed(1)))


# ------------------------------------------------------- EM with parallel_scan

D, LENGTHS, EM_ITERS = 3, (36, 28, 36), 3


@pytest.fixture(scope='module', params=[('stationary', 'ar'), ('recurrent', 'robust_ar')],
                ids=['stationary-ar', 'recurrent-robust_ar'])
def parallel_em(request):
    """Three EM iterations of JAX's and the port's ARHMM with
    ``parallel_scan``, from the same initialized params."""
    transitions, obs = request.param
    rs = np.random.RandomState(8)
    datas = [np.cumsum(rs.randn(T, D) * 0.3, axis=0).astype(np.float32) for T in LENGTHS]
    kw = dict(lags=1, observations=obs, transitions=transitions, rng_seed=2,
              parallel_scan=True)
    t = ARHMM(K, D, device='cpu', **kw)
    t.initialize(datas)
    j = JaxARHMM(K, D, **kw)
    j.params = {k: jnp.asarray(v.numpy()) for k, v in t.params.items()}
    return datas, j, t, j.fit(datas, num_iters=EM_ITERS), t.fit(datas, num_iters=EM_ITERS)


def test_parallel_scan_em_matches_jax(parallel_em):
    _, _, _, lls_j, lls_t = parallel_em
    np.testing.assert_allclose(lls_t, lls_j, rtol=1e-5)


def test_jax_written_parallel_scan_model_loads_and_runs(parallel_em, tmp_path):
    """A JAX-written pickle with ``parallel_scan=True`` loads through
    ``load_arhmm`` with JAX's parameters bit for bit and decodes with the
    parallel scans: the same paths, posteriors and log-likelihood as the
    sequential passes of the same model."""
    datas, j = parallel_em[:2]
    path = str(tmp_path / 'jax.pt')
    j.save(path)
    m = pickles.load_arhmm(path, device='cpu')
    assert m.parallel_scan
    for key, want in j.params.items():
        np.testing.assert_array_equal(m.params[key].numpy(), np.asarray(want), err_msg=key)
    seq = pickles.load_arhmm(path, device='cpu')
    seq.parallel_scan = False
    np.testing.assert_allclose(m.log_likelihood(datas), seq.log_likelihood(datas), rtol=1e-5)
    np.testing.assert_array_equal(m.most_likely_states(datas[0]),
                                  seq.most_likely_states(datas[0]))
    np.testing.assert_allclose(m.expected_states(datas[1]), seq.expected_states(datas[1]),
                               atol=1e-5)
    z = m.posterior_sample(datas[2], generator=torch.Generator().manual_seed(0))
    assert z.shape == (LENGTHS[2],) and z.dtype == np.int32


# ------------------------------------------- observations against JAX's

SAMPLE_T = 40
PREFIXES = {'none': 0, 'short': 1, 'full': 3}   # frames of history before frame 0


def _ar_models(lags, transitions='stationary'):
    """The port's and JAX's ARHMM with the same params: stable dynamics
    (each lag's block 0.5 / lags times a random rotation), random offsets
    and covariances away from the identity."""
    rs = np.random.RandomState(30 + lags)
    kw = dict(lags=lags, transitions=transitions, rng_seed=1)
    t = ARHMM(K, D, device='cpu', **kw)
    arrays = {k: v.numpy() for k, v in t.params.items()}
    B = rs.randn(K, D, D)
    arrays.update(
        As=np.concatenate([0.5 / lags * np.linalg.qr(rs.randn(K, D, D))[0]
                           for _ in range(lags)], axis=2),
        bs=rs.randn(K, D), Sigmas=0.1 * np.eye(D) + 0.1 * B @ B.transpose(0, 2, 1))
    t.params = t._tensors(arrays)
    j = JaxARHMM(K, D, **kw)
    j.params = {k: jnp.asarray(v.numpy()) for k, v in t.params.items()}
    return t, j


def _prefix(frames):
    return list(np.random.RandomState(9).randn(frames, D)) if frames else None


def _jax_noise(t, key, monkeypatch):
    """Make the port's model draw JAX's noise for ``key`` (jax.random.normal
    of (T, D), as JAX's ``sample`` / ``sample_x`` draw it)."""
    monkeypatch.setattr(t, '_noise', lambda gen, T: np.asarray(
        jax.random.normal(key, (T, D)), dtype=np.float64))


@pytest.mark.parametrize('prefix', list(PREFIXES))
@pytest.mark.parametrize('lags', [1, 2])
def test_sample_x_matches_jax(lags, prefix):
    """``sample_x(states, prefix, with_noise=False)`` (each x_t the AR mean
    of its state's dynamics, ``_ar_mean``) equals JAX's over every frame,
    the prefix standing in for the history before frame 0 and zeros past
    it (rtol 1e-5, atol 1e-5: the port sums in float64, JAX in float32)."""
    t, j = _ar_models(lags)
    states = np.random.RandomState(7).randint(K, size=SAMPLE_T).astype(np.int32)
    pre = _prefix(PREFIXES[prefix])
    got = t.sample_x(states, generator=torch.Generator().manual_seed(0), prefix=pre,
                     with_noise=False)
    want = np.asarray(j.sample_x(states, key=jax.random.PRNGKey(0), prefix=pre,
                                 with_noise=False))
    assert got.dtype == np.float32 and got.shape == (SAMPLE_T, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('lags', [1, 2])
def test_sample_x_with_noise_matches_jax(lags, monkeypatch):
    """With noise: the same noise (JAX's draws for one key) through each
    state's covariance factor gives JAX's observations."""
    t, j = _ar_models(lags)
    key = jax.random.PRNGKey(4)
    _jax_noise(t, key, monkeypatch)
    states = np.random.RandomState(8).randint(K, size=SAMPLE_T).astype(np.int32)
    pre = _prefix(PREFIXES['full'])
    got = t.sample_x(states, generator=torch.Generator().manual_seed(0), prefix=pre)
    want = np.asarray(j.sample_x(states, key=key, prefix=pre))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('with_noise', [False, True], ids=['mean', 'noise'])
@pytest.mark.parametrize('transitions', ['stationary', 'recurrent'])
def test_sample_observations_match_jax(transitions, with_noise, monkeypatch):
    """``ARHMM.sample``'s observations given the states it drew (K16's chain
    or, recurrent, the host loop's) equal JAX's ``sample_x`` of those states
    on the same params, prefix and noise (rtol 1e-5, atol 1e-5)."""
    t, j = _ar_models(2, transitions)
    key = jax.random.PRNGKey(5)
    _jax_noise(t, key, monkeypatch)
    pre = _prefix(PREFIXES['full'])
    zs, xs = t.sample(SAMPLE_T, generator=torch.Generator().manual_seed(3), prefix=pre,
                      with_noise=with_noise)
    assert zs.dtype == np.int32 and zs.shape == (SAMPLE_T,)
    want = np.asarray(j.sample_x(zs, key=key, prefix=pre, with_noise=with_noise))
    np.testing.assert_allclose(xs, want, rtol=1e-5, atol=1e-5)
