"""The port's time-sharded HMM passes (``parallel.seq``, the plain versions
of K32-K35) and multi-shard ARHMM EM against the JAX package's, on the CPU.

The port's mesh names ``cpu`` eight times, the counterpart of the JAX
tests' eight virtual CPU devices (``make_mesh(axis_name='sp')``); every JAX
reference runs compiled at LLVM level 0 (``tests/jax_low.py``), never
eagerly. ``sp_scan`` of the log semiring and of the index-map monoid,
``sp_forward_backward`` (stationary and time-varying, a masked tail),
``sp_viterbi`` and ``sp_sample_posterior`` (fed JAX's own uniforms) against
JAX's; the ARHMM's ``expected_states`` / ``most_likely_states(mesh=)``
against JAX's ``sp_*`` on the JAX model's log-likelihoods; ``fit`` with the
time layout (``shard_time``, lags 1 and robust lags 2) and the trial layout
against JAX's ``fit`` on the same mesh layout; ``iters_per_dispatch``
against the port's own fit; the refusals; the launch check's rule that a
kernel's tensors lie on the current card, and ``per_device`` making each
shard's card current."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.models import arhmm as jax_arhmm_module
from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu.parallel import seq as jseq
from behavenet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from behavenet_tpu_torch.fitting import arhmm_grid_search
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.models.bayesian import BayesianDecoder
from behavenet_tpu_torch.ops import hmm
from behavenet_tpu_torch.parallel import Mesh, make_mesh, on_device, per_device, seq
from tests.jax_low import LowOptJax, jit_low

MESH = Mesh(['cpu'] * 8, ('sp',))
TINY = float(np.finfo(np.float32).tiny)
K, T, VALID = 4, 57, 41
SCAN_LENGTHS = (5, 48, 57)   # fewer frames than shards, a multiple of 8, ragged
N_KEYS = 6


@pytest.fixture(scope='module')
def jmesh():
    return jax_make_mesh(axis_name='sp')


def _t(a):
    return torch.from_numpy(np.array(a))


def _log_identity(k):
    return np.where(np.eye(k) > 0, 0.0, -np.inf).astype(np.float32)


@pytest.fixture(scope='module')
def scans(jmesh):
    """The inputs and JAX's ``sp_scan`` of each: the log semiring at each
    of SCAN_LENGTHS in both directions, and the index-map monoid (37 maps
    of 5 states) backwards; one program."""
    rs = np.random.RandomState(1)
    Ms = [rs.randn(n, K, K).astype(np.float32) for n in SCAN_LENGTHS]
    psi = np.random.RandomState(2).randint(0, 5, (37, 5)).astype(np.int32)

    def ref(Ms, psi):
        ident = jnp.asarray(_log_identity(K))
        out = [jseq.sp_scan(jhmm._log_matmul, m, ident, jmesh, reverse=r)
               for m in Ms for r in (False, True)]
        maps = jseq.sp_scan(jhmm._compose_maps, psi, jnp.arange(5, dtype=jnp.int32), jmesh,
                            reverse=True)
        return out, maps
    out, maps = jit_low(ref, Ms, psi)
    return Ms, psi, [np.asarray(o) for o in out], np.asarray(maps)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('length', SCAN_LENGTHS)
def test_sp_scan_log_semiring(scans, length, reverse):
    Ms, _, want, _ = scans
    i = SCAN_LENGTHS.index(length)
    got = seq.sp_scan(hmm._log_matmul, _t(Ms[i]), _t(_log_identity(K)), MESH, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want[2 * i + int(reverse)], rtol=2e-5, atol=2e-5)


def test_sp_scan_index_maps(scans):
    _, psi, _, want = scans
    got = seq.sp_scan(hmm._compose_maps, _t(psi).long(), torch.arange(5), MESH, reverse=True)
    np.testing.assert_array_equal(got.numpy(), want)


def _chain(tv, seed):
    rs = np.random.RandomState(seed)
    log_pi0 = np.log(rs.dirichlet(np.ones(K))).astype(np.float32)
    size = (T - 1, K) if tv else (K,)
    log_P = np.log(0.7 * np.eye(K) + 0.3 * rs.dirichlet(np.ones(K), size=size))
    log_lik = (1.5 * rs.randn(T, K)).astype(np.float32)
    mask = (np.arange(T) < VALID).astype(np.float32)
    return log_pi0, log_P.astype(np.float32), log_lik, mask


def _uniform(key, shape):
    return jax.random.uniform(key, shape, minval=TINY, maxval=1.0)


@pytest.fixture(scope='module', params=['stationary', 'time_varying'])
def chain_case(request, jmesh):
    """A chain with a masked tail and JAX's sp_forward_backward,
    sp_viterbi and, stationary, for N_KEYS keys, sp_sample_posterior with
    the uniforms ``_presample_path_draws`` draws from each key; one
    program."""
    tv = request.param == 'time_varying'
    chain = _chain(tv, 3 if tv else 4)
    keys = [jax.random.PRNGKey(i) for i in range(0 if tv else N_KEYS)]

    def ref(chain, keys):
        fb = jseq.sp_forward_backward(*chain, mesh=jmesh)
        path = jseq.sp_viterbi(*chain, mesh=jmesh)
        draws = []
        for key in keys:
            k_last, k_maps = jax.random.split(key)
            draws.append((_uniform(k_last, (K,)), _uniform(k_maps, (T - 1, K, K)),
                          jseq.sp_sample_posterior(key, *chain, mesh=jmesh)))
        return fb, path, draws
    fb, path, draws = jit_low(ref, chain, keys)
    return (chain, [np.asarray(v) for v in fb], np.asarray(path),
            [[np.asarray(v) for v in d] for d in draws])


def test_sp_forward_backward_matches_jax(chain_case):
    chain, (g_want, z_want, x_want), _, _ = chain_case
    gamma, log_Z, xi_sum = seq.sp_forward_backward(*map(_t, chain), mesh=MESH)
    np.testing.assert_allclose(gamma.numpy(), g_want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(log_Z.item(), z_want, rtol=1e-5)
    np.testing.assert_allclose(xi_sum.numpy(), x_want, rtol=0, atol=1e-5)
    assert np.all(gamma.numpy()[VALID:] == 0)


def test_sp_viterbi_matches_jax(chain_case):
    chain, _, want, _ = chain_case
    got = seq.sp_viterbi(*map(_t, chain), mesh=MESH)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('chain_case', ['stationary'], indirect=True)
def test_sp_sample_posterior_matches_jax_from_its_uniforms(chain_case):
    """Equal paths for all keys but at most one: sharding reassociates the
    alphas, so a draw within roundoff of a tie may flip (JAX's own test
    allows the same, tests/test_parallel/test_seq.py). The time-varying
    draws run through the same code, and the recurrent ARHMM's below."""
    chain, _, _, draws = chain_case
    equal = 0
    for u_last, u_maps, want in draws:
        got = seq.sp_sample_posterior(*map(_t, chain), mesh=MESH,
                                      uniforms=(_t(u_last), _t(u_maps)))
        equal += int(np.array_equal(got.numpy(), want))
    assert equal >= N_KEYS - 1, equal


def _models(D, rng_seed=0):
    """A stationary AR(2) and a recurrent AR(1) model in both packages, the
    same numpy params (the JAX draws, which the port's init repeats)."""
    out = []
    for kw in (dict(lags=2), dict(lags=1, transitions='recurrent')):
        j = jax_arhmm_module.ARHMM(K=K, D=D, observations='ar', rng_seed=rng_seed, **kw)
        params = {k: np.asarray(v) for k, v in j.params.items()}
        if 'Rs' in params:
            params['Rs'] = 0.5 * np.random.RandomState(7).randn(K, D).astype(np.float32)
        j.params = {k: jnp.asarray(v) for k, v in params.items()}
        t = ARHMM(K, D, observations='ar', rng_seed=rng_seed, device='cpu', **kw)
        t.params = t._tensors(params)
        out.append((j, t))
    return out


@pytest.fixture(scope='module')
def inference(jmesh):
    """One 203-frame trial, the model pairs, and JAX's sp_forward_backward
    gamma and sp_viterbi path on each JAX model's own log-likelihoods and
    log-transitions (JAX: models/arhmm.py:257-292, compiled); one
    program."""
    D = 3
    data = 0.5 * np.random.RandomState(0).randn(203, D).astype(np.float32)
    pairs = _models(D)

    def ref(x, params):
        mask = jnp.ones(x.shape[0])
        out = []
        for (j, _), p in zip(pairs, params):
            ll, lp = j._log_likes(p, x, mask), j._log_P(p, x, mask)
            out.append((jseq.sp_forward_backward(p['log_pi0'], lp, ll, mask, mesh=jmesh)[0],
                        jseq.sp_viterbi(p['log_pi0'], lp, ll, mask, mesh=jmesh)))
        return out
    want = jit_low(ref, data, [j.params for j, _ in pairs])
    return data, pairs, [[np.asarray(v) for v in w] for w in want]


@pytest.mark.parametrize('which', ['stationary_lags2', 'recurrent'])
def test_arhmm_mesh_inference_matches_jax_sp(inference, which):
    """``expected_states`` and ``most_likely_states`` with a mesh: each
    shard's log-likelihoods from its frames and their lag history (the
    first frames under the initial condition), then the sharded passes;
    and the draw with a mesh equals the draw without one from the same
    generator state."""
    data, pairs, want = inference
    i = ['stationary_lags2', 'recurrent'].index(which)
    t = pairs[i][1]
    # |log alpha| reaches ~600 at 203 frames, where a float32 ulp is 6e-5:
    # the two packages' sharded sums agree to ~1e-4, JAX's own tolerance
    # for this call (tests/test_parallel/test_seq.py, TestARHMMSequenceParallel)
    np.testing.assert_allclose(t.expected_states(data, mesh=MESH), want[i][0], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(t.most_likely_states(data, mesh=MESH), want[i][1])
    draws = [t.posterior_sample(data, generator=torch.Generator().manual_seed(5), mesh=mesh)
             for mesh in (MESH, None)]
    np.testing.assert_array_equal(*draws)


@pytest.fixture(scope='module')
def fit_datas():
    rs = np.random.RandomState(0)
    return [rs.randn(157, 2).astype(np.float32) for _ in range(2)]


def _initialized_pair(datas, obs, lags):
    """The port's model initialized on ``datas`` (its k-means) and a JAX
    model with the same params."""
    t = ARHMM(3, 2, lags=lags, observations=obs, rng_seed=0, device='cpu')
    t.initialize(datas)
    j = jax_arhmm_module.ARHMM(K=3, D=2, lags=lags, observations=obs, rng_seed=0)
    j.params = {k: jnp.asarray(v.numpy()) for k, v in t.params.items()}
    return j, t


@pytest.mark.parametrize('layout, obs, lags', [('time', 'ar', 1), ('time', 'robust_ar', 2),
                                               ('trial', 'ar', 1)])
def test_fit_on_a_mesh_matches_jax(monkeypatch, jmesh, fit_datas, layout, obs, lags):
    """Three EM iterations on 2 x 157 frames, K = 3, on an 8-shard mesh in
    both packages: the time layout (T padded to 160, 20 frames a shard; at
    lags 2 each shard's first two frames read the shard to their left, and
    only global frames 0-1 take the initial condition and weigh 0) and the
    trial layout (the 2 trials padded to 8)."""
    monkeypatch.setattr(jax_arhmm_module, 'jax', LowOptJax())
    j, t = _initialized_pair(fit_datas, obs, lags)
    shard_time = layout == 'time'
    want = j.fit(fit_datas, num_iters=3, mesh=jmesh, shard_time=shard_time)
    got = t.fit(fit_datas, num_iters=3, mesh=MESH, shard_time=shard_time)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for key in ('As', 'bs', 'Sigmas', 'log_Ps', 'log_pi0', 'nus'):
        np.testing.assert_allclose(t.params[key].numpy(), np.asarray(j.params[key]), rtol=1e-3,
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize('shard_time', [False, True])
def test_iters_per_dispatch_composes_with_mesh(fit_datas, shard_time):
    """Five iterations with ``iters_per_dispatch=2`` (two runs of two, one
    left over) on a 3-shard mesh are the same iterations as one at a time:
    the same log-likelihoods and parameters."""
    mesh = Mesh(['cpu'] * 3, ('sp',))
    init = ARHMM(3, 2, lags=1, rng_seed=0, device='cpu')
    init.initialize(fit_datas)
    fits = []
    for k in (1, 2):
        t = ARHMM(3, 2, lags=1, rng_seed=0, device='cpu')
        t.params = dict(init.params)
        fits.append((t.fit(fit_datas, num_iters=5, mesh=mesh, shard_time=shard_time,
                           iters_per_dispatch=k), t.params))
    (lls1, p1), (lls2, p2) = fits
    assert len(lls2) == 5
    np.testing.assert_allclose(lls2, lls1, rtol=1e-12)
    for key in p1:
        assert torch.equal(p2[key], p1[key]), key


def _refusal(which):
    t = ARHMM(2, 2, lags=1, rng_seed=0, device='cpu')
    data = [np.zeros((40, 2), np.float32)]
    if which == 'shard_time_without_mesh':
        with pytest.raises(ValueError, match='mesh'):
            t.fit(data, shard_time=True)
    elif which == 'recurrent_shard_time':
        r = ARHMM(2, 2, lags=1, transitions='recurrent', rng_seed=0, device='cpu')
        with pytest.raises(NotImplementedError, match='stationary'):
            r.fit(data, mesh=MESH, shard_time=True)
    elif which == 'float64_mesh':
        f = ARHMM(2, 2, lags=1, rng_seed=0, dtype='float64', device='cpu')
        with pytest.raises(NotImplementedError, match='A1c'):
            f.fit(data, mesh=MESH)
        with pytest.raises(NotImplementedError, match='A1c'):
            f.expected_states(data[0], mesh=MESH)
    else:   # the Bayesian decoder's mesh is a parallel.Mesh, not a device list
        dec = BayesianDecoder(t, obs_noise=0.1 * np.eye(2))
        with pytest.raises(TypeError, match='Mesh'):
            dec.decode(data[0], mesh=list(MESH.devices))


@pytest.mark.parametrize('which', ['shard_time_without_mesh', 'recurrent_shard_time',
                                   'float64_mesh', 'decode_mesh'])
def test_refusals(which):
    _refusal(which)


def test_mesh_and_make_mesh(monkeypatch):
    """A Mesh reads as JAX's (axis names, shape, size); make_mesh lists the
    first CUDA devices and raises without one; the ARHMM CLI shards EM over
    the trials when it runs on more than one card, as the JAX CLI does."""
    assert MESH.shape == {'sp': 8} and MESH.size == 8 and MESH.axis_names == ('sp',)
    with pytest.raises(ValueError):
        Mesh(['cpu'], ('a', 'b'))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh()
    assert arhmm_grid_search._em_mesh(torch.device('cpu')) is None
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    mesh = arhmm_grid_search._em_mesh(torch.device('cuda'))
    assert mesh.axis_names == ('dp',) and [str(d) for d in mesh.devices] == \
        ['cuda:0', 'cuda:1', 'cuda:2']
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert arhmm_grid_search._em_mesh(torch.device('cuda')) is None
    with pytest.raises(ValueError, match='cuda devices or on cpu'):
        seq.on_card(['cpu', 'cuda:0'])


def test_launches_run_on_their_shard_device(monkeypatch):
    """The launch check (``build.check_device``, in ``dtype_suffix`` and
    ``ops.hmm``'s checks) refuses tensors on a card that is not the current
    one, whose stream a launch takes; ``per_device`` makes each shard's
    card current for its calls and restores the one before; ``on_device``
    leaves the CPU as it is. (Fake tensors and a fake ``torch.cuda.device``
    that only tracks the current index: no card is needed.)"""
    current = [0]

    class FakeCudaDevice:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev
    monkeypatch.setattr(torch.cuda, 'device', FakeCudaDevice)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: current[0])

    def fake(device):
        return types.SimpleNamespace(dtype=torch.float32, device=torch.device(device))
    on1 = [fake('cuda:1')] * 2
    with pytest.raises(ValueError, match='current device is cuda:0'):
        build.dtype_suffix('k', on1)
    with pytest.raises(ValueError, match='current device is cuda:0'):
        hmm._check_tensors('k', on1, (torch.float32,) * 2)
    with pytest.raises(ValueError, match='one CUDA device'):
        build.dtype_suffix('k', [fake('cuda:0'), fake('cuda:1')])
    shards = [fake(d) for d in ('cuda:1', 'cuda:0', 'cuda:1')]
    seen = per_device(lambda sh, i: (i, current[0], build.dtype_suffix('k', [sh, sh])),
                      shards, range(3))
    assert seen == [(0, 1, ''), (1, 0, ''), (2, 1, '')] and current[0] == 0
    with on_device('cpu'):
        assert current[0] == 0
