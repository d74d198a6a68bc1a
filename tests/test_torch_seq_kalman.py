"""The port's time-sharded Kalman filter and smoother (``parallel.seq``'s
``sp_kalman_*``: the plain versions of K36-K39) and the Bayesian decoder's
``decode(mesh=)`` against the JAX package's, on the CPU.

The port's mesh names ``cpu`` eight times, the counterpart of the JAX
tests' eight virtual CPU devices (``make_mesh(axis_name='sp')``). The
systems are the JAX package's own sharded-Kalman tests' (``_lds`` of
tests/test_parallel/test_seq.py: n = 3, d = 2, seeded numpy) at T = 5
(fewer frames than shards: three shards empty), 40, 53 and, with a third
of the steps masked, 41; the smoother at T = 47 on the port's plain
filtered moments, on both sides.
The decoder is a JAX ARHMM's seeded params carried into the port's, over
one 97-frame trial with NaN borders and state evidence. Every JAX
reference runs compiled at LLVM level 0 (``tests/jax_low.py``). The four
filter cases share one program: JAX filters each system padded to the
longest case's 53 frames with the observations past its own masked (a
filtered moment reads the frames up to its own alone), and the port's
frames are held to the first T; the smoother runs in a second program.

Tolerances are JAX's own for these calls (tests/test_parallel/
test_seq.py:122-176): moments within rtol = atol = 1e-4; decoded latents
within 1e-3, the posteriors within atol 1e-4, the Viterbi states equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.models.bayesian import BayesianDecoder as JaxDecoder
from behavenet_tpu.parallel import seq as jseq
from behavenet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.models.bayesian import BayesianDecoder
from behavenet_tpu_torch.ops import kalman
from behavenet_tpu_torch.parallel import Mesh, seq
from tests.jax_low import compile_low, jit_low

MESH = Mesh(['cpu'] * 8, ('sp',))
TOL = dict(rtol=1e-4, atol=1e-4)
# name -> (T, seed, masked)
FILTER_CASES = {'T5': (5, 7, False), 'T40': (40, 7, False), 'T53': (53, 7, False),
                'T41_masked': (41, 9, True)}
SMOOTH_T, SMOOTH_SEED = 47, 8
K, D, T_DECODE, BORDER = 3, 3, 97, 3


def _lds(T, seed, masked=False, n=3, d=2):
    """tests/test_parallel/test_seq.py:122 ``_lds``, as numpy float32; with
    ``masked`` its masked case's mask (:150)."""
    rng = np.random.RandomState(seed)
    F = np.tile(0.9 * np.eye(n) + 0.05 * rng.randn(n, n), (T, 1, 1)).astype(np.float32)
    c = (0.1 * rng.randn(T, n)).astype(np.float32)
    Q = np.tile(0.1 * np.eye(n), (T, 1, 1)).astype(np.float32)
    H = rng.randn(d, n).astype(np.float32)
    R = (0.5 * np.eye(d)).astype(np.float32)
    y = rng.randn(T, d).astype(np.float32)
    mask = np.ones(T, np.float32)
    if masked:
        mask = (np.random.RandomState(1).rand(T) > 0.3).astype(np.float32)
    return [F, c, Q, H, R, y, mask, np.zeros(n, np.float32), np.eye(n, dtype=np.float32)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def jmesh():
    return jax_make_mesh(axis_name='sp')


def _padded(system, T):
    """``system`` (an ``_lds``) extended to T frames: the last frame's F and
    Q, c and y zero, the added observations masked."""
    F, c, Q, H, R, y, mask, m0, P0 = system
    pad = T - len(mask)

    def ext(a, fill):
        return np.concatenate([a, np.repeat(fill[None], pad, axis=0)])
    return [ext(F, F[-1]), ext(c, np.zeros_like(c[0])), ext(Q, Q[-1]), H, R,
            ext(y, np.zeros_like(y[0])), ext(mask, np.zeros_like(mask[0])), m0, P0]


@pytest.fixture(scope='module')
def jax_kalman(jmesh):
    """JAX's sp_kalman_filter of each FILTER_CASES system (one program over
    the systems padded to the longest case, each cut back to its own
    frames), and its sp_kalman_smooth of the smoother's system on the
    port's plain filtered moments."""
    systems = {name: _lds(*case) for name, case in FILTER_CASES.items()}
    T_all = max(T for T, _, _ in FILTER_CASES.values())
    padded = {name: _padded(s, T_all) for name, s in systems.items()}
    smooth_sys = _lds(SMOOTH_T, SMOOTH_SEED)
    moments = [m.numpy() for m in kalman.filter_parallel_plain(*map(_t, smooth_sys))]
    run = compile_low(lambda s: jseq.sp_kalman_filter(*s, jmesh), next(iter(padded.values())))
    filt = {name: [np.asarray(a)[:FILTER_CASES[name][0]] for a in run(s)]
            for name, s in padded.items()}
    smoothed = jit_low(lambda *a: jseq.sp_kalman_smooth(*a, jmesh), *smooth_sys[:3], *moments)
    return systems, smooth_sys, filt, moments, smoothed


@pytest.mark.parametrize('name', list(FILTER_CASES))
def test_sp_kalman_filter_matches_jax(jax_kalman, name):
    systems, _, filt, _, _ = jax_kalman
    ms, Ps = seq.sp_kalman_filter(*map(_t, systems[name]), mesh=MESH)
    assert ms.shape == (FILTER_CASES[name][0], 3) and ms.device == MESH.devices[0]
    np.testing.assert_allclose(ms.numpy(), np.asarray(filt[name][0]), **TOL)
    np.testing.assert_allclose(Ps.numpy(), np.asarray(filt[name][1]), **TOL)


def test_sp_kalman_smooth_matches_jax(jax_kalman):
    """The smoother on the same filtered moments, every frame (a shard's
    last frame reads the next shard's first frame of F, c, Q)."""
    _, smooth_sys, _, (ms, Ps), (ms_s, Ps_s) = jax_kalman
    F, c, Q = map(_t, smooth_sys[:3])
    got = seq.sp_kalman_smooth(F, c, Q, _t(ms), _t(Ps), mesh=MESH)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ms_s), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(Ps_s), **TOL)


def test_kalman_shards_keep_their_frames():
    """``shard_lds`` cuts T = 9 on 8 shards into five (2, 2, 2, 2, 1 frames:
    the last holds only the terminal frame), F, c, Q one frame past each
    shard's own but the last's; the ``*_shards`` passes return each shard's
    frames, and joined they are the whole-trial passes'."""
    ins = [_t(a) for a in _lds(9, 3)]
    shards = seq.shard_lds(MESH, *ins)
    assert [sh.frames for sh in shards] == [2, 2, 2, 2, 1]
    assert [sh.F.shape[0] for sh in shards] == [3, 3, 3, 3, 1]
    torch.testing.assert_close(shards[1].F[2], ins[0][4], rtol=0, atol=0)
    filt = seq.kalman_filter_shards(shards)
    smooth = seq.kalman_smooth_shards(shards, filt)
    assert [f[0].shape[0] for f in smooth] == [2, 2, 2, 2, 1]
    want = seq.sp_kalman_smooth(*ins[:3], *seq.sp_kalman_filter(*ins, mesh=MESH), mesh=MESH)
    for got, w in zip(seq.joined_frames(smooth, torch.device('cpu')), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def _low_decoder(dec):
    """A JAX decoder whose per-instance jit cache compiles at level 0."""
    cache = {}

    def jitted(key, fn):
        def run(*args):
            if key not in cache:
                cache[key] = compile_low(fn, *args)
            return cache[key](*args)
        return run
    dec._jitted = jitted
    return dec


@pytest.fixture(scope='module')
def decoders():
    """A JAX decoder and the port's on one seeded ARHMM (K = 3, D = 3, AR(1)),
    R = 0.1 I, and a trial with NaN borders and state evidence."""
    j = JaxARHMM(K=K, D=D, observations='ar', rng_seed=0)
    params = {k: np.asarray(v) for k, v in j.params.items()}
    params['As'] = 0.9 * params['As'] / np.abs(params['As']).max()
    params['log_Ps'] = np.log(0.9 * np.eye(K) + 0.1 / K).astype(np.float32)
    j.params = {k: jnp.asarray(v) for k, v in params.items()}
    t = ARHMM(K, D, observations='ar', rng_seed=0, device='cpu')
    t.params = t._tensors(params)
    rs = np.random.RandomState(0)
    y = np.cumsum(0.3 * rs.randn(T_DECODE, D), axis=0).astype(np.float32)
    q = rs.dirichlet(np.ones(K), size=T_DECODE).astype(np.float32)
    y[:BORDER] = y[-BORDER:] = q[:BORDER] = q[-BORDER:] = np.nan
    R = 0.1 * np.eye(D, dtype=np.float32)
    return _low_decoder(JaxDecoder(j, obs_noise=R)), BayesianDecoder(t, obs_noise=R), y, q


def _decoded_close(got, want):
    np.testing.assert_allclose(got['latents'], want['latents'], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got['latents_cov'], want['latents_cov'], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got['states_posterior'], want['states_posterior'], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(got['states'], want['states'])


def test_decode_mesh_matches_jax(decoders, jmesh):
    """``decode(mesh=)`` against JAX's ``decode(mesh=...)`` on the same
    weights, and against the port's own ``decode(parallel=True)``."""
    jdec, tdec, y, q = decoders
    got = tdec.decode(y, q, mesh=MESH)
    assert set(got) == {'latents', 'latents_cov', 'states', 'states_posterior'}
    assert got['latents'].shape == (T_DECODE, D) and np.isfinite(got['latents']).all()
    _decoded_close(got, jdec.decode(y, q, mesh=jmesh))
    _decoded_close(got, tdec.decode(y, q, parallel=True))


def test_decode_mesh_axis_dp(decoders):
    """A mesh whose axis is named 'dp' (as ``make_mesh`` names it) decodes
    as the 'sp' mesh does, unsmoothed too; ``as_numpy=False`` leaves the
    outputs on the mesh's first device."""
    _, tdec, y, q = decoders
    dp = Mesh(['cpu'] * 8, ('dp',))
    for smooth in (True, False):
        got = tdec.decode(y, q, smooth=smooth, mesh=dp, as_numpy=False)
        want = tdec.decode(y, q, smooth=smooth, mesh=MESH, as_numpy=False)
        for key in want:
            assert got[key].device == dp.devices[0]
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_shard_wrappers_refuse_cpu_tensors():
    """K36-K39's wrappers take CUDA tensors only and launch nothing
    otherwise; a smoother shard's F of the wrong length is refused."""
    before = dict(build.LAUNCHES)
    T, n, d = 6, 3, 2
    f = torch.zeros
    fins = (f(T, n, n), f(T, n), f(T, n, n), f(d, n), f(d, d), f(T, d), f(T), f(n), f(n, n))
    sins = (f(T + 1, n, n), f(T + 1, n), f(T + 1, n, n), f(T, n), f(T, n, n))
    L = kalman.scan_chunk(T)
    C = -(-T // L)
    calls = (
        lambda: kalman.shard_filter_totals_cuda(*fins, first=True),
        lambda: kalman.shard_filter_finish_cuda(f(2, 3 * n * n + 2 * n), 1, *fins,
                                                f(C * (4 * n * n + 3 * n))),
        lambda: kalman.shard_smoother_totals_cuda(*sins),
        lambda: kalman.shard_smoother_finish_cuda(f(2, 2 * n * n + n), 0, *sins,
                                                  f(C * (3 * n * n + 2 * n))))
    for call in calls:
        with pytest.raises(ValueError, match='CUDA'):
            call()
    with pytest.raises(ValueError, match='T \\+ 1 frames'):
        kalman.shard_smoother_totals_cuda(f(T + 2, n, n), f(T + 2, n), f(T + 2, n, n),
                                          f(T, n), f(T, n, n))
    assert build.LAUNCHES == before
