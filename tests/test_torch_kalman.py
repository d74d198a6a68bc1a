"""The port's Kalman filter and smoother (``ops.kalman``: the plain versions
of K19-K22) and K11's pivoted solve against the JAX package's, on the CPU.

The systems are ``make_system``'s of the JAX package's own Kalman tests
(T = 60, n = 3, d = 2, seeded numpy), with every step observed and with a
quarter of the steps masked (the first and last three among them, as the
decoders' NaN borders leave them). JAX's functions run compiled at LLVM
optimization level 0, in one program shared by the cases. JAX's chunked
scan at a chunk of at least T is its unchunked scan (ops/scans.py:33), so
the chunk larger than T is held to that.

Tolerances: float32 on both sides in the same operation order, except the
parallel scans' trees (the port's plain ``prefix_scan`` doubles,
Hillis-Steele; JAX's ``associative_scan`` reduces odd and even elements),
so they agree to roundoff: within atol 2e-6, rtol 1e-5 (measured: ~3e-7 on
moments of order 1). The float64 plain versions within the same bound.
"""

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import kalman as jkalman
from behavenet_tpu.ops import smallmat as jsmallmat
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.ops import kalman, smallmat
from tests.jax_low import compile_low
from tests.test_ops.test_kalman import make_system

RTOL, ATOL = 1e-5, 2e-6
T, N, D = 60, 3, 2
CHUNKS = (25, 100)   # one that does not divide T, one larger than T


def _inputs(masked):
    args, _ = make_system(T=T, n=N, d=D, seed=6, mask_frac=0.25 if masked else 0.0)
    args = [np.array(a) for a in args]
    if masked:
        args[6][:3] = args[6][-3:] = 0.0
    return args


def _jax_all(F, c, Q, H, R, y, mask, m0, P0):
    """The four JAX functions on one system (the sequential smoother on the
    sequential filter's moments, the parallel one on the parallel's), the
    parallel ones unchunked and at each chunk of CHUNKS below T."""
    seq = jkalman.filter_sequential(F, c, Q, H, R, y, mask, m0, P0)
    out = {'seq': (seq, jkalman.smooth_sequential(F, c, Q, *seq))}
    for chunk in (None,) + tuple(ch for ch in CHUNKS if ch < T):
        par = jkalman.filter_parallel(F, c, Q, H, R, y, mask, m0, P0, chunk=chunk)
        out['par%s' % (chunk or '')] = (par, jkalman.smooth_parallel(F, c, Q, *par,
                                                                     chunk=chunk))
    return out


@pytest.fixture(scope='module')
def jax_ref():
    """masked -> JAX's outputs, from one compiled program."""
    program, made = [], {}

    def get(masked):
        if masked not in made:
            args = _inputs(masked)
            if not program:
                program.append(compile_low(_jax_all, *args))
            made[masked] = jax.tree_util.tree_map(np.asarray, program[0](*args))
        return made[masked]
    return get


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=RTOL, atol=ATOL)


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize('masked', [False, True], ids=['observed', 'masked'])
def test_plain_versions_match_jax(jax_ref, masked):
    """The four public functions (the plain versions on CPU tensors) against
    JAX's; the float64 plain versions too."""
    ref = jax_ref(masked)
    (w_seq, w_sseq), (w_par, w_spar) = ref['seq'], ref['par']
    ts = _torch(_inputs(masked))
    F, c, Q = ts[:3]
    seq = kalman.filter_sequential(*ts)
    par = kalman.filter_parallel(*ts)
    assert len(seq) == 4 and len(par) == 2 and seq[0].dtype == torch.float32
    _close(seq, w_seq)
    _close(par, w_par)
    _close(kalman.smooth_sequential(F, c, Q, *seq), w_sseq)
    _close(kalman.smooth_parallel(F, c, Q, *par), w_spar)
    seq64 = kalman.filter_sequential_plain(*ts, dtype=torch.float64)
    par64 = kalman.filter_parallel_plain(*ts, dtype=torch.float64)
    assert par64[0].dtype == torch.float64
    _close(seq64, w_seq)
    _close(par64, w_seq[:2])
    _close(kalman.smooth_parallel_plain(F, c, Q, *par64, dtype=torch.float64), w_sseq)


@pytest.mark.parametrize('chunk', CHUNKS)
def test_chunked_scans_match_jax(jax_ref, chunk):
    """``filter_parallel`` / ``smooth_parallel`` with ``chunk`` against JAX's
    with the same chunk, on the masked system."""
    w_par, w_spar = jax_ref(True)['par%d' % chunk if chunk < T else 'par']
    ts = _torch(_inputs(True))
    par = kalman.filter_parallel(*ts, chunk=chunk)
    _close(par, w_par)
    _close(kalman.smooth_parallel(*ts[:3], *par, chunk=chunk), w_spar)


def test_pivoted_solve_with_zero_leading_pivot():
    """The pivoted solve on systems whose leading pivot is 0: JAX's results
    (the same pivots, the same operation order); the unpivoted elimination
    gives non-finite output on both sides."""
    rs = np.random.RandomState(4)
    A = rs.randn(6, 5, 5).astype(np.float32)
    A[:, 0, 0] = 0.0
    Y = rs.randn(6, 5, 3).astype(np.float32)
    got = smallmat.solve_small(torch.from_numpy(A), torch.from_numpy(Y), pivot=True)
    want = jax.jit(lambda a, y: jsmallmat.solve_small(a, y, pivot=True))(A, Y)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(A @ got.numpy(), Y, atol=1e-4)
    assert not torch.isfinite(smallmat.solve_small(torch.from_numpy(A),
                                                   torch.from_numpy(Y))).all()


def test_cuda_wrappers_refuse_without_launching():
    """K19-K22 and K11's pivoting launcher take float32 tensors on one CUDA
    device within n <= 32, d <= 16; a CPU tensor, a wider state or another
    dtype raises and launches nothing."""
    before = dict(build.LAUNCHES)
    ts = _torch(_inputs(False))
    F, c, Q = ts[:3]
    ms, Ps = F.new_zeros(T, N), F.new_zeros(T, N, N)
    for call in (kalman.filter_parallel_cuda, kalman.filter_sequential_cuda):
        with pytest.raises(ValueError, match='CUDA'):
            call(*ts)
        with pytest.raises(ValueError, match='float32'):
            call(*[t.double() for t in ts])
    with pytest.raises(ValueError, match='CUDA'):
        kalman.smooth_parallel_cuda(F, c, Q, ms, Ps)
    with pytest.raises(ValueError, match='CUDA'):
        kalman.smooth_sequential_cuda(F, c, Q, ms, Ps, ms, Ps)
    n2 = kalman.MAX_N + 1
    z = torch.zeros
    wide = (z(4, n2, n2), z(4, n2), z(4, n2, n2), z(D, n2), z(D, D), z(4, D), z(4), z(n2),
            z(n2, n2))
    with pytest.raises(ValueError, match='n <= %d' % kalman.MAX_N):
        kalman.filter_parallel_cuda(*wide)
    with pytest.raises(ValueError, match='n <= %d' % kalman.MAX_N):
        kalman.smooth_sequential_cuda(*wide[:3], z(4, n2), z(4, n2, n2), z(4, n2),
                                      z(4, n2, n2))
    with pytest.raises(ValueError, match='CUDA'):
        smallmat.solve_small_cuda(z(2, 3, 3), z(2, 3, 3), pivot=True)
    assert build.LAUNCHES == before
