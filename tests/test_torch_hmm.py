"""The port's HMM message passing and small solve (``behavenet_tpu_torch.ops.hmm``,
``ops.smallmat``) against the JAX package's, on the CPU, where they run
their plain versions (the kernels K9-K11 run on the card only)."""

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu.ops import smallmat as jsmallmat
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.ops import hmm, smallmat
from tests.jax_low import jit_low

N, T, K = 5, 30, 4
SHORT = 19   # one trial is shorter, so the padded-frame path runs


def _chain(seed=0, ties=False):
    rs = np.random.RandomState(seed)
    pi0 = rs.dirichlet(np.ones(K))
    P = 0.7 * np.eye(K) + 0.3 * rs.dirichlet(np.ones(K), size=K)
    log_lik = rs.randn(N, T, K) * 3.0
    if ties:   # exact ties between states 1 and 2 everywhere
        log_lik[..., 2] = log_lik[..., 1]
        P[:, 2] = P[:, 1]
        pi0[2] = pi0[1]
    mask = np.ones((N, T))
    mask[2, SHORT:] = 0.0
    log_lik = log_lik * mask[:, :, None]
    f32 = np.float32
    return (np.log(pi0).astype(f32), np.log(P).astype(f32), log_lik.astype(f32),
            mask.astype(f32))



@pytest.fixture(scope='module')
def chain():
    return _chain()


@pytest.fixture(scope='module')
def jax_fb(chain):
    """JAX's forward-backward of every trial, vmapped once for the module."""
    pi0, lp, ll, m = chain
    fn = jax.vmap(jhmm.forward_backward, in_axes=(None, None, 0, 0))
    return [np.asarray(v) for v in jit_low(fn, pi0, lp, ll, m)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_forward_matches_jax(chain):
    pi0, lp, ll, m = chain
    want_alpha, want_z = jit_low(jax.vmap(jhmm.forward, in_axes=(None, None, 0, 0)), pi0, lp, ll, m)
    alpha, log_z = hmm.forward_plain(*_t(pi0, lp, ll, m))
    np.testing.assert_allclose(log_z.numpy(), np.asarray(want_z), rtol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(hmm.log_normalizer(*_t(pi0, lp, ll, m)).numpy(),
                               np.asarray(want_z), rtol=1e-6)


def test_backward_matches_jax(chain):
    _, lp, ll, m = chain
    want = jit_low(jax.vmap(jhmm.backward, in_axes=(None, 0, 0)), lp, ll, m)
    np.testing.assert_allclose(hmm.backward_plain(*_t(lp, ll, m)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-5)


def test_forward_backward_matches_jax(chain, jax_fb):
    gamma, log_z, xi_sum = hmm.forward_backward(*_t(*chain))
    want_gamma, want_z, want_xi = jax_fb
    np.testing.assert_allclose(log_z.numpy(), want_z, rtol=1e-6)
    np.testing.assert_allclose(gamma.numpy(), want_gamma, atol=1e-6)
    np.testing.assert_allclose(xi_sum.numpy(), want_xi, atol=1e-6)
    # the padded frames of the short trial carry no posterior mass
    assert np.all(gamma.numpy()[2, SHORT:] == 0)
    np.testing.assert_allclose(xi_sum.numpy()[2].sum(), SHORT - 1, rtol=1e-5)


@pytest.mark.parametrize('ties', [False, True], ids=['tie_free', 'ties'])
def test_viterbi_matches_jax(ties):
    """Paths equal on tie-free data; on exact ties both take the lowest
    state index (jnp.argmax's rule)."""
    pi0, lp, ll, m = _chain(seed=1, ties=ties)
    want = np.asarray(jit_low(jax.vmap(jhmm.viterbi, in_axes=(None, None, 0, 0)), pi0, lp, ll, m))
    path = hmm.viterbi(*_t(pi0, lp, ll, m))
    assert path.dtype == torch.int32
    np.testing.assert_array_equal(path.numpy(), want)
    if ties:
        assert not np.any(want == 2)
    # the path is the most probable one: its joint log-prob beats one
    # state flipped anywhere
    score = hmm.path_log_prob(*_t(pi0, lp, ll, m), path)
    flipped = path.clone()
    flipped[:, 5] = (flipped[:, 5] + 1) % K
    assert torch.all(score >= hmm.path_log_prob(*_t(pi0, lp, ll, m), flipped))


@pytest.mark.parametrize('n,k', [(10, 9), (4, 1), (16, 3)])
def test_solve_small_matches_jax(n, k):
    rs = np.random.RandomState(n + k)
    B = rs.randn(6, n, n)
    A = (B @ np.swapaxes(B, 1, 2) + n * np.eye(n)).astype(np.float32)
    Y = rs.randn(6, n, k).astype(np.float32)
    want = np.asarray(jit_low(jsmallmat.solve_small, A, Y))
    got = smallmat.solve_small(torch.from_numpy(A), torch.from_numpy(Y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # a vector right-hand side
    want_v = np.asarray(jit_low(jsmallmat.solve_small, A, Y[..., 0]))
    got_v = smallmat.solve_small(torch.from_numpy(A), torch.from_numpy(Y[..., 0])).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=1e-6 * np.abs(want_v).max())


def test_solve_small_pivot_matches_jax():
    rs = np.random.RandomState(3)
    A = rs.randn(5, 6, 6).astype(np.float32)
    A[:, 0, 0] = 0.0   # needs a row swap
    Y = rs.randn(5, 6, 2).astype(np.float32)
    want = np.asarray(jit_low(lambda a, y: jsmallmat.solve_small(a, y, True), A, Y))
    got = smallmat.solve_small(torch.from_numpy(A), torch.from_numpy(Y), pivot=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors(chain):
    """The kernels' wrappers take CUDA tensors only; nothing is launched (or
    counted) for a refused call."""
    before = dict(build.LAUNCHES)
    args = _t(*chain)
    for fn in (hmm.forward_backward_cuda, hmm.log_normalizer_cuda, hmm.viterbi_cuda):
        with pytest.raises(ValueError, match='CUDA'):
            fn(*args)
    with pytest.raises(ValueError, match='CUDA'):
        smallmat.solve_small_cuda(torch.eye(3)[None], torch.ones(1, 3, 2))
    assert build.LAUNCHES == before
