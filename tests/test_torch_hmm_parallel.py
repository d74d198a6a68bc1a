"""The port's parallel-prefix HMM message passing (``behavenet_tpu_torch.ops.hmm``
with ``parallel=True``, ``ops.scans``) against the JAX package's
``forward_parallel`` / ``backward_parallel`` / ``viterbi_parallel`` and
``chunked_prefix_scan``, on the CPU, where the port runs its plain versions
(K13 and K14 run on the card only). Three trials of 40 frames, one cut to 29,
K = 4, stationary and time-varying transitions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu.ops import scans as jscans
from behavenet_tpu_torch.ops import hmm, scans

N, T, K = 3, 40, 4
SHORT = 29


def _chain(seed, tv):
    rs = np.random.RandomState(seed)
    pi0 = rs.dirichlet(np.ones(K))
    if tv:
        P = 0.7 * np.eye(K) + 0.3 * rs.dirichlet(np.ones(K), size=(N, T - 1, K))
    else:
        P = 0.7 * np.eye(K) + 0.3 * rs.dirichlet(np.ones(K), size=K)
    log_lik = rs.randn(N, T, K) * 3.0
    mask = np.ones((N, T))
    mask[1, SHORT:] = 0.0
    log_lik = log_lik * mask[:, :, None]
    f32 = np.float32
    return (np.log(pi0).astype(f32), np.log(P).astype(f32), log_lik.astype(f32),
            mask.astype(f32))


def _compiled(fn, *args):
    """``fn(*args)`` through ``jax.jit``, compiled at LLVM optimization
    level 0 (the same XLA program, built in less time)."""
    compiled = jax.jit(fn).lower(*args).compile({'xla_backend_optimization_level': 0})
    return compiled(*args)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope='module', params=['stationary', 'time_varying'])
def case(request):
    """A chain and JAX's parallel forward-backward, passes and Viterbi of
    every trial, with the per-step xi of its ``expected_transitions``: one
    vmapped, compiled function for the module's case."""
    tv = request.param == 'time_varying'
    chain = _chain(1 if tv else 0, tv)

    def one(pi0, lp, ll, m):
        return dict(fb=jhmm.forward_backward(pi0, lp, ll, m, parallel=True),
                    fwd=jhmm.forward_parallel(pi0, lp, ll, m),
                    bwd=jhmm.backward_parallel(lp, ll, m),
                    xi=jhmm.expected_transitions(pi0, lp, ll, m),
                    viterbi=jhmm.viterbi_parallel(pi0, lp, ll, m))
    out = _compiled(jax.vmap(one, in_axes=(None, 0 if tv else None, 0, 0)), *chain)
    return chain, jax.tree_util.tree_map(np.asarray, out)


def test_forward_backward_parallel_matches_jax(case):
    chain, ref = case
    gamma, log_z, xi_sum = hmm.forward_backward(*_t(*chain), parallel=True)
    want_gamma, want_z, want_xi = ref['fb']
    np.testing.assert_allclose(log_z.numpy(), want_z, rtol=1e-5)
    np.testing.assert_allclose(gamma.numpy(), want_gamma, atol=1e-5)
    np.testing.assert_allclose(xi_sum.numpy(), want_xi, atol=1e-5)
    assert np.all(gamma.numpy()[1, SHORT:] == 0)


def test_forward_backward_parallel_with_xi(case):
    """``with_xi`` works with ``parallel``: the per-step xi from the same
    passes equal JAX's ``expected_transitions`` and sum to xi_sum."""
    chain, ref = case
    pi0, lp, ll, m = _t(*chain)
    if lp.dim() == 2:
        lp = lp.expand(N, T - 1, K, K).contiguous()
    gamma, log_z, xi_sum, xi = hmm.forward_backward(pi0, lp, ll, m, with_xi=True,
                                                    parallel=True)
    np.testing.assert_allclose(xi.numpy(), ref['xi'], atol=1e-5)
    np.testing.assert_allclose(xi.sum(dim=1).numpy(), xi_sum.numpy(), atol=1e-5)
    np.testing.assert_allclose(log_z.numpy(), ref['fb'][1], rtol=1e-5)


def test_parallel_passes_match_jax(case):
    """The passes themselves on the unpadded frames, and log_Z of
    ``log_normalizer(parallel=True)`` against ``forward_parallel``'s."""
    chain, ref = case
    pi0, lp, ll, m = _t(*chain)
    alpha, log_z = hmm.forward_parallel_plain(pi0, lp, ll, m)
    beta = hmm.backward_parallel_plain(lp, ll, m)
    keep = chain[3] > 0
    np.testing.assert_allclose(alpha.numpy()[keep], ref['fwd'][0][keep], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(beta.numpy()[keep], ref['bwd'][keep], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(hmm.log_normalizer(pi0, lp, ll, m, parallel=True).numpy(),
                               ref['fwd'][1], rtol=1e-5)


def test_viterbi_parallel_matches_jax(case):
    chain, ref = case
    path = hmm.viterbi(*_t(*chain), parallel=True)
    assert path.dtype == torch.int32
    np.testing.assert_array_equal(path.numpy(), ref['viterbi'])
    np.testing.assert_array_equal(path.numpy(), hmm.viterbi(*_t(*chain)).numpy())


@pytest.mark.parametrize('reverse', [False, True])
def test_chunked_scan_matches_unchunked_and_jax(reverse):
    """The plain chunked scan at chunk 8 against the unchunked one and
    against JAX's ``chunked_prefix_scan`` at the same chunk, over 37 (4, 4)
    log-semiring elements (a padded last chunk)."""
    rs = np.random.RandomState(3)
    elems = (rs.randn(37, K, K) * 2).astype(np.float32)
    ident = np.where(np.eye(K) > 0, 0.0, -np.inf).astype(np.float32)
    got = scans.chunked_prefix_scan(hmm._log_matmul, torch.from_numpy(elems),
                                    torch.from_numpy(ident), 8, reverse=reverse)
    whole = scans.prefix_scan(hmm._log_matmul, torch.from_numpy(elems), reverse=reverse)
    want = jscans.chunked_prefix_scan(jhmm._log_matmul, jnp.asarray(elems), jnp.asarray(ident),
                                      8, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_long_chain_scans_in_chunks(monkeypatch):
    """Past ``_CHUNK_ABOVE`` steps the plain passes scan in chunks; lowered
    here to 16 (chunk 8), the parallel forward-backward, log_Z and Viterbi
    of a 40-frame chain still equal the unchunked ones."""
    chain = _t(*_chain(2, False))
    want = hmm.forward_backward(*chain, parallel=True)
    want_path = hmm.viterbi(*chain, parallel=True)
    monkeypatch.setattr(hmm, '_CHUNK_ABOVE', 16)
    monkeypatch.setattr(hmm, '_CHUNK', 8)
    for got, w in zip(hmm.forward_backward(*chain, parallel=True), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(hmm.viterbi(*chain, parallel=True).numpy(), want_path.numpy())


def test_scan_and_sampling_wrappers_refuse_cpu_tensors():
    """K13-K16's wrappers take CUDA tensors only (the public functions run
    the plain versions on the CPU); nothing is launched or counted for a
    refused call."""
    from behavenet_tpu_torch.kernels import build
    before = dict(build.LAUNCHES)
    pi0, lp, ll, m = _t(*_chain(0, False))
    u_last, u_maps = torch.rand(N, K), torch.rand(N, T - 1, K, K)
    for call in (lambda: hmm.forward_backward_scan_cuda(pi0, lp, ll, m),
                 lambda: hmm.forward_scan_cuda(pi0, lp, ll, m, with_alpha=True),
                 lambda: hmm.forward_alpha_cuda(pi0, lp, ll, m),
                 lambda: hmm.viterbi_scan_cuda(pi0, lp, ll, m),
                 lambda: hmm.sample_posterior_cuda(ll, lp, m, u_last, u_maps),
                 lambda: hmm.sample_states_cuda(pi0, lp, u_last, u_maps[:, :, 0])):
        with pytest.raises(ValueError, match='CUDA'):
            call()
    assert build.LAUNCHES == before


@pytest.mark.parametrize('T,L', [(1, 32), (1000, 32), (100000, 256), (1 << 20, 1024)])
def test_scan_chunk_length(T, L):
    """The kernels' chunk length: a power of two of at least 32 near
    sqrt(T - 1)."""
    assert hmm.scan_chunk(T) == L
