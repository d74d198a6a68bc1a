"""HMM message passing over a batch of padded trials (the port of
``behavenet_tpu/ops/hmm.py``).

The JAX package writes each recursion for one trial and ``vmap``s it over
the trials; here every function takes the trial axis written out:

- ``log_pi0``: (K,) initial state log-probs;
- ``log_P``: (K, K) stationary transition log-probs, rows = from-state, or
  per trial and step (N, T-1, K, K), the step t -> t+1 reading
  ``log_P[n, t]`` (JAX: ops/hmm.py:32 ``_get_log_P``, for the recurrent
  transitions);
- ``log_lik``: (N, T, K) per-frame observation log-likelihoods;
- ``mask``: (N, T) float, 1 on a trial's frames and 0 on its padding. A
  padded frame carries alpha, beta and delta through unchanged and adds
  nothing to the posteriors.

:func:`forward_backward` and :func:`log_normalizer` run K9
(``kernels/hmm_forward_backward.cu``) and :func:`viterbi` K10
(``kernels/hmm_viterbi.cu``) on ``cuda`` tensors, or with ``parallel`` the
chunked parallel-prefix scans K13 and K14 (``kernels/hmm_scan.cu``);
:func:`sample_posterior` draws posterior paths with K15 and
:func:`sample_states` prior chains with K16 (``kernels/hmm_sample.cu``).
On ``cpu`` tensors the plain PyTorch versions beside them run, picked from
the input's device and from nothing else. A time-varying ``log_P`` goes to
the kernels' ``_tv`` launchers, which also write the per-step pairwise
posteriors for :func:`forward_backward`'s ``with_xi``. Randomness comes
from an explicit ``torch.Generator`` (the JAX package's ``key``); each
sampler's plain version takes its uniforms explicitly, so that a test can
feed it JAX's.
"""

import math

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import launch
from behavenet_tpu_torch.ops.scans import chunked_prefix_scan, prefix_scan

__all__ = ['forward_plain', 'backward_plain', 'forward_backward_plain',
           'expected_transitions_plain', 'viterbi_plain', 'forward_parallel_plain',
           'backward_parallel_plain', 'viterbi_parallel_plain', 'presample_path_draws_plain',
           'sample_posterior_plain', 'sample_states_plain', 'forward_backward',
           'forward_backward_cuda', 'forward_backward_scan_cuda', 'log_normalizer',
           'log_normalizer_cuda', 'forward_scan_cuda', 'forward_alpha_cuda', 'viterbi',
           'viterbi_cuda', 'viterbi_scan_cuda', 'sample_posterior', 'sample_posterior_cuda',
           'sample_states', 'sample_states_cuda', 'path_log_prob', 'scan_chunk']

_MAX_K = 32   # K9, K10 and K13-K16 put state k in lane k of a warp


def _mask(log_lik, mask):
    if mask is None:
        return torch.ones(log_lik.shape[:2], dtype=log_lik.dtype, device=log_lik.device)
    return mask.to(log_lik.dtype)


def _step_P(log_P, t):
    """The log-transitions of step t -> t+1 as (1 or N, K, K)."""
    return log_P[None] if log_P.dim() == 2 else log_P[:, t]


def _steps_P(log_P):
    """All steps' log-transitions as (1 or N, T-1 or 1, K, K)."""
    return log_P[None, None] if log_P.dim() == 2 else log_P


# ------------------------------------------------------------ plain versions


def forward_plain(log_pi0, log_P, log_lik, mask=None):
    """Forward (alpha) recursion in log space (JAX: ops/hmm.py:39).
    Returns (log_alpha (N, T, K), log_Z (N,))."""
    mask = _mask(log_lik, mask)
    T = log_lik.shape[1]
    alpha = log_pi0[None] + log_lik[:, 0] * mask[:, 0, None]
    alphas = [alpha]
    for t in range(1, T):
        a = torch.logsumexp(alpha[:, :, None] + _step_P(log_P, t - 1), dim=1) \
            + log_lik[:, t] * mask[:, t, None]
        alpha = torch.where(mask[:, t, None] > 0, a, alpha)
        alphas.append(alpha)
    log_alpha = torch.stack(alphas, dim=1)
    return log_alpha, torch.logsumexp(log_alpha[:, -1], dim=1)


def backward_plain(log_P, log_lik, mask=None):
    """Backward (beta) recursion in log space (JAX: ops/hmm.py:94).
    Returns log_beta (N, T, K)."""
    mask = _mask(log_lik, mask)
    N, T, K = log_lik.shape
    beta = torch.zeros((N, K), dtype=log_lik.dtype, device=log_lik.device)
    betas = [beta]
    for t in range(T - 2, -1, -1):
        w = log_lik[:, t + 1] * mask[:, t + 1, None] + beta
        b = torch.logsumexp(_step_P(log_P, t) + w[:, None, :], dim=2)
        beta = torch.where(mask[:, t + 1, None] > 0, b, beta)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=1)


def _posteriors(log_P, log_lik, mask, log_alpha, log_beta):
    """gamma (N, T, K) and the per-step pairwise posteriors xi (N, T-1, K,
    K), each normalized per step over its own max and logsumexp, then
    masked (JAX: ops/hmm.py:146-163, :176-183)."""
    log_gamma = log_alpha + log_beta
    log_gamma = log_gamma - log_gamma.max(dim=2, keepdim=True).values
    log_gamma = log_gamma - torch.logsumexp(log_gamma, dim=2, keepdim=True)
    gamma = torch.exp(log_gamma) * mask[:, :, None]

    log_xi = (log_alpha[:, :-1, :, None] + _steps_P(log_P)
              + (log_lik[:, 1:] * mask[:, 1:, None] + log_beta[:, 1:])[:, :, None, :])
    log_xi = log_xi - log_xi.amax(dim=(2, 3), keepdim=True)
    log_xi = log_xi - torch.logsumexp(log_xi.flatten(2), dim=2)[:, :, None, None]
    pair_mask = (mask[:, :-1] * mask[:, 1:])[:, :, None, None]
    return gamma, torch.exp(log_xi) * pair_mask


def forward_backward_plain(log_pi0, log_P, log_lik, mask=None, with_xi=False, parallel=False):
    """Posterior marginals and expected transition counts (JAX:
    ops/hmm.py:115).

    Returns (gamma (N, T, K), log_Z (N,), xi_sum (N, K, K)), and with
    ``with_xi`` the per-step pairwise posteriors xi (N, T-1, K, K) of
    :func:`expected_transitions_plain` fourth: gamma are the posterior
    marginals p(z_t | x), normalized per step with the row max subtracted
    first; xi_sum is the masked sum over t of the pairwise posteriors
    p(z_t, z_{t+1} | x). ``parallel`` runs the message passes as
    parallel-prefix scans (:func:`forward_parallel_plain`,
    :func:`backward_parallel_plain`): the same function to float32
    roundoff.
    """
    mask = _mask(log_lik, mask)
    if parallel:
        log_alpha, log_Z = forward_parallel_plain(log_pi0, log_P, log_lik, mask)
        log_beta = backward_parallel_plain(log_P, log_lik, mask)
    else:
        log_alpha, log_Z = forward_plain(log_pi0, log_P, log_lik, mask)
        log_beta = backward_plain(log_P, log_lik, mask)
    gamma, xi = _posteriors(log_P, log_lik, mask, log_alpha, log_beta)
    out = (gamma, log_Z, torch.sum(xi, dim=1))
    return out + (xi,) if with_xi else out


def expected_transitions_plain(log_pi0, log_P, log_lik, mask=None):
    """Per-step pairwise posteriors (N, T-1, K, K), zero where a step touches
    a padded frame (JAX: ops/hmm.py:167 ``expected_transitions``)."""
    return forward_backward_plain(log_pi0, log_P, log_lik, mask, with_xi=True)[3]


def viterbi_plain(log_pi0, log_P, log_lik, mask=None):
    """Most likely state paths (N, T) int32 by max-product and backtrace
    (JAX: ops/hmm.py:186); ties go to the lowest state index, as
    ``jnp.argmax``; a padded step's backpointer is the identity."""
    mask = _mask(log_lik, mask)
    N, T, K = log_lik.shape
    iota = torch.arange(K, device=log_lik.device).expand(N, K)
    delta = log_pi0[None] + log_lik[:, 0] * mask[:, 0, None]
    backptrs = []
    for t in range(1, T):
        scores = delta[:, :, None] + _step_P(log_P, t - 1)   # (N, from, to)
        best_prev = torch.argmax(scores, dim=1)
        d = scores.amax(dim=1) + log_lik[:, t] * mask[:, t, None]
        keep = mask[:, t, None] > 0
        delta = torch.where(keep, d, delta)
        backptrs.append(torch.where(keep, best_prev, iota))
    z = torch.argmax(delta, dim=1)
    zs = [z]
    for bp in backptrs[::-1]:
        z = bp.gather(1, z[:, None])[:, 0]
        zs.append(z)
    return torch.stack(zs[::-1], dim=1).to(torch.int32)


def path_log_prob(log_pi0, log_P, log_lik, mask, path):
    """Joint log-probability (N,) of state paths (N, T) under the chain:
    log_pi0[z_0] + sum over frames of log_lik, plus log_P over every step
    into a frame that is not padded."""
    mask = _mask(log_lik, mask)
    z = path.long()
    lik = log_lik.gather(2, z[:, :, None])[:, :, 0] * mask
    if log_P.dim() == 2:
        trans = log_P[z[:, :-1], z[:, 1:]]
    else:
        N, T = z.shape
        trans = log_P[torch.arange(N, device=z.device)[:, None],
                      torch.arange(T - 1, device=z.device)[None], z[:, :-1], z[:, 1:]]
    return log_pi0[z[:, 0]] + lik.sum(dim=1) + (trans * mask[:, 1:]).sum(dim=1)


# ------------------------------------------- parallel-prefix plain versions
# The forward recursion is a chain of log-space vector-matrix products;
# reassociated as a scan over the (K, K) step matrices it has depth log T
# instead of T (JAX: ops/hmm.py:369-432). Very long chains scan in chunks
# (JAX: :380-381, chunked there to bound XLA's compile time).

_CHUNK_ABOVE = 16384
_CHUNK = 8192


def _prefix(combine, elems, identity, reverse=False):
    """Scan over the leading (time) axis (JAX: ops/hmm.py:384)."""
    if elems.shape[0] > _CHUNK_ABOVE:
        return chunked_prefix_scan(combine, elems, identity, _CHUNK, reverse=reverse)
    return prefix_scan(combine, elems, reverse=reverse)


def _log_matmul(A, B):
    """(..., K, K) log-space matrix product logsumexp_k A[.., i, k] + B[..,
    k, j], as the JAX package computes it (ops/hmm.py:390): a max-shifted
    real product, clamped at 1e-38 before the log."""
    sA = A.amax(dim=-1, keepdim=True)
    sB = B.amax(dim=-2, keepdim=True)
    sA = torch.where(torch.isfinite(sA), sA, torch.zeros_like(sA))
    sB = torch.where(torch.isfinite(sB), sB, torch.zeros_like(sB))
    prod = torch.matmul(torch.exp(A - sA), torch.exp(B - sB))
    return sA + sB + torch.log(torch.clamp(prod, min=1e-38))


def _maxplus_matmul(A, B):
    """(..., K, K) (max, +) product: max_k A[.., i, k] + B[.., k, j] (JAX:
    ops/hmm.py:220)."""
    return (A[..., :, :, None] + B[..., None, :, :]).amax(dim=-2)


def _compose_maps(later, earlier):
    """Index-map composition for the backtrace and posterior-sample suffix
    scans (JAX: ops/hmm.py:271): (earlier o later)[k] = earlier[later[k]];
    the identity is arange(K)."""
    later, earlier = torch.broadcast_tensors(later, earlier)
    return torch.gather(earlier, -1, later)


def _identity(K, like):
    """The (K, K) identity of the log and (max, +) semirings: 0 on the
    diagonal, -inf off it."""
    eye = torch.eye(K, dtype=torch.bool, device=like.device)
    return torch.where(eye, torch.zeros((), dtype=like.dtype, device=like.device),
                       torch.full((), float('-inf'), dtype=like.dtype, device=like.device))


def _chain(log_P, log_lik, mask):
    """The step matrices M_t(i, j) = log_P_t(i, j) + log_lik[t+1, j] m[t+1],
    the identity on a step into a padded frame: (T-1, N, K, K), time
    leading, and the identity."""
    N, T, K = log_lik.shape
    Ms = _steps_P(log_P) + (log_lik[:, 1:] * mask[:, 1:, None])[:, :, None, :]
    ident = _identity(K, log_lik)
    Ms = torch.where(mask[:, 1:, None, None] > 0, Ms, ident)
    return Ms.transpose(0, 1), ident


def forward_parallel_plain(log_pi0, log_P, log_lik, mask=None):
    """Forward pass by a parallel-prefix scan in log space (JAX:
    ops/hmm.py:404 ``forward_parallel``). Returns (log_alpha (N, T, K),
    log_Z (N,))."""
    mask = _mask(log_lik, mask)
    alpha0 = log_pi0[None] + log_lik[:, 0] * mask[:, 0, None]
    Ms, ident = _chain(log_P, log_lik, mask)
    prefix = _prefix(_log_matmul, Ms, ident)                          # (T-1, N, K, K)
    alphas = torch.logsumexp(alpha0[None, :, :, None] + prefix, dim=2)   # (T-1, N, K)
    log_alpha = torch.cat([alpha0[:, None], alphas.transpose(0, 1)], dim=1)
    return log_alpha, torch.logsumexp(log_alpha[:, -1], dim=1)


def backward_parallel_plain(log_P, log_lik, mask=None):
    """Backward pass by a parallel-prefix suffix scan (JAX: ops/hmm.py:65
    ``backward_parallel``): beta_t is the row logsumexp of M_t x ... x
    M_{T-2}, scanned as transposes. Returns log_beta (N, T, K)."""
    mask = _mask(log_lik, mask)
    N, _, K = log_lik.shape
    zeros = torch.zeros((N, 1, K), dtype=log_lik.dtype, device=log_lik.device)
    Ms, ident = _chain(log_P, log_lik, mask)
    suffix_T = _prefix(_log_matmul, Ms.transpose(-1, -2), ident, reverse=True)
    betas = torch.logsumexp(suffix_T.transpose(-1, -2), dim=-1)      # (T-1, N, K)
    return torch.cat([betas.transpose(0, 1), zeros], dim=1)


def _backtrace(psi, z_last, parallel):
    """Paths (N, T) int32 from the maps psi (N, T-1, K) (z_t = psi_t[z_{t+1}])
    and the last states (N,): a T-step loop, or with ``parallel`` the
    pointer-doubling suffix scan of the maps (JAX: ops/hmm.py:260-268,
    :340-350)."""
    N, S, K = psi.shape
    if parallel and S:
        iota = torch.arange(K, dtype=psi.dtype, device=psi.device)
        comp = _prefix(_compose_maps, psi.transpose(0, 1), iota, reverse=True)   # (S, N, K)
        zs = torch.gather(comp, 2, z_last[None, :, None].expand(S, N, 1))[:, :, 0].T
    else:
        z, cols = z_last, []
        for t in range(S - 1, -1, -1):
            z = torch.gather(psi[:, t], 1, z[:, None])[:, 0]
            cols.append(z)
        zs = torch.stack(cols[::-1], dim=1) if cols else psi.new_zeros((N, 0))
    return torch.cat([zs, z_last[:, None]], dim=1).to(torch.int32)


def viterbi_parallel_plain(log_pi0, log_P, log_lik, mask=None):
    """Viterbi by a (max, +) parallel-prefix scan (JAX: ops/hmm.py:225
    ``viterbi_parallel``): the deltas from the scan, every backpointer from
    the completed deltas at once (lowest index on ties, the identity on a
    padded step), then the pointer-doubling backtrace. Returns (N, T)
    int32."""
    mask = _mask(log_lik, mask)
    K = log_lik.shape[2]
    delta0 = log_pi0[None] + log_lik[:, 0] * mask[:, 0, None]
    Ms, ident = _chain(log_P, log_lik, mask)
    prefix = _prefix(_maxplus_matmul, Ms, ident)
    deltas = (delta0[None, :, :, None] + prefix).amax(dim=2).transpose(0, 1)
    delta = torch.cat([delta0[:, None], deltas], dim=1)                 # (N, T, K)
    scores = delta[:, :-1, :, None] + _steps_P(log_P)                   # (N, T-1, K, K)
    psi = torch.argmax(scores, dim=2)
    iota = torch.arange(K, device=log_lik.device).expand_as(psi)
    psi = torch.where(mask[:, 1:, None] > 0, psi, iota)
    return _backtrace(psi, torch.argmax(delta[:, -1], dim=1), parallel=True)


# ------------------------------------------------------ sampling, plain


def gumbel(u):
    """Gumbel noise -log(-log u) of uniforms ``u`` in [tiny, 1), as
    ``jax.random.gumbel`` makes it (a categorical draw is the argmax of
    logits plus this noise)."""
    return -torch.log(-torch.log(u))


def presample_path_draws_plain(log_alpha, log_P, mask, u_last, u_maps):
    """The final states (N,) and the presampled predecessor maps psi (N,
    T-1, K) of FFBS (JAX: ops/hmm.py:280 ``_presample_path_draws``):
    psi[n, t, k] ~ p(z_t | z_{t+1} = k, x_{1:t}) by the Gumbel argmax over
    the predecessor of (logits - row max) + gumbel(u_maps[n, t, k]), u_maps
    (N, T-1, K, K) in JAX's (t, to, from) layout; a row max that is not
    finite is taken as 0; a step into a padded frame gets the identity map.
    z_T from the last alpha minus its max plus gumbel(u_last) (N, K)."""
    mask = _mask(log_alpha, mask)
    last = log_alpha[:, -1]
    z_last = torch.argmax(last - last.amax(dim=1, keepdim=True) + gumbel(u_last), dim=1)
    logits = (log_alpha[:, :-1, :, None] + _steps_P(log_P)).transpose(-1, -2)
    shift = logits.amax(dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    psi = torch.argmax(logits - shift + gumbel(u_maps), dim=-1)
    iota = torch.arange(psi.shape[-1], device=psi.device).expand_as(psi)
    return z_last, torch.where(mask[:, 1:, None] > 0, psi, iota)


def sample_posterior_plain(log_pi0, log_P, log_lik, mask, u_last, u_maps, parallel=False):
    """Posterior state paths (N, T) int32 by forward filtering, backward
    sampling (JAX: ops/hmm.py:310 ``sample_posterior``) from the uniforms
    ``u_last`` (N, K) and ``u_maps`` (N, T-1, K, K): the filtered alphas of
    the sequential or, with ``parallel``, the parallel forward pass, the
    presampled maps of :func:`presample_path_draws_plain`, composed by a
    T-step loop or the pointer-doubling suffix scan (the same paths from
    the same maps)."""
    mask = _mask(log_lik, mask)
    fwd = forward_parallel_plain if parallel else forward_plain
    log_alpha, _ = fwd(log_pi0, log_P, log_lik, mask)
    z_last, psi = presample_path_draws_plain(log_alpha, log_P, mask, u_last, u_maps)
    return _backtrace(psi, z_last, parallel)


def sample_states_plain(log_pi0, log_P, u0, u):
    """Prior state chains (B, T) int32 (JAX: ops/hmm.py:353 ``sample_states``,
    B chains): z_0 = argmax(log_pi0 + gumbel(u0)), z_t = argmax(log_P[z_{t-1}]
    + gumbel(u[:, t-1])), from uniforms u0 (B, K) and u (B, T-1, K)."""
    z = torch.argmax(log_pi0[None] + gumbel(u0), dim=1)
    g = gumbel(u)
    zs = [z]
    for t in range(u.shape[1]):
        z = torch.argmax(log_P[z] + g[:, t], dim=1)
        zs.append(z)
    return torch.stack(zs, dim=1).to(torch.int32)


# -------------------------------------------------------------- the kernels


def _check(name, log_pi0, log_P, log_lik, mask):
    """Checks a kernel's inputs; returns N, T, K, whether ``log_P`` is
    time-varying, and the inputs made contiguous."""
    tensors = (log_pi0, log_P, log_lik, mask)
    for t in tensors:
        if t.device.type != 'cuda' or t.device != log_lik.device:
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
        if t.dtype != torch.float32:
            raise ValueError('%s: tensors must be float32, got %s' % (name, t.dtype))
    if log_lik.dim() != 3:
        raise ValueError('%s: log_lik must be (N, T, K), got %s'
                         % (name, tuple(log_lik.shape)))
    N, T, K = log_lik.shape
    if log_pi0.shape != (K,) or log_P.shape not in ((K, K), (N, T - 1, K, K)) or \
            mask.shape != (N, T):
        raise ValueError('%s: takes log_pi0 (K,), log_P (K, K) or (N, T-1, K, K) and '
                         'mask (N, T) beside log_lik %s, got %s %s %s'
                         % (name, (N, T, K), tuple(log_pi0.shape), tuple(log_P.shape),
                            tuple(mask.shape)))
    if not 1 <= K <= _MAX_K or T < 1:
        raise ValueError('%s: takes 1 <= K <= %d states and T >= 1, got K=%d, T=%d'
                         % (name, _MAX_K, K, T))
    return N, T, K, log_P.dim() == 4, (t.contiguous() for t in tensors)


def forward_backward_cuda(log_pi0, log_P, log_lik, mask, with_xi=False):
    """K9 on the card: (gamma, log_Z, xi_sum[, xi]) as
    :func:`forward_backward_plain`. The forward and backward passes write
    log_alpha and log_beta (N, T, K) to scratch, a last pass the
    posteriors. A time-varying ``log_P`` runs the ``_tv`` launcher, which
    reads ``log_P[n, t]`` per step and, with ``with_xi``, writes the
    per-step xi; ``with_xi`` takes a time-varying ``log_P`` only."""
    name = 'hmm_forward_backward'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    if with_xi and not tv:
        raise ValueError('%s: with_xi takes a time-varying log_P (N, T-1, K, K), got %s'
                         % (name, tuple(log_P.shape)))
    dev = ll.device
    scratch = torch.empty((2, N, T, K), device=dev, dtype=torch.float32)
    gamma = torch.empty((N, T, K), device=dev, dtype=torch.float32)
    log_Z = torch.empty(N, device=dev, dtype=torch.float32)
    xi_sum = torch.empty((N, K, K), device=dev, dtype=torch.float32)
    xi = torch.empty((N, T - 1, K, K), device=dev, dtype=torch.float32) if with_xi else None
    if N:
        args = (pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
                scratch[0].data_ptr(), scratch[1].data_ptr(), gamma.data_ptr(),
                log_Z.data_ptr(), xi_sum.data_ptr())
        if tv:
            launch(name, *args, xi.data_ptr() if with_xi else None,
                   symbol='bn_hmm_forward_backward_tv')
        else:
            launch(name, *args, symbol='bn_hmm_forward_backward')
    out = (gamma, log_Z, xi_sum)
    return out + (xi,) if with_xi else out


def log_normalizer_cuda(log_pi0, log_P, log_lik, mask):
    """K9's forward pass alone on the card: log_Z (N,)."""
    name = 'hmm_forward_backward'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    log_Z = torch.empty(N, device=ll.device, dtype=torch.float32)
    if N:
        launch(name, pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
               log_Z.data_ptr(), symbol='bn_hmm_forward_tv' if tv else 'bn_hmm_forward')
    return log_Z


def viterbi_cuda(log_pi0, log_P, log_lik, mask):
    """K10 on the card: the (N, T) int32 paths of :func:`viterbi_plain`.
    Backpointers go to (N, T-1, K) int32 scratch; the backtrace runs in the
    same kernel. A time-varying ``log_P`` runs the ``_tv`` launcher."""
    name = 'hmm_viterbi'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    dev = ll.device
    backptrs = torch.empty((N, max(T - 1, 1), K), device=dev, dtype=torch.int32)
    path = torch.empty((N, T), device=dev, dtype=torch.int32)
    if N:
        launch(name, pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
               backptrs.data_ptr(), path.data_ptr(),
               symbol='bn_hmm_viterbi_tv' if tv else 'bn_hmm_viterbi')
    return path


def scan_chunk(T):
    """The chunk length L of K13-K15 for T frames: a power of two of at
    least 32 near sqrt(T - 1), so that the chains of a chunk (L steps) and
    across chunks (T / L) are both short."""
    return max(32, 1 << int(round(math.log2(math.sqrt(max(T - 1, 1))))))


def _n_chunks(T, L):
    return -(-(T - 1) // L) if T > 1 else 1


def _scan_scratch(N, T, K, dev):
    """K13/K14's chunk length and scratch: the chunk products (N, C, K, K)
    and the entry vectors of both directions (2, N, C+1, K)."""
    L = scan_chunk(T)
    C = _n_chunks(T, L)
    return (L, C, torch.empty((N, C, K, K), device=dev, dtype=torch.float32),
            torch.empty((2, N, C + 1, K), device=dev, dtype=torch.float32))


def forward_backward_scan_cuda(log_pi0, log_P, log_lik, mask, with_xi=False):
    """K13 on the card: (gamma, log_Z, xi_sum[, xi]) as
    :func:`forward_backward_plain` with ``parallel=True``, by chunked
    parallel-prefix scans (``kernels/hmm_scan.cu``), then K9's posterior
    pass over chunks of frames. A time-varying ``log_P`` runs the ``_tv``
    launcher, which alone takes ``with_xi``."""
    name = 'hmm_scan'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    if with_xi and not tv:
        raise ValueError('%s: with_xi takes a time-varying log_P (N, T-1, K, K), got %s'
                         % (name, tuple(log_P.shape)))
    dev = ll.device
    L, C, prod, entries = _scan_scratch(N, T, K, dev)
    Cp = -(-T // L)
    passes = torch.empty((2, N, T, K), device=dev, dtype=torch.float32)
    parts = torch.empty((N, Cp, K, K), device=dev, dtype=torch.float32)
    gamma = torch.empty((N, T, K), device=dev, dtype=torch.float32)
    log_Z = torch.empty(N, device=dev, dtype=torch.float32)
    xi_sum = torch.empty((N, K, K), device=dev, dtype=torch.float32)
    xi = torch.empty((N, T - 1, K, K), device=dev, dtype=torch.float32) if with_xi else None
    if N:
        args = (pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K, L,
                prod.data_ptr(), entries.data_ptr(), passes[0].data_ptr(),
                passes[1].data_ptr(), parts.data_ptr(), gamma.data_ptr(), log_Z.data_ptr(),
                xi_sum.data_ptr())
        if tv:
            launch(name, *args, xi.data_ptr() if with_xi else None,
                   symbol='bn_hmm_scan_forward_backward_tv')
        else:
            launch(name, *args, symbol='bn_hmm_scan_forward_backward')
    out = (gamma, log_Z, xi_sum)
    return out + (xi,) if with_xi else out


def forward_scan_cuda(log_pi0, log_P, log_lik, mask, with_alpha=False):
    """K13's forward phases on the card: log_Z (N,) from the chunk products
    and the entry vectors alone, and with ``with_alpha`` (log_alpha (N, T,
    K), log_Z) from the chunks' recursions too."""
    name = 'hmm_scan'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    dev = ll.device
    L, _, prod, entries = _scan_scratch(N, T, K, dev)
    log_Z = torch.empty(N, device=dev, dtype=torch.float32)
    log_alpha = torch.empty((N, T, K), device=dev, dtype=torch.float32) if with_alpha else None
    if N:
        launch(name, pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K, L,
               prod.data_ptr(), entries.data_ptr(), log_Z.data_ptr(),
               log_alpha.data_ptr() if with_alpha else None,
               symbol='bn_hmm_scan_forward_tv' if tv else 'bn_hmm_scan_forward')
    return (log_alpha, log_Z) if with_alpha else log_Z


def forward_alpha_cuda(log_pi0, log_P, log_lik, mask):
    """K9's forward pass alone on the card, writing the filtered alphas:
    (log_alpha (N, T, K), log_Z (N,)) as :func:`forward_plain`."""
    name = 'hmm_forward_backward'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    log_Z = torch.empty(N, device=ll.device, dtype=torch.float32)
    log_alpha = torch.empty((N, T, K), device=ll.device, dtype=torch.float32)
    if N:
        launch(name, pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
               log_Z.data_ptr(), log_alpha.data_ptr(),
               symbol='bn_hmm_forward_alpha_tv' if tv else 'bn_hmm_forward_alpha')
    return log_alpha, log_Z


def viterbi_scan_cuda(log_pi0, log_P, log_lik, mask):
    """K14 on the card: the (N, T) int32 paths of
    :func:`viterbi_parallel_plain`: the (max, +) chunked scan writes the
    backpointers (N, T-1, K) and the last states, the chunked backtrace
    composes them (``kernels/hmm_scan.cu``, ``hmm_backtrace.cuh``)."""
    name = 'hmm_viterbi_scan'
    N, T, K, tv, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
    dev = ll.device
    L, C, prod, entries = _scan_scratch(N, T, K, dev)
    psi = torch.empty((N, max(T - 1, 1), K), device=dev, dtype=torch.int32)
    maps = torch.empty((N, C, K), device=dev, dtype=torch.int32)
    bounds = torch.empty((N, C + 1), device=dev, dtype=torch.int32)
    path = torch.empty((N, T), device=dev, dtype=torch.int32)
    if N:
        launch('hmm_scan', pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T,
               K, L, prod.data_ptr(), entries.data_ptr(), psi.data_ptr(), maps.data_ptr(),
               bounds.data_ptr(), path.data_ptr(),
               symbol='bn_hmm_viterbi_scan_tv' if tv else 'bn_hmm_viterbi_scan')
    return path


def _check_tensors(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
        if t.dtype != dt:
            raise ValueError('%s: takes %s tensors, got %s' % (name, dt, t.dtype))


def sample_posterior_cuda(log_alpha, log_P, mask, u_last, u_maps):
    """K15 on the card: posterior paths (N, T) int32 from the filtered
    alphas (N, T, K), ``log_P`` (K, K) or (N, T-1, K, K), the mask and the
    uniforms u_last (N, K) and u_maps (N, T-1, K, K): the presampled maps of
    :func:`presample_path_draws_plain` composed by the chunked backtrace
    (``kernels/hmm_sample.cu``)."""
    name = 'hmm_sample_posterior'
    tensors = (log_alpha, log_P, mask, u_last, u_maps)
    _check_tensors(name, tensors, (torch.float32,) * 5)
    N, T, K = log_alpha.shape
    tv = log_P.dim() == 4
    if log_P.shape not in ((K, K), (N, T - 1, K, K)) or mask.shape != (N, T) or \
            u_last.shape != (N, K) or u_maps.shape != (N, T - 1, K, K):
        raise ValueError('%s: takes log_P (K, K) or (N, T-1, K, K), mask (N, T), u_last '
                         '(N, K) and u_maps (N, T-1, K, K) beside log_alpha %s, got %s'
                         % (name, (N, T, K), [tuple(t.shape) for t in tensors[1:]]))
    if not 1 <= K <= _MAX_K or T < 1:
        raise ValueError('%s: takes 1 <= K <= %d states and T >= 1, got K=%d, T=%d'
                         % (name, _MAX_K, K, T))
    la, lp, m, ul, um = (t.contiguous() for t in tensors)
    dev = la.device
    L = scan_chunk(T)
    C = _n_chunks(T, L)
    psi = torch.empty((N, max(T - 1, 1), K), device=dev, dtype=torch.int32)
    maps = torch.empty((N, C, K), device=dev, dtype=torch.int32)
    bounds = torch.empty((N, C + 1), device=dev, dtype=torch.int32)
    path = torch.empty((N, T), device=dev, dtype=torch.int32)
    if N:
        launch(name, la.data_ptr(), lp.data_ptr(), m.data_ptr(), ul.data_ptr(), um.data_ptr(),
               N, T, K, L, psi.data_ptr(), maps.data_ptr(), bounds.data_ptr(), path.data_ptr(),
               symbol='bn_hmm_sample_posterior_tv' if tv else 'bn_hmm_sample_posterior')
    return path


def sample_states_cuda(log_pi0, log_P, u0, u):
    """K16 on the card: B prior state chains (B, T) int32 as
    :func:`sample_states_plain`, one thread per chain."""
    name = 'hmm_sample_states'
    _check_tensors(name, (log_pi0, log_P, u0, u), (torch.float32,) * 4)
    K = log_pi0.shape[0]
    B, S = u.shape[:2]
    if log_P.shape != (K, K) or u0.shape != (B, K) or u.shape != (B, S, K):
        raise ValueError('%s: takes log_pi0 (K,), log_P (K, K), u0 (B, K) and u (B, T-1, '
                         'K), got %s' % (name, [tuple(t.shape) for t in (log_pi0, log_P, u0,
                                                                           u)]))
    if not 1 <= K <= _MAX_K:
        raise ValueError('%s: takes 1 <= K <= %d states, got K=%d' % (name, _MAX_K, K))
    pi0, lp, u0, u = (t.contiguous() for t in (log_pi0, log_P, u0, u))
    path = torch.empty((B, S + 1), device=pi0.device, dtype=torch.int32)
    if B:
        launch('hmm_sample_posterior', pi0.data_ptr(), lp.data_ptr(), u0.data_ptr(),
               u.data_ptr(), B, S + 1, K, path.data_ptr(), symbol='bn_hmm_sample_states')
    return path


def _dispatch(name, log_lik):
    if log_lik.device.type not in ('cpu', 'cuda'):
        raise ValueError('%s: no implementation for device %s' % (name, log_lik.device))
    return log_lik.device.type == 'cpu'


def forward_backward(log_pi0, log_P, log_lik, mask=None, with_xi=False, parallel=False):
    """(gamma (N, T, K), log_Z (N,), xi_sum (N, K, K)[, xi (N, T-1, K, K)])
    of a batch of trials (JAX: ops/hmm.py:115, and with ``with_xi`` :167
    ``expected_transitions`` from the same passes): on the card K9, or with
    ``parallel`` K13; the plain version on the CPU."""
    mask = _mask(log_lik, mask)
    if _dispatch('forward_backward', log_lik):
        return forward_backward_plain(log_pi0, log_P, log_lik, mask, with_xi, parallel)
    if parallel:
        return forward_backward_scan_cuda(log_pi0, log_P, log_lik, mask, with_xi)
    return forward_backward_cuda(log_pi0, log_P, log_lik, mask, with_xi)


def log_normalizer(log_pi0, log_P, log_lik, mask=None, parallel=False):
    """The marginal log-likelihood log_Z (N,) of each trial, the forward pass
    alone (JAX: ops/hmm.py:39 ``forward``'s second output, or :404
    ``forward_parallel``'s with ``parallel``): K9's or K13's forward phases
    on the card, the plain version on the CPU."""
    mask = _mask(log_lik, mask)
    if _dispatch('log_normalizer', log_lik):
        fwd = forward_parallel_plain if parallel else forward_plain
        return fwd(log_pi0, log_P, log_lik, mask)[1]
    if parallel:
        return forward_scan_cuda(log_pi0, log_P, log_lik, mask)
    return log_normalizer_cuda(log_pi0, log_P, log_lik, mask)


def viterbi(log_pi0, log_P, log_lik, mask=None, parallel=False):
    """Most likely state paths (N, T) int32 (JAX: ops/hmm.py:186, or :225
    ``viterbi_parallel``): K10, or with ``parallel`` K14, on the card; the
    plain version on the CPU."""
    mask = _mask(log_lik, mask)
    if _dispatch('viterbi', log_lik):
        return (viterbi_parallel_plain if parallel else viterbi_plain)(log_pi0, log_P,
                                                                        log_lik, mask)
    if parallel:
        return viterbi_scan_cuda(log_pi0, log_P, log_lik, mask)
    return viterbi_cuda(log_pi0, log_P, log_lik, mask)


def generator_for(device, generator=None):
    """``generator``, or one on ``device`` seeded from numpy's global state
    (as the JAX package draws a key when none is given)."""
    if generator is not None:
        return generator
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))
    return gen


def uniforms(shape, generator, device):
    """Uniforms in [tiny, 1) from ``generator``: ``torch.rand`` clamped below
    at float32's smallest normal, as ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


def sample_posterior(log_pi0, log_P, log_lik, mask=None, parallel=False, generator=None):
    """Posterior state paths (N, T) int32 by forward filtering, backward
    sampling (JAX: ops/hmm.py:310 ``sample_posterior``), the uniforms drawn
    from ``generator`` (on the tensors' device; ``None``: seeded from
    numpy): on the card the alphas of K9's forward pass, or with
    ``parallel`` K13's, then K15; the plain version on the CPU."""
    mask = _mask(log_lik, mask)
    N, T, K = log_lik.shape
    dev = log_lik.device
    gen = generator_for(dev, generator)
    u_last = uniforms((N, K), gen, dev)
    u_maps = uniforms((N, max(T - 1, 0), K, K), gen, dev)
    if _dispatch('sample_posterior', log_lik):
        return sample_posterior_plain(log_pi0, log_P, log_lik, mask, u_last, u_maps, parallel)
    if parallel:
        log_alpha, _ = forward_scan_cuda(log_pi0, log_P, log_lik, mask, with_alpha=True)
    else:
        log_alpha, _ = forward_alpha_cuda(log_pi0, log_P, log_lik, mask)
    return sample_posterior_cuda(log_alpha, log_P, mask, u_last, u_maps)


def sample_states(log_pi0, log_P, T, generator=None, chains=1):
    """``chains`` state sequences (chains, T) int32 from the prior (JAX:
    ops/hmm.py:353 ``sample_states``; a (T-1, K, K) ``log_P`` uses its first
    step, as there), the uniforms drawn from ``generator``: K16 on the card,
    the plain version on the CPU."""
    if log_P.dim() == 3:
        log_P = log_P[0]
    K = log_pi0.shape[0]
    dev = log_pi0.device
    gen = generator_for(dev, generator)
    u0 = uniforms((chains, K), gen, dev)
    u = uniforms((chains, T - 1, K), gen, dev)
    if _dispatch('sample_states', log_pi0):
        return sample_states_plain(log_pi0, log_P, u0, u)
    return sample_states_cuda(log_pi0, log_P, u0, u)
