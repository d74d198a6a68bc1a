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
posteriors for :func:`forward_backward`'s ``with_xi``. K9 and K10 take
float64 inputs too (their ``_f64`` launchers, for float64 EM); the scans
and samplers take float32. Randomness comes
from an explicit ``torch.Generator`` (the JAX package's ``key``); each
sampler's plain version takes its uniforms explicitly, so that a test can
feed it JAX's.
"""

import math

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import check_device, dtype_suffix, launch
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
_MAX_K_F64 = 16   # K9's double instances (kTopK, kernels/hmm_forward_backward.cu)


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


def forward_backward_plain(log_pi0, log_P, log_lik, mask=None, with_xi=False, parallel=False,
                           scan=None):
    """Posterior marginals and expected transition counts (JAX:
    ops/hmm.py:115).

    Returns (gamma (N, T, K), log_Z (N,), xi_sum (N, K, K)), and with
    ``with_xi`` the per-step pairwise posteriors xi (N, T-1, K, K) of
    :func:`expected_transitions_plain` fourth: gamma are the posterior
    marginals p(z_t | x), normalized per step with the row max subtracted
    first; xi_sum is the masked sum over t of the pairwise posteriors
    p(z_t, z_{t+1} | x). ``parallel`` runs the message passes as
    parallel-prefix scans (:func:`forward_parallel_plain`,
    :func:`backward_parallel_plain`, by ``scan``, default :func:`_prefix`):
    the same function to float32 roundoff.
    """
    mask = _mask(log_lik, mask)
    if parallel:
        scan = scan or _prefix
        log_alpha, log_Z = forward_parallel_plain(log_pi0, log_P, log_lik, mask, scan)
        log_beta = backward_parallel_plain(log_P, log_lik, mask, scan)
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


def forward_parallel_plain(log_pi0, log_P, log_lik, mask=None, scan=_prefix):
    """Forward pass by a parallel-prefix scan in log space (JAX:
    ops/hmm.py:404 ``forward_parallel``). Returns (log_alpha (N, T, K),
    log_Z (N,)). ``scan(combine, elems, identity, reverse=False)`` scans
    the time-leading step matrices (``parallel.seq`` passes its
    time-sharded ``sp_scan``)."""
    mask = _mask(log_lik, mask)
    alpha0 = log_pi0[None] + log_lik[:, 0] * mask[:, 0, None]
    Ms, ident = _chain(log_P, log_lik, mask)
    prefix = scan(_log_matmul, Ms, ident)                             # (T-1, N, K, K)
    alphas = torch.logsumexp(alpha0[None, :, :, None] + prefix, dim=2)   # (T-1, N, K)
    log_alpha = torch.cat([alpha0[:, None], alphas.transpose(0, 1)], dim=1)
    return log_alpha, torch.logsumexp(log_alpha[:, -1], dim=1)


def backward_parallel_plain(log_P, log_lik, mask=None, scan=_prefix):
    """Backward pass by a parallel-prefix suffix scan (JAX: ops/hmm.py:65
    ``backward_parallel``): beta_t is the row logsumexp of M_t x ... x
    M_{T-2}, scanned as transposes (by ``scan``, as
    :func:`forward_parallel_plain`'s). Returns log_beta (N, T, K)."""
    mask = _mask(log_lik, mask)
    N, _, K = log_lik.shape
    zeros = torch.zeros((N, 1, K), dtype=log_lik.dtype, device=log_lik.device)
    Ms, ident = _chain(log_P, log_lik, mask)
    suffix_T = scan(_log_matmul, Ms.transpose(-1, -2), ident, reverse=True)
    betas = torch.logsumexp(suffix_T.transpose(-1, -2), dim=-1)      # (T-1, N, K)
    return torch.cat([betas.transpose(0, 1), zeros], dim=1)


def _backtrace(psi, z_last, parallel, scan=_prefix):
    """Paths (N, T) int32 from the maps psi (N, T-1, K) (z_t = psi_t[z_{t+1}])
    and the last states (N,): a T-step loop, or with ``parallel`` the
    pointer-doubling suffix scan of the maps by ``scan`` (JAX:
    ops/hmm.py:260-268, :340-350)."""
    N, S, K = psi.shape
    if parallel and S:
        iota = torch.arange(K, dtype=psi.dtype, device=psi.device)
        comp = scan(_compose_maps, psi.transpose(0, 1), iota, reverse=True)      # (S, N, K)
        zs = torch.gather(comp, 2, z_last[None, :, None].expand(S, N, 1))[:, :, 0].T
    else:
        z, cols = z_last, []
        for t in range(S - 1, -1, -1):
            z = torch.gather(psi[:, t], 1, z[:, None])[:, 0]
            cols.append(z)
        zs = torch.stack(cols[::-1], dim=1) if cols else psi.new_zeros((N, 0))
    return torch.cat([zs, z_last[:, None]], dim=1).to(torch.int32)


def viterbi_parallel_plain(log_pi0, log_P, log_lik, mask=None, scan=_prefix):
    """Viterbi by a (max, +) parallel-prefix scan (JAX: ops/hmm.py:225
    ``viterbi_parallel``): the deltas from the scan, every backpointer from
    the completed deltas at once (lowest index on ties, the identity on a
    padded step), then the pointer-doubling backtrace; both scans by
    ``scan``, as :func:`forward_parallel_plain`'s. Returns (N, T) int32."""
    mask = _mask(log_lik, mask)
    K = log_lik.shape[2]
    delta0 = log_pi0[None] + log_lik[:, 0] * mask[:, 0, None]
    Ms, ident = _chain(log_P, log_lik, mask)
    prefix = scan(_maxplus_matmul, Ms, ident)
    deltas = (delta0[None, :, :, None] + prefix).amax(dim=2).transpose(0, 1)
    delta = torch.cat([delta0[:, None], deltas], dim=1)                 # (N, T, K)
    scores = delta[:, :-1, :, None] + _steps_P(log_P)                   # (N, T-1, K, K)
    psi = torch.argmax(scores, dim=2)
    iota = torch.arange(K, device=log_lik.device).expand_as(psi)
    psi = torch.where(mask[:, 1:, None] > 0, psi, iota)
    return _backtrace(psi, torch.argmax(delta[:, -1], dim=1), parallel=True, scan=scan)


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


def sample_posterior_plain(log_pi0, log_P, log_lik, mask, u_last, u_maps, parallel=False,
                           scan=_prefix):
    """Posterior state paths (N, T) int32 by forward filtering, backward
    sampling (JAX: ops/hmm.py:310 ``sample_posterior``) from the uniforms
    ``u_last`` (N, K) and ``u_maps`` (N, T-1, K, K): the filtered alphas of
    the sequential or, with ``parallel``, the parallel forward pass, the
    presampled maps of :func:`presample_path_draws_plain`, composed by a
    T-step loop or the pointer-doubling suffix scan (the same paths from
    the same maps); with ``parallel`` both scans by ``scan``."""
    mask = _mask(log_lik, mask)
    if parallel:
        log_alpha, _ = forward_parallel_plain(log_pi0, log_P, log_lik, mask, scan)
    else:
        log_alpha, _ = forward_plain(log_pi0, log_P, log_lik, mask)
    z_last, psi = presample_path_draws_plain(log_alpha, log_P, mask, u_last, u_maps)
    return _backtrace(psi, z_last, parallel, scan)


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


def _check(name, log_pi0, log_P, log_lik, mask, float64=False):
    """Checks a kernel's inputs (all float32, or with ``float64`` all
    float64 too: K9's and K10's launchers take it); returns N, T, K,
    whether ``log_P`` is time-varying, the launcher suffix of the dtype
    ('' or '_f64') and the inputs made contiguous."""
    tensors = (log_pi0, log_P, log_lik, mask)
    f64 = dtype_suffix(name, tensors, float64)
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
    return N, T, K, log_P.dim() == 4, f64, (t.contiguous() for t in tensors)


def _check_k9_f64(name, K, f64):
    """K9 in float64 takes at most _MAX_K_F64 states."""
    if f64 and K > _MAX_K_F64:
        raise NotImplementedError(
            '%s: float64 with K=%d states is not ported yet: the float64 forward-backward '
            'takes K <= %d, the rest of ROADMAP item A1c' % (name, K, _MAX_K_F64))


def forward_backward_cuda(log_pi0, log_P, log_lik, mask, with_xi=False):
    """K9 on the card: (gamma, log_Z, xi_sum[, xi]) as
    :func:`forward_backward_plain`, float32 or float64 (the ``_f64``
    launchers, K <= 16) in the inputs' dtype. The forward and backward passes write
    log_alpha and log_beta (N, T, K) to scratch, a last pass the
    posteriors. A time-varying ``log_P`` runs the ``_tv`` launcher, which
    reads ``log_P[n, t]`` per step and, with ``with_xi``, writes the
    per-step xi; ``with_xi`` takes a time-varying ``log_P`` only."""
    name = 'hmm_forward_backward'
    N, T, K, tv, f64, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask, True)
    _check_k9_f64(name, K, f64)
    if with_xi and not tv:
        raise ValueError('%s: with_xi takes a time-varying log_P (N, T-1, K, K), got %s'
                         % (name, tuple(log_P.shape)))
    dev, dt = ll.device, ll.dtype
    scratch = torch.empty((2, N, T, K), device=dev, dtype=dt)
    gamma = torch.empty((N, T, K), device=dev, dtype=dt)
    log_Z = torch.empty(N, device=dev, dtype=dt)
    xi_sum = torch.empty((N, K, K), device=dev, dtype=dt)
    xi = torch.empty((N, T - 1, K, K), device=dev, dtype=dt) if with_xi else None
    if N:
        args = (pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
                scratch[0].data_ptr(), scratch[1].data_ptr(), gamma.data_ptr(),
                log_Z.data_ptr(), xi_sum.data_ptr())
        if tv:
            launch(name, *args, xi.data_ptr() if with_xi else None,
                   symbol='bn_hmm_forward_backward_tv' + f64)
        else:
            launch(name, *args, symbol='bn_hmm_forward_backward' + f64)
    out = (gamma, log_Z, xi_sum)
    return out + (xi,) if with_xi else out


def log_normalizer_cuda(log_pi0, log_P, log_lik, mask):
    """K9's forward pass alone on the card: log_Z (N,), float32 or float64
    (K <= 16) in the inputs' dtype."""
    name = 'hmm_forward_backward'
    N, T, K, tv, f64, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask, True)
    _check_k9_f64(name, K, f64)
    log_Z = torch.empty(N, device=ll.device, dtype=ll.dtype)
    if N:
        launch(name, pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
               log_Z.data_ptr(),
               symbol=('bn_hmm_forward_tv' if tv else 'bn_hmm_forward') + f64)
    return log_Z


def viterbi_cuda(log_pi0, log_P, log_lik, mask):
    """K10 on the card: the (N, T) int32 paths of :func:`viterbi_plain`.
    Backpointers go to (N, T-1, K) int32 scratch; the backtrace runs in the
    same kernel. A time-varying ``log_P`` runs the ``_tv`` launcher; float64
    scores the ``_f64`` ones."""
    name = 'hmm_viterbi'
    N, T, K, tv, f64, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask, True)
    dev = ll.device
    backptrs = torch.empty((N, max(T - 1, 1), K), device=dev, dtype=torch.int32)
    path = torch.empty((N, T), device=dev, dtype=torch.int32)
    if N:
        launch(name, pi0.data_ptr(), lp.data_ptr(), ll.data_ptr(), m.data_ptr(), N, T, K,
               backptrs.data_ptr(), path.data_ptr(),
               symbol=('bn_hmm_viterbi_tv' if tv else 'bn_hmm_viterbi') + f64)
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
    N, T, K, tv, _, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
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
    N, T, K, tv, _, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
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
    N, T, K, tv, _, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
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
    N, T, K, tv, _, (pi0, lp, ll, m) = _check(name, log_pi0, log_P, log_lik, mask)
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
    check_device(name, tensors)
    for t, dt in zip(tensors, dtypes):
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


# --------------------------------------- time shards (K32-K35, row 19a)
# A shard of a time-sharded chain holds frames [t0, t1) of every trial as
# a trial of its own: log_lik (N, Ts, K), mask (N, Ts), log_P (K, K) or its
# own steps (N, Ts-1, K, K); a shard after the first also the step into
# t0, entry_P (K, K) or (N, K, K), and the mask of frame t0 - 1, m_prev
# (N,). ``parallel.seq`` cuts the chain, launches these on each shard's
# device and copies the totals between shards (kernels/hmm_shard.cu).

_SHARD = 'hmm_shard_totals'   # the source of K32-K35


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_shard(log_pi0, log_P, entry_P, log_lik, mask):
    """K32 / K33's input checks (``_check``'s, and entry_P's shape beside
    log_P's); returns N, T, K, the _tv suffix and the inputs made
    contiguous."""
    N, T, K, tv, _, (pi0, lp, ll, m) = _check(_SHARD, log_pi0, log_P, log_lik, mask)
    if entry_P is not None:
        dtype_suffix(_SHARD, (ll, entry_P), float64=False)
        if tuple(entry_P.shape) != ((N, K, K) if tv else (K, K)):
            raise ValueError('%s: entry_P must be %s beside log_P %s, got %s'
                             % (_SHARD, (N, K, K) if tv else (K, K), tuple(log_P.shape),
                                tuple(entry_P.shape)))
        entry_P = entry_P.contiguous()
    return N, T, K, '_tv' if tv else '', (pi0, lp, entry_P, ll, m)


def _check_totals(totals, s, N, K, dev, dtype=torch.float32, width=None):
    """The gathered totals (n_sh, N, K+1, K) (or map totals (n_sh, N, K)) on
    the shard's device; returns n_sh."""
    want = (N, K if width is None else width, K) if dtype == torch.float32 else (N, K)
    if totals.dim() != len(want) + 1 or tuple(totals.shape[1:]) != want or \
            totals.dtype != dtype or totals.device != dev or not 0 <= s < totals.shape[0]:
        raise ValueError('%s: takes totals (n_sh,) + %s %s on %s and 0 <= s < n_sh, got %s %s '
                         'on %s, s=%d' % (_SHARD, want, dtype, dev, tuple(totals.shape),
                                          totals.dtype, totals.device, s))
    return totals.shape[0]


def shard_totals_cuda(log_pi0, log_P, entry_P, log_lik, mask, maxplus=False):
    """K32 on the card: the shard's total (N, K+1, K) in the log or, with
    ``maxplus``, the (max, +) semiring, rows 0..K-1 the product of its step
    matrices (the entry step's first), row K (first shard: entry_P None)
    alpha_0 = log_pi0 + log_lik[:, 0] m[:, 0]; and the chunk products (N,
    C, K, K) that K33 reads."""
    N, T, K, tv, (pi0, lp, ep, ll, m) = _check_shard(log_pi0, log_P, entry_P, log_lik, mask)
    L = scan_chunk(T)
    kw = dict(device=ll.device, dtype=torch.float32)
    prod = torch.empty((N, _n_chunks(T, L), K, K), **kw)
    totals = torch.empty((N, K + 1, K), **kw)
    launch(_SHARD, pi0.data_ptr(), lp.data_ptr(), _ptr(ep), ll.data_ptr(), m.data_ptr(), N, T,
           K, L, prod.data_ptr(), totals.data_ptr(),
           symbol='bn_hmm_shard_totals' + ('_maxplus' if maxplus else '') + tv)
    return totals, prod


def _finish_scratch(N, T, K, dev):
    L = scan_chunk(T)
    kw = dict(device=dev, dtype=torch.float32)
    return L, torch.empty((2, N, _n_chunks(T, L) + 1, K), **kw), torch.empty((3, N, K), **kw)


def shard_forward_backward_cuda(totals, s, log_pi0, log_P, entry_P, log_lik, mask, m_prev,
                                prod):
    """K33's posteriors on shard ``s``: from the gathered totals (n_sh, N,
    K+1, K) of K32 (log semiring) and this shard's chunk products ``prod``,
    (gamma (N, Ts, K), log_Z (N,) on the last shard else None, the xi_sum
    (N, K, K) of the shard's steps, the step into t0 included)."""
    N, T, K, tv, (pi0, lp, ep, ll, m) = _check_shard(log_pi0, log_P, entry_P, log_lik, mask)
    n_sh = _check_totals(totals, s, N, K, ll.device, width=K + 1)
    if s > 0 and (m_prev is None or m_prev.shape != (N,)):
        raise ValueError('%s: a shard after the first takes m_prev (N,)' % _SHARD)
    dev = ll.device
    L, entries, ends = _finish_scratch(N, T, K, dev)
    kw = dict(device=dev, dtype=torch.float32)
    passes = torch.empty((2, N, T, K), **kw)
    parts = torch.empty((N, -(-T // L), K, K), **kw)
    gamma, log_Z, xi_sum = (torch.empty((N, T, K), **kw), torch.empty(N, **kw),
                            torch.empty((N, K, K), **kw))
    launch(_SHARD, totals.contiguous().data_ptr(), n_sh, s, pi0.data_ptr(), lp.data_ptr(),
           _ptr(ep), ll.data_ptr(), m.data_ptr(), _ptr(None if s == 0 else m_prev.contiguous()),
           N, T, K, L, prod.data_ptr(), entries.data_ptr(), ends.data_ptr(),
           passes[0].data_ptr(), passes[1].data_ptr(), parts.data_ptr(), gamma.data_ptr(),
           log_Z.data_ptr(), xi_sum.data_ptr(), symbol='bn_hmm_shard_finish' + tv)
    return gamma, (log_Z if s == n_sh - 1 else None), xi_sum


def shard_forward_alpha_cuda(totals, s, log_pi0, log_P, entry_P, log_lik, mask, prod):
    """K33's filtered alphas on shard ``s``: (log_alpha (N, Ts, K), alpha at
    frame t0 - 1 (N, K), None on the first shard) for K34's draws."""
    N, T, K, tv, (pi0, lp, ep, ll, m) = _check_shard(log_pi0, log_P, entry_P, log_lik, mask)
    n_sh = _check_totals(totals, s, N, K, ll.device, width=K + 1)
    L, entries, ends = _finish_scratch(N, T, K, ll.device)
    log_alpha = torch.empty((N, T, K), device=ll.device, dtype=torch.float32)
    launch(_SHARD, totals.contiguous().data_ptr(), n_sh, s, pi0.data_ptr(), lp.data_ptr(),
           _ptr(ep), ll.data_ptr(), m.data_ptr(), N, T, K, L, prod.data_ptr(),
           entries.data_ptr(), ends.data_ptr(), log_alpha.data_ptr(),
           symbol='bn_hmm_shard_alpha' + tv)
    return log_alpha, (ends[0] if s > 0 else None)


def shard_viterbi_cuda(totals, s, log_pi0, log_P, entry_P, log_lik, mask, prod):
    """K33's Viterbi on shard ``s`` from the gathered (max, +) totals: (the
    backpointers psi (N, max(Ts-1, 1), K), the entry step's (N, K) or None
    on the first shard, z_{T-1} (N,) on the last shard or None), int32."""
    N, T, K, tv, (pi0, lp, ep, ll, m) = _check_shard(log_pi0, log_P, entry_P, log_lik, mask)
    n_sh = _check_totals(totals, s, N, K, ll.device, width=K + 1)
    L, entries, ends = _finish_scratch(N, T, K, ll.device)
    kw = dict(device=ll.device, dtype=torch.int32)
    psi = torch.empty((N, max(T - 1, 1), K), **kw)
    psi_entry = torch.empty((N, K), **kw)
    bounds = torch.empty((N, _n_chunks(T, L) + 1), **kw)
    launch(_SHARD, totals.contiguous().data_ptr(), n_sh, s, pi0.data_ptr(), lp.data_ptr(),
           _ptr(ep), ll.data_ptr(), m.data_ptr(), N, T, K, L, prod.data_ptr(),
           entries.data_ptr(), ends.data_ptr(), psi.data_ptr(), psi_entry.data_ptr(),
           bounds.data_ptr(), symbol='bn_hmm_shard_viterbi' + tv)
    return psi, (psi_entry if s > 0 else None), \
        (bounds[:, -1].contiguous() if s == n_sh - 1 else None)


def _check_maps(name, tensors, N, K):
    _check_tensors(name, tensors, (torch.int32,) * len(tensors))
    if any(t.shape[0] != N or t.shape[-1] != K for t in tensors):
        raise ValueError('%s: maps of (N, ..., K) = (%d, ..., %d), got %s'
                         % (name, N, K, [tuple(t.shape) for t in tensors]))


def shard_maps_cuda(psi, psi_entry, T):
    """K34 from K33's backpointers psi (N, max(T-1, 1), K) of a shard of T
    frames and its entry step's psi_entry (N, K) (None on the first shard):
    (the shard's map total G (N, K), the chunks' composed maps (N, C, K)
    that K35 reads), int32."""
    N, _, K = psi.shape
    _check_maps(_SHARD, [t for t in (psi, psi_entry) if t is not None], N, K)
    L = scan_chunk(T)
    maps = torch.empty((N, _n_chunks(T, L), K), device=psi.device, dtype=torch.int32)
    G = torch.empty((N, K), device=psi.device, dtype=torch.int32)
    launch(_SHARD, psi.contiguous().data_ptr(), _ptr(psi_entry), N, T, K, L, maps.data_ptr(),
           G.data_ptr(), symbol='bn_hmm_shard_maps')
    return G, maps


def shard_sample_maps_cuda(log_alpha, log_P, mask, u_maps, u_last=None, alpha_prev=None,
                           entry_P=None, u_entry=None):
    """K34 by sampling on a shard: K15's draws of the predecessor maps of
    its steps from its alphas (N, Ts, K), log_P, mask and uniforms u_maps
    (N, Ts-1, K, K), and of the entry step's from alpha_prev (the alpha of
    frame t0 - 1, (N, K)), entry_P and u_entry (N, K, K) (all three None on
    the first shard); on the last shard z_{T-1} from u_last (N, K). Returns
    (G (N, K), the chunks' maps, psi, z_{T-1} (N,) or None), int32."""
    N, T, K = log_alpha.shape
    tv = log_P.dim() == 4
    given = [t for t in (log_alpha, log_P, mask, u_maps, u_last, alpha_prev, entry_P, u_entry)
             if t is not None]
    _check_tensors(_SHARD, given, (torch.float32,) * len(given))
    if log_P.shape not in ((K, K), (N, T - 1, K, K)) or mask.shape != (N, T) or \
            u_maps.shape != (N, T - 1, K, K) or (u_last is not None and u_last.shape != (N, K)):
        raise ValueError('%s: takes log_P (K, K) or (N, T-1, K, K), mask (N, T), u_maps (N, '
                         'T-1, K, K) and u_last (N, K) beside log_alpha %s, got %s'
                         % (_SHARD, (N, T, K), [tuple(t.shape) for t in given[1:]]))
    entry = (alpha_prev, entry_P, u_entry)
    if any(t is not None for t in entry) and any(
            t is None or tuple(t.shape) != want
            for t, want in zip(entry, ((N, K), (N, K, K) if tv else (K, K), (N, K, K)))):
        raise ValueError('%s: alpha_prev (N, K), entry_P (as a step of log_P) and u_entry (N, '
                         'K, K) go together, got %s' % (_SHARD, [None if t is None else
                                                                 tuple(t.shape) for t in entry]))
    if not 1 <= K <= _MAX_K:
        raise ValueError('%s: takes 1 <= K <= %d states, got K=%d' % (_SHARD, _MAX_K, K))
    la, lp, m, um = (t.contiguous() for t in (log_alpha, log_P, mask, u_maps))
    L = scan_chunk(T)
    C = _n_chunks(T, L)
    kw = dict(device=la.device, dtype=torch.int32)
    psi, psi_entry = torch.empty((N, max(T - 1, 1), K), **kw), torch.empty((N, K), **kw)
    maps, bounds, G = (torch.empty((N, C, K), **kw), torch.empty((N, C + 1), **kw),
                       torch.empty((N, K), **kw))
    launch(_SHARD, la.data_ptr(), lp.data_ptr(), m.data_ptr(),
           _ptr(None if u_last is None else u_last.contiguous()), um.data_ptr(),
           _ptr(None if alpha_prev is None else alpha_prev.contiguous()),
           _ptr(None if entry_P is None else entry_P.contiguous()),
           _ptr(None if u_entry is None else u_entry.contiguous()), N, T, K, L, psi.data_ptr(),
           psi_entry.data_ptr(), maps.data_ptr(), bounds.data_ptr(), G.data_ptr(),
           symbol='bn_hmm_shard_sample_maps' + ('_tv' if tv else ''))
    return G, maps, psi, (bounds[:, -1].contiguous() if u_last is not None else None)


def shard_backtrace_cuda(G, z_last, s, psi, maps, T):
    """K35 on shard ``s`` of T frames: the gathered map totals G (n_sh, N,
    K) and z_{T-1} (N,), with the shard's psi and K34's chunk maps, give
    its path (N, T) int32."""
    N, C, K = maps.shape
    _check_maps(_SHARD, [psi, maps, G[0]], N, K)
    n_sh = _check_totals(G, s, N, K, psi.device, dtype=torch.int32)
    if z_last.shape != (N,) or z_last.dtype != torch.int32 or z_last.device != psi.device:
        raise ValueError('%s: z_last must be (N,) int32 on %s, got %s %s on %s'
                         % (_SHARD, psi.device, tuple(z_last.shape), z_last.dtype,
                            z_last.device))
    L = scan_chunk(T)
    if C != _n_chunks(T, L):
        raise ValueError('%s: maps of %d chunks do not fit T=%d' % (_SHARD, C, T))
    bounds = torch.empty((N, C + 1), device=psi.device, dtype=torch.int32)
    path = torch.empty((N, T), device=psi.device, dtype=torch.int32)
    launch(_SHARD, G.contiguous().data_ptr(), z_last.contiguous().data_ptr(), n_sh, s,
           psi.contiguous().data_ptr(), maps.contiguous().data_ptr(), N, T, K, L,
           bounds.data_ptr(), path.data_ptr(), symbol='bn_hmm_shard_backtrace')
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
