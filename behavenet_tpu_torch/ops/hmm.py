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
(``kernels/hmm_viterbi.cu``) on ``cuda`` tensors, and the plain PyTorch
versions beside them on ``cpu`` tensors, picked from the input's device and
from nothing else; a time-varying ``log_P`` goes to the kernels' ``_tv``
launchers, which also write the per-step pairwise posteriors for
:func:`forward_backward`'s ``with_xi``. The parallel-prefix forms and
posterior sampling are not ported yet.
"""

import torch

from behavenet_tpu_torch.kernels.build import launch

__all__ = ['forward_plain', 'backward_plain', 'forward_backward_plain',
           'expected_transitions_plain', 'viterbi_plain', 'forward_backward',
           'forward_backward_cuda', 'log_normalizer', 'log_normalizer_cuda', 'viterbi',
           'viterbi_cuda', 'path_log_prob']

_MAX_K = 32   # K9 and K10 put state k in lane k of a warp


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


def forward_backward_plain(log_pi0, log_P, log_lik, mask=None, with_xi=False):
    """Posterior marginals and expected transition counts (JAX:
    ops/hmm.py:115 with ``parallel=False``).

    Returns (gamma (N, T, K), log_Z (N,), xi_sum (N, K, K)), and with
    ``with_xi`` the per-step pairwise posteriors xi (N, T-1, K, K) of
    :func:`expected_transitions_plain` fourth: gamma are the posterior
    marginals p(z_t | x), normalized per step with the row max subtracted
    first; xi_sum is the masked sum over t of the pairwise posteriors
    p(z_t, z_{t+1} | x).
    """
    mask = _mask(log_lik, mask)
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


def _dispatch(name, log_lik):
    if log_lik.device.type not in ('cpu', 'cuda'):
        raise ValueError('%s: no implementation for device %s' % (name, log_lik.device))
    return log_lik.device.type == 'cpu'


def forward_backward(log_pi0, log_P, log_lik, mask=None, with_xi=False):
    """(gamma (N, T, K), log_Z (N,), xi_sum (N, K, K)[, xi (N, T-1, K, K)])
    of a batch of trials (JAX: ops/hmm.py:115, and with ``with_xi`` :167
    ``expected_transitions`` from the same passes): K9 on the card, the
    plain version on the CPU."""
    mask = _mask(log_lik, mask)
    if _dispatch('forward_backward', log_lik):
        return forward_backward_plain(log_pi0, log_P, log_lik, mask, with_xi)
    return forward_backward_cuda(log_pi0, log_P, log_lik, mask, with_xi)


def log_normalizer(log_pi0, log_P, log_lik, mask=None):
    """The marginal log-likelihood log_Z (N,) of each trial, the forward pass
    alone (JAX: ops/hmm.py:39 ``forward``'s second output)."""
    mask = _mask(log_lik, mask)
    if _dispatch('log_normalizer', log_lik):
        return forward_plain(log_pi0, log_P, log_lik, mask)[1]
    return log_normalizer_cuda(log_pi0, log_P, log_lik, mask)


def viterbi(log_pi0, log_P, log_lik, mask=None):
    """Most likely state paths (N, T) int32 (JAX: ops/hmm.py:186): K10 on the
    card, the plain version on the CPU."""
    mask = _mask(log_lik, mask)
    if _dispatch('viterbi', log_lik):
        return viterbi_plain(log_pi0, log_P, log_lik, mask)
    return viterbi_cuda(log_pi0, log_P, log_lik, mask)
