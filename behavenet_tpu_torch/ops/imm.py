"""The Bayesian decoder's continuous passes over one trial: the IMM-collapsed
Kalman filter and the RTS smoother on the companion state (the port of
``behavenet_tpu/models/bayesian.py:299 _kalman_filter`` and ``:340
_rts_smoother``, which the JAX package keeps inside its model).

The state is the companion vector s_t = [x_t, x_{t-1}, ...] of size n; the
observation picks its first D entries (H = [I 0]). The inputs are those of
the JAX functions, written out:

- ``y``: (T, D) observations, NaN rows already set to 0;
- ``obs_mask``: (T,) float, 1 where a row was observed;
- ``gamma``: (T, K) discrete posterior;
- ``As``: (K, n, n), ``bs``: (K, n), ``Qs``: (K, n, n) companion dynamics;
- ``R``: (D, D) observation covariance;
- ``mu0``: (n,), ``Sigma0``: (n, n) prior moments at t = 0.

:func:`imm_filter` runs K17 (``kernels/imm.cu`` ``bn_imm_filter``) and
:func:`rts_smoother` K18 (``bn_rts_smoother``, counted as
``rts_smoother``) on ``cuda`` tensors; on ``cpu`` tensors the plain PyTorch
versions beside them run, picked from the input's device and from nothing
else. The plain versions are JAX's ``lax.scan`` bodies step by step, in its
einsum order, with the JAX package's unpivoted Gauss-Jordan solve; their
``dtype`` lets a caller run them in float64.
"""

import torch

from behavenet_tpu_torch.kernels.build import launch
from behavenet_tpu_torch.ops.hmm import _check_tensors, _dispatch
from behavenet_tpu_torch.ops.smallmat import solve_small_plain

__all__ = ['imm_filter_plain', 'rts_smoother_plain', 'imm_filter_cuda', 'rts_smoother_cuda',
           'imm_filter', 'rts_smoother', 'MAX_N', 'MAX_K']

MAX_N = 32   # the widest companion state K17 and K18 take (D = 16 at lags 2)
MAX_K = 16   # the most states (the EM benchmark's K)


def _cast(dtype, *tensors):
    return [t if dtype is None else t.to(dtype) for t in tensors]


# ------------------------------------------------------------ plain versions


def imm_filter_plain(y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0, dtype=None):
    """The IMM filter (JAX: models/bayesian.py:299-338): at t = 0 the prior
    updated with ``y[0]``; then per step the soft predict, the gamma-weighted
    moment-matched mixture of the K dynamics, and the Kalman update, skipped
    where ``obs_mask`` is 0.

    Returns (mus_f (T, n), Sigmas_f (T, n, n), mus_p (T-1, n), Sigmas_p
    (T-1, n, n)), in ``dtype`` (default: the inputs')."""
    y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0 = _cast(
        dtype, y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0)
    D, n = y.shape[1], As.shape[-1]
    H = torch.eye(D, n, dtype=y.dtype, device=y.device)
    I_n = torch.eye(n, dtype=y.dtype, device=y.device)

    def update(mu_pred, Sigma_pred, y_t, m_t):
        S = H @ Sigma_pred @ H.T + R
        Kg = solve_small_plain(S, H @ Sigma_pred).T              # (n, D)
        mu_upd = mu_pred + Kg @ (y_t - H @ mu_pred)
        Sigma_upd = (I_n - Kg @ H) @ Sigma_pred
        return (torch.where(m_t > 0, mu_upd, mu_pred),
                torch.where(m_t > 0, Sigma_upd, Sigma_pred))

    mu, Sigma = update(mu0, Sigma0, y[0], obs_mask[0])
    mus_f, Sigmas_f, mus_p, Sigmas_p = [mu], [Sigma], [], []
    for t in range(1, y.shape[0]):
        g_t = gamma[t]
        mu_k = torch.einsum('kde,e->kd', As, mu) + bs                 # (K, n)
        mu_pred = torch.einsum('k,kd->d', g_t, mu_k)
        diff = mu_k - mu_pred[None]
        Sigma_k = torch.einsum('kde,ef,kgf->kdg', As, Sigma, As) + Qs
        Sigma_pred = torch.einsum('k,kde->de', g_t, Sigma_k) + \
            torch.einsum('k,kd,ke->de', g_t, diff, diff)
        mu, Sigma = update(mu_pred, Sigma_pred, y[t], obs_mask[t])
        mus_f.append(mu)
        Sigmas_f.append(Sigma)
        mus_p.append(mu_pred)
        Sigmas_p.append(Sigma_pred)

    def stack(xs, shape):
        return torch.stack(xs) if xs else torch.zeros((0,) + shape, dtype=y.dtype,
                                                      device=y.device)
    return (stack(mus_f, (n,)), stack(Sigmas_f, (n, n)), stack(mus_p, (n,)),
            stack(Sigmas_p, (n, n)))


def rts_smoother_plain(mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As, dtype=None):
    """The RTS pass with the soft dynamics A_soft = sum_k gamma[t+1, k] A_k
    (JAX: models/bayesian.py:340-363), backwards from the last filtered
    moments. Returns (mus_s (T, n), Sigmas_s (T, n, n))."""
    mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As = _cast(
        dtype, mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As)
    n = As.shape[-1]
    jitter = 1e-6 * torch.eye(n, dtype=As.dtype, device=As.device)
    mu, Sigma = mus_f[-1], Sigmas_f[-1]
    mus_s, Sigmas_s = [mu], [Sigma]
    for t in range(mus_f.shape[0] - 2, -1, -1):
        A_soft = torch.einsum('k,kde->de', gamma[t + 1], As)
        C = Sigmas_f[t] @ A_soft.T
        G = solve_small_plain(Sigmas_p[t] + jitter, C.T).T
        mu = mus_f[t] + G @ (mu - mus_p[t])
        Sigma = Sigmas_f[t] + G @ (Sigma - Sigmas_p[t]) @ G.T
        mus_s.append(mu)
        Sigmas_s.append(Sigma)
    return torch.stack(mus_s[::-1]), torch.stack(Sigmas_s[::-1])


# -------------------------------------------------------------- the kernels


def _check(name, tensors, shapes):
    """Each tensor float32 on one CUDA device with its expected shape.
    Returns the tensors made contiguous."""
    _check_tensors(name, tensors, [torch.float32] * len(tensors))
    if any(tuple(t.shape) != shape for t, shape in zip(tensors, shapes)):
        raise ValueError('%s: expected shapes %s, got %s'
                         % (name, shapes, [tuple(t.shape) for t in tensors]))
    return [t.contiguous() for t in tensors]


def _limits(name, T, K, n, D=1):
    """The kernels' limits: n <= MAX_N, K <= MAX_K (and the filter's D <= n)."""
    if not (1 <= D <= n <= MAX_N and 1 <= K <= MAX_K and T >= 1):
        raise ValueError('%s: takes n <= %d, K <= %d, 1 <= D <= n and T >= 1, got '
                         'n=%d, K=%d, D=%d, T=%d' % (name, MAX_N, MAX_K, n, K, D, T))


def imm_filter_cuda(y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0):
    """K17 on the card: the outputs of :func:`imm_filter_plain`, the whole
    chain in one block."""
    name = 'imm_filter'
    (T, D), (K, n) = y.shape, As.shape[:2]
    _limits(name, T, K, n, D)
    ts = _check(name, (y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0),
                ((T, D), (T,), (T, K), (K, n, n), (K, n), (K, n, n), (D, D), (n,), (n, n)))
    dev = y.device
    mus_f = torch.empty((T, n), device=dev, dtype=torch.float32)
    Sigmas_f = torch.empty((T, n, n), device=dev, dtype=torch.float32)
    mus_p = torch.empty((T - 1, n), device=dev, dtype=torch.float32)
    Sigmas_p = torch.empty((T - 1, n, n), device=dev, dtype=torch.float32)
    launch(name, *(t.data_ptr() for t in ts), T, D, K, n, mus_f.data_ptr(),
           Sigmas_f.data_ptr(), mus_p.data_ptr(), Sigmas_p.data_ptr(),
           symbol='bn_imm_filter')
    return mus_f, Sigmas_f, mus_p, Sigmas_p


def rts_smoother_cuda(mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As):
    """K18 on the card: the outputs of :func:`rts_smoother_plain`, the whole
    backward chain in one block."""
    name = 'rts_smoother'
    (T, n), K = mus_f.shape, As.shape[0]
    _limits(name, T, K, n)
    ts = _check(name, (mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As),
                ((T, n), (T, n, n), (T - 1, n), (T - 1, n, n), (T, K), (K, n, n)))
    mus_s = torch.empty_like(ts[0])
    Sigmas_s = torch.empty_like(ts[1])
    launch('imm_filter', *(t.data_ptr() for t in ts), T, K, n, mus_s.data_ptr(),
           Sigmas_s.data_ptr(), symbol='bn_rts_smoother')
    return mus_s, Sigmas_s


def imm_filter(y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0):
    """(mus_f, Sigmas_f, mus_p, Sigmas_p) of one trial (JAX:
    models/bayesian.py:299): K17 on the card, the plain version on the CPU."""
    if _dispatch('imm_filter', y):
        return imm_filter_plain(y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0)
    return imm_filter_cuda(y, obs_mask, gamma, As, bs, Qs, R, mu0, Sigma0)


def rts_smoother(mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As):
    """(mus_s, Sigmas_s) of one trial (JAX: models/bayesian.py:340): K18 on
    the card, the plain version on the CPU."""
    if _dispatch('rts_smoother', mus_f):
        return rts_smoother_plain(mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As)
    return rts_smoother_cuda(mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As)
