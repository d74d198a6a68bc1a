"""(AR)HMM segmentation with EM, in PyTorch (the port of
``behavenet_tpu/models/arhmm.py``).

Observations ``'ar'``, ``'gaussian'``, ``'diagonal_ar'`` and
``'diagonal_gaussian'``, and their Student's-t forms ``'robust_ar'``,
``'studentst'``, ``'diagonal_robust_ar'`` and ``'diagonal_studentst'``;
transitions ``'stationary'``, ``'sticky'``, ``'recurrent'`` and
``'recurrent_only'``. Trials are padded to a common length with a mask. One
EM iteration is

- the observation log-likelihoods of every frame and state
  (:func:`log_likes`, or :func:`robust_log_likes` with the scale-mixture
  weights tau of the same pass: K8 ``kernels/arhmm_log_likes.cu`` on the
  card);
- the transition log-probs: stationary (K, K), or for the recurrent
  transitions (N, T-1, K, K) driven by ``Rs x_t`` (:func:`recurrent_log_P`,
  PyTorch ops, as plain ops in the JAX package);
- forward-backward over all trials (``ops.hmm.forward_backward``: K9, or
  K13 with ``parallel_scan``), which with recurrent transitions also
  writes the per-step pairwise posteriors;
- the M-step: the initial distribution; the transition counts (plus kappa
  on the diagonal when sticky) or, recurrent, 25 Adam steps (lr 1e-2) on
  the expected transitions' log-likelihood over ``log_Ps``, ``Rs`` and
  ``r`` (:func:`recurrent_mstep`: K40 ``kernels/arhmm_recurrent_mstep.cu``
  on the card, the gradient written out; the plain version's by autograd,
  with ``optax.adam``'s update written out); per-state weighted least
  squares (weights times tau when robust)
  with the JAX package's Jacobi equilibration and 1e-5 ridge: the weighted
  sums XtWX, XtWY and wsum in one pass over the frames (:func:`mstep_stats`:
  K31 ``kernels/arhmm_mstep.cu`` on the card), solved by
  ``ops.smallmat.solve_small`` (K11), then the weighted residual
  covariances in a second pass (:func:`mstep_cov`, K31's second launcher);
  robust, 10 finite-difference Newton steps on the dof nu
  (:func:`nu_mstep`: K41 ``kernels/arhmm_nu_mstep.cu`` on the card).

Conventions match the JAX package (and ssm): the first ``lags`` frames of
a trial are scored under a fixed N(0, I) for every state, and the AR
regression uses only frames with a full lag history.

With ``parallel_scan`` the message passes of EM, ``log_likelihood``,
``expected_states`` and ``most_likely_states`` run as chunked
parallel-prefix scans (K13, K14 on the card): the same results to float32
roundoff, for long sessions. ``posterior_sample`` draws posterior state
paths (forward filtering, backward sampling: K15 on the card); ``sample``
draws a stationary or sticky model's state chain with K16 and the
recurrent models' states and every observation in host loops over numpy,
as the JAX package does. Randomness comes from a ``torch.Generator``
(``generator``, in place of the JAX package's ``key``).

``dtype='float64'`` (the CLI's ``em_dtype``) runs EM, ``log_likelihood``,
``expected_states`` and ``most_likely_states`` in float64: parameters,
padded trials and every intermediate, through the ``_f64`` launchers of
K8-K11, K31, K40 and K41 on the card. Not ported yet, and raising
``NotImplementedError``: float64 with ``parallel_scan``, ``posterior_sample``,
``sample`` / ``sample_x`` or a mesh (they need K13-K16 and K32-K35 in
float64, ROADMAP A1c).

A ``parallel.Mesh`` (an ordered list of devices, one per shard) spreads one
call over several devices, as the JAX package's ``jax.sharding.Mesh``:
``expected_states``, ``most_likely_states`` and ``posterior_sample`` with
``mesh=`` cut the trial's frames into shards, each with its lag history
(its log-likelihoods made on its device, the initial condition on global
frames only), and run ``parallel.seq``'s time-sharded passes (K32-K35 on
the card). ``fit(mesh=...)`` shards the trials, or with ``shard_time``
every trial's frames, each part's E-step and M-step sums on its device,
the sums added in part order on the first; ``iters_per_dispatch`` reads
the log-likelihoods once every k iterations.
"""

import collections
import contextvars
import functools
import pickle

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import dtype_suffix, launch
from behavenet_tpu_torch.ops import hmm as hmm_ops
from behavenet_tpu_torch.ops.smallmat import solve_small
from behavenet_tpu_torch.parallel import seq
from behavenet_tpu_torch.parallel.mesh import Mesh, on_device, per_device
from behavenet_tpu_torch.utils.device import resolve_device

__all__ = ['ARHMM', 'PaddedTrials', 'pad_trials', 'obs_precision', 'log_likes',
           'log_likes_plain', 'log_likes_cuda', 'student_t_terms', 'robust_log_likes',
           'robust_log_likes_plain', 'robust_log_likes_cuda', 'mstep_stats',
           'mstep_stats_plain', 'mstep_stats_cuda', 'mstep_cov', 'mstep_cov_plain',
           'mstep_cov_cuda', 'recurrent_log_P', 'recurrent_mstep', 'recurrent_mstep_plain',
           'recurrent_mstep_cuda', 'nu_mstep', 'nu_mstep_plain', 'nu_mstep_cuda', 'kmeans',
           'check_ported']

LN2PI = float(np.log(2 * np.pi))
_OBSERVATIONS = ('ar', 'gaussian', 'diagonal_ar', 'diagonal_gaussian')
_ROBUST = ('robust_ar', 'studentst', 'diagonal_robust_ar', 'diagonal_studentst')
_TRANSITIONS = ('stationary', 'sticky', 'recurrent', 'recurrent_only')
_RECURRENT_ADAM_STEPS, _RECURRENT_ADAM_LR = 25, 1e-2   # models/arhmm.py:670-680
_NU_NEWTON_STEPS = 10                                   # models/arhmm.py:613
_MAX_D, _MAX_LAG_COLS = 16, 64  # K8 keeps a frame and its lags in registers
_DTYPES = {'float32': torch.float32, 'float64': torch.float64}
_MSTEP_CHUNK = 512   # frames a block of K31 sums (kChunk, kernels/arhmm_mstep.cu)
_REC_CHUNK = 256     # steps a block of K40 sums (kChunk, kernels/arhmm_recurrent_mstep.cu)
_NU_CHUNK = 1024     # frames a block of K41's pass sums (kChunk, kernels/arhmm_nu_mstep.cu)
_MAX_MSTEP_K = 32    # states K40 and K41 take
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults

# the device an unpickled model's parameters go to: ``utils.pickles.load``
# sets it; unset, ``None`` means 'cuda' (which raises without a GPU)
UNPICKLE_DEVICE = contextvars.ContextVar('UNPICKLE_DEVICE', default=None)

# stacked trials (N, T, D) and their mask (N, T), on one device
PaddedTrials = collections.namedtuple('PaddedTrials', ['x', 'mask'])

# what one device holds of the padded trials in EM (ARHMM._layout)
_Part = collections.namedtuple('_Part', ['device', 'x', 'mask', 'halo', 't0', 'm_prev'])


def _reduce(tensors, device):
    """The sum of ``tensors`` copied to ``device``, added in their order."""
    return functools.reduce(torch.add, [t.to(device) for t in tensors])


def _on_own_device(method):
    """Run ``method`` with the model's device current (``on_device``), so
    that a model on any card launches there."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with on_device(self.device):
            return method(self, *args, **kwargs)
    return run


def _params_on(params, parts):
    """A copy of ``params`` on each device the parts lie on."""
    return {dev: {k: v.to(dev) for k, v in params.items()}
            for dev in dict.fromkeys(part.device for part in parts)}


def pad_trials(datas, device, dtype=torch.float32):
    """List of (T_i, D) arrays -> :class:`PaddedTrials` of ``dtype`` on
    ``device``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    datas = [np.asarray(d, dtype=np_dtype) for d in datas]
    t_max = max(d.shape[0] for d in datas)
    x = np.zeros((len(datas), t_max, datas[0].shape[1]), dtype=np_dtype)
    mask = np.zeros((len(datas), t_max), dtype=np_dtype)
    for i, d in enumerate(datas):
        x[i, :d.shape[0]] = d
        mask[i, :d.shape[0]] = 1.0
    return PaddedTrials(torch.from_numpy(x).to(device), torch.from_numpy(mask).to(device))


def _lagged(x, lags):
    """(N, T, D) -> design rows (N, T, D * lags) of [x_{t-1}, ..., x_{t-lags}],
    x[(t - l) mod T] of the padded trial where t < l, as the JAX package's
    ``jnp.roll`` (models/arhmm.py:61 ``_make_lagged``): the Gaussian
    log-likelihoods of those frames are replaced by the initial condition
    and they weigh nothing in the regression, but the tau weights read
    them."""
    feats = [torch.roll(x, lag, dims=1) for lag in range(1, lags + 1)]
    return torch.cat(feats, dim=2)


# ----------------------------------------------- observation log-likes (K8)


def obs_precision(Sigmas, diagonal):
    """What K8 and its plain version read of the covariances: the inverse
    lower Cholesky factors (K, D, D) of ``Sigmas + 1e-8 I`` (NaN where the
    factorization fails, as ``jnp.linalg.cholesky``) or, with ``diagonal``,
    the variances clipped at 1e-8 (K, D); and the log-determinants (K,)."""
    if diagonal:
        var = torch.clamp(torch.diagonal(Sigmas, dim1=1, dim2=2), min=1e-8).contiguous()
        return var, torch.log(var).sum(dim=1)
    eye = torch.eye(Sigmas.shape[-1], dtype=Sigmas.dtype, device=Sigmas.device)
    chol, info = torch.linalg.cholesky_ex(Sigmas + 1e-8 * eye[None])
    chol = torch.where(info[:, None, None] > 0, torch.full_like(chol, float('nan')), chol)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol).contiguous(), upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(dim=1)
    return linv.contiguous(), logdet


def _maha(x, As, bs, prec, lags, diagonal):
    """The Mahalanobis distances (N, T, K) of every frame from each state's
    AR mean, from :func:`obs_precision`'s ``prec``."""
    N, T, D = x.shape
    K = bs.shape[0]
    if lags > 0:
        mus = torch.einsum('kdp,ntp->ntkd', As[:, :, :D * lags],
                           _lagged(x, lags)) + bs
    else:
        mus = bs.expand(N, T, K, D)
    diff = x[:, :, None, :] - mus                      # (N, T, K, D)
    if diagonal:
        return torch.sum(diff ** 2 / prec, dim=3)
    sol = torch.einsum('kde,ntke->ntkd', prec, diff)
    return torch.sum(sol ** 2, dim=3)


def _initial_condition(x, ll, mask, lags):
    """``ll`` with the first ``lags`` frames scored under N(0, I), times the
    mask."""
    if lags > 0:
        D, T = x.shape[2], x.shape[1]
        init_ll = -0.5 * (D * LN2PI + torch.sum(x ** 2, dim=2))   # (N, T)
        first = (torch.arange(T, device=x.device) < lags)[None, :, None]
        ll = torch.where(first, init_ll[:, :, None], ll)
    return ll * mask[:, :, None]


def log_likes_plain(x, mask, As, bs, prec, logdet, lags, diagonal):
    """Per-frame observation log-likelihoods (N, T, K) (JAX:
    models/arhmm.py:187 _log_likes, for trials stacked on a leading axis),
    plain PyTorch, from :func:`obs_precision`'s ``prec`` and ``logdet``."""
    maha = _maha(x, As, bs, prec, lags, diagonal)
    ll = -0.5 * (x.shape[2] * LN2PI + logdet + maha)
    return _initial_condition(x, ll, mask, lags)


def _check_log_likes(name, tensors, lags, diagonal):
    """K8's input checks: x, mask, As, bs, prec, logdet (or c)[, nus];
    returns the launcher suffix of their dtype."""
    x, mask, As, bs, prec, logdet = tensors[:6]
    f64 = dtype_suffix(name, tensors)
    N, T, D = x.shape
    K, P = bs.shape[0], As.shape[2]
    want_prec = (K, D) if diagonal else (K, D, D)
    if mask.shape != (N, T) or As.shape[:2] != (K, D) or bs.shape != (K, D) or \
            tuple(prec.shape) != want_prec or logdet.shape != (K,) or P < D * lags:
        raise ValueError('%s: shapes x %s, mask %s, As %s, bs %s, prec %s, logdet %s do '
                         'not fit together' % (name, *(tuple(t.shape) for t in tensors[:6])))
    if D > _MAX_D or D * lags > _MAX_LAG_COLS:
        raise ValueError('%s: takes D <= %d and D * lags <= %d, got D=%d, lags=%d'
                         % (name, _MAX_D, _MAX_LAG_COLS, D, lags))
    return f64


def log_likes_cuda(x, mask, As, bs, prec, logdet, lags, diagonal):
    """K8 on the card: :func:`log_likes_plain`'s (N, T, K), float32 or
    float64 (``bn_arhmm_log_likes_f64``) in the inputs' dtype."""
    name = 'arhmm_log_likes'
    tensors = (x, mask, As, bs, prec, logdet)
    f64 = _check_log_likes(name, tensors, lags, diagonal)
    N, T, D = x.shape
    K, P = bs.shape[0], As.shape[2]
    x, mask, As, bs, prec, logdet = (t.contiguous() for t in tensors)
    out = torch.empty((N, T, K), device=x.device, dtype=x.dtype)
    if out.numel():
        launch(name, x.data_ptr(), mask.data_ptr(), As.data_ptr(), bs.data_ptr(),
               prec.data_ptr(), logdet.data_ptr(), N, T, D, K, P, lags, int(diagonal),
               out.data_ptr(), symbol='bn_arhmm_log_likes' + f64)
    return out


def log_likes(x, mask, As, bs, Sigmas, lags, diagonal):
    """Observation log-likelihoods (N, T, K) of padded trials: K8 on a
    ``cuda`` tensor, the plain version on a ``cpu`` one."""
    prec, logdet = obs_precision(Sigmas, diagonal)
    if x.device.type == 'cpu':
        return log_likes_plain(x, mask, As, bs, prec, logdet, lags, diagonal)
    if x.device.type != 'cuda':
        raise ValueError('log_likes: no implementation for device %s' % x.device)
    return log_likes_cuda(x, mask, As, bs, prec, logdet, lags, diagonal)


def student_t_terms(nus, logdet, D):
    """What K8's Student's-t form and its plain version read of the dof:
    ``nus`` clipped at 1e-2 and the per-state constant lgamma((nu + D) / 2)
    - lgamma(nu / 2) - D / 2 log(nu pi) - logdet / 2 (K,) (JAX:
    models/arhmm.py:212-214)."""
    nus = torch.clamp(nus, min=1e-2)
    c = torch.lgamma(0.5 * (nus + D)) - torch.lgamma(0.5 * nus) \
        - 0.5 * D * torch.log(nus * np.pi) - 0.5 * logdet
    return nus.contiguous(), c.contiguous()


def robust_log_likes_plain(x, mask, As, bs, prec, c, nus, lags, diagonal, with_tau=False):
    """Student's-t observation log-likelihoods (N, T, K) (JAX:
    models/arhmm.py:211-215) and, with ``with_tau``, the scale-mixture
    weights tau = (nu + D) / (nu + maha) (N, T, K) of every frame, unmasked,
    the first ``lags`` frames' from the wrapped history (JAX: :616
    ``_tau_weights``), else None; from :func:`student_t_terms`' ``nus`` and
    ``c``."""
    D = x.shape[2]
    maha = _maha(x, As, bs, prec, lags, diagonal)
    ll = c - 0.5 * (nus + D) * torch.log1p(maha / nus)
    tau = (nus + D) / (nus + maha) if with_tau else None
    return _initial_condition(x, ll, mask, lags), tau


def robust_log_likes_cuda(x, mask, As, bs, prec, c, nus, lags, diagonal, with_tau=False):
    """K8's Student's-t launcher on the card: (ll, tau or None) as
    :func:`robust_log_likes_plain`, float32 or float64 in the inputs'
    dtype (tau in the same)."""
    name = 'arhmm_log_likes'
    N, T, D = x.shape
    K = bs.shape[0]
    f64 = _check_log_likes(name, (x, mask, As, bs, prec, c, nus), lags, diagonal)
    if nus.shape != (K,):
        raise ValueError('%s: nus must be (K,), got %s' % (name, tuple(nus.shape)))
    x, mask, As, bs, prec, c, nus = (t.contiguous() for t in (x, mask, As, bs, prec, c, nus))
    out = torch.empty((N, T, K), device=x.device, dtype=x.dtype)
    tau = torch.empty((N, T, K), device=x.device, dtype=x.dtype) if with_tau else None
    if out.numel():
        launch(name, x.data_ptr(), mask.data_ptr(), As.data_ptr(), bs.data_ptr(),
               prec.data_ptr(), c.data_ptr(), nus.data_ptr(), N, T, D, K, As.shape[2], lags,
               int(diagonal), out.data_ptr(), tau.data_ptr() if with_tau else None,
               symbol='bn_arhmm_log_likes_robust' + f64)
    return out, tau


def robust_log_likes(x, mask, As, bs, Sigmas, nus, lags, diagonal, with_tau=False):
    """Student's-t observation log-likelihoods (N, T, K) of padded trials and,
    with ``with_tau``, their scale-mixture weights (else None): K8 on a
    ``cuda`` tensor, the plain version on a ``cpu`` one."""
    prec, logdet = obs_precision(Sigmas, diagonal)
    nus, c = student_t_terms(nus, logdet, x.shape[2])
    if x.device.type == 'cpu':
        return robust_log_likes_plain(x, mask, As, bs, prec, c, nus, lags, diagonal, with_tau)
    if x.device.type != 'cuda':
        raise ValueError('robust_log_likes: no implementation for device %s' % x.device)
    return robust_log_likes_cuda(x, mask, As, bs, prec, c, nus, lags, diagonal, with_tau)


# ------------------------------------------- the M-step's weighted sums (K31)


def _mstep_weights(gammas, mask, tau, lags):
    """The regression weights (N, T, K) as the JAX package builds them
    (models/arhmm.py:504-511): gammas times the mask, times tau when given,
    times (t >= lags) when ``lags > 0``: frames without a full lag history
    weigh 0."""
    w = gammas * mask[:, :, None]
    if tau is not None:
        w = w * tau
    if lags > 0:
        w = w * (torch.arange(gammas.shape[1], device=gammas.device) >= lags)[None, :, None]
    return w


def _design(x, lags):
    """The design rows (N, T, D * lags + 1): [x_{t-1}, ..., x_{t-lags}, 1]
    (JAX: models/arhmm.py:512-515)."""
    ones = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([_lagged(x, lags), ones], dim=2) if lags > 0 else ones


def _flat(x, mask, gammas, tau, lags):
    """(design rows (N T, P), y (N T, D), weights (N T, K)), the JAX
    package's ``Xf``, ``Yf``, ``Wf``."""
    Xd = _design(x, lags)
    return (Xd.reshape(-1, Xd.shape[2]), x.reshape(-1, x.shape[2]),
            _mstep_weights(gammas, mask, tau, lags).reshape(-1, gammas.shape[2]))


def mstep_stats_plain(x, mask, gammas, tau, lags):
    """The M-step's weighted sums (JAX: models/arhmm.py:522-523, :538):
    (XtWX (K, P, P), XtWY (K, P, D), wsum (K,)) with P = D * lags + 1, over
    padded trials x (N, T, D), mask (N, T), the posteriors gammas (N, T, K)
    and the robust weights tau (N, T, K) or None; plain PyTorch, the JAX
    formulas in the tensors' dtype."""
    Xf, Yf, Wf = _flat(x, mask, gammas, tau, lags)
    return (torch.einsum('np,nk,nq->kpq', Xf, Wf, Xf),
            torch.einsum('np,nk,nd->kpd', Xf, Wf, Yf), torch.sum(Wf, dim=0))


def mstep_cov_plain(x, mask, gammas, tau, beta, lags, diagonal):
    """The raw weighted residual sums of the M-step (JAX:
    models/arhmm.py:537-546, before the division by wsum): with r = y -
    X^T beta_k, sum w r r^T (K, D, D), or with ``diagonal`` sum w r^2 (K,
    D); ``beta`` (K, P, D) the solved regression. Plain PyTorch."""
    Xf, Yf, Wf = _flat(x, mask, gammas, tau, lags)
    resid = Yf[:, None, :] - torch.einsum('np,kpd->nkd', Xf, beta)   # (N T, K, D)
    if diagonal:
        return torch.einsum('nk,nkd->kd', Wf, resid ** 2)
    return torch.einsum('nk,nkd,nke->kde', Wf, resid, resid)


def _check_mstep(name, x, mask, gammas, tau, lags, beta=None):
    """K31's input checks; returns (N, T, D, K, P, chunks, the launcher
    suffix of the dtype) and the inputs made contiguous."""
    tensors = tuple(t for t in (x, mask, gammas, tau, beta) if t is not None)
    f64 = dtype_suffix(name, tensors)
    N, T, D = x.shape
    K = gammas.shape[2]
    if mask.shape != (N, T) or gammas.shape != (N, T, K) or \
            (tau is not None and tau.shape != (N, T, K)):
        raise ValueError('%s: takes x (N, T, D), mask (N, T), gammas and tau (N, T, K), got '
                         '%s' % (name, [tuple(t.shape) for t in tensors]))
    if not 1 <= D <= _MAX_D or lags < 0 or D * lags > _MAX_LAG_COLS:
        raise ValueError('%s: takes D <= %d and D * lags <= %d, got D=%d, lags=%d'
                         % (name, _MAX_D, _MAX_LAG_COLS, D, lags))
    if beta is not None and beta.shape != (K, D * lags + 1, D):
        raise ValueError('%s: beta must be (K, P, D) = %s, got %s'
                         % (name, (K, D * lags + 1, D), tuple(beta.shape)))
    chunks = -(-N * T // _MSTEP_CHUNK)
    x, mask, gammas = (t.contiguous() for t in (x, mask, gammas))
    tau = None if tau is None else tau.contiguous()
    return (N, T, D, K, D * lags + 1, chunks, f64), (x, mask, gammas, tau)


def _ptr(t):
    return None if t is None else t.data_ptr()


def mstep_stats_cuda(x, mask, gammas, tau, lags):
    """K31's first pass on the card: :func:`mstep_stats_plain`'s (XtWX,
    XtWY, wsum), float32 or float64 (``bn_arhmm_mstep_stats_f64``) in the
    inputs' dtype, summed in float64 either way; fixed-order sums, the same
    bits on every call."""
    name = 'arhmm_mstep_stats'
    (N, T, D, K, P, chunks, f64), (x, mask, gammas, tau) = _check_mstep(
        name, x, mask, gammas, tau, lags)
    kw = dict(device=x.device, dtype=x.dtype)
    XtWX, XtWY, wsum = torch.empty((K, P, P), **kw), torch.empty((K, P, D), **kw), \
        torch.empty(K, **kw)
    part = torch.empty((chunks, K, P * (P + 1) // 2 + P * D), device=x.device,
                       dtype=torch.float64)
    launch(name, x.data_ptr(), mask.data_ptr(), gammas.data_ptr(), _ptr(tau), N, T, D, K, lags,
           chunks, part.data_ptr(), XtWX.data_ptr(), XtWY.data_ptr(), wsum.data_ptr(),
           symbol='bn_arhmm_mstep_stats' + f64)
    return XtWX, XtWY, wsum


def mstep_cov_cuda(x, mask, gammas, tau, beta, lags, diagonal):
    """K31's second pass on the card: :func:`mstep_cov_plain`'s raw
    residual sums, (K, D, D) or (K, D) with ``diagonal``, float32 or
    float64 (``bn_arhmm_mstep_cov_f64``) in the inputs' dtype, the residuals
    and sums in float64 either way."""
    name = 'arhmm_mstep_cov'
    (N, T, D, K, P, chunks, f64), (x, mask, gammas, tau) = _check_mstep(
        name, x, mask, gammas, tau, lags, beta)
    beta = beta.contiguous()
    E = D if diagonal else D * (D + 1) // 2
    out = torch.empty((K, D) if diagonal else (K, D, D), device=x.device, dtype=x.dtype)
    part = torch.empty((chunks, K, E), device=x.device, dtype=torch.float64)
    launch('arhmm_mstep_stats', x.data_ptr(), mask.data_ptr(), gammas.data_ptr(), _ptr(tau),
           beta.data_ptr(), N, T, D, K, lags, int(diagonal), chunks, part.data_ptr(),
           out.data_ptr(), symbol='bn_arhmm_mstep_cov' + f64)
    return out


def mstep_stats(x, mask, gammas, tau, lags):
    """(XtWX (K, P, P), XtWY (K, P, D), wsum (K,)) of the M-step: K31 on a
    ``cuda`` tensor, the plain version on a ``cpu`` one."""
    if x.device.type == 'cpu':
        return mstep_stats_plain(x, mask, gammas, tau, lags)
    if x.device.type != 'cuda':
        raise ValueError('mstep_stats: no implementation for device %s' % x.device)
    return mstep_stats_cuda(x, mask, gammas, tau, lags)


def mstep_cov(x, mask, gammas, tau, beta, lags, diagonal):
    """The M-step's raw weighted residual sums, (K, D, D) or (K, D) with
    ``diagonal``: K31's second pass on a ``cuda`` tensor, the plain version
    on a ``cpu`` one."""
    if x.device.type == 'cpu':
        return mstep_cov_plain(x, mask, gammas, tau, beta, lags, diagonal)
    if x.device.type != 'cuda':
        raise ValueError('mstep_cov: no implementation for device %s' % x.device)
    return mstep_cov_cuda(x, mask, gammas, tau, beta, lags, diagonal)


# ---------------------- the recurrent and dof M-steps (K40, K41; row 18c)


def _check_part(name, tensors, suffix):
    """Raise unless ``tensors`` (one part's, under its device) lie on the
    current CUDA device in the dtype of the launchers ``suffix`` names."""
    if dtype_suffix(name, tensors) != suffix:
        raise ValueError('%s: tensors must be all float32 or all float64, got %s'
                         % (name, [t.dtype for t in tensors]))


def recurrent_log_P(log_Ps, Rs, r, x, transitions):
    """The recurrent transitions' log-probs (N, T-1, K, K) over padded
    trials ``x`` (N, T, D), the step t -> t+1 driven by ``Rs x_t``: logits
    ``log_Ps[j, k] + (Rs x_t)[k]`` ('recurrent') or ``r[k] + (Rs x_t)[k]``
    for every j ('recurrent_only'), log-softmaxed over k (JAX:
    models/arhmm.py:226)."""
    drive = torch.einsum('kd,ntd->ntk', Rs, x[:, :-1])   # (N, T-1, K)
    if transitions == 'recurrent':
        logits = log_Ps[None, None] + drive[:, :, None, :]
    else:   # recurrent_only: no base matrix
        N, S, K = drive.shape
        logits = (drive + r)[:, :, None, :].expand(N, S, K, K)
    return torch.log_softmax(logits, dim=3)


def recurrent_mstep_plain(log_Ps, Rs, r, x, xis, transitions):
    """K40's plain version: 25 Adam steps on -sum xis log_P over
    ``log_Ps``, ``Rs`` and ``r`` (JAX: models/arhmm.py:641), the gradient
    by autograd, the update ``optax.adam(1e-2)``'s written out (b1 0.9, b2
    0.999, eps 1e-8; a parameter the objective does not read keeps its
    value, as a zero gradient leaves it in optax). ``x`` (N, T, D) and the
    pairwise posteriors ``xis`` (N, T-1, K, K) under the old params are
    lists over the parts of a trial layout, each on its device: the
    objective is the sum of theirs, added in part order on the device of
    ``log_Ps``. Returns the new (log_Ps, Rs, r)."""
    trans = [p.detach().clone() for p in (log_Ps, Rs, r)]
    dev = trans[0].device
    mu = [torch.zeros_like(p) for p in trans]
    nu = [torch.zeros_like(p) for p in trans]
    xis = [v.detach() for v in xis]
    b1, b2, eps, lr = _ADAM_B1, _ADAM_B2, _ADAM_EPS, _RECURRENT_ADAM_LR
    for step in range(1, _RECURRENT_ADAM_STEPS + 1):
        leaves = [p.detach().requires_grad_(True) for p in trans]
        with torch.enable_grad():
            losses = [-torch.sum(xi * recurrent_log_P(*(v.to(xp.device) for v in leaves), xp,
                                                      transitions))
                      for xp, xi in zip(x, xis)]
            grads = torch.autograd.grad(_reduce(losses, dev), leaves, allow_unused=True)
        for i, g in enumerate(grads):
            if g is None:
                continue
            mu[i] = (1 - b1) * g + b1 * mu[i]
            nu[i] = (1 - b2) * g * g + b2 * nu[i]
            upd = (mu[i] / (1 - b1 ** step)) / (torch.sqrt(nu[i] / (1 - b2 ** step)) + eps)
            trans[i] = trans[i] - lr * upd
    return tuple(trans)


def _part_rows(rows, off, C, dev):
    """A part's rows ``off:off + C`` of the partials array ``rows``, for a
    launch on ``dev``: a view of them when ``rows`` lies on ``dev``, else a
    buffer there; and the function that copies the buffer into them once
    the launch is queued (nothing for the view)."""
    if dev == rows.device:
        return rows[off:off + C], lambda: None
    buf = torch.empty((C,) + tuple(rows.shape[1:]), device=dev, dtype=rows.dtype)
    return buf, lambda: rows[off:off + C].copy_(buf)


def recurrent_mstep_cuda(log_Ps, Rs, r, x, xis, transitions):
    """K40 on the card: :func:`recurrent_mstep_plain`'s 25 Adam steps with
    the gradient written out, float32 or float64
    (``bn_arhmm_recurrent_*_f64``), sums in float64 in a fixed order (the
    same bits on every call). Each part (a trial layout has several) runs
    the prep once and a pass each Adam step on its device, into its rows
    of one partials array on the device of ``log_Ps`` (copied there from
    another card); each step's update runs there, and the parameters are
    copied to the other parts' devices before the next step's passes: 1 +
    25 x 2 launches for one part. Returns the new (log_Ps, Rs, r)."""
    name = 'arhmm_recurrent_mstep'
    only = int(transitions == 'recurrent_only')
    dev0 = log_Ps.device
    K, D = Rs.shape
    if not 1 <= K <= _MAX_MSTEP_K or not 1 <= D <= _MAX_D:
        raise ValueError('%s: takes K <= %d states and D <= %d, got K=%d, D=%d'
                         % (name, _MAX_MSTEP_K, _MAX_D, K, D))
    if log_Ps.shape != (K, K) or r.shape != (K,):
        raise ValueError('%s: log_Ps must be (K, K) and r (K,) with K=%d, got %s, %s'
                         % (name, K, tuple(log_Ps.shape), tuple(r.shape)))
    R = 1 if only else K
    n_prep, n_step, n_theta = K * K + K + K * D, R * K + K * D, K * K + K * D + K
    parts = []
    for xp, xi in zip(x, xis):
        N, T = xp.shape[:2]
        if xp.shape[2] != D or xi.shape != (N, T - 1, K, K):
            raise ValueError('%s: x must be (N, T, %d) and xis (N, T-1, %d, %d), got %s, %s'
                             % (name, D, K, K, tuple(xp.shape), tuple(xi.shape)))
        parts.append((xp.contiguous(), xi.contiguous(), N, T, -(-N * (T - 1) // _REC_CHUNK)))
    dt = log_Ps.dtype
    with on_device(dev0):
        f64 = dtype_suffix(name, [log_Ps, Rs, r])
        theta = torch.cat([log_Ps.reshape(-1), Rs.reshape(-1), r.reshape(-1)])
        moments = torch.zeros(2 * n_theta, device=dev0, dtype=dt)
        lin = torch.empty(n_theta, device=dev0, dtype=torch.float64)
    rows = sum(p[4] for p in parts)
    prep_all = torch.empty((rows, n_prep), device=dev0, dtype=torch.float64)
    step_all = torch.empty((rows, n_step), device=dev0, dtype=torch.float64)
    runs, off = [], 0
    for xp, xi, N, T, C in parts:
        dev = xp.device
        with on_device(dev):
            _check_part(name, [xp, xi], f64)
            prep, prep_done = _part_rows(prep_all, off, C, dev)
            step_rows, step_done = _part_rows(step_all, off, C, dev)
            run = dict(xp=xp, N=N, T=T, C=C, step=step_rows, step_done=step_done,
                       theta=theta if dev == dev0 else torch.empty_like(theta, device=dev),
                       s=torch.empty((N * (T - 1), R), device=dev, dtype=dt))
            if C:
                launch(name, xi.data_ptr(), xp.data_ptr(), N, T, D, K, only, C,
                       prep.data_ptr(), run['s'].data_ptr(),
                       symbol='bn_arhmm_recurrent_prep' + f64)
            prep_done()
        runs.append(run)
        off += C
    for step in range(1, _RECURRENT_ADAM_STEPS + 1):
        for run in runs:
            with on_device(run['xp'].device):
                if run['theta'] is not theta:
                    run['theta'].copy_(theta)
                if run['C']:
                    launch(name, run['s'].data_ptr(), run['xp'].data_ptr(),
                           run['theta'].data_ptr(), run['N'], run['T'], D, K, only, run['C'],
                           run['step'].data_ptr(), symbol='bn_arhmm_recurrent_step' + f64)
                run['step_done']()
        with on_device(dev0):
            launch(name, prep_all.data_ptr(), rows, step_all.data_ptr(), rows, D, K, only, step,
                   _RECURRENT_ADAM_LR, lin.data_ptr(), theta.data_ptr(), moments.data_ptr(),
                   symbol='bn_arhmm_recurrent_update' + f64)
    return (theta[:K * K].view(K, K), theta[K * K:K * K + K * D].view(K, D),
            theta[K * K + K * D:])


def recurrent_mstep(log_Ps, Rs, r, x, xis, transitions):
    """The recurrent transitions' M-step, (log_Ps, Rs, r) after 25 Adam
    steps: K40 on a ``cuda`` tensor, the plain version on a ``cpu`` one.
    ``x`` and ``xis`` are lists over the parts of a trial layout."""
    if log_Ps.device.type == 'cpu':
        return recurrent_mstep_plain(log_Ps, Rs, r, x, xis, transitions)
    if log_Ps.device.type != 'cuda':
        raise ValueError('recurrent_mstep: no implementation for device %s' % log_Ps.device)
    return recurrent_mstep_cuda(log_Ps, Rs, r, x, xis, transitions)


def nu_mstep_plain(nus, parts, D):
    """K41's plain version: Newton steps on the per-state dof (JAX:
    models/arhmm.py:582): the root of log(nu/2) - digamma(nu/2) + c, with c
    = 1 + E_w[E[log tau] - tau] under the old params (every frame weighs
    its posterior, the first ``lags`` frames too), the derivative a forward
    difference of step 1e-3 nu, each step clipped to [1, 200]. ``parts``
    holds (mask (N, T), gammas (N, T, K), taus (N, T, K)) over each part's
    own frames, on its device; their sums add in part order on the device
    of ``nus``."""
    nus = torch.clamp(nus, min=1e-2)
    dev = nus.device
    sums = []
    for mask, gammas, taus in parts:
        w = gammas * mask[:, :, None]
        nu_p = nus.to(w.device)
        e_log_tau = torch.digamma(0.5 * (nu_p + D)) + torch.log(taus) \
            - torch.log(0.5 * (nu_p + D))
        sums.append((torch.sum(w, dim=(0, 1)), torch.sum(w * (e_log_tau - taus), dim=(0, 1))))
    wsum = torch.clamp(_reduce([sm[0] for sm in sums], dev), min=1e-8)
    c = 1.0 + _reduce([sm[1] for sm in sums], dev) / wsum
    nu = nus
    for _ in range(_NU_NEWTON_STEPS):
        half = 0.5 * nu
        f = torch.log(half) - torch.digamma(half) + c
        eps = 1e-3 * nu
        half2 = 0.5 * (nu + eps)
        f2 = torch.log(half2) - torch.digamma(half2) + c
        grad = (f2 - f) / eps
        step = f / torch.where(torch.abs(grad) > 1e-12, grad, torch.full_like(grad, -1e-12))
        nu = torch.clamp(nu - step, 1.0, 200.0)
    return nu


def nu_mstep_cuda(nus, parts, D):
    """K41 on the card: :func:`nu_mstep_plain`'s new nus, float32 or float64
    (``bn_arhmm_nu_*_f64``), computed in float64 either way; a pass per
    part on its device (tau may be a slice along time of a wider array)
    into the rows of one partials array on the device of ``nus`` (copied
    there from another card), then the sums and the Newton steps there in
    one small launch. Fixed-order sums: the same bits on every call."""
    name = 'arhmm_nu_mstep'
    K = nus.shape[0]
    if not 1 <= K <= _MAX_MSTEP_K:
        raise ValueError('%s: takes K <= %d states, got %d' % (name, _MAX_MSTEP_K, K))
    ins = []
    for mask, gammas, tau in parts:
        N, T = mask.shape
        if gammas.shape != (N, T, K) or tau.shape != (N, T, K):
            raise ValueError('%s: gammas and tau must be (N, T, %d) over mask (N, T) = %s, '
                             'got %s, %s' % (name, K, (N, T), tuple(gammas.shape),
                                             tuple(tau.shape)))
        if tau.stride()[1:] != (K, 1):
            tau = tau.contiguous()
        ins.append((mask.contiguous(), gammas.contiguous(), tau, N, T, -(-N * T // _NU_CHUNK)))
    dev0 = nus.device
    rows = sum(p[5] for p in ins)
    with on_device(dev0):
        f64 = dtype_suffix(name, [nus])
        part_all = torch.empty((rows, 2 * K), device=dev0, dtype=torch.float64)
        out = torch.empty_like(nus)
    off = 0
    for mask, gammas, tau, N, T, C in ins:
        dev = gammas.device
        with on_device(dev):
            nus_p = nus.to(dev)
            _check_part(name, [gammas, mask, tau, nus_p], f64)
            buf, done = _part_rows(part_all, off, C, dev)
            launch(name, gammas.data_ptr(), mask.data_ptr(), tau.data_ptr(), tau.stride(0),
                   nus_p.data_ptr(), N, T, K, D, C, buf.data_ptr(),
                   symbol='bn_arhmm_nu_pass' + f64)
            done()
        off += C
    with on_device(dev0):
        launch(name, part_all.data_ptr(), rows, K, nus.data_ptr(), out.data_ptr(),
               symbol='bn_arhmm_nu_finish' + f64)
    return out


def nu_mstep(nus, parts, D):
    """The new Student's-t dofs (K,) from ``parts`` of (mask, gammas, tau):
    K41 on a ``cuda`` tensor, the plain version on a ``cpu`` one."""
    if nus.device.type == 'cpu':
        return nu_mstep_plain(nus, parts, D)
    if nus.device.type != 'cuda':
        raise ValueError('nu_mstep: no implementation for device %s' % nus.device)
    return nu_mstep_cuda(nus, parts, D)


# ------------------------------------------------------------------ k-means


def _sq_dists(X, x_sq, C):
    return np.maximum(x_sq[:, None] - 2.0 * X @ C.T + np.sum(C ** 2, axis=1)[None], 0.0)


def _kmeans_pp(X, x_sq, K, rs):
    """Greedy k-means++ seeding: each new center is the best of
    2 + log(K) candidates drawn in proportion to the squared distance."""
    n = X.shape[0]
    n_local = 2 + int(np.log(K))
    centers = np.empty((K, X.shape[1]))
    centers[0] = X[rs.randint(n)]
    closest = _sq_dists(X, x_sq, centers[:1])[:, 0]
    for c in range(1, K):
        cand = np.searchsorted(np.cumsum(closest), rs.uniform(size=n_local) * closest.sum())
        cand = np.minimum(cand, n - 1)
        trial = np.minimum(closest[:, None], _sq_dists(X, x_sq, X[cand]))
        best = int(np.argmin(trial.sum(axis=0)))
        closest = trial[:, best]
        centers[c] = X[cand[best]]
    return centers


_KMEANS_MAX_ITER, _KMEANS_TOL = 300, 1e-4   # sklearn's KMeans defaults


def kmeans(X, K, n_init=10, rng_seed=0):
    """k-means in numpy: greedy k-means++ seeding from
    ``RandomState(rng_seed)``, ``n_init`` restarts of at most 300 Lloyd
    iterations, until the centers move less than 1e-4 times the mean
    feature variance (an empty cluster takes the point farthest from its
    center), the lowest inertia kept. Returns (labels (n,), centers (K, D),
    inertia)."""
    X = np.asarray(X, dtype=np.float64)
    if X.shape[0] < K:
        raise ValueError('k-means needs at least K=%d points, got %d' % (K, X.shape[0]))
    rs = np.random.RandomState(rng_seed)
    x_sq = np.sum(X ** 2, axis=1)
    tol_abs = _KMEANS_TOL * np.mean(np.var(X, axis=0))
    rows = np.arange(X.shape[0])
    XT32 = np.ascontiguousarray(X.T, dtype=np.float32)   # (D, n): the assignments
    best = None
    for _ in range(n_init):
        C = _kmeans_pp(X, x_sq, K, rs)
        labels = None
        for _ in range(_KMEANS_MAX_ITER):
            # nearest center: argmin_k |c_k|^2 - 2 c_k . x (|x|^2 is the same
            # for every k), over the (K, n) scores in float32
            C32 = C.astype(np.float32)
            scores = (-2.0 * C32) @ XT32 + np.sum(C32 ** 2, axis=1)[:, None]
            new_labels = np.argmin(scores, axis=0)
            if labels is not None and np.array_equal(new_labels, labels):
                break
            labels = new_labels
            counts = np.bincount(labels, minlength=K)
            C_new = np.stack([np.bincount(labels, weights=X[:, d], minlength=K)
                              for d in range(X.shape[1])], axis=1)
            C_new /= np.maximum(counts, 1)[:, None]
            empty = np.flatnonzero(counts == 0)
            if len(empty):
                far = np.argsort(_sq_dists(X, x_sq, C)[rows, labels])[::-1]
                C_new[empty] = X[far[:len(empty)]]
            shift = np.sum((C_new - C) ** 2)
            C = C_new
            if shift <= tol_abs:
                break
        d2 = _sq_dists(X, x_sq, C)
        labels = np.argmin(d2, axis=1)
        inertia = float(d2[rows, labels].sum())
        if best is None or inertia < best[2]:
            best = (labels, C, inertia)
    return best


# ------------------------------------------------------------------- model


def check_ported(observations, transitions, dtype='float32', parallel_scan=False):
    """Raise ``NotImplementedError`` for a configuration the port cannot fit
    yet (naming the slice that brings it), ``ValueError`` for an invalid one."""
    if observations not in _OBSERVATIONS + _ROBUST:
        raise ValueError('"%s" is an invalid observation type' % observations)
    if transitions not in _TRANSITIONS:
        raise ValueError('"%s" is an invalid transition type' % transitions)
    if dtype not in _DTYPES:
        raise ValueError('dtype must be "float32" or "float64", got %r' % (dtype,))
    if dtype == 'float64' and parallel_scan:
        raise NotImplementedError(_f64_refusal('parallel_scan'))


def _f64_refusal(what):
    return ('%s in float64 is not ported yet: it needs the parallel scans and samplers '
            '(K13-K16) in float64, the rest of ROADMAP item A1c' % what)


class ARHMM:
    """(AR)HMM with EM fitting; the JAX package's ``ARHMM`` API (itself
    ssm.HMM's where the reference uses it), with parameters held as tensors
    of ``dtype`` (float32, or float64 for float64 EM) on ``device``
    (``None`` means ``'cuda'``)."""

    def __init__(self, K, D, lags=1, observations='ar', transitions='stationary',
                 kappa=0.0, nu=4.0, rng_seed=0, parallel_scan=False, dtype='float32',
                 device=None):
        check_ported(observations, transitions, dtype, parallel_scan)
        self.device = resolve_device(device)
        self.K = int(K)
        self.D = int(D)
        self.observations = observations
        self.transitions = transitions
        self.kappa = float(kappa)
        self.rng_seed = rng_seed
        # parallel-prefix message passing (K13, K14): the same results to
        # float32 roundoff, shorter chains on long trials
        self.parallel_scan = bool(parallel_scan)
        self.dtype = dtype
        self.lags = int(lags) if 'ar' in observations.split('_') else 0
        self.diagonal = observations.startswith('diagonal')
        self.robust = observations in _ROBUST

        # drawn exactly as the JAX package draws them (models/arhmm.py:111-128)
        P = self.D * self.lags
        rng = np.random.RandomState(rng_seed)
        Ps = 0.95 * np.eye(K) + 0.05 * rng.rand(K, K)
        Ps /= Ps.sum(axis=1, keepdims=True)
        params = {
            'log_pi0': np.log(np.ones(K) / K),
            'log_Ps': np.log(Ps),
            'As': 0.8 * np.tile(np.eye(self.D), (K, 1, self.lags)) if self.lags > 0
            else np.zeros((K, self.D, max(P, 1))),
            'bs': 0.01 * rng.randn(K, self.D),
            'Sigmas': np.tile(np.eye(self.D), (K, 1, 1)),
            'nus': np.full((K,), float(nu)),
        }
        if self.recurrent:
            params['Rs'] = 0.01 * rng.randn(K, self.D)
            params['r'] = np.zeros(K)
        self.params = self._tensors(params)

    @property
    def recurrent(self):
        """Whether the transitions are input-driven, (N, T-1, K, K)."""
        return self.transitions in ('recurrent', 'recurrent_only')

    @property
    def torch_dtype(self):
        """The tensors' dtype: torch.float32, or torch.float64 for float64 EM."""
        return _DTYPES[self.dtype]

    def _tensors(self, arrays):
        return {k: torch.tensor(np.asarray(v), dtype=self.torch_dtype, device=self.device)
                for k, v in arrays.items()}

    def to(self, device):
        """Move the parameters to ``device``; returns the model."""
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in self.params.items()}
        return self

    # ------------------------------------------------------------------ io
    def __getstate__(self):
        state = dict(self.__dict__)
        state['params'] = {k: v.detach().cpu().numpy() for k, v in self.params.items()}
        del state['device']
        return state

    def __setstate__(self, state):
        # a JAX-written model carries its jit caches; they mean nothing here
        for key in ('_fit_step', '_fit_step_sp', '_fit_scan'):
            state.pop(key, None)
        state.setdefault('parallel_scan', False)
        state.setdefault('dtype', 'float32')
        state.setdefault('robust', state['observations'] in _ROBUST)
        check_ported(state['observations'], state['transitions'], state['dtype'],
                     state['parallel_scan'])
        self.__dict__.update(state)
        self.device = resolve_device(UNPICKLE_DEVICE.get())
        self.params = self._tensors(state['params'])

    def save(self, filepath):
        with open(filepath, 'wb') as f:
            pickle.dump(self, f)

    @staticmethod
    def load(filepath, device=None):
        """A pickled model of either package, on ``device``."""
        from behavenet_tpu_torch.utils.pickles import load_arhmm
        return load_arhmm(filepath, device=device)

    # ------------------------------------------------------ likelihood core
    def pad(self, datas):
        """A trial or list of trials -> :class:`PaddedTrials` of the model's
        dtype on its device (a :class:`PaddedTrials` passes through, cast as
        the JAX package pads in its dtype)."""
        if isinstance(datas, PaddedTrials):
            return PaddedTrials(*(t.to(self.device, self.torch_dtype) for t in datas))
        if not isinstance(datas, (list, tuple)):
            datas = [datas]
        return pad_trials(datas, self.device, self.torch_dtype)

    def _log_likes(self, params, x, mask, with_tau=False):
        """Per-frame observation log-likelihoods (N, T, K) of padded trials;
        with ``with_tau`` also the robust scale-mixture weights (N, T, K),
        None unless the observations are Student's t."""
        if self.robust:
            ll, tau = robust_log_likes(x, mask, params['As'], params['bs'],
                                       params['Sigmas'], params['nus'], self.lags,
                                       self.diagonal, with_tau)
        else:
            ll, tau = log_likes(x, mask, params['As'], params['bs'], params['Sigmas'],
                                self.lags, self.diagonal), None
        return (ll, tau) if with_tau else ll

    def _log_P(self, params, x=None):
        """Transition log-probs: (K, K) for stationary or sticky transitions;
        recurrent, (N, T-1, K, K) from the padded trials ``x``, the step t ->
        t+1 driven by ``Rs x_t`` (JAX: models/arhmm.py:226)."""
        if not self.recurrent:
            return torch.log_softmax(params['log_Ps'], dim=1)
        return recurrent_log_P(params['log_Ps'], params['Rs'], params['r'], x, self.transitions)

    # ------------------------------------------------------------- public api
    @_on_own_device
    def log_likelihood(self, datas):
        """Total log-likelihood of a trial, a list of trials or
        :class:`PaddedTrials` (ssm.HMM API), the forward pass alone."""
        x, mask = self.pad(datas)
        p = self.params
        log_Z = hmm_ops.log_normalizer(p['log_pi0'], self._log_P(p, x),
                                       self._log_likes(p, x, mask), mask,
                                       parallel=self.parallel_scan)
        return float(torch.sum(log_Z))

    @_on_own_device
    def most_likely_states_batch(self, datas):
        """Viterbi paths of a list of trials in one launch: a list of (T_i,)
        int32 arrays."""
        if not isinstance(datas, (list, tuple)):
            datas = [datas]
        x, mask = self.pad(datas)
        p = self.params
        paths = hmm_ops.viterbi(p['log_pi0'], self._log_P(p, x), self._log_likes(p, x, mask),
                                mask, parallel=self.parallel_scan).cpu().numpy()
        return [paths[i, :len(d)] for i, d in enumerate(datas)]

    def _check_mesh(self, mesh):
        if not isinstance(mesh, Mesh):
            raise TypeError('mesh must be a behavenet_tpu_torch.parallel.Mesh, got %r' % (mesh,))
        if self.dtype == 'float64':
            raise NotImplementedError(
                'a mesh in float64 is not ported yet: the time-sharded passes K32-K35 and the '
                'scans K13-K16 they build on take float32, the rest of ROADMAP item A1c')

    def _shards(self, data, mesh):
        """One trial cut along time over ``mesh``: log_pi0 on the first
        device and the trial's :class:`parallel.seq.Shard`\\ s, each shard's
        log-likelihoods and log-transitions made on its device from its
        frames and their lag history."""
        self._check_mesh(mesh)
        x, mask = self.pad([data])
        parts = self._time_parts(x, mask, mesh, max(self.lags, int(self.recurrent)))
        on = _params_on(self.params, parts)
        shards = per_device(lambda part: seq.Shard(
            part.device, self._part_obs(on[part.device], part), part.mask,
            *self._part_log_P(on[part.device], part), part.m_prev), parts)
        return on[parts[0].device]['log_pi0'], shards

    @staticmethod
    def _joined(per_shard):
        return torch.cat([t[0].cpu() for t in per_shard]).numpy()

    @_on_own_device
    def most_likely_states(self, data, mesh=None):
        """Viterbi path (T,) int32 of one trial (ssm.HMM API). With ``mesh``
        (a ``parallel.Mesh``) the trial's time axis is sharded over its
        devices (``parallel.seq.viterbi_shards``: K32-K35 on the card; JAX:
        models/arhmm.py:257)."""
        if mesh is not None:
            return self._joined(seq.viterbi_shards(*self._shards(data, mesh)))
        return self.most_likely_states_batch([data])[0]

    @_on_own_device
    def expected_states(self, data, mesh=None):
        """Posterior marginals gamma (T, K) of one trial; with ``mesh`` the
        time axis sharded (``parallel.seq.forward_backward_shards``: K32 and
        K33 on the card; JAX: models/arhmm.py:276)."""
        if mesh is not None:
            return self._joined(seq.forward_backward_shards(*self._shards(data, mesh))[0])
        x, mask = self.pad([data])
        p = self.params
        gamma, _, _ = hmm_ops.forward_backward(p['log_pi0'], self._log_P(p, x),
                                               self._log_likes(p, x, mask), mask,
                                               parallel=self.parallel_scan)
        return gamma[0].cpu().numpy()

    @_on_own_device
    def posterior_sample(self, data, generator=None, mesh=None):
        """A state path z ~ p(z | data) of one trial, (T,) int32 (JAX:
        models/arhmm.py:296): forward filtering, backward sampling with
        presampled predecessor maps (``ops.hmm.sample_posterior``; with
        ``parallel_scan`` the filter is the parallel scan), the uniforms
        from ``generator`` (on the model's device; ``None``: seeded from
        numpy). With ``mesh`` the time axis is sharded
        (``parallel.seq.sample_posterior_shards``: K32-K35 on the card), the
        uniforms drawn in the same order on the mesh's first device: the
        same generator state draws the same path, up to float reassociation
        at a near-tie."""
        self._check_sampling('posterior_sample')
        if mesh is not None:
            pi0, shards = self._shards(data, mesh)
            dev, T = shards[0].device, len(data)
            gen = hmm_ops.generator_for(dev, generator)
            u_last = hmm_ops.uniforms((1, self.K), gen, dev)
            u_maps = hmm_ops.uniforms((1, max(T - 1, 0), self.K, self.K), gen, dev)
            return self._joined(seq.sample_posterior_shards(pi0, shards, u_last, u_maps))
        x, mask = self.pad([data])
        p = self.params
        path = hmm_ops.sample_posterior(p['log_pi0'], self._log_P(p, x),
                                        self._log_likes(p, x, mask), mask,
                                        parallel=self.parallel_scan, generator=generator)
        return path[0].cpu().numpy()

    def _check_sampling(self, what):
        if self.dtype == 'float64':
            raise NotImplementedError(_f64_refusal(what))

    def _numpy_params(self):
        return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in self.params.items()}

    @_on_own_device
    def sample(self, T, generator=None, prefix=None, with_noise=True):
        """(states (T,) int32, observations (T, D) float32) from the generative
        model (JAX: models/arhmm.py:336). A stationary or sticky model draws
        its state chain first (``ops.hmm.sample_states``: K16 on the card),
        then the observations; recurrent transitions make z_{t+1} depend on
        x_t, so states and observations are drawn together in a host loop.
        The noise comes from ``generator`` (on the model's device; ``None``:
        seeded from numpy)."""
        self._check_sampling('sample')
        gen = hmm_ops.generator_for(self.device, generator)
        if not self.recurrent:
            lp = torch.log_softmax(self.params['log_Ps'], dim=1)
            zs = hmm_ops.sample_states(self.params['log_pi0'], lp, T, generator=gen)[0]
            zs = zs.cpu().numpy()
            return zs, self.sample_x(zs, generator=gen, prefix=prefix, with_noise=with_noise)

        K, D = self.K, self.D
        p = self._numpy_params()
        rs = np.random.RandomState(int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                                     device=self.device)))
        pi0 = np.exp(p['log_pi0'] - p['log_pi0'].max())
        pi0 /= pi0.sum()
        chols = np.linalg.cholesky(p['Sigmas'] + 1e-8 * np.eye(D))
        noise = self._noise(gen, T)
        hist = [] if prefix is None else [np.asarray(v) for v in prefix]
        zs = np.zeros(T, dtype=np.int32)
        xs = np.zeros((T, D), dtype=np.float32)
        for t in range(T):
            if t == 0:
                zs[0] = rs.choice(K, p=pi0)
            else:
                drive = p['Rs'] @ xs[t - 1]
                if self.transitions == 'recurrent':
                    logits = p['log_Ps'][zs[t - 1]] + drive
                else:   # recurrent_only: the logits ignore the previous state
                    logits = drive + p['r']
                q = np.exp(logits - logits.max())
                zs[t] = rs.choice(K, p=q / q.sum())
            mu = self._ar_mean(p, int(zs[t]), t, xs, hist)
            xs[t] = mu + (chols[zs[t]] @ noise[t] if with_noise else 0.0)
        return zs, xs

    def _noise(self, gen, T):
        """(T, D) standard normal noise from ``gen``, as float64 numpy."""
        return torch.randn((T, self.D), generator=gen, device=self.device).cpu().numpy() \
            .astype(np.float64)

    def _ar_mean(self, p, k, t, xs, hist):
        """The mean of x_t under state k given the sample so far (JAX:
        models/arhmm.py:378): the lags reach into ``hist`` (the prefix)
        before frame 0, and read zeros past it."""
        D, lags = self.D, self.lags
        mu = p['bs'][k].copy()
        for lag in range(1, lags + 1):
            if t - lag >= 0:
                x_lag = xs[t - lag]
            elif len(hist) >= lag - t:
                x_lag = hist[-(lag - t)]
            else:
                x_lag = np.zeros(D)
            mu += p['As'][k][:, (lag - 1) * D:lag * D] @ x_lag
        return mu

    def sample_x(self, states, generator=None, prefix=None, with_noise=True):
        """Observations (T, D) float32 given a state sequence (JAX:
        models/arhmm.py:396), the noise from ``generator`` (on the model's
        device; ``None``: seeded from numpy)."""
        self._check_sampling('sample_x')
        gen = hmm_ops.generator_for(self.device, generator)
        states = np.asarray(states)
        T, D = len(states), self.D
        p = self._numpy_params()
        chols = np.linalg.cholesky(p['Sigmas'] + 1e-8 * np.eye(D))
        noise = self._noise(gen, T)
        xs = np.zeros((T, D), dtype=np.float32)
        hist = [] if prefix is None else [np.asarray(v) for v in prefix]
        for t in range(T):
            k = int(states[t])
            mu = self._ar_mean(p, k, t, xs, hist)
            xs[t] = mu + (chols[k] @ noise[t] if with_noise else 0.0)
        return xs

    def permute(self, perm):
        """Relabel states by ``perm`` (ssm.HMM API; the CLI's usage sort)."""
        perm = torch.tensor(np.array(perm, dtype=np.int64), device=self.device)
        p = self.params
        new = dict(p)
        new['log_pi0'] = p['log_pi0'][perm]
        new['log_Ps'] = p['log_Ps'][perm][:, perm]
        for key in ('As', 'bs', 'Sigmas', 'nus', 'Rs', 'r'):
            if key in p:
                new[key] = p[key][perm]
        self.params = new

    # ------------------------------------------------------------------- EM
    def initialize(self, datas, localize=True):
        """ssm-style initialization: k-means clusters of the frames (the
        port's :func:`kmeans`, 10 restarts from ``rng_seed``), then per-cluster
        (AR) least squares, as the JAX package's (models/arhmm.py:414)."""
        datas = [np.asarray(d) for d in datas]
        stacked = np.vstack(datas).astype(np.float64)
        labels = kmeans(stacked, self.K, n_init=10, rng_seed=self.rng_seed)[0]
        D, lags, K = self.D, self.lags, self.K

        bs = np.zeros((K, D))
        As = np.zeros((K, D, max(D * lags, 1)))
        Sigmas = np.tile(np.eye(D), (K, 1, 1))
        if lags == 0:
            for k in range(K):
                pts = stacked[labels == k]
                if len(pts) > 1:
                    bs[k] = pts.mean(axis=0)
                    Sigmas[k] = np.cov(pts.T) + 1e-4 * np.eye(D)
        else:
            offset = 0
            Xs, Ys, Ls = [], [], []
            for d in datas:
                T = d.shape[0]
                if T <= lags:
                    offset += T
                    continue
                feats = np.concatenate(
                    [d[lags - l:T - l] for l in range(1, lags + 1)], axis=1)
                Xs.append(np.concatenate([feats, np.ones((T - lags, 1))], axis=1))
                Ys.append(d[lags:])
                Ls.append(labels[offset + lags:offset + T])
                offset += T
            X, Y, L = np.vstack(Xs), np.vstack(Ys), np.concatenate(Ls)
            for k in range(K):
                sel = (L == k) if localize else np.ones(len(L), dtype=bool)
                if sel.sum() < D * lags + 1:
                    sel = np.ones(len(L), dtype=bool)
                Xk, Yk = X[sel], Y[sel]
                beta = np.linalg.lstsq(
                    Xk.T @ Xk + 1e-4 * np.eye(Xk.shape[1]), Xk.T @ Yk, rcond=None)[0]
                As[k] = beta[:-1].T
                bs[k] = beta[-1]
                resid = Yk - Xk @ beta
                Sigmas[k] = (resid.T @ resid) / max(len(Yk), 1) + 1e-4 * np.eye(D)

        self.params = dict(self.params)
        self.params.update(self._tensors({'As': As, 'bs': bs, 'Sigmas': Sigmas}))

    # A part of the padded trials that one device holds: for EM on one
    # device the trials themselves; on a mesh a slice of the trials (the
    # trial layout) or of the frames (the time layout). x carries ``halo``
    # frames before the part's own (the wrapped history of global frame
    # t0 - halo .. t0 - 1) so that its design rows and lags need no other
    # device; mask (N, Ts) covers its own frames, t0 is the global index of
    # the first, m_prev the mask of frame t0 - 1 (time layout, t0 > 0).
    def _part(self, x, mask):
        return _Part(x.device, x, mask, 0, 0, None)

    def _time_parts(self, x, mask, mesh, halo):
        """The time layout: frames [t0, t1) of every trial on each mesh
        device (``parallel.seq.shard_bounds``), with ``halo`` frames of
        history (the trial's wrapped end before frame 0, as the JAX
        package's ``jnp.roll``)."""
        T = x.shape[1]
        parts = []
        for (t0, t1), dev in zip(seq.shard_bounds(T, mesh.size), mesh.devices):
            if t1 > t0:
                rows = torch.arange(t0 - halo, t1, device=x.device) % T
                parts.append(_Part(dev, x[:, rows].to(dev), mask[:, t0:t1].to(dev), halo, t0,
                                   mask[:, t0 - 1].to(dev) if t0 else None))
        return parts

    def _layout(self, x, mask, mesh=None, shard_time=False):
        """The parts of EM over padded trials: one on their device, or on
        ``mesh`` the time layout (T padded to a mesh multiple with masked
        frames, JAX: models/arhmm.py:733-741) or the trial layout (the trial
        count padded with fully masked trials, :752-757). Returns (parts,
        shard_time, the padded trial count)."""
        if mesh is None:
            return [self._part(x, mask)], False, x.shape[0]
        n = mesh.size
        if shard_time:
            pad = (-x.shape[1]) % n
            x = torch.cat([x, x.new_zeros((x.shape[0], pad, x.shape[2]))], dim=1)
            mask = torch.cat([mask, mask.new_zeros((mask.shape[0], pad))], dim=1)
            return self._time_parts(x, mask, mesh, self.lags), True, x.shape[0]
        pad = (-x.shape[0]) % n
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        mask = torch.cat([mask, mask.new_zeros((pad,) + mask.shape[1:])])
        per = x.shape[0] // n
        return [_Part(dev, x[i * per:(i + 1) * per].to(dev), mask[i * per:(i + 1) * per].to(dev),
                      0, 0, None) for i, dev in enumerate(mesh.devices)], False, x.shape[0]

    def _part_obs(self, params, part, with_tau=False):
        """A part's observation log-likelihoods over its own frames (N, Ts,
        K) and, with ``with_tau``, the robust weights over its rows with the
        halo (N, H + Ts, K) (None unless Student's t). A time shard's frames
        before global frame ``lags`` take the initial condition there."""
        H = part.halo
        mask = torch.cat([part.mask.new_zeros((part.mask.shape[0], H)), part.mask], dim=1)
        ll, tau = self._log_likes(params, part.x, mask, with_tau=True)
        ll = ll[:, H:]
        first = min(max(self.lags - part.t0, 0), ll.shape[1]) if H else 0
        if first:
            own = part.x[:, H:H + first]
            init = -0.5 * (self.D * LN2PI + torch.sum(own ** 2, dim=2))
            ll = torch.cat([init[:, :, None].expand(-1, -1, self.K) * part.mask[:, :first, None],
                            ll[:, first:]], dim=1)
        return (ll, tau) if with_tau else ll

    def _part_log_P(self, params, part):
        """A time shard's transition log-probs: (its own steps, the step
        into its first frame or None on the first shard), (K, K) each, or
        recurrent (N, Ts-1, K, K) and (N, K, K) driven by the halo's last
        frame."""
        if not self.recurrent:
            lp = self._log_P(params)
            return lp, (lp if part.t0 else None)
        H = part.halo
        if not part.t0:
            return self._log_P(params, part.x[:, H:]), None
        steps = self._log_P(params, part.x[:, H - 1:])
        return steps[:, 1:], steps[:, 0]

    def _em_step(self, params, x, mask):
        """One EM iteration on padded trials (N, T, D) on one device: returns
        (new params, the total log-likelihood under ``params`` as a 0-d
        tensor)."""
        return self._em_step_parts(params, self._layout(x, mask))

    def _em_step_parts(self, params, layout):
        """One EM iteration over :meth:`_layout`'s parts: each part's E-step
        on its device (K8, then K9 or K13 per trial part, or the time
        shards' K32 and K33 through ``parallel.seq``), the M-step's sums per
        part added in part order on the first part's device, where the new
        parameters are made (JAX: models/arhmm.py:474 ``_em_step``, :561
        ``_em_step_sp``); recurrent, K40's prep and step passes per part and
        its Adam updates on the first. Each part's launches run under its
        device, the M-step's under the first part's."""
        parts, shard_time, n_trials = layout
        dev0 = parts[0].device
        on = _params_on(params, parts)
        obs = per_device(lambda part: self._part_obs(on[part.device], part, with_tau=True), parts)
        xis = None
        if shard_time:
            shards = [seq.Shard(part.device, ll, part.mask,
                                *self._part_log_P(on[part.device], part), part.m_prev)
                      for part, (ll, _) in zip(parts, obs)]
            gammas, log_Z, xi_sum = seq.forward_backward_shards(on[dev0]['log_pi0'], shards)
            total_ll, counts, pi0_sum = log_Z.sum(), xi_sum.sum(0), gammas[0][:, 0].sum(0)
        else:
            posts = per_device(lambda part, o: hmm_ops.forward_backward(
                on[part.device]['log_pi0'], self._log_P(on[part.device], part.x), o[0], part.mask,
                with_xi=self.recurrent, parallel=self.parallel_scan), parts, obs)
            gammas = [post[0] for post in posts]
            total_ll = _reduce([post[1].sum() for post in posts], dev0)
            counts = _reduce([post[2].sum(0) for post in posts], dev0)
            pi0_sum = _reduce([post[0][:, 0].sum(0) for post in posts], dev0)
            if self.recurrent:
                xis = [post[3] for post in posts]
        with on_device(dev0):
            new = self._m_step_parts(on[dev0], parts, gammas, [tau for _, tau in obs], counts,
                                     pi0_sum, n_trials)
        if self.recurrent:
            new.update(self._m_step_recurrent(on[dev0], [part.x for part in parts], xis))
        return new, total_ll

    def _m_step(self, params, x, mask, gammas, xi_sums, tau=None):
        """All M-step updates from the posteriors but the recurrent
        transitions' (JAX: models/arhmm.py:484), on padded trials on one
        device, with the robust weights ``tau`` (N, T, K) under
        ``params``."""
        with on_device(x.device):
            return self._m_step_parts(params, [self._part(x, mask)], [gammas], [tau],
                                      torch.sum(xi_sums, dim=0), gammas[:, 0].sum(0),
                                      x.shape[0])

    def _mstep_inputs(self, part, gammas, tau):
        """K31's inputs over a part's rows with the halo, (x, mask, gammas,
        tau): the halo weighs 0, and so do a time shard's frames before
        global frame ``lags`` (K31's own t >= lags rule sees local rows)."""
        H = part.halo
        tau = tau if self.robust else None
        if not H:
            return part.x, part.mask, gammas, tau
        N, T_s = part.mask.shape
        late = torch.arange(part.t0, part.t0 + T_s, device=part.mask.device) >= self.lags
        mask = torch.cat([part.mask.new_zeros((N, H)), part.mask * late], dim=1)
        return part.x, mask, torch.cat([gammas.new_zeros((N, H, self.K)), gammas], dim=1), tau

    def _m_step_parts(self, params, parts, gammas, taus, counts, pi0_sum, n_trials):
        """The M-step over parts (JAX: models/arhmm.py:484): every sum over
        (trial, frame) is a sum of the parts' sums, added in part order on
        the device of ``params`` (the first part's): the initial
        distribution from ``pi0_sum`` (the posteriors of frame 0 summed
        over the trials) over ``n_trials``, the transition ``counts``, K31's
        two passes per part around one solve (K11), the dof's M-step (K41's
        pass per part, its Newton steps on the first). Returns
        the new params dict on that device. Each part's K31 launches run
        under its device; the caller makes that of ``params`` current for
        the rest."""
        K, D, lags = self.K, self.D, self.lags
        dev = params['log_pi0'].device
        dt = params['log_pi0'].dtype
        new = dict(params)

        pi0 = pi0_sum.to(dev) / n_trials + 1e-8
        new['log_pi0'] = torch.log(pi0 / torch.sum(pi0))

        if not self.recurrent:
            counts = counts.to(dev)
            if self.transitions == 'sticky':
                counts = counts + self.kappa * torch.eye(K, dtype=dt, device=dev)
            counts = counts + 1e-8
            new['log_Ps'] = torch.log(counts / torch.sum(counts, dim=1, keepdim=True))

        # weighted least squares over the frames (K31's first pass): frames
        # without a full lag history weigh 0, robust ones tau times more
        inputs = [self._mstep_inputs(part, g, tau) for part, g, tau in zip(parts, gammas, taus)]
        stats = per_device(lambda part, args: mstep_stats(*args, lags), parts, inputs)
        XtWX, XtWY, wsum = (_reduce([st[i] for st in stats], dev) for i in range(3))
        Pdim = XtWX.shape[1]
        # Jacobi equilibration, then a relative 1e-5 ridge: SPD, so the
        # pivot-free unrolled solve is safe
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(XtWX, dim1=1, dim2=2), min=1e-8))
        A = XtWX * s[:, :, None] * s[:, None, :] + \
            1e-5 * torch.eye(Pdim, dtype=dt, device=dev)[None]
        beta = s[:, :, None] * solve_small(A, XtWY * s[:, :, None])   # (K, P, D)
        if lags > 0:
            new['As'] = beta[:, :-1, :].transpose(1, 2).contiguous()
        new['bs'] = beta[:, -1, :].contiguous()

        # the residuals' weighted sums (K31's second pass); wsum holds tau,
        # as the JAX package's code has it
        S = _reduce(per_device(lambda part, args: mstep_cov(*args, beta.to(part.device), lags,
                                                            self.diagonal), parts, inputs), dev)
        if self.diagonal:
            var = S / torch.clamp(wsum[:, None], min=1e-8) + 1e-6
            new['Sigmas'] = torch.diag_embed(var)
        else:
            Sig = S / torch.clamp(wsum[:, None, None], min=1e-8)
            # symmetrize, plus a scale-relative jitter that keeps the next
            # E-step's Cholesky positive definite
            Sig = 0.5 * (Sig + Sig.transpose(1, 2))
            jit = 1e-6 * (1.0 + torch.diagonal(Sig, dim1=1, dim2=2).amax(dim=1))
            new['Sigmas'] = Sig + jit[:, None, None] * torch.eye(D, dtype=dt, device=dev)[None]

        if self.robust:
            # the dof's Newton steps (K41): the sums over every part's own
            # frames, the first lags too
            new['nus'] = nu_mstep(params['nus'], [(part.mask, g, tau[:, part.halo:])
                                                  for part, g, tau in zip(parts, gammas, taus)],
                                  D)
        return new

    def _m_step_recurrent(self, params, x, xis):
        """The recurrent transitions' gradient M-step (JAX:
        models/arhmm.py:641) through :func:`recurrent_mstep` (K40 on the
        card): 25 Adam steps on -sum xis log_P_new over ``log_Ps``, ``Rs``
        and ``r`` from the per-step pairwise posteriors ``xis`` (N, T-1, K,
        K) under the old params. ``x`` and ``xis`` may be lists over the
        parts of a trial layout, each on its device; the sums add in part
        order on the device of ``params``. Returns the three tensors."""
        keys = ('log_Ps', 'Rs', 'r')
        if torch.is_tensor(x):
            x, xis = [x], [xis]
        return dict(zip(keys, recurrent_mstep(*(params[k] for k in keys), x, xis,
                                              self.transitions)))

    @_on_own_device
    def fit(self, datas, method='em', num_iters=1, initialize=False, tolerance=0.0,
            mesh=None, shard_time=False, iters_per_dispatch=1):
        """Run EM iterations (ssm.HMM.fit API subset); returns the
        log-likelihood before each iteration's M-step, as Python floats.
        ``datas`` is a list of trials or :class:`PaddedTrials` (then
        ``initialize`` is not available). With ``tolerance > 0`` EM stops
        once the relative change of the last two values is below it.

        ``mesh`` (a ``parallel.Mesh``) spreads EM over its devices (JAX:
        models/arhmm.py:684): the trials (padded to a mesh multiple with
        fully masked trials, which add nothing) or, with ``shard_time``,
        every trial's frames (padded with masked frames; stationary and
        sticky transitions only), each part's E-step on its device and the
        M-step's sums added in part order on the first. ``iters_per_dispatch``
        runs k iterations back to back with their log-likelihoods kept on
        the device and read once; the tolerance is checked between such
        runs (a fit may go up to k - 1 iterations past the stopping point),
        and the ``num_iters % k`` left over run one at a time."""
        if method != 'em':
            raise NotImplementedError('only EM fitting is supported')
        if shard_time and mesh is None:
            raise ValueError('shard_time=True requires mesh= (a parallel.Mesh to shard the time '
                             'axis over); without one the run would silently be single-device')
        if mesh is not None:
            self._check_mesh(mesh)
            if shard_time and self.recurrent:
                raise NotImplementedError('shard_time EM supports stationary/sticky transitions '
                                          'only')
        if initialize:
            if isinstance(datas, PaddedTrials):
                raise ValueError('initialize needs the list of trials, not PaddedTrials')
            self.initialize(datas if isinstance(datas, (list, tuple)) else [datas])
        layout = self._layout(*self.pad(datas), mesh, shard_time)
        k = max(1, int(iters_per_dispatch))
        params, lls = self.params, []
        while len(lls) < num_iters:
            if tolerance > 0 and len(lls) >= 2 and \
                    abs((lls[-1] - lls[-2]) / lls[-1]) < tolerance:
                break
            dispatch = []
            for _ in range(k if num_iters - len(lls) >= k else 1):
                params, ll = self._em_step_parts(params, layout)
                dispatch.append(ll)
            lls.extend(torch.stack(dispatch).tolist())
            self.params = {key: v.to(self.device) for key, v in params.items()}
        return lls
