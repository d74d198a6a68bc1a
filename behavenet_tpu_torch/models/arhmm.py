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
  transitions (N, T-1, K, K) driven by ``Rs x_t`` (:meth:`ARHMM._log_P`,
  PyTorch ops, as plain ops in the JAX package);
- forward-backward over all trials (``ops.hmm.forward_backward``: K9, or
  K13 with ``parallel_scan``), which with recurrent transitions also
  writes the per-step pairwise posteriors;
- the M-step: the initial distribution; the transition counts (plus kappa
  on the diagonal when sticky) or, recurrent, 25 Adam steps (lr 1e-2) on
  the expected transitions' log-likelihood over ``log_Ps``, ``Rs`` and
  ``r`` (the gradient by autograd, the update ``optax.adam``'s written
  out); per-state weighted least squares (weights times tau when robust)
  with the JAX package's Jacobi equilibration and 1e-5 ridge,
  solved by ``ops.smallmat.solve_small`` (K11), then the weighted residual
  covariances; robust, 10 finite-difference Newton steps on the dof nu.
  Its weighted contractions are ``torch.einsum``, as they are plain einsums
  in the JAX package.

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

Not ported yet, and raising ``NotImplementedError``: ``em_dtype='float64'``
(ROADMAP A1c), meshes and ``iters_per_dispatch > 1``.
"""

import collections
import contextvars
import pickle

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import launch
from behavenet_tpu_torch.ops import hmm as hmm_ops
from behavenet_tpu_torch.ops.smallmat import solve_small
from behavenet_tpu_torch.utils.device import resolve_device

__all__ = ['ARHMM', 'PaddedTrials', 'pad_trials', 'obs_precision', 'log_likes',
           'log_likes_plain', 'log_likes_cuda', 'student_t_terms', 'robust_log_likes',
           'robust_log_likes_plain', 'robust_log_likes_cuda', 'kmeans', 'check_ported']

LN2PI = float(np.log(2 * np.pi))
_OBSERVATIONS = ('ar', 'gaussian', 'diagonal_ar', 'diagonal_gaussian')
_ROBUST = ('robust_ar', 'studentst', 'diagonal_robust_ar', 'diagonal_studentst')
_TRANSITIONS = ('stationary', 'sticky', 'recurrent', 'recurrent_only')
_RECURRENT_ADAM_STEPS, _RECURRENT_ADAM_LR = 25, 1e-2   # models/arhmm.py:670-680
_NU_NEWTON_STEPS = 10                                   # models/arhmm.py:613
_MAX_D, _MAX_LAG_COLS = 16, 64  # K8 keeps a frame and its lags in registers

# the device an unpickled model's parameters go to: ``utils.pickles.load``
# sets it; unset, ``None`` means 'cuda' (which raises without a GPU)
UNPICKLE_DEVICE = contextvars.ContextVar('UNPICKLE_DEVICE', default=None)

# stacked trials (N, T, D) and their mask (N, T), on one device
PaddedTrials = collections.namedtuple('PaddedTrials', ['x', 'mask'])


def pad_trials(datas, device):
    """List of (T_i, D) arrays -> :class:`PaddedTrials` on ``device``."""
    datas = [np.asarray(d, dtype=np.float32) for d in datas]
    t_max = max(d.shape[0] for d in datas)
    x = np.zeros((len(datas), t_max, datas[0].shape[1]), dtype=np.float32)
    mask = np.zeros((len(datas), t_max), dtype=np.float32)
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
    """K8's input checks: x, mask, As, bs, prec, logdet (or c)[, nus]."""
    x, mask, As, bs, prec, logdet = tensors[:6]
    for t in tensors:
        if t.device.type != 'cuda' or t.device != x.device:
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
        if t.dtype != torch.float32:
            raise ValueError('%s: tensors must be float32, got %s' % (name, t.dtype))
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


def log_likes_cuda(x, mask, As, bs, prec, logdet, lags, diagonal):
    """K8 on the card: :func:`log_likes_plain`'s (N, T, K)."""
    name = 'arhmm_log_likes'
    tensors = (x, mask, As, bs, prec, logdet)
    _check_log_likes(name, tensors, lags, diagonal)
    N, T, D = x.shape
    K, P = bs.shape[0], As.shape[2]
    x, mask, As, bs, prec, logdet = (t.contiguous() for t in tensors)
    out = torch.empty((N, T, K), device=x.device, dtype=torch.float32)
    if out.numel():
        launch(name, x.data_ptr(), mask.data_ptr(), As.data_ptr(), bs.data_ptr(),
               prec.data_ptr(), logdet.data_ptr(), N, T, D, K, P, lags, int(diagonal),
               out.data_ptr())
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
    :func:`robust_log_likes_plain`."""
    name = 'arhmm_log_likes'
    N, T, D = x.shape
    K = bs.shape[0]
    _check_log_likes(name, (x, mask, As, bs, prec, c, nus), lags, diagonal)
    if nus.shape != (K,):
        raise ValueError('%s: nus must be (K,), got %s' % (name, tuple(nus.shape)))
    x, mask, As, bs, prec, c, nus = (t.contiguous() for t in (x, mask, As, bs, prec, c, nus))
    out = torch.empty((N, T, K), device=x.device, dtype=torch.float32)
    tau = torch.empty((N, T, K), device=x.device, dtype=torch.float32) if with_tau else None
    if out.numel():
        launch(name, x.data_ptr(), mask.data_ptr(), As.data_ptr(), bs.data_ptr(),
               prec.data_ptr(), c.data_ptr(), nus.data_ptr(), N, T, D, K, As.shape[2], lags,
               int(diagonal), out.data_ptr(), tau.data_ptr() if with_tau else None,
               symbol='bn_arhmm_log_likes_robust')
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


def check_ported(observations, transitions, dtype='float32'):
    """Raise ``NotImplementedError`` for a configuration the port cannot fit
    yet (naming the slice that brings it), ``ValueError`` for an invalid one."""
    if observations not in _OBSERVATIONS + _ROBUST:
        raise ValueError('"%s" is an invalid observation type' % observations)
    if transitions not in _TRANSITIONS:
        raise ValueError('"%s" is an invalid transition type' % transitions)
    if dtype != 'float32':
        raise NotImplementedError('em_dtype "%s" is not ported; the port runs EM in '
                                  'float32 (float64 EM is ROADMAP item A1c)' % dtype)


class ARHMM:
    """(AR)HMM with EM fitting; the JAX package's ``ARHMM`` API (itself
    ssm.HMM's where the reference uses it), with parameters held as float32
    tensors on ``device`` (``None`` means ``'cuda'``)."""

    def __init__(self, K, D, lags=1, observations='ar', transitions='stationary',
                 kappa=0.0, nu=4.0, rng_seed=0, parallel_scan=False, dtype='float32',
                 device=None):
        check_ported(observations, transitions, dtype)
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

    def _tensors(self, arrays):
        return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=self.device)
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
        check_ported(state['observations'], state['transitions'], state['dtype'])
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
        """A trial or list of trials -> :class:`PaddedTrials` on the model's
        device (a :class:`PaddedTrials` passes through)."""
        if isinstance(datas, PaddedTrials):
            return PaddedTrials(datas.x.to(self.device), datas.mask.to(self.device))
        if not isinstance(datas, (list, tuple)):
            datas = [datas]
        return pad_trials(datas, self.device)

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
        drive = torch.einsum('kd,ntd->ntk', params['Rs'], x[:, :-1])   # (N, T-1, K)
        if self.transitions == 'recurrent':
            logits = params['log_Ps'][None, None] + drive[:, :, None, :]
        else:   # recurrent_only: no base matrix
            N, S, K = drive.shape
            logits = (drive + params['r'])[:, :, None, :].expand(N, S, K, K)
        return torch.log_softmax(logits, dim=3)

    # ------------------------------------------------------------- public api
    def log_likelihood(self, datas):
        """Total log-likelihood of a trial, a list of trials or
        :class:`PaddedTrials` (ssm.HMM API), the forward pass alone."""
        x, mask = self.pad(datas)
        p = self.params
        log_Z = hmm_ops.log_normalizer(p['log_pi0'], self._log_P(p, x),
                                       self._log_likes(p, x, mask), mask,
                                       parallel=self.parallel_scan)
        return float(torch.sum(log_Z))

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

    def most_likely_states(self, data, mesh=None):
        """Viterbi path (T,) int32 of one trial (ssm.HMM API)."""
        if mesh is not None:
            raise NotImplementedError('sequence-parallel Viterbi (mesh) is not ported yet')
        return self.most_likely_states_batch([data])[0]

    def expected_states(self, data, mesh=None):
        """Posterior marginals gamma (T, K) of one trial."""
        if mesh is not None:
            raise NotImplementedError('sequence-parallel forward-backward (mesh) is not '
                                      'ported yet')
        x, mask = self.pad([data])
        p = self.params
        gamma, _, _ = hmm_ops.forward_backward(p['log_pi0'], self._log_P(p, x),
                                               self._log_likes(p, x, mask), mask,
                                               parallel=self.parallel_scan)
        return gamma[0].cpu().numpy()

    def posterior_sample(self, data, generator=None, mesh=None):
        """A state path z ~ p(z | data) of one trial, (T,) int32 (JAX:
        models/arhmm.py:296): forward filtering, backward sampling with
        presampled predecessor maps (``ops.hmm.sample_posterior``; with
        ``parallel_scan`` the filter is the parallel scan), the uniforms
        from ``generator`` (on the model's device; ``None``: seeded from
        numpy)."""
        if mesh is not None:
            raise NotImplementedError('sequence-parallel posterior sampling (mesh) is not '
                                      'ported yet')
        x, mask = self.pad([data])
        p = self.params
        path = hmm_ops.sample_posterior(p['log_pi0'], self._log_P(p, x),
                                        self._log_likes(p, x, mask), mask,
                                        parallel=self.parallel_scan, generator=generator)
        return path[0].cpu().numpy()

    def _numpy_params(self):
        return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in self.params.items()}

    def sample(self, T, generator=None, prefix=None, with_noise=True):
        """(states (T,) int32, observations (T, D) float32) from the generative
        model (JAX: models/arhmm.py:336). A stationary or sticky model draws
        its state chain first (``ops.hmm.sample_states``: K16 on the card),
        then the observations; recurrent transitions make z_{t+1} depend on
        x_t, so states and observations are drawn together in a host loop.
        The noise comes from ``generator`` (on the model's device; ``None``:
        seeded from numpy)."""
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

    def _em_step(self, params, x, mask):
        """One EM iteration on padded trials (N, T, D): returns (new params,
        the total log-likelihood under ``params`` as a 0-d tensor)."""
        ll, tau = self._log_likes(params, x, mask, with_tau=True)
        post = hmm_ops.forward_backward(params['log_pi0'], self._log_P(params, x), ll, mask,
                                        with_xi=self.recurrent, parallel=self.parallel_scan)
        gammas, log_Zs, xi_sums = post[:3]
        new = self._m_step(params, x, mask, gammas, xi_sums, tau)
        if self.recurrent:
            new.update(self._m_step_recurrent(params, x, post[3]))
        return new, torch.sum(log_Zs)

    def _m_step(self, params, x, mask, gammas, xi_sums, tau=None):
        """All M-step updates from the posteriors but the recurrent
        transitions' (JAX: models/arhmm.py:484), with the robust weights
        ``tau`` (N, T, K) under ``params``."""
        K, D, lags = self.K, self.D, self.lags
        dev = x.device
        new = dict(params)

        pi0 = torch.mean(gammas[:, 0, :], dim=0) + 1e-8
        new['log_pi0'] = torch.log(pi0 / torch.sum(pi0))

        if not self.recurrent:
            counts = torch.sum(xi_sums, dim=0)
            if self.transitions == 'sticky':
                counts = counts + self.kappa * torch.eye(K, device=dev)
            counts = counts + 1e-8
            new['log_Ps'] = torch.log(counts / torch.sum(counts, dim=1, keepdim=True))

        # weighted least squares; frames without a full lag history weigh 0
        w = gammas * mask[:, :, None]
        if self.robust:
            w = w * tau
        ones = torch.ones(x.shape[:2] + (1,), device=dev)
        if lags > 0:
            w = w * (torch.arange(x.shape[1], device=dev) >= lags)[None, :, None]
            Xd = torch.cat([_lagged(x, lags), ones], dim=2)
        else:
            Xd = ones
        N, T, Pdim = Xd.shape
        Xf, Yf, Wf = Xd.reshape(-1, Pdim), x.reshape(-1, D), w.reshape(-1, K)

        XtWX = torch.einsum('np,nk,nq->kpq', Xf, Wf, Xf)
        XtWY = torch.einsum('np,nk,nd->kpd', Xf, Wf, Yf)
        # Jacobi equilibration, then a relative 1e-5 ridge: SPD, so the
        # pivot-free unrolled solve is safe
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(XtWX, dim1=1, dim2=2), min=1e-8))
        A = XtWX * s[:, :, None] * s[:, None, :] + 1e-5 * torch.eye(Pdim, device=dev)[None]
        beta = s[:, :, None] * solve_small(A, XtWY * s[:, :, None])   # (K, P, D)
        if lags > 0:
            new['As'] = beta[:, :-1, :].transpose(1, 2).contiguous()
        new['bs'] = beta[:, -1, :].contiguous()

        resid = Yf[:, None, :] - torch.einsum('np,kpd->nkd', Xf, beta)   # (N T, K, D)
        wsum = torch.sum(Wf, dim=0)   # tau included, as the JAX package's code has it
        if self.diagonal:
            var = torch.sum(Wf[:, :, None] * resid ** 2, dim=0) / \
                torch.clamp(wsum[:, None], min=1e-8) + 1e-6
            new['Sigmas'] = torch.diag_embed(var)
        else:
            # sum_n W_nk r_nk r_nk^T as a (D, D) product per state and trial,
            # then the sum over trials: as one contraction over all N T
            # frames per state it is a GEMM with a 100k-long reduction and
            # one output tile
            R = resid.transpose(0, 1).reshape(K * N, T, D)
            RW = (resid * Wf[:, :, None]).transpose(0, 1).reshape(K * N, T, D)
            Sig = torch.bmm(RW.transpose(1, 2), R).reshape(K, N, D, D).sum(dim=1) / \
                torch.clamp(wsum[:, None, None], min=1e-8)
            # symmetrize, plus a scale-relative jitter that keeps the next
            # E-step's Cholesky positive definite
            Sig = 0.5 * (Sig + Sig.transpose(1, 2))
            jit = 1e-6 * (1.0 + torch.diagonal(Sig, dim1=1, dim2=2).amax(dim=1))
            new['Sigmas'] = Sig + jit[:, None, None] * torch.eye(D, device=dev)[None]

        if self.robust:
            new['nus'] = self._m_step_nu(params, mask, gammas, tau)
        return new

    def _m_step_nu(self, params, mask, gammas, taus):
        """Newton steps on the per-state dof (JAX: models/arhmm.py:582): the
        root of log(nu/2) - digamma(nu/2) + c, with c = 1 + E_w[E[log tau]
        - tau] under the old params (every frame weighs its posterior, the
        first ``lags`` frames too), the derivative a forward difference of
        step 1e-3 nu, each step clipped to [1, 200]."""
        D = self.D
        w = gammas * mask[:, :, None]
        wsum = torch.clamp(torch.sum(w, dim=(0, 1)), min=1e-8)
        nus = torch.clamp(params['nus'], min=1e-2)
        e_log_tau = torch.digamma(0.5 * (nus + D)) + torch.log(taus) \
            - torch.log(0.5 * (nus + D))
        c = 1.0 + torch.sum(w * (e_log_tau - taus), dim=(0, 1)) / wsum
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

    def _m_step_recurrent(self, params, x, xis):
        """The recurrent transitions' gradient M-step (JAX:
        models/arhmm.py:641): 25 Adam steps on -sum xis log_P_new over
        ``log_Ps``, ``Rs`` and ``r``, from the per-step pairwise posteriors
        ``xis`` (N, T-1, K, K) under the old params; the gradient by
        autograd, the update ``optax.adam(1e-2)``'s (b1 0.9, b2 0.999, eps
        1e-8, written out: a parameter the objective does not read keeps its
        value, as a zero gradient leaves it in optax). Returns the three
        tensors."""
        keys = ('log_Ps', 'Rs', 'r')
        trans = [params[k].detach().clone() for k in keys]
        mu = [torch.zeros_like(p) for p in trans]
        nu = [torch.zeros_like(p) for p in trans]
        xis = xis.detach()
        b1, b2, eps, lr = 0.9, 0.999, 1e-8, _RECURRENT_ADAM_LR
        for step in range(1, _RECURRENT_ADAM_STEPS + 1):
            leaves = [p.detach().requires_grad_(True) for p in trans]
            with torch.enable_grad():
                loss = -torch.sum(xis * self._log_P(dict(params, **dict(zip(keys, leaves))),
                                                    x))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for i, g in enumerate(grads):
                if g is None:
                    continue
                mu[i] = (1 - b1) * g + b1 * mu[i]
                nu[i] = (1 - b2) * g * g + b2 * nu[i]
                upd = (mu[i] / (1 - b1 ** step)) / (torch.sqrt(nu[i] / (1 - b2 ** step)) + eps)
                trans[i] = trans[i] - lr * upd
        return dict(zip(keys, trans))

    def fit(self, datas, method='em', num_iters=1, initialize=False, tolerance=0.0,
            mesh=None, shard_time=False, iters_per_dispatch=1):
        """Run EM iterations (ssm.HMM.fit API subset); returns the
        log-likelihood before each iteration's M-step, as Python floats.
        ``datas`` is a list of trials or :class:`PaddedTrials` (then
        ``initialize`` is not available). With ``tolerance > 0`` EM stops
        once the relative change of the last two values is below it."""
        if method != 'em':
            raise NotImplementedError('only EM fitting is supported')
        if mesh is not None or shard_time:
            raise NotImplementedError('multi-device EM (mesh, shard_time) is not ported '
                                      'yet (kernel row 19)')
        if int(iters_per_dispatch) > 1:
            raise NotImplementedError('iters_per_dispatch > 1 is not ported yet')
        if initialize:
            if isinstance(datas, PaddedTrials):
                raise ValueError('initialize needs the list of trials, not PaddedTrials')
            self.initialize(datas if isinstance(datas, (list, tuple)) else [datas])
        x, mask = self.pad(datas)
        lls = []
        while len(lls) < num_iters:
            if tolerance > 0 and len(lls) >= 2 and \
                    abs((lls[-1] - lls[-2]) / lls[-1]) < tolerance:
                break
            self.params, ll = self._em_step(self.params, x, mask)
            lls.append(float(ll))
        return lls
