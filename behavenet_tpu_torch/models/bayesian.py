"""Bayesian decoder: fuse ARHMM dynamics with neural-decoder outputs (the
port of ``behavenet_tpu/models/bayesian.py``).

A switching linear dynamical system whose discrete dynamics and per-state
AR parameters come from a fitted :class:`~behavenet_tpu_torch.models.arhmm
.ARHMM`, observed through two neural decoders: the neural->latent decoder's
predictions ``y_t`` are noisy measurements of the latents ``x_t`` with
covariance R (estimated from decoder residuals on training trials), and the
neural->state decoder's probabilities ``q_t(k)`` enter the discrete chain
as extra log-likelihood terms. AR(L) dynamics run in companion form: the
state s_t = [x_t, x_{t-1}, ..., x_{t-L+1}] with block-shift dynamics,
observed through H = [I 0 ... 0].

``decode`` takes the discrete posterior gamma and the Viterbi path from the
port's HMM ops (K9 and K10 on the card; K13 and K14 when the decode or the
ARHMM asks for ``parallel``), then the IMM-collapsed filter (K17) and the
RTS smoother (K18) of ``ops.imm`` on the companion state, or with
``parallel=True`` the associative Kalman filter and smoother of
``ops.kalman`` (K19, K20) over the gamma-weighted dynamics. With ``mesh``
(a :class:`~behavenet_tpu_torch.parallel.Mesh`) the trial's time axis is
sharded over the mesh's devices: the discrete pass runs
``parallel.seq``'s ``sp_forward_backward`` and ``sp_viterbi`` (K32-K35 on
the card), the continuous one its time-sharded Kalman filter and smoother
(K36-K39). Everything runs in float32, on the ARHMM's device or the
mesh's: a float64 ARHMM raises (ROADMAP item A1c).
"""

import numpy as np
import torch

from behavenet_tpu_torch.ops import hmm as hmm_ops
from behavenet_tpu_torch.ops import imm, kalman
from behavenet_tpu_torch.parallel import Mesh, seq

__all__ = ['BayesianDecoder']


class BayesianDecoder:
    """Fuses an ARHMM prior with neural decoder outputs (any AR lag order);
    the JAX package's ``BayesianDecoder`` API, on the ARHMM's device."""

    model_class = 'bayesian-decoding'

    def __init__(self, arhmm, obs_noise=None, state_evidence_weight=1.0):
        """
        Parameters
        ----------
        arhmm : behavenet_tpu_torch.models.arhmm.ARHMM
            fitted segmentation model providing transitions + AR dynamics
        obs_noise : (D, D) array, optional
            observation covariance R of the neural latent predictions; if
            None, call :meth:`estimate_obs_noise` before decoding
        state_evidence_weight : float
            weight on the neural state-decoder log-probabilities
        """
        if arhmm.dtype == 'float64':
            raise NotImplementedError(
                'the Bayesian decoder on a float64 ARHMM is not ported yet: it needs the IMM '
                'filter and the Kalman kernels (K17-K22) in float64, the rest of ROADMAP item '
                'A1c')
        self.arhmm = arhmm
        self.K = arhmm.K
        self.D = arhmm.D
        self.lags = max(int(arhmm.lags), 1)  # lags=0 -> random walk form, L=1
        self.n = self.D * self.lags          # augmented state dim
        self.state_evidence_weight = float(state_evidence_weight)
        self.R = None if obs_noise is None else self._tensor(obs_noise)

    @property
    def device(self):
        return self.arhmm.device

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- setup
    def estimate_obs_noise(self, ae_latents, ae_predictions):
        """Estimate R from decoder residuals on training trials.

        Parameters are lists of (T, D) arrays; NaN rows (lag-trimmed borders
        of prediction exports) are ignored.
        """
        resids = []
        for z, y in zip(ae_latents, ae_predictions):
            z = np.asarray(z, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64)
            good = ~np.any(np.isnan(y), axis=1) & ~np.any(np.isnan(z), axis=1)
            resids.append((y - z)[good])
        r = np.vstack(resids)
        R = np.cov(r.T) + 1e-6 * np.eye(self.D)
        self.R = self._tensor(np.atleast_2d(R))
        return self.R

    @property
    def _H(self):
        """(D, n) observation matrix picking x_t out of the companion state."""
        return torch.eye(self.D, self.n, device=self.device)

    def _ar_weights(self):
        """(K, D, D*L) AR weight blocks [A_1 ... A_L] (zeros for lags=0)."""
        if self.arhmm.lags == 0:
            return torch.zeros((self.K, self.D, self.n), device=self.device)
        return self.arhmm.params['As']

    def _aug_dynamics(self):
        """Companion-form per-state dynamics (A (K,n,n), b (K,n), Q (K,n,n))."""
        p = self.arhmm.params
        D, L, K, n = self.D, self.lags, self.K, self.n
        dev = self.device
        shift = torch.zeros((n - D, n), device=dev)
        if L > 1:
            shift[:, :n - D] = torch.eye(n - D, device=dev)
        As = torch.cat([self._ar_weights(), shift[None].expand(K, n - D, n)], dim=1)
        bs = torch.cat([p['bs'], torch.zeros((K, n - D), device=dev)], dim=1)
        Qs = torch.zeros((K, n, n), device=dev) + 1e-6 * torch.eye(n, device=dev)[None]
        Qs[:, :D, :D] += p['Sigmas']
        return As, bs, Qs

    # ----------------------------------------------------------- decoding
    def states_posterior(self, ae_predictions=None, arhmm_predictions=None):
        """Discrete posterior gamma (T, K) from transitions + neural evidence."""
        ll = self._discrete_loglik(ae_predictions, arhmm_predictions)
        log_P = torch.log_softmax(self.arhmm.params['log_Ps'], dim=1)
        gamma, _, _ = hmm_ops.forward_backward(self.arhmm.params['log_pi0'], log_P, ll[None])
        return gamma[0].cpu().numpy()

    def _discrete_loglik(self, ae_predictions, arhmm_predictions):
        terms = []
        if arhmm_predictions is not None:
            q = self._tensor(arhmm_predictions)
            # NaN rows (lag-trimmed borders of prediction exports) carry no
            # evidence: log 1 = 0
            q = torch.where(torch.isnan(q), 1.0, q)
            terms.append(self.state_evidence_weight * torch.log(torch.clamp(q, min=1e-6)))
        if ae_predictions is not None:
            # continuous evidence enters the discrete chain through the
            # per-state one-step predictive likelihood of y_t under
            # (A_k, b_k, Q_k + R), with the AR history read from y itself
            p = self.arhmm.params
            y = self._tensor(ae_predictions)
            D = self.D
            eye = torch.eye(D, device=self.device)
            covs = p['Sigmas'] + self.R[None]
            chol = torch.linalg.cholesky_ex(covs + 1e-6 * eye[None]).L
            Linv = torch.linalg.solve_triangular(chol, eye.expand(self.K, D, D), upper=False)
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
            if self.arhmm.lags == 0:
                mus = p['bs'][None].expand(y.shape[0], self.K, D)
            else:
                # lagged history with the first rows clamped to y[0]
                feats = torch.cat([torch.cat([y[:1].repeat(lag, 1), y[:-lag]], dim=0)
                                   for lag in range(1, self.lags + 1)], dim=1)   # (T, D*L)
                mus = torch.einsum('kdp,tp->tkd', self._ar_weights(), feats) + p['bs'][None]
            diff = y[:, None, :] - mus
            sol = torch.einsum('kde,tke->tkd', Linv, diff)
            maha = torch.sum(sol ** 2, dim=2)
            terms.append(-0.5 * (D * np.log(2 * np.pi) + logdet[None] + maha))
        if not terms:
            raise ValueError('need at least one of ae_predictions / arhmm_predictions')
        return sum(terms)

    def decode(self, ae_predictions, arhmm_predictions=None, smooth=True,
               parallel=False, mesh=None, as_numpy=True):
        """Decode latents + states from neural predictions for one trial.

        Parameters
        ----------
        ae_predictions : (T, D)
            neural->latent decoder output (NaN border rows are filled by
            the prior dynamics)
        arhmm_predictions : (T, K), optional
            neural->state decoder probabilities
        smooth : bool
            run the backward pass (K18, or with ``parallel`` K20)
        parallel : bool
            the associative Kalman filter and smoother (``ops.kalman``, K19
            and K20) over the gamma-weighted soft dynamics instead of the
            sequential IMM filter, and the parallel-prefix discrete pass
            (K13, K14); preferred for very long trials. It omits the IMM
            mixture-spread covariance term (negligible when the state
            posterior is concentrated)
        mesh : behavenet_tpu_torch.parallel.Mesh, optional
            a 1-D mesh (any axis name): shard the trial's time axis over
            its devices; every message pass (forward-backward, Viterbi,
            the Kalman filter and smoother) runs time-sharded through
            ``parallel.seq``. Implies ``parallel=True``
        as_numpy : bool
            fetch results to host numpy arrays (default); False keeps them
            as tensors on the ARHMM's device (with ``mesh``, the mesh's
            first device)

        Returns
        -------
        dict with 'latents' (T, D), 'latents_cov' (T, D, D), 'states'
        (T,), 'states_posterior' (T, K)
        """
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError('mesh must be a behavenet_tpu_torch.parallel.Mesh, got %r'
                                % (mesh,))
            parallel = True
        if self.R is None:
            raise RuntimeError('call estimate_obs_noise() or pass obs_noise first')
        y = np.asarray(ae_predictions, dtype=np.float32)
        obs_mask = (~np.any(np.isnan(y), axis=1)).astype(np.float32)
        y = self._tensor(np.nan_to_num(y))
        m = self._tensor(obs_mask)

        # discrete pass over every frame: a row without an observation
        # carries no evidence (its log-likelihood is zeroed), and the HMM
        # ops see no mask, as in the JAX package
        p = self.arhmm.params
        q = None if arhmm_predictions is None else self._tensor(arhmm_predictions)
        ll = self._discrete_loglik(torch.where(m[:, None] > 0, y, 0.0), q) * m[:, None]
        log_P = torch.log_softmax(p['log_Ps'], dim=1)
        if mesh is not None:
            axis = mesh.axis_names[0]
            gamma = seq.sp_forward_backward(p['log_pi0'], log_P, ll, mesh=mesh,
                                            axis_name=axis)[0]
            states = seq.sp_viterbi(p['log_pi0'], log_P, ll, mesh=mesh, axis_name=axis)
        else:
            par_scan = bool(parallel or self.arhmm.parallel_scan)
            gamma = hmm_ops.forward_backward(p['log_pi0'], log_P, ll[None],
                                             parallel=par_scan)[0][0]
            states = hmm_ops.viterbi(p['log_pi0'], log_P, ll[None], parallel=par_scan)[0]

        if parallel:
            mus_s, Sigmas_s = self._soft_kalman_parallel(y, m, gamma.to(self.device), smooth,
                                                         mesh)
        else:
            mus_s, Sigmas_s, mus_p, Sigmas_p = self._kalman_filter(y, m, gamma)
            if smooth:
                mus_s, Sigmas_s = self._rts_smoother(mus_s, Sigmas_s, mus_p, Sigmas_p, gamma)

        D = self.D
        out = {
            'latents': mus_s[:, :D],
            'latents_cov': Sigmas_s[:, :D, :D],
            'states': states,
            'states_posterior': gamma,
        }
        if as_numpy:
            out = {k: np.ascontiguousarray(v.cpu().numpy()) for k, v in out.items()}
        return out

    def _init_moments(self, y, gamma):
        """Prior moments of the augmented state at t=0."""
        I_L = torch.eye(self.lags, device=self.device)
        mu0 = y[0].repeat(self.lags)                            # (n,)
        Sigma0 = torch.kron(I_L, self.R) + torch.kron(
            I_L, torch.einsum('k,kde->de', gamma[0], self.arhmm.params['Sigmas']))
        return mu0, Sigma0

    def _kalman_filter(self, y, obs_mask, gamma):
        """Soft-weighted (IMM-collapsed) Kalman filter on the companion state:
        (mus_f, Sigmas_f, mus_p, Sigmas_p), K17 on the card."""
        As, bs, Qs = self._aug_dynamics()
        mu0, Sigma0 = self._init_moments(y, gamma)
        return imm.imm_filter(y, obs_mask, gamma, As, bs, Qs, self.R, mu0, Sigma0)

    def _rts_smoother(self, mus_f, Sigmas_f, mus_p, Sigmas_p, gamma):
        """RTS backward pass with the soft-mixture dynamics matrix: (mus_s,
        Sigmas_s), K18 on the card."""
        As = self._aug_dynamics()[0]
        return imm.rts_smoother(mus_f, Sigmas_f, mus_p, Sigmas_p, gamma, As)

    def _soft_dynamics(self, y, gamma):
        """The gamma-weighted time-varying LDS of :meth:`_soft_kalman_parallel`:
        (F (T, n, n), c (T, n), Q (T, n, n), mu0, Sigma0), element 0 carrying
        the prior straight through (F0 = I, c0 = 0, Q0 = 1e-6 I)."""
        As, bs, Qs = self._aug_dynamics()
        F = torch.einsum('tk,kde->tde', gamma, As)
        c = torch.einsum('tk,kd->td', gamma, bs)
        Q = torch.einsum('tk,kde->tde', gamma, Qs)
        mu0, Sigma0 = self._init_moments(y, gamma)
        eye = torch.eye(self.n, device=self.device)
        F[0] = eye
        c[0] = 0.0
        Q[0] = 1e-6 * eye
        return F, c, Q, mu0, Sigma0

    def _soft_kalman_parallel(self, y, obs_mask, gamma, smooth, mesh=None):
        """The gamma-weighted time-varying LDS solved with associative scans
        (JAX: models/bayesian.py:365): (mus, Sigmas), K19 and K20 on the
        card; with ``mesh`` time-sharded (K36-K39 on the card), the
        filtered moments kept on their shards for the smoother, the result
        on the mesh's first device."""
        F, c, Q, mu0, Sigma0 = self._soft_dynamics(y, gamma)
        # the plain version's two-level scan above 8192 frames, as JAX's
        # (which chunks to bound its compile time); the kernels chunk by
        # their own length
        chunk = 8192 if y.shape[0] > 8192 else None
        if mesh is not None:
            shards = seq.shard_lds(mesh, F, c, Q, self._H, self.R, y, obs_mask, mu0, Sigma0,
                                   axis_name=mesh.axis_names[0])
            moments = seq.kalman_filter_shards(shards, chunk)
            if smooth:
                moments = seq.kalman_smooth_shards(shards, moments, chunk)
            return seq.joined_frames(moments, mesh.devices[0])
        ms, Ps = kalman.filter_parallel(F, c, Q, self._H, self.R, y, obs_mask, mu0, Sigma0,
                                        chunk=chunk)
        if smooth:
            ms, Ps = kalman.smooth_parallel(F, c, Q, ms, Ps, chunk=chunk)
        return ms, Ps
