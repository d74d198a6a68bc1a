"""VAE family of the port: ``VAE``, ``BetaTCVAE`` and ``PSVAE`` (JAX:
``behavenet_tpu/models/vaes.py``; reference behavenet/models/vaes.py).

They are conv ``AE``s (``models/aes.py``) with a variational encoder, a
``logvar`` head beside ``FF``, and the JAX package's losses, metric keys and
per-epoch schedules (``loss_kwargs(epoch)``). As in the reference,
``reparameterize`` draws z = mu + eps * exp(logvar): std is exp(logvar), not
exp(logvar / 2) (JAX vaes.py:32-36). Its eps come from a ``torch.Generator``
the caller passes; the trainer keeps one on the device.

The PS-VAE splits the encoder's mean through the fixed orthogonal maps A
(to the supervised latents) and B (the unsupervised ones), drawn from
``rng_seed_model`` exactly as the JAX package draws them; they are buffers
(reference names ``encoding.A.weight``, ``encoding.B.weight``), so they get
no gradient, no L2 and no update. The trainable diagonal map D
(``encoding.D``) predicts the labels from the supervised latents.

The MSPS-VAE, the multi-session PS-VAE, adds a third fixed map C (to the
background latents, reference names ``encoding.C.weight`` and the trainable
``encoding.C.bias``) and a cross-session triplet loss on the background
latents' means, weighted by ``ps_vae.delta``; its batches are
dataset-major concatenations of segments from distinct sessions
(``seg_lens``). Its eps and then its permutations come from the caller's
generator, in that order.

On the card the image and label log-likelihoods run in K5, the KL
decomposition of the beta-TC-VAE, the PS-VAE and the MSPS-VAE in K7, and
the triplet loss in K25 / K26 (``ops/losses.py``). ``ConditionalVAE`` is
not ported yet.
"""

import numpy as np
import torch
import torch.nn as nn

from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.models.aes import AE, r2_score_vw
from behavenet_tpu_torch.ops import conv as ops
from behavenet_tpu_torch.ops import losses

__all__ = ['reparameterize', 'VAE', 'BetaTCVAE', 'PSVAE', 'MSPSVAE']


def reparameterize(mu, logvar, generator=None):
    """Sample z = mu + eps * exp(logvar), eps ~ N(0, 1) drawn from
    ``generator`` on mu's device (JAX: vaes.py:32)."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return eps * torch.exp(logvar) + mu


def _linear_anneal(beta, anneal_epochs, max_n_epochs):
    """Per-epoch (beta, kl) schedules (JAX: vaes.py:53)."""
    if anneal_epochs and anneal_epochs > 0:
        beta_vals = np.append(
            np.linspace(0, beta, anneal_epochs), beta * np.ones(max_n_epochs + 1))
        kl_vals = np.append(np.linspace(0, 1, anneal_epochs), np.ones(max_n_epochs + 1))
    else:
        beta_vals = beta * np.ones(max_n_epochs + 1)
        kl_vals = np.ones(max_n_epochs + 1)
    return beta_vals, kl_vals


def _f32(v):
    """A schedule value as the JAX package passes it (``jnp.float32``)."""
    return float(np.float32(v))


def _data_mse(loss_ll, x):
    """The MSE a unit-std Gaussian log-likelihood of frames ``x`` stands for."""
    n_dims = x[0].numel()
    return -(loss_ll + (0.5 * losses.LN2PI) * n_dims) * 2.0 / n_dims


def _detached(metrics):
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


class FixedLinear(nn.Module):
    """A fixed linear map, weight (out, in) kept as a buffer; with ``bias``
    a trainable bias (out,) (the MSPS-VAE's C)."""

    def __init__(self, weight, bias=False):
        super().__init__()
        self.register_buffer('weight', torch.as_tensor(weight, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(self.weight.shape[0])) if bias else None

    def forward(self, x):
        return ops.linear(x, self.weight.t(), self.bias)


class DiagLinear(nn.Module):
    """y = x * weight + bias, weight and bias (dim,) (reference DiagLinear)."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return base.diag_linear(x, self.weight, self.bias)


class VAE(AE):
    """beta-VAE with optional linear beta annealing (JAX: vaes.py:66)."""

    model_class = 'vae'
    variational = True
    metrics_keys = ['loss', 'loss_ll', 'loss_kl', 'loss_mse', 'beta']

    def __init__(self, hparams):
        super().__init__(dict(hparams, variational=True))
        anneal_epochs = self.hparams.get('vae.beta_anneal_epochs', 0) or 0
        max_n_epochs = self.hparams.get('max_n_epochs', 200)
        if anneal_epochs > 0:
            # as the reference (vaes.py:96-98): 0 -> beta, then **1.0** after
            self.beta_vals = np.append(
                np.linspace(0, hparams['vae.beta'], anneal_epochs), np.ones(max_n_epochs + 1))
        else:
            self.beta_vals = hparams['vae.beta'] * np.ones(max_n_epochs + 1)

    def loss_kwargs(self, epoch):
        return {'beta': _f32(self.beta_vals[epoch])}

    def forward(self, x, use_mean=False, generator=None, act_grad_in_loss=False):
        """(reconstruction, z, mu, logvar); z is mu with ``use_mean``, else a
        sample drawn with ``generator``."""
        mu, logvar, pool_idx = self.encoding(x)
        z = mu if use_mean else reparameterize(mu, logvar, generator)
        return self.decoding(z, pool_idx, act_grad_in_loss=act_grad_in_loss), z, mu, logvar

    def encode(self, x):
        """(mu, logvar) of the variational encoder."""
        return self.encoding(x)[:2]

    def latents(self, x):
        return self.encoding(x)[0]

    def reconstruct(self, x):
        return self(x, use_mean=True)[0]

    def loss_fn(self, batch, generator=None, beta=1.0):
        """Negative ELBO of a batch (JAX: vaes.py:104 loss_fn); ``batch`` as
        for ``AE.loss_fn``. Returns (loss, detached metrics)."""
        x = batch['images']
        fm = batch.get('frame_mask')
        x_hat, _, mu, logvar = self(x, generator=generator, act_grad_in_loss=True)
        loss_ll = losses.gaussian_ll(x_hat, x, batch.get('masks'), frame_mask=fm,
                                     sigmoid_output=True)
        loss_kl = losses.kl_div_to_std_normal(mu, logvar, frame_mask=fm)
        loss = -loss_ll + beta * loss_kl
        return loss, _detached({'loss': loss, 'loss_ll': loss_ll, 'loss_kl': loss_kl,
                                'loss_mse': _data_mse(loss_ll, x), 'beta': beta})


class BetaTCVAE(VAE):
    """VAE with the decomposed KL and an up-weighted total correlation (JAX:
    vaes.py:167)."""

    model_class = 'beta-tcvae'
    metrics_keys = ['loss', 'loss_ll', 'loss_mi', 'loss_tc', 'loss_dwkl', 'loss_mse', 'beta']

    def __init__(self, hparams):
        super().__init__(dict(hparams, **{'vae.beta': 1}))
        anneal_epochs = self.hparams.get('beta_tcvae.beta_anneal_epochs', 0) or 0
        self.beta_vals, self.kl_anneal_vals = _linear_anneal(
            hparams['beta_tcvae.beta'], anneal_epochs, self.hparams.get('max_n_epochs', 200))

    def loss_kwargs(self, epoch):
        return {'beta': _f32(self.beta_vals[epoch]), 'kl': _f32(self.kl_anneal_vals[epoch])}

    def loss_fn(self, batch, generator=None, beta=1.0, kl=1.0):
        x = batch['images']
        fm = batch.get('frame_mask')
        x_hat, sample, mu, logvar = self(x, generator=generator, act_grad_in_loss=True)
        loss_ll = losses.gaussian_ll(x_hat, x, batch.get('masks'), frame_mask=fm,
                                     sigmoid_output=True)
        mi, tc, dwkl = losses.decomposed_kl(sample, mu, logvar, frame_mask=fm)
        loss = -loss_ll + kl * mi + beta * tc + kl * dwkl
        return loss, _detached({
            'loss': loss, 'loss_ll': loss_ll, 'loss_mi': mi, 'loss_tc': tc,
            'loss_dwkl': dwkl, 'loss_mse': _data_mse(loss_ll, x), 'beta': beta})


class PSVAE(AE):
    """Partitioned-subspace VAE (JAX: vaes.py:213; Whiteway et al 2021)."""

    model_class = 'ps-vae'
    variational = True
    metrics_keys = ['loss', 'loss_data_ll', 'loss_label_ll', 'loss_zs_kl', 'loss_zu_mi',
                    'loss_zu_tc', 'loss_zu_dwkl', 'loss_data_mse', 'alpha', 'beta',
                    'label_r2']

    def __init__(self, hparams):
        if hparams['n_ae_latents'] < hparams['n_labels']:
            raise ValueError('PS-VAE model must contain at least as many latents as labels')
        super().__init__(dict(hparams, variational=True))
        self.n_latents = int(self.hparams['n_ae_latents'])
        self.n_labels = int(self.hparams['n_labels'])
        anneal_epochs = self.hparams.get('ps_vae.anneal_epochs', 0) or 0
        self.beta_vals, self.kl_anneal_vals = _linear_anneal(
            hparams['ps_vae.beta'], anneal_epochs, self.hparams.get('max_n_epochs', 200))

    def _build(self):
        super()._build()
        n_labels = int(self.hparams['n_labels'])
        m = base.orthogonal_matrix(int(self.hparams['n_ae_latents']),
                                   self.hparams.get('rng_seed_model', 0))
        # weight = the JAX package's input-major A (resp. B), transposed
        self.encoding.A = FixedLinear(m[:n_labels])
        self.encoding.B = FixedLinear(m[n_labels:])
        self.encoding.D = DiagLinear(n_labels)

    def _init_params(self, gen):
        super()._init_params(gen)
        base.init_diag_linear(self.encoding.D.weight, self.encoding.D.bias, gen)

    def loss_kwargs(self, epoch):
        return {'beta': _f32(self.beta_vals[epoch]), 'kl': _f32(self.kl_anneal_vals[epoch]),
                'alpha': _f32(self.hparams['ps_vae.alpha'])}

    def encode(self, x):
        """(y, w, logvar, pool_idx): the supervised and unsupervised means,
        the log-variances of all latents and the encoder's pool indices."""
        mu_ff, logvar, pool_idx = self.encoding(x)
        return self.encoding.A(mu_ff), self.encoding.B(mu_ff), logvar, pool_idx

    def forward(self, x, use_mean=False, generator=None, act_grad_in_loss=False):
        """(reconstruction, z, mu = [y, w], logvar, predicted labels)."""
        y, w, logvar, pool_idx = self.encode(x)
        mu = torch.cat([y, w], dim=1)
        z = mu if use_mean else reparameterize(mu, logvar, generator)
        x_hat = self.decoding(z, pool_idx, act_grad_in_loss=act_grad_in_loss)
        return x_hat, z, mu, logvar, self.encoding.D(y)

    def latents(self, x):
        return torch.cat(self.encode(x)[:2], dim=1)

    def reconstruct(self, x):
        return self(x, use_mean=True)[0]

    def loss_fn(self, batch, generator=None, beta=1.0, kl=1.0, alpha=None):
        """JAX: vaes.py:294 loss_fn. ``batch`` adds ``labels`` (N, n_labels)
        float32 and optional ``labels_masks`` to ``AE.loss_fn``'s."""
        x, labels = batch['images'], batch['labels']
        n, fm = batch.get('labels_masks'), batch.get('frame_mask')
        k = self.n_labels
        if alpha is None:
            alpha = self.hparams['ps_vae.alpha']
        x_hat, sample, mu, logvar, y_hat = self(x, generator=generator,
                                                act_grad_in_loss=True)
        loss_data_ll = losses.gaussian_ll(x_hat, x, batch.get('masks'), frame_mask=fm,
                                          sigmoid_output=True)
        loss_label_ll = losses.gaussian_ll(y_hat, labels, n, frame_mask=fm)
        loss_zs_kl = losses.kl_div_to_std_normal(mu[:, :k], logvar[:, :k], frame_mask=fm)
        mi, tc, dwkl = losses.decomposed_kl(sample[:, k:], mu[:, k:], logvar[:, k:],
                                            frame_mask=fm)
        loss = -loss_data_ll - alpha * loss_label_ll + loss_zs_kl \
            + kl * mi + beta * tc + kl * dwkl
        if n is not None and fm is not None:
            weights = n * fm[:, None]
        else:
            weights = n if n is not None else fm
        return loss, _detached({
            'loss': loss, 'loss_data_ll': loss_data_ll, 'loss_label_ll': loss_label_ll,
            'loss_zs_kl': loss_zs_kl, 'loss_zu_mi': mi, 'loss_zu_tc': tc,
            'loss_zu_dwkl': dwkl, 'loss_data_mse': _data_mse(loss_data_ll, x),
            'alpha': _f32(alpha), 'beta': beta,
            'label_r2': r2_score_vw(labels, y_hat.detach(), weights=weights)})

    def _inputs(self, inputs):
        return torch.as_tensor(inputs, device=self.encoding.D.weight.device)

    def get_predicted_labels(self, x, use_mean=True, generator=None):
        """Labels predicted from frames ``x`` (JAX: vaes.py:336): D of the
        supervised means, or of a sample drawn with ``generator``."""
        y, _, logvar, _ = self.encode(self._inputs(x))
        if not use_mean:
            y = reparameterize(y, logvar[:, :self.n_labels], generator)
        return self.encoding.D(y)

    def get_transformed_latents(self, inputs):
        """[D(y), w] from latents (N, n_latents) or frames (N, H, W, C) (JAX:
        vaes.py:342; reference vaes.py:755)."""
        inputs = self._inputs(inputs)
        if inputs.dim() == 2:
            y, w = inputs[:, :self.n_labels], inputs[:, self.n_labels:]
        else:
            y, w = self.encode(inputs)[:2]
        return torch.cat([self.encoding.D(y), w], dim=1)

    def get_inverse_transformed_latents(self, inputs):
        """Label space mapped back to the supervised latents: [(y - b) / d, w]
        (JAX: vaes.py:353; reference vaes.py:801)."""
        inputs = self._inputs(inputs)
        y, w = inputs[:, :self.n_labels], inputs[:, self.n_labels:]
        D = self.encoding.D
        return torch.cat([(y - D.bias) / D.weight, w], dim=1)


class MSPSVAE(PSVAE):
    """Multi-session PS-VAE with a background subspace (JAX: vaes.py:363;
    reference vaes.py:849-1273)."""

    model_class = 'msps-vae'
    metrics_keys = ['loss', 'loss_data_ll', 'loss_label_ll', 'loss_zs_kl', 'loss_zu_mi',
                    'loss_zu_tc', 'loss_zu_dwkl', 'loss_triplet', 'loss_data_mse',
                    'alpha', 'beta', 'delta', 'label_r2']

    def __init__(self, hparams):
        if hparams.get('n_sessions_per_batch', 1) == 1:
            raise ValueError('must choose "n_sessions_per_batch" > 1 in hparams')
        super().__init__(dict(hparams, n_background=int(hparams.get('n_background', 4))))
        self.n_background = int(self.hparams['n_background'])

    def _build(self):
        AE._build(self)
        k, n_bg = int(self.hparams['n_labels']), int(self.hparams['n_background'])
        m = base.orthogonal_matrix(int(self.hparams['n_ae_latents']),
                                   self.hparams.get('rng_seed_model', 0))
        # as the JAX init draws them: A = rows [:k], C = the next n_bg, B the rest
        self.encoding.A = FixedLinear(m[:k])
        self.encoding.B = FixedLinear(m[k + n_bg:])
        self.encoding.C = FixedLinear(m[k:k + n_bg], bias=True)
        self.encoding.D = DiagLinear(k)

    def _init_params(self, gen):
        super()._init_params(gen)
        # C's bias: uniform with fan-in n_ae_latents (JAX :387)
        base.uniform_fan_in_(self.encoding.C.bias, self.encoding.C.weight.shape[1], gen)

    def loss_kwargs(self, epoch):
        return dict(super().loss_kwargs(epoch), delta=_f32(self.hparams['ps_vae.delta']))

    def encode(self, x):
        """(z_s, z_b, z_u, logvar, pool_idx): the supervised, background and
        unsupervised means, the log-variances of all latents and the
        encoder's pool indices."""
        mu_ff, logvar, pool_idx = self.encoding(x)
        return (self.encoding.A(mu_ff), self.encoding.C(mu_ff), self.encoding.B(mu_ff),
                logvar, pool_idx)

    def forward(self, x, use_mean=False, generator=None, act_grad_in_loss=False):
        """(reconstruction, z, mu = [z_s, z_b, z_u], logvar, predicted labels)."""
        z_s, z_b, z_u, logvar, pool_idx = self.encode(x)
        mu = torch.cat([z_s, z_b, z_u], dim=1)
        z = mu if use_mean else reparameterize(mu, logvar, generator)
        x_hat = self.decoding(z, pool_idx, act_grad_in_loss=act_grad_in_loss)
        return x_hat, z, mu, logvar, self.encoding.D(z_s)

    def latents(self, x):
        return torch.cat(self.encode(x)[:3], dim=1)

    def loss_fn(self, batch, generator=None, beta=1.0, kl=1.0, alpha=None, delta=None,
                seg_lens=None):
        """JAX: vaes.py:424 loss_fn. ``batch`` as for ``PSVAE.loss_fn``, a
        dataset-major concatenation of per-session segments of ``seg_lens``
        (padded) rows; without ``seg_lens`` the batch is one session and the
        triplet term is 0 (reference vaes.py:1039-1042). ``generator`` draws
        the eps, then one permutation per session for the triplet term."""
        x, labels = batch['images'], batch['labels']
        n, fm = batch.get('labels_masks'), batch.get('frame_mask')
        k, k_bg = self.n_labels, self.n_labels + self.n_background
        if alpha is None:
            alpha = self.hparams['ps_vae.alpha']
        if delta is None:
            delta = self.hparams['ps_vae.delta']
        x_hat, sample, mu, logvar, y_hat = self(x, generator=generator,
                                                act_grad_in_loss=True)
        loss_data_ll = losses.gaussian_ll(x_hat, x, batch.get('masks'), frame_mask=fm,
                                          sigmoid_output=True)
        loss_label_ll = losses.gaussian_ll(y_hat, labels, n, frame_mask=fm)
        loss_zs_kl = losses.kl_div_to_std_normal(mu[:, :k], logvar[:, :k], frame_mask=fm)
        mi, tc, dwkl = losses.decomposed_kl(sample[:, k_bg:], mu[:, k_bg:], logvar[:, k_bg:],
                                            frame_mask=fm)
        loss = -loss_data_ll - alpha * loss_label_ll + loss_zs_kl \
            + kl * mi + beta * tc + kl * dwkl
        if seg_lens is not None:
            loss_triplet = losses.triplet_loss(mu[:, k:k_bg], seg_lens, seg_mask=fm,
                                               generator=generator)
            loss = loss + delta * loss_triplet
        else:
            loss_triplet = 0.0
        if n is not None and fm is not None:
            weights = n * fm[:, None]
        else:
            weights = n if n is not None else fm
        return loss, _detached({
            'loss': loss, 'loss_data_ll': loss_data_ll, 'loss_label_ll': loss_label_ll,
            'loss_zs_kl': loss_zs_kl, 'loss_zu_mi': mi, 'loss_zu_tc': tc,
            'loss_zu_dwkl': dwkl, 'loss_triplet': loss_triplet,
            'loss_data_mse': _data_mse(loss_data_ll, x), 'alpha': _f32(alpha),
            'beta': beta, 'delta': _f32(delta),
            'label_r2': r2_score_vw(labels, y_hat.detach(), weights=weights)})

    def get_predicted_labels(self, x, use_mean=True, generator=None):
        """JAX: vaes.py:489 (the MSPS encoder's 4-tuple)."""
        z_s, _, _, logvar, _ = self.encode(self._inputs(x))
        if not use_mean:
            z_s = reparameterize(z_s, logvar[:, :self.n_labels], generator)
        return self.encoding.D(z_s)

    def _split(self, inputs):
        k, k_bg = self.n_labels, self.n_labels + self.n_background
        return inputs[:, :k], inputs[:, k:k_bg], inputs[:, k_bg:]

    def get_transformed_latents(self, inputs):
        """[D(z_s), z_b, z_u] from latents or frames (JAX: vaes.py:498)."""
        inputs = self._inputs(inputs)
        z_s, z_b, z_u = self._split(inputs) if inputs.dim() == 2 else self.encode(inputs)[:3]
        return torch.cat([self.encoding.D(z_s), z_b, z_u], dim=1)

    def get_inverse_transformed_latents(self, inputs):
        """[(z_s - b) / d, z_b, z_u] (JAX: vaes.py:510)."""
        z_s, z_b, z_u = self._split(self._inputs(inputs))
        D = self.encoding.D
        return torch.cat([(z_s - D.bias) / D.weight, z_b, z_u], dim=1)
