"""Losses of the port (``behavenet_tpu/ops/losses.py``): the masked MSE, the
Gaussian log-likelihood built on it, the KL to a standard normal, the
minibatch KL decomposition of the beta-TC-VAE and PS-VAE, the decoders'
full-covariance Gaussian negative log-likelihood and the MSPS-VAE's
cross-session triplet loss.

:func:`mse`, :func:`decomposed_kl`, :func:`gaussian_neg_log_prob` (its
per-frame branch) and :func:`triplet_loss` are ``torch.autograd.Function``s
whose forward and backward run in kernels on a ``cuda`` tensor (K5
``kernels/masked_mse.cu``, K7 ``kernels/decomposed_kl.cu``, K12
``kernels/gaussian_nll.cu``, K25 / K26 ``kernels/triplet.cu``) and in the
plain PyTorch versions beside them on a ``cpu`` tensor, picked from the
input's device and from nothing else.
"""

import ctypes

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import launch
from behavenet_tpu_torch.ops import smallmat

__all__ = ['LN2PI', 'mse', 'mse_plain', 'mse_grad_plain', 'mse_cuda', 'mse_grad_cuda',
           'gaussian_ll', 'kl_div_to_std_normal', 'decomposed_kl', 'decomposed_kl_plain',
           'decomposed_kl_grad_plain', 'decomposed_kl_cuda', 'decomposed_kl_grad_cuda',
           'gaussian_neg_log_prob', 'gaussian_neg_log_prob_plain',
           'gaussian_neg_log_prob_grad_plain', 'gaussian_neg_log_prob_cuda',
           'gaussian_neg_log_prob_grad_cuda', 'triplet_loss', 'triplet_loss_plain',
           'triplet_loss_grad_plain', 'triplet_loss_cuda', 'triplet_loss_grad_cuda']

LN2PI = float(np.log(2 * np.pi))
_PER_BLOCK = 2048  # elements of one frame each block of K5 reduces
_MASKED = -1e30    # log-density of a padded mixture component (JAX :133)
_KL_MAX_D = 64     # widest latent space K7 takes (the arch's max_latents)
_NLL_MAX_D = 16    # widest per-frame covariance K12 takes (JAX unrolls up to it)
_NLL_JITTER = 1e-3  # added to the covariance's diagonal (reference losses.py:17-33)


def _on_cpu(t):
    return t.device.type == 'cpu'


def _target(y_true):
    return y_true.float() / 255.0 if y_true.dtype == torch.uint8 else y_true


def mse_plain(y_pred, y_true, masks=None, frame_mask=None):
    """Masked mean square error (JAX: ops/losses.py:25 mse), plain PyTorch.

    ``y_true`` may be uint8 frames, read as ``y_true / 255``. ``frame_mask``
    (N,) marks real frames in a padded-to-bucket batch: the mean then runs
    over valid frames only. Returns (loss, denominator), the denominator
    being ``max(sum(frame_mask), 1)`` (N without a frame mask).
    """
    d = (y_pred - _target(y_true)) ** 2
    if masks is not None:
        d = d * masks
    per_frame = d.reshape(d.shape[0], -1).mean(dim=1)
    if frame_mask is None:
        frame_mask = torch.ones_like(per_frame)
    den = torch.clamp(frame_mask.sum(), min=1.0)
    return (per_frame * frame_mask).sum() / den, den


def mse_grad_plain(y_pred, y_true, masks, frame_mask, den, grad_loss,
                   sigmoid_output=False):
    """dL/dy_pred of :func:`mse_plain` at upstream gradient ``grad_loss``;
    with ``sigmoid_output``, the gradient of the sigmoid's input (times
    ``y (1 - y)``)."""
    n = y_pred.shape[0]
    scale = 2.0 * grad_loss / (y_pred[0].numel() * den)
    g = (y_pred - _target(y_true)) * scale
    if masks is not None:
        g = g * masks
    if frame_mask is not None:
        g = g * frame_mask.reshape((n,) + (1,) * (y_pred.dim() - 1))
    if sigmoid_output:
        g = g * y_pred * (1 - y_pred)
    return g


def _check(name, y_pred, y_true, masks, frame_mask):
    tensors = [t for t in (y_pred, y_true, masks, frame_mask) if t is not None]
    for t in tensors:
        if t.device != y_pred.device or t.device.type != 'cuda':
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
    if y_pred.dtype != torch.float32 or y_true.dtype not in (torch.float32, torch.uint8):
        raise ValueError('%s: y_pred must be float32 and y_true float32 or uint8'
                         % name)
    if y_true.shape != y_pred.shape or (masks is not None and masks.shape != y_pred.shape):
        raise ValueError('%s: y_true and masks must have y_pred\'s shape %s'
                         % (name, tuple(y_pred.shape)))
    if frame_mask is not None and tuple(frame_mask.shape) != (y_pred.shape[0],):
        raise ValueError('%s: frame_mask must be (%d,)' % (name, y_pred.shape[0]))
    n = y_pred.shape[0]
    f = y_pred.numel() // max(n, 1)
    return n, f, -(-f // _PER_BLOCK)


def _c(t, dtype=torch.float32):
    return None if t is None else t.to(dtype).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def mse_cuda(y_pred, y_true, masks=None, frame_mask=None):
    """K5's forward on the card: (loss, denominator) as :func:`mse_plain`."""
    name = 'masked_mse'
    n, f, chunks = _check(name, y_pred, y_true, masks, frame_mask)
    y_pred, y_true = y_pred.contiguous(), y_true.contiguous()
    masks, frame_mask = _c(masks), _c(frame_mask)
    partial = torch.empty(max(n * chunks, 1), device=y_pred.device, dtype=torch.float32)
    out = torch.empty(2, device=y_pred.device, dtype=torch.float32)
    launch(name, y_pred.data_ptr(), y_true.data_ptr(), int(y_true.dtype == torch.uint8),
           _ptr(masks), _ptr(frame_mask),
           partial.data_ptr(), out.data_ptr(), n, f, chunks, symbol='bn_masked_mse_fwd')
    return out[0], out[1]


def mse_grad_cuda(y_pred, y_true, masks, frame_mask, den, grad_loss,
                  sigmoid_output=False):
    """K5's backward on the card (see :func:`mse_grad_plain`); ``den`` and
    ``grad_loss`` are one-element float32 tensors on the card."""
    name = 'masked_mse'
    n, f, chunks = _check(name, y_pred, y_true, masks, frame_mask)
    y_pred, y_true = y_pred.contiguous(), y_true.contiguous()
    masks, frame_mask = _c(masks), _c(frame_mask)
    den, grad_loss = _c(den), _c(grad_loss)
    grad = torch.empty_like(y_pred)
    if grad.numel():
        launch(name, y_pred.data_ptr(), y_true.data_ptr(),
               int(y_true.dtype == torch.uint8), _ptr(masks), _ptr(frame_mask),
               den.data_ptr(),
               grad_loss.data_ptr(), grad.data_ptr(), n, f, chunks,
               int(sigmoid_output), symbol='bn_masked_mse_bwd')
    return grad


class _MSEFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y_pred, y_true, masks, frame_mask, sigmoid_output):
        fwd = mse_plain if _on_cpu(y_pred) else mse_cuda
        loss, den = fwd(y_pred, y_true, masks, frame_mask)
        ctx.save_for_backward(y_pred, y_true, masks, frame_mask, den)
        ctx.sigmoid_output = sigmoid_output
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        y_pred, y_true, masks, frame_mask, den = ctx.saved_tensors
        bwd = mse_grad_plain if _on_cpu(y_pred) else mse_grad_cuda
        grad = bwd(y_pred, y_true, masks, frame_mask, den, grad_loss,
                   ctx.sigmoid_output)
        return grad, None, None, None, None


def mse(y_pred, y_true, masks=None, frame_mask=None, sigmoid_output=False):
    """Masked mean square error over all elements (JAX: ops/losses.py:25).

    ``frame_mask`` (N,) marks real frames in a padded-to-bucket batch; the
    mean then runs over valid frames only (exactly the value on the unpadded
    batch). ``y_true`` may be uint8 frames, read as ``y_true / 255``; it and
    the masks are data and get no gradient.

    With ``sigmoid_output`` the gradient is returned for the input of the
    sigmoid that produced ``y_pred`` (it is multiplied by ``y (1 - y)``): the
    producing layer must then skip its own sigmoid derivative
    (``conv_transpose2d(..., act_grad_in_loss=True)``).
    """
    if y_pred.device.type not in ('cpu', 'cuda'):
        raise ValueError('mse: no implementation for device %s' % y_pred.device)
    for t in (y_true, masks, frame_mask):
        if t is not None and t.requires_grad:
            raise ValueError('mse: targets and masks are data; they get no gradient')
    return _MSEFn.apply(y_pred, y_true, masks, frame_mask, sigmoid_output)


def gaussian_ll(y_pred, y_true, masks=None, std=1.0, frame_mask=None,
                sigmoid_output=False):
    """Diagonal-Gaussian log-likelihood with a fixed ``std``, summed over the
    dims of a frame and averaged over (valid) frames (JAX: ops/losses.py:42;
    its arguments are (data, mean), symmetric in the two).

    Written as an affine function of :func:`mse`, so its forward and backward
    run in K5 on the card: ``ll = -(ln(2 pi) + ln std^2) n / 2 - n mse /
    (2 std^2)`` with ``n`` the dims of a frame. ``y_pred`` gets the gradient;
    ``y_true`` (uint8 frames or floats), ``masks`` and ``frame_mask`` are as
    in :func:`mse`, and so is ``sigmoid_output``.
    """
    n_dims = y_pred[0].numel()
    log_var = float(np.log(std ** 2))
    err = mse(y_pred, y_true, masks, frame_mask, sigmoid_output=sigmoid_output)
    return -(0.5 * LN2PI + 0.5 * log_var) * n_dims - (0.5 / std ** 2) * n_dims * err


def kl_div_to_std_normal(mu, logvar, frame_mask=None):
    """KL(N(mu, exp(logvar)) || N(0, 1)), summed over dims, averaged over
    (valid) frames (JAX: ops/losses.py:71), in PyTorch ops on (B, <= 64)."""
    kl = 0.5 * torch.sum(torch.exp(logvar) - logvar + mu ** 2 - 1, dim=1)
    if frame_mask is None:
        return kl.mean()
    return (kl * frame_mask).sum() / torch.clamp(frame_mask.sum(), min=1.0)


# ------------------------------------------------------- decomposed KL (K7)


def _log_density(z, mu, logvar):
    """Elementwise diagonal-Gaussian log-density (JAX :79)."""
    return -0.5 * ((z - mu) ** 2 * torch.exp(-logvar) + logvar + LN2PI)


def _kl_weights(frame_mask, n, like):
    """Per-row weights of the batch means: ``fm / max(sum fm, 1)``, or 1/n."""
    if frame_mask is None:
        return torch.full((n,), 1.0 / n, dtype=like.dtype, device=like.device)
    return frame_mask / torch.clamp(frame_mask.sum(), min=1.0)


def _masked_pairwise(z, mu, logvar, frame_mask):
    """(B, B, D) log q(z_j,d | x_i) indexed [j, i, d], padded components i
    set to -1e30 (JAX :130-134)."""
    lq = _log_density(z[:, None], mu[None], logvar[None])
    if frame_mask is not None:
        lq = torch.where(frame_mask[None, :, None] > 0, lq,
                         torch.full_like(lq, _MASKED))
    return lq


def decomposed_kl_plain(z, mu, logvar, frame_mask=None):
    """(MI, TC, dimension-wise KL) of the minibatch KL decomposition (JAX:
    ops/losses.py:120 decomposed_kl), plain PyTorch on the (B, B, D)
    pairwise tensor. Differentiable by autograd."""
    lq = _masked_pairwise(z, mu, logvar, frame_mask)
    log_qz = torch.logsumexp(lq.sum(dim=2), dim=1)
    log_qz_cond = _log_density(z, mu, logvar).sum(dim=1)   # the unmasked diagonal
    log_qz_product = torch.logsumexp(lq, dim=1).sum(dim=1)
    log_pz_product = (-0.5 * (z ** 2 + LN2PI)).sum(dim=1)
    if frame_mask is None:
        def mean(v):
            return v.mean()
    else:
        def mean(v):
            return (v * frame_mask).sum() / torch.clamp(frame_mask.sum(), min=1.0)
    return (mean(log_qz_cond - log_qz), mean(log_qz - log_qz_product),
            mean(log_qz_product - log_pz_product))


def decomposed_kl_grad_plain(z, mu, logvar, frame_mask, grad):
    """Gradients (z, mu, logvar) of :func:`decomposed_kl_plain` at upstream
    gradients ``grad`` = (dMI, dTC, dDWKL), written out as K7's backward
    computes them.

    With w_j the mean's row weights, the rows' terms weigh each pairwise
    log-density l[j, i, d] by G = a_j [i = j] + b_j r[j, i] + c_j q[j, i, d],
    where a = w dMI, b = w (dTC - dMI), c = w (dDWKL - dTC), r is the softmax
    over i of sum_d l and q the softmax over i of l (valid components only).
    """
    w = _kl_weights(frame_mask, z.shape[0], z)
    lq = _masked_pairwise(z, mu, logvar, frame_mask)
    s = lq.sum(dim=2)
    r = torch.exp(s - torch.logsumexp(s, dim=1, keepdim=True))
    q = torch.exp(lq - torch.logsumexp(lq, dim=1, keepdim=True))
    a, b, c = w * grad[0], w * (grad[1] - grad[0]), w * (grad[2] - grad[1])
    g = b[:, None, None] * r[:, :, None] + c[:, None, None] * q \
        + torch.diag(a)[:, :, None]
    diff = z[:, None] - mu[None]
    t = diff * torch.exp(-logvar)[None]           # -dl/dz = dl/dmu
    grad_z = -(g * t).sum(dim=1) + (w * grad[2])[:, None] * z
    grad_mu = (g * t).sum(dim=0)
    grad_logvar = (g * 0.5 * (diff * t - 1.0)).sum(dim=0)
    return grad_z, grad_mu, grad_logvar


def _check_kl(name, z, mu, logvar, frame_mask):
    tensors = [t for t in (z, mu, logvar, frame_mask) if t is not None]
    for t in tensors:
        if t.device != z.device or t.device.type != 'cuda':
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
        if t.dtype != torch.float32:
            raise ValueError('%s: tensors must be float32, got %s' % (name, t.dtype))
    if z.dim() != 2 or mu.shape != z.shape or logvar.shape != z.shape:
        raise ValueError('%s: z, mu and logvar must be one (B, D) shape, got %s %s %s'
                         % (name, tuple(z.shape), tuple(mu.shape), tuple(logvar.shape)))
    n, d = z.shape
    if n < 1 or not 1 <= d <= _KL_MAX_D:
        raise ValueError('%s: takes B >= 1 and 1 <= D <= %d, got (%d, %d)'
                         % (name, _KL_MAX_D, n, d))
    if frame_mask is not None and tuple(frame_mask.shape) != (n,):
        raise ValueError('%s: frame_mask must be (%d,)' % (name, n))
    return n, d


def decomposed_kl_cuda(z, mu, logvar, frame_mask=None):
    """K7's forward on the card. Returns (the (3,) tensor (MI, TC, DWKL), the
    means' denominator (1,), the per-row logsumexp of sum_d l (B,) and the
    per-row, per-dim logsumexps (B, D)); the last three feed the backward."""
    name = 'decomposed_kl'
    n, d = _check_kl(name, z, mu, logvar, frame_mask)
    z, mu, logvar, frame_mask = (_c(t) for t in (z, mu, logvar, frame_mask))
    dev = z.device
    out = torch.empty(3, device=dev, dtype=torch.float32)
    den = torch.empty(1, device=dev, dtype=torch.float32)
    lse_s = torch.empty(n, device=dev, dtype=torch.float32)
    lse_p = torch.empty((n, d), device=dev, dtype=torch.float32)
    rows = torch.empty(3 * n, device=dev, dtype=torch.float32)
    launch(name, z.data_ptr(), mu.data_ptr(), logvar.data_ptr(), _ptr(frame_mask),
           n, d, lse_s.data_ptr(), lse_p.data_ptr(), rows.data_ptr(), out.data_ptr(),
           den.data_ptr(), symbol='bn_decomposed_kl_fwd')
    return out, den, lse_s, lse_p


def decomposed_kl_grad_cuda(z, mu, logvar, frame_mask, den, lse_s, lse_p, grad):
    """K7's backward on the card: (grad z, grad mu, grad logvar) from the
    forward's saved ``den``, ``lse_s``, ``lse_p`` and the upstream (3,)
    ``grad``, all on the card."""
    name = 'decomposed_kl'
    n, d = _check_kl(name, z, mu, logvar, frame_mask)
    z, mu, logvar, frame_mask, grad = (_c(t) for t in (z, mu, logvar, frame_mask, grad))
    if tuple(grad.shape) != (3,) or lse_s.shape != (n,) or lse_p.shape != (n, d):
        raise ValueError('%s: backward takes a (3,) gradient and the forward\'s '
                         'saved tensors' % name)
    grads = [torch.empty_like(z) for _ in range(3)]
    launch(name, z.data_ptr(), mu.data_ptr(), logvar.data_ptr(), _ptr(frame_mask),
           n, d, lse_s.data_ptr(), lse_p.data_ptr(), den.data_ptr(), grad.data_ptr(),
           *(g.data_ptr() for g in grads), symbol='bn_decomposed_kl_bwd')
    return tuple(grads)


class _DecomposedKLFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, mu, logvar, frame_mask):
        if _on_cpu(z):
            out = torch.stack(decomposed_kl_plain(z, mu, logvar, frame_mask))
            ctx.save_for_backward(z, mu, logvar, frame_mask)
        else:
            out, den, lse_s, lse_p = decomposed_kl_cuda(z, mu, logvar, frame_mask)
            ctx.save_for_backward(z, mu, logvar, frame_mask, den, lse_s, lse_p)
        return out

    @staticmethod
    def backward(ctx, grad):
        if _on_cpu(grad):
            z, mu, logvar, frame_mask = ctx.saved_tensors
            grads = decomposed_kl_grad_plain(z, mu, logvar, frame_mask, grad)
        else:
            grads = decomposed_kl_grad_cuda(*ctx.saved_tensors, grad)
        return grads + (None,)


def decomposed_kl(z, mu, logvar, frame_mask=None):
    """Minibatch KL decomposition into (MI, TC, dimension-wise KL) (JAX:
    ops/losses.py:120; Chen et al 2018).

    z, mu, logvar: (B, D) float32 (a sample, and the means and log-variances
    of the B diagonal Gaussians that form the aggregate posterior). With
    ``frame_mask`` (B,), padded rows drop out as mixture components and from
    the batch means, so the result is the value on the unpadded batch; the
    diagonal term log q(z_j | x_j) is taken unmasked, as in JAX. Gradients
    reach z, mu and logvar (K7's backward on the card); the mask is data.
    """
    if z.device.type not in ('cpu', 'cuda'):
        raise ValueError('decomposed_kl: no implementation for device %s' % z.device)
    if frame_mask is not None and frame_mask.requires_grad:
        raise ValueError('decomposed_kl: frame_mask is data; it gets no gradient')
    return tuple(_DecomposedKLFn.apply(z, mu, logvar, frame_mask).unbind(0))


# ------------------------------------------- full-covariance Gaussian NLL (K12)


def _nll_sigma(cov, d, frame_mask):
    """1e-3 I + cov, with a masked frame's covariance replaced by I (JAX
    :173, :181-182)."""
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    sigma = _NLL_JITTER * eye + cov
    if frame_mask is not None and sigma.dim() == 3:
        sigma = torch.where(frame_mask[:, None, None] > 0, sigma, eye)
    return sigma


def _weighted_mean(nll, frame_mask):
    """(sum w nll / max(sum w, 1), the denominator); w = 1 without a mask."""
    w = torch.ones_like(nll) if frame_mask is None else frame_mask
    den = torch.clamp(w.sum(), min=1.0)
    return (nll * w).sum() / den, den


def gaussian_neg_log_prob_plain(y_pred, y_true, cov, frame_mask=None):
    """K12's function in plain PyTorch: the per-frame branch (``cov`` (B, d,
    d), d <= 16) of JAX ops/losses.py:161 through the unrolled
    ``smallmat.cholesky_small`` and ``solve_tril_small``. Returns (loss,
    denominator), the denominator being ``max(sum(frame_mask), 1)`` (B
    without a mask)."""
    d = y_true.shape[1]
    chol = smallmat.cholesky_small(_nll_sigma(cov, d, frame_mask))
    sol = smallmat.solve_tril_small(chol, y_true - y_pred)
    maha = torch.sum(sol ** 2, dim=1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
    return _weighted_mean(0.5 * (d * LN2PI + logdet + maha), frame_mask)


def gaussian_neg_log_prob_grad_plain(y_pred, y_true, cov, frame_mask, den, grad_loss):
    """(dL/dy_pred, dL/dcov) of :func:`gaussian_neg_log_prob_plain` at
    upstream gradient ``grad_loss``, written out as K12 computes them: with
    S = 1e-3 I + cov, a = S^-1 (y_true - y_pred) and scale = grad_loss w /
    den, dL/dy_pred = -scale a and dL/dcov = scale (S^-1 - a a^T) below the
    diagonal, half that on it and 0 above it (JAX's gradient through
    ``cholesky_small``, which reads only the lower triangle); a masked frame
    gets no covariance gradient."""
    B, d = y_true.shape
    chol = smallmat.cholesky_small(_nll_sigma(cov, d, frame_mask))
    x = smallmat.solve_tril_small(chol, y_true - y_pred)
    a = torch.linalg.solve_triangular(chol.transpose(1, 2), x[..., None], upper=True)[..., 0]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device).expand(B, d, d)
    l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    s = l_inv.transpose(1, 2) @ l_inv - a[:, :, None] * a[:, None, :]
    w = torch.ones(B, dtype=cov.dtype, device=cov.device) if frame_mask is None \
        else frame_mask
    scale = grad_loss * w / den
    half_diag = 0.5 * torch.diag_embed(torch.diagonal(s, dim1=1, dim2=2))
    grad_cov = (torch.tril(s, -1) + half_diag) * scale[:, None, None]
    if frame_mask is not None:
        grad_cov = torch.where(frame_mask[:, None, None] > 0, grad_cov,
                               torch.zeros_like(grad_cov))
    return -scale[:, None] * a, grad_cov


def _check_nll(name, y_pred, y_true, cov, frame_mask):
    tensors = [t for t in (y_pred, y_true, cov, frame_mask) if t is not None]
    for t in tensors:
        if t.device != y_pred.device or t.device.type != 'cuda':
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
        if t.dtype != torch.float32:
            raise ValueError('%s: tensors must be float32, got %s' % (name, t.dtype))
    if y_pred.dim() != 2 or y_true.shape != y_pred.shape:
        raise ValueError('%s: y_pred and y_true must be one (B, d) shape, got %s and %s'
                         % (name, tuple(y_pred.shape), tuple(y_true.shape)))
    n, d = y_pred.shape
    if n < 1 or not 1 <= d <= _NLL_MAX_D or tuple(cov.shape) != (n, d, d):
        raise ValueError('%s: takes B >= 1, 1 <= d <= %d and cov (B, d, d), got '
                         'y_pred %s and cov %s' % (name, _NLL_MAX_D, tuple(y_pred.shape),
                                                    tuple(cov.shape)))
    if frame_mask is not None and tuple(frame_mask.shape) != (n,):
        raise ValueError('%s: frame_mask must be (%d,)' % (name, n))
    return n, d


def gaussian_neg_log_prob_cuda(y_pred, y_true, cov, frame_mask=None):
    """K12's forward on the card: (loss, denominator) as
    :func:`gaussian_neg_log_prob_plain`."""
    name = 'gaussian_nll'
    n, d = _check_nll(name, y_pred, y_true, cov, frame_mask)
    y_pred, y_true, cov, frame_mask = (_c(t) for t in (y_pred, y_true, cov, frame_mask))
    wnll = torch.empty(n, device=y_pred.device, dtype=torch.float32)
    out = torch.empty(2, device=y_pred.device, dtype=torch.float32)
    launch(name, y_pred.data_ptr(), y_true.data_ptr(), cov.data_ptr(), _ptr(frame_mask),
           wnll.data_ptr(), out.data_ptr(), n, d, symbol='bn_gaussian_nll_fwd')
    return out[0], out[1]


def gaussian_neg_log_prob_grad_cuda(y_pred, y_true, cov, frame_mask, den, grad_loss):
    """K12's backward on the card: (dL/dy_pred, dL/dcov) as
    :func:`gaussian_neg_log_prob_grad_plain`; ``den`` and ``grad_loss`` are
    one-element float32 tensors on the card."""
    name = 'gaussian_nll'
    n, d = _check_nll(name, y_pred, y_true, cov, frame_mask)
    y_pred, y_true, cov, frame_mask, den, grad_loss = (
        _c(t) for t in (y_pred, y_true, cov, frame_mask, den, grad_loss))
    grad_y = torch.empty_like(y_pred)
    grad_cov = torch.empty_like(cov)
    launch(name, y_pred.data_ptr(), y_true.data_ptr(), cov.data_ptr(), _ptr(frame_mask),
           den.data_ptr(), grad_loss.data_ptr(), grad_y.data_ptr(), grad_cov.data_ptr(),
           n, d, symbol='bn_gaussian_nll_bwd')
    return grad_y, grad_cov


class _GaussianNLLFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y_pred, y_true, cov, frame_mask):
        fwd = gaussian_neg_log_prob_plain if _on_cpu(y_pred) else gaussian_neg_log_prob_cuda
        loss, den = fwd(y_pred, y_true, cov, frame_mask)
        ctx.save_for_backward(y_pred, y_true, cov, frame_mask, den)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        y_pred, y_true, cov, frame_mask, den = ctx.saved_tensors
        bwd = gaussian_neg_log_prob_grad_plain if _on_cpu(y_pred) \
            else gaussian_neg_log_prob_grad_cuda
        grad_y, grad_cov = bwd(y_pred, y_true, cov, frame_mask, den, grad_loss)
        return grad_y, None, grad_cov, None


def _gaussian_neg_log_prob_linalg(y_pred, y_true, cov, frame_mask):
    """The shared-covariance (d, d) and the d > 16 branches of JAX :175-195,
    which call the library's Cholesky and triangular solve there too
    (``torch.linalg`` here, differentiated by autograd; its Cholesky
    gradient is symmetric, as JAX's)."""
    d = y_true.shape[1]
    sigma = _nll_sigma(cov, d, frame_mask)
    diff = y_true - y_pred
    chol = torch.linalg.cholesky(sigma)
    if sigma.dim() == 2:
        sol = torch.linalg.solve_triangular(chol, diff.T, upper=False)     # (d, B)
        maha = torch.sum(sol ** 2, dim=0)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    else:
        sol = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
        maha = torch.sum(sol ** 2, dim=1)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
    return _weighted_mean(0.5 * (d * LN2PI + logdet + maha), frame_mask)[0]


def gaussian_neg_log_prob(y_pred, y_true, cov, frame_mask=None):
    """Negative multivariate-normal log-probability with a learned covariance
    (JAX: ops/losses.py:161; the reference's GaussianNegLogProb module,
    losses.py:17-33): covariance 1e-3 I + ``cov``, mean over (valid) frames.

    ``y_pred``, ``y_true``: (B, d). ``cov``: (d, d) shared, or (B, d, d) per
    frame (the decoder's precision head, passed as a covariance as the
    reference does). ``frame_mask`` (B,) restricts the mean to valid rows; a
    masked row's covariance is replaced by I first, so padding cannot give
    NaNs. A per-frame covariance with d <= 16 runs K12 on a ``cuda`` tensor
    (its plain version on a ``cpu`` one); the other cases go through
    ``torch.linalg``. ``y_pred`` and ``cov`` get gradients; ``y_true`` and
    the mask are data.
    """
    if y_pred.device.type not in ('cpu', 'cuda'):
        raise ValueError('gaussian_neg_log_prob: no implementation for device %s'
                         % y_pred.device)
    for t in (y_true, frame_mask):
        if t is not None and t.requires_grad:
            raise ValueError('gaussian_neg_log_prob: targets and masks are data; they '
                             'get no gradient')
    if cov.dim() == 3 and y_true.shape[1] <= _NLL_MAX_D:
        return _GaussianNLLFn.apply(y_pred, y_true, cov, frame_mask)
    return _gaussian_neg_log_prob_linalg(y_pred, y_true, cov, frame_mask)


# ------------------------------------------------ cross-session triplet (K25, K26)

# chunk-pairing patterns per session count (JAX :224, the reference's
# hand-enumerated triplets, losses.py:402-511, as data):
# triplets: (anchor_ds, anchor_chunk, positive_chunk, negative_ds, negative_chunk)
# pulls:    (ds, chunk_i, chunk_j) within-session attraction terms
_TRIPLET_PATTERNS = {
    2: {'n_chunks': 3,
        'triplets': [(0, 0, 1, 1, 2), (1, 0, 1, 0, 2)],
        'pulls': [(0, 0, 1), (1, 0, 1)],
        # the reference keeps this legacy normalization (losses.py:441)
        'n_terms': 3},
    3: {'n_chunks': 6,
        'triplets': [(0, 0, 1, 1, 4), (0, 2, 3, 2, 4),
                     (1, 0, 1, 0, 4), (1, 2, 3, 2, 5),
                     (2, 0, 1, 0, 5), (2, 2, 3, 1, 5)],
        'pulls': [(ds, 2 * i, 2 * i + 1) for ds in range(3) for i in range(2)],
        'n_terms': 6},
    4: {'n_chunks': 9,
        'triplets': [(0, 0, 1, 1, 6), (0, 2, 3, 2, 6), (0, 4, 5, 3, 6),
                     (1, 0, 1, 0, 6), (1, 2, 3, 2, 7), (1, 4, 5, 3, 7),
                     (2, 0, 1, 0, 7), (2, 2, 3, 1, 7), (2, 4, 5, 3, 8),
                     (3, 0, 1, 0, 8), (3, 2, 3, 1, 8), (3, 4, 5, 2, 8)],
        'pulls': [(ds, 2 * i, 2 * i + 1) for ds in range(4) for i in range(3)],
        'n_terms': 12},
}
_TRIPLET_EPS = 1e-6   # inside the distance, as torch's pairwise_distance (JAX :202)
_TRIPLET_MAX_D = 64   # widest background space K25 / K26 take (the arch's max_latents)


def _triplet_pattern(seg_lens):
    """(pattern, chunks per session, chunk length m) of ``seg_lens``; m is
    the shortest (padded) segment's length over the chunk count (JAX :272-278)."""
    if len(seg_lens) not in _TRIPLET_PATTERNS:
        raise NotImplementedError('triplet loss supports 2-4 datasets')
    pat = _TRIPLET_PATTERNS[len(seg_lens)]
    m = min(int(s) // pat['n_chunks'] for s in seg_lens)
    if m == 0:
        raise ValueError('segments %s too small for %d chunks'
                         % (tuple(seg_lens), pat['n_chunks']))
    return pat, pat['n_chunks'], m


def _chunk_rows(seg_lens, perms, n_chunks, m):
    """rows[ds][i]: the (m,) rows of z in chunk i of session ds: row
    ``offset_ds + perm_ds[i + n_chunks * j]`` at position j."""
    rows, offset = [], 0
    for n, perm in zip(seg_lens, perms):
        perm = torch.as_tensor(perm).to(torch.long)
        if tuple(perm.shape) != (int(n),):
            raise ValueError('a permutation of %d rows has shape %s' % (n, tuple(perm.shape)))
        rows.append([perm[i::n_chunks][:m] + offset for i in range(n_chunks)])
        offset += int(n)
    return rows


def _pdist(a, b):
    """Row-wise euclidean distance with torch's eps (JAX :202 _pdist)."""
    return torch.sqrt(torch.sum((a - b + _TRIPLET_EPS) ** 2, dim=1))


def _triplet_terms(z, seg_lens, perms, seg_mask):
    """Each term of the pattern, in the table's order: ('triplet', the
    (session, chunk) keys and rows of its anchor, positive and negative,
    weights) or ('pull', the keys and rows of its two ends, weights);
    weights None without a mask, else the product of the rows' mask values."""
    pat, n_chunks, m = _triplet_pattern(seg_lens)
    rows = _chunk_rows(seg_lens, perms, n_chunks, m)
    rows = [[r.to(z.device) for r in chunks] for chunks in rows]

    def weights(*idx):
        if seg_mask is None:
            return None
        out = seg_mask[idx[0]]
        for i in idx[1:]:
            out = out * seg_mask[i]
        return out
    terms = []
    for a_ds, a_i, p_i, n_ds, n_i in pat['triplets']:
        keys = ((a_ds, a_i), (a_ds, p_i), (n_ds, n_i))
        idx = tuple(rows[ds][i] for ds, i in keys)
        terms.append(('triplet', keys, idx, weights(*idx)))
    for ds, i, j in pat['pulls']:
        keys = ((ds, i), (ds, j))
        idx = tuple(rows[d][c] for d, c in keys)
        terms.append(('pull', keys, idx, weights(*idx)))
    return pat, m, terms


def triplet_loss_plain(z, seg_lens, perms, margin=1.0, seg_mask=None):
    """The cross-session triplet loss (JAX: ops/losses.py:246 triplet_loss)
    in plain PyTorch, from given per-session permutations.

    ``z`` (sum(seg_lens), d) is a dataset-major concatenation of segments;
    ``perms[ds]`` permutes segment ds's rows (local indices). Each permuted
    segment splits into 3 / 6 / 9 interleaved chunks of m rows; the loss
    sums the pattern's triplet margins (p = 2, hinge at ``margin``) and
    within-session pulls, each a mean over its m rows (weighted by
    ``seg_mask`` when given: a row of a term drops out when any of its rows
    is padding; denominator ``max(sum w, 1)``), and divides by the pattern's
    ``n_terms``. Differentiable by autograd; the hinge's gradient is 0.5
    where it sits exactly at its kink (``torch.maximum``'s and JAX's rule).
    """
    pat, m, terms = _triplet_terms(z, seg_lens, perms, seg_mask)

    def mean(vals, w):
        if w is None:
            return vals.mean()
        return torch.sum(vals * w) / torch.clamp(w.sum(), min=1.0)
    loss = z.new_zeros(())
    for kind, _, idx, w in terms:
        if kind == 'triplet':
            anc, pos, neg = (z[i] for i in idx)
            x = _pdist(anc, pos) - _pdist(anc, neg) + margin
            loss = loss + mean(torch.maximum(x, torch.zeros_like(x)), w)
        else:
            loss = loss + mean(_pdist(z[idx[0]], z[idx[1]]), w)
    return loss / pat['n_terms']


def triplet_loss_grad_plain(z, seg_lens, perms, margin, seg_mask, grad):
    """dL/dz of :func:`triplet_loss_plain` at upstream gradient ``grad``,
    written out as K26 computes it: with u = (a - b + eps) / |a - b + eps|
    and, per term and row, c = grad w slope / (den n_terms) (w the row's
    weight, 1 without a mask; den = max(sum w, 1), m without a mask; slope
    of the hinge 1, 0.5 at the kink, 0 below it, and 1 for a pull), a
    triplet adds c (u_ap - u_an) to its anchor, -c u_ap to its positive and
    c u_an to its negative, a pull c u to its first row and -c u to its
    second, summed in the table's order; rows in no chunk get 0."""
    pat, m, terms = _triplet_terms(z, seg_lens, perms, seg_mask)
    scale = grad / pat['n_terms']
    rows, grads = {}, {}

    def add(key, idx, g):
        rows[key] = idx
        grads[key] = grads[key] + g if key in grads else g
    for kind, keys, idx, w in terms:
        den = float(m) if w is None else torch.clamp(w.sum(), min=1.0)
        w = torch.ones(m, dtype=z.dtype, device=z.device) if w is None else w
        if kind == 'triplet':
            anc, pos, neg = (z[i] for i in idx)
            d_ap, d_an = _pdist(anc, pos), _pdist(anc, neg)
            u_ap = (anc - pos + _TRIPLET_EPS) / d_ap[:, None]
            u_an = (anc - neg + _TRIPLET_EPS) / d_an[:, None]
            x = d_ap - d_an + margin
            slope = (x > 0).to(z.dtype) + 0.5 * (x == 0).to(z.dtype)
            c = (scale * w * slope / den)[:, None]
            add(keys[0], idx[0], c * (u_ap - u_an))
            add(keys[1], idx[1], -c * u_ap)
            add(keys[2], idx[2], c * u_an)
        else:
            a, b = z[idx[0]], z[idx[1]]
            u = (a - b + _TRIPLET_EPS) / _pdist(a, b)[:, None]
            c = (scale * w / den)[:, None]
            add(keys[0], idx[0], c * u)
            add(keys[1], idx[1], -c * u)
    dz = torch.zeros_like(z)
    for key, g in grads.items():
        dz[rows[key]] = g      # the chunks' rows are distinct: nothing sums across them
    return dz


def _check_triplet(name, z, seg_lens, perm, seg_mask):
    tensors = [t for t in (z, perm, seg_mask) if t is not None]
    for t in tensors:
        if t.device != z.device or t.device.type != 'cuda':
            raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                             % (name, [str(t.device) for t in tensors]))
    n = sum(seg_lens)
    if z.dtype != torch.float32 or z.dim() != 2 or z.shape[0] != n or \
            not 1 <= z.shape[1] <= _TRIPLET_MAX_D:
        raise ValueError('%s: z must be float32 (sum(seg_lens) = %d, d <= %d), got %s %s'
                         % (name, n, _TRIPLET_MAX_D, z.dtype, tuple(z.shape)))
    if perm.dtype != torch.int32 or tuple(perm.shape) != (n,):
        raise ValueError('%s: perm must be int32 (%d,), got %s %s'
                         % (name, n, perm.dtype, tuple(perm.shape)))
    if seg_mask is not None and (seg_mask.dtype != torch.float32 or
                                 tuple(seg_mask.shape) != (n,)):
        raise ValueError('%s: seg_mask must be float32 (%d,)' % (name, n))
    pat, n_chunks, m = _triplet_pattern(seg_lens)
    lens = list(seg_lens) + [0] * (4 - len(seg_lens))
    # the pattern as the launchers read it, from host memory: the triplets'
    # 5-tuples, then the pulls' 3-tuples
    flat = [v for t in pat['triplets'] + pat['pulls'] for v in t]
    table = (ctypes.c_int * len(flat))(*flat)
    # the launch reads these: the caller keeps them alive until it is queued
    z = z if z.stride(1) == 1 else z.contiguous()   # rows may be strided (mu's columns)
    perm, seg_mask = perm.contiguous(), _c(seg_mask)
    keep = (z, perm, seg_mask, table)
    args = (z.data_ptr(), z.stride(0), z.shape[1], perm.data_ptr(), _ptr(seg_mask),
            ctypes.addressof(table), len(seg_lens), *lens, n_chunks, m,
            len(pat['triplets']), len(pat['pulls']))
    return pat, m, args, keep


def triplet_loss_cuda(z, seg_lens, perm, margin=1.0, seg_mask=None):
    """K25, the triplet loss's forward on the card: (loss, each term's
    denominator max(sum w, 1)). ``perm`` is the sessions' permutations
    (local indices) concatenated, int32 (sum(seg_lens),); ``z`` may have a
    row stride (the background columns of mu)."""
    name = 'triplet_loss'
    pat, m, args, _keep = _check_triplet(name, z, seg_lens, perm, seg_mask)
    n_terms = len(pat['triplets']) + len(pat['pulls'])
    work = torch.empty(2 * n_terms * m, device=z.device, dtype=torch.float32)
    den = torch.empty(n_terms, device=z.device, dtype=torch.float32)
    out = torch.empty(1, device=z.device, dtype=torch.float32)
    launch(name, *args, float(margin), float(pat['n_terms']), work.data_ptr(),
           den.data_ptr(), out.data_ptr(), symbol='bn_triplet_loss')
    return out[0], den


def triplet_loss_grad_cuda(z, seg_lens, perm, margin, seg_mask, den, grad):
    """K26, the triplet loss's backward on the card: dL/dz (N, d)
    contiguous, from the forward's ``den`` and the upstream (1,) ``grad``."""
    name = 'triplet_loss'
    pat, m, args, _keep = _check_triplet(name, z, seg_lens, perm, seg_mask)
    den, grad = _c(den), _c(grad.reshape(1))
    if tuple(den.shape) != (len(pat['triplets']) + len(pat['pulls']),):
        raise ValueError('%s: backward takes the forward\'s denominators' % name)
    dz = torch.empty(z.shape, device=z.device, dtype=torch.float32)
    launch(name, *args, float(margin), float(pat['n_terms']), den.data_ptr(),
           grad.data_ptr(), dz.data_ptr(), z.shape[0], symbol='bn_triplet_loss_grad')
    return dz


class _TripletFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, seg_mask, perm, seg_lens, margin):
        ctx.seg_lens, ctx.margin = seg_lens, margin
        if _on_cpu(z):
            perms = torch.split(perm, list(seg_lens))
            ctx.save_for_backward(z, seg_mask, perm)
            return triplet_loss_plain(z, seg_lens, perms, margin, seg_mask)
        loss, den = triplet_loss_cuda(z, seg_lens, perm, margin, seg_mask)
        ctx.save_for_backward(z, seg_mask, perm, den)
        return loss

    @staticmethod
    def backward(ctx, grad):
        if _on_cpu(grad):
            z, seg_mask, perm = ctx.saved_tensors
            dz = triplet_loss_grad_plain(z, ctx.seg_lens, torch.split(perm, list(ctx.seg_lens)),
                                         ctx.margin, seg_mask, grad)
        else:
            z, seg_mask, perm, den = ctx.saved_tensors
            dz = triplet_loss_grad_cuda(z, ctx.seg_lens, perm, ctx.margin, seg_mask, den, grad)
        return dz, None, None, None, None


def triplet_loss(z, seg_lens, margin=1.0, seg_mask=None, generator=None, perms=None):
    """Triplet loss separating per-session embedding clusters (JAX:
    ops/losses.py:246; the reference's hand-enumerated chunk triplets,
    losses.py:402-511), as :func:`triplet_loss_plain` computes it.

    ``z`` (sum(seg_lens), d): the sessions' segments, dataset-major, padded
    rows included (``seg_lens`` are the padded lengths, and ``seg_mask``
    (N,) marks the real rows). Each segment's permutation is drawn with
    ``torch.randperm(seg_len, generator=generator)`` on z's device, one per
    session in order (the port's own random stream; JAX draws its own), or
    taken from ``perms`` (one per session, local indices). On a ``cuda``
    tensor the forward runs K25 and the backward K26; on a ``cpu`` one the
    plain versions. ``z`` gets the gradient; the mask is data.
    """
    if z.device.type not in ('cpu', 'cuda'):
        raise ValueError('triplet_loss: no implementation for device %s' % z.device)
    if seg_mask is not None and seg_mask.requires_grad:
        raise ValueError('triplet_loss: seg_mask is data; it gets no gradient')
    seg_lens = tuple(int(s) for s in seg_lens)
    _triplet_pattern(seg_lens)
    if z.dim() != 2 or z.shape[0] != sum(seg_lens):
        raise ValueError('triplet_loss: z must be (sum(seg_lens) = %d, d), got %s'
                         % (sum(seg_lens), tuple(z.shape)))
    if perms is None:
        perms = [torch.randperm(n, generator=generator, device=z.device) for n in seg_lens]
    perm = torch.cat([torch.as_tensor(p, device=z.device) for p in perms]).to(torch.int32)
    return _TripletFn.apply(z, seg_mask, perm, seg_lens, float(margin))
