"""Losses of the port (``behavenet_tpu/ops/losses.py``): the masked MSE, the
Gaussian log-likelihood built on it, the KL to a standard normal and the
minibatch KL decomposition of the beta-TC-VAE and PS-VAE.

:func:`mse` and :func:`decomposed_kl` are ``torch.autograd.Function``s whose
forward and backward run in kernels on a ``cuda`` tensor (K5
``kernels/masked_mse.cu``, K7 ``kernels/decomposed_kl.cu``) and in the plain
PyTorch versions beside them on a ``cpu`` tensor, picked from the input's
device and from nothing else.
"""

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import launch

__all__ = ['LN2PI', 'mse', 'mse_plain', 'mse_grad_plain', 'mse_cuda', 'mse_grad_cuda',
           'gaussian_ll', 'kl_div_to_std_normal', 'decomposed_kl', 'decomposed_kl_plain',
           'decomposed_kl_grad_plain', 'decomposed_kl_cuda', 'decomposed_kl_grad_cuda']

LN2PI = float(np.log(2 * np.pi))
_PER_BLOCK = 2048  # elements of one frame each block of K5 reduces
_MASKED = -1e30    # log-density of a padded mixture component (JAX :133)
_KL_MAX_D = 64     # widest latent space K7 takes (the arch's max_latents)


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
