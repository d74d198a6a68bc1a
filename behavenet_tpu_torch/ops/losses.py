"""Losses of the port (``behavenet_tpu/ops/losses.py``): the masked MSE.

:func:`mse` is a ``torch.autograd.Function`` whose forward and backward run
in kernel K5 (``kernels/masked_mse.cu``) on a ``cuda`` tensor and in the
plain PyTorch versions beside it on a ``cpu`` tensor, picked from the
prediction's device and from nothing else.
"""

import torch

from behavenet_tpu_torch.kernels.build import launch

__all__ = ['mse', 'mse_plain', 'mse_grad_plain', 'mse_cuda', 'mse_grad_cuda']

_PER_BLOCK = 2048  # elements of one frame each block of K5 reduces


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
