"""2-D conv / transposed conv with BehaveNet padding semantics, in NHWC.

The port of ``behavenet_tpu/ops/conv.py``. Public functions keep the JAX
package's layouts: activations NHWC, conv weights HWIO, transposed-conv
weights HWIO in forward orientation, dense weights (din, dout).

:func:`conv2d` and :func:`conv_transpose2d` are ``torch.autograd.Function``s
whose forward and backward are made of the same pieces on both devices, each
picked from the device of its input and from nothing else:

- a ``cuda`` tensor goes to the hand-written kernel (``kernels/*.cu``),
  through a wrapper that checks the arguments, launches on the current
  stream, raises on a failed launch and counts the launch in ``LAUNCHES``;
- a ``cpu`` tensor goes to the plain PyTorch version beside it, which is
  also the reference the kernels are held against on the card.

The backward follows the JAX package's hand-written VJPs (``_conv_s2dgw_bwd``
and ``_tconv_bwd``): grad-x of a strided conv is a transposed conv of the
cotangent (K2), grad-x of a transposed conv a strided conv of it (K1), and
grad-w of either one weight-gradient kernel (K4, roles swapped for the
transposed conv). The fused activation is differentiated from the saved
output; the bias gradient is a sum over (N, H, W).

Activations (``None``, ``'leaky_relu'`` with the reference's slope 0.05,
``'sigmoid'``) are fused into the kernels' epilogues. A uint8 input to
:func:`conv2d` means raw video frames, normalized as ``x / 255``; it gets no
gradient.
"""

import torch
import torch.nn.functional as F

from behavenet_tpu_torch.kernels.build import LAUNCHES, launch

__all__ = ['conv2d', 'conv2d_plain', 'conv2d_cuda', 'conv_transpose2d',
           'conv_transpose2d_plain', 'conv_transpose2d_cuda', 'conv2d_grad_x',
           'conv2d_grad_x_plain', 'conv_transpose2d_grad_x',
           'conv_transpose2d_grad_x_plain', 'conv2d_grad_w', 'conv2d_grad_w_plain',
           'conv2d_grad_w_cuda', 'leaky_relu', 'linear', 'space_to_depth',
           'depth_to_space', 'conv_out_hw', 'conv_transpose_out_hw', 'LAUNCHES']

_ACT_CODE = {None: 0, 'leaky_relu': 1, 'sigmoid': 2}
_SMALL_COUT = 4  # widest output the final-layer kernel keeps in registers
_LEAKY_SLOPE = 0.05


def leaky_relu(x, negative_slope=_LEAKY_SLOPE):
    """LeakyReLU with the reference's slope of 0.05 (aes.py:114)."""
    return torch.where(x >= 0, x, negative_slope * x)


def _activate(x, activation):
    if activation is None:
        return x
    if activation == 'leaky_relu':
        return leaky_relu(x)
    if activation == 'sigmoid':
        return torch.sigmoid(x)
    raise ValueError('unknown activation %r' % (activation,))


def _activation_grad(gy, y, activation):
    """Cotangent of the pre-activation from that of the output ``y``."""
    if activation is None:
        return gy
    if activation == 'leaky_relu':
        return torch.where(y >= 0, gy, _LEAKY_SLOPE * gy)
    if activation == 'sigmoid':
        return gy * y * (1 - y)
    raise ValueError('unknown activation %r' % (activation,))


def linear(x, w, b=None):
    """Dense layer ``x @ w + b``; x: (..., din), w: (din, dout)."""
    out = torch.matmul(x, w)
    return out if b is None else out + b


def conv_out_hw(h, w, k, stride, pad_y, pad_x):
    """Output (H, W) of a strided conv with (before, after) pads."""
    return ((h + pad_y[0] + pad_y[1] - k) // stride + 1,
            (w + pad_x[0] + pad_x[1] - k) // stride + 1)


def conv_transpose_out_hw(h, w, k, stride, pad_y, pad_x, out_pad=(0, 0)):
    """Output (H, W) of a transposed conv: ``(in-1)*s + k - p0 - p1 + op``."""
    return ((h - 1) * stride + k - pad_y[0] - pad_y[1] + out_pad[0],
            (w - 1) * stride + k - pad_x[0] - pad_x[1] + out_pad[1])


def _frames_to_float(x):
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


# ---------------------------------------------------------------- plain


def conv2d_plain(x, w, b, stride, pad_y, pad_x, activation=None):
    """Plain PyTorch conv: ``F.conv2d`` on an explicitly padded input (a
    negative pad crops)."""
    xt = _frames_to_float(x).permute(0, 3, 1, 2)
    xt = F.pad(xt, [pad_x[0], pad_x[1], pad_y[0], pad_y[1]])
    out = F.conv2d(xt, w.permute(3, 2, 0, 1), b, stride=int(stride))
    return _activate(out.permute(0, 2, 3, 1), activation).contiguous()


def conv_transpose2d_plain(x, w, b, stride, pad_y, pad_x, out_pad=(0, 0),
                           activation=None):
    """Plain PyTorch transposed conv: ``F.conv_transpose2d`` at padding 0,
    then the crop of (before, after - out_pad) pixels per side (a negative
    crop extends with zeros, as torch's ``output_padding`` does)."""
    xt = x.permute(0, 3, 1, 2)
    out = F.conv_transpose2d(xt, w.permute(2, 3, 0, 1), None, stride=int(stride))
    out = F.pad(out, [-pad_x[0], -(pad_x[1] - out_pad[1]),
                      -pad_y[0], -(pad_y[1] - out_pad[0])])
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return _activate(out, activation).contiguous()


def conv2d_grad_w_plain(x, g, k, stride, pad_y, pad_x, out_transposed=False):
    """Plain weight gradient of a strided conv (the formula of JAX
    ops/conv.py:226-232): ``gw[ty, tx, a, b] = sum_{n, oy, ox}
    x[n, oy*s - p0y + ty, ox*s - p0x + tx, a] * g[n, oy, ox, b]``, as one
    ``F.conv2d`` that contracts over the batch (the batch as channels, the
    cotangent as an s-dilated kernel). Returns (k, k, A, B), or (k, k, B, A)
    with ``out_transposed``."""
    xt = _frames_to_float(x).permute(3, 0, 1, 2)         # (A, N, H, W)
    xt = F.pad(xt, [pad_x[0], pad_x[1], pad_y[0], pad_y[1]])
    out = F.conv2d(xt, g.permute(3, 0, 1, 2), dilation=int(stride))  # (A, B, k', k')
    out = out[:, :, :k, :k]
    return out.permute(2, 3, 1, 0).contiguous() if out_transposed \
        else out.permute(2, 3, 0, 1).contiguous()


def _conv2d_grad_x(tconv, g, w, stride, pad_y, pad_x, in_hw):
    # output padding restores the exact input extent (JAX :169-171)
    k = w.shape[0]
    op = (in_hw[0] - ((g.shape[1] - 1) * stride + k - pad_y[0] - pad_y[1]),
          in_hw[1] - ((g.shape[2] - 1) * stride + k - pad_x[0] - pad_x[1]))
    return tconv(g, w.permute(0, 1, 3, 2), None, stride, pad_y, pad_x, op)


def _conv_transpose2d_grad_x(conv, g, w, stride, pad_y, pad_x, out_pad):
    # gx[i] = sum_t g[i*s - p0 + t] w[t]: a strided conv with pads
    # (p0, p1 - out_pad) (JAX :218-225)
    return conv(g, w.permute(0, 1, 3, 2), None, stride,
                (pad_y[0], pad_y[1] - out_pad[0]), (pad_x[0], pad_x[1] - out_pad[1]))


def conv2d_grad_x_plain(g, w, stride, pad_y, pad_x, in_hw):
    """Plain input gradient of :func:`conv2d` at cotangent ``g`` of its
    pre-activation output; ``in_hw`` is the input's (H, W)."""
    return _conv2d_grad_x(conv_transpose2d_plain, g, w, stride, pad_y, pad_x, in_hw)


def conv_transpose2d_grad_x_plain(g, w, stride, pad_y, pad_x, out_pad):
    """Plain input gradient of :func:`conv_transpose2d` at cotangent ``g``
    of its pre-activation output."""
    return _conv_transpose2d_grad_x(conv2d_plain, g, w, stride, pad_y, pad_x, out_pad)


# ---------------------------------------------------------------- kernels


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError('%s: every tensor must lie on one CUDA device, '
                             'got %s and %s' % (name, dev, t.device))
        if not t.is_contiguous():
            raise ValueError('%s: tensors must be contiguous' % name)


def _check_params(name, w, b, ci, co):
    if w.dtype != torch.float32 or (b is not None and b.dtype != torch.float32):
        raise ValueError('%s: weights and bias must be float32' % name)
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != ci:
        raise ValueError('%s: weight must be (k, k, %d, Cout), got %s'
                         % (name, ci, tuple(w.shape)))
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError('%s: bias must be (%d,), got %s' % (name, co, tuple(b.shape)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def conv2d_cuda(x, w, b, stride, pad_y, pad_x, activation=None):
    """K1 ``conv2d_nhwc`` on the card (see :func:`conv2d`). The pads before
    must be >= 0; a negative pad after crops the input's end."""
    name = 'conv2d_nhwc'
    x, w = x.contiguous(), w.contiguous()
    b = None if b is None else b.contiguous()
    _check_cuda(name, x, w, b)
    if x.dtype not in (torch.float32, torch.uint8):
        raise ValueError('%s: input must be float32 or uint8, got %s' % (name, x.dtype))
    n, h, wd, ci = x.shape
    k, co, s = w.shape[0], w.shape[3], int(stride)
    _check_params(name, w, b, ci, co)
    if min(pad_y[0], pad_x[0]) < 0:
        raise ValueError('%s: pads before must be >= 0' % name)
    oh, ow = conv_out_hw(h, wd, k, s, pad_y, pad_x)
    out = torch.empty((n, max(oh, 0), max(ow, 0), co), device=x.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch(name, x.data_ptr(), int(x.dtype == torch.uint8), w.data_ptr(), _ptr(b),
           out.data_ptr(), n, h, wd, ci, co, k, s, pad_y[0], pad_x[0], oh, ow,
           _ACT_CODE[activation])
    return out


def conv_transpose2d_cuda(x, w, b, stride, pad_y, pad_x, out_pad=(0, 0),
                          activation=None, small_cout=False):
    """K2 ``conv_transpose2d_nhwc`` or, with ``small_cout``, K3
    ``conv_transpose2d_smallcout_sigmoid`` on the card."""
    name = 'conv_transpose2d_smallcout_sigmoid' if small_cout \
        else 'conv_transpose2d_nhwc'
    x, w = x.contiguous(), w.contiguous()
    b = None if b is None else b.contiguous()
    _check_cuda(name, x, w, b)
    if x.dtype != torch.float32:
        raise ValueError('%s: input must be float32, got %s' % (name, x.dtype))
    n, h, wd, ci = x.shape
    k, co, s = w.shape[0], w.shape[3], int(stride)
    _check_params(name, w, b, ci, co)
    if small_cout and co > _SMALL_COUT:
        raise ValueError('%s: Cout must be <= %d, got %d' % (name, _SMALL_COUT, co))
    if min(pad_y + pad_x) < 0:
        raise ValueError('%s: pads must be >= 0' % name)
    oh, ow = conv_transpose_out_hw(h, wd, k, s, pad_y, pad_x, out_pad)
    out = torch.empty((n, oh, ow, co), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch(name, x.data_ptr(), w.data_ptr(), _ptr(b), out.data_ptr(),
           n, h, wd, ci, co, k, s, pad_y[0], pad_x[0], oh, ow,
           _ACT_CODE[activation])
    return out


_sm_count = {}


def _gradw_split(m, cols, p, device):
    """(splits, chunk) of K4's contraction over ``p`` pixels: enough splits
    that the (m x cols) output's 64 x 64 tiles fill one wave of four blocks
    on every SM, with at least 256 pixels (16 tile steps) per split."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-m // 64) * -(-cols // 64)
    splits = max(1, min(-(-4 * _sm_count[device] // tiles), p // 256))
    chunk = -(-p // splits)
    chunk = -(-chunk // 16) * 16
    return -(-p // chunk), chunk


def conv2d_grad_w_cuda(x, g, k, stride, pad_y, pad_x, out_transposed=False):
    """K4 ``conv2d_grad_w_nhwc`` on the card (see :func:`conv2d_grad_w_plain`)."""
    name = 'conv2d_grad_w_nhwc'
    x, g = x.contiguous(), g.contiguous()
    _check_cuda(name, x, g)
    if x.dtype not in (torch.float32, torch.uint8) or g.dtype != torch.float32:
        raise ValueError('%s: x must be float32 or uint8 and g float32, got %s, %s'
                         % (name, x.dtype, g.dtype))
    n, h, wd, a = x.shape
    s = int(stride)
    if min(pad_y[0], pad_x[0]) < 0:
        raise ValueError('%s: pads before must be >= 0' % name)
    oh, ow = conv_out_hw(h, wd, k, s, pad_y, pad_x)
    if g.dim() != 4 or tuple(g.shape[:3]) != (n, oh, ow):
        raise ValueError('%s: g must be (%d, %d, %d, B), got %s'
                         % (name, n, oh, ow, tuple(g.shape)))
    cols = g.shape[3]
    p = n * oh * ow
    if p >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError('%s: %d output pixels is beyond the kernel\'s int32 range'
                         % (name, p))
    m = k * k * a
    out = torch.empty((k, k, cols, a) if out_transposed else (k, k, a, cols),
                      device=x.device, dtype=torch.float32)
    if p == 0:
        return out.zero_()
    splits, chunk = _gradw_split(m, cols, p, x.device)
    partial = torch.empty(splits * m * cols, device=x.device, dtype=torch.float32)
    launch(name, x.data_ptr(), int(x.dtype == torch.uint8), g.data_ptr(),
           partial.data_ptr(), out.data_ptr(), n, h, wd, a, cols, k, s, pad_y[0],
           pad_x[0], oh, ow, splits, chunk, int(out_transposed))
    return out


# ---------------------------------------------------------------- dispatch


def _on_cpu(x, name='op'):
    if x.device.type == 'cpu':
        return True
    if x.device.type == 'cuda':
        return False
    raise ValueError('%s: no implementation for device %s' % (name, x.device))


def conv2d_grad_w(x, g, k, stride, pad_y, pad_x, out_transposed=False):
    """Weight gradient of a strided conv (K4 on the card)."""
    fn = conv2d_grad_w_plain if _on_cpu(x, 'conv2d_grad_w') else conv2d_grad_w_cuda
    return fn(x, g, k, stride, pad_y, pad_x, out_transposed)


def conv2d_grad_x(g, w, stride, pad_y, pad_x, in_hw):
    """Input gradient of :func:`conv2d` (K2 on the card)."""
    tconv = conv_transpose2d_plain if _on_cpu(g, 'conv2d_grad_x') \
        else conv_transpose2d_cuda
    return _conv2d_grad_x(tconv, g, w, stride, pad_y, pad_x, in_hw)


def conv_transpose2d_grad_x(g, w, stride, pad_y, pad_x, out_pad):
    """Input gradient of :func:`conv_transpose2d` (K1 on the card)."""
    conv = conv2d_plain if _on_cpu(g, 'conv_transpose2d_grad_x') else conv2d_cuda
    return _conv_transpose2d_grad_x(conv, g, w, stride, pad_y, pad_x, out_pad)


class _Conv2dFn(torch.autograd.Function):
    """Strided conv + bias + activation; backward in K2 (x) and K4 (w)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad_y, pad_x, activation):
        fn = conv2d_plain if _on_cpu(x, 'conv2d') else conv2d_cuda
        y = fn(x, w, b, stride, pad_y, pad_x, activation)
        ctx.save_for_backward(x, w, y)
        ctx.args = (stride, pad_y, pad_x, activation)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        stride, pad_y, pad_x, activation = ctx.args
        g = _activation_grad(gy.contiguous(), y, activation)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = conv2d_grad_x(g, w, stride, pad_y, pad_x, x.shape[1:3])
        if ctx.needs_input_grad[1]:
            gw = conv2d_grad_w(x, g, w.shape[0], stride, pad_y, pad_x)
        if ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 1, 2))
        return gx, gw, gb, None, None, None, None


class _ConvTranspose2dFn(torch.autograd.Function):
    """Transposed conv + bias + activation; backward in K1 (x) and K4 (w)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad_y, pad_x, out_pad, small_cout, activation,
                act_grad_in_loss):
        if _on_cpu(x, 'conv_transpose2d'):
            y = conv_transpose2d_plain(x, w, b, stride, pad_y, pad_x, out_pad, activation)
        else:
            y = conv_transpose2d_cuda(x, w, b, stride, pad_y, pad_x, out_pad,
                                      activation, small_cout=small_cout)
        ctx.save_for_backward(x, w, y)
        ctx.args = (stride, pad_y, pad_x, out_pad, activation, act_grad_in_loss)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        stride, pad_y, pad_x, out_pad, activation, act_grad_in_loss = ctx.args
        g = gy.contiguous() if act_grad_in_loss \
            else _activation_grad(gy.contiguous(), y, activation)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = conv_transpose2d_grad_x(g, w, stride, pad_y, pad_x, out_pad)
        if ctx.needs_input_grad[1]:
            # the strided conv's grad-w with the roles of input and
            # cotangent swapped, transposed back (JAX :226-233)
            gw = conv2d_grad_w(g, x, w.shape[0], stride,
                               (pad_y[0], pad_y[1] - out_pad[0]),
                               (pad_x[0], pad_x[1] - out_pad[1]), out_transposed=True)
        if ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 1, 2))
        return gx, gw, gb, None, None, None, None, None, None, None


def conv2d(x, w, b, stride, pad_y, pad_x, activation=None):
    """Conv with explicit asymmetric padding (JAX: ops/conv.py:43 conv2d).

    Parameters
    ----------
    x : (N, H, W, Cin) float32, or uint8 frames normalized as ``x / 255``
    w : (kh, kw, Cin, Cout) float32
    b : (Cout,) or None
    stride : int
    pad_y, pad_x : (before, after) tuples
    activation : None, 'leaky_relu' or 'sigmoid', applied after the bias

    Returns (N, Ho, Wo, Cout) float32, differentiable in x (float), w and b.
    """
    return _Conv2dFn.apply(x, w, b, int(stride), tuple(pad_y), tuple(pad_x),
                           activation)


def conv_transpose2d(x, w, b, stride, pad_y, pad_x, out_pad=(0, 0), block=None,
                     activation=None, act_grad_in_loss=False):
    """Transposed conv with torch ConvTranspose2d semantics
    (JAX: ops/conv.py:239 conv_transpose2d).

    Output size per dim is ``(in-1)*s + k - p_before - p_after + out_pad``:
    torch's for symmetric pads, the reference's conv-then-crop for
    asymmetric ones (aes.py:407-418, 465-470).

    ``block`` marks a tiny-Cout layer (the decoder's last, chosen as at
    behavenet_tpu/models/aes.py:265-267). It changes no arithmetic: on the
    card it selects the final-layer kernel K3 instead of K2.

    With ``act_grad_in_loss`` the backward takes the cotangent it is given
    as that of the pre-activation: the loss that consumes the output has
    already applied the activation's derivative (``losses.mse`` with
    ``sigmoid_output=True``), which saves a pass over the reconstruction.

    Parameters
    ----------
    x : (N, H, W, Cin) float32
    w : (kh, kw, Cin, Cout) float32, forward orientation
    b : (Cout,) or None
    pad_y, pad_x : (before, after) "input padding" in the torch sense
    out_pad : (opy, opx) torch output_padding
    activation : None, 'leaky_relu' or 'sigmoid', applied after the bias
    """
    return _ConvTranspose2dFn.apply(x, w, b, int(stride), tuple(pad_y), tuple(pad_x),
                                    tuple(out_pad), block is not None, activation,
                                    act_grad_in_loss)


def space_to_depth(x, block):
    """(N, H*block, W*block, C) -> (N, H, W, block*block*C), channels (ry, rx, c)."""
    n, h, w, c = x.shape
    f = block
    x = x.reshape(n, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // f, w // f, f * f * c)


def depth_to_space(x, block):
    """(N, H, W, block*block*C) -> (N, H*block, W*block, C); inverse of
    :func:`space_to_depth`."""
    n, h, w, c = x.shape
    co = c // (block * block)
    x = x.reshape(n, h, w, block, block, co).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, co)
