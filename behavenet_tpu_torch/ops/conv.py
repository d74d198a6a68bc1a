"""2-D conv / transposed conv with BehaveNet padding semantics, in NHWC.

The port of ``behavenet_tpu/ops/conv.py``. Public functions keep the JAX
package's layouts: activations NHWC, conv weights HWIO, transposed-conv
weights HWIO in forward orientation, dense weights (din, dout).

Each dispatcher picks its implementation from the device of its input and
from nothing else:

- a ``cuda`` tensor goes to the hand-written kernel (``kernels/*.cu``),
  through a wrapper that checks the arguments, launches on the current
  stream, raises on a failed launch and counts the launch in ``LAUNCHES``;
- a ``cpu`` tensor goes to the plain PyTorch version beside it, which is
  also the reference the kernels are held against on the card.

Activations (``None``, ``'leaky_relu'`` with the reference's slope 0.05,
``'sigmoid'``) are fused into the kernels' epilogues. A uint8 input to
:func:`conv2d` means raw video frames, normalized as ``x / 255``.
"""

import torch
import torch.nn.functional as F

__all__ = ['conv2d', 'conv2d_plain', 'conv_transpose2d',
           'conv_transpose2d_plain', 'leaky_relu', 'linear', 'space_to_depth',
           'depth_to_space', 'conv_out_hw', 'conv_transpose_out_hw', 'LAUNCHES']

# launches of each kernel since the last reset (callers may zero them)
LAUNCHES = {'conv2d_nhwc': 0, 'conv_transpose2d_nhwc': 0,
            'conv_transpose2d_smallcout_sigmoid': 0}

_ACT_CODE = {None: 0, 'leaky_relu': 1, 'sigmoid': 2}
_SMALL_COUT = 4  # widest output the final-layer kernel keeps in registers


def leaky_relu(x, negative_slope=0.05):
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
    """Plain PyTorch conv: ``F.conv2d`` on an explicitly padded input."""
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


def _launch(name, *args):
    from behavenet_tpu_torch.kernels import build
    err = build.library(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError('%s: kernel launch failed (cudaError %d)' % (name, err))
    LAUNCHES[name] += 1


def conv2d_cuda(x, w, b, stride, pad_y, pad_x, activation=None):
    """K1 ``conv2d_nhwc`` on the card (see :func:`conv2d`)."""
    name = 'conv2d_nhwc'
    x, w = x.contiguous(), w.contiguous()
    b = None if b is None else b.contiguous()
    _check_cuda(name, x, w, b)
    if x.dtype not in (torch.float32, torch.uint8):
        raise ValueError('%s: input must be float32 or uint8, got %s' % (name, x.dtype))
    n, h, wd, ci = x.shape
    k, co, s = w.shape[0], w.shape[3], int(stride)
    _check_params(name, w, b, ci, co)
    if min(pad_y + pad_x) < 0:
        raise ValueError('%s: pads must be >= 0' % name)
    oh, ow = conv_out_hw(h, wd, k, s, pad_y, pad_x)
    out = torch.empty((n, oh, ow, co), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    _launch(name, x.data_ptr(), int(x.dtype == torch.uint8), w.data_ptr(), _ptr(b),
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
    _launch(name, x.data_ptr(), w.data_ptr(), _ptr(b), out.data_ptr(),
            n, h, wd, ci, co, k, s, pad_y[0], pad_x[0], oh, ow,
            _ACT_CODE[activation])
    return out


# ---------------------------------------------------------------- dispatch


def _on_cpu(x, name):
    if x.device.type == 'cpu':
        return True
    if x.device.type == 'cuda':
        return False
    raise ValueError('%s: no implementation for device %s' % (name, x.device))


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

    Returns (N, Ho, Wo, Cout) float32.
    """
    pad_y, pad_x = tuple(pad_y), tuple(pad_x)
    if _on_cpu(x, 'conv2d'):
        return conv2d_plain(x, w, b, stride, pad_y, pad_x, activation)
    return conv2d_cuda(x, w, b, stride, pad_y, pad_x, activation)


def conv_transpose2d(x, w, b, stride, pad_y, pad_x, out_pad=(0, 0), block=None,
                     activation=None):
    """Transposed conv with torch ConvTranspose2d semantics
    (JAX: ops/conv.py:239 conv_transpose2d).

    Output size per dim is ``(in-1)*s + k - p_before - p_after + out_pad``:
    torch's for symmetric pads, the reference's conv-then-crop for
    asymmetric ones (aes.py:407-418, 465-470).

    ``block`` marks a tiny-Cout layer (the decoder's last, chosen as at
    behavenet_tpu/models/aes.py:265-267). It changes no arithmetic: on the
    card it selects the final-layer kernel K3 instead of K2.

    Parameters
    ----------
    x : (N, H, W, Cin) float32
    w : (kh, kw, Cin, Cout) float32, forward orientation
    b : (Cout,) or None
    pad_y, pad_x : (before, after) "input padding" in the torch sense
    out_pad : (opy, opx) torch output_padding
    activation : None, 'leaky_relu' or 'sigmoid', applied after the bias
    """
    pad_y, pad_x, out_pad = tuple(pad_y), tuple(pad_x), tuple(out_pad)
    if _on_cpu(x, 'conv_transpose2d'):
        return conv_transpose2d_plain(x, w, b, stride, pad_y, pad_x, out_pad,
                                      activation)
    return conv_transpose2d_cuda(x, w, b, stride, pad_y, pad_x, out_pad,
                                 activation, small_cout=block is not None)


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
