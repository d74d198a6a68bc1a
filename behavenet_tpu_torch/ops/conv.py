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

The pooling and batch-norm archs' layers (JAX ops/conv.py:367-462) follow
the same pattern: :func:`max_pool2d_with_indices` (K27, its backward
``max_pool2d_grad``), :func:`max_unpool2d` (K28, ``max_unpool2d_grad``) and
:func:`batch_norm` (K29, with the running update of
:func:`batch_norm_update` in the same call; its backward K30), each a
``torch.autograd.Function`` over a plain version and a CUDA wrapper. The
layout is JAX's: NHWC, and int32 flat indices ``row * W + col`` into each
(n, c) input plane. The backwards are JAX's autodiff written out: the pool's
cotangent is split evenly among tied maxima (``jnp.max``'s), not sent to
one index as ``torch.nn.functional.max_pool2d``'s is.
"""

import functools
import math
import os
import re
import struct

import torch
import torch.nn.functional as F

from behavenet_tpu_torch.kernels.build import LAUNCHES, launch
from behavenet_tpu_torch.ops.lstm import _smem_optin

__all__ = ['conv2d', 'conv2d_plain', 'conv2d_cuda', 'conv_transpose2d',
           'conv_transpose2d_plain', 'conv_transpose2d_cuda', 'conv2d_grad_x',
           'conv2d_grad_x_plain', 'conv_transpose2d_grad_x',
           'conv_transpose2d_grad_x_plain', 'conv2d_grad_w', 'conv2d_grad_w_plain',
           'conv2d_grad_w_cuda', 'conv_plan', 'tconv_plan', 'gradw_plan', 'bn_plan',
           'leaky_relu', 'linear', 'space_to_depth',
           'depth_to_space', 'conv_out_hw', 'conv_transpose_out_hw', 'pool_out_hw',
           'pool_windows',
           'max_pool2d_with_indices', 'max_pool2d_plain', 'max_pool2d_cuda',
           'max_pool2d_grad', 'max_pool2d_grad_plain', 'max_pool2d_grad_cuda', 'max_unpool2d',
           'max_unpool2d_plain', 'max_unpool2d_cuda', 'max_unpool2d_grad',
           'max_unpool2d_grad_plain', 'max_unpool2d_grad_cuda', 'batch_norm',
           'batch_norm_plain', 'batch_norm_stats_plain', 'batch_norm_cuda', 'batch_norm_update',
           'batch_norm_backward_plain', 'batch_norm_backward_cuda', 'LAUNCHES']

_ACT_CODE = {None: 0, 'leaky_relu': 1, 'sigmoid': 2}
_SMALL_COUT = 4  # widest output the final-layer kernel keeps in registers
_LEAKY_SLOPE = 0.05
_BN_EPS = 1e-5


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
    """K1 ``conv2d_nhwc`` on the card (see :func:`conv2d`), launched as
    :func:`conv_plan` plans it. The pads before must be >= 0; a negative pad
    after crops the input's end."""
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
    if max(x.numel(), out.numel()) >= 2 ** 31:
        raise ValueError('%s: tensors of 2^31 elements or more are beyond the kernel\'s '
                         'int32 offsets' % name)
    uint8 = x.dtype == torch.uint8
    plan = conv_plan(n, ci, co, k, s, (oh, ow), x_uint8=uint8, aligned=_aligned(x, w, b, out),
                     smem_optin=_smem_optin())
    launch(name, x.data_ptr(), int(uint8), w.data_ptr(), _ptr(b), out.data_ptr(), n, h, wd, ci,
           co, k, s, pad_y[0], pad_x[0], oh, ow, _ACT_CODE[activation], plan['tile_m'],
           plan['tile_n'], plan['stages'], plan['vec'], *plan['grid'][:2])
    return out


# K1's, K2's and K4's launch plans (kernels/igemm_sm90.cuh): the tile, the
# ring's stages, 16-byte copies or not, the grid and, for K4, the
# contraction's chunks; K29's split (bn_plan). Pure functions of the
# shapes, so the CPU tests reach them.

H100_SMS = 132          # the card's SMs; K4's wrapper passes the device's own count
H100_SMEM_OPTIN = 232448   # shared bytes a block may opt in to; K1's wrapper passes the device's


def conv_tiles():
    """The kernels' instances as ``kernels/conv_tiles.h`` lists them (the
    launchers dispatch to the same lists): a dict of each ``#define
    NAME(X)`` list's tuples and each ``#define NAME value``'s int."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'kernels', 'conv_tiles.h')
    with open(path) as f:
        text = f.read().replace('\\\n', ' ')
    out = {}
    for line in text.splitlines():
        m = re.match(r'#define BN_(\w+)\(X\)(.*)', line)
        if m:
            out[m.group(1)] = tuple(tuple(int(v) for v in t.split(','))
                                    for t in re.findall(r'X\(([\d, ]+)\)', m.group(2)))
            continue
        m = re.match(r'#define BN_(\w+) (\d+)$', line.strip())
        if m:
            out[m.group(1)] = int(m.group(2))
    return out


_TILES = conv_tiles()
# K1: GEMM tiles (rows, columns, rows a thread, columns a thread, step,
# stages) for float input with Cin > CONV_NARROW_MAX_CIN; the narrow kernel
# (Cin <= CONV_NARROW_MAX_CIN, or uint8 frames): a block owns
# CONV_NARROW_ROWS x CONV_NARROW_COLS output pixels by COB output channels
# (CONV_NARROW_COBS), staging CONV_NARROW_CHANNELS input channels at a time
CONV_TILES = _TILES['CONV_GEMM_TILES']
CONV_NARROW_ROWS, CONV_NARROW_COLS = _TILES['CONV_NARROW_ROWS'], _TILES['CONV_NARROW_COLS']
CONV_NARROW_CHANNELS = _TILES['CONV_NARROW_CHANNELS']
CONV_NARROW_COBS = tuple(t[0] for t in _TILES['CONV_NARROW'])
CONV_NARROW_MAX_CIN = 4
# K2: GEMM tiles (rows, columns, rows a thread, columns a thread, step,
# stages); the narrow kernel (Cout <= 4): a block of 256 threads owns
# NARROW_ROWS x NARROW_COLS outputs of a phase, 2 or 4 output registers a
# pixel, unrolled for 2 to 5 landing taps per dim (a layer with one takes
# the 2-tap instance)
TCONV_TILES = _TILES['TCONV_GEMM_TILES']
NARROW_ROWS, NARROW_COLS = _TILES['TCONV_NARROW_ROWS'], _TILES['TCONV_NARROW_COLS']
NARROW_COUTS = tuple(sorted({t[0] for t in _TILES['TCONV_NARROW']}))
NARROW_TAPS = tuple(sorted({t[1] for t in _TILES['TCONV_NARROW']}))
# K4: the patch and gather kernels' tiles as K2's, the patch kernel's steps
# of PATCH_STEP output pixels
GRADW_PATCH_TILES, PATCH_STEP = _TILES['GRADW_PATCH_TILES'], _TILES['GRADW_PATCH_STEP']
GRADW_GATHER_TILES = _TILES['GRADW_GATHER_TILES']
# K4 splits its contraction into enough chunks for GRADW_BLOCKS_PER_SM
# blocks an SM (the gather kernel's blocks: four resident, two waves; the
# patch kernel's: four resident, four waves), each chunk at least 8 steps
GRADW_BLOCKS_PER_SM = {'gather': 8, 'patch': 16}
GRADW_PATCH_SMEM = 110 * 1024   # the patch kernel's shared memory for two blocks an SM
_GRADW_MIN_STEPS = 8


def _cdiv(a, b):
    return -(-a // b)


def _column_tile(cols, choices):
    """The narrowest tile of ``choices`` that holds ``cols``, else the widest."""
    fit = [c for c in sorted(choices) if c >= cols]
    return fit[0] if fit else max(choices)


def _gemm_smem(bm, bn, bk, stages, m_major):
    a = bm * (bk + 4) if m_major else bk * (bm + 4)
    return 4 * stages * (a + bk * (bn + 4))


def tconv_plan(n, ci, co, k, s, out_hw, aligned=True):
    """K2's launch for a transposed conv of ``n`` frames of ``ci`` channels
    by a (k, k, ci, co) weight at stride ``s`` to ``out_hw``: a dict with
    ``kind`` ('narrow' or 'gemm'), ``tile_m`` (outputs a block owns along
    the pixels), ``tile_n`` (the column tile; the narrow kernel's output
    registers a pixel), ``taps`` (the landing taps per dim the narrow
    kernel unrolls), ``stages``, ``vec`` (16-byte copies: Cin and, for the
    GEMM, Cout multiples of 4 and ``aligned`` pointers), ``threads``,
    ``smem`` bytes and ``grid``.

    Each block computes one output phase (oy % s, ox % s), so gridDim.z is
    s * s. Cout <= 4 (with at most 5 landing taps a dim) takes the narrow
    kernel, wider outputs the GEMM tile with the narrowest column tile that
    holds Cout (64 columns at most)."""
    oh, ow = out_hw
    qh, qw = _cdiv(oh, s), _cdiv(ow, s)   # phase (0, 0), the largest
    taps = max(_cdiv(k, s), min(NARROW_TAPS))
    if co <= max(NARROW_COUTS) and taps <= max(NARROW_TAPS):
        co_regs = _column_tile(co, NARROW_COUTS)
        pw = (NARROW_COLS + taps - 1) | 1
        patch = (NARROW_ROWS + taps - 1) * pw * 4
        smem = 4 * 2 * (patch + taps * taps * 4 * co_regs)
        grid = (n * _cdiv(qh, NARROW_ROWS) * _cdiv(qw, NARROW_COLS), 1, s * s)
        return dict(kind='narrow', tile_m=NARROW_ROWS * NARROW_COLS, tile_n=co_regs, taps=taps,
                    stages=2, vec=int(aligned and ci % 4 == 0), threads=256, smem=smem,
                    grid=grid)
    bn = _column_tile(co, [t[1] for t in TCONV_TILES])
    bm, bn, tm, tn, bk, stages = [t for t in TCONV_TILES if t[1] == bn][0]
    return dict(kind='gemm', tile_m=bm, tile_n=bn, taps=taps, stages=stages,
                vec=int(aligned and ci % 4 == 0 and co % 4 == 0),
                threads=(bm // tm) * (bn // tn),
                smem=16 * bm + _gemm_smem(bm, bn, bk, stages, True),
                grid=(_cdiv(n * qh * qw, bm), _cdiv(co, bn), s * s))


def conv_plan(n, ci, co, k, s, out_hw, x_uint8=False, aligned=True,
              smem_optin=H100_SMEM_OPTIN):
    """K1's launch for a k x k conv at stride ``s`` of ``n`` frames of
    ``ci`` channels to ``out_hw`` x ``co``: a dict with ``kind`` ('narrow'
    or 'gemm'), ``tile_m`` (output pixels a block owns), ``tile_n`` (its
    output channels), ``stages``, ``vec`` (16-byte copies and stores: Cout
    and, for the GEMM, Cin multiples of 4 and ``aligned`` pointers),
    ``threads``, ``smem`` bytes and ``grid``.

    uint8 frames and Cin <= CONV_NARROW_MAX_CIN take the narrow kernel: a
    block stages its tile's input patch, (rows - 1) * s + k by (cols - 1) *
    s + k positions of CONV_NARROW_CHANNELS channels (columns grouped by
    phase, ``patch``: (rows, columns, pitch)), and the tile's weights, with
    the narrowest COB that holds Cout (32 at most: wider outputs take more
    blocks along y). Wider float inputs take the GEMM tile with the
    narrowest column tile that holds Cout (64 columns at most). A narrow
    patch beyond ``smem_optin`` bytes, the shared memory a block may opt in
    to, raises ValueError."""
    oh, ow = out_hw
    if x_uint8 or ci <= CONV_NARROW_MAX_CIN:
        cob = _column_tile(co, CONV_NARROW_COBS)
        ph = (CONV_NARROW_ROWS - 1) * s + k
        pw = (CONV_NARROW_COLS - 1) * s + k
        pitch = s * _cdiv(pw, s)
        patch = -(-CONV_NARROW_CHANNELS * ph * pitch // 4) * 4
        smem = 4 * (patch + k * k * CONV_NARROW_CHANNELS * cob)
        if smem > smem_optin:
            raise ValueError('conv2d_nhwc: a %d x %d kernel at stride %d stages %d bytes, beyond '
                             'the %d a block may use' % (k, k, s, smem, smem_optin))
        grid = (n * _cdiv(oh, CONV_NARROW_ROWS) * _cdiv(ow, CONV_NARROW_COLS), _cdiv(co, cob), 1)
        return dict(kind='narrow', tile_m=CONV_NARROW_ROWS * CONV_NARROW_COLS, tile_n=cob,
                    stages=1, vec=int(aligned and co % 4 == 0),
                    threads=CONV_NARROW_COLS * (CONV_NARROW_ROWS // 8) * (cob // 8), smem=smem,
                    patch=(ph, pw, pitch), grid=grid)
    bn = _column_tile(co, [t[1] for t in CONV_TILES])
    bm, bn, tm, tn, bk, stages = [t for t in CONV_TILES if t[1] == bn][0]
    return dict(kind='gemm', tile_m=bm, tile_n=bn, stages=stages,
                vec=int(aligned and ci % 4 == 0 and co % 4 == 0),
                threads=(bm // tm) * (bn // tn),
                smem=16 * bm + _gemm_smem(bm, bn, bk, stages, True),
                grid=(_cdiv(n * oh * ow, bm), _cdiv(co, bn), 1))


def _gradw_chunks(steps, tiles, sms, kind):
    """(splits, chunk): chunks of ``chunk`` steps for K4's ``kind`` of
    kernel, GRADW_BLOCKS_PER_SM blocks an SM, at least 8 steps each."""
    want = _cdiv(GRADW_BLOCKS_PER_SM[kind] * sms, tiles)
    chunk = max(_GRADW_MIN_STEPS, steps // want)
    return _cdiv(steps, chunk), chunk


def gradw_plan(n, a, b, k, s, out_hw, x_uint8=False, aligned=True, sms=H100_SMS):
    """K4's launch for the weight gradient of a k x k conv at stride ``s``
    of ``n`` frames of ``a`` channels to ``out_hw`` with a cotangent of
    ``b`` channels: a dict with ``kind`` ('patch' or 'gather'), ``tile_m``
    x ``tile_n`` (rows (tap, channel) x columns), ``threads``, ``stages``,
    ``smem`` bytes, ``splits`` chunks of ``chunk`` steps and the ``grid``
    (row tiles, column tiles, splits).

    The patch kernel takes float input with A and B multiples of 4 (16-byte
    copies, ``aligned`` pointers) where a tile of GRADW_PATCH_TILES holds B
    with at most 2x waste. Its rows run in the order (slab of 4 channels,
    tap, channel), so a block's tile_m rows are every tap of one slab or
    more (``patch_slabs`` at most); a step is ``step_rows`` stacked output
    rows (n * OH + oy) by ``step_cols`` columns (8, or the plane's width
    rounded up to a power of two), ``steps`` of them, and its input patch
    at most ``patch_rows`` x ``patch_cols`` positions a slab (3 stages, 2
    where that keeps two blocks an SM). Else the gather kernel's tile of
    the narrowest column width that holds B (one tile a width); its steps
    are ``bk`` consecutive pixels of P = n * OH * OW. The
    contraction is split for GRADW_BLOCKS_PER_SM blocks an SM of ``sms``,
    each chunk at least 8 steps. The gather kernel's row codes take A <
    2^15 and k < 256: larger raise ValueError."""
    if a >= 2 ** 15 or k > 255:
        raise ValueError('conv2d_grad_w_nhwc: %d input channels and %d x %d kernels are beyond '
                         'the kernel\'s row codes (A < 32768, k < 256)' % (a, k, k))
    oh, ow = out_hw
    m, p = k * k * a, n * oh * ow
    if aligned and not x_uint8 and a % 4 == 0 and b % 4 == 0:
        bn = _column_tile(b, [t[1] for t in GRADW_PATCH_TILES])
        if bn <= 2 * b:
            bm, bn, tm, tn, bk, stages = [t for t in GRADW_PATCH_TILES if t[1] == bn][0]
            cols = min(8, 1 << max(0, ow - 1).bit_length())
            rows = bk // cols
            s1 = min(s, k)
            # frame boundaries inside a step: each starts a fresh k rows
            breaks = min(rows - 1, (oh - math.gcd(rows, oh) + rows - 1) // oh)
            patch_rows = (rows - 1) * s1 + breaks * (k - s1) + k
            patch_cols = (cols - 1) * s + k
            # the slabs of 4 channels a block's bm / 4 (slab, tap) fours touch
            slabs = (bm // 4 - 2 + k * k) // (k * k) + 1
            steps = _cdiv(n * oh, rows) * _cdiv(ow, cols)
            splits, chunk = _gradw_chunks(steps, _cdiv(m, bm) * _cdiv(b, bn), sms, 'patch')

            def smem(st):
                return 4 * st * (slabs * patch_rows * patch_cols * 4 + bk * (bn + 4)) \
                    + 4 * (st + 1) * (2 * bk + patch_rows)
            if smem(stages) > GRADW_PATCH_SMEM and stages > 2:
                stages = 2   # keep two blocks an SM where the patch is large
            return dict(kind='patch', tile_m=bm, tile_n=bn, threads=(bm // tm) * (bn // tn),
                        stages=stages, step_rows=rows, step_cols=cols, patch_rows=patch_rows,
                        patch_cols=patch_cols, patch_slabs=slabs, steps=steps,
                        smem=smem(stages), splits=splits, chunk=chunk,
                        grid=(_cdiv(m, bm), _cdiv(b, bn), splits))
    bn = _column_tile(b, [t[1] for t in GRADW_GATHER_TILES])
    bm, bn, tm, tn, bk, stages = [t for t in GRADW_GATHER_TILES if t[1] == bn][0]
    splits, chunk = _gradw_chunks(_cdiv(p, bk), _cdiv(m, bm) * _cdiv(b, bn), sms, 'gather')
    return dict(kind='gather', tile_m=bm, tile_n=bn, threads=(bm // tm) * (bn // tn),
                stages=stages, step_rows=0, step_cols=0, patch_rows=0, patch_cols=0,
                steps=_cdiv(p, bk), bk=bk,
                smem=4 * (bm + 4 * bk * stages) + _gemm_smem(bm, bn, bk, stages, False),
                splits=splits, chunk=chunk * bk, grid=(_cdiv(m, bm), _cdiv(b, bn), splits))


_sm_count = {}


def _sms(device):
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def _aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def conv_transpose2d_cuda(x, w, b, stride, pad_y, pad_x, out_pad=(0, 0),
                          activation=None, small_cout=False):
    """K2 ``conv_transpose2d_nhwc`` (launched as :func:`tconv_plan` plans
    it) or, with ``small_cout``, K3 ``conv_transpose2d_smallcout_sigmoid``
    on the card."""
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
    if max(x.numel(), out.numel()) >= 2 ** 31:
        raise ValueError('%s: tensors of 2^31 elements or more are beyond the kernel\'s '
                         'int32 offsets' % name)
    args = (x.data_ptr(), w.data_ptr(), _ptr(b), out.data_ptr(),
            n, h, wd, ci, co, k, s, pad_y[0], pad_x[0], oh, ow, _ACT_CODE[activation])
    if small_cout:
        launch(name, *args)
        return out
    plan = tconv_plan(n, ci, co, k, s, (oh, ow), aligned=_aligned(x, w, b, out))
    launch(name, *args, plan['tile_m'], plan['tile_n'], plan['taps'], plan['stages'],
           plan['vec'], *plan['grid'])
    return out


def conv2d_grad_w_cuda(x, g, k, stride, pad_y, pad_x, out_transposed=False):
    """K4 ``conv2d_grad_w_nhwc`` on the card (see :func:`conv2d_grad_w_plain`),
    launched as :func:`gradw_plan` plans it."""
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
    plan = gradw_plan(n, a, cols, k, s, (oh, ow), x_uint8=x.dtype == torch.uint8,
                      aligned=_aligned(x, g), sms=_sms(x.device))
    partial = torch.empty(plan['splits'] * m * cols, device=x.device, dtype=torch.float32)
    launch(name, x.data_ptr(), int(x.dtype == torch.uint8), g.data_ptr(),
           partial.data_ptr(), out.data_ptr(), n, h, wd, a, cols, k, s, pad_y[0],
           pad_x[0], oh, ow, plan['splits'], plan['chunk'], int(out_transposed),
           plan['tile_m'], plan['tile_n'], plan['stages'], int(plan['kind'] == 'patch'),
           plan['step_rows'], plan['step_cols'], plan['patch_rows'], plan['patch_cols'],
           *plan['grid'][:2])
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


# ------------------------------------------- pooling and batch norm: plain


def pool_out_hw(h, w, ceil_mode=True):
    """Output (H, W) of the 2x2 / stride-2 pool (JAX ops/conv.py:385-386)."""
    if ceil_mode:
        return -(-(h - 2) // 2) + 1, -(-(w - 2) // 2) + 1
    return (h - 2) // 2 + 1, (w - 2) // 2 + 1


def pool_windows(x, ceil_mode):
    """(N, Ho, Wo, C, 4) pooling windows in (dy, dx) order: ceil mode pads
    the input with the lowest float to an even extent, floor mode crops the
    remainder (JAX :387-394)."""
    n, h, w, c = x.shape
    ho, wo = pool_out_hw(h, w, ceil_mode)
    xp = x[:, :min(h, 2 * ho), :min(w, 2 * wo), :]
    if 2 * ho > h or 2 * wo > w:
        xp = F.pad(xp, [0, 0, 0, max(0, 2 * wo - w), 0, max(0, 2 * ho - h)],
                   value=torch.finfo(x.dtype).min)
    return xp.reshape(n, ho, 2, wo, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(n, ho, wo, c, 4)


def max_pool2d_plain(x, ceil_mode=True, activation=None):
    """Plain 2x2 / stride-2 max pool: (pooled, int32 indices of the first
    maximum, ``row * W + col``). ``amax``'s autograd splits a window's
    cotangent evenly among its tied maxima, as JAX's does."""
    n, h, w, c = x.shape
    xw = pool_windows(x, ceil_mode)
    arg = torch.argmax(xw, dim=-1)
    ho, wo = xw.shape[1], xw.shape[2]
    oy = torch.arange(ho, device=x.device).reshape(1, ho, 1, 1)
    ox = torch.arange(wo, device=x.device).reshape(1, 1, wo, 1)
    idx = (oy * 2 + arg // 2) * w + ox * 2 + arg % 2
    return _activate(xw.amax(dim=-1), activation), idx.to(torch.int32)


def max_pool2d_grad_plain(x, g, ceil_mode=True):
    """Input gradient of :func:`max_pool2d_plain` at cotangent ``g`` of its
    pre-activation output, written out: each window's cotangent split evenly
    among the positions equal to its maximum, 0 elsewhere and on the rows
    and columns floor mode cut off."""
    n, h, w, c = x.shape
    xw = pool_windows(x, ceil_mode)
    ho, wo = xw.shape[1], xw.shape[2]
    eq = xw == xw.amax(dim=-1, keepdim=True)
    share = g[..., None] / eq.sum(dim=-1, keepdim=True)
    gw = torch.where(eq, share, torch.zeros((), dtype=g.dtype, device=g.device))
    gx = gw.reshape(n, ho, wo, c, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * ho, 2 * wo, c)
    gx = gx[:, :h, :w, :]
    return F.pad(gx, [0, 0, 0, w - gx.shape[2], 0, h - gx.shape[1]]).contiguous()


def _flat_indices(indices, size):
    """(N, h*w, C) int64 indices, those outside [0, size) moved to ``size``
    (a slot the callers drop: JAX's mode='drop')."""
    n, h, w, c = indices.shape
    idx = indices.reshape(n, h * w, c).long()
    return torch.where((idx >= 0) & (idx < size), idx, torch.full_like(idx, size))


def max_unpool2d_plain(x, indices, out_hw):
    """Plain unpool: each value of ``x`` scattered to its flat index in an
    (N, out_h, out_w, C) output of zeros (JAX :402)."""
    n, h, w, c = x.shape
    size = int(out_hw[0]) * int(out_hw[1])
    out = x.new_zeros((n, size + 1, c)).scatter(1, _flat_indices(indices, size),
                                                 x.reshape(n, h * w, c))
    return out[:, :size].reshape(n, int(out_hw[0]), int(out_hw[1]), c)


def max_unpool2d_grad_plain(g, indices):
    """Input gradient of :func:`max_unpool2d_plain`: the gather
    ``g[n, idx, c]`` (0 for a dropped index)."""
    n, oh, ow, c = g.shape
    size = oh * ow
    gp = F.pad(g.reshape(n, size, c), [0, 0, 0, 1])
    return gp.gather(1, _flat_indices(indices, size)).reshape(indices.shape)


def batch_norm_stats_plain(x):
    """Per-channel mean and biased variance over all but the last axis."""
    dims = tuple(range(x.dim() - 1))
    return x.mean(dim=dims), x.var(dim=dims, unbiased=False)


def batch_norm_plain(x, gamma, beta, mean=None, var=None, eps=_BN_EPS, activation=None):
    """Plain batch norm ``gamma * (x - mean) * rsqrt(var + eps) + beta``
    (JAX :419), with the batch's statistics when ``mean`` is None."""
    if mean is None:
        mean, var = batch_norm_stats_plain(x)
    return _activate(gamma * (x - mean) * torch.rsqrt(var + eps) + beta, activation)


def _running_update(running_mean, running_var, count, mean, var, n, momentum):
    """New running statistics (JAX :439-462): the momentum's, or with
    ``momentum`` None the cumulative average 1 / (count + 1); the
    variance unbiased by n / (n - 1)."""
    m = 1.0 / (count + 1) if momentum is None else momentum
    return ((1.0 - m) * running_mean + m * mean,
            (1.0 - m) * running_var + m * (var * (n / max(n - 1, 1))))


def batch_norm_update(x, stats, momentum=0.1):
    """The running statistics after batch ``x`` (JAX :439 batch_norm_update):
    a new dict of ``running_mean``, ``running_var`` and ``num_batches`` (the
    count + 1) from ``stats`` of the same keys; no gradient."""
    x = x.detach()
    mean, var = batch_norm_stats_plain(x)
    count = stats['num_batches']
    rm, rv = _running_update(stats['running_mean'], stats['running_var'], count, mean, var,
                             x.numel() // x.shape[-1], momentum)
    return {'running_mean': rm, 'running_var': rv, 'num_batches': count + 1}


def batch_norm_backward_plain(g, x, gamma, mean, var, batch_stats=True, eps=_BN_EPS):
    """(dx, dgamma, dbeta) of :func:`batch_norm_plain` at cotangent ``g`` of
    its pre-activation output, written out: with ``batch_stats`` through the
    batch mean and variance, else at fixed ``mean`` and ``var``."""
    dims = tuple(range(x.dim() - 1))
    r = torch.rsqrt(var + eps)
    xhat = (x - mean) * r
    dbeta = g.sum(dim=dims)
    dgamma = (g * xhat).sum(dim=dims)
    if batch_stats:
        p = x.numel() // x.shape[-1]
        dx = gamma * r * (g - dbeta / p - xhat * (dgamma / p))
    else:
        dx = gamma * r * g
    return dx, dgamma, dbeta


# ------------------------------------------- pooling and batch norm: kernels


def _check_nhwc(name, x, dtype=torch.float32):
    if x.dtype != dtype or x.dim() != 4:
        raise ValueError('%s: expected a 4-d %s tensor, got %s %s'
                         % (name, dtype, x.dtype, tuple(x.shape)))


def _act_code(name, activation):
    if activation not in (None, 'leaky_relu'):
        raise ValueError('%s: activation must be None or leaky_relu, got %r'
                         % (name, activation))
    return _ACT_CODE[activation]


def max_pool2d_cuda(x, ceil_mode=True, activation=None):
    """K27 ``bn_max_pool2d`` on the card (see :func:`max_pool2d_plain`)."""
    name = 'max_pool2d'
    x = x.contiguous()
    _check_cuda(name, x)
    _check_nhwc(name, x)
    act = _act_code(name, activation)
    n, h, w, c = x.shape
    ho, wo = pool_out_hw(h, w, ceil_mode)
    y = torch.empty((n, max(ho, 0), max(wo, 0), c), device=x.device, dtype=torch.float32)
    idx = torch.empty(y.shape, device=x.device, dtype=torch.int32)
    if y.numel():
        launch(name, x.data_ptr(), y.data_ptr(), idx.data_ptr(), n, h, w, c, ho, wo, act)
    return y, idx


def max_pool2d_grad_cuda(x, g, ceil_mode=True):
    """K27's backward ``bn_max_pool2d_grad`` (counted as ``max_pool2d_grad``)."""
    name = 'max_pool2d_grad'
    x, g = x.contiguous(), g.contiguous()
    _check_cuda(name, x, g)
    _check_nhwc(name, x)
    _check_nhwc(name, g)
    n, h, w, c = x.shape
    ho, wo = pool_out_hw(h, w, ceil_mode)
    if tuple(g.shape) != (n, ho, wo, c):
        raise ValueError('%s: g must be %s, got %s' % (name, (n, ho, wo, c), tuple(g.shape)))
    if g.numel() == 0:
        return torch.zeros_like(x)
    gx = torch.empty_like(x)
    launch('max_pool2d', x.data_ptr(), g.data_ptr(), gx.data_ptr(), n, h, w, c, ho, wo,
           symbol='bn_max_pool2d_grad')
    return gx


def _check_indices(name, x, indices):
    _check_nhwc(name, indices, torch.int32)
    if indices.shape != x.shape:
        raise ValueError('%s: indices must be %s, got %s'
                         % (name, tuple(x.shape), tuple(indices.shape)))


def max_unpool2d_cuda(x, indices, out_hw):
    """K28 ``bn_max_unpool2d`` (counted as ``max_unpool2d``) on the card."""
    name = 'max_unpool2d'
    x, indices = x.contiguous(), indices.contiguous()
    _check_cuda(name, x, indices)
    _check_nhwc(name, x)
    _check_indices(name, x, indices)
    n, h, w, c = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = torch.empty((n, oh, ow, c), device=x.device, dtype=torch.float32)
    if out.numel():
        launch('max_pool2d', x.data_ptr(), indices.data_ptr(), out.data_ptr(), n, h, w, c,
               oh, ow, symbol='bn_max_unpool2d')
    return out


def max_unpool2d_grad_cuda(g, indices):
    """K28's backward ``bn_max_unpool2d_grad`` (counted as
    ``max_unpool2d_grad``): the gather ``g[n, idx, c]``."""
    name = 'max_unpool2d_grad'
    g, indices = g.contiguous(), indices.contiguous()
    _check_cuda(name, g, indices)
    _check_nhwc(name, g)
    _check_nhwc(name, indices, torch.int32)
    n, oh, ow, c = g.shape
    if indices.shape[0] != n or indices.shape[3] != c:
        raise ValueError('%s: indices %s do not match g %s'
                         % (name, tuple(indices.shape), tuple(g.shape)))
    h, w = indices.shape[1], indices.shape[2]
    gx = torch.empty(indices.shape, device=g.device, dtype=torch.float32)
    if gx.numel():
        launch('max_pool2d', g.data_ptr(), indices.data_ptr(), gx.data_ptr(), n, h, w, c,
               oh, ow, symbol='bn_max_unpool2d_grad')
    return gx


# K29's blocks: 256 threads, at most BN_BLOCKS_PER_SM of them an SM (as many
# as fit an SM at once: the train launch is cooperative, every block
# resident), each thread at least BN_MIN_ROWS rows of its chunk
BN_THREADS, BN_BLOCKS_PER_SM, BN_MIN_ROWS = 256, 4, 8


@functools.lru_cache(maxsize=256)
def bn_plan(p, c, aligned=True, sms=H100_SMS):
    """K29's launch over ``p`` rows of ``c`` channels (cached: a small
    layer's call is bound by the host, so the dict returned is shared and
    must not be changed): a dict with ``vec``
    (16-byte accesses: C % 4 == 0 and ``aligned`` pointers), ``lanes`` (CQ:
    channel lanes of 4 channels with ``vec``, else 1), ``rows`` (RB =
    256 // CQ row lanes), ``tiles`` (channel tiles), the chunks (``splits``
    of ``chunk`` rows, chunk s = rows [s * chunk, (s + 1) * chunk)) and the
    ``grid`` (splits, tiles): at most BN_BLOCKS_PER_SM blocks an SM of
    ``sms``, so that the cooperative train launch fits the card."""
    vec = int(aligned and c % 4 == 0)
    width = c // 4 if vec else c
    lanes = min(width, BN_THREADS)
    rows = BN_THREADS // lanes
    tiles = _cdiv(width, lanes)
    splits = max(1, min(BN_BLOCKS_PER_SM * sms // tiles, _cdiv(p, BN_MIN_ROWS * rows)))
    chunk = _cdiv(p, splits)
    splits = _cdiv(p, chunk)
    return dict(vec=vec, lanes=lanes, rows=rows, tiles=tiles, splits=splits, chunk=chunk,
                grid=(splits, tiles))


def _bn_split(p, c, device):
    """(splits, chunk) of K30's reductions over ``p`` rows: about eight
    256-thread blocks an SM over the ceil(c / 32) channel tiles, at least
    64 rows a split."""
    tiles = -(-c // 32)
    splits = max(1, min(-(-8 * _sms(device) // tiles), -(-p // 64)))
    chunk = -(-p // splits)
    return -(-p // chunk), chunk


def _check_bn(name, x, *per_channel):
    # (a small layer's call is bound by the host: _check_cuda, which says
    # what is wrong, runs only when something is)
    dev = x.device
    if dev.type != 'cuda' or not x.is_contiguous():
        _check_cuda(name, x)
    if x.dtype != torch.float32 or x.dim() < 2:
        raise ValueError('%s: x must be float32 (..., C), got %s %s'
                         % (name, x.dtype, tuple(x.shape)))
    c = x.shape[-1]
    for t in per_channel:
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            _check_cuda(name, x, t)
        if t.dtype != torch.float32 or t.shape != (c,):
            raise ValueError('%s: per-channel tensors must be float32 (%d,), got %s %s'
                             % (name, c, t.dtype, tuple(t.shape)))


# kernels/batch_norm.cu BnArgs: 12 pointers, P and chunk, C and splits, eps,
# momentum and the unbiasing factor, act, vec and lanes, padded to the
# struct's 8-byte alignment (0q: the launcher copies sizeof(BnArgs) bytes)
_BN_ARGS = struct.Struct('@12P2q2i3f3i0q')


def batch_norm_cuda(x, gamma, beta, mean=None, var=None, running=None, momentum=0.1,
                    eps=_BN_EPS, activation=None):
    """K29 ``bn_batch_norm`` on the card, launched as :func:`bn_plan` plans
    it: (y, mean, var), the statistics it used. With ``mean`` None the
    batch's, and with ``running`` = (running_mean, running_var,
    num_batches_tracked int64) those are updated in place in the same call
    (:func:`batch_norm_update`)."""
    name = 'batch_norm'
    x = x.contiguous()
    rm = rv = count = None
    if mean is None and running is not None:
        rm, rv, count = running
        if count.dtype != torch.int64 or count.numel() != 1 or count.device != x.device:
            raise ValueError('%s: the batch count must be one int64 on %s' % (name, x.device))
    _check_bn(name, x, gamma, beta, mean, var, rm, rv)
    act = _act_code(name, activation)
    c = x.shape[-1]
    p = x.numel() // c
    y = torch.empty_like(x)
    if p == 0:
        return y, mean, var
    xp, yp = x.data_ptr(), y.data_ptr()
    plan = bn_plan(p, c, (xp | yp) % 16 == 0, _sms(x.device))
    splits = plan['splits']
    if mean is None:
        # the chunks' partial statistics, then the mean and the variance
        stats = torch.empty((splits + 1) * 2 * c, device=x.device, dtype=torch.float32)
        mean, var = stats[:c], stats[c:2 * c]
        sp = stats.data_ptr()
        ptrs = (0, 0, sp + 8 * c, sp, sp + 4 * c) + (
            (0, 0, 0) if rm is None else (rm.data_ptr(), rv.data_ptr(), count.data_ptr()))
    else:
        ptrs = (mean.data_ptr(), var.data_ptr(), 0, 0, 0, 0, 0, 0)
    launch(name, _BN_ARGS.pack(
        xp, gamma.data_ptr(), beta.data_ptr(), *ptrs, yp, p, plan['chunk'], c, splits, eps,
        -1.0 if momentum is None else momentum, p / max(p - 1, 1), act, plan['vec'],
        plan['lanes']))
    return y, mean, var


def batch_norm_backward_cuda(g, x, gamma, mean, var, batch_stats=True, eps=_BN_EPS):
    """K30 ``bn_batch_norm_backward`` (counted as ``batch_norm_backward``):
    (dx, dgamma, dbeta), see :func:`batch_norm_backward_plain`."""
    name = 'batch_norm_backward'
    g, x = g.contiguous(), x.contiguous()
    _check_bn(name, x, gamma, mean, var)
    _check_bn(name, g)
    if g.shape != x.shape:
        raise ValueError('%s: g must be %s, got %s' % (name, tuple(x.shape), tuple(g.shape)))
    c = x.shape[-1]
    p = x.numel() // c
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, device=x.device, dtype=torch.float32)
    dbeta = torch.empty(c, device=x.device, dtype=torch.float32)
    if p == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    splits, chunk = _bn_split(p, c, x.device)
    part = torch.empty(splits * c * 2, device=x.device, dtype=torch.float32)
    launch('batch_norm', x.data_ptr(), g.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
           var.data_ptr(), part.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
           dx.data_ptr(), p, c, splits, chunk, eps, int(batch_stats),
           symbol='bn_batch_norm_backward')
    return dx, dgamma, dbeta


# ------------------------------------------- pooling and batch norm: dispatch


def max_pool2d_grad(x, g, ceil_mode=True):
    """Input gradient of the max pool (K27's backward on the card)."""
    fn = max_pool2d_grad_plain if _on_cpu(x, 'max_pool2d_grad') else max_pool2d_grad_cuda
    return fn(x, g, ceil_mode)


def max_unpool2d_grad(g, indices):
    """Input gradient of the unpool (K28's backward on the card)."""
    fn = max_unpool2d_grad_plain if _on_cpu(g, 'max_unpool2d_grad') else max_unpool2d_grad_cuda
    return fn(g, indices)


class _MaxPool2dFn(torch.autograd.Function):
    """Max pool + activation; backward in K27's gradient launcher."""

    @staticmethod
    def forward(ctx, x, ceil_mode, activation):
        fn = max_pool2d_plain if _on_cpu(x, 'max_pool2d') else max_pool2d_cuda
        y, idx = fn(x, ceil_mode, activation)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(x, y)
        ctx.args = (ceil_mode, activation)
        return y, idx

    @staticmethod
    def backward(ctx, gy, gidx):
        x, y = ctx.saved_tensors
        ceil_mode, activation = ctx.args
        g = _activation_grad(gy.contiguous(), y, activation)
        return max_pool2d_grad(x, g, ceil_mode), None, None


class _MaxUnpool2dFn(torch.autograd.Function):
    """Unpool; backward in K28's gather."""

    @staticmethod
    def forward(ctx, x, indices, out_hw):
        fn = max_unpool2d_plain if _on_cpu(x, 'max_unpool2d') else max_unpool2d_cuda
        ctx.save_for_backward(indices)
        return fn(x, indices, out_hw)

    @staticmethod
    def backward(ctx, g):
        indices, = ctx.saved_tensors
        return max_unpool2d_grad(g.contiguous(), indices), None, None


class _BatchNormFn(torch.autograd.Function):
    """Batch norm (+ running update) + activation; backward in K30."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, running, momentum, eps, activation):
        batch_stats = mean is None
        if _on_cpu(x, 'batch_norm'):
            if batch_stats:
                mean, var = batch_norm_stats_plain(x)
                if running is not None:
                    rm, rv, count = running
                    new_rm, new_rv = _running_update(rm, rv, count, mean, var,
                                                     x.numel() // x.shape[-1], momentum)
                    rm.copy_(new_rm)
                    rv.copy_(new_rv)
                    count.add_(1)
            y = batch_norm_plain(x, gamma, beta, mean, var, eps, activation)
        else:
            y, mean, var = batch_norm_cuda(x, gamma, beta, mean, var, running, momentum, eps,
                                           activation)
        ctx.save_for_backward(x, gamma, mean, var, y)
        ctx.args = (batch_stats, eps, activation)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, mean, var, y = ctx.saved_tensors
        batch_stats, eps, activation = ctx.args
        g = _activation_grad(gy.contiguous(), y, activation)
        fn = batch_norm_backward_plain if _on_cpu(x, 'batch_norm_backward') \
            else batch_norm_backward_cuda
        dx, dgamma, dbeta = fn(g, x, gamma, mean, var, batch_stats, eps)
        return dx, dgamma, dbeta, None, None, None, None, None, None


def max_pool2d_with_indices(x, ceil_mode=True, activation=None):
    """2x2 / stride-2 max pool returning values and flat indices (JAX:
    ops/conv.py:367 max_pool2d_with_indices; ``ceil_mode`` for 'same'
    archs, floor for 'valid').

    x: (N, H, W, C) float32. Returns (pooled (N, Ho, Wo, C), indices int32
    of the same shape: ``row * W + col`` of the first maximum of each window
    in the input plane). ``activation`` (None or 'leaky_relu') is applied to
    the pooled values after the pool, as the encoder applies it. The
    gradient splits each window's cotangent evenly among its tied maxima.
    """
    return _MaxPool2dFn.apply(x, bool(ceil_mode), activation)


def max_unpool2d(x, indices, out_hw):
    """Scatter pooled values back to ``out_hw`` at their flat indices (JAX:
    ops/conv.py:402 max_unpool2d); an index outside the output is dropped."""
    return _MaxUnpool2dFn.apply(x, indices, (int(out_hw[0]), int(out_hw[1])))


def batch_norm(x, gamma, beta, eps=_BN_EPS, mean=None, var=None, running=None, momentum=0.1,
               activation=None):
    """Batch normalization over all but the last axis (JAX: ops/conv.py:419
    batch_norm).

    With ``mean`` / ``var`` None the batch's statistics are used (train
    mode, and eval mode without running statistics); ``running`` =
    (running_mean, running_var, num_batches_tracked int64) are then updated
    in place as :func:`batch_norm_update` computes them, in the same call
    on the card (``momentum`` None: the cumulative average). Given ``mean``
    and ``var`` (eval mode with running statistics) are used as they are.
    ``activation`` (None or 'leaky_relu') follows the affine map.
    Differentiable in x, gamma and beta.
    """
    return _BatchNormFn.apply(x, gamma, beta, mean, var, running, momentum, float(eps),
                              activation)
