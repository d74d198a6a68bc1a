"""Port ops (behavenet_tpu_torch.ops.conv) against behavenet_tpu.ops.conv.

On CPU tensors the dispatchers run their plain PyTorch versions, which are
the references the CUDA kernels are held against on the card. The JAX
references run jitted, compiled at LLVM optimization level 0 (a fraction
of the eager ops' compile time). Tolerance: float32, atol 1e-5 and rtol
1e-5 (both sides sum the same products in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from behavenet_tpu.ops import conv as jops
from behavenet_tpu_torch.ops import conv as tops
from tests.jax_low import jit_low

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, **TOL)


@pytest.mark.parametrize('shape,co,k,s,pad_y,pad_x', [
    ((2, 13, 17, 3), 8, 5, 2, (1, 2), (2, 1)),    # asymmetric pads
    ((3, 16, 16, 4), 6, 3, 1, (0, 0), (0, 0)),
    ((3, 16, 16, 4), 6, 3, 2, (2, 2), (2, 2)),
    ((2, 16, 12, 1), 8, 5, 2, (1, 2), (1, 2)),    # enc1, 1 view
    ((2, 16, 16, 2), 4, 5, 2, (2, 1), (1, 2)),    # enc1, 2 views
    ((2, 8, 8, 6), 5, 5, 5, (1, 1), (1, 1)),      # the default arch's stride 5
])
def test_conv2d_plain(shape, co, k, s, pad_y, pad_x):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(k, k, shape[-1], co).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    ref, ref_act = jit_low(lambda a, c, d: (lambda y: (y, jops.leaky_relu(y)))(
        jops.conv2d(a, c, d, s, pad_y, pad_x)), x, w, b)
    out = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      s, pad_y, pad_x)
    _close(out, ref)
    act = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      s, pad_y, pad_x, activation='leaky_relu')
    _close(act, ref_act)


@pytest.mark.parametrize('ci', [1, 2])
def test_conv2d_uint8_frames(ci):
    """uint8 input is normalized as x / 255, as the JAX serving heads do."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (2, 16, 12, ci)).astype(np.uint8)
    w = rng.randn(5, 5, ci, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    ref = jit_low(lambda a, c, d: jops.conv2d(a.astype(jnp.float32) / 255.0, c, d, 2, (1, 2),
                                           (1, 2)), x, w, b)
    out = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      2, (1, 2), (1, 2))
    _close(out, ref)


@pytest.mark.parametrize('k,s,pad_y,pad_x,out_pad', [
    (5, 2, (2, 2), (2, 2), (1, 1)),
    (5, 1, (0, 0), (0, 0), (0, 0)),
    (5, 3, (1, 1), (1, 1), (2, 2)),
    (5, 2, (2, 1), (1, 2), (0, 0)),   # asymmetric 'same' crop
    (5, 5, (1, 1), (1, 1), (0, 0)),   # the default arch's stride 5
    (5, 2, (0, 0), (0, 0), (1, 0)),   # 'valid' arch output padding
])
def test_conv_transpose2d_plain(k, s, pad_y, pad_x, out_pad):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 5, 8).astype(np.float32)
    w = rng.randn(k, k, 8, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    ref = jit_low(lambda a, c, d: jops.conv_transpose2d(a, c, d, s, pad_y, pad_x, out_pad),
               x, w, b)
    out = tops.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), s, pad_y, pad_x, out_pad)
    _close(out, ref)


@pytest.mark.parametrize('k,s,pads,out_pad,block', [
    (5, 2, ((1, 2), (2, 1)), 0, 2),
    (5, 2, ((1, 2), (1, 2)), 0, 4),
    (5, 2, ((1, 2), (1, 2)), 0, 8),   # the default arch's final layer
    (5, 5, ((1, 2), (1, 2)), 0, 5),
    (3, 2, ((0, 0), (0, 0)), 1, 2),
])
def test_final_layer_matches_subpixel(k, s, pads, out_pad, block):
    """The final layer (JAX: _subpixel_fwd, block=F) with its sigmoid."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 8, 6).astype(np.float32)
    w = rng.randn(k, k, 6, 2).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    ref = jit_low(lambda a, c, d: jops.conv_transpose2d(a, c, d, s, pads[0], pads[1],
                                                     (out_pad, out_pad), block=block), x, w, b)
    out = tops.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), s, pads[0], pads[1],
                                (out_pad, out_pad), block=block, activation='sigmoid')
    _close(out, 1.0 / (1.0 + np.exp(-np.asarray(ref, np.float64))))


def test_space_depth_roundtrip():
    x = np.random.RandomState(3).randn(2, 8, 12, 3).astype(np.float32)
    s2d = tops.space_to_depth(torch.from_numpy(x), 4)
    _close(s2d, jops.space_to_depth(jnp.asarray(x), 4))
    _close(tops.depth_to_space(s2d, 4), x)


def test_cpu_runs_plain_path_and_counts_no_launch():
    before = dict(tops.LAUNCHES)
    x = torch.zeros(1, 8, 8, 2)
    tops.conv2d(x, torch.zeros(5, 5, 2, 4), None, 2, (1, 2), (1, 2))
    tops.conv_transpose2d(torch.zeros(1, 4, 4, 4), torch.zeros(5, 5, 4, 2), None,
                          2, (1, 2), (1, 2), block=8)
    assert tops.LAUNCHES == before


@pytest.mark.parametrize('fn', ['conv2d_cuda', 'conv_transpose2d_cuda'])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version."""
    with pytest.raises(ValueError, match='CUDA'):
        getattr(tops, fn)(torch.zeros(1, 8, 8, 2), torch.zeros(5, 5, 2, 2), None,
                          2, (1, 2), (1, 2))
