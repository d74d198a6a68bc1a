"""K2's and K4's launch plans (behavenet_tpu_torch.ops.conv tconv_plan and
gradw_plan) at every K2 and K4 layer of the default arch and of the
max-pooling arch (the port's models/arch.py, 2-view 128 x 128 frames, the
192-frame bucket), also with each layer's Cout replaced by each width of
COUTS: the column tile covers Cout with at most 2x waste, the grid covers
every output exactly once, K4's chunks partition the output pixels in
order, and where the pixels allow, K4's grid fills two waves of the H100's
132 SMs; and the planners' tables are the lists the launchers dispatch to.
Pure Python: no kernel is built or launched, no JAX is imported.
"""

import os

import numpy as np
import pytest

from behavenet_tpu_torch.models import arch
from behavenet_tpu_torch.ops import conv

BATCH = 192
IMG = [2, 128, 128]
COUTS = (1, 2, 3, 5, 33, 65, 130)
SMS = 132
KERNELS = os.path.join(os.path.dirname(__file__), '..', 'behavenet_tpu_torch', 'kernels')
POOL_ARCH = {
    'ae_network_type': 'max_pooling', 'ae_padding_type': 'same', 'ae_batch_norm': 1,
    'ae_batch_norm_momentum': None, 'symmetric_arch': 1,
    'ae_encoding_n_channels': [32, 32, 64, 64, 128, 128, 256, 256, 512, 512],
    'ae_encoding_kernel_size': [5, 2] * 5, 'ae_encoding_stride_size': [1, 2] * 5,
    'ae_encoding_layer_type': ['conv', 'maxpool'] * 5, 'ae_decoding_last_FF_layer': 0}


def _archs():
    default = arch.load_handcrafted_arch(list(IMG), 12, None, check_memory=False)
    pool = arch.get_handcrafted_dims(dict(POOL_ARCH, ae_input_dim=list(IMG), n_ae_latents=12),
                                     symmetric=True)
    return {'default': default, 'pool': pool}


def _layers():
    """(arch, label, kernel, args) of every K2 and K4 launch of both archs:
    K2 forward (transposed convs that do not go to K3) and as a conv's
    grad-x (not of the uint8 first layer); K4 as a conv's and a transposed
    conv's grad-w. args: K2 (ci, co, k, s, out_hw), K4 (a, b, k, s, out_hw,
    uint8)."""
    out = []
    for name, hp in _archs().items():
        h, w, c = IMG[1], IMG[2], IMG[0]
        for i, co in enumerate(hp['ae_encoding_n_channels']):
            oh, ow = hp['ae_encoding_y_dim'][i], hp['ae_encoding_x_dim'][i]
            if hp['ae_encoding_layer_type'][i] == 'conv':
                k, s = hp['ae_encoding_kernel_size'][i], hp['ae_encoding_stride_size'][i]
                out.append((name, 'conv_%d' % i, 'K4', (c, co, k, s, (oh, ow), i == 0)))
                if i:
                    out.append((name, 'conv_%d.grad_x' % i, 'K2', (co, c, k, s, (h, w))))
            h, w, c = oh, ow, co
        c, h, w = hp['ae_decoding_starting_dim']
        last = len(hp['ae_decoding_n_channels']) - 1
        for i, co in enumerate(hp['ae_decoding_n_channels']):
            oh, ow = hp['ae_decoding_y_dim'][i], hp['ae_decoding_x_dim'][i]
            if hp['ae_decoding_layer_type'][i] == 'convtranspose':
                k, s = hp['ae_decoding_kernel_size'][i], hp['ae_decoding_stride_size'][i]
                if not (i == last and s > 1 and co <= 4):   # K3's layer
                    out.append((name, 'convt_%d' % i, 'K2', (c, co, k, s, (oh, ow))))
                out.append((name, 'convt_%d' % i, 'K4', (co, c, k, s, (h, w), False)))
            h, w, c = oh, ow, co
    return out


LAYERS = _layers()


def _check_k2(ci, co, k, s, out_hw):
    plan = conv.tconv_plan(BATCH, ci, co, k, s, out_hw)
    gx, gy, gz = plan['grid']
    oh, ow = out_hw
    assert gz == s * s
    # the phases (oy % s, ox % s) partition the output pixels
    phases = [(-(-(oh - ry) // s), -(-(ow - rx) // s)) for ry in range(min(s, oh))
              for rx in range(min(s, ow))]
    assert sum(qh * qw for qh, qw in phases) == oh * ow
    qh0, qw0 = max(q for q, _ in phases), max(q for _, q in phases)
    if plan['kind'] == 'narrow':
        assert plan['tile_n'] in conv.NARROW_COUTS and gy == 1
        assert co <= plan['tile_n'] <= 2 * co
        assert plan['taps'] == max(-(-k // s), 2) and plan['taps'] in conv.NARROW_TAPS
        ty, tx = -(-qh0 // conv.NARROW_ROWS), -(-qw0 // conv.NARROW_COLS)
        # blockIdx.x = (n, tile row, tile column): each phase plane's
        # tiles are disjoint and cover it, and no block is left idle
        assert gx == BATCH * ty * tx
        assert plan['tile_m'] == conv.NARROW_ROWS * conv.NARROW_COLS
    else:
        bm, bn = plan['tile_m'], plan['tile_n']
        tile = [t for t in conv.TCONV_TILES if t[:2] == (bm, bn)]
        assert len(tile) == 1 and plan['stages'] == tile[0][5]
        assert gy * bn >= co and (gy - 1) * bn < co and gy * bn <= 2 * co
        # the largest phase's pixels, in disjoint row tiles, none idle
        assert (gx - 1) * bm < BATCH * qh0 * qw0 <= gx * bm
        tm, tn = tile[0][2:4]
        assert plan['threads'] == (bm // tm) * (bn // tn)
    assert plan['smem'] <= 227 * 1024 and plan['stages'] in (2, 3)


def _patch_steps(plan, n, oh, ow):
    """The output pixel index of each (step, pixel) of the patch kernel's
    steps, -1 past the output (as the kernel's tables compute it)."""
    rows, cols = plan['step_rows'], plan['step_cols']
    col_blocks = -(-ow // cols)
    t = np.arange(-(-(n * oh) // rows) * col_blocks)[:, None]
    k = np.arange(rows * cols)[None, :]
    gr = (t // col_blocks) * rows + k // cols
    ox = (t % col_blocks) * cols + k % cols
    return np.where((gr < n * oh) & (ox < ow), gr * ow + ox, -1)


def _check_k4(a, b, k, s, out_hw, uint8):
    plan = conv.gradw_plan(BATCH, a, b, k, s, out_hw, x_uint8=uint8)
    gx, gy, gz = plan['grid']
    bm, bn = plan['tile_m'], plan['tile_n']
    oh, ow = out_hw
    m, p = k * k * a, BATCH * oh * ow
    assert gy * bn >= b and (gy - 1) * bn < b and gy * bn <= 2 * b
    patch = not uint8 and a % 4 == 0 and b % 4 == 0 and b >= 32
    assert plan['kind'] == ('patch' if patch else 'gather')
    if plan['kind'] == 'patch':
        tile = [t for t in conv.GRADW_PATCH_TILES if t[:2] == (bm, bn)]
        assert len(tile) == 1 and plan['stages'] in (2, tile[0][5])
        tm, tn = tile[0][2:4]
        assert plan['threads'] == (bm // tm) * (bn // tn)
        assert (gx - 1) * bm < m <= gx * bm
        # the (slab, tap) fours of each row tile touch at most patch_slabs slabs
        q0 = np.arange(gx) * (bm // 4)
        last = np.minimum(q0 + bm // 4, m // 4) - 1
        assert (last // (k * k) - q0 // (k * k) + 1).max() <= plan['patch_slabs']
        rows, cols = plan['step_rows'], plan['step_cols']
        assert rows * cols == conv.PATCH_STEP and cols & (cols - 1) == 0
        assert cols == 8 or cols // 2 < ow <= cols
        steps = plan['steps']
        assert steps == -(-(BATCH * oh) // rows) * -(-ow // cols)
        # the steps cover every output pixel once (checked on 3 frames: the
        # steps' shape does not depend on the frame count)
        small = conv.gradw_plan(3, a, b, k, s, out_hw)
        assert (small['step_rows'], small['step_cols']) == (rows, cols)
        pix = _patch_steps(small, 3, oh, ow)
        assert np.array_equal(np.sort(pix[pix >= 0]), np.arange(3 * oh * ow))
        # every step's patch rows fit the planned patch
        s1 = min(s, k)
        gr0 = np.arange(-(-(BATCH * oh) // rows)) * rows
        used = (rows - 1) * s1 + ((gr0 + rows - 1) // oh - gr0 // oh) * (k - s1) + k
        assert used.max() <= plan['patch_rows']
        assert plan['patch_cols'] == (cols - 1) * s + k
    else:
        tiles = [t for t in conv.GRADW_GATHER_TILES if t[:2] == (bm, bn)]
        assert len(tiles) == 1 and plan['stages'] == tiles[0][5]
        bk = tiles[0][4]
        assert (gx - 1) * bm < m <= gx * bm
        assert plan['chunk'] % bk == 0 and plan['steps'] == -(-p // bk)
        steps = -(-p // bk)
    # the chunks partition the steps (the gather kernel's: [0, P)) in order
    chunk = plan['chunk'] // (1 if plan['kind'] == 'patch' else plan['bk'])
    total = steps if plan['kind'] == 'patch' else p
    unit = 1 if plan['kind'] == 'patch' else plan['bk']
    assert gz == plan['splits']
    bounds = [(z * chunk * unit, min(total, (z + 1) * chunk * unit)) for z in range(gz)]
    assert bounds[0][0] == 0 and bounds[-1][1] == total
    assert all(lo < hi for lo, hi in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(gz - 1))
    # two waves of blocks wherever chunks of 8 steps allow them
    if gx * gy * -(-steps // 8) >= 2 * SMS:
        assert gx * gy * gz >= 2 * SMS
    assert plan['smem'] <= 227 * 1024


def test_layers_of_both_archs():
    kinds = {}
    for name, label, kernel, args in LAYERS:
        (_check_k2 if kernel == 'K2' else _check_k4)(*args)
        kinds.setdefault((name, kernel), []).append(label)
    # every arch has K2 and K4 layers; the pooling arch's 2-channel sigmoid
    # layer is the narrow kernel's
    assert set(kinds) == {(a, k) for a in ('default', 'pool') for k in ('K2', 'K4')}
    last = [args for name, label, kernel, args in LAYERS
            if name == 'pool' and kernel == 'K2' and label == 'convt_9'][0]
    assert conv.tconv_plan(BATCH, *last)['kind'] == 'narrow'


@pytest.mark.parametrize('cout', COUTS)
def test_ragged_cout(cout):
    """Each layer's geometry with Cout (K2's output channels, K4's cotangent
    columns) replaced by ``cout``, and Cin too for K2 and K4."""
    for name, label, kernel, args in LAYERS:
        if kernel == 'K2':
            ci, co, k, s, hw = args
            _check_k2(ci, cout, k, s, hw)
            _check_k2(cout, co, k, s, hw)
        else:
            a, b, k, s, hw, uint8 = args
            _check_k4(a, cout, k, s, hw, uint8)
            _check_k4(cout, b, k, s, hw, uint8)


def test_plans_name_instances_the_launchers_build():
    """The planners' tables are conv_tiles.h's lists, and each launcher
    dispatches through its list (no instance list of its own)."""
    tiles = conv.conv_tiles()
    assert tiles['TCONV_GEMM_TILES'] == conv.TCONV_TILES and len(conv.TCONV_TILES) >= 1
    assert tiles['GRADW_PATCH_TILES'] == conv.GRADW_PATCH_TILES
    assert tiles['GRADW_GATHER_TILES'] == conv.GRADW_GATHER_TILES
    assert {(c, t) for c in conv.NARROW_COUTS for t in conv.NARROW_TAPS} == \
        set(tiles['TCONV_NARROW'])
    assert all(len(t) == 6 for t in
               conv.TCONV_TILES + conv.GRADW_PATCH_TILES + conv.GRADW_GATHER_TILES)
    with open(os.path.join(KERNELS, 'conv_transpose2d_nhwc.cu')) as f:
        k2 = f.read()
    with open(os.path.join(KERNELS, 'conv2d_grad_w_nhwc.cu')) as f:
        k4 = f.read()
    for src, lists in ((k2, ('TCONV_GEMM_TILES', 'TCONV_NARROW')),
                       (k4, ('GRADW_PATCH_TILES', 'GRADW_GATHER_TILES'))):
        assert '#include "conv_tiles.h"' in src
        for name in lists:
            assert src.count('BN_%s(BN_' % name) == 1


def test_gradw_plan_refuses_row_codes_out_of_range():
    """The gather kernel packs a row's channel into 15 bits and its taps
    into 8: wider inputs and kernels are refused, not wrapped."""
    conv.gradw_plan(2, 2 ** 15 - 1, 3, 3, 1, (4, 4), x_uint8=True)
    conv.gradw_plan(2, 3, 3, 255, 1, (4, 4))
    with pytest.raises(ValueError):
        conv.gradw_plan(2, 2 ** 15, 3, 3, 1, (4, 4))
    with pytest.raises(ValueError):
        conv.gradw_plan(2, 3, 3, 256, 1, (4, 4))
