"""K1's, K2's and K4's launch plans (behavenet_tpu_torch.ops.conv conv_plan,
tconv_plan and gradw_plan) at every K1, K2 and K4 layer of the default arch
and of the max-pooling arch (the port's models/arch.py, 2-view 128 x 128
frames, the 192-frame bucket), also with each layer's Cout replaced by each
width of COUTS: the column tile covers Cout with at most 2x waste, the grid
covers every output exactly once, K4's chunks partition the output pixels
in order, and where the pixels allow, K4's grid fills two waves of the
H100's 132 SMs; K1's narrow kernel takes uint8 frames and Cin <= 4 and its
staged patch holds every input a tile reads; K29's split (bn_plan) covers
every row of every batch-norm layer; the planners' tables are the lists
the launchers dispatch to, K29's packed arguments are its launcher's
struct, and every header the kernels include is built from. Pure Python:
no kernel is built or launched, no JAX is imported.
"""

import os
import re

import numpy as np
import pytest

from behavenet_tpu_torch.kernels import build
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
    """(arch, label, kernel, args) of every K1, K2 and K4 launch of both
    archs: K1 forward (every conv; uint8 frames at the first) and as a
    transposed conv's grad-x (also of K3's layer); K2 forward (transposed
    convs that do not go to K3) and as a conv's grad-x (not of the uint8
    first layer); K4 as a conv's and a transposed conv's grad-w. args: K1
    (ci, co, k, s, out_hw, uint8), K2 (ci, co, k, s, out_hw), K4 (a, b, k,
    s, out_hw, uint8)."""
    out = []
    for name, hp in _archs().items():
        h, w, c = IMG[1], IMG[2], IMG[0]
        for i, co in enumerate(hp['ae_encoding_n_channels']):
            oh, ow = hp['ae_encoding_y_dim'][i], hp['ae_encoding_x_dim'][i]
            if hp['ae_encoding_layer_type'][i] == 'conv':
                k, s = hp['ae_encoding_kernel_size'][i], hp['ae_encoding_stride_size'][i]
                out.append((name, 'conv_%d' % i, 'K1', (c, co, k, s, (oh, ow), i == 0)))
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
                out.append((name, 'convt_%d.grad_x' % i, 'K1', (co, c, k, s, (h, w), False)))
                out.append((name, 'convt_%d' % i, 'K4', (co, c, k, s, (h, w), False)))
            h, w, c = oh, ow, co
    return out


LAYERS = _layers()


def _check_k1(ci, co, k, s, out_hw, uint8):
    plan = conv.conv_plan(BATCH, ci, co, k, s, out_hw, x_uint8=uint8)
    gx, gy, gz = plan['grid']
    oh, ow = out_hw
    bm, bn = plan['tile_m'], plan['tile_n']
    assert gz == 1 and gy * bn >= co and (gy - 1) * bn < co
    assert plan['kind'] == ('narrow' if uint8 or ci <= conv.CONV_NARROW_MAX_CIN else 'gemm')
    if plan['kind'] == 'narrow':
        rows, cols = conv.CONV_NARROW_ROWS, conv.CONV_NARROW_COLS
        assert bm == rows * cols and bn in conv.CONV_NARROW_COBS
        # the narrowest COB that holds Cout (32 at most: more blocks along y)
        assert bn == min([b for b in conv.CONV_NARROW_COBS if b >= co] or [32])
        # blockIdx.x = (n, tile row, tile column): every output pixel once
        assert gx == BATCH * -(-oh // rows) * -(-ow // cols)
        assert plan['threads'] == cols * (rows // 8) * (bn // 8) <= 1024
        # the patch holds the (rows - 1) * s + k rows and (cols - 1) * s + k
        # columns a tile reads, its columns grouped by phase: column x lies
        # at (x % s) * ceil(PW / s) + x // s, inside the pitch and distinct
        ph, pw, pitch = plan['patch']
        assert ph == (rows - 1) * s + k and pw == (cols - 1) * s + k
        cps = -(-pw // s)
        where = [(x % s) * cps + x // s for x in range(pw)]
        assert len(set(where)) == pw and max(where) < pitch == s * cps
        # a warp's 32 columns at one tap are 32 consecutive words
        for tx in range(k):
            at = [(lane * s + tx) % s * cps + (lane * s + tx) // s for lane in range(cols)]
            assert at == list(range(at[0], at[0] + cols))
    else:
        tile = [t for t in conv.CONV_TILES if t[:2] == (bm, bn)]
        assert len(tile) == 1 and plan['stages'] == tile[0][5] and not uint8
        # at most 2x waste, or the narrowest tile
        assert gy * bn <= max(2 * co, min(t[1] for t in conv.CONV_TILES))
        # the output pixels, in disjoint row tiles, none idle
        assert (gx - 1) * bm < BATCH * oh * ow <= gx * bm
        tm, tn = tile[0][2:4]
        assert plan['threads'] == (bm // tm) * (bn // tn)
    assert plan['smem'] <= conv.H100_SMEM_OPTIN


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
    assert plan['smem'] <= conv.H100_SMEM_OPTIN and plan['stages'] in (2, 3)


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
    assert plan['smem'] <= conv.H100_SMEM_OPTIN


def test_layers_of_both_archs():
    kinds = {}
    for name, label, kernel, args in LAYERS:
        {'K1': _check_k1, 'K2': _check_k2, 'K4': _check_k4}[kernel](*args)
        kinds.setdefault((name, kernel), []).append(label)
    # every arch has K1, K2 and K4 layers; the pooling arch's 2-channel
    # sigmoid layer is K2's narrow kernel's
    assert set(kinds) == {(a, k) for a in ('default', 'pool') for k in ('K1', 'K2', 'K4')}
    last = [args for name, label, kernel, args in LAYERS
            if name == 'pool' and kernel == 'K2' and label == 'convt_9'][0]
    assert conv.tconv_plan(BATCH, *last)['kind'] == 'narrow'
    # K1's narrow kernel takes each arch's first layer (uint8 frames) and the
    # grad-x of its last transposed conv (a 2-channel cotangent); its GEMM
    # every other layer
    for name in ('default', 'pool'):
        k1 = [(label, args) for a, label, kernel, args in LAYERS if a == name and kernel == 'K1']
        narrow = [label for label, args in k1
                  if conv.conv_plan(BATCH, *args[:5], x_uint8=args[5])['kind'] == 'narrow']
        assert narrow == [k1[0][0], k1[-1][0]] and k1[0][0] == 'conv_0'
        assert k1[-1][0].endswith('.grad_x') and k1[-1][1][0] == IMG[0]


@pytest.mark.parametrize('cout', COUTS)
def test_ragged_cout(cout):
    """Each layer's geometry with Cout (K2's output channels, K4's cotangent
    columns) replaced by ``cout``, and Cin too for K2 and K4."""
    for name, label, kernel, args in LAYERS:
        if kernel == 'K1':
            ci, co, k, s, hw, uint8 = args
            _check_k1(ci, cout, k, s, hw, uint8)
            _check_k1(cout, co, k, s, hw, uint8)
        elif kernel == 'K2':
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
    assert tiles['CONV_GEMM_TILES'] == conv.CONV_TILES and len(conv.CONV_TILES) >= 1
    assert tuple(t[0] for t in tiles['CONV_NARROW']) == conv.CONV_NARROW_COBS
    assert all(b % 8 == 0 for b in conv.CONV_NARROW_COBS)
    assert tiles['TCONV_GEMM_TILES'] == conv.TCONV_TILES and len(conv.TCONV_TILES) >= 1
    assert tiles['GRADW_PATCH_TILES'] == conv.GRADW_PATCH_TILES
    assert tiles['GRADW_GATHER_TILES'] == conv.GRADW_GATHER_TILES
    assert {(c, t) for c in conv.NARROW_COUTS for t in conv.NARROW_TAPS} == \
        set(tiles['TCONV_NARROW'])
    assert all(len(t) == 6 for t in conv.CONV_TILES + conv.TCONV_TILES +
               conv.GRADW_PATCH_TILES + conv.GRADW_GATHER_TILES)
    srcs = {}
    for fname in ('conv2d_nhwc.cu', 'conv_transpose2d_nhwc.cu', 'conv2d_grad_w_nhwc.cu'):
        with open(os.path.join(KERNELS, fname)) as f:
            srcs[fname] = f.read()
    for src, lists in ((srcs['conv2d_nhwc.cu'], ('CONV_GEMM_TILES', 'CONV_NARROW')),
                       (srcs['conv_transpose2d_nhwc.cu'], ('TCONV_GEMM_TILES', 'TCONV_NARROW')),
                       (srcs['conv2d_grad_w_nhwc.cu'],
                        ('GRADW_PATCH_TILES', 'GRADW_GATHER_TILES'))):
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


def test_conv_plan_refuses_a_patch_beyond_the_opt_in_limit():
    """The narrow kernel stages its whole patch: a kernel and stride whose
    patch and weights pass the opt-in limit the wrapper reads from the
    device (227 KB on the H100) are refused, not launched."""
    plan = conv.conv_plan(2, 2, 32, 5, 3, (4, 4), x_uint8=True)
    conv.conv_plan(2, 2, 32, 5, 3, (4, 4), x_uint8=True, smem_optin=plan['smem'])
    with pytest.raises(ValueError):
        conv.conv_plan(2, 2, 32, 5, 3, (4, 4), x_uint8=True, smem_optin=plan['smem'] - 1)
    with pytest.raises(ValueError):
        conv.conv_plan(2, 2, 32, 31, 4, (4, 4), x_uint8=True)


def _bn_layers():
    """(rows, channels) of every batch-norm layer of the pooling arch at the
    192-frame bucket (as chip_smoke.row6_shapes lists them) and of ragged
    widths."""
    hp = _archs()['pool']
    out = [(BATCH * hp['ae_encoding_y_dim'][i] * hp['ae_encoding_x_dim'][i], c)
           for i, c in enumerate(hp['ae_encoding_n_channels'])
           if hp['ae_encoding_layer_type'][i] == 'conv']
    last = len(hp['ae_decoding_layer_type']) - 1
    out += [(BATCH * hp['ae_decoding_y_dim'][i] * hp['ae_decoding_x_dim'][i],
             hp['ae_decoding_n_channels'][i])
            for i, t in enumerate(hp['ae_decoding_layer_type'])
            if t == 'convtranspose' and i < last]
    assert len(out) == 9
    return out + [(8 * 13 * 17, 3), (8 * 13 * 17, 33), (1, 1), (5, 2048), (3_145_728, 1)]


@pytest.mark.parametrize('p, c', _bn_layers())
@pytest.mark.parametrize('aligned', [True, False])
def test_bn_plan_covers_every_row(p, c, aligned):
    """K29's chunks partition the rows in order, its channel lanes cover
    every channel once (4 a lane with 16-byte accesses), each block has at
    most 256 threads and the grid at most BN_BLOCKS_PER_SM blocks an SM."""
    plan = conv.bn_plan(p, c, aligned, SMS)
    vec = plan['vec']
    assert vec == int(aligned and c % 4 == 0)
    width = c // 4 if vec else c
    lanes, rows, tiles = plan['lanes'], plan['rows'], plan['tiles']
    assert 1 <= lanes <= 256 and lanes * rows <= 256 and rows == 256 // lanes
    assert (tiles - 1) * lanes < width <= tiles * lanes
    splits, chunk = plan['splits'], plan['chunk']
    assert plan['grid'] == (splits, tiles)
    assert (splits - 1) * chunk < p <= splits * chunk
    bounds = [(z * chunk, min(p, (z + 1) * chunk)) for z in range(splits)]
    assert all(lo < hi for lo, hi in bounds)
    # the cooperative train launch: every block resident at once
    assert splits * tiles <= conv.BN_BLOCKS_PER_SM * SMS


def test_bn_args_match_the_launcher_struct():
    """K29's wrapper packs its arguments as kernels/batch_norm.cu's BnArgs
    lays them out: the same fields in the same order, padded to the size the
    source asserts (the launcher copies that many bytes)."""
    with open(os.path.join(KERNELS, 'batch_norm.cu')) as f:
        src = f.read()
    body = re.search(r'struct BnArgs \{(.*?)\};', src, re.S).group(1)
    codes = []
    for decl in body.split(';'):
        decl = decl.strip()
        if not decl:
            continue
        names = decl.split(',')
        kind = 'P' if '*' in decl else {'long long': 'q', 'int': 'i', 'float': 'f'}[
            re.match(r'(const )?(long long|int|float)', decl).group(2)]
        codes += [kind] * len(names)
    fmt = conv._BN_ARGS.format
    want = ''.join(c * int(n or 1) for n, c in re.findall(r'(\d*)([Pqif])', fmt))
    assert ''.join(codes) == want and fmt.startswith('@')
    size = re.search(r'static_assert\(sizeof\(BnArgs\) == (\d+)', src)
    assert size and conv._BN_ARGS.size == int(size.group(1))


def test_headers_are_the_kernels_includes():
    """The first implicit-GEMM core (igemm.cuh) is gone; every header in
    build._HEADERS exists, and every header a source includes is one of them
    (so an edited header rebuilds the libraries)."""
    assert not os.path.exists(os.path.join(KERNELS, 'igemm.cuh'))
    assert 'igemm.cuh' not in build._HEADERS
    for h in build._HEADERS:
        assert os.path.isfile(os.path.join(KERNELS, h)), h
    included = set()
    for fname in os.listdir(KERNELS):
        if fname.endswith(('.cu', '.cuh', '.h')):
            with open(os.path.join(KERNELS, fname)) as f:
                included |= set(re.findall(r'#include "([^"]+)"', f.read()))
    assert included and included <= set(build._HEADERS)
