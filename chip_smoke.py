#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``behavenet_tpu_torch``).

    python3 chip_smoke.py

On one CUDA GPU (an H100: the kernels are built for sm_90a) it

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from the sources in this checkout;
3. holds each kernel against its plain PyTorch version at the shapes the
   two main paths give it, and times the kernel, the plain version and the
   one PyTorch call that computes the same function (TF32 off for every
   float32 reference), on the published default conv AE (Whiteway et al
   2021) and the reference's 2-view 128x128 frames:
   - the forward convs (K1-K3) at the 189-frame trial batch;
   - the backward of every layer at the train step's 192-frame bucket:
     grad-w in K4, grad-x in K2 (of a conv) or K1 (of a transposed conv);
   - the masked MSE's forward and backward (K5) and one AMSGrad step over
     the whole model (K6);
4. serving (main path 1): writes a fitted-version directory, serves
   ``encode`` and ``reconstruct`` requests of 1, 189 and 1024 uint8 frames
   through ``serving.load_version`` on the card, checks every answer against
   the plain path on the card, shows from the launch counts that the
   requests ran through K1-K3, and times each request and its plain twin;
5. training (main path 2): runs ``fitting.training.fit`` on the card for an
   eval epoch and one train epoch over 189-frame trials from an in-memory
   trial source, checks that every logged loss is finite and that the
   train loss fell, that ``best_val_model.pt`` serves through
   ``serving.load_version``, that one step's gradients match the plain
   path's on the card, shows that K1-K6 all ran inside ``fit``, times a
   train step beside the plain one (cuDNN autograd + torch's fused AMSGrad),
   and profiles five steps (``torch.profiler``: device time per kernel and
   the device's idle share).

Each phase prints one JSON line; the line before the last lists the kernels
with their numbers, and the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. Any failure exits non-zero.
"""

import csv
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

IMG = (2, 128, 128)          # (views, height, width) of the 2-view Musall trial
N_LATENTS = 12
TRIAL = 189                  # frames in one trial: the kernel-check batch
BUCKET = 192                 # the trial padded to the trainer's 32-frame bucket
REQUEST_SIZES = (1, 189, 1024)
TRAIN_TRIALS = 20            # in-memory trials: 16 train, 2 val, 2 test
LEARNING_RATE = 1e-4         # configs/ae_jsons/ae_training.json
L2_REG = 1e-5                # nonzero (ae_model.json has 0) so K6's L2 term runs
SEED = 0
DEVICE = 'cuda'

# H100 SXM published peaks (NVIDIA's data sheet, dense): float32
# outside the tensor cores, which is what the kernels use, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version, float32 on both sides, different summation order
# (up to 6400 products per output): max |d| <= ABS_TOL * max(1, max|plain|)
# and max |d| / (|plain| + REL_FLOOR) <= REL_TOL.
ABS_TOL, REL_TOL, REL_FLOOR = 1e-4, 1e-3, 1e-2
# Gradients contract over up to 786k products (grad-w of conv_0), so the
# relative floor scales with the output: max |d| / (|plain| + REL_FLOOR *
# max(1, max|plain|)) <= REL_TOL, beside the same absolute bound.
# A served answer vs the plain path on the card, after ten layers.
SERVE_ABS_TOL = 1e-4
# K5's loss vs plain: relative (two-pass float32 sums in another order).
LOSS_REL_TOL = 1e-5
# K6 vs the plain recursion: the step p_new - p_old within 1e-3 of the
# largest step, the moments within 1e-5 of their largest value.
STEP_REL_TOL, STATE_REL_TOL = 1e-3, 1e-5
# One train step's gradients, kernels vs the plain path on the card.
GRAD_REL_TOL = 1e-3

KERNELS = {
    'conv2d_nhwc': ('behavenet_tpu_torch/kernels/conv2d_nhwc.cu',
                    'behavenet_tpu/ops/conv.py:43'),
    'conv_transpose2d_nhwc': ('behavenet_tpu_torch/kernels/conv_transpose2d_nhwc.cu',
                              'behavenet_tpu/ops/conv.py:195'),
    'conv_transpose2d_smallcout_sigmoid': (
        'behavenet_tpu_torch/kernels/conv_transpose2d_smallcout_sigmoid.cu',
        'behavenet_tpu/ops/conv.py:310'),
    'conv2d_grad_w_nhwc': ('behavenet_tpu_torch/kernels/conv2d_grad_w_nhwc.cu',
                           'behavenet_tpu/ops/conv.py:110'),
    'masked_mse': ('behavenet_tpu_torch/kernels/masked_mse.cu',
                   'behavenet_tpu/ops/losses.py:25'),
    'amsgrad_step': ('behavenet_tpu_torch/kernels/amsgrad_step.cu',
                     'behavenet_tpu/ops/optim.py:32'),
}

# the kernels a served request runs (the train step runs all six)
SERVE_KERNELS = ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'conv_transpose2d_smallcout_sigmoid')


def emit(obj):
    print(json.dumps(obj), flush=True)


def import_port():
    """The port from this checkout, never from another installation."""
    sys.path.insert(0, HERE)
    import behavenet_tpu_torch
    if not os.path.abspath(behavenet_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit('behavenet_tpu_torch was imported from %s, not from '
                         'this checkout' % behavenet_tpu_torch.__file__)
    from behavenet_tpu_torch import serving
    from behavenet_tpu_torch.fitting import experiment, training
    from behavenet_tpu_torch.kernels import build
    from behavenet_tpu_torch.models import aes, arch, base
    from behavenet_tpu_torch.ops import conv as ops
    from behavenet_tpu_torch.ops import losses, optim
    from behavenet_tpu_torch.utils import weights
    return types.SimpleNamespace(
        serving=serving, build=build, arch=arch, base=base, ops=ops, aes=aes,
        losses=losses, optim=optim, training=training, experiment=experiment,
        weights=weights)


def median_ms(fn, samples=5, inner=10, warmup=3):
    """Device time of one call of ``fn``: CUDA events around ``inner``
    back-to-back calls, divided by ``inner``; the median of ``samples``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def request_ms(fn, reps=10, warmup=3):
    """Latency of one request: host clock from the call to the device's
    end of its work (``synchronize``); the median of ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def taps_per_dim(n_out, n_in, k, s, p0, transposed):
    """(output position, tap) pairs that read an input inside the image."""
    count = 0
    for o in range(n_out):
        for t in range(k):
            if transposed:
                q, r = divmod(o + p0 - t, s)
                count += r == 0 and 0 <= q < n_in
            else:
                count += 0 <= o * s - p0 + t < n_in
    return count


def layer_macs(L, oh, ow, transposed):
    """Multiply-adds of a layer (and of each of its gradients): the
    (output pixel, tap) pairs that land in the image, times Cin x Cout."""
    return L['n'] * L['ci'] * L['co'] \
        * taps_per_dim(oh, L['h'], L['k'], L['s'], L['pad_y'][0], transposed) \
        * taps_per_dim(ow, L['w'], L['k'], L['s'], L['pad_x'][0], transposed)


def errors(out_k, out_p, scaled_floor=False):
    """(max abs err, abs tol, max rel err, finite) of a kernel's output
    against its plain version."""
    d = (out_k - out_p).abs()
    scale = out_p.abs().max().item()
    floor = REL_FLOOR * max(1.0, scale) if scaled_floor else REL_FLOOR
    return (d.max().item(), ABS_TOL * max(1.0, scale),
            (d / (out_p.abs() + floor)).max().item(),
            bool(torch.isfinite(out_k).all().item()))


def layer_shapes(hp, n):
    """One entry per conv layer of the default AE at batch ``n``."""
    layers = []
    h, w = IMG[1], IMG[2]
    c = IMG[0]
    for i, co in enumerate(hp['ae_encoding_n_channels']):
        layers.append(dict(
            layer='conv_%d' % i, kernel='conv2d_nhwc', n=n, h=h, w=w, ci=c, co=co,
            k=hp['ae_encoding_kernel_size'][i], s=hp['ae_encoding_stride_size'][i],
            pad_y=tuple(hp['ae_encoding_y_padding'][i]),
            pad_x=tuple(hp['ae_encoding_x_padding'][i]), out_pad=(0, 0),
            act='leaky_relu', uint8=i == 0))
        h, w, c = hp['ae_encoding_y_dim'][i], hp['ae_encoding_x_dim'][i], co
    c, h, w = hp['ae_decoding_starting_dim']
    last = len(hp['ae_decoding_n_channels']) - 1
    for i, co in enumerate(hp['ae_decoding_n_channels']):
        layers.append(dict(
            layer='convt_%d' % i,
            kernel='conv_transpose2d_smallcout_sigmoid' if i == last
            else 'conv_transpose2d_nhwc', n=n, h=h, w=w, ci=c, co=co,
            k=hp['ae_decoding_kernel_size'][i], s=hp['ae_decoding_stride_size'][i],
            pad_y=tuple(hp['ae_decoding_y_padding'][i]),
            pad_x=tuple(hp['ae_decoding_x_padding'][i]), out_pad=(0, 0),
            act='sigmoid' if i == last else 'leaky_relu', uint8=False))
        h, w, c = hp['ae_decoding_y_dim'][i], hp['ae_decoding_x_dim'][i], co
    return layers


def check_layer(L, ops, gen):
    """Kernel vs plain version (and the cuDNN call) at one layer shape."""
    dev = DEVICE
    transposed = L['kernel'] != 'conv2d_nhwc'
    fan_in = (L['co'] if transposed else L['ci']) * L['k'] ** 2
    bound = 1.0 / fan_in ** 0.5
    shape = (L['n'], L['h'], L['w'], L['ci'])
    if L['uint8']:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    else:
        x = torch.randn(shape, device=dev, generator=gen)
    w = (torch.rand((L['k'], L['k'], L['ci'], L['co']), device=dev, generator=gen)
         * 2 - 1) * bound
    b = (torch.rand((L['co'],), device=dev, generator=gen) * 2 - 1) * bound
    s, py, px, op, act = L['s'], L['pad_y'], L['pad_x'], L['out_pad'], L['act']

    if transposed:
        def kernel():
            return ops.conv_transpose2d_cuda(
                x, w, b, s, py, px, op, act,
                small_cout=L['kernel'] == 'conv_transpose2d_smallcout_sigmoid')

        def plain():
            return ops.conv_transpose2d_plain(x, w, b, s, py, px, op, act)
        # cuDNN at the symmetric pad p_before: the wanted output plus, for an
        # asymmetric pad, one more row and column
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)

        def library():
            return F.conv_transpose2d(xl, wl, b, stride=s, padding=(py[0], px[0]))
        oh, ow = ops.conv_transpose_out_hw(L['h'], L['w'], L['k'], s, py, px, op)
    else:
        def kernel():
            return ops.conv2d_cuda(x, w, b, s, py, px, act)

        def plain():
            return ops.conv2d_plain(x, w, b, s, py, px, act)
        # cuDNN on the already padded (and, for frames, normalized) input
        xl = F.pad((x.float() / 255.0 if L['uint8'] else x).permute(0, 3, 1, 2),
                   [px[0], px[1], py[0], py[1]])
        xl = xl.contiguous(memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def library():
            return F.conv2d(xl, wl, b, stride=s)
        oh, ow = ops.conv_out_hw(L['h'], L['w'], L['k'], s, py, px)

    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or out_k.shape != (L['n'], oh, ow, L['co']):
        raise AssertionError('%s: kernel shape %s, plain %s'
                             % (L['layer'], tuple(out_k.shape), tuple(out_p.shape)))
    max_abs, abs_tol, max_rel, finite = errors(out_k, out_p)
    del out_k, out_p

    macs = layer_macs(L, oh, ow, transposed)
    nbytes = x.numel() * x.element_size() + 4 * (w.numel() + b.numel()) \
        + 4 * L['n'] * oh * ow * L['co']
    t_ops = 2 * macs / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(
        phase='kernel_check', layer=L['layer'], kernel=L['kernel'], frames=L['n'],
        input=list(x.shape), input_dtype=str(x.dtype).replace('torch.', ''),
        output=[L['n'], oh, ow, L['co']], k=L['k'], stride=s, pad_y=py, pad_x=px,
        max_abs_err=max_abs, abs_tol=abs_tol, max_rel_err=max_rel, rel_tol=REL_TOL,
        gflop=2 * macs / 1e9, mbytes=nbytes / 1e6,
        ms=median_ms(kernel), plain_ms=median_ms(plain), library_ms=median_ms(library),
        bound_ms=max(t_ops, t_bytes), t_ops_ms=t_ops, t_bytes_ms=t_bytes,
        bound_by='operations' if t_ops >= t_bytes else 'bytes')
    emit(rec)
    if not finite or max_abs > abs_tol or max_rel > REL_TOL:
        raise AssertionError('%s: kernel disagrees with its plain version '
                             '(finite=%s, max abs %.3g > %.3g or max rel %.3g > %.3g)'
                             % (L['layer'], finite, max_abs, abs_tol, max_rel, REL_TOL))
    return rec


def random_params(hp, rs):
    """A JAX-layout params pytree (HWIO kernels, (in, out) dense weights) at
    torch's default init scale U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    def u(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    enc, dec = {}, {}
    c = hp['ae_input_dim'][0]
    for i, co in enumerate(hp['ae_encoding_n_channels']):
        k = hp['ae_encoding_kernel_size'][i]
        enc['conv_%d' % i] = {'w': u((k, k, c, co), c * k * k), 'b': u((co,), c * k * k)}
        c = co
    fc_in = c * hp['ae_encoding_y_dim'][-1] * hp['ae_encoding_x_dim'][-1]
    enc['fc'] = {'w': u((fc_in, N_LATENTS), fc_in), 'b': u((N_LATENTS,), fc_in)}
    start = int(np.prod(hp['ae_decoding_starting_dim']))
    dec['fc'] = {'w': u((N_LATENTS, start), N_LATENTS), 'b': u((start,), N_LATENTS)}
    c = hp['ae_decoding_starting_dim'][0]
    for i, co in enumerate(hp['ae_decoding_n_channels']):
        k = hp['ae_decoding_kernel_size'][i]
        dec['convt_%d' % i] = {'w': u((k, k, c, co), co * k * k),
                               'b': u((co,), co * k * k)}
        c = co
    return {'encoder': enc, 'decoder': dec}


def plain_forward(model, ops, frames, decode=True):
    """The model's forward through the plain PyTorch versions only:
    (reconstruction or None, latents)."""
    x = frames
    for layer in model.encoding.encoder.values():
        x = ops.conv2d_plain(x, layer.weight.permute(2, 3, 1, 0), layer.bias,
                             layer.stride, layer.pad_y, layer.pad_x, layer.activation)
    z = model.encoding.FF(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))
    if not decode:
        return None, z
    c, h, w = model.decoding.starting_dim
    y = model.decoding.FF(z).reshape(z.shape[0], c, h, w).permute(0, 2, 3, 1)
    for layer in model.decoding.decoder.values():
        y = ops.conv_transpose2d_plain(
            y, layer.weight.permute(2, 3, 0, 1), layer.bias, layer.stride,
            layer.pad_y, layer.pad_x, layer.out_pad, layer.activation)
    return y, z


def plain_request(bundle, ops, frames, head):
    """One request as ``bundle`` serves it, through the plain versions."""
    with torch.inference_mode():
        y, z = plain_forward(bundle.model, ops, bundle._frames(frames),
                             decode=head == 'reconstruct')
    return z if head == 'encode' else y


def model_hparams(arch):
    """The published default arch on the 2-view frames, 12 latents."""
    hp = arch.load_handcrafted_arch(list(IMG), N_LATENTS, None, check_memory=False)
    return dict(hp, model_class='ae', model_type='conv', n_ae_latents=N_LATENTS,
                n_input_channels=IMG[0], y_pixels=IMG[1], x_pixels=IMG[2],
                rng_seed_model=SEED)


def serve(serving, base, ops, hp, tmp):
    """Main path 1: serving through ``load_version`` on the card."""
    vdir = os.path.join(tmp, 'version_0')
    os.makedirs(vdir)
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(hp, f)
    base.save_params(random_params(hp, np.random.RandomState(SEED)),
                     os.path.join(vdir, 'best_val_model.pt'),
                     extra={'model_class': 'ae'})
    frames = np.random.RandomState(SEED + 1).randint(
        0, 256, (max(REQUEST_SIZES),) + (IMG[1], IMG[2], IMG[0])).astype(np.uint8)

    # the main path: every launch from here to the read below is counted
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bundle = serving.load_version(vdir)
    answers = {(head, n): getattr(bundle, head)(frames[:n])
               for n in REQUEST_SIZES for head in ('encode', 'reconstruct')}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    emit(dict(phase='serve_launches', device=str(bundle.device), launches=launches))
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError('the served requests never launched %s' % missing)

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bundle.reconstruct(frames[:TRIAL])
    torch.cuda.synchronize()
    per_request = dict(ops.LAUNCHES)
    emit(dict(phase='launches_per_reconstruct_request', frames=TRIAL,
              launches=per_request))

    results = []
    for n in REQUEST_SIZES:
        with torch.inference_mode():
            ref_y, ref_z = plain_forward(
                bundle.model, ops, torch.from_numpy(frames[:n]).to(bundle.device))
        for head, ref in (('encode', ref_z), ('reconstruct', ref_y)):
            out = answers[(head, n)]
            want = (n, N_LATENTS) if head == 'encode' else (n, IMG[1], IMG[2], IMG[0])
            ok_shape = tuple(out.shape) == want and out.dtype == torch.float32
            finite = bool(torch.isfinite(out).all().item())
            in_range = head == 'encode' or bool(((out >= 0) & (out <= 1)).all().item())
            err = (out - ref).abs().max().item()
            tol = SERVE_ABS_TOL * max(1.0, ref.abs().max().item())
            ms = request_ms(lambda: getattr(bundle, head)(frames[:n]))
            # the same request through the plain versions (cuDNN, TF32 off)
            plain_ms = request_ms(lambda: plain_request(bundle, ops, frames[:n], head))
            rec = dict(phase='serve', head=head, frames=n, shape=list(out.shape),
                       finite=finite, in_unit_range=in_range, max_abs_err=err,
                       tol=tol, ms=ms, frames_per_s=n / ms * 1e3, plain_ms=plain_ms)
            emit(rec)
            if not (ok_shape and finite and in_range and err <= tol):
                raise AssertionError('served %s of %d frames is wrong: %s'
                                     % (head, n, rec))
            results.append(rec)
    return launches, per_request, results


def check_backward_layer(L, ops, gen):
    """The backward of one layer at the train step's shapes: grad-w (K4) and,
    unless the input is uint8 frames, grad-x (K2 for a conv, K1 for a
    transposed conv), each against its plain version and cuDNN's wgrad /
    dgrad through ``torch.autograd.grad``."""
    dev = DEVICE
    transposed = L['kernel'] != 'conv2d_nhwc'
    k, s, py, px, op = L['k'], L['s'], L['pad_y'], L['pad_x'], L['out_pad']
    shape = (L['n'], L['h'], L['w'], L['ci'])
    if L['uint8']:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    else:
        x = torch.randn(shape, device=dev, generator=gen)
    w = torch.randn((k, k, L['ci'], L['co']), device=dev, generator=gen) * 0.05
    if transposed:
        oh, ow = ops.conv_transpose_out_hw(L['h'], L['w'], k, s, py, px, op)
    else:
        oh, ow = ops.conv_out_hw(L['h'], L['w'], k, s, py, px)
    g = torch.randn((L['n'], oh, ow, L['co']), device=dev, generator=gen)

    # cuDNN yardsticks: autograd of the library call (for a transposed conv
    # at the symmetric pad p_before, whose output is up to one row and
    # column larger; the cotangent is padded with zeros to match)
    xf = (x.float() / 255.0 if L['uint8'] else x)
    if transposed:
        xl = xf.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        wl = w.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
        xl.requires_grad_(True)
        wl.requires_grad_(True)
        out_l = F.conv_transpose2d(xl, wl, None, stride=s, padding=(py[0], px[0]),
                                   output_padding=op)
    else:
        xl = F.pad(xf.permute(0, 3, 1, 2), [px[0], px[1], py[0], py[1]])
        xl = xl.contiguous(memory_format=torch.channels_last).requires_grad_(True)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        wl.requires_grad_(True)
        out_l = F.conv2d(xl, wl, None, stride=s)
    gl = g.permute(0, 3, 1, 2)
    gl = F.pad(gl, [0, out_l.shape[3] - ow, 0, out_l.shape[2] - oh])
    gl = gl.contiguous(memory_format=torch.channels_last)

    passes = []
    if transposed:
        pw_y, pw_x = (py[0], py[1] - op[0]), (px[0], px[1] - op[1])
        passes.append(('grad_w', 'conv2d_grad_w_nhwc',
                       lambda: ops.conv2d_grad_w(g, x, k, s, pw_y, pw_x, True),
                       lambda: ops.conv2d_grad_w_plain(g, x, k, s, pw_y, pw_x, True), wl))
        passes.append(('grad_x', 'conv2d_nhwc',
                       lambda: ops.conv_transpose2d_grad_x(g, w, s, py, px, op),
                       lambda: ops.conv_transpose2d_grad_x_plain(g, w, s, py, px, op), xl))
    else:
        passes.append(('grad_w', 'conv2d_grad_w_nhwc',
                       lambda: ops.conv2d_grad_w(x, g, k, s, py, px),
                       lambda: ops.conv2d_grad_w_plain(x, g, k, s, py, px), wl))
        if not L['uint8']:
            hw = (L['h'], L['w'])
            passes.append(('grad_x', 'conv_transpose2d_nhwc',
                           lambda: ops.conv2d_grad_x(g, w, s, py, px, hw),
                           lambda: ops.conv2d_grad_x_plain(g, w, s, py, px, hw), xl))

    rows = []
    for name, kernel_name, kernel, plain, wrt in passes:
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape:
            raise AssertionError('%s %s: kernel shape %s, plain %s' % (
                L['layer'], name, tuple(out_k.shape), tuple(out_p.shape)))
        max_abs, abs_tol, max_rel, finite = errors(out_k, out_p, scaled_floor=True)
        out_shape = list(out_k.shape)
        del out_k, out_p
        macs = layer_macs(L, oh, ow, transposed)
        if name == 'grad_w':   # reads x and g once, writes gw
            nbytes = x.numel() * x.element_size() + 4 * g.numel() + 4 * w.numel()
        else:                  # reads g and w once, writes gx
            nbytes = 4 * (g.numel() + w.numel() + x.numel())
        t_ops = 2 * macs / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3

        def library(wrt=wrt):
            return torch.autograd.grad(out_l, wrt, gl, retain_graph=True)
        rec = dict(
            phase='backward_check', layer=L['layer'], kernel=kernel_name, grad=name,
            frames=L['n'], cotangent=list(g.shape), output=out_shape,
            max_abs_err=max_abs, abs_tol=abs_tol, max_rel_err=max_rel, rel_tol=REL_TOL,
            gflop=2 * macs / 1e9, mbytes=nbytes / 1e6,
            ms=median_ms(kernel), plain_ms=median_ms(plain), library_ms=median_ms(library),
            bound_ms=max(t_ops, t_bytes), t_ops_ms=t_ops, t_bytes_ms=t_bytes,
            bound_by='operations' if t_ops >= t_bytes else 'bytes')
        emit(rec)
        if not finite or max_abs > abs_tol or max_rel > REL_TOL:
            raise AssertionError('%s %s: kernel disagrees with its plain version: %s'
                                 % (L['layer'], name, rec))
        rows.append(rec)
    return rows


def check_mse(losses, gen):
    """K5 at the train step's loss shape: (192, 128, 128, 2) sigmoid outputs,
    uint8 targets, 189 real frames; forward and backward (with the sigmoid
    term) against the plain versions and ``F.mse_loss`` forward+backward."""
    dev = DEVICE
    shape = (BUCKET, IMG[1], IMG[2], IMG[0])
    y = torch.sigmoid(torch.randn(shape, device=dev, generator=gen))
    t = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    fm = torch.zeros(BUCKET, device=dev)
    fm[:TRIAL] = 1.0
    one = torch.ones((), device=dev)

    def kernel():
        loss, den = losses.mse_cuda(y, t, None, fm)
        return loss, losses.mse_grad_cuda(y, t, None, fm, den, one, True)

    def plain():
        loss, den = losses.mse_plain(y, t, None, fm)
        return loss, losses.mse_grad_plain(y, t, None, fm, den, one, True)
    (loss_k, g_k), (loss_p, g_p) = kernel(), plain()
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    max_abs, abs_tol, max_rel, finite = errors(g_k, g_p, scaled_floor=True)
    del g_k, g_p

    yl = y.clone().requires_grad_(True)
    tf = t.float() / 255.0

    def library():
        loss = F.mse_loss(yl, tf)
        return torch.autograd.grad(loss, yl)
    n = y.numel()
    nbytes = n * (4 + 1) + n * (4 + 1 + 4) + 2 * 4 * BUCKET   # fwd + bwd
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 8 * n / PEAK_F32_FLOPS * 1e3
    rec = dict(phase='loss_check', kernel='masked_mse', shape=list(shape),
               real_frames=TRIAL, loss=loss_k.item(), loss_rel_err=loss_err,
               loss_rel_tol=LOSS_REL_TOL, max_abs_err=max_abs, abs_tol=abs_tol,
               max_rel_err=max_rel, rel_tol=REL_TOL, mbytes=nbytes / 1e6,
               ms=median_ms(kernel), plain_ms=median_ms(plain),
               library_ms=median_ms(library), bound_ms=max(t_ops, t_bytes),
               t_ops_ms=t_ops, t_bytes_ms=t_bytes,
               bound_by='operations' if t_ops >= t_bytes else 'bytes')
    emit(rec)
    if not finite or loss_err > LOSS_REL_TOL or max_abs > abs_tol or max_rel > REL_TOL:
        raise AssertionError('K5 disagrees with its plain version: %s' % rec)
    return rec


def check_amsgrad(optim, model, gen):
    """K6: one AMSGrad step (L2 on, step 3, moments from earlier steps) over
    every parameter of the full-width model against the plain recursion,
    and torch's fused ``Adam(amsgrad=True)`` as the yardstick."""
    dev = DEVICE
    params = [p.detach() for p in model.parameters()]
    grads = [torch.randn(p.shape, device=dev, generator=gen) * 1e-3 for p in params]
    m0 = [torch.randn(p.shape, device=dev, generator=gen) * 1e-3 for p in params]
    v0 = [torch.rand(p.shape, device=dev, generator=gen) * 1e-6 for p in params]
    vmax0 = [v * 1.5 for v in v0]

    def state():
        return ([p.clone() for p in params], [m.clone() for m in m0],
                [v.clone() for v in v0], [v.clone() for v in vmax0])
    args = dict(lr=LEARNING_RATE, weight_decay=L2_REG)
    steps = [3] * len(params)
    pk, mk, vk, xk = state()
    optim.amsgrad_cuda_(pk, grads, mk, vk, xk, steps, **args)
    pp, mp, vp, xp = state()
    optim.amsgrad_plain_(pp, grads, mp, vp, xp, steps, **args)
    torch.cuda.synchronize()

    def rel(a, b, ref):
        return max((x - y).abs().max().item() for x, y in zip(a, b)) / \
            max(r.abs().max().item() for r in ref)
    step_err = rel([a - p for a, p in zip(pk, params)], [a - p for a, p in zip(pp, params)],
                   [a - p for a, p in zip(pp, params)])
    state_err = max(rel(mk, mp, mp), rel(vk, vp, vp), rel(xk, xp, xp))
    max_abs = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    finite = all(bool(torch.isfinite(a).all().item()) for a in pk)
    del pp, mp, vp, xp

    pk, mk, vk, xk = state()

    def kernel():
        optim.amsgrad_cuda_(pk, grads, mk, vk, xk, steps, **args)

    def plain():
        optim.amsgrad_plain_(pk, grads, mk, vk, xk, steps, **args)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    adam = torch.optim.Adam(lib_params, lr=LEARNING_RATE, weight_decay=L2_REG,
                            amsgrad=True, fused=True)
    n = sum(p.numel() for p in params)
    nbytes = 4 * n * (5 + 4)   # p, g, m, v, vmax in; p, m, v, vmax out
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 16 * n / PEAK_F32_FLOPS * 1e3
    rec = dict(phase='optimizer_check', kernel='amsgrad_step', tensors=len(params),
               params=n, step_rel_err=step_err, step_rel_tol=STEP_REL_TOL,
               state_rel_err=state_err, state_rel_tol=STATE_REL_TOL, max_abs_err=max_abs,
               mbytes=nbytes / 1e6, ms=median_ms(kernel), plain_ms=median_ms(plain),
               library_ms=median_ms(adam.step), bound_ms=max(t_ops, t_bytes),
               t_ops_ms=t_ops, t_bytes_ms=t_bytes,
               bound_by='operations' if t_ops >= t_bytes else 'bytes')
    emit(rec)
    if not finite or step_err > STEP_REL_TOL or state_err > STATE_REL_TOL:
        raise AssertionError('K6 disagrees with the plain recursion: %s' % rec)
    return rec


class TrialSource:
    """In-memory trial store with the generator interface ``fit`` uses
    (``next_batch``, ``reset_iterators``, ``n_tot_batches``, ``n_datasets``,
    samples with ``batch_idx``): ``n`` trials of 189 uint8 frames from a
    seed, split 8/1/1 per block of 10 as the reference splits a session.
    The frames are blocky and dark (8x8 random tiles in 0..100, like a
    dim behaviour video), so a few steps can lower the loss."""

    n_datasets = 1

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        tiles = rs.randint(0, 100, (n, TRIAL, 8, 8, IMG[0])).astype(np.uint8)
        self.trials = np.repeat(np.repeat(tiles, IMG[1] // 8, axis=2), IMG[2] // 8, axis=3)
        idx = np.arange(n)
        self.idxs = {'train': idx[idx % 10 < 8], 'val': idx[idx % 10 == 8],
                     'test': idx[idx % 10 == 9]}
        self.n_tot_batches = {k: len(v) for k, v in self.idxs.items()}
        self.reset_iterators('all')

    def reset_iterators(self, dtype):
        for dt in (self.idxs if dtype == 'all' else [dtype]):
            setattr(self, '_order_' + dt, list(np.random.permutation(self.idxs[dt])))

    def next_batch(self, dtype):
        i = int(getattr(self, '_order_' + dtype).pop(0))
        return {'images': self.trials[i], 'batch_idx': i}, 0


def plain_loss(model, ops, losses, batch):
    """The AE's loss through the plain versions only (cuDNN autograd)."""
    y, _ = plain_forward(model, ops, batch['images'])
    return losses.mse_plain(y, batch['images'], None, batch['frame_mask'])[0]


def train(port, hp, tmp):
    """Main path 2: ``fit`` on the card, then its checks and the step timing."""
    ops, losses = port.ops, port.losses
    hp = dict(hp, learning_rate=LEARNING_RATE, l2_reg=L2_REG, rng_seed_train=SEED,
              max_n_epochs=1, min_n_epochs=1, val_check_interval=1,
              enable_early_stop=False, early_stop_history=10, export_latents=False,
              rng_seed_data=SEED, device=DEVICE, experiment_name='smoke')
    source = TrialSource(TRAIN_TRIALS, SEED + 2)
    exp = port.experiment.Experiment('smoke', tmp)
    hp['expt_dir'] = os.path.join(tmp, 'smoke')
    vdir = os.path.join(hp['expt_dir'], 'version_%d' % exp.version)
    model = port.aes.AE(hp)

    # the main path: every launch from here to the read below is counted
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    best = port.training.fit(hp, model, source, exp)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    emit(dict(phase='train_launches', device=str(next(model.parameters()).device),
              seconds=fit_s, launches=launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError('fit never launched %s' % missing)

    with open(os.path.join(vdir, 'metrics.csv'), newline='') as f:
        rows = list(csv.DictReader(f))
    losses_logged = {k: [float(r[k]) for r in rows if r.get(k)]
                     for k in ('tr_loss', 'val_loss', 'test_loss')}
    finite = all(np.isfinite(v).all() and len(v) for v in losses_logged.values())
    fell = losses_logged['tr_loss'][-1] < losses_logged['tr_loss'][0]
    emit(dict(phase='train', epochs=[0, 1], train_trials=source.n_tot_batches['train'],
              frames_per_trial=TRIAL, bucket=BUCKET, losses=losses_logged,
              finite=finite, train_loss_fell=fell))
    if not (finite and fell):
        raise AssertionError('fit logged non-finite losses or the train loss did not '
                             'fall: %s' % losses_logged)

    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(dict(hp, version=exp.version, training_completed=True), f)
    bundle = port.serving.load_version(vdir)
    served = dict(bundle.model.state_dict())
    same = all(torch.equal(served[k].cpu(), v) for k, v in
               port.weights.params_to_state_dict(bundle.model, best).items())
    recon = bundle.reconstruct(source.trials[0])
    ok_served = same and tuple(recon.shape) == (TRIAL, IMG[1], IMG[2], IMG[0]) and \
        bool(torch.isfinite(recon).all().item())
    emit(dict(phase='train_checkpoint_serves', weights_equal=same, ok=ok_served))
    if not ok_served:
        raise AssertionError('best_val_model.pt does not serve the fitted weights')

    # one step's gradients: kernels vs the plain path on the card
    images = np.zeros((BUCKET,) + source.trials[0].shape[1:], np.uint8)
    images[:TRIAL] = source.trials[0]
    frame_mask = np.zeros(BUCKET, np.float32)
    frame_mask[:TRIAL] = 1.0
    batch = {'images': torch.from_numpy(images).to(DEVICE),
             'frame_mask': torch.from_numpy(frame_mask).to(DEVICE)}
    model.zero_grad(set_to_none=True)
    model.loss_fn(batch)[0].backward()
    grads_k = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    plain_loss(model, ops, losses, batch).backward()
    grad_errs = {k: (grads_k[k] - p.grad).abs().max().item()
                 / max(p.grad.abs().max().item(), 1e-30)
                 for k, p in model.named_parameters()}
    worst = max(grad_errs, key=grad_errs.get)
    emit(dict(phase='train_grads', frames=BUCKET, rel_tol=GRAD_REL_TOL,
              max_rel_err=grad_errs[worst], worst=worst, rel_err=grad_errs))
    if grad_errs[worst] > GRAD_REL_TOL:
        raise AssertionError('card gradients disagree with the plain path: %s=%.3g'
                             % (worst, grad_errs[worst]))

    # step time: the port's step (kernels, K6) and the plain one (cuDNN
    # autograd, torch's fused AMSGrad) on a copy of the same weights
    opt = port.optim.AMSGrad(model.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG)
    twin = port.aes.AE(hp).to(DEVICE)
    twin.load_state_dict(model.state_dict())
    adam = torch.optim.Adam(twin.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG,
                            amsgrad=True, fused=True)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss_fn(batch)[0].backward()
        opt.step()

    def plain_step():
        adam.zero_grad(set_to_none=True)
        plain_loss(twin, ops, losses, batch).backward()
        adam.step()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    step()
    torch.cuda.synchronize()
    per_step = dict(ops.LAUNCHES)
    ms, plain_ms = request_ms(step), request_ms(plain_step)
    rec = dict(phase='train_step', frames=TRIAL, bucket=BUCKET, ms=ms,
               frames_per_s=TRIAL / ms * 1e3, plain_ms=plain_ms,
               plain_frames_per_s=TRIAL / plain_ms * 1e3, launches_per_step=per_step)
    emit(rec)
    host_batch = {'images': images, 'frame_mask': frame_mask}
    emit(profile_steps(lambda: step_from_host(step, host_batch, batch)))
    return launches, per_step, rec


def step_from_host(step, host_batch, batch):
    """One train step as ``fit`` runs it: the padded trial goes to the card,
    then forward, backward and the optimizer step."""
    for k, v in host_batch.items():
        batch[k] = torch.from_numpy(v).to(DEVICE)
    step()


# kernel function name -> the port kernel it belongs to
KERNEL_OF = (('igemm_conv_kernel<unsigned char, false>', 'K1 conv2d_nhwc'),
             ('igemm_conv_kernel<float, false>', 'K1 conv2d_nhwc'),
             ('igemm_conv_kernel<float, true>', 'K2 conv_transpose2d_nhwc'),
             ('tconv_smallcout_kernel', 'K3 conv_transpose2d_smallcout_sigmoid'),
             ('gradw_', 'K4 conv2d_grad_w_nhwc'), ('mse_', 'K5 masked_mse'),
             ('amsgrad_kernel', 'K6 amsgrad_step'))


def profile_steps(fn, steps=5, warmup=2):
    """Where a train step's time goes: ``torch.profiler`` over ``steps``
    steps after ``warmup``; device time per kernel function, grouped by port
    kernel (everything else is PyTorch's: the FC matmuls, activation
    derivatives, bias sums, copies), and the device's busy and idle share
    of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, counts = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        counts[e.name] = counts.get(e.name, 0) + 1
    busy_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    groups = {}
    for name, us in by_name.items():
        group = next((g for key, g in KERNEL_OF if key in name), 'pytorch')
        groups[group] = groups.get(group, 0.0) + us / steps / 1e3
    top = sorted(by_name, key=by_name.get, reverse=True)[:12]
    return dict(
        phase='train_profile', steps=steps, frames=TRIAL, bucket=BUCKET,
        device_events=len(spans), wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=busy_us / steps / 1e3,
        device_idle_share=1.0 - busy_us / wall_us if spans else None,
        ms_per_step_by_kernel=groups,
        top_functions=[dict(name=n[:90], ms_per_step=by_name[n] / steps / 1e3,
                            calls_per_step=counts[n] / steps) for n in top])


def kernel_row(name, rows, launches):
    """The kernels-line entry of one kernel: sums over the rows it was
    checked at; launches from the main paths' runs."""
    source, replaces = KERNELS[name]
    t_ops = sum(r['t_ops_ms'] for r in rows)
    t_bytes = sum(r['t_bytes_ms'] for r in rows)
    return dict(
        name=name, route='cuda', source=source, replaces=replaces,
        launches=sum(v[name] for v in launches.values()),
        launches_by_path={path: v[name] for path, v in launches.items()},
        checked_at=['%s%s@%d' % (r.get('layer', r['phase']),
                                 '.' + r['grad'] if 'grad' in r else '',
                                 r.get('frames', BUCKET)) for r in rows],
        max_abs_err=max(r['max_abs_err'] for r in rows),
        ms=sum(r['ms'] for r in rows), plain_ms=sum(r['plain_ms'] for r in rows),
        bound_ms=sum(r['bound_ms'] for r in rows),
        bound_by='operations' if t_ops >= t_bytes else 'bytes',
        library_ms=sum(r['library_ms'] for r in rows))


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    port = import_port()
    ops = port.ops
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase='gpu', nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device=kind))

    seconds = port.build.build_all()
    emit(dict(phase='build', seconds=seconds, ptxas=port.build.ptxas_info()))

    hp = model_hparams(port.arch)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    checks = [check_layer(L, ops, gen) for L in layer_shapes(hp, TRIAL)]
    for L in layer_shapes(hp, BUCKET):
        checks += check_backward_layer(L, ops, gen)
    checks.append(check_mse(port.losses, gen))
    checks.append(check_amsgrad(port.optim, port.aes.AE(hp).to(DEVICE), gen))

    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, _, _ = serve(port.serving, port.base, ops, hp, tmp)
        train_launches, _, _ = train(port, hp, tmp)
    launches = {'serve': serve_launches, 'train': train_launches}

    emit({'kernels': [kernel_row(name, [r for r in checks if r['kernel'] == name], launches)
                      for name in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
