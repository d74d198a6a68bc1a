#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``behavenet_tpu_torch``).

    python3 chip_smoke.py

On one CUDA GPU (an H100: the kernels are built for sm_90a) it

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from the sources in this checkout;
3. holds each kernel against its plain PyTorch version at every layer shape
   of the published default conv AE (Whiteway et al 2021) on the reference's
   2-view 128x128 frames at the 189-frame trial batch, and times the kernel,
   the plain version and the one cuDNN call that computes the same
   convolution (TF32 off for every float32 reference);
4. writes a fitted-version directory (``meta_tags.pkl``, ``best_val_model.pt``
   in the JAX package's layout, weights from a seeded numpy RNG at torch's
   default init scale), serves ``encode`` and ``reconstruct`` requests of
   1, 189 and 1024 uint8 frames through ``serving.load_version`` on the card,
   checks every answer against the plain path on the card, and shows from
   the launch counts that the requests ran through every kernel;
5. times each request after warm-up (host clock to ``synchronize``), and
   the same request through the plain versions.

Each phase prints one JSON line; the line before the last lists the kernels
with their numbers, and the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. Any failure exits non-zero.
"""

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

IMG = (2, 128, 128)          # (views, height, width) of the 2-view Musall trial
N_LATENTS = 12
TRIAL = 189                  # frames in one trial: the kernel-check batch
REQUEST_SIZES = (1, 189, 1024)
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
# A served answer vs the plain path on the card, after ten layers.
SERVE_ABS_TOL = 1e-4

KERNELS = {
    'conv2d_nhwc': ('behavenet_tpu_torch/kernels/conv2d_nhwc.cu',
                    'behavenet_tpu/ops/conv.py:43'),
    'conv_transpose2d_nhwc': ('behavenet_tpu_torch/kernels/conv_transpose2d_nhwc.cu',
                              'behavenet_tpu/ops/conv.py:195'),
    'conv_transpose2d_smallcout_sigmoid': (
        'behavenet_tpu_torch/kernels/conv_transpose2d_smallcout_sigmoid.cu',
        'behavenet_tpu/ops/conv.py:310'),
}


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
    from behavenet_tpu_torch.kernels import build
    from behavenet_tpu_torch.models import arch, base
    from behavenet_tpu_torch.ops import conv as ops
    return serving, build, arch, base, ops


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
    d = (out_k - out_p).abs()
    scale = out_p.abs().max().item()
    max_abs = d.max().item()
    max_rel = (d / (out_p.abs() + REL_FLOOR)).max().item()
    abs_tol = ABS_TOL * max(1.0, scale)
    finite = bool(torch.isfinite(out_k).all().item())
    del out_k, out_p, d

    macs = L['n'] * L['ci'] * L['co'] \
        * taps_per_dim(oh, L['h'], L['k'], s, py[0], transposed) \
        * taps_per_dim(ow, L['w'], L['k'], s, px[0], transposed)
    nbytes = x.numel() * x.element_size() + 4 * (w.numel() + b.numel()) \
        + 4 * L['n'] * oh * ow * L['co']
    t_ops = 2 * macs / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(
        phase='kernel_check', layer=L['layer'], kernel=L['kernel'],
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


def serve(serving, arch, base, ops, tmp):
    hp = arch.load_handcrafted_arch(list(IMG), N_LATENTS, None, check_memory=False)
    hp = dict(hp, model_class='ae', model_type='conv', n_ae_latents=N_LATENTS,
              n_input_channels=IMG[0], y_pixels=IMG[1], x_pixels=IMG[2],
              rng_seed_model=SEED)
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
    missing = [k for k, v in launches.items() if v == 0]
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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    serving, build, arch, base, ops = import_port()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase='gpu', nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device=kind))

    seconds = build.build_all()
    emit(dict(phase='build', seconds=seconds, ptxas=build.ptxas_info()))

    hp = arch.load_handcrafted_arch(list(IMG), N_LATENTS, None, check_memory=False)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    checks = [check_layer(L, ops, gen) for L in layer_shapes(hp, TRIAL)]

    with tempfile.TemporaryDirectory() as tmp:
        launches, _, _ = serve(serving, arch, base, ops, tmp)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in checks if r['kernel'] == name]
        t_ops = sum(r['t_ops_ms'] for r in rows)
        t_bytes = sum(r['t_bytes_ms'] for r in rows)
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches[name],
            layers=[r['layer'] for r in rows],
            max_abs_err=max(r['max_abs_err'] for r in rows),
            ms=sum(r['ms'] for r in rows), plain_ms=sum(r['plain_ms'] for r in rows),
            bound_ms=sum(r['bound_ms'] for r in rows),
            bound_by='operations' if t_ops >= t_bytes else 'bytes',
            library_ms=sum(r['library_ms'] for r in rows)))
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
