#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``behavenet_tpu_torch``).

    python3 chip_smoke.py

On one CUDA GPU (an H100: the kernels are built for sm_90a) it

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's twelve CUDA kernel sources from this checkout;
3. holds each kernel against its plain PyTorch version at the shapes the
   two main paths give it, and times the kernel, the plain version and the
   one PyTorch call that computes the same function (TF32 off for every
   float32 reference: ``tf32_off`` around the phases up to the ARHMM's and
   around the decoders' library yardsticks; the decoder phases run under
   PyTorch's default flags, as users run them), on the published default
   conv AE (Whiteway et al 2021) and the reference's 2-view 128x128 frames:
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
   the device's idle share);
6. the VAE family (main paths 3-5): holds K7, the decomposed KL, forward
   and backward against its plain version at the 192-frame bucket with 189
   real frames, for the PS-VAE's 8 unsupervised latents and the
   beta-TC-VAE's 12; runs ``fit`` of a PS-VAE (4 labels, alpha 1000, beta 5,
   100 anneal epochs: docs/user_guide.psvae.md) and of a beta-TC-VAE
   (configs/ae_jsons/ae_model.json) for an eval epoch and two train epochs
   each on trials with seeded labels, checks every logged loss is finite and that K1-K7 all ran
   inside each ``fit``; checks a PS-VAE train step's gradients against the
   plain path's with the same eps, times and profiles it; and serves the
   fitted PS-VAE through ``serving.load_version`` (``encode`` = [y, w]).

7. the ARHMM (main paths 6-8): holds K8 (AR log-likelihoods, full and
   diagonal covariance), K9 (forward-backward, on full trials and on a copy
   with every tenth trial cut to 700 frames), K10 (Viterbi) and K11 (the
   M-step's small solves) against their plain versions at the JAX package's
   EM benchmark shapes (bench.py:300: K = 16 states, D = 9, AR(1), 100
   trials of 1000 frames, sampled from a seeded ARHMM), params from a seeded
   ``initialize``; runs ``ARHMM.fit`` for 20 EM iterations there (every LL
   finite and non-decreasing, K8, K9 and K11 launched every iteration),
   times an iteration beside the same EM through the plain versions and
   profiles it; runs the port's ``arhmm_grid_search`` CLI on the card over
   the published grid of configs/arhmm_jsons/arhmm_model.json (K = 2, 4, 8,
   12) on a latents pickle of 50 trials of 189 frames (K8-K11 must all
   launch inside it); and serves one fitted ``best_val_model.pt`` through
   ``utils.pickles.load_arhmm`` (``most_likely_states``,
   ``expected_states`` against the plain path on the card). Then the
   recurrent and robust ARHMM at the same shapes: K8's Student's-t launcher
   (log-likelihoods and the scale-mixture weights tau, full and diagonal),
   K9's time-varying one (gamma, log_Z, xi_sum and the per-step xi, with
   (100, 999, 16, 16) log-transitions of a seeded 'recurrent' model on full
   trials and of a 'recurrent_only' one with every tenth trial cut to 700
   frames) and K10's time-varying one, each against its plain version; 20
   EM iterations of 'recurrent' transitions with 'robust_ar' observations
   through ``ARHMM.fit`` (every LL finite, the last above the first; one
   iteration's LL and parameters against the plain EM; timed and
   profiled); the CLI over the same grid with ``transitions: recurrent``
   and ``noise_type: studentst``, and its K = 12 model served through
   ``load_arhmm``.
8. the neural decoders (main paths 9-12) at the published decoding config
   (configs/decoding_jsons: a 9-wide temporal conv, one hidden layer of 32
   relu units, 9 AE latents or 4 ARHMM states) on 189-frame trials of 256
   neural channels (a chosen width: the repo names none): K12, the
   full-covariance Gaussian NLL, forward and backward against its plain
   version and ``MultivariateNormal.log_prob`` at the 192-frame bucket with
   the lag-trimmed window, d = 9 and 16, and K5 there at (192, 9) with
   float32 targets; ``fit`` of a ``neural-ae`` ``mlp-mv``
   (K12 and K6 must launch inside it), a ``neural-ae`` ``mlp`` (K5, K6) and a
   ``neural-arhmm`` ``mlp`` (K6) for an eval epoch and two train epochs over
   20 in-memory trials with targets linear in the neural input, every
   logged number finite; the fitted ``mlp``'s and ``mlp-mv``'s gradients
   against the plain path's, the ``mlp-mv`` step's time beside the plain
   step's and its profile; ``predict``
   of the fitted ``mlp-mv`` through ``serving.load_version`` on a 189- and
   a 1000-frame trial against the float64 forward.

Each phase prints one JSON line; the line before the last lists the kernels
with their numbers, and the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. Any failure exits non-zero.
"""

import contextlib
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
# K7's gradients vs its plain version: float32 sums of 189 terms in another
# order (and an online logsumexp), max |d| within 1e-4 of max |plain|.
KL_GRAD_REL_TOL = 1e-4

# The VAE family at the same width: the PS-VAE of docs/user_guide.psvae.md
# (4 labels; 12 latents leave 8 unsupervised ones to K7) and the beta-TC-VAE
# of configs/ae_jsons/ae_model.json (K7 over all 12 latents).
N_LABELS = 4
VAE_CLASSES = {
    'ps-vae': {'n_labels': N_LABELS, 'ps_vae.alpha': 1000, 'ps_vae.beta': 5,
               'ps_vae.anneal_epochs': 100},
    'beta-tcvae': {'beta_tcvae.beta': 1, 'beta_tcvae.beta_anneal_epochs': 100},
}
KL_DIMS = (N_LATENTS - N_LABELS, N_LATENTS)
VAE_FIT_EPOCHS = 2           # an eval epoch, then two train epochs

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
    'decomposed_kl': ('behavenet_tpu_torch/kernels/decomposed_kl.cu',
                      'behavenet_tpu/ops/losses.py:120'),
    'arhmm_log_likes': ('behavenet_tpu_torch/kernels/arhmm_log_likes.cu',
                        'behavenet_tpu/models/arhmm.py:187'),
    'hmm_forward_backward': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                             'behavenet_tpu/ops/hmm.py:115'),
    'hmm_viterbi': ('behavenet_tpu_torch/kernels/hmm_viterbi.cu',
                    'behavenet_tpu/ops/hmm.py:186'),
    'solve_small': ('behavenet_tpu_torch/kernels/solve_small.cu',
                    'behavenet_tpu/ops/smallmat.py:17'),
    'gaussian_nll': ('behavenet_tpu_torch/kernels/gaussian_nll.cu',
                     'behavenet_tpu/ops/losses.py:161'),
    # the launchers added beside K8-K10 for the recurrent and robust ARHMM
    'arhmm_log_likes_robust': ('behavenet_tpu_torch/kernels/arhmm_log_likes.cu',
                               'behavenet_tpu/models/arhmm.py:211'),
    'hmm_forward_backward_tv': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                                'behavenet_tpu/ops/hmm.py:167'),
    'hmm_viterbi_tv': ('behavenet_tpu_torch/kernels/hmm_viterbi.cu',
                       'behavenet_tpu/ops/hmm.py:186'),
}

# the kernels a served request runs (an AE train step runs K1-K6, a
# beta-TC-VAE or PS-VAE step K1-K7; ARHMM EM runs K8, K9 and K11, the
# ARHMM CLI and serving K10 too)
SERVE_KERNELS = ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'conv_transpose2d_smallcout_sigmoid')
AE_KERNELS = SERVE_KERNELS + ('conv2d_grad_w_nhwc', 'masked_mse', 'amsgrad_step')
VAE_KERNELS = AE_KERNELS + ('decomposed_kl',)
EM_KERNELS = ('arhmm_log_likes', 'hmm_forward_backward', 'solve_small')
ARHMM_KERNELS = EM_KERNELS + ('hmm_viterbi',)
# a recurrent + robust ARHMM's EM, CLI and serving run the launchers for
# Student's-t observations and time-varying transitions
RECURRENT_EM_KERNELS = ('arhmm_log_likes_robust', 'hmm_forward_backward_tv', 'solve_small')
RECURRENT_KERNELS = RECURRENT_EM_KERNELS + ('hmm_viterbi_tv',)

# The ARHMM at the JAX package's EM benchmark shapes (bench.py:300
# measure_arhmm_em; the reference NP dataset's 1000-frame trials,
# SURVEY.md:391; configs/arhmm_jsons/arhmm_training.json n_iters), and the
# CLI's published grid on 189-frame Musall trials.
EM_STATES, EM_DIM, EM_TRIALS, EM_FRAMES, EM_ITERS = 16, 9, 100, 1000, 20
EM_CUT = 700                 # every tenth trial cut to 700 frames: the mask path
EM_TIMED_ITERS = 5           # timed EM iterations, after 2 warm-up ones
CLI_TRIALS = 50              # 40 train, 5 val, 5 test trials of TRIAL frames
ARHMM_CONFIGS = os.path.join(HERE, 'configs', 'arhmm_jsons')
# K8: max |d| <= LL_ABS_TOL * max(1, max|plain|) (f32 sums of 90 products
# per frame and state in another order). K9: log_Z within LOGZ_REL_TOL,
# gamma within GAMMA_ABS_TOL, xi_sum within XI_REL_TOL of its largest
# entry (sums over 1000 frames in another order). K10: paths equal on at
# least PATH_AGREE of the frames, and where they differ (a near-tie broken
# the other way) the joint log-probabilities within PATH_LP_REL_TOL.
# K11: within SOLVE_REL_TOL of max|plain| (10 elimination steps).
LL_ABS_TOL, LOGZ_REL_TOL, GAMMA_ABS_TOL, XI_REL_TOL = 1e-4, 1e-5, 1e-4, 1e-4
PATH_AGREE, PATH_LP_REL_TOL, SOLVE_REL_TOL = 0.999, 1e-5, 1e-4
# EM's log-likelihood may not fall by more than this relative amount
EM_LL_REL_TOL = 1e-5
# The recurrent + robust ARHMM (transitions 'recurrent', observations
# 'robust_ar') at the same shapes: 20 EM iterations through ARHMM.fit, whose
# last LL must exceed its first (the JAX package's standard,
# tests/test_models/test_arhmm.py:284-294). One iteration from the same
# params on the card and through the plain versions: the LL within
# EM_LL_REL_TOL, each parameter within REC_PARAM_REL_TOL of its largest
# entry (25 Adam steps turn posterior differences of ~1e-5 into parameter
# differences of ~1e-4 of their scale). The kernel checks draw Rs and r at
# REC_DRIVE so that log_P moves from step to step.
REC_EM_ITERS, REC_PARAM_REL_TOL, REC_DRIVE = 20, 1e-3, 0.5

# The neural decoders at the published decoding config
# (configs/decoding_jsons/decoding_ae_model.json: n_lags 4, so a 9-wide
# temporal conv, n_max_lags 8, one hidden layer of 32 relu units, l2 1e-3,
# 9 AE latents; decoding_arhmm_model.json: 4 states; decoding_training.json:
# learning rate 1e-3) on 189-frame trials of N_NEURAL channels. The repo
# names no published neural width (it is the data's own): 256 is a choice.
N_NEURAL, DEC_LATENTS, DEC_STATES = 256, 9, 4
DEC_HP = dict(n_lags=4, n_max_lags=8, n_hid_layers=1, n_hid_units=32, activation='relu',
              learning_rate=1e-3, l2_reg=1e-3)
# name -> (model_class, model_type, output signal, output width, noise_dist,
# the kernels its fit must launch)
DECODERS = {
    'neural-ae-mlp-mv': ('neural-ae', 'mlp-mv', 'ae_latents', DEC_LATENTS, 'gaussian-full',
                         ('gaussian_nll', 'amsgrad_step')),
    'neural-ae-mlp': ('neural-ae', 'mlp', 'ae_latents', DEC_LATENTS, 'gaussian',
                      ('masked_mse', 'amsgrad_step')),
    'neural-arhmm-mlp': ('neural-arhmm', 'mlp', 'arhmm_states', DEC_STATES, 'categorical',
                         ('amsgrad_step',)),
}
NLL_DIMS = (DEC_LATENTS, 16)   # the published latents; the widest K12 takes
PREDICT_FRAMES = (TRIAL, 1000)
# K12 vs its plain version: the loss within LOSS_REL_TOL, the gradients
# within NLL_GRAD_REL_TOL of max|plain| (float32 factors of covariances
# with condition numbers up to ~5e3, in another operation order).
NLL_GRAD_REL_TOL = 1e-4
# A served prediction vs the float64 forward of the same weights.
PREDICT_ABS_TOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def tf32_off():
    """float32, not TF32, in cuDNN and cuBLAS while the references run: the
    phases before the decoders hold the kernels against plain versions and
    library calls that go through cuDNN's convs (the port's own paths there
    run no cuDNN); the decoder phases run under PyTorch's default flags, as
    users run them, and set this around their library yardsticks only."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def tf32_flags():
    """PyTorch's TF32 flags as they stand (defaults: cuDNN True, cuBLAS False)."""
    return dict(cudnn=torch.backends.cudnn.allow_tf32,
                cublas=torch.backends.cuda.matmul.allow_tf32)


def import_port():
    """The port from this checkout, never from another installation."""
    sys.path.insert(0, HERE)
    import behavenet_tpu_torch
    if not os.path.abspath(behavenet_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit('behavenet_tpu_torch was imported from %s, not from '
                         'this checkout' % behavenet_tpu_torch.__file__)
    from behavenet_tpu_torch import serving
    from behavenet_tpu_torch.fitting import arhmm_grid_search, experiment, hyperparams, training
    from behavenet_tpu_torch.kernels import build
    from behavenet_tpu_torch.models import aes, arch, arhmm, base, decoders, vaes
    from behavenet_tpu_torch.ops import conv as ops
    from behavenet_tpu_torch.ops import hmm, losses, optim, smallmat
    from behavenet_tpu_torch.utils import pickles, weights
    return types.SimpleNamespace(
        serving=serving, build=build, arch=arch, base=base, ops=ops, aes=aes,
        vaes=vaes, losses=losses, optim=optim, training=training,
        experiment=experiment, weights=weights, arhmm=arhmm, hmm=hmm, smallmat=smallmat,
        pickles=pickles, arhmm_grid_search=arhmm_grid_search, hyperparams=hyperparams,
        decoders=decoders)


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


def plain_features(model, ops, frames):
    """The encoder's conv stack through the plain versions, flattened (C, H,
    W) as its dense heads read it."""
    x = frames
    for layer in model.encoding.encoder.values():
        x = ops.conv2d_plain(x, layer.weight.permute(2, 3, 1, 0), layer.bias,
                             layer.stride, layer.pad_y, layer.pad_x, layer.activation)
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def plain_decode(model, ops, z):
    """The decoder through the plain versions."""
    c, h, w = model.decoding.starting_dim
    y = model.decoding.FF(z).reshape(z.shape[0], c, h, w).permute(0, 2, 3, 1)
    for layer in model.decoding.decoder.values():
        y = ops.conv_transpose2d_plain(
            y, layer.weight.permute(2, 3, 0, 1), layer.bias, layer.stride,
            layer.pad_y, layer.pad_x, layer.out_pad, layer.activation)
    return y


def plain_forward(model, ops, frames, decode=True):
    """The AE's forward through the plain PyTorch versions only:
    (reconstruction or None, latents)."""
    z = model.encoding.FF(plain_features(model, ops, frames))
    return (plain_decode(model, ops, z) if decode else None), z


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


def check_mse(losses, gen, decoder=False):
    """K5 at a train step's loss shape, forward and backward against the
    plain versions and ``F.mse_loss`` forward+backward. The AE's: (192,
    128, 128, 2) sigmoid outputs, uint8 targets, 189 real frames, with the
    sigmoid term. With ``decoder``, the ``mlp`` decoder's: (192, 9) float32
    outputs and targets under the lag-trimmed window of a 189-frame trial,
    no sigmoid term."""
    dev = DEVICE
    if decoder:
        shape = (BUCKET, DEC_LATENTS)
        y = torch.randn(shape, device=dev, generator=gen)
        t = torch.randn(shape, device=dev, generator=gen)
        fm = decoder_window()
    else:
        shape = (BUCKET, IMG[1], IMG[2], IMG[0])
        y = torch.sigmoid(torch.randn(shape, device=dev, generator=gen))
        t = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        fm = torch.zeros(BUCKET, device=dev)
        fm[:TRIAL] = 1.0
    sigmoid = not decoder
    one = torch.ones((), device=dev)

    def kernel():
        loss, den = losses.mse_cuda(y, t, None, fm)
        return loss, losses.mse_grad_cuda(y, t, None, fm, den, one, sigmoid)

    def plain():
        loss, den = losses.mse_plain(y, t, None, fm)
        return loss, losses.mse_grad_plain(y, t, None, fm, den, one, sigmoid)
    (loss_k, g_k), (loss_p, g_p) = kernel(), plain()
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    max_abs, abs_tol, max_rel, finite = errors(g_k, g_p, scaled_floor=True)
    del g_k, g_p

    yl = y.clone().requires_grad_(True)
    tf = t if decoder else t.float() / 255.0

    def library():
        loss = F.mse_loss(yl, tf)
        return torch.autograd.grad(loss, yl)
    n = y.numel()
    # the pair as one function: y, t, the frame mask and the upstream
    # gradient read once; the loss, its denominator and dL/dy written once
    nbytes = n * (4 + t.element_size()) + 4 * BUCKET + 4 + 2 * 4 + 4 * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 8 * n / PEAK_F32_FLOPS * 1e3
    rec = dict(phase='loss_check', kernel='masked_mse', shape=list(shape),
               **(dict(layer='decoder') if decoder else {}),
               real_frames=int(fm.sum().item()), loss=loss_k.item(), loss_rel_err=loss_err,
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

    def __init__(self, n, seed, n_labels=0):
        rs = np.random.RandomState(seed)
        tiles = rs.randint(0, 100, (n, TRIAL, 8, 8, IMG[0])).astype(np.uint8)
        self.trials = np.repeat(np.repeat(tiles, IMG[1] // 8, axis=2), IMG[2] // 8, axis=3)
        # labels a model can read off the frames: the mean brightness of
        # n_labels bands of rows of view 0, z-scored
        self.labels = None
        if n_labels:
            bands = tiles[..., 0].reshape(n, TRIAL, n_labels, -1).mean(axis=-1)
            self.labels = ((bands - bands.mean()) / bands.std()).astype(np.float32)
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
        sample = {'images': self.trials[i], 'batch_idx': i}
        if self.labels is not None:
            sample['labels'] = self.labels[i]
        return sample, 0


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
    missing = [k for k in AE_KERNELS if launches[k] == 0]
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


# kernel function name -> the port kernel it belongs to (the robust and
# time-varying instances of K8-K10 first: their template flag is true)
KERNEL_OF = tuple(
    ('%s<%d, true>' % (fn, k), label) for fn, label in (
        ('arhmm_log_likes_kernel', 'K8 arhmm_log_likes (robust)'),
        ('forward_backward_kernel', 'K9 hmm_forward_backward (time-varying)'),
        ('forward_kernel', 'K9 hmm_forward_backward (forward alone, time-varying)'),
        ('viterbi_kernel', 'K10 hmm_viterbi (time-varying)'))
    for k in (8, 16, 32, 64)) + (
             ('igemm_conv_kernel<unsigned char, false>', 'K1 conv2d_nhwc'),
             ('igemm_conv_kernel<float, false>', 'K1 conv2d_nhwc'),
             ('igemm_conv_kernel<float, true>', 'K2 conv_transpose2d_nhwc'),
             ('tconv_smallcout_kernel', 'K3 conv_transpose2d_smallcout_sigmoid'),
             ('gradw_', 'K4 conv2d_grad_w_nhwc'),
             ('mse_partial_kernel', 'K5 masked_mse'), ('mse_finish_kernel', 'K5 masked_mse'),
             ('mse_grad_kernel', 'K5 masked_mse'),
             ('amsgrad_kernel', 'K6 amsgrad_step'), ('dkl_', 'K7 decomposed_kl'),
             ('arhmm_log_likes_kernel', 'K8 arhmm_log_likes'),
             ('forward_backward_kernel', 'K9 hmm_forward_backward'),
             ('forward_kernel', 'K9 hmm_forward_backward (forward alone)'),
             ('viterbi_kernel', 'K10 hmm_viterbi'), ('solve_small_kernel', 'K11 solve_small'),
             ('nll_frames_kernel', 'K12 gaussian_nll'),
             ('nll_finish_kernel', 'K12 gaussian_nll'), ('nll_grad_kernel', 'K12 gaussian_nll'))


def profile_steps(fn, steps=5, warmup=2, phase='train_profile', **labels):
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
        phase=phase, steps=steps, **dict(dict(frames=TRIAL, bucket=BUCKET), **labels),
        device_events=len(spans), wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=busy_us / steps / 1e3,
        device_idle_share=1.0 - busy_us / wall_us if spans else None,
        ms_per_step_by_kernel=groups,
        top_functions=[dict(name=n[:90], ms_per_step=by_name[n] / steps / 1e3,
                            calls_per_step=counts[n] / steps) for n in top])


def check_decomposed_kl(losses, gen, d):
    """K7 at the train step's shape: a sample z, means and log-variances of
    (192, d), 189 real frames; forward (MI, TC, DWKL) and backward (grads of
    z, mu, logvar at upstream weights (1, 5, 1): kl, beta, kl of an annealed
    PS-VAE) against the plain versions. No PyTorch call computes it."""
    dev = DEVICE
    mu = torch.randn((BUCKET, d), device=dev, generator=gen)
    lv = torch.randn((BUCKET, d), device=dev, generator=gen) * 0.5 - 1.0
    z = mu + torch.randn((BUCKET, d), device=dev, generator=gen) * torch.exp(lv)
    fm = torch.zeros(BUCKET, device=dev)
    fm[:TRIAL] = 1.0
    up = torch.tensor([1.0, 5.0, 1.0], device=dev)

    def forward():
        return losses.decomposed_kl_cuda(z, mu, lv, fm)

    def kernel():
        out, den, lse_s, lse_p = forward()
        return out, losses.decomposed_kl_grad_cuda(z, mu, lv, fm, den, lse_s, lse_p, up)

    def plain():
        out = torch.stack(losses.decomposed_kl_plain(z, mu, lv, fm))
        return out, losses.decomposed_kl_grad_plain(z, mu, lv, fm, up)
    (out_k, grads_k), (out_p, grads_p) = kernel(), plain()
    torch.cuda.synchronize()
    max_abs, abs_tol, max_rel, finite = errors(out_k, out_p)
    grad_err = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(grads_k, grads_p))
    finite = finite and all(bool(torch.isfinite(g).all().item()) for g in grads_k)
    # work this run's data needs: 189 valid components for each of 192
    # samples; per (sample, component, dim) ~10 operations forward, ~14 for
    # grad z and ~18 for grad mu / logvar (exps counted as one)
    pairs = BUCKET * TRIAL * d
    n_ops = 42 * pairs
    nbytes = 4 * (3 * BUCKET * d + BUCKET + 3) + 4 * (3 + 3 + 3 * BUCKET * d)
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(phase='kl_check', kernel='decomposed_kl', layer='D=%d' % d, frames=BUCKET,
               real_frames=TRIAL, latents=d, values=out_k.tolist(),
               plain_values=out_p.tolist(), max_abs_err=max_abs, abs_tol=abs_tol,
               max_rel_err=max_rel, rel_tol=REL_TOL, grad_rel_err=grad_err,
               grad_rel_tol=KL_GRAD_REL_TOL, mflop=n_ops / 1e6, mbytes=nbytes / 1e6,
               ms=median_ms(kernel), fwd_ms=median_ms(forward), plain_ms=median_ms(plain),
               library_ms=None, bound_ms=max(t_ops, t_bytes), t_ops_ms=t_ops,
               t_bytes_ms=t_bytes, bound_by='operations' if t_ops >= t_bytes else 'bytes')
    emit(rec)
    if not finite or max_abs > abs_tol or max_rel > REL_TOL or grad_err > KL_GRAD_REL_TOL:
        raise AssertionError('K7 disagrees with its plain version: %s' % rec)
    return rec


def read_metrics(vdir):
    """Every loss and metric column ``fit`` logged, as floats."""
    with open(os.path.join(vdir, 'metrics.csv'), newline='') as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) for r in rows if r.get(k)]
            for k in rows[0] if k.split('_')[0] in ('tr', 'val', 'test')}


def fit_vae(port, hp, tmp, mc, source):
    """Main paths 3 and 4: ``fit`` of a VAE-family model on the card, every
    logged number finite and K1-K7 all launched inside it."""
    ops = port.ops
    hp = dict(hp, model_class=mc, learning_rate=LEARNING_RATE, l2_reg=L2_REG,
              rng_seed_train=SEED, max_n_epochs=VAE_FIT_EPOCHS, min_n_epochs=1,
              val_check_interval=1, enable_early_stop=False, early_stop_history=10,
              export_latents=False, rng_seed_data=SEED, device=DEVICE,
              experiment_name=mc, **VAE_CLASSES[mc])
    exp = port.experiment.Experiment(mc, tmp)
    hp['expt_dir'] = os.path.join(tmp, mc)
    vdir = os.path.join(hp['expt_dir'], 'version_%d' % exp.version)
    model = {'ps-vae': port.vaes.PSVAE, 'beta-tcvae': port.vaes.BetaTCVAE}[mc](hp)

    # the main path: every launch from here to the read below is counted
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    best = port.training.fit(hp, model, source, exp)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    logged = read_metrics(vdir)
    finite = all(len(v) and np.isfinite(v).all() for v in logged.values())
    emit(dict(phase='fit', model_class=mc, epochs=list(range(VAE_FIT_EPOCHS + 1)),
              train_trials=source.n_tot_batches['train'], seconds=fit_s,
              launches=launches, finite=finite,
              losses={k: v for k, v in logged.items() if 'loss' in k or 'r2' in k}))
    missing = [k for k in VAE_KERNELS if launches[k] == 0]
    if missing or not finite:
        raise AssertionError('%s fit never launched %s or logged non-finite numbers'
                             % (mc, missing))
    return dict(hp, version=exp.version), model, vdir, best, launches


def plain_psvae_loss(model, ops, losses, batch, eps, kw):
    """The PS-VAE's loss (JAX: vaes.py:294) through the plain versions only:
    cuDNN convs, ``mse_plain`` for both log-likelihoods, the plain KL terms."""
    k = model.n_labels
    flat = plain_features(model, ops, batch['images'])
    mu_ff, logvar = model.encoding.FF(flat), model.encoding.logvar(flat)
    y = model.encoding.A(mu_ff)
    mu = torch.cat([y, model.encoding.B(mu_ff)], dim=1)
    z = eps * torch.exp(logvar) + mu
    fm = batch['frame_mask']

    def ll(pred, target):
        n = pred[0].numel()
        return -0.5 * losses.LN2PI * n - 0.5 * n * losses.mse_plain(pred, target, None, fm)[0]
    mi, tc, dwkl = losses.decomposed_kl_plain(z[:, k:], mu[:, k:], logvar[:, k:], fm)
    return -ll(plain_decode(model, ops, z), batch['images']) \
        - kw['alpha'] * ll(model.encoding.D(y), batch['labels']) \
        + losses.kl_div_to_std_normal(mu[:, :k], logvar[:, :k], fm) \
        + kw['kl'] * mi + kw['beta'] * tc + kw['kl'] * dwkl


def psvae_step(port, hp, model, source):
    """A PS-VAE train step on the card at the annealed loss weights: its
    gradients against the plain path's with the same eps, its time beside
    the plain step's (cuDNN autograd, torch's fused AMSGrad), and its
    profile."""
    ops, losses = port.ops, port.losses
    images = np.zeros((BUCKET,) + source.trials[0].shape[1:], np.uint8)
    images[:TRIAL] = source.trials[0]
    labels = np.zeros((BUCKET, N_LABELS), np.float32)
    labels[:TRIAL] = source.labels[0]
    frame_mask = np.zeros(BUCKET, np.float32)
    frame_mask[:TRIAL] = 1.0
    host_batch = {'images': images, 'labels': labels, 'frame_mask': frame_mask}
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host_batch.items()}
    kw = model.loss_kwargs(len(model.beta_vals) - 1)   # alpha 1000, beta 5, kl 1

    def generator():
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED)
        return gen
    model.zero_grad(set_to_none=True)
    loss_k = model.loss_fn(batch, generator=generator(), **kw)[0]
    loss_k.backward()
    grads_k = {k: p.grad.clone() for k, p in model.named_parameters()}
    # the same draw reparameterize makes from the same generator state
    eps = torch.randn((BUCKET, N_LATENTS), generator=generator(), device=DEVICE)
    model.zero_grad(set_to_none=True)
    loss_p = plain_psvae_loss(model, ops, losses, batch, eps, kw)
    loss_p.backward()
    grad_errs = {k: (grads_k[k] - p.grad).abs().max().item()
                 / max(p.grad.abs().max().item(), 1e-30)
                 for k, p in model.named_parameters()}
    worst = max(grad_errs, key=grad_errs.get)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    emit(dict(phase='psvae_grads', frames=BUCKET, loss_weights=kw, loss=loss_k.item(),
              plain_loss=loss_p.item(), loss_rel_err=loss_err, rel_tol=GRAD_REL_TOL,
              max_rel_err=grad_errs[worst], worst=worst, rel_err=grad_errs))
    if grad_errs[worst] > GRAD_REL_TOL or loss_err > GRAD_REL_TOL:
        raise AssertionError('PS-VAE gradients on the card disagree with the plain '
                             'path: %s=%.3g, loss %.3g' % (worst, grad_errs[worst], loss_err))

    opt = port.optim.AMSGrad(model.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG)
    twin = port.vaes.PSVAE(hp).to(DEVICE)
    twin.load_state_dict(model.state_dict())
    adam = torch.optim.Adam(twin.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG,
                            amsgrad=True, fused=True)
    gen = generator()

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss_fn(batch, generator=gen, **kw)[0].backward()
        opt.step()

    def plain_step():
        adam.zero_grad(set_to_none=True)
        noise = torch.randn((BUCKET, N_LATENTS), generator=gen, device=DEVICE)
        plain_psvae_loss(twin, ops, losses, batch, noise, kw).backward()
        adam.step()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    step()
    torch.cuda.synchronize()
    per_step = dict(ops.LAUNCHES)
    ms, plain_ms = request_ms(step), request_ms(plain_step)
    rec = dict(phase='psvae_step', frames=TRIAL, bucket=BUCKET, ms=ms,
               frames_per_s=TRIAL / ms * 1e3, plain_ms=plain_ms,
               plain_frames_per_s=TRIAL / plain_ms * 1e3, launches_per_step=per_step)
    emit(rec)
    emit(profile_steps(lambda: step_from_host(step, host_batch, batch),
                       phase='psvae_profile'))
    return per_step, rec


def serve_psvae(port, hp, vdir, best, source):
    """Main path 5: the fitted PS-VAE's ``best_val_model.pt`` serves through
    ``load_version``: ``encode`` gives [y, w] and ``reconstruct`` decodes it,
    both within 1e-4 of the plain path on the card."""
    ops = port.ops
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(dict(hp, training_completed=True), f)
    frames = source.trials[0]
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bundle = port.serving.load_version(vdir)
    latents, recon = bundle.encode(frames), bundle.reconstruct(frames)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    served = dict(bundle.model.state_dict())
    same = all(torch.equal(served[k].cpu(), v) for k, v in
               port.weights.params_to_state_dict(bundle.model, best).items())
    with torch.inference_mode():
        model = bundle.model
        mu_ff = model.encoding.FF(plain_features(model, ops, bundle._frames(frames)))
        ref_z = torch.cat([model.encoding.A(mu_ff), model.encoding.B(mu_ff)], dim=1)
        ref_y = plain_decode(model, ops, ref_z)
    errs = {head: ((out - ref).abs().max().item(),
                   SERVE_ABS_TOL * max(1.0, ref.abs().max().item()))
            for head, out, ref in (('encode', latents, ref_z), ('reconstruct', recon, ref_y))}
    ok = same and tuple(latents.shape) == (TRIAL, N_LATENTS) and \
        tuple(recon.shape) == (TRIAL, IMG[1], IMG[2], IMG[0]) and \
        all(e <= tol for e, tol in errs.values()) and \
        bool(torch.isfinite(latents).all().item() and torch.isfinite(recon).all().item())
    rec = dict(phase='serve_psvae', frames=TRIAL, weights_equal=same,
               encode_shape=list(latents.shape), max_abs_err={h: e for h, (e, _) in errs.items()},
               tol={h: t for h, (_, t) in errs.items()}, launches=launches, ok=ok,
               encode_ms=request_ms(lambda: bundle.encode(frames)),
               reconstruct_ms=request_ms(lambda: bundle.reconstruct(frames)))
    emit(rec)
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing or not ok:
        raise AssertionError('the fitted PS-VAE does not serve: missing %s, %s'
                             % (missing, rec))
    return launches


# ------------------------------------------------------------------ ARHMM


def reset_launches(build):
    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0


def bound(n_ops, n_bytes):
    """The least time of a call: the larger of its operations at the f32
    peak and its bytes (each input read once, each output written once) at
    the memory rate."""
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), t_ops_ms=t_ops, t_bytes_ms=t_bytes,
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def sample_arhmm(n, frames, k, d, seed):
    """(n, frames, d) float32 trials from a seeded AR(1) HMM with k states:
    dynamics 0.9 times a random rotation, offsets of scale 0.3, noise 0.1,
    a state kept with probability 0.95 a frame."""
    rs = np.random.RandomState(seed)
    A = 0.9 * np.linalg.qr(rs.randn(k, d, d))[0]
    b = 0.3 * rs.randn(k, d)
    z = rs.randint(k, size=n)
    x = np.zeros((n, frames, d))
    x[:, 0] = rs.randn(n, d)
    for t in range(1, frames):
        z = np.where(rs.rand(n) < 0.95, z, rs.randint(k, size=n))
        x[:, t] = np.einsum('nde,ne->nd', A[z], x[:, t - 1]) + b[z] + 0.1 * rs.randn(n, d)
    return x.astype(np.float32)


@contextlib.contextmanager
def plain_arhmm(port):
    """Route the ARHMM's kernel entry points to their plain versions: K8's
    ``log_likes`` and ``robust_log_likes``, K9's ``forward_backward`` and
    ``log_normalizer``, K10's ``viterbi`` and the M-step's K11
    ``solve_small``, for the plain twin of a run on the card."""
    am, hmm = port.arhmm, port.hmm

    def log_likes(x, mask, As, bs, Sigmas, lags, diagonal):
        prec, logdet = am.obs_precision(Sigmas, diagonal)
        return am.log_likes_plain(x, mask, As, bs, prec, logdet, lags, diagonal)

    def robust_log_likes(x, mask, As, bs, Sigmas, nus, lags, diagonal, with_tau=False):
        prec, logdet = am.obs_precision(Sigmas, diagonal)
        nus, c = am.student_t_terms(nus, logdet, x.shape[2])
        return am.robust_log_likes_plain(x, mask, As, bs, prec, c, nus, lags, diagonal,
                                         with_tau)
    routes = ((am, 'log_likes', log_likes), (am, 'robust_log_likes', robust_log_likes),
              (am, 'solve_small', port.smallmat.solve_small_plain),
              (hmm, 'forward_backward', hmm.forward_backward_plain),
              (hmm, 'log_normalizer', lambda *a: hmm.forward_plain(*a)[1]),
              (hmm, 'viterbi', hmm.viterbi_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    for mod, name, fn in routes:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def em_workload(port):
    """The EM workload on the card (100 trials of 1000 frames, D = 9, from a
    seeded 16-state ARHMM) and a 16-state model initialized on it."""
    datas = list(sample_arhmm(EM_TRIALS, EM_FRAMES, EM_STATES, EM_DIM, SEED + 4))
    model = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, device=DEVICE)
    t0 = time.perf_counter()
    model.initialize(datas)
    init_s = time.perf_counter() - t0
    return model, model.pad(datas), init_s


def check_arhmm_log_likes(port, model, trials):
    """K8 against its plain version on the EM workload: full covariance (the
    main path) and diagonal."""
    am = port.arhmm
    x, mask = trials
    p = model.params
    N, T, D = x.shape
    K = p['bs'].shape[0]
    cases = {}
    for diagonal in (False, True):
        prec, logdet = am.obs_precision(p['Sigmas'], diagonal)
        args = (x, mask, p['As'], p['bs'], prec, logdet, model.lags, diagonal)
        out_k, out_p = am.log_likes_cuda(*args), am.log_likes_plain(*args)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        tol = LL_ABS_TOL * max(1.0, out_p.abs().max().item())
        finite = bool(torch.isfinite(out_k).all().item())
        del out_k, out_p
        P = D * model.lags
        # per frame past the lags and state: mu (D P multiply-adds), bias and
        # difference (2 D), then the lower-triangular L^-1 product (D (D + 1) / 2
        # multiply-adds) and the squares summed (2 D), or with diagonal
        # covariance a square, divide and add per dimension (3 D)
        per_state = 2 * D * P + (5 * D if diagonal else D * (D + 1) + 4 * D)
        n_ops = N * (T - model.lags) * K * per_state
        n_bytes = 4 * (x.numel() + mask.numel() + N * T * K + p['As'].numel()
                       + p['bs'].numel() + prec.numel() + K)
        cases['diagonal' if diagonal else 'full'] = dict(
            max_abs_err=err, abs_tol=tol, finite=finite,
            ms=median_ms(lambda: am.log_likes_cuda(*args)),
            plain_ms=median_ms(lambda: am.log_likes_plain(*args), samples=3, inner=2),
            gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
    rec = dict(phase='arhmm_kernel_check', kernel='arhmm_log_likes', layer='full',
               frames=N * T, trials=N, states=K, dim=D, library_ms=None, cases=cases,
               **{k: v for k, v in cases['full'].items() if k != 'finite'})
    emit(rec)
    bad = [c for c, v in cases.items()
           if not v['finite'] or v['max_abs_err'] > v['abs_tol']]
    if bad:
        raise AssertionError('K8 disagrees with its plain version (%s): %s' % (bad, rec))
    return rec


def check_forward_backward(port, model, trials):
    """K9 against its plain version on the EM workload's log-likelihoods and
    on a copy with every tenth trial cut to 700 frames."""
    hmm = port.hmm
    x, mask = trials
    p = model.params
    pi0, lp = p['log_pi0'], model._log_P(p)
    ll = model._log_likes(p, x, mask)
    cut = mask.clone()
    cut[::10, EM_CUT:] = 0.0
    N, T, K = ll.shape
    cases = {}
    for name, m in (('full', mask), ('cut', cut)):
        llm = ll * m[:, :, None]
        (g_k, z_k, xi_k), (g_p, z_p, xi_p) = (hmm.forward_backward_cuda(pi0, lp, llm, m),
                                              hmm.forward_backward_plain(pi0, lp, llm, m))
        fz_k = hmm.log_normalizer_cuda(pi0, lp, llm, m)
        torch.cuda.synchronize()
        frames = m.sum().item()
        n_ops = (20 * K * K + 6 * K) * frames
        n_bytes = 4 * (llm.numel() + m.numel() + K * K + K + g_k.numel() + N + xi_k.numel())
        cases[name] = dict(
            frames=frames,
            log_z_rel_err=((z_k - z_p).abs() / z_p.abs()).max().item(),
            forward_log_z_rel_err=((fz_k - z_p).abs() / z_p.abs()).max().item(),
            max_abs_err=(g_k - g_p).abs().max().item(),
            xi_rel_err=(xi_k - xi_p).abs().max().item() / xi_p.abs().max().item(),
            padded_gamma_zero=bool((g_k[m == 0] == 0).all().item()),
            finite=bool(torch.isfinite(g_k).all().item() and torch.isfinite(xi_k).all().item()),
            ms=median_ms(lambda: hmm.forward_backward_cuda(pi0, lp, llm, m)),
            fwd_ms=median_ms(lambda: hmm.log_normalizer_cuda(pi0, lp, llm, m)),
            plain_ms=median_ms(lambda: hmm.forward_backward_plain(pi0, lp, llm, m),
                               samples=3, inner=1, warmup=1),
            gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
    rec = dict(phase='arhmm_kernel_check', kernel='hmm_forward_backward', layer='full',
               frames=N * T, trials=N, states=K, log_z_rel_tol=LOGZ_REL_TOL,
               abs_tol=GAMMA_ABS_TOL, xi_rel_tol=XI_REL_TOL, library_ms=None,
               bound_note='the T-step dependence chain of the recursions, not these',
               cases=cases, **{k: v for k, v in cases['full'].items()
                               if k not in ('finite', 'padded_gamma_zero', 'frames')})
    emit(rec)
    bad = [c for c, v in cases.items() if not v['finite'] or not v['padded_gamma_zero']
           or max(v['log_z_rel_err'], v['forward_log_z_rel_err']) > LOGZ_REL_TOL
           or v['max_abs_err'] > GAMMA_ABS_TOL or v['xi_rel_err'] > XI_REL_TOL]
    if bad:
        raise AssertionError('K9 disagrees with its plain version (%s): %s' % (bad, rec))
    return rec


def check_viterbi(port, model, trials):
    """K10 against its plain version on the EM workload: paths equal on at
    least 99.9% of the frames, and each path's joint log-probability within
    1e-5 of the plain path's."""
    hmm = port.hmm
    x, mask = trials
    p = model.params
    pi0, lp = p['log_pi0'], model._log_P(p)
    ll = model._log_likes(p, x, mask)
    N, T, K = ll.shape
    path_k, path_p = hmm.viterbi_cuda(pi0, lp, ll, mask), hmm.viterbi_plain(pi0, lp, ll, mask)
    torch.cuda.synchronize()
    lp_k = hmm.path_log_prob(pi0, lp, ll, mask, path_k)
    lp_p = hmm.path_log_prob(pi0, lp, ll, mask, path_p)
    agree = (path_k == path_p).float().mean().item()
    lp_rel = ((lp_k - lp_p).abs() / lp_p.abs()).max().item()
    frames = mask.sum().item()
    n_ops = 2 * K * K * frames
    n_bytes = 4 * (ll.numel() + mask.numel() + K * K + K + path_k.numel())
    rec = dict(phase='arhmm_kernel_check', kernel='hmm_viterbi', layer='full', frames=N * T,
               trials=N, states=K, path_agreement=agree, agree_tol=PATH_AGREE,
               path_log_prob_rel_err=lp_rel, rel_tol=PATH_LP_REL_TOL,
               max_abs_err=(lp_k - lp_p).abs().max().item(),
               ms=median_ms(lambda: hmm.viterbi_cuda(pi0, lp, ll, mask)),
               plain_ms=median_ms(lambda: hmm.viterbi_plain(pi0, lp, ll, mask),
                                  samples=3, inner=1, warmup=1),
               library_ms=None, gflop=n_ops / 1e9, mbytes=n_bytes / 1e6,
               bound_note='the T-step dependence chain and the backtrace, not these',
               **bound(n_ops, n_bytes))
    emit(rec)
    if agree < PATH_AGREE or lp_rel > PATH_LP_REL_TOL:
        raise AssertionError('K10 disagrees with its plain version: %s' % rec)
    return rec


def check_solve_small(port, model, trials):
    """K11 at the systems one EM iteration's M-step solves on the EM workload
    (16 equilibrated, ridged (10, 10) normal equations, 9 right-hand
    sides), against its plain version and ``torch.linalg.solve``."""
    am, sm = port.arhmm, port.smallmat
    seen = []
    real = am.solve_small

    def capture(A, Y):
        seen.append((A.clone(), Y.clone()))
        return real(A, Y)
    am.solve_small = capture
    try:
        model._em_step(model.params, *trials)
    finally:
        am.solve_small = real
    A, Y = seen[0]
    x_k, x_p = sm.solve_small_cuda(A, Y), sm.solve_small_plain(A, Y)
    torch.cuda.synchronize()
    scale = x_p.abs().max().item()
    err = (x_k - x_p).abs().max().item()
    B, n, k = Y.shape
    n_ops = 2 * B * n * n * (n + k)
    n_bytes = 4 * (A.numel() + 2 * Y.numel())
    rec = dict(phase='arhmm_kernel_check', kernel='solve_small', layer='m_step', frames=B,
               systems=B, a_shape=list(A.shape), y_shape=list(Y.shape), max_abs_err=err,
               rel_err=err / scale, rel_tol=SOLVE_REL_TOL,
               ms=median_ms(lambda: sm.solve_small_cuda(A, Y)),
               plain_ms=median_ms(lambda: sm.solve_small_plain(A, Y)),
               library_ms=median_ms(lambda: torch.linalg.solve(A, Y)),
               **bound(n_ops, n_bytes))
    emit(rec)
    if not bool(torch.isfinite(x_k).all().item()) or err > SOLVE_REL_TOL * scale:
        raise AssertionError('K11 disagrees with its plain version: %s' % rec)
    return rec


def recurrent_arhmm(port, model, transitions, observations):
    """A fresh ``transitions`` / ``observations`` ARHMM at the EM shapes
    (its own seeded Rs, r and dof 4) holding ``model``'s initialized
    ``log_pi0``, ``log_Ps`` and AR params."""
    m = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, observations=observations,
                         transitions=transitions, rng_seed=SEED, device=DEVICE)
    m.params.update({k: model.params[k].clone()
                     for k in ('log_pi0', 'log_Ps', 'As', 'bs', 'Sigmas')})
    return m


def recurrent_models(port, model):
    """Seeded recurrent + robust ARHMMs for the kernel checks: one with
    'recurrent' transitions (observations 'robust_ar'), one with
    'recurrent_only' ('diagonal_robust_ar'), their dofs drawn in [2, 10] and
    Rs (and r) at REC_DRIVE, so the drive Rs x_t moves log_P from step to
    step."""
    rs = np.random.RandomState(SEED + 9)
    out = {}
    for transitions, obs in (('recurrent', 'robust_ar'),
                             ('recurrent_only', 'diagonal_robust_ar')):
        m = recurrent_arhmm(port, model, transitions, obs)
        m.params.update(m._tensors({
            'nus': rs.uniform(2, 10, EM_STATES), 'Rs': REC_DRIVE * rs.randn(EM_STATES, EM_DIM),
            'r': REC_DRIVE * rs.randn(EM_STATES)}))
        out[transitions] = m
    return out


def check_robust_log_likes(port, model, trials):
    """K8's Student's-t launcher against its plain version on the EM
    workload: log-likelihoods and the scale-mixture weights tau (the first
    frame's from the wrapped history), full covariance and diagonal."""
    am = port.arhmm
    x, mask = trials
    p = model.params
    N, T, D = x.shape
    K = p['bs'].shape[0]
    cases = {}
    for diagonal in (False, True):
        prec, logdet = am.obs_precision(p['Sigmas'], diagonal)
        nus, c = am.student_t_terms(p['nus'], logdet, D)
        args = (x, mask, p['As'], p['bs'], prec, c, nus, model.lags, diagonal, True)
        (ll_k, tau_k), (ll_p, tau_p) = am.robust_log_likes_cuda(*args), \
            am.robust_log_likes_plain(*args)
        torch.cuda.synchronize()
        ll_err = (ll_k - ll_p).abs().max().item()
        tau_err = (tau_k - tau_p).abs().max().item()
        finite = bool(torch.isfinite(ll_k).all().item() and torch.isfinite(tau_k).all().item())
        ll_tol = LL_ABS_TOL * max(1.0, ll_p.abs().max().item())
        tau_tol = LL_ABS_TOL * max(1.0, tau_p.abs().max().item())
        del ll_k, tau_k, ll_p, tau_p
        P = D * model.lags
        # K8's Gaussian work per frame past the lags and state, then the
        # Student's-t terms: a divide, a log1p, a multiply-add for ll and an
        # add and a divide for tau; tau's frames include the first ones
        per_state = 2 * D * P + (5 * D if diagonal else D * (D + 1) + 4 * D) + 6
        n_ops = N * T * K * per_state
        n_bytes = 4 * (x.numel() + mask.numel() + 2 * N * T * K + p['As'].numel()
                       + p['bs'].numel() + prec.numel() + 2 * K)
        cases['diagonal' if diagonal else 'full'] = dict(
            max_abs_err=max(ll_err, tau_err), ll_max_abs_err=ll_err, ll_abs_tol=ll_tol,
            tau_max_abs_err=tau_err, tau_abs_tol=tau_tol, finite=finite,
            ms=median_ms(lambda: am.robust_log_likes_cuda(*args)),
            plain_ms=median_ms(lambda: am.robust_log_likes_plain(*args), samples=3, inner=2),
            gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
    rec = dict(phase='arhmm_kernel_check', kernel='arhmm_log_likes_robust', layer='full',
               frames=N * T, trials=N, states=K, dim=D, library_ms=None, cases=cases,
               **{k: v for k, v in cases['full'].items() if k != 'finite'})
    emit(rec)
    bad = [c for c, v in cases.items() if not v['finite'] or v['ll_max_abs_err'] >
           v['ll_abs_tol'] or v['tau_max_abs_err'] > v['tau_abs_tol']]
    if bad:
        raise AssertionError('K8 (robust) disagrees with its plain version (%s): %s'
                             % (bad, rec))
    return rec


def check_forward_backward_tv(port, models, trials):
    """K9's time-varying launcher against its plain version on the EM
    workload: gamma, log_Z, xi_sum and the per-step xi, with log_P (100,
    999, 16, 16) from the seeded 'recurrent' model over full trials and
    from the 'recurrent_only' one over a copy with every tenth trial cut to
    700 frames; and the forward pass alone. log_Z within LOGZ_REL_TOL and
    xi_sum within XI_REL_TOL of the plain version's; gamma and xi within
    GAMMA_ABS_TOL, or twice the plain float32 version's own distance, of
    the plain version run in float64."""
    hmm = port.hmm
    x, mask = trials
    cut = mask.clone()
    cut[::10, EM_CUT:] = 0.0
    cases = {}
    for name, m in (('recurrent', mask), ('recurrent_only', cut)):
        model = models[name]
        p = model.params
        pi0, lp = p['log_pi0'], model._log_P(p, x)
        ll = model._log_likes(p, x, m)
        N, T, K = ll.shape
        out_k = hmm.forward_backward_cuda(pi0, lp, ll, m, with_xi=True)
        out_p = hmm.forward_backward_plain(pi0, lp, ll, m, with_xi=True)
        g_d, _, _, xi_d = hmm.forward_backward_plain(pi0.double(), lp.double(), ll.double(),
                                                     m.double(), with_xi=True)
        fz_k = hmm.log_normalizer_cuda(pi0, lp, ll, m)
        torch.cuda.synchronize()
        (g_k, z_k, s_k, xi_k), (g_p, z_p, s_p, xi_p) = out_k, out_p
        # |alpha| reaches ~|log_Z| ~ 1e4 after 1000 steps, where one float32
        # ulp is ~1e-3 in log space: the kernel is held to the float64
        # posteriors within twice the plain float32 version's own error
        vs_f64 = {name: max((g.double() - g_d).abs().max().item(),
                            (xi.double() - xi_d).abs().max().item())
                  for name, g, xi in (('kernel', g_k, xi_k), ('plain', g_p, xi_p))}
        del g_d, xi_d
        pair = (m[:, :-1] * m[:, 1:]) == 0
        frames = m.sum().item()
        n_ops = (20 * K * K + 6 * K) * frames
        n_bytes = 4 * (ll.numel() + m.numel() + lp.numel() + K + g_k.numel() + N
                       + s_k.numel() + xi_k.numel())
        cases[name] = dict(
            frames=frames,
            log_z_rel_err=((z_k - z_p).abs() / z_p.abs()).max().item(),
            forward_log_z_rel_err=((fz_k - z_p).abs() / z_p.abs()).max().item(),
            max_abs_err=max((g_k - g_p).abs().max().item(), (xi_k - xi_p).abs().max().item()),
            gamma_max_abs_err=(g_k - g_p).abs().max().item(),
            xi_max_abs_err=(xi_k - xi_p).abs().max().item(),
            xi_sum_rel_err=(s_k - s_p).abs().max().item() / s_p.abs().max().item(),
            max_abs_log_z=z_p.abs().max().item(), kernel_err_vs_f64=vs_f64['kernel'],
            plain_err_vs_f64=vs_f64['plain'],
            posterior_tol=max(GAMMA_ABS_TOL, 2 * vs_f64['plain']),
            padded_zero=bool((g_k[m == 0] == 0).all().item() and (xi_k[pair] == 0).all().item()),
            finite=bool(torch.isfinite(g_k).all().item() and torch.isfinite(xi_k).all().item()),
            ms=median_ms(lambda: hmm.forward_backward_cuda(pi0, lp, ll, m, with_xi=True)),
            xi_sum_only_ms=median_ms(lambda: hmm.forward_backward_cuda(pi0, lp, ll, m)),
            fwd_ms=median_ms(lambda: hmm.log_normalizer_cuda(pi0, lp, ll, m)),
            plain_ms=median_ms(lambda: hmm.forward_backward_plain(pi0, lp, ll, m, with_xi=True),
                               samples=3, inner=1, warmup=1),
            gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
        del out_k, out_p, g_k, g_p, xi_k, xi_p, lp
    rec = dict(phase='arhmm_kernel_check', kernel='hmm_forward_backward_tv', layer='full',
               frames=EM_TRIALS * EM_FRAMES, trials=EM_TRIALS, states=EM_STATES,
               log_z_rel_tol=LOGZ_REL_TOL, abs_tol=GAMMA_ABS_TOL, xi_rel_tol=XI_REL_TOL,
               library_ms=None,
               bound_note='the T-step dependence chain of the recursions, not these',
               cases=cases, **{k: v for k, v in cases['recurrent'].items()
                               if k not in ('finite', 'padded_zero', 'frames')})
    emit(rec)
    bad = [c for c, v in cases.items() if not v['finite'] or not v['padded_zero']
           or max(v['log_z_rel_err'], v['forward_log_z_rel_err']) > LOGZ_REL_TOL
           or v['kernel_err_vs_f64'] > v['posterior_tol'] or v['xi_sum_rel_err'] > XI_REL_TOL]
    if bad:
        raise AssertionError('K9 (time-varying) disagrees with its plain version (%s): %s'
                             % (bad, rec))
    return rec


def check_viterbi_tv(port, models, trials):
    """K10's time-varying launcher against its plain version on the EM
    workload with the seeded 'recurrent' model's log_P: paths equal on at
    least 99.9% of the frames, each path's joint log-probability within
    1e-5 of the plain path's."""
    hmm = port.hmm
    x, mask = trials
    model = models['recurrent']
    p = model.params
    pi0, lp = p['log_pi0'], model._log_P(p, x)
    ll = model._log_likes(p, x, mask)
    N, T, K = ll.shape
    path_k, path_p = hmm.viterbi_cuda(pi0, lp, ll, mask), hmm.viterbi_plain(pi0, lp, ll, mask)
    torch.cuda.synchronize()
    lp_k = hmm.path_log_prob(pi0, lp, ll, mask, path_k)
    lp_p = hmm.path_log_prob(pi0, lp, ll, mask, path_p)
    agree = (path_k == path_p).float().mean().item()
    lp_rel = ((lp_k - lp_p).abs() / lp_p.abs()).max().item()
    frames = mask.sum().item()
    n_ops = 2 * K * K * frames
    n_bytes = 4 * (ll.numel() + mask.numel() + lp.numel() + K + path_k.numel())
    rec = dict(phase='arhmm_kernel_check', kernel='hmm_viterbi_tv', layer='full', frames=N * T,
               trials=N, states=K, path_agreement=agree, agree_tol=PATH_AGREE,
               path_log_prob_rel_err=lp_rel, rel_tol=PATH_LP_REL_TOL,
               max_abs_err=(lp_k - lp_p).abs().max().item(),
               ms=median_ms(lambda: hmm.viterbi_cuda(pi0, lp, ll, mask)),
               plain_ms=median_ms(lambda: hmm.viterbi_plain(pi0, lp, ll, mask),
                                  samples=3, inner=1, warmup=1),
               library_ms=None, gflop=n_ops / 1e9, mbytes=n_bytes / 1e6,
               bound_note='the T-step dependence chain and the backtrace, not these',
               **bound(n_ops, n_bytes))
    emit(rec)
    if agree < PATH_AGREE or lp_rel > PATH_LP_REL_TOL:
        raise AssertionError('K10 (time-varying) disagrees with its plain version: %s' % rec)
    return rec


def arhmm_em(port, model, trials, init_s):
    """Main path 6a: ``ARHMM.fit`` from ``initialize``, 20 EM iterations of
    the EM workload on the card; then an iteration's time beside the same
    EM through the plain versions, and its profile."""
    build = port.build
    reset_launches(build)
    t0 = time.perf_counter()
    lls = model.fit(trials, num_iters=EM_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    finite = bool(np.isfinite(lls).all())
    rising = all(b >= a - EM_LL_REL_TOL * abs(a) for a, b in zip(lls, lls[1:]))
    missing = [k for k in EM_KERNELS if launches[k] < EM_ITERS]

    def step(m=model):
        m.fit(trials, num_iters=1)
    twin = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, device=DEVICE)
    twin.params = dict(model.params)
    ms = request_ms(step, reps=EM_TIMED_ITERS, warmup=2)
    with plain_arhmm(port):
        plain_ms = request_ms(lambda: step(twin), reps=EM_TIMED_ITERS, warmup=2)
    rec = dict(phase='arhmm_em', trials=EM_TRIALS, frames_per_trial=EM_FRAMES,
               states=EM_STATES, dim=EM_DIM, iterations=EM_ITERS, init_seconds=init_s,
               fit_seconds=fit_s, lls=lls, finite=finite, non_decreasing=rising,
               launches=launches,
               launches_per_iteration={k: launches[k] / EM_ITERS for k in ARHMM_KERNELS},
               ms_per_iteration=ms, iterations_per_s=1e3 / ms,
               plain_ms_per_iteration=plain_ms, plain_iterations_per_s=1e3 / plain_ms)
    emit(rec)
    if missing or not finite or not rising:
        raise AssertionError('EM on the card failed (missing %s): %s' % (missing, rec))
    emit(profile_steps(step, phase='arhmm_em_profile', frames=EM_TRIALS * EM_FRAMES,
                       bucket=None))
    return launches


def arhmm_em_recurrent(port, model, trials):
    """Main path 6b: ``ARHMM.fit`` of a recurrent + robust ARHMM
    (:func:`recurrent_arhmm`: 'recurrent' transitions, 'robust_ar'
    observations) for REC_EM_ITERS iterations
    on the card: every LL finite, the last above the first, K8's robust
    launcher, K9's time-varying one and K11 every iteration. Before it, one
    iteration from the same params on the card and through the plain
    versions (LL and every parameter); after it, an iteration's time beside
    the plain EM's, and its profile."""
    build = port.build
    x, mask = trials
    p0 = dict(model.params)
    new_k, ll_k = model._em_step(p0, x, mask)
    with plain_arhmm(port):
        new_p, ll_p = model._em_step(p0, x, mask)
    torch.cuda.synchronize()
    ll_rel = abs(ll_k.item() - ll_p.item()) / abs(ll_p.item())
    param_err = {k: (new_k[k] - new_p[k]).abs().max().item()
                 / max(new_p[k].abs().max().item(), 1e-30) for k in new_p}
    del new_k, new_p

    reset_launches(build)
    t0 = time.perf_counter()
    lls = model.fit(trials, num_iters=REC_EM_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    finite = bool(np.isfinite(lls).all())
    rising = lls[-1] > lls[0]
    missing = [k for k in RECURRENT_EM_KERNELS if launches[k] < REC_EM_ITERS]

    def step(m=model):
        m.fit(trials, num_iters=1)
    twin = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, observations=model.observations,
                            transitions=model.transitions, rng_seed=SEED, device=DEVICE)
    twin.params = dict(model.params)
    ms = request_ms(step, reps=EM_TIMED_ITERS, warmup=2)
    with plain_arhmm(port):
        plain_ms = request_ms(lambda: step(twin), reps=EM_TIMED_ITERS, warmup=2)
    rec = dict(phase='arhmm_em_recurrent', transitions=model.transitions,
               observations=model.observations, trials=EM_TRIALS, frames_per_trial=EM_FRAMES,
               states=EM_STATES, dim=EM_DIM, iterations=REC_EM_ITERS, fit_seconds=fit_s,
               lls=lls, finite=finite, last_above_first=rising, launches=launches,
               launches_per_iteration={k: launches[k] / REC_EM_ITERS
                                       for k in RECURRENT_KERNELS},
               one_iteration=dict(ll=ll_k.item(), plain_ll=ll_p.item(), ll_rel_err=ll_rel,
                                  ll_rel_tol=EM_LL_REL_TOL, param_rel_err=param_err,
                                  param_rel_tol=REC_PARAM_REL_TOL),
               ms_per_iteration=ms, iterations_per_s=1e3 / ms,
               plain_ms_per_iteration=plain_ms, plain_iterations_per_s=1e3 / plain_ms,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    emit(rec)
    if missing or not finite or not rising or ll_rel > EM_LL_REL_TOL or \
            max(param_err.values()) > REC_PARAM_REL_TOL:
        raise AssertionError('the recurrent EM on the card failed (missing %s): %s'
                             % (missing, rec))
    emit(profile_steps(step, phase='arhmm_em_recurrent_profile',
                       frames=EM_TRIALS * EM_FRAMES, bucket=None))
    return launches


def write_latents_store(port, save_dir, ids, model_cfg, training_cfg, latents):
    """An upstream AE's completed version (``ae_version: "best"`` finds it)
    holding a latents pickle in the experiment store's format."""
    ae_dir = os.path.join(save_dir, *ids, model_cfg['ae_model_class'],
                          model_cfg['ae_model_type'], '%02i_latents' % model_cfg['n_ae_latents'],
                          model_cfg['ae_experiment_name'], 'version_0')
    os.makedirs(ae_dir)
    with open(os.path.join(ae_dir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump({'rng_seed_data': training_cfg['rng_seed_data'],
                     'trial_splits': training_cfg['trial_splits'],
                     'training_completed': True}, f)
    with open(os.path.join(ae_dir, 'metrics.csv'), 'w', newline='') as f:
        csv.writer(f).writerows([['epoch', 'val_loss'], [0, 1.0]])
    trs = [int(v) for v in training_cfg['trial_splits'].split(';')]
    from behavenet_tpu_torch.data.generator import split_trials
    splits = split_trials(len(latents), training_cfg['rng_seed_data'], *trs)
    with open(os.path.join(ae_dir, '%s_latents.pkl' % '_'.join(ids)), 'wb') as f:
        pickle.dump({'latents': list(latents), 'trials': splits}, f)


def arhmm_cli(port, tmp, kernels=ARHMM_KERNELS, **model):
    """Main path 7: the port's ``arhmm_grid_search`` on the card over the
    published grid (configs/arhmm_jsons/arhmm_model.json, K = 2, 4, 8, 12,
    with the ``model`` keys changed; arhmm_training.json with its 20
    iterations, train plots off; a compute config without a device), on a
    latents pickle of 50 trials of 189 frames from a seeded 8-state ARHMM.
    Every logged loss finite, a states pickle with one path per trial,
    ``kernels`` launched inside it."""
    def load(name):
        with open(os.path.join(ARHMM_CONFIGS, 'arhmm_%s.json' % name)) as f:
            return json.load(f)
    model_cfg, training_cfg, compute_cfg = load('model'), load('training'), load('compute')
    model_cfg.update(model)
    training_cfg['export_train_plots'] = False
    training_cfg['export_states'] = True
    compute_cfg.pop('device')
    ids = ('musall', 'smoke', 'mouse', 'session-0')
    tmp = os.path.join(tmp, 'arhmm_cli_%s_%s' % (model_cfg['transitions'],
                                                 model_cfg['noise_type']))
    save_dir = os.path.join(tmp, 'arhmm_store')
    latents = sample_arhmm(CLI_TRIALS, TRIAL, 8, model_cfg['n_ae_latents'], SEED + 5)
    write_latents_store(port, save_dir, ids, model_cfg, training_cfg, latents)
    data_cfg = dict(zip(('lab', 'expt', 'animal', 'session'), ids), save_dir=save_dir,
                    data_dir=os.path.join(tmp, 'arhmm_data'), all_source='save')
    args = []
    for name, cfg in (('data', data_cfg), ('model', model_cfg), ('training', training_cfg),
                      ('compute', compute_cfg)):
        path = os.path.join(tmp, 'arhmm_%s.json' % name)
        with open(path, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, path]

    seconds = {}

    def timed_main(hp):
        t0 = time.perf_counter()
        port.arhmm_grid_search.main(hp)
        torch.cuda.synchronize()
        seconds[hp['n_arhmm_states']] = time.perf_counter() - t0
    reset_launches(port.build)
    with open(os.path.join(tmp, 'arhmm_cli.log'), 'w') as log, \
            contextlib.redirect_stdout(log):   # the CLI's own progress lines
        port.hyperparams.run_grid_search(timed_main, port.hyperparams.get_all_params(
            'grid_search', args))
    launches = dict(port.build.LAUNCHES)

    results, vdirs = {}, {}
    for k in model_cfg['n_arhmm_states']:
        vdir = os.path.join(save_dir, *ids, model_cfg['model_class'],
                            '%02i_latents' % model_cfg['n_ae_latents'], '%02i_states' % k,
                            model_cfg['transitions'], model_cfg['noise_type'],
                            model_cfg['experiment_name'], 'version_0')
        vdirs[k] = vdir
        logged = read_metrics(vdir)
        with open(os.path.join(vdir, '%s_states.pkl' % '_'.join(ids)), 'rb') as f:
            states = pickle.load(f)['states']
        with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
            completed = pickle.load(f)['training_completed']
        ok_states = len(states) == CLI_TRIALS and all(
            s.dtype == np.int32 and s.shape == (TRIAL,) and 0 <= s.min() and s.max() < k
            for s in states)
        finite = all(len(v) and np.isfinite(v).all() for v in logged.values())
        results[k] = dict(seconds=seconds.get(k), completed=completed, finite=finite,
                          states_ok=ok_states, epochs=len(logged['tr_loss']) // 2,
                          tr_loss=logged['tr_loss'][::2], val_loss=logged['val_loss'][::2])
    missing = [k for k in kernels if launches[k] == 0]
    rec = dict(phase='arhmm_cli', transitions=model_cfg['transitions'],
               noise_type=model_cfg['noise_type'], trials=CLI_TRIALS, frames_per_trial=TRIAL,
               dim=model_cfg['n_ae_latents'], iterations=training_cfg['n_iters'],
               grid=model_cfg['n_arhmm_states'], seconds_per_grid_point=seconds,
               launches=launches, results=results)
    emit(rec)
    if missing or not all(r['completed'] and r['finite'] and r['states_ok']
                          for r in results.values()):
        raise AssertionError('the ARHMM CLI failed (missing %s): %s' % (missing, rec))
    return vdirs[max(vdirs)], latents, launches


def arhmm_serve(port, vdir, latents, kernels=('arhmm_log_likes', 'hmm_forward_backward',
                                               'hmm_viterbi')):
    """Main path 8: a fitted ``best_val_model.pt`` loads through
    ``load_arhmm`` on the card and decodes one trial: the Viterbi path and
    the posteriors against the plain path's on the card, ``kernels``
    launched."""
    hmm = port.hmm
    trial = latents[0]
    reset_launches(port.build)
    model = port.pickles.load_arhmm(os.path.join(vdir, 'best_val_model.pt'))
    path, gamma = model.most_likely_states(trial), model.expected_states(trial)
    torch.cuda.synchronize()
    launches = dict(port.build.LAUNCHES)
    with plain_arhmm(port):
        path_p, gamma_p = model.most_likely_states(trial), model.expected_states(trial)
    x, mask = model.pad([trial])
    p = model.params
    ll = model._log_likes(p, x, mask)
    lps = [hmm.path_log_prob(p['log_pi0'], model._log_P(p, x), ll, mask,
                             torch.from_numpy(z[None]).to(x.device)).item()
           for z in (path, path_p)]
    agree = float(np.mean(path == path_p))
    lp_rel = abs(lps[0] - lps[1]) / abs(lps[1])
    gamma_err = float(np.abs(gamma - gamma_p).max())
    rec = dict(phase='arhmm_serve', transitions=model.transitions,
               observations=model.observations, states=model.K, frames=TRIAL,
               device=str(model.device),
               path_agreement=agree, path_log_prob_rel_err=lp_rel, gamma_max_abs_err=gamma_err,
               launches=launches,
               most_likely_states_ms=request_ms(lambda: model.most_likely_states(trial)),
               expected_states_ms=request_ms(lambda: model.expected_states(trial)))
    emit(rec)
    missing = [k for k in kernels if launches[k] == 0]
    if missing or agree < PATH_AGREE or lp_rel > PATH_LP_REL_TOL or \
            gamma_err > GAMMA_ABS_TOL or model.device.type != torch.device(DEVICE).type:
        raise AssertionError('the fitted ARHMM does not serve (missing %s): %s'
                             % (missing, rec))
    return launches


# ---------------------------------------------------------------- decoders


def decoder_window(frames=TRIAL, bucket=BUCKET, max_lags=DEC_HP['n_max_lags']):
    """The loss weights of a trial padded to its bucket: 1 on [max_lags,
    frames - max_lags), 0 on the lag borders and the padding."""
    w = torch.zeros(bucket, device=DEVICE)
    w[max_lags:frames - max_lags] = 1.0
    return w


def check_gaussian_nll(losses, gen, d):
    """K12 at the decoder step's shapes: (192, d) means and targets, (192,
    d, d) covariances L L^T from a seeded precision head (32 relu hidden
    units, weights 0.05 randn, bias I: covariance condition numbers of
    median 26 at d = 9 and 77 at d = 16, ~5e3 at worst; at weights 0.1 the
    medians reach 2e2-2e3, and the two float32 factors then part by ~1e-5
    of the loss, a test of the conditioning more than of the kernel), the
    loss weights of a 189-frame trial after the lag trim; forward and
    backward against the plain versions and ``-MultivariateNormal(y_pred,
    1e-3 I + cov).log_prob(y_true)`` (the reference's own module), masked
    mean, with autograd."""
    dev = DEVICE
    y_pred = torch.randn((BUCKET, d), device=dev, generator=gen)
    y_true = torch.randn((BUCKET, d), device=dev, generator=gen)
    hidden = torch.relu(torch.randn((BUCKET, DEC_HP['n_hid_units']), device=dev,
                                    generator=gen))
    w_head = torch.randn((DEC_HP['n_hid_units'], d * d), device=dev, generator=gen) * 0.05
    L = (hidden @ w_head + torch.eye(d, device=dev).reshape(-1)).reshape(BUCKET, d, d)
    cov = L @ L.transpose(1, 2)
    fm = decoder_window()
    one = torch.ones((), device=dev)

    def forward():
        return losses.gaussian_neg_log_prob_cuda(y_pred, y_true, cov, fm)

    def kernel():
        loss, den = forward()
        return (loss,) + losses.gaussian_neg_log_prob_grad_cuda(y_pred, y_true, cov, fm,
                                                                den, one)

    def plain():
        loss, den = losses.gaussian_neg_log_prob_plain(y_pred, y_true, cov, fm)
        return (loss,) + losses.gaussian_neg_log_prob_grad_plain(y_pred, y_true, cov, fm,
                                                                 den, one)
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    loss_err = abs(out_k[0].item() - out_p[0].item()) / abs(out_p[0].item())
    grad_err = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(out_k[1:], out_p[1:]))
    max_abs = max((a - b).abs().max().item() for a, b in zip(out_k, out_p))
    finite = all(bool(torch.isfinite(t).all().item()) for t in out_k)
    upper_zero = bool((torch.triu(out_k[2], 1) == 0).all().item())

    yl, cl = y_pred.clone().requires_grad_(True), cov.clone().requires_grad_(True)
    eye = 1e-3 * torch.eye(d, device=dev)

    def library():
        mvn = torch.distributions.MultivariateNormal(yl, covariance_matrix=eye + cl)
        loss = -(mvn.log_prob(y_true) * fm).sum() / fm.sum()
        return torch.autograd.grad(loss, (yl, cl))
    with tf32_off():
        library_ms = median_ms(library)
    valid = int(fm.sum().item())
    # per valid frame: the factor d^3/3 + d^2 flops and the solves, logs and
    # squares ~3 d^2 forward; the backward again the factor and four
    # triangular solves, plus S^-1's d columns at two solves each (2 d^3)
    n_ops = valid * (d ** 3 / 3 + 4 * d ** 2 + 7 * d ** 3 / 3 + 6 * d ** 2)
    # the pair as one function: y_pred, y_true, the frame mask, the upstream
    # gradient and the lower triangles of the valid frames' covariances (all
    # the factor reads) read once; the loss, its denominator, dL/dy_pred and
    # dL/dcov written once
    n_bytes = 4 * (2 * BUCKET * d + BUCKET + 1 + valid * d * (d + 1) // 2
                   + 2 + BUCKET * d + BUCKET * d * d)
    rec = dict(phase='nll_check', kernel='gaussian_nll', layer='d=%d' % d, frames=BUCKET,
               valid_frames=valid, dim=d, loss=out_k[0].item(), plain_loss=out_p[0].item(),
               loss_rel_err=loss_err, loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
               grad_rel_tol=NLL_GRAD_REL_TOL, max_abs_err=max_abs,
               cov_grad_upper_zero=upper_zero, mflop=n_ops / 1e6, mbytes=n_bytes / 1e6,
               ms=median_ms(kernel), fwd_ms=median_ms(forward), plain_ms=median_ms(plain),
               library_ms=library_ms, **bound(n_ops, n_bytes))
    emit(rec)
    if not finite or not upper_zero or loss_err > LOSS_REL_TOL or grad_err > NLL_GRAD_REL_TOL:
        raise AssertionError('K12 disagrees with its plain version: %s' % rec)
    return rec


class DecoderSource:
    """In-memory trial store with the generator interface ``fit`` uses:
    ``n`` trials of ``frames`` frames of ``channels`` z-scored neural
    channels from a seed, and targets linear in them: latents ``x W`` plus
    0.1 noise, or states ``argmax(x W)``; split 8/1/1 per block of 10."""

    n_datasets = 1

    def __init__(self, n, seed, signal, width, frames=TRIAL, channels=N_NEURAL):
        rs = np.random.RandomState(seed)
        self.neural = rs.randn(n, frames, channels).astype(np.float32)
        w = rs.randn(channels, width).astype(np.float32) / np.sqrt(channels)
        y = self.neural @ w
        self.signal = signal
        self.targets = np.argmax(y, axis=-1).astype(np.int32) if signal == 'arhmm_states' \
            else (y + 0.1 * rs.randn(*y.shape)).astype(np.float32)
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
        return {'neural': self.neural[i], self.signal: self.targets[i], 'batch_idx': i}, 0


def decoder_hparams(name, tmp):
    """The fit hparams of one of ``DECODERS`` (an eval epoch and two train
    epochs, on the card)."""
    mc, model_type, signal, width, noise, _ = DECODERS[name]
    return dict(DEC_HP, model_class=mc, model_type=model_type, noise_dist=noise,
                input_size=N_NEURAL, output_size=width, input_signal='neural',
                output_signal=signal, rng_seed_model=SEED,
                rng_seed_train=SEED, rng_seed_data=SEED, max_n_epochs=VAE_FIT_EPOCHS,
                min_n_epochs=1, val_check_interval=1, enable_early_stop=False,
                early_stop_history=10, export_predictions=False, device=DEVICE,
                experiment_name=name, expt_dir=os.path.join(tmp, name))


def fit_decoder(port, tmp, name, seed):
    """Main paths 9-11: ``fit`` of a decoder on the card over 20 in-memory
    trials; every logged number finite and its kernels launched inside it."""
    build = port.build
    hp = decoder_hparams(name, tmp)
    source = DecoderSource(TRAIN_TRIALS, seed, hp['output_signal'], hp['output_size'])
    exp = port.experiment.Experiment(name, tmp)
    model = port.decoders.Decoder(hp)
    reset_launches(build)
    t0 = time.perf_counter()
    best = port.training.fit(hp, model, source, exp, method='nll')
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    vdir = os.path.join(hp['expt_dir'], 'version_%d' % exp.version)
    logged = read_metrics(vdir)
    finite = all(len(v) and np.isfinite(v).all() for v in logged.values())
    need = DECODERS[name][-1]
    missing = [k for k in need if launches[k] == 0]
    emit(dict(phase='decoder_fit', model=name, model_class=hp['model_class'], tf32=tf32_flags(),
              noise_dist=hp['noise_dist'], neural_channels=N_NEURAL,
              outputs=hp['output_size'], epochs=list(range(VAE_FIT_EPOCHS + 1)),
              train_trials=source.n_tot_batches['train'], seconds=fit_s,
              launches=launches, finite=finite, logged=logged))
    if missing or not finite:
        raise AssertionError('%s fit never launched %s or logged non-finite numbers'
                             % (name, missing))
    return dict(hp, version=exp.version), model, vdir, best, source, launches


@contextlib.contextmanager
def plain_decoder_losses(port):
    """Route the decoder's losses to their plain versions (autograd through
    ``gaussian_neg_log_prob_plain`` and ``mse_plain``), for the plain twin
    of a step on the card."""
    losses = port.losses
    routes = (('gaussian_neg_log_prob',
               lambda *a, **k: losses.gaussian_neg_log_prob_plain(*a, **k)[0]),
              ('mse', lambda *a, **k: losses.mse_plain(*a, **k)[0]))
    saved = [(name, getattr(losses, name)) for name, _ in routes]
    for name, fn in routes:
        setattr(losses, name, fn)
    try:
        yield
    finally:
        for name, fn in saved:
            setattr(losses, name, fn)


def decoder_batch(hp, source):
    """The first train trial of ``source`` padded to its bucket, as ``fit``
    hands it to the loss: (host arrays, tensors on the card)."""
    idx = int(source.idxs['train'][0])
    predictors = np.zeros((BUCKET, N_NEURAL), np.float32)
    predictors[:TRIAL] = source.neural[idx]
    targets = np.zeros((BUCKET, hp['output_size']), np.float32)
    targets[:TRIAL] = source.targets[idx]
    frame_mask = np.zeros(BUCKET, np.float32)
    frame_mask[:TRIAL] = 1.0
    host_batch = {'predictors': predictors, 'targets': targets, 'frame_mask': frame_mask}
    return host_batch, {k: torch.from_numpy(v).to(DEVICE) for k, v in host_batch.items()}


def decoder_grads(port, hp, model, batch):
    """A fitted decoder's loss and gradients on the card (K12 for ``mlp-mv``,
    K5 for ``mlp``, under the lag-trimmed window) against the plain path's:
    the same forward, the plain loss differentiated by autograd."""
    loss_kernel = 'gaussian_nll' if hp['noise_dist'] == 'gaussian-full' else 'masked_mse'
    reset_launches(port.build)
    model.zero_grad(set_to_none=True)
    loss_k = model.loss_fn(batch)[0]
    loss_k.backward()
    grads_k = {k: p.grad.clone() for k, p in model.named_parameters()}
    launched = port.build.LAUNCHES[loss_kernel]
    model.zero_grad(set_to_none=True)
    with plain_decoder_losses(port):
        loss_p = model.loss_fn(batch)[0]
        loss_p.backward()
    grad_errs = {k: (grads_k[k] - p.grad).abs().max().item()
                 / max(p.grad.abs().max().item(), 1e-30)
                 for k, p in model.named_parameters()}
    worst = max(grad_errs, key=grad_errs.get)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    emit(dict(phase='decoder_grads', model=hp['experiment_name'], frames=BUCKET, tf32=tf32_flags(),
              loss=loss_k.item(), plain_loss=loss_p.item(), loss_rel_err=loss_err,
              rel_tol=GRAD_REL_TOL, loss_kernel=loss_kernel, loss_kernel_launches=launched,
              max_rel_err=grad_errs[worst], worst=worst, rel_err=grad_errs))
    if not launched or grad_errs[worst] > GRAD_REL_TOL or loss_err > GRAD_REL_TOL:
        raise AssertionError('%s gradients on the card (%s launched %d times) disagree with '
                             'the plain path: %s=%.3g, loss %.3g'
                             % (hp['experiment_name'], loss_kernel, launched, worst,
                                grad_errs[worst], loss_err))


def decoder_step(port, hp, model, source):
    """An ``mlp-mv`` train step on the card: its gradients against the plain
    path's, its time beside the plain step's (plain losses, torch's fused
    AMSGrad), and its profile."""
    host_batch, batch = decoder_batch(hp, source)
    decoder_grads(port, hp, model, batch)
    opt = port.optim.AMSGrad(model.parameters(), lr=hp['learning_rate'],
                             weight_decay=hp['l2_reg'])
    twin = port.decoders.Decoder(hp).to(DEVICE)
    twin.load_state_dict(model.state_dict())
    adam = torch.optim.Adam(twin.parameters(), lr=hp['learning_rate'],
                            weight_decay=hp['l2_reg'], amsgrad=True, fused=True)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss_fn(batch)[0].backward()
        opt.step()

    def plain_step():
        adam.zero_grad(set_to_none=True)
        with plain_decoder_losses(port):
            twin.loss_fn(batch)[0].backward()
        adam.step()
    reset_launches(port.build)
    step()
    torch.cuda.synchronize()
    per_step = dict(port.build.LAUNCHES)
    ms, plain_ms = request_ms(step), request_ms(plain_step)
    rec = dict(phase='decoder_step', model=hp['experiment_name'], frames=TRIAL, bucket=BUCKET,
               tf32=tf32_flags(),
               neural_channels=N_NEURAL, ms=ms, frames_per_s=TRIAL / ms * 1e3,
               plain_ms=plain_ms, plain_frames_per_s=TRIAL / plain_ms * 1e3,
               launches_per_step=per_step)
    emit(rec)
    emit(profile_steps(lambda: step_from_host(step, host_batch, batch),
                       phase='decoder_profile'))
    return per_step, rec


def reference_predict(model, x):
    """The decoder's forward in float64 on the card, written out: the
    temporal conv as one matmul over the unfolded +-n_lags window."""
    sd = {k: v.double() for k, v in model.state_dict().items()}
    lags = int(model.hparams['n_lags'])
    w = sd['model.decoder.conv1d_layer_00.weight']                     # (out, in, K)
    xp = F.pad(x.double().t(), (lags, lags)).t()                        # (T + 2 lags, in)
    windows = xp.unfold(0, 2 * lags + 1, 1)                             # (T, in, K)
    h = windows.reshape(x.shape[0], -1) @ w.reshape(w.shape[0], -1).t() \
        + sd['model.decoder.conv1d_layer_00.bias']
    h = torch.relu(h)
    return h @ sd['model.decoder.dense_layer_01.weight'].t() \
        + sd['model.decoder.dense_layer_01.bias']


def serve_decoder(port, hp, vdir, best, source):
    """Main path 12: the fitted ``mlp-mv`` decoder's ``best_val_model.pt``
    serves ``predict`` through ``load_version`` on the card, for a 189-frame
    and a 1000-frame trial, within 1e-4 of the float64 forward."""
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(dict(hp, training_completed=True), f)
    rs = np.random.RandomState(SEED + 7)
    trials = {TRIAL: source.neural[0],
              1000: rs.randn(1000, N_NEURAL).astype(np.float32)}
    bundle = port.serving.load_version(vdir)
    served = dict(bundle.model.state_dict())
    same = all(torch.equal(served[k].cpu(), v) for k, v in
               port.weights.params_to_state_dict(bundle.model, best).items())
    rows = {}
    for frames, x in trials.items():
        out = bundle.predict(x)
        with torch.inference_mode():
            ref = reference_predict(bundle.model, torch.from_numpy(x).to(DEVICE))
        err = (out.double() - ref).abs().max().item()
        tol = PREDICT_ABS_TOL * max(1.0, ref.abs().max().item())
        rows[frames] = dict(shape=list(out.shape), max_abs_err=err, tol=tol,
                            finite=bool(torch.isfinite(out).all().item()),
                            ms=request_ms(lambda: bundle.predict(x)))
    ok = same and bundle.names() == ['predict'] and all(
        r['finite'] and r['max_abs_err'] <= r['tol'] and r['shape'] == [f, DEC_LATENTS]
        for f, r in rows.items())
    rec = dict(phase='decoder_serve', model=hp['experiment_name'], device=str(bundle.device),
               tf32=tf32_flags(),
               weights_equal=same, requests=rows, ok=ok)
    emit(rec)
    if not ok:
        raise AssertionError('the fitted decoder does not serve: %s' % rec)
    return rec


def kernel_row(name, rows, launches):
    """The kernels-line entry of one kernel: sums over the rows it was
    checked at; launches from the main paths' runs."""
    source, replaces = KERNELS[name]
    t_ops = sum(r['t_ops_ms'] for r in rows)
    t_bytes = sum(r['t_bytes_ms'] for r in rows)
    library = [r['library_ms'] for r in rows]
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
        library_ms=None if None in library else sum(library))


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    port = import_port()
    ops = port.ops
    default_flags = tf32_flags()

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
    with tf32_off():
        checks = [check_layer(L, ops, gen) for L in layer_shapes(hp, TRIAL)]
        for L in layer_shapes(hp, BUCKET):
            checks += check_backward_layer(L, ops, gen)
        checks.append(check_mse(port.losses, gen))
        checks.append(check_amsgrad(port.optim, port.aes.AE(hp).to(DEVICE), gen))
        checks += [check_decomposed_kl(port.losses, gen, d) for d in KL_DIMS]
        em_model, em_trials, init_s = em_workload(port)
        checks += [check(port, em_model, em_trials) for check in (
            check_arhmm_log_likes, check_forward_backward, check_viterbi, check_solve_small)]
        rec_models = recurrent_models(port, em_model)
        checks.append(check_robust_log_likes(port, rec_models['recurrent'], em_trials))
        checks += [check(port, rec_models, em_trials)
                   for check in (check_forward_backward_tv, check_viterbi_tv)]
    checks += [check_gaussian_nll(port.losses, gen, d) for d in NLL_DIMS]
    checks.append(check_mse(port.losses, gen, decoder=True))

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        with tf32_off():
            launches['serve'], _, _ = serve(port.serving, port.base, ops, hp, tmp)
            launches['train'], _, _ = train(port, hp, tmp)
            source = TrialSource(TRAIN_TRIALS, SEED + 3, n_labels=N_LABELS)
            ps_hp, ps_model, ps_dir, ps_best, launches['fit_ps-vae'] = fit_vae(
                port, hp, tmp, 'ps-vae', source)
            psvae_step(port, ps_hp, ps_model, source)
            launches['serve_ps-vae'] = serve_psvae(port, ps_hp, ps_dir, ps_best, source)
            launches['fit_beta-tcvae'] = fit_vae(port, hp, tmp, 'beta-tcvae', source)[-1]
            launches['arhmm_em'] = arhmm_em(port, em_model, em_trials, init_s)
            launches['arhmm_em_recurrent'] = arhmm_em_recurrent(
                port, recurrent_arhmm(port, em_model, 'recurrent', 'robust_ar'), em_trials)
            del em_model, em_trials, rec_models
            vdir, cli_latents, launches['arhmm_cli'] = arhmm_cli(port, tmp)
            launches['arhmm_serve'] = arhmm_serve(port, vdir, cli_latents)
            vdir, cli_latents, launches['arhmm_cli_recurrent'] = arhmm_cli(
                port, tmp, RECURRENT_KERNELS, transitions='recurrent', noise_type='studentst')
            launches['arhmm_serve_recurrent'] = arhmm_serve(
                port, vdir, cli_latents, ('arhmm_log_likes_robust', 'hmm_forward_backward_tv',
                                          'hmm_viterbi_tv'))
        if tf32_flags() != default_flags:
            raise AssertionError('the TF32 flags were left changed: %s' % tf32_flags())
        fitted = {}
        for i, name in enumerate(DECODERS):
            fitted[name] = fit_decoder(port, tmp, name, SEED + 8 + i)
            launches['decoder_fit_' + name] = fitted[name][-1]
        mlp_hp, mlp_model, _, _, mlp_source, _ = fitted['neural-ae-mlp']
        decoder_grads(port, mlp_hp, mlp_model, decoder_batch(mlp_hp, mlp_source)[1])
        dec_hp, dec_model, dec_dir, dec_best, dec_source, _ = fitted['neural-ae-mlp-mv']
        decoder_step(port, dec_hp, dec_model, dec_source)
        serve_decoder(port, dec_hp, dec_dir, dec_best, dec_source)

    emit({'kernels': [kernel_row(name, [r for r in checks if r['kernel'] == name], launches)
                      for name in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
