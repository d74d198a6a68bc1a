#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``behavenet_tpu_torch``).

    python3 chip_smoke.py

On one CUDA GPU (an H100: the kernels are built for sm_90a) it

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's twenty-five CUDA kernel sources from this checkout;
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
     the whole model (K6): ``amsgrad_cuda_`` once, then three
     ``AMSGrad.step()`` calls against the plain recursion, one gradient
     dropped at the second and a ``load_state_dict`` of a copied state
     before the third (a stale table of pointers would fail); the step's
     time beside fused ``Adam(amsgrad=True)``, its host time and K6's
     device time (profiler);
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
   ``load_arhmm``. Then ``parallel_scan`` and sampling at the same shapes:
   K13 (the chunked log-semiring scan and K9's posterior pass) against the
   plain parallel version and K9, K14 (the (max, +) scan and the chunked
   backtrace) against the plain parallel version and K10, K15 (posterior
   draws and their composition) against the plain draws from the same
   uniforms and alphas, each stationary and time-varying on full and cut
   trials; K16 (prior state chains) on 1,000 chains of 1,000 steps against
   its plain version and softmax(log_Ps); K15's draws of one trial against
   its posterior marginals; 20 EM iterations with ``parallel_scan`` of the
   stationary and of the recurrent + robust model (one iteration against
   the sequential EM, timed beside it, profiled; the recurrent model then
   decodes and samples a trial); one 100,000-frame session decoded with
   K13 / K14 against K9 / K10 and the plain parallel version in float64;
   the CLI over the published grid with ``parallel_scan: true``, its K = 12
   model served through ``load_arhmm`` (decoding, ``posterior_sample``,
   ``sample(1000)``). Then K31 (row 18b, the M-step's weighted sums,
   kernels/arhmm_mstep.cu) on the EM trials cut to 900-1000 frames: the
   statistics and the residual covariance, float32 and float64, full,
   diagonal, robust (tau), lags 0 and 2 (P = 19) and K = 2, each against the
   plain version in float64, a second call bit for bit, timed beside the
   einsum / bmm path it replaced; the float64 launchers of K8-K11 against
   their plain versions in float64 at the EM and the CLI's shapes; float64
   EM (``ARHMM(dtype='float64')``) through ``fit`` at the EM shapes (every
   ``_f64`` launcher of its path every iteration; the first iteration
   against a plain float64 one; timed and profiled) and one 'recurrent' +
   'robust_ar' float64 iteration with its decoding; and the CLI with
   ``em_dtype: float64`` over K = 2, 4, its K = 4 model served in float64
   through ``load_arhmm``. Then row 18c: K40 (the recurrent transitions'
   25 Adam steps, kernels/arhmm_recurrent_mstep.cu) and K41 (the
   Student's-t dof's Newton steps, kernels/arhmm_nu_mstep.cu), float32 and
   float64, against their plain versions in float64 on the EM trials, full
   and cut, 'recurrent' and 'recurrent_only', on one part and two, a second
   call bit for bit, each timed beside its plain version; the device
   digamma against ``torch.digamma``; every recurrent EM path (sequential,
   ``parallel_scan``, float64, the CLI, the trial layout on 2 shards) must
   launch them. Then the time-sharded passes (row 19a,
   kernels/hmm_shard.cu) on the 100,000-frame session, on meshes that
   repeat the card 1, 2 and 4 times (``parallel.Mesh``: every shard's
   launches and every exchange run, one shard after another): K32 (a
   shard's totals, log and (max, +)), K33 (its posteriors, filtered alphas
   or backpointers), K34 (its map total, from the backpointers or drawn)
   and K35 (its backtrace) through ``parallel.seq``'s passes against their
   plain versions, float64 and, with one shard, K13-K15 bit for bit, the
   stationary EM model's chain and the recurrent model's time-varying one,
   each launcher timed (``check_sp_kernels``); EM on meshes
   (``arhmm_em_sp``: ``fit(shard_time=True)`` over 4 shards of two
   100,000-frame sessions, the trial layout over 2 shards of the EM
   workload, each with and without ``iters_per_dispatch=2``, against the
   unsharded fit; timed and profiled; and the recurrent + robust model in
   the trial layout over 2 shards, against its unsharded fit, LLs and
   parameters: K40's and K41's multi-part reductions); and ``expected_states``,
   ``most_likely_states`` and ``posterior_sample(mesh=)`` of the session on
   1 and 4 shards beside the unsharded ``parallel_scan`` calls
   (``arhmm_sp_serve``).
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
9. the Bayesian decoder (main paths 13-14) at the published config
   (configs/bayesian_jsons: 9 AE latents, the ARHMM CLI's K = 4 version,
   lags 1, Gaussian, stationary; state evidence and smoothing on): K17
   (the IMM filter) and K18 (the RTS smoother) against their plain versions
   at the CLI's shape (a 189-frame trial with NaN lag borders in the
   192-frame bucket), at lags 2 and at K = 12, filter alone and with the
   smoother, and on one 10,000-frame trial against the plain versions in
   float64; the port's ``bayesian_decoder_grid_search`` on the card over
   the stationary ARHMM CLI's store, with the two neural decoders'
   predictions pickles written in their export format (K9, K10, K17 and
   K18 must launch inside it; every exported trial finite; the decoded
   test MSE below the raw predictions'); and ``decode`` of one trial from
   the loaded K = 4 models of the stationary and the ``parallel_scan`` CLIs
   (K13, K14) against their plain twins, timed with and without smoothing
   and profiled.
10. the associative Kalman path (main paths 13b-15): K19 and K20 (the
   associative filter and smoother, kernels/kalman.cu) and K21 and K22
   (the sequential ones of ops.kalman) against their plain versions and
   the float64 sequential versions at the CLI's soft LDS (192 frames, 189
   observed, n = 9), at lags 2 (n = 18) and with a general H (the JAX
   package's Kalman tests' system at n = 9, d = 5), K19 / K20 against K21
   / K22, and K19 / K20 on one 10,000-frame trial at three chunk lengths
   against the plain parallel versions in float64 on the card; K11's
   pivoting launcher at the combine's matrices and
   with a zero leading pivot; the Bayesian CLI with ``"parallel_scan":
   true`` (K13, K14, K19 and K20 must launch; decoded test MSE below the
   raw predictions'); ``decode(parallel=True)`` of one trial against its
   plain twin, timed and profiled; the public ``ops.kalman`` passes and
   ``solve_small(pivot=True)`` on a general LDS (K19-K22 and the pivot
   launcher); and a 100,000-frame trial drawn from the fitted EM model,
   ``decode(parallel=True)`` timed beside the sequential ``decode`` under
   JAX's MSE gates. Then row 19b (kernels/kalman_shard.cu) on meshes that
   repeat the card 1, 2 and 4 times: K36 / K37 (a time shard's filtering
   total; its filtered moments from the gathered totals) and K38 / K39 (the
   smoother's) through ``parallel.seq``'s time-sharded Kalman passes at
   that trial's soft LDS and the CLI's, against the plain sharded passes
   and float64 per frame, with one shard K19's and K20's outputs bit for
   bit, at masked shard boundaries and on trials shorter than the mesh,
   each launcher timed (``check_sp_kalman``); and ``decode(mesh=)`` of the
   100,000-frame trial and of a CLI trial from the fitted K = 4 model
   against ``decode(parallel=True)`` and a float64 decode, timed and
   profiled on each mesh (``bayesian_sp_serve``).
11. the LSTM decoder (main paths 16-19b; row 20, kernels/lstm.cu): K23 (the
   forward: the input projection, then one block a direction walks the
   192-step chain) against ``lstm_scan_plain`` and ``torch.nn.LSTM`` (the
   yardstick, TF32 off) at the decoding config's width (h = 32 hidden units
   over 256 neural channels, both directions, the 192-frame bucket) and at
   h = 64, 128, 150 and 256 (W_hh partly through L2 there), and on one
   1000-frame trial against the plain version in float64; K24 (BPTT: the
   chain in a cluster of 1, 2 or 8 CTAs that holds all of W_hh) against
   autograd through the plain version (dW, db; dx at h = 32) and a second
   call bit for bit, its plan and device time by launch (chain, dW, dx),
   and on the 1000-frame trial (dx, dW, db) against autograd in float64;
   ``fit`` of a ``neural-ae`` and a ``neural-arhmm`` bidirectional LSTM
   (K23, K24 and the loss's kernel must launch); the fitted ``neural-ae``
   LSTM's gradients against the plain path's, its step timed and profiled;
   its ``predict`` through ``serving.load_version`` on 189 and 1000 frames
   (K23 alone) against a float64 forward; and the ``neural-ae`` LSTM's step
   at h = 128 from its seeded init beside its plain twin (19b).
12. the MSPS-VAE (main paths 20-21; row 10, kernels/triplet.cu) at the user
   guide's config (docs/user_guide.mspsvae.md: 14 latents, 4 labels, 3
   background, alpha 1000, beta 5, delta 50, 100 anneal epochs, two sessions
   a batch): K25 (the cross-session triplet loss) and K26 (its backward)
   against their plain versions and the plain versions in float64 on the
   strided background columns of the means, at the step's two 192-row
   segments and at 3 and 4 sessions, unmasked and with 3 padded rows a
   segment, timed beside a composition of ``F.triplet_margin_loss`` and
   ``F.pairwise_distance`` (no PyTorch call computes the loss); ``fit`` on
   two in-memory sessions of 20 trials that differ in brightness (an eval
   epoch, then two train epochs: K1-K7, K25 and K26 must launch; every
   logged number finite; the triplet term above 0 in the train rows and 0
   in the val and test rows); a 384-frame step's gradients against the
   plain path's with the same eps and permutations, its time and profile;
   and the fitted model served through ``serving.load_version`` at 1, 189
   and 1024 frames (``encode`` = [z_s, z_b, z_u]) against the plain path,
   with no triplet launch.
13. the max-pooling + batch-norm AE (main paths 22-24; row 6,
   kernels/pool.cu and kernels/batch_norm.cu): the published default arch
   recast as the reference generator's max_pooling type (POOL_ARCH: five
   stride-1 k5 convs, each with batch norm and a 2x2 pool, the shipped
   cumulative momentum) on the same frames; its convs (K1, K2, K4 at stride
   1; the uint8 first layer; the 2-channel sigmoid last layer in K2)
   against the plain versions as the default arch's; K27 (the pool with
   its leaky ReLU, and its backward), K28 (the unpool, and its backward),
   K29 (batch norm, train mode with the running update and eval mode) and
   K30 (its backward) against their plain versions at every pool and
   batch-norm layer at the 192-frame bucket, and K27 / K28 on a 13 x 17
   plane in ceil and floor mode with planted ties, each timed beside
   ``F.max_pool2d`` / ``F.max_unpool2d`` / ``F.batch_norm`` and their
   autograd backwards (yardsticks the port never calls); ``fit`` (an eval
   epoch, one train epoch over 8 trials; K27-K30 must launch; every running
   statistic leaves its init) and ``export_latents`` in eval mode (no
   backward, the statistics untouched, the latents the plain path's); one
   train step's gradients and running statistics against the plain twin's,
   its time and profile; and the fitted version served through
   ``serving.load_version`` at 1, 189 and 1024 frames against the plain
   path in eval mode, with no batch-statistics pass in a request's profile.
   Also K12's gradients (row 9) on 5 further draws at d = 9 and 16 against
   the plain version in float64, beside the plain float32 version's.
14. K2 and K4 on ragged shapes (``check_ragged``): every width of
   RAGGED_WIDTHS as Cin and as Cout on a 13 x 17 plane at strides 1-3,
   asymmetric pads, an out_pad at stride > 1, uint8 frames for K4 at
   stride 1 and its transposed output at stride 3, against their plain
   versions (K4's in float64) under the layers' tolerances, each run twice
   bit for bit (as at every layer of both archs); ``conv_summary`` sums
   K1's, K2's and K4's times beside cuDNN's per arch and stride, and
   ``conv_ptxas`` lists the registers and spills of K2's and K4's
   instances (no spill allowed).

    python3 chip_smoke.py --only PHASE[,PHASE]

runs, after the build, only the named phases of ONLY_PHASES, in the order
given: ``conv`` (every conv layer of both archs, forward and backward,
``check_ragged`` and ``conv_summary``), ``optimizer`` (K6's
``optimizer_check``), ``lstm`` (``check_lstm``: K23, K24) and
``lstm_step`` (the LSTM decoder step at LSTM_STEP_HIDDEN). They need of
the package only the entry points they call, so a copy of this script in
a checkout of an earlier commit times that commit's kernels the same way
(K24's plan then reads None where ``ops.lstm`` has no ``bptt_plan``).

Each phase prints one JSON line; the line before the last lists the kernels
with their numbers, and the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. Any failure exits non-zero.

    python3 chip_smoke.py --cards N

runs, after the build, only the mesh paths across N distinct cards of one
host (``mesh_cards``): the ARHMM's ``expected_states`` /
``most_likely_states`` / ``posterior_sample(mesh=)`` of the 100,000-frame
session and ``fit`` in both layouts (with and without
``iters_per_dispatch=2``) on a mesh of cards 0..N-1 and on one that starts
at card 1 (its first device not the model's), held to the same calls on a
mesh that repeats card 0 N times; the recurrent + robust model's fit in
the trial layout on each of the three meshes against its unsharded fit
(K40 and K41 on every card); ``decode(mesh=)`` of the Bayesian
decoder's 100,000-frame session on the same meshes, equal bit for bit; then
the ARHMM CLI, which shards EM over the trials on every card.
"""

import argparse
import contextlib
import copy
import csv
import functools
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

# H100 SXM published peaks (NVIDIA's data sheet, dense): float32 outside
# the tensor cores, float64 on them (the card's float64 peak: 67 TFLOP/s,
# twice the 34 of its CUDA cores), and HBM3. A bound is the least time the
# card could take, so each type takes the card's highest rate for it.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 67e12
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
# check_amsgrad: the parameter whose gradient is dropped at the optimizer's
# second step; host calls timed back to back
AMSGRAD_DROPPED, AMSGRAD_HOST_CALLS = 1, 100
# One train step's gradients, kernels vs the plain path on the card.
GRAD_REL_TOL = 1e-3
# train and msps_step: replayed leaky-ReLU signs that may differ from the
# float64 plain path's own, each at a pre-activation within SIGN_FLIP_TOL *
# max(1, the layer's largest) of 0 (float32 rounding; a kernel fault lands
# farther). The MSPS step's nine layers hold ~2e8 pre-activations, so a few
# lie within float32 rounding of 0 (7, each within 5e-8, on the H100).
SIGN_FLIPS_MAX, SIGN_FLIP_TOL = 64, 1e-5
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
# The MSPS-VAE of docs/user_guide.mspsvae.md:36-46 (14 latents: 4 supervised,
# 3 background, 7 unsupervised for K7; the triplet term weighted by delta 50
# over two sessions a step) at the same width: a step is two 189-frame trials
# of two sessions, each in the 192-frame bucket, so the triplet kernels (K25,
# K26) see seg_lens (192, 192), d = 3 and chunks of m = 64 rows. K25 / K26 are
# held to their plain versions at 2, 3 and 4 sessions (TRIPLET_SESSIONS),
# with an all-ones mask and with TRIPLET_PAD padded rows per segment: the
# loss within LOSS_REL_TOL, dz within TRIPLET_GRAD_REL_TOL of max|plain|
# (float32 sums of 64 terms in another order), both also against the plain
# version in float64. The two in-memory sessions differ in brightness by
# MSPS_BRIGHTNESS, so the background latents have something to separate.
N_MSPS_LATENTS, N_BACKGROUND = 14, 3
MSPS_CLASS = {'n_labels': N_LABELS, 'n_background': N_BACKGROUND, 'ps_vae.alpha': 1000,
              'ps_vae.beta': 5, 'ps_vae.delta': 50, 'ps_vae.anneal_epochs': 100,
              'n_sessions_per_batch': 2}
MSPS_BRIGHTNESS = 60
TRIPLET_SESSIONS, TRIPLET_PAD = (2, 3, 4), BUCKET - TRIAL
TRIPLET_GRAD_REL_TOL = 1e-4
# K12's gradients on NLL_DRAWS further draws at d = 9 and 16 from a
# generator of their own, K12 (its factor in float64 registers) and its
# plain float32 version each against the plain version in float64: K12
# within NLL_GRAD_REL_TOL of max|float64| and no farther from it than the
# plain float32 version, on every draw.
NLL_DRAWS = 5

# Row 6 (K27-K30): the published default arch (Whiteway et al 2021,
# models/arch.py:load_default_arch: widths 32-512, kernel 5) recast as the
# reference generator's max_pooling network type, with batch norm at the
# shipped cumulative momentum (configs/ae_jsons/ae_arch_default.json:13:
# null), on the same 2-view frames and 12 latents: five stride-1 'same'
# convs, each followed by batch norm and a 2x2 pool (128 -> 4), and a
# decoder of unpool, conv-transpose and batch norm whose last layer (2
# channels, sigmoid) runs in K2. 8.92 M parameters. Its convs are held to
# the plain versions as the default arch's (check_layer,
# check_backward_layer), K27-K30 at each of its pool and batch-norm layers
# at the 192-frame bucket and at POOL_ODD in ceil and floor mode with
# planted ties; fit on BN_FIT_TRIALS in-memory trials.
POOL_ARCH = {
    'ae_network_type': 'max_pooling', 'ae_padding_type': 'same', 'ae_batch_norm': 1,
    'ae_batch_norm_momentum': None, 'symmetric_arch': 1,
    'ae_encoding_n_channels': [32, 32, 64, 64, 128, 128, 256, 256, 512, 512],
    'ae_encoding_kernel_size': [5, 2] * 5, 'ae_encoding_stride_size': [1, 2] * 5,
    'ae_encoding_layer_type': ['conv', 'maxpool'] * 5, 'ae_decoding_last_FF_layer': 0}
POOL_ODD = (13, 17)
# the stride-1 convs do ~5x the default arch's work (the plain grad-w ~0.3
# s a call): fewer timed calls
POOL_TIMING = dict(samples=2, inner=3, warmup=1)
BN_FIT_TRIALS = 10           # 8 train, 1 val, 1 test
# K1, K2 and K4 on ragged shapes beside the archs' layers (check_ragged):
# each width as Cin and as Cout, RAGGED_FRAMES frames of a POOL_ODD plane, k
# 5, pads (before, after) RAGGED_PADS, out_pad (1, 0) at stride > 1; K1 also
# with the pads after RAGGED_NEG_PADS_AFTER (a transposed conv's grad-x
# where out_pad exceeds its pad after) and on uint8 frames of
# RAGGED_UINT8_CIN channels; K29 at RAGGED_BN_WIDTHS channels
RAGGED_WIDTHS = (1, 2, 3, 5, 33, 65)
RAGGED_PATCH_WIDTHS = ((4, 36), (12, 68), (36, 132))   # K4's patch kernel: (Cin, Cout)
RAGGED_STRIDES = (1, 2, 3)
RAGGED_FRAMES = 4
RAGGED_PADS = ((2, 1), (1, 2))
RAGGED_NEG_PADS_AFTER = (-1, -2)
RAGGED_UINT8_CIN = (1, 2, 3)
RAGGED_BN_WIDTHS = (3, 33)
# K27 / K28 vs plain: equal (comparisons, copies and one division by the tie
# count). K29: the output as the convs' (ABS_TOL, REL_TOL); the batch and
# running statistics within BN_STAT_REL_TOL of max(1, max|plain|) (float32
# sums over up to 3.1 M rows in another order). K30: dx, dgamma and dbeta
# within BN_GRAD_REL_TOL of max|plain|. A train step's running statistics
# against the plain twin's within BN_RUNNING_REL_TOL of max(1, max|twin|)
# (ten layers of kernels against cuDNN before them).
BN_STAT_REL_TOL, BN_GRAD_REL_TOL, BN_RUNNING_REL_TOL = 1e-5, 1e-4, 1e-4
ROW6_KERNELS = ('max_pool2d', 'max_pool2d_grad', 'max_unpool2d', 'max_unpool2d_grad',
                'batch_norm', 'batch_norm_backward')
BN_KERNELS = ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'conv2d_grad_w_nhwc', 'masked_mse',
              'amsgrad_step') + ROW6_KERNELS
BN_SERVE_KERNELS = ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'max_pool2d', 'max_unpool2d',
                    'batch_norm')

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
    # the parallel-prefix scans (K13, K14) and the samplers (K15, K16), with
    # their time-varying launchers
    'hmm_scan': ('behavenet_tpu_torch/kernels/hmm_scan.cu', 'behavenet_tpu/ops/hmm.py:404'),
    'hmm_scan_tv': ('behavenet_tpu_torch/kernels/hmm_scan.cu', 'behavenet_tpu/ops/hmm.py:65'),
    'hmm_viterbi_scan': ('behavenet_tpu_torch/kernels/hmm_scan.cu',
                         'behavenet_tpu/ops/hmm.py:225'),
    'hmm_viterbi_scan_tv': ('behavenet_tpu_torch/kernels/hmm_scan.cu',
                            'behavenet_tpu/ops/hmm.py:225'),
    'hmm_sample_posterior': ('behavenet_tpu_torch/kernels/hmm_sample.cu',
                             'behavenet_tpu/ops/hmm.py:310'),
    'hmm_sample_posterior_tv': ('behavenet_tpu_torch/kernels/hmm_sample.cu',
                                'behavenet_tpu/ops/hmm.py:280'),
    'hmm_sample_states': ('behavenet_tpu_torch/kernels/hmm_sample.cu',
                          'behavenet_tpu/ops/hmm.py:353'),
    # K9's forward pass writing the filtered alphas that K15 draws from
    # without parallel_scan
    'hmm_forward_alpha': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                          'behavenet_tpu/ops/hmm.py:39'),
    'hmm_forward_alpha_tv': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                             'behavenet_tpu/ops/hmm.py:39'),
    # the Bayesian decoder's IMM filter (K17) and RTS smoother (K18)
    'imm_filter': ('behavenet_tpu_torch/kernels/imm.cu', 'behavenet_tpu/models/bayesian.py:299'),
    'rts_smoother': ('behavenet_tpu_torch/kernels/imm.cu',
                     'behavenet_tpu/models/bayesian.py:340'),
    # the associative Kalman filter and smoother (K19, K20), the sequential
    # ones (K21, K22) and K11's pivoting launcher
    'kalman_filter_scan': ('behavenet_tpu_torch/kernels/kalman.cu',
                           'behavenet_tpu/ops/kalman.py:132'),
    'kalman_smoother_scan': ('behavenet_tpu_torch/kernels/kalman.cu',
                             'behavenet_tpu/ops/kalman.py:214'),
    'kalman_filter': ('behavenet_tpu_torch/kernels/kalman.cu', 'behavenet_tpu/ops/kalman.py:38'),
    'kalman_smoother': ('behavenet_tpu_torch/kernels/kalman.cu',
                        'behavenet_tpu/ops/kalman.py:152'),
    'solve_small_pivot': ('behavenet_tpu_torch/kernels/solve_small.cu',
                          'behavenet_tpu/ops/smallmat.py:17'),
    # the LSTM decoder's recurrence (K23) and its backward (K24)
    'lstm_forward': ('behavenet_tpu_torch/kernels/lstm.cu',
                     'behavenet_tpu/models/decoders.py:169'),
    'lstm_backward': ('behavenet_tpu_torch/kernels/lstm.cu',
                      'behavenet_tpu/models/decoders.py:169'),
    # the MSPS-VAE's cross-session triplet loss (K25) and its backward (K26)
    'triplet_loss': ('behavenet_tpu_torch/kernels/triplet.cu',
                     'behavenet_tpu/ops/losses.py:246'),
    'triplet_loss_grad': ('behavenet_tpu_torch/kernels/triplet.cu',
                          'behavenet_tpu/ops/losses.py:213'),
    # the pooling and batch-norm archs' pool (K27), unpool (K28), batch norm
    # with its running update (K29) and their backwards (JAX's autodiff)
    'max_pool2d': ('behavenet_tpu_torch/kernels/pool.cu', 'behavenet_tpu/ops/conv.py:367'),
    'max_pool2d_grad': ('behavenet_tpu_torch/kernels/pool.cu',
                        'behavenet_tpu/ops/conv.py:367'),
    'max_unpool2d': ('behavenet_tpu_torch/kernels/pool.cu', 'behavenet_tpu/ops/conv.py:402'),
    'max_unpool2d_grad': ('behavenet_tpu_torch/kernels/pool.cu',
                          'behavenet_tpu/ops/conv.py:402'),
    'batch_norm': ('behavenet_tpu_torch/kernels/batch_norm.cu',
                   'behavenet_tpu/ops/conv.py:419'),
    'batch_norm_backward': ('behavenet_tpu_torch/kernels/batch_norm.cu',
                            'behavenet_tpu/ops/conv.py:419'),
    # the M-step's weighted sums (K31, row 18b): the statistics, then the
    # residual covariance; float32 and float64
    'arhmm_mstep_stats': ('behavenet_tpu_torch/kernels/arhmm_mstep.cu',
                          'behavenet_tpu/models/arhmm.py:522'),
    'arhmm_mstep_cov': ('behavenet_tpu_torch/kernels/arhmm_mstep.cu',
                        'behavenet_tpu/models/arhmm.py:537'),
    'arhmm_mstep_stats_f64': ('behavenet_tpu_torch/kernels/arhmm_mstep.cu',
                              'behavenet_tpu/models/arhmm.py:522'),
    'arhmm_mstep_cov_f64': ('behavenet_tpu_torch/kernels/arhmm_mstep.cu',
                            'behavenet_tpu/models/arhmm.py:537'),
    # float64 EM's launchers of K8-K11 (em_dtype 'float64')
    'arhmm_log_likes_f64': ('behavenet_tpu_torch/kernels/arhmm_log_likes.cu',
                            'behavenet_tpu/models/arhmm.py:187'),
    'arhmm_log_likes_robust_f64': ('behavenet_tpu_torch/kernels/arhmm_log_likes.cu',
                                   'behavenet_tpu/models/arhmm.py:211'),
    'hmm_forward_backward_f64': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                                 'behavenet_tpu/ops/hmm.py:115'),
    'hmm_forward_backward_tv_f64': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                                    'behavenet_tpu/ops/hmm.py:167'),
    'hmm_forward_f64': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                        'behavenet_tpu/ops/hmm.py:39'),
    'hmm_forward_tv_f64': ('behavenet_tpu_torch/kernels/hmm_forward_backward.cu',
                           'behavenet_tpu/ops/hmm.py:39'),
    'hmm_viterbi_f64': ('behavenet_tpu_torch/kernels/hmm_viterbi.cu',
                        'behavenet_tpu/ops/hmm.py:186'),
    'hmm_viterbi_tv_f64': ('behavenet_tpu_torch/kernels/hmm_viterbi.cu',
                           'behavenet_tpu/ops/hmm.py:186'),
    'solve_small_f64': ('behavenet_tpu_torch/kernels/solve_small.cu',
                        'behavenet_tpu/ops/smallmat.py:17'),
    # the time-sharded passes (row 19a): a shard's totals (K32, log and
    # (max, +) semirings), its finish (K33: posteriors, filtered alphas,
    # backpointers), its map total (K34: from the backpointers or drawn) and
    # its backtrace (K35)
    'hmm_shard_totals': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                         'behavenet_tpu/parallel/seq.py:58'),
    'hmm_shard_totals_maxplus': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                                 'behavenet_tpu/parallel/seq.py:58'),
    'hmm_shard_finish': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                         'behavenet_tpu/parallel/seq.py:143'),
    'hmm_shard_finish_alpha': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                               'behavenet_tpu/parallel/seq.py:134'),
    'hmm_shard_finish_viterbi': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                                 'behavenet_tpu/parallel/seq.py:182'),
    'hmm_shard_maps': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                       'behavenet_tpu/parallel/seq.py:208'),
    'hmm_shard_maps_sample': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                              'behavenet_tpu/parallel/seq.py:214'),
    'hmm_shard_backtrace': ('behavenet_tpu_torch/kernels/hmm_shard.cu',
                            'behavenet_tpu/parallel/seq.py:208'),
    # the time-sharded Kalman passes (row 19b): a shard's filtering total
    # (K36) and its filtered moments (K37), its smoothing total (K38) and
    # its smoothed moments (K39)
    'kalman_shard_filter_totals': ('behavenet_tpu_torch/kernels/kalman_shard.cu',
                                   'behavenet_tpu/parallel/seq.py:238'),
    'kalman_shard_filter_finish': ('behavenet_tpu_torch/kernels/kalman_shard.cu',
                                   'behavenet_tpu/parallel/seq.py:238'),
    'kalman_shard_smoother_totals': ('behavenet_tpu_torch/kernels/kalman_shard.cu',
                                     'behavenet_tpu/parallel/seq.py:258'),
    'kalman_shard_smoother_finish': ('behavenet_tpu_torch/kernels/kalman_shard.cu',
                                     'behavenet_tpu/parallel/seq.py:258'),
    # the recurrent transitions' Adam M-step (K40) and the Student's-t dof's
    # Newton M-step (K41) (row 18c); float32 and float64
    'arhmm_recurrent_mstep': ('behavenet_tpu_torch/kernels/arhmm_recurrent_mstep.cu',
                              'behavenet_tpu/models/arhmm.py:641'),
    'arhmm_recurrent_mstep_f64': ('behavenet_tpu_torch/kernels/arhmm_recurrent_mstep.cu',
                                  'behavenet_tpu/models/arhmm.py:641'),
    'arhmm_nu_mstep': ('behavenet_tpu_torch/kernels/arhmm_nu_mstep.cu',
                       'behavenet_tpu/models/arhmm.py:582'),
    'arhmm_nu_mstep_f64': ('behavenet_tpu_torch/kernels/arhmm_nu_mstep.cu',
                           'behavenet_tpu/models/arhmm.py:582'),
}

# the kernels a served request runs (an AE train step runs K1-K6, a
# beta-TC-VAE or PS-VAE step K1-K7, an MSPS-VAE step K25 and K26 too; ARHMM
# EM runs K8, K9, K11 and K31's two passes, the ARHMM CLI and serving K10 too)
SERVE_KERNELS = ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'conv_transpose2d_smallcout_sigmoid')
AE_KERNELS = SERVE_KERNELS + ('conv2d_grad_w_nhwc', 'masked_mse', 'amsgrad_step')
VAE_KERNELS = AE_KERNELS + ('decomposed_kl',)
MSPS_KERNELS = VAE_KERNELS + ('triplet_loss', 'triplet_loss_grad')
MSTEP_KERNELS = ('solve_small', 'arhmm_mstep_stats', 'arhmm_mstep_cov')
EM_KERNELS = ('arhmm_log_likes', 'hmm_forward_backward') + MSTEP_KERNELS
ARHMM_KERNELS = EM_KERNELS + ('hmm_viterbi',)
# a recurrent + robust ARHMM's EM, CLI and serving run the launchers for
# Student's-t observations and time-varying transitions, and its M-step K40
# and K41
REC_MSTEP_KERNELS = ('arhmm_recurrent_mstep', 'arhmm_nu_mstep')
RECURRENT_EM_KERNELS = ('arhmm_log_likes_robust', 'hmm_forward_backward_tv') + MSTEP_KERNELS \
    + REC_MSTEP_KERNELS
RECURRENT_KERNELS = RECURRENT_EM_KERNELS + ('hmm_viterbi_tv',)
# float64 EM (em_dtype 'float64') runs every one of them in its _f64 form
F64_MSTEP_KERNELS = tuple(k + '_f64' for k in MSTEP_KERNELS)
F64_EM_KERNELS = ('arhmm_log_likes_f64', 'hmm_forward_backward_f64') + F64_MSTEP_KERNELS
F64_REC_EM_KERNELS = ('arhmm_log_likes_robust_f64', 'hmm_forward_backward_tv_f64') + \
    F64_MSTEP_KERNELS + tuple(k + '_f64' for k in REC_MSTEP_KERNELS)
F64_CLI_KERNELS = F64_EM_KERNELS + ('hmm_forward_f64', 'hmm_viterbi_f64')

# The ARHMM at the JAX package's EM benchmark shapes (bench.py:300
# measure_arhmm_em; the reference NP dataset's 1000-frame trials,
# SURVEY.md:391; configs/arhmm_jsons/arhmm_training.json n_iters), and the
# CLI's published grid on 189-frame Musall trials.
EM_STATES, EM_DIM, EM_TRIALS, EM_FRAMES, EM_ITERS = 16, 9, 100, 1000, 20
EM_CUT = 700                 # every tenth trial cut to 700 frames: the mask path
EM_TIMED_ITERS = 5           # timed EM iterations, after 2 warm-up ones
CLI_TRIALS = 50              # 40 train, 5 val, 5 test trials of TRIAL frames
CLI_IDS = ('musall', 'smoke', 'mouse', 'session-0')
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
# parallel_scan (K13, K14) and sampling (K15, K16) at the same shapes, and
# one 100,000-frame session (the JAX package's long-trial design point,
# behavenet_tpu/ops/hmm.py:118-121). K13's posteriors and log_Z are held to
# the plain parallel version run in float64 within max(the K9 tolerances,
# twice the larger error of K9 and of the plain float32 version): at |log_Z|
# ~ 1e4 (EM shapes) to ~1e6 (100k frames) one float32 ulp of alpha is
# 1e-3 to 0.06 in log space. K14 as K10 (PATH_AGREE, PATH_LP_REL_TOL, the
# joint log-probabilities in float64). K15 and K16 against their plain
# versions from the same uniforms: paths equal, or agreeing on PATH_AGREE
# of the frames with each first differing draw a near-tie (the two states'
# scores within DRAW_TIE_TOL). Draw frequencies within SAMPLE_SE standard
# errors (plus one draw's worth, for a count's discreteness) of gamma (K15,
# SAMPLE_DRAWS draws of one trial) and of softmax(log_Ps) (K16, CHAINS
# chains of CHAIN_STEPS steps).
# K31 (the M-step's weighted sums, row 18b) against its plain version on the
# EM trials cut to seeded lengths in MSTEP_LENGTHS, at MSTEP_CASES (states,
# lags, diagonal, robust): the float32 kernel (float32 in and out, float64
# sums) within MSTEP_F32_REL_TOL of each output's largest entry from the
# plain version in float64, and no farther from it than the plain float32
# version (or one float32 ulp of that entry, F32_ULP); the float64 kernel
# within MSTEP_F64_REL_TOL; a second call equal bit for bit. The float64
# launchers of K8-K11 against their plain versions in float64 within
# F64_REL_TOL of each output's largest entry (float64 sums of up to 1000
# steps in another order), Viterbi paths as K10's float32 ones, at the EM
# shape and the CLI's (F64_CLI_STATES states). Float64 EM: F64_EM_ITERS
# iterations, the first one's LL and parameters within F64_PARAM_REL_TOL of
# a plain float64 iteration; the CLI over F64_CLI_GRID.
MSTEP_LENGTHS = (900, 1000)
MSTEP_CASES = {'full': (EM_STATES, 1, False, False), 'diagonal': (EM_STATES, 1, True, False),
               'robust': (EM_STATES, 1, False, True), 'lags0': (EM_STATES, 0, False, False),
               'lags2': (EM_STATES, 2, False, False), 'k2': (2, 1, False, False)}
MSTEP_F32_REL_TOL, MSTEP_F64_REL_TOL, F32_ULP = 1e-5, 1e-12, 2.0 ** -23
F64_REL_TOL, F64_CLI_STATES, F64_EM_ITERS, F64_PARAM_REL_TOL = 1e-10, 4, 10, 1e-9
F64_CLI_GRID = [2, 4]
# Row 18c: K40 (the recurrent transitions' 25 Adam steps) and K41 (the
# dof's 10 Newton steps) on the EM trials, full and with every tenth trial
# cut to EM_CUT frames, for 'recurrent' ('robust_ar') and 'recurrent_only'
# ('diagonal_robust_ar') under the seeded recurrent models (xis from K9, tau
# from K8), and at the CLI's shape (its 50 trials of TRIAL frames) for each
# K of REC_CLI_GRID under 'recurrent' ('robust_ar'), each against its plain
# version run in float64 on the card on the same inputs. K40's float32
# log_Ps, Rs and r within max(REC_F32_ABS_TOL, twice the plain float32
# version's own distance) of it, but never more than REC_F32_ABS_CAP
# (Adam's first step is lr sign(g): an entry of g near 0 may flip sign
# between two summation orders and move by 2 lr; the smallest |g| over the
# largest at step 1 is reported; a flip in the plain version fails the case
# rather than widen its gate); the float64 ones within REC_F64_ABS_TOL.
# K41's float32 nus within max(NU_F32_REL_TOL, twice the plain float32
# version's relative distance), at most NU_F32_REL_CAP, of it (the forward
# difference amplifies digamma's last bits by 1e3-1e5), the float64 ones
# within NU_F64_REL_TOL. The trial layout's two parts (the trials halved)
# and a strided tau held as one part; a second call equal bit for bit. The
# device digamma against torch.digamma in float64 over DIGAMMA_RANGE,
# within DIGAMMA_TOL of max(1, |digamma|).
REC_F32_ABS_TOL, REC_F32_ABS_CAP, REC_F64_ABS_TOL = 1e-5, 1e-4, 1e-9
NU_F32_REL_TOL, NU_F32_REL_CAP, NU_F64_REL_TOL = 1e-4, 1e-3, 1e-9
REC_CLI_GRID = (2, 4, 8, 12)  # configs/arhmm_jsons/arhmm_model.json's n_arhmm_states
DIGAMMA_RANGE, DIGAMMA_TOL = (0.5, 110.0), 1e-13
ADAM_STEPS = 25
PARALLEL_EM_KERNELS = ('arhmm_log_likes', 'hmm_scan') + MSTEP_KERNELS
PARALLEL_REC_EM_KERNELS = ('arhmm_log_likes_robust', 'hmm_scan_tv') + MSTEP_KERNELS + \
    REC_MSTEP_KERNELS
PARALLEL_REC_DECODE_KERNELS = ('hmm_viterbi_scan_tv', 'hmm_sample_posterior_tv')
PARALLEL_CLI_KERNELS = ('arhmm_log_likes', 'hmm_scan', 'hmm_viterbi_scan') + MSTEP_KERNELS
LONG_FRAMES = 100000
SAMPLE_DRAWS, CHAINS, CHAIN_STEPS, SAMPLE_LEN = 400, 1000, 1000, 1000
# The time-sharded passes (K32-K35, row 19a) on the long session, on meshes
# that repeat the card SP_SHARDS times: an n-shard mesh on one card runs
# every shard's launches and every exchange, one shard after another. K32
# and K33 against the plain parallel/seq.py passes and float64 as K13 is
# held (check_scan's tolerances); paths and draws against the plain
# versions by PATH_AGREE and, Viterbi, PATH_LP_REL_TOL; the filtered alphas
# within LOGZ_REL_TOL of their largest magnitude, and against the plain
# forward pass in float64 frame by frame, relative to each frame's largest
# magnitude (at least 1), within LOGZ_REL_TOL or twice the larger of the
# plain float32 pass's and K13's own errors; with one shard K13-K15's
# outputs bit for bit. The shard boundaries (each
# boundary step's xi counted once) and padding on the long session's first
# SP_CUT_FRAMES frames with the frames from SP_CUT_VALID on masked, on
# meshes of SP_CUT_SHARDS shards (with 8 the last shard is padding only):
# xi_sum within SP_XI_ABS_TOL counts of the plain pass's in every entry,
# and its total within SP_XI_COUNT_TOL of the number of steps between two
# valid frames (a dropped or doubled boundary step moves it by 1). EM on
# meshes (SP_EM_SHARDS for the time layout on two long sessions,
# SP_TRIAL_SHARDS for the trial layout on the EM workload): SP_EM_ITERS
# iterations, with and without iters_per_dispatch SP_DISPATCH, the LLs
# non-decreasing and within SP_EM_REL_TOL of the unsharded fit's (K13 on
# the long sessions: K9's float32 log_Z drifts 7e-4 there).
SP_SHARDS, SP_EM_SHARDS, SP_TRIAL_SHARDS = (1, 2, 4), 4, 2
SP_CUT_FRAMES, SP_CUT_VALID, SP_CUT_SHARDS = 1003, 880, (4, 8)
SP_XI_ABS_TOL, SP_XI_COUNT_TOL = 1e-3, 1e-2
MESH_CARD_ITERS = 3   # EM iterations of each fit in mesh_cards
SP_EM_ITERS, SP_DISPATCH, SP_EM_REL_TOL = 4, 2, 1e-4
# the recurrent + robust model in the trial layout (K40's and K41's passes
# per part, their sums on the first): SP_REC_ITERS iterations against the
# unsharded fit, LLs within SP_EM_REL_TOL and every parameter within
# REC_PARAM_REL_TOL of its largest entry
SP_REC_ITERS = 2
SP_KERNELS = ('hmm_shard_totals', 'hmm_shard_finish', 'hmm_shard_totals_maxplus',
              'hmm_shard_finish_viterbi', 'hmm_shard_maps', 'hmm_shard_backtrace',
              'hmm_shard_finish_alpha', 'hmm_shard_maps_sample')
DRAW_TIE_TOL, SAMPLE_SE = 1e-5, 5.0

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
    'neural-ae-lstm': ('neural-ae', 'lstm', 'ae_latents', DEC_LATENTS, 'gaussian',
                       ('lstm_forward', 'lstm_backward', 'masked_mse', 'amsgrad_step')),
    'neural-arhmm-lstm': ('neural-arhmm', 'lstm', 'arhmm_states', DEC_STATES, 'categorical',
                          ('lstm_forward', 'lstm_backward', 'amsgrad_step')),
}
NLL_DIMS = (DEC_LATENTS, 16)   # the published latents; the widest K12 takes
PREDICT_FRAMES = (TRIAL, 1000)
# K12 vs its plain version: the loss within LOSS_REL_TOL, the gradients
# within NLL_GRAD_REL_TOL of max|plain| (float32 factors of covariances
# with condition numbers up to ~5e3, in another operation order).
NLL_GRAD_REL_TOL = 1e-4
# A served prediction vs the float64 forward of the same weights.
PREDICT_ABS_TOL = 1e-4
# The LSTM decoder (DECODERS' 'lstm' entries: n_hid_units 32 of the
# published config, bidirectional as JAX's default) and K23 / K24 at
# LSTM_HIDDEN units: the config's, JAX's default when a config gives none
# (models/decoders.py:141), 128 (above the 119 units whose W_hh fits one
# block's shared memory: K24 in a cluster of 2), 150 (a cluster of 2 with
# rows not a multiple of 8), 200 (a cluster of 4), 256 (a cluster of 8) and
# 400 (above the 330 units a cluster of 8 holds: K24's one-block chain,
# part of W_hh read through L2), so every branch of K24's plan is held
# against the plain version. Kernel vs plain
# version, float32 on the card: hidden states (in (-1, 1)) within
# LSTM_ABS_TOL (192-step chains, sums in another order); gradients within
# LSTM_GRAD_REL_TOL of max|plain| (sums over 192 frames); on one
# LSTM_LONG-frame trial, hidden states within max(LSTM_ABS_TOL, twice the
# float32 plain version's distance) of the plain version in float64, and
# K24's dx, dW and db within max(LSTM_GRAD_REL_TOL, twice the float32
# autograd's distance) of autograd in float64, each over its max.
LSTM_HIDDEN = (DEC_HP['n_hid_units'], 64, 128, 150, 200, 256, 400)
LSTM_LONG = 1000
LSTM_ABS_TOL, LSTM_GRAD_REL_TOL = 1e-4, 1e-4
# K24's launches, by device kernel name (check_lstm's split)
LSTM_SPLIT = {'bptt': ('lstm_bptt_',), 'dw': ('lstm_dw_kernel',), 'dx': ('lstm_dx_kernel',)}
# the LSTM decoder step at a width whose W_hh a block cannot hold (K24 in a
# cluster of 2)
LSTM_STEP_HIDDEN = 128

# The Bayesian decoder at the published config (configs/bayesian_jsons: the
# ARHMM CLI's K = 4 version over the 9 latents, lags 1, Gaussian noise,
# stationary transitions; state evidence and smoothing on) on the ARHMM
# CLI's 189-frame trials, NaN-padded to the 192-frame bucket. K17 and K18
# are held to their plain versions at IMM_CASES ((K, lags): the CLI's, the
# shift block of lags 2, the published ARHMM grid's largest K) within
# IMM_REL_TOL of each output's max(1, max|plain|) (float32 chains of 192
# steps in another operation order), and on one IMM_LONG-frame trial to
# the plain versions in float64 within twice the float32 plain version's
# own distance. A served decode against its plain twin:
# latents, covariances and posteriors within BAYES_ABS_TOL (relative as
# above), states equal.
BAYES_CONFIGS = os.path.join(HERE, 'configs', 'bayesian_jsons')
BAYES_STATES = 4
IMM_CASES = {'cli': (BAYES_STATES, 1), 'lags2': (BAYES_STATES, 2), 'k12': (12, 1)}
IMM_LONG = 10000
IMM_REL_TOL, BAYES_ABS_TOL = 1e-4, 1e-4
BAYES_KERNELS = ('hmm_forward_backward', 'hmm_viterbi', 'imm_filter', 'rts_smoother')
BAYES_PARALLEL_KERNELS = ('hmm_scan', 'hmm_viterbi_scan', 'imm_filter', 'rts_smoother')

# decode(parallel=True): the associative Kalman filter and smoother (K19,
# K20; row 17) over the gamma-weighted soft dynamics, with K13 and K14. The
# kernels, and the sequential K21 and K22 of ops.kalman, are held to their
# plain versions on the card at KALMAN_CASES: the CLI's soft LDS (the
# 192-frame bucket, 189 frames with NaN borders, K = 4, 9 latents, H = [I
# 0]), lags 2 (n = 18) and a general H (the JAX package's Kalman tests'
# make_system at n = 9, d = 5, a quarter of the steps unobserved), and K19 /
# K20 to K21 / K22. The float64 sequential versions on the host are the
# yardstick: each kernel within max(KALMAN_REL_TOL, twice the float32 plain
# version's distance from them) of them, and within max(KALMAN_REL_TOL,
# three times that distance) of its plain version (both distances add up;
# relative to each output's max(1, max|plain|)). On one IMM_LONG-frame trial
# (above 8192 frames: the plain parallel version's chunked branch) K19 and
# K20 at each of KALMAN_CHUNKS (None: the kernels' own, scan_chunk(T)) are
# within twice the float32 plain parallel version's distance from float64.
# K11's pivoting launcher against solve_small_plain(pivot=True) within
# SOLVE_REL_TOL at the combine's matrices I + C1 J2 (the CLI case's
# elements, n = 9, and a general LDS's at n = 16, K11's widest), and on the
# same with a zero leading pivot, where the unpivoted elimination is not
# finite. The long session: one LONG_FRAMES-frame trial drawn from the
# fitted EM workload's ARHMM; JAX's gates (tests/test_models/
# test_bayesian.py:124-145): the parallel decode's MSE below
# LONG_RAW_SHARE x the raw predictions' and below LONG_SEQ_SHARE x the
# sequential decode's.
KALMAN_CASES = ('cli', 'lags2', 'general')
KALMAN_CHUNKS = (None, 32, 1024)
KALMAN_REL_TOL = 1e-4
LONG_RAW_SHARE, LONG_SEQ_SHARE = 0.2, 1.5
BAYES_ASSOC_KERNELS = ('hmm_scan', 'hmm_viterbi_scan', 'kalman_filter_scan',
                       'kalman_smoother_scan')
KALMAN_OPS_KERNELS = ('kalman_filter', 'kalman_smoother', 'kalman_filter_scan',
                      'kalman_smoother_scan', 'solve_small_pivot')

# The time-sharded Kalman passes (K36-K39, row 19b) and decode(mesh=), on
# meshes that repeat the card SP_SHARDS times, at the long session's soft
# LDS (bayesian_long_session: K = 16, n = d = 9, LONG_FRAMES frames) and
# the CLI's (soft_lds at the 192-frame bucket). With one shard K36 + K37
# give K19's (ms, Ps) and K38 + K39 K20's bit for bit (the same chunks,
# carries and recursions). On n shards each output against the plain
# sharded pass on the same mesh and inputs and both against the plain pass
# in float64 on the card (the smoother on K19's moments), per frame: the
# largest distance in a frame relative to max(1, that frame's largest
# |float64|), the kernel within max(KALMAN_REL_TOL, twice the larger of the
# plain float32 pass's and K19's (K20's) own distances) of float64 and
# within max(KALMAN_REL_TOL, three times it) of the plain pass (the two
# distances add up). The boundaries: SP_KALMAN_CUT frames of the long
# session's dynamics with the observations masked on both sides of every
# cut and from SP_KALMAN_VALID on (with 8 shards the last shard predicts
# only), on SP_CUT_SHARDS shards; and short trials of SP_KALMAN_SHORT
# frames on 8 shards (empty shards, a shard that holds only the terminal
# frame), every frame against the plain pass as above.
SP_KALMAN_CUT, SP_KALMAN_VALID, SP_KALMAN_SHORT = 1003, 880, (5, 9)
SP_KALMAN_KERNELS = ('kalman_shard_filter_totals', 'kalman_shard_filter_finish',
                     'kalman_shard_smoother_totals', 'kalman_shard_smoother_finish')
# decode(mesh=) against decode(parallel=True) of the same trial and a
# float64 decode on the card (the plain passes in float64: the discrete
# pass's gamma, the gamma-weighted dynamics, the Kalman filter and
# smoother): gamma within max(GAMMA_ABS_TOL, twice the unsharded decode's
# own distance) of the float64 gamma; the paths agreeing on PATH_AGREE of
# the frames; the latents and their covariances, per frame as above,
# within max(KALMAN_REL_TOL, twice the unsharded decode's distance) of the
# float64 decode's and within max(KALMAN_REL_TOL, three times it) of the
# unsharded decode's (float32 gammas differ by up to a few 1e-2 at near
# ties of 100,000-frame chains and carry into F, c, Q); and within the
# K36-K39 tolerances above of the float64 plain Kalman passes on the mesh
# decode's own gamma.
BAYES_SP_KERNELS = SP_KERNELS[:6] + SP_KALMAN_KERNELS


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase lines carry the script's elapsed seconds."""
    if 'phase' in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - _T0, 1))
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
    from behavenet_tpu_torch.fitting import (arhmm_grid_search, bayesian_decoder_grid_search,
                                             experiment, hyperparams, training)
    from behavenet_tpu_torch.fitting import eval as fit_eval
    from behavenet_tpu_torch.kernels import build
    from behavenet_tpu_torch.models import aes, arch, arhmm, base, bayesian, decoders, vaes
    from behavenet_tpu_torch.ops import conv as ops
    from behavenet_tpu_torch.ops import hmm, imm, kalman, losses, lstm, optim, smallmat
    from behavenet_tpu_torch.parallel import mesh, seq
    from behavenet_tpu_torch.utils import pickles, weights
    return types.SimpleNamespace(mesh=mesh, seq=seq,
        serving=serving, build=build, arch=arch, base=base, ops=ops, aes=aes,
        vaes=vaes, losses=losses, optim=optim, training=training,
        experiment=experiment, weights=weights, arhmm=arhmm, hmm=hmm, smallmat=smallmat,
        pickles=pickles, arhmm_grid_search=arhmm_grid_search, hyperparams=hyperparams,
        decoders=decoders, imm=imm, kalman=kalman, lstm=lstm, bayesian=bayesian,
        bayesian_decoder_grid_search=bayesian_decoder_grid_search, fit_eval=fit_eval)


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


def layer_shapes(hp, n, prefix=''):
    """One entry per conv layer of a conv AE arch at batch ``n``: the
    default AE's, or a pooling / batch-norm arch's, whose convs ahead of a
    batch norm or a pool run without an activation and whose last layer
    goes to K3 only when it upsamples (models/aes.py). ``prefix`` names the
    arch in the layer labels."""
    layers = []
    h, w = IMG[1], IMG[2]
    c = IMG[0]
    bn = bool(hp.get('ae_batch_norm'))
    types = hp['ae_encoding_layer_type']
    for i, co in enumerate(hp['ae_encoding_n_channels']):
        if types[i] == 'conv':
            pool = i + 1 < len(types) and types[i + 1] == 'maxpool'
            layers.append(dict(
                layer='%sconv_%d' % (prefix, i), kernel='conv2d_nhwc', n=n, h=h, w=w, ci=c,
                co=co, k=hp['ae_encoding_kernel_size'][i], s=hp['ae_encoding_stride_size'][i],
                pad_y=tuple(hp['ae_encoding_y_padding'][i]),
                pad_x=tuple(hp['ae_encoding_x_padding'][i]), out_pad=(0, 0),
                act=None if (bn or pool) else 'leaky_relu', uint8=i == 0))
        h, w, c = hp['ae_encoding_y_dim'][i], hp['ae_encoding_x_dim'][i], co
    c, h, w = hp['ae_decoding_starting_dim']
    last = len(hp['ae_decoding_n_channels']) - 1
    for i, co in enumerate(hp['ae_decoding_n_channels']):
        if hp['ae_decoding_layer_type'][i] == 'convtranspose':
            s = hp['ae_decoding_stride_size'][i]
            layers.append(dict(
                layer='%sconvt_%d' % (prefix, i),
                kernel='conv_transpose2d_smallcout_sigmoid' if i == last and s > 1 and co <= 4
                else 'conv_transpose2d_nhwc', n=n, h=h, w=w, ci=c, co=co,
                k=hp['ae_decoding_kernel_size'][i], s=s,
                pad_y=tuple(hp['ae_decoding_y_padding'][i]),
                pad_x=tuple(hp['ae_decoding_x_padding'][i]), out_pad=(0, 0),
                act='sigmoid' if i == last else (None if bn else 'leaky_relu'), uint8=False))
        h, w, c = hp['ae_decoding_y_dim'][i], hp['ae_decoding_x_dim'][i], co
    return layers


def check_layer(L, ops, gen, timing=None):
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
    rerun_bitwise = bool(torch.equal(out_k, kernel()))
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
        rerun_bitwise=rerun_bitwise, gflop=2 * macs / 1e9, mbytes=nbytes / 1e6,
        **timed(kernel, plain, library, max(t_ops, t_bytes), timing),
        t_ops_ms=t_ops, t_bytes_ms=t_bytes,
        bound_by='operations' if t_ops >= t_bytes else 'bytes')
    emit(rec)
    if not finite or max_abs > abs_tol or max_rel > REL_TOL or not rerun_bitwise:
        raise AssertionError('%s: kernel disagrees with its plain version or itself '
                             '(finite=%s, max abs %.3g > %.3g or max rel %.3g > %.3g, '
                             'rerun bitwise %s)' % (L['layer'], finite, max_abs, abs_tol,
                                                    max_rel, REL_TOL, rerun_bitwise))
    return rec


def timed(kernel, plain, library, bound_ms, timing=None):
    """A check's times: the kernel, its plain version and the library call
    (median_ms), the kernel over the library (``vs_library``) and the bound
    over the kernel (``share_of_bound``); where the kernel is slower than
    the library call, the device kernels that call ran (``library_kernels``,
    from ``torch.profiler``: which algorithm cuDNN picked)."""
    ms = median_ms(kernel, **(timing or {}))
    library_ms = median_ms(library, **(timing or {}))
    rec = dict(ms=ms, plain_ms=median_ms(plain, **(timing or {})), library_ms=library_ms,
               bound_ms=bound_ms, vs_library=ms / library_ms, share_of_bound=bound_ms / ms)
    if rec['vs_library'] > 1.0:
        rec['library_kernels'] = sorted(device_kernels(library))
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


def plain_layer(layer, ops, x, train, pool_idx, replay=None):
    """One encoder or decoder layer through the plain versions: a pool
    pushes its indices onto ``pool_idx``, an unpool pops them; batch norm
    in train mode (or untracked) uses the batch's statistics, and in train
    mode also updates the layer's running statistics as K29 does. With
    ``replay`` (``recorded_decisions`` of the kernel path, consumed in
    order) a pool takes the kernel path's indices and window weights and a
    fused leaky ReLU its signs; the arithmetic stays the plain versions'."""
    kind = type(layer).__name__
    if kind == 'Unpool':
        return ops.max_unpool2d_plain(x, pool_idx.pop(), layer.out_hw)
    if kind == 'MaxPool':
        if replay is None:
            y, idx = ops.max_pool2d_plain(x, layer.ceil_mode, layer.activation)
            pool_idx.append(idx)
            return y
        idx, weights, sign = replay.pop(0)
        pool_idx.append(idx)
        y = (ops.pool_windows(x, layer.ceil_mode) * weights).sum(dim=-1)
        return torch.where(sign, y, 0.05 * y) if layer.activation else y
    act, sign = layer.activation, None
    if replay is not None and act == 'leaky_relu':
        act, sign = None, replay.pop(0)
    if kind == 'ConvLayer':
        y = ops.conv2d_plain(x, layer.weight.permute(2, 3, 1, 0), layer.bias, layer.stride,
                             layer.pad_y, layer.pad_x, act)
    elif kind == 'ConvTransposeLayer':
        y = ops.conv_transpose2d_plain(x, layer.weight.permute(2, 3, 0, 1), layer.bias,
                                       layer.stride, layer.pad_y, layer.pad_x, layer.out_pad,
                                       act)
    elif layer.track and not train:
        y = ops.batch_norm_plain(x, layer.weight, layer.bias, layer.running_mean,
                                 layer.running_var, activation=act)
    else:
        if layer.track:
            with torch.no_grad():
                new = ops.batch_norm_update(x, {'running_mean': layer.running_mean,
                                                'running_var': layer.running_var,
                                                'num_batches': layer.num_batches_tracked},
                                            layer.momentum)
                layer.running_mean.copy_(new['running_mean'])
                layer.running_var.copy_(new['running_var'])
                layer.num_batches_tracked.copy_(new['num_batches'])
        y = ops.batch_norm_plain(x, layer.weight, layer.bias, activation=act)
    if sign is not None and isinstance(replay, Replay):
        replay.note(y, sign)
    return y if sign is None else torch.where(sign, y, 0.05 * y)


class Replay(list):
    """``recorded_decisions`` to replay (``plain_layer`` pops them in
    order), noting at each replayed leaky-ReLU sign where the plain path's
    own pre-activation would take the other branch: how many entries, the
    largest |pre-activation| among them and the layer's largest."""

    def __init__(self, decisions):
        super().__init__(decisions)
        self.flips = []

    def note(self, y, sign):
        flip = (y >= 0) != sign
        n = int(flip.sum().item())
        self.flips.append(dict(flips=n, max_abs=y.abs().max().item(),
                               max_abs_at_flips=y.abs()[flip].max().item() if n else 0.0))


def plain_features(model, ops, frames, train=False, pool_idx=None, replay=None):
    """The encoder's layers through the plain versions, flattened (C, H, W)
    as its dense heads read it; its pool indices appended to ``pool_idx``;
    ``replay`` as for ``plain_layer``."""
    x = frames
    pool_idx = [] if pool_idx is None else pool_idx
    for layer in model.encoding.encoder.values():
        x = plain_layer(layer, ops, x, train, pool_idx, replay)
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def plain_decode(model, ops, z, train=False, pool_idx=(), replay=None):
    """The decoder through the plain versions, at the encoder's pool indices."""
    c, h, w = model.decoding.starting_dim
    y = model.decoding.FF(z).reshape(z.shape[0], c, h, w).permute(0, 2, 3, 1)
    stack = list(pool_idx)
    for layer in model.decoding.decoder.values():
        y = plain_layer(layer, ops, y, train, stack, replay)
    return y


def plain_forward(model, ops, frames, decode=True, train=False, replay=None):
    """The AE's forward through the plain PyTorch versions only:
    (reconstruction or None, latents); batch norm in eval mode unless
    ``train``; ``replay`` as for ``plain_layer``."""
    pool_idx = []
    if replay is not None and not isinstance(replay, Replay):
        replay = list(replay)
    z = model.encoding.FF(plain_features(model, ops, frames, train, pool_idx, replay))
    return (plain_decode(model, ops, z, train, pool_idx, replay) if decode else None), z


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


def check_backward_layer(L, ops, gen, timing=None):
    """The backward of one layer at the train step's shapes: grad-w (K4) and,
    unless the input is uint8 frames, grad-x (K2 for a conv, K1 for a
    transposed conv), each against its plain version and cuDNN's wgrad /
    dgrad through ``torch.autograd.grad``. Grad-w sums over every output
    pixel (786 k at the default arch's first layer, 3.1 M at the stride-1
    archs'), where the plain version's float32 sum (cuDNN) itself drifts up
    to ~1.2e-3 (relative, as ``errors`` measures it) from the exact one on
    the H100, ten times K4's drift: so K4 is held to the plain version run
    in float64, and its distance from the float32 plain version and that
    version's own are reported beside it."""
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

    x64 = x.double() / 255.0 if L['uint8'] else x.double()
    passes = []
    if transposed:
        pw_y, pw_x = (py[0], py[1] - op[0]), (px[0], px[1] - op[1])
        passes.append(('grad_w', 'conv2d_grad_w_nhwc',
                       lambda: ops.conv2d_grad_w(g, x, k, s, pw_y, pw_x, True),
                       lambda: ops.conv2d_grad_w_plain(g, x, k, s, pw_y, pw_x, True), wl,
                       lambda: ops.conv2d_grad_w_plain(g.double(), x64, k, s, pw_y, pw_x, True)))
        passes.append(('grad_x', 'conv2d_nhwc',
                       lambda: ops.conv_transpose2d_grad_x(g, w, s, py, px, op),
                       lambda: ops.conv_transpose2d_grad_x_plain(g, w, s, py, px, op), xl, None))
    else:
        passes.append(('grad_w', 'conv2d_grad_w_nhwc',
                       lambda: ops.conv2d_grad_w(x, g, k, s, py, px),
                       lambda: ops.conv2d_grad_w_plain(x, g, k, s, py, px), wl,
                       lambda: ops.conv2d_grad_w_plain(x64, g.double(), k, s, py, px)))
        if not L['uint8']:
            hw = (L['h'], L['w'])
            passes.append(('grad_x', 'conv_transpose2d_nhwc',
                           lambda: ops.conv2d_grad_x(g, w, s, py, px, hw),
                           lambda: ops.conv2d_grad_x_plain(g, w, s, py, px, hw), xl, None))

    rows = []
    for name, kernel_name, kernel, plain, wrt, exact in passes:
        out_k, out_p = kernel(), plain()
        rerun_bitwise = bool(torch.equal(out_k, kernel()))
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape:
            raise AssertionError('%s %s: kernel shape %s, plain %s' % (
                L['layer'], name, tuple(out_k.shape), tuple(out_p.shape)))
        extra = {}
        if exact is not None:
            ref = exact().float()
            extra = dict(reference='plain_float64',
                         plain_f32_max_rel_err=errors(out_p, ref, scaled_floor=True)[2],
                         kernel_vs_plain_f32_max_rel_err=errors(out_k, out_p,
                                                                scaled_floor=True)[2])
            out_p = ref
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
            frames=L['n'], stride=s, cotangent=list(g.shape), output=out_shape,
            max_abs_err=max_abs, abs_tol=abs_tol, max_rel_err=max_rel, rel_tol=REL_TOL,
            rerun_bitwise=rerun_bitwise, **extra, gflop=2 * macs / 1e9, mbytes=nbytes / 1e6,
            **timed(kernel, plain, library, max(t_ops, t_bytes), timing),
            t_ops_ms=t_ops, t_bytes_ms=t_bytes,
            bound_by='operations' if t_ops >= t_bytes else 'bytes')
        emit(rec)
        if not finite or max_abs > abs_tol or max_rel > REL_TOL or not rerun_bitwise:
            raise AssertionError('%s %s: kernel disagrees with its plain version: %s'
                                 % (L['layer'], name, rec))
        rows.append(rec)
    return rows


def arch_conv_checks(ops, hp, gen, prefix='', timing=None):
    """check_layer at every conv layer of an arch (the 189-frame trial), then
    check_backward_layer at each (the 192-frame bucket)."""
    checks = [check_layer(L, ops, gen, timing) for L in layer_shapes(hp, TRIAL, prefix)]
    for L in layer_shapes(hp, BUCKET, prefix):
        checks += check_backward_layer(L, ops, gen, timing)
    return checks


def check_ragged(ops, gen):
    """K1, K2 and K4 on ragged shapes (RAGGED_*): each width as Cin and as
    Cout at strides 1-3 on a 13 x 17 plane, against the plain versions under
    the layers' tolerances (K1 and K2 as check_layer holds them; K4 against
    the plain version in float64 as check_backward_layer holds it), K1 with
    asymmetric pads and with negative pads after, and on uint8 frames of
    RAGGED_UINT8_CIN channels (its narrow kernel for Cin <= 4 and frames,
    its GEMM beyond; 4-byte copies and stores where a width is not a
    multiple of 4), K4 on uint8 frames at stride 1 and transposed at stride
    3; then K4's patch kernel
    (RAGGED_PATCH_WIDTHS: multiples of 4, half an 8-channel slab, steps
    across frames and past the plane's edge) at strides 1-3; every case run
    twice, equal bit for bit. One line a kernel, with its worst case."""
    k, (h, w), (py, px) = 5, POOL_ODD, RAGGED_PADS
    worst = {'conv2d_nhwc': None, 'conv_transpose2d_nhwc': None, 'conv2d_grad_w_nhwc': None}
    failed = []
    cases = 0

    def run(name, kernel, plain, scaled, **case):
        out_k, out_k2, out_p = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        max_abs, abs_tol, max_rel, finite = errors(out_k, out_p, scaled_floor=scaled)
        case = dict(case, max_abs_err=max_abs, abs_tol=abs_tol, max_rel_err=max_rel,
                    rerun_bitwise=bool(torch.equal(out_k, out_k2)), finite=finite)
        if (not finite or max_abs > abs_tol or max_rel > REL_TOL
                or not case['rerun_bitwise'] or out_k.shape != out_p.shape):
            failed.append(dict(case, kernel=name))
        if worst[name] is None or max_rel > worst[name]['max_rel_err']:
            worst[name] = case

    for ci, co, s in ((a, b, c) for a in RAGGED_WIDTHS for b in RAGGED_WIDTHS
                      for c in RAGGED_STRIDES):
        op = (1, 0) if s > 1 else (0, 0)
        act = (None, 'leaky_relu', 'sigmoid')[s - 1]
        x = torch.randn((RAGGED_FRAMES, h, w, ci), device=DEVICE, generator=gen)
        wt = torch.randn((k, k, ci, co), device=DEVICE, generator=gen) * 0.1
        b = torch.randn((co,), device=DEVICE, generator=gen)
        u8 = s == 1
        xs = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=DEVICE,
                           generator=gen) if u8 else x
        oh, ow = ops.conv_out_hw(h, w, k, s, py, px)
        g = torch.randn((RAGGED_FRAMES, oh, ow, co), device=DEVICE, generator=gen)
        x64 = xs.double() / 255.0 if u8 else xs.double()
        tr = s == 3
        for pads in ((py, px), ((py[0], RAGGED_NEG_PADS_AFTER[0]),
                                (px[0], RAGGED_NEG_PADS_AFTER[1]))):
            run('conv2d_nhwc', lambda: ops.conv2d_cuda(x, wt, b, s, *pads, act),
                lambda: ops.conv2d_plain(x, wt, b, s, *pads, act), False, ci=ci, co=co,
                stride=s, pads=pads, uint8=False)
            if ci in RAGGED_UINT8_CIN:
                frames = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=DEVICE,
                                       generator=gen)
                run('conv2d_nhwc', lambda: ops.conv2d_cuda(frames, wt, b, s, *pads, act),
                    lambda: ops.conv2d_plain(frames, wt, b, s, *pads, act), False, ci=ci,
                    co=co, stride=s, pads=pads, uint8=True)
        run('conv_transpose2d_nhwc',
            lambda: ops.conv_transpose2d_cuda(x, wt, b, s, py, px, op, act),
            lambda: ops.conv_transpose2d_plain(x, wt, b, s, py, px, op, act), False,
            ci=ci, co=co, stride=s, uint8=False, transposed_out=False)
        run('conv2d_grad_w_nhwc', lambda: ops.conv2d_grad_w_cuda(xs, g, k, s, py, px, tr),
            lambda: ops.conv2d_grad_w_plain(x64, g.double(), k, s, py, px, tr).float(), True,
            ci=ci, co=co, stride=s, uint8=u8, transposed_out=tr)
        cases += 1
    for (ci, co), s in ((wd, c) for wd in RAGGED_PATCH_WIDTHS for c in RAGGED_STRIDES):
        x = torch.randn((RAGGED_FRAMES, h, w, ci), device=DEVICE, generator=gen)
        oh, ow = ops.conv_out_hw(h, w, k, s, py, px)
        g = torch.randn((RAGGED_FRAMES, oh, ow, co), device=DEVICE, generator=gen)
        tr = s == 3
        if ops.gradw_plan(RAGGED_FRAMES, ci, co, k, s, (oh, ow))['kind'] != 'patch':
            raise AssertionError('ragged case %s is not the patch kernel\'s' % ((ci, co, s),))
        run('conv2d_grad_w_nhwc', lambda: ops.conv2d_grad_w_cuda(x, g, k, s, py, px, tr),
            lambda: ops.conv2d_grad_w_plain(x.double(), g.double(), k, s, py, px, tr).float(),
            True, ci=ci, co=co, stride=s, uint8=False, transposed_out=tr, patch=True)
        cases += 1
    for name, case in worst.items():
        emit(dict(phase='ragged_check', kernel=name, cases=cases, widths=RAGGED_WIDTHS,
                  patch_widths=RAGGED_PATCH_WIDTHS, strides=RAGGED_STRIDES, plane=POOL_ODD,
                  frames=RAGGED_FRAMES, pads=RAGGED_PADS, rel_tol=REL_TOL, worst=case,
                  failed=[f for f in failed if f['kernel'] == name]))
    if failed:
        raise AssertionError('K1 / K2 / K4 disagree on ragged shapes: %s' % failed[:5])


def conv_summary(checks):
    """K1's, K2's and K4's times beside cuDNN's, summed per arch and stride
    over the conv checks (K2 forward and as grad-x, K4 as grad-w of convs
    (row 2) and of transposed convs (row 4), K1 forward and as grad-x)."""
    groups = {}
    for r in checks:
        if r.get('phase') not in ('kernel_check', 'backward_check') or \
                r['kernel'] not in ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'conv2d_grad_w_nhwc'):
            continue
        arch = 'pool' if r['layer'].startswith('pool.') else 'default'
        short = {'conv2d_nhwc': 'K1', 'conv_transpose2d_nhwc': 'K2',
                 'conv2d_grad_w_nhwc': 'K4'}[r['kernel']]
        use = 'forward' if r['phase'] == 'kernel_check' else r['grad'] + (
            '_row4' if '.convt_' in '.' + r['layer'] else '_row2') * (short == 'K4')
        key = '%s %s %s stride %d' % (arch, short, use, r['stride'])
        g = groups.setdefault(key, dict(layers=[], ms=0.0, library_ms=0.0, bound_ms=0.0,
                                        worst_layer_vs_library=0.0))
        g['layers'].append(r['layer'])
        g['ms'] += r['ms']
        g['library_ms'] += r['library_ms']
        g['bound_ms'] += r['bound_ms']
        g['worst_layer_vs_library'] = max(g['worst_layer_vs_library'], r['vs_library'])
    for g in groups.values():
        g['vs_library'] = g['ms'] / g['library_ms']
        g['share_of_bound'] = g['bound_ms'] / g['ms']
    emit(dict(phase='conv_summary', groups=groups))
    return groups


def kernel_ptxas(build, phase, libs, bases):
    """Registers and spills of the instances of the device functions
    ``bases`` in the libraries ``libs`` from nvcc's -Xptxas -v, as a
    ``phase`` line (raises on a spill; nothing to read when the libraries
    were built before this process)."""
    import re
    kernels = []
    built = [lib for lib in libs if lib in build.ptxas_info()]
    for lib in built:
        cur = None
        for line in build.ptxas_info().get(lib, []):
            m = re.search(r'Function properties for (\S+)', line)
            if m:
                name = m.group(1)
                base = next((k for k in bases if k in name), None)
                cur = None
                if base:
                    args = re.findall(r'L([ib])(\d+)E', name)
                    cur = dict(kernel='%s<%s>' % (base, ','.join(v for _, v in args)))
                    kernels.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
            if m:
                cur['spill_stores'], cur['spill_loads'] = int(m.group(1)), int(m.group(2))
            m = re.search(r'Used (\d+) registers', line)
            if m:
                cur['registers'] = int(m.group(1))
                sm = re.search(r'(\d+) bytes smem', line)
                cur['static_smem'] = int(sm.group(1)) if sm else 0
    emit(dict(phase=phase, libraries=built, kernels=kernels))
    spills = [k for k in kernels if k.get('spill_stores') or k.get('spill_loads')]
    if (built and not kernels) or spills:
        raise AssertionError('instances of %s spill or were not reported: %s'
                             % (', '.join(bases), spills or kernels))


def conv_ptxas(build):
    """K1's, K2's and K4's instances (``kernel_ptxas``; K2's names before
    K1's, which they contain)."""
    kernel_ptxas(build, 'conv_ptxas',
                 ('conv2d_nhwc', 'conv_transpose2d_nhwc', 'conv2d_grad_w_nhwc'),
                 ('tconv_gemm_kernel', 'tconv_narrow_kernel', 'conv_gemm_kernel',
                  'conv_narrow_kernel', 'gradw_patch_kernel', 'gradw_gather_kernel',
                  'gradw_reduce_kernel'))


def lstm_optim_ptxas(build):
    """K6's kernel and K23's and K24's (``kernel_ptxas``)."""
    kernel_ptxas(build, 'lstm_optim_ptxas', ('amsgrad_step', 'lstm_forward'),
                 ('amsgrad_kernel', 'lstm_project_kernel', 'lstm_chain_kernel',
                  'lstm_bptt_cluster_kernel', 'lstm_bptt_kernel', 'lstm_dw_kernel',
                  'lstm_dx_kernel'))


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
    every parameter of the full-width model against the plain recursion
    (``amsgrad_cuda_``, which builds its table on every call); then three
    ``AMSGrad.step()`` calls over copies of the same parameters against the
    plain recursion, one parameter's gradient dropped at the second (it
    keeps its step count: mixed counts at the third) and a
    ``load_state_dict`` of a deep copy of the state before the third (every
    state pointer changes, so a stale table would fail). Times
    ``AMSGrad.step()`` (``ms``: the main path's call, its table kept),
    ``amsgrad_cuda_``, the plain recursion and torch's fused
    ``Adam(amsgrad=True)`` (the yardstick), and reads K6's device time from
    the profiler and the step's host time from the host clock."""
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

    # the optimizer: its kept table across a dropped gradient and a new state,
    # with gradients from a generator of its own (the later checks keep the
    # inputs they drew before this part was added)
    seq_gen = torch.Generator(device=dev)
    seq_gen.manual_seed(SEED + 18)
    live = [torch.nn.Parameter(p.clone()) for p in params]
    opt = optim.AMSGrad(live, **args)
    ref = [p.clone() for p in params]
    ref_state = [[torch.zeros_like(p) for p in params] for _ in range(3)]
    ref_steps = [0] * len(params)
    seq_step_errs = []
    for i in range(3):
        g = [torch.randn(p.shape, device=dev, generator=seq_gen) * 1e-3 for p in params]
        on = [j for j in range(len(params)) if not (i == 1 and j == AMSGRAD_DROPPED)]
        for j, p in enumerate(live):
            p.grad = g[j] if j in on else None
        if i == 2:
            opt.load_state_dict(copy.deepcopy(opt.state_dict()))
        before = [r.clone() for r in ref]
        opt.step()
        for j in on:
            ref_steps[j] += 1
        optim.amsgrad_plain_([ref[j] for j in on], [g[j] for j in on],
                             *([col[j] for j in on] for col in ref_state),
                             [ref_steps[j] for j in on], **args)
        torch.cuda.synchronize()
        seq_step_errs.append(rel([p.detach() for p in live], ref,
                                 [r - b for r, b in zip(ref, before)]))
    got = [[opt.state[p][k] for p in live] for k in ('exp_avg', 'exp_avg_sq', 'max_exp_avg_sq')]
    seq_state_err = max(rel(a, b, b) for a, b in zip(got, ref_state))
    seq_steps = [opt.state[p]['step'] for p in live]
    steps_ok = seq_steps == ref_steps
    finite = finite and all(bool(torch.isfinite(p).all().item()) for p in live)

    pk, mk, vk, xk = state()

    def function():
        optim.amsgrad_cuda_(pk, grads, mk, vk, xk, steps, **args)

    def plain():
        optim.amsgrad_plain_(pk, grads, mk, vk, xk, steps, **args)
    for p, gr in zip(live, grads):
        p.grad = gr
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, gr in zip(lib_params, grads):
        p.grad = gr
    adam = torch.optim.Adam(lib_params, lr=LEARNING_RATE, weight_decay=L2_REG,
                            amsgrad=True, fused=True)
    n = sum(p.numel() for p in params)
    nbytes = 4 * n * (5 + 4)   # p, g, m, v, vmax in; p, m, v, vmax out
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 16 * n / PEAK_F32_FLOPS * 1e3
    ms = median_ms(opt.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AMSGRAD_HOST_CALLS):
        opt.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / AMSGRAD_HOST_CALLS
    torch.cuda.synchronize()
    device = profile_steps(opt.step, groups={'amsgrad_step': ('amsgrad_kernel',)})
    device_launches = device['launches_per_step_by_kernel']
    rec = dict(phase='optimizer_check', kernel='amsgrad_step', tensors=len(params),
               params=n, step_rel_err=step_err, step_rel_tol=STEP_REL_TOL,
               state_rel_err=state_err, state_rel_tol=STATE_REL_TOL, max_abs_err=max_abs,
               optimizer_step_rel_errs=seq_step_errs, optimizer_state_rel_err=seq_state_err,
               optimizer_steps=seq_steps, dropped_at_step_2=AMSGRAD_DROPPED,
               mbytes=nbytes / 1e6, ms=ms, host_ms=host_ms,
               device_ms=device['ms_per_step_by_kernel']['amsgrad_step']
               if device_launches['amsgrad_step'] == 1 else None,
               device_launches=device_launches,
               function_ms=median_ms(function), plain_ms=median_ms(plain),
               library_ms=median_ms(adam.step), bound_ms=max(t_ops, t_bytes),
               t_ops_ms=t_ops, t_bytes_ms=t_bytes,
               bound_by='operations' if t_ops >= t_bytes else 'bytes')
    rec.update(vs_library=ms / rec['library_ms'],
               device_share_of_bound=rec['device_ms'] and rec['bound_ms'] / rec['device_ms'])
    emit(rec)
    if not finite or not steps_ok or max([step_err] + seq_step_errs) > STEP_REL_TOL or \
            max(state_err, seq_state_err) > STATE_REL_TOL:
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

    def __init__(self, n, seed, n_labels=0, brightness=0):
        rs = np.random.RandomState(seed)
        tiles = (rs.randint(0, 100, (n, TRIAL, 8, 8, IMG[0])) + brightness).astype(np.uint8)
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
        # the session ``export_latents`` names its pickle after
        self.datasets = [types.SimpleNamespace(
            lab='smoke', expt='chip', animal='mouse', session='session-0', n_trials=n,
            batch_idxs=self.idxs)]
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


def plain_loss(model, ops, losses, batch, train=False, replay=None):
    """The AE's loss through the plain versions only (cuDNN autograd)."""
    y, _ = plain_forward(model, ops, batch['images'], train=train, replay=replay)
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

    # one step's gradients: kernels vs the plain path on the card, in
    # float32 as it runs (``unreplayed``) and, as msps_step, in float64 with
    # the kernel path's leaky-ReLU signs replayed, the replayed signs held to
    # the float64 path's own (SIGN_FLIPS_MAX, SIGN_FLIP_TOL)
    images = np.zeros((BUCKET,) + source.trials[0].shape[1:], np.uint8)
    images[:TRIAL] = source.trials[0]
    frame_mask = np.zeros(BUCKET, np.float32)
    frame_mask[:TRIAL] = 1.0
    batch = {'images': torch.from_numpy(images).to(DEVICE),
             'frame_mask': torch.from_numpy(frame_mask).to(DEVICE)}
    model.zero_grad(set_to_none=True)
    with recorded_decisions(model, ops) as decisions:
        model.loss_fn(batch)[0].backward()
    grads_k = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    def plain_grads(replay, dtype=torch.float32):
        twin = port.aes.AE(hp).to(DEVICE, dtype)
        twin.load_state_dict(model.state_dict())
        data = batch if dtype == torch.float32 else dict(
            images=batch['images'].to(dtype) / 255.0, frame_mask=batch['frame_mask'].to(dtype))
        plain_loss(twin, ops, losses, data, replay=replay).backward()
        return {k: p.grad for k, p in twin.named_parameters()}

    def rel_errs(got, ref):
        return {k: (got[k].double() - ref[k].double()).abs().max().item()
                / max(ref[k].abs().max().item(), 1e-30) for k in ref}
    unreplayed = rel_errs(grads_k, plain_grads(None))
    replay = Replay(decisions)
    grad_errs = rel_errs(grads_k, plain_grads(replay, torch.float64))
    del decisions
    flips = replay.flips
    n_flips = sum(f['flips'] for f in flips)
    far = [i for i, f in enumerate(flips)
           if f['max_abs_at_flips'] > SIGN_FLIP_TOL * max(1.0, f['max_abs'])]
    worst = max(grad_errs, key=grad_errs.get)
    worst_unreplayed = max(unreplayed, key=unreplayed.get)
    emit(dict(phase='train_grads', frames=BUCKET, reference='plain_float64',
              rel_tol=GRAD_REL_TOL, max_rel_err=grad_errs[worst], worst=worst,
              unreplayed_max_rel_err=unreplayed[worst_unreplayed],
              unreplayed_worst=worst_unreplayed, sign_flips=n_flips,
              sign_flips_max=SIGN_FLIPS_MAX, sign_flip_tol=SIGN_FLIP_TOL,
              sign_flip_layers=[dict(f, layer=i) for i, f in enumerate(flips) if f['flips']],
              rel_err=grad_errs, unreplayed_rel_err=unreplayed))
    if max(grad_errs[worst], unreplayed[worst_unreplayed]) > GRAD_REL_TOL:
        raise AssertionError('card gradients disagree with the plain path: %s=%.3g, '
                             'unreplayed float32 %s=%.3g'
                             % (worst, grad_errs[worst], worst_unreplayed,
                                unreplayed[worst_unreplayed]))
    if n_flips > SIGN_FLIPS_MAX or far:
        raise AssertionError('AE: %d replayed leaky-ReLU signs differ from the plain path\'s '
                             'own (at most %d), at layers %s beyond %.0e of 0'
                             % (n_flips, SIGN_FLIPS_MAX, far, SIGN_FLIP_TOL))

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
# (K2's function names contain K1's: K2's entries come first)
KERNEL_OF = tuple(
    ('%s<%d, true,' % (fn, k), label) for fn, label in (
        ('arhmm_log_likes_kernel', 'K8 arhmm_log_likes (robust)'),
        ('forward_backward_kernel', 'K9 hmm_forward_backward (time-varying)'),
        ('forward_kernel', 'K9 hmm_forward_backward (forward alone, time-varying)'),
        ('viterbi_kernel', 'K10 hmm_viterbi (time-varying)'))
    for k in (8, 16, 32, 64)) + (
             ('tconv_gemm_kernel', 'K2 conv_transpose2d_nhwc'),
             ('tconv_narrow_kernel', 'K2 conv_transpose2d_nhwc'),
             ('conv_gemm_kernel', 'K1 conv2d_nhwc'), ('conv_narrow_kernel', 'K1 conv2d_nhwc'),
             ('tconv_smallcout_kernel', 'K3 conv_transpose2d_smallcout_sigmoid'),
             ('gradw_patch_kernel', 'K4 conv2d_grad_w_nhwc'),
             ('gradw_gather_kernel', 'K4 conv2d_grad_w_nhwc'),
             ('gradw_reduce_kernel', 'K4 conv2d_grad_w_nhwc'),
             ('mse_partial_kernel', 'K5 masked_mse'), ('mse_finish_kernel', 'K5 masked_mse'),
             ('mse_grad_kernel', 'K5 masked_mse'),
             ('amsgrad_kernel', 'K6 amsgrad_step'), ('dkl_', 'K7 decomposed_kl'),
             ('arhmm_log_likes_kernel', 'K8 arhmm_log_likes'),
             ('forward_backward_kernel', 'K9 hmm_forward_backward'),
             ('forward_kernel', 'K9 hmm_forward_backward (forward alone)'),
             ('viterbi_kernel', 'K10 hmm_viterbi'), ('solve_small_kernel', 'K11 solve_small'),
             ('nll_frames_kernel', 'K12 gaussian_nll'),
             ('nll_finish_kernel', 'K12 gaussian_nll'), ('nll_grad_kernel', 'K12 gaussian_nll'),
             ('LogSum', 'K13 hmm_scan'), ('posterior_kernel', 'K13 hmm_scan'),
             ('sum_parts_kernel', 'K13 hmm_scan'), ('MaxPlus', 'K14 hmm_viterbi_scan'),
             ('compose_chunks_kernel', 'K14/K15 backtrace'),
             ('chunk_bounds_kernel', 'K14/K15 backtrace'),
             ('chunk_paths_kernel', 'K14/K15 backtrace'),
             ('draw_maps_kernel', 'K15 hmm_sample_posterior'),
             ('sample_states_kernel', 'K16 hmm_sample_states'),
             ('imm_filter_kernel', 'K17 imm_filter'), ('rts_smoother_kernel', 'K18 rts_smoother'),
             ('filter_compose_kernel', 'K19/K36 kalman filter (compose)'),
             ('filter_chain_kernel', 'K19/K36/K37 kalman filter (chain)'),
             ('filter_run_kernel', 'K19/K21/K37 kalman filter (run)'),
             ('smoother_compose_kernel', 'K20/K38 kalman smoother (compose)'),
             ('smoother_chain_kernel', 'K20/K38/K39 kalman smoother (chain)'),
             ('smoother_run_kernel', 'K20/K39 kalman smoother (run)'),
             ('smoother_sequential_kernel', 'K22 kalman_smoother'),
             ('lstm_project_kernel', 'K23 lstm_forward'),
             ('lstm_chain_kernel', 'K23 lstm_forward'),
             ('lstm_bptt_kernel', 'K24 lstm_backward'),
             ('lstm_bptt_cluster_kernel', 'K24 lstm_backward'),
             ('lstm_dw_kernel', 'K24 lstm_backward'),
             ('lstm_dx_kernel', 'K24 lstm_backward'),
             ('triplet_fwd_kernel', 'K25 triplet_loss'),
             ('triplet_bwd_kernel', 'K26 triplet_loss_grad'),
             ('maxpool_fwd_kernel', 'K27 max_pool2d'),
             ('maxpool_grad_kernel', 'K27 max_pool2d_grad'),
             ('unpool_scatter_kernel', 'K28 max_unpool2d'),
             ('unpool_gather_kernel', 'K28 max_unpool2d_grad'),
             ('bn_train_kernel', 'K29 batch_norm (train)'),
             ('bn_apply_kernel', 'K29 batch_norm (apply)'),
             ('bn_grad_', 'K30 batch_norm_backward'),
             ('mstep_stats_', 'K31 arhmm_mstep (statistics)'),
             ('mstep_cov_', 'K31 arhmm_mstep (covariance)'),
             ('rec_prep_kernel', 'K40 arhmm_recurrent_mstep (prep)'),
             ('rec_step_kernel', 'K40 arhmm_recurrent_mstep (step)'),
             ('rec_update_kernel', 'K40 arhmm_recurrent_mstep (update)'),
             ('nu_pass_kernel', 'K41 arhmm_nu_mstep'), ('nu_finish_kernel', 'K41 arhmm_nu_mstep'))


def profile_steps(fn, steps=5, warmup=2, phase='train_profile', groups=None, **labels):
    """Where a train step's time goes: ``torch.profiler`` over ``steps``
    steps after ``warmup``; device time and launches a step per kernel
    function, grouped by port kernel (everything else is PyTorch's: the FC
    matmuls, activation derivatives, bias sums, copies) or by ``groups``
    (label -> substrings of device kernel names; ``other`` for the rest),
    and the device's busy and idle share of the host-clock window. The
    profiler has been seen to drop kernels late in a long run, so a caller
    that knows a step's launches can tell a complete split from a partial
    one."""
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
        # user annotations (``Optimizer.step#...``) span kernels already counted
        if e.device_type != DeviceType.CUDA or getattr(e, 'is_user_annotation', False):
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
    if groups:
        ms = dict.fromkeys(list(groups) + ['other'], 0.0)

        def group_of(name):
            return next((g for g, keys in groups.items() if any(k in name for k in keys)),
                        'other')
    else:
        ms = {}

        def group_of(name):
            return next((g for key, g in KERNEL_OF if key in name), 'pytorch')
    launches = dict.fromkeys(ms, 0.0)
    for name, us in by_name.items():
        group = group_of(name)
        ms[group] = ms.get(group, 0.0) + us / steps / 1e3
        launches[group] = launches.get(group, 0.0) + counts[name] / steps
    top = sorted(by_name, key=by_name.get, reverse=True)[:12]
    return dict(
        phase=phase, steps=steps, **dict(dict(frames=TRIAL, bucket=BUCKET), **labels),
        device_events=len(spans), wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=busy_us / steps / 1e3,
        device_idle_share=1.0 - busy_us / wall_us if spans else None,
        ms_per_step_by_kernel=ms, launches_per_step_by_kernel=launches,
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


# --------------------------------------------------------------- MSPS-VAE


def triplet_ops(n_rows, n_sessions, m, d, backward):
    """Operations of one triplet-loss call at these shapes (sqrt and divide
    as one): a triplet slot forms two distances (3d + 1 each) and its hinge,
    a pull slot one distance; the backward recomputes them and adds 2d a
    row's term (the sums of the forward's reduction are counted too)."""
    pat = {2: (2, 2), 3: (6, 6), 4: (12, 12)}[n_sessions]
    fwd = m * (pat[0] * (2 * (3 * d + 1) + 4) + pat[1] * (3 * d + 3)) + 2 * m * sum(pat)
    if not backward:
        return fwd
    return fwd + m * (3 * pat[0] * 4 * d + 2 * pat[1] * 2 * d) + n_rows * d


def check_triplet(port):
    """K25 / K26 at the MSPS-VAE step's shape (two sessions of 192 rows, the
    3 background columns of (384, 14) means: a row stride of 14) and at 3 and
    4 sessions, with an all-ones mask and with TRIPLET_PAD padded rows per
    segment, against the plain versions on the same permutations (float32
    and float64). No PyTorch call computes the loss: the yardstick is a
    composition of ``F.triplet_margin_loss`` and ``F.pairwise_distance`` on
    pre-gathered chunks (unmasked), timed forward and backward. Its inputs
    come from a generator of its own, so the other checks keep theirs."""
    losses = port.losses
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 11)
    rows = []
    for n in TRIPLET_SESSIONS:
        seg_lens = (BUCKET,) * n
        N = BUCKET * n
        pat, n_chunks, m = losses._triplet_pattern(seg_lens)
        mu = torch.randn((N, N_MSPS_LATENTS), device=DEVICE, generator=gen)
        z = mu[:, N_LABELS:N_LABELS + N_BACKGROUND]
        perms = [torch.randperm(BUCKET, generator=gen, device=DEVICE) for _ in seg_lens]
        perm = torch.cat(perms).to(torch.int32)
        up = torch.tensor([1.7], device=DEVICE)
        pad = torch.ones(N, device=DEVICE)
        pad.view(n, BUCKET)[:, TRIAL:] = 0.0
        for mask_name, mask in (('ones', torch.ones(N, device=DEVICE)), ('pad', pad)):
            def fwd():
                return losses.triplet_loss_cuda(z, seg_lens, perm, 1.0, mask)
            loss_k, den = fwd()

            def bwd():
                return losses.triplet_loss_grad_cuda(z, seg_lens, perm, 1.0, mask, den, up)
            dz_k = bwd()

            def plain_fwd(dtype=torch.float32):
                return losses.triplet_loss_plain(z.to(dtype), seg_lens, perms, 1.0,
                                                 mask.to(dtype))

            def plain_bwd(dtype=torch.float32):
                return losses.triplet_loss_grad_plain(z.to(dtype), seg_lens, perms, 1.0,
                                                      mask.to(dtype), up.to(dtype))
            loss_p, dz_p = plain_fwd(), plain_bwd()
            loss_64, dz_64 = plain_fwd(torch.float64), plain_bwd(torch.float64)
            torch.cuda.synchronize()
            scale = dz_p.abs().max().item()
            err = dict(
                loss=abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
                loss_f64=abs(loss_k.item() - loss_64.item()) / abs(loss_64.item()),
                plain_loss_f64=abs(loss_p.item() - loss_64.item()) / abs(loss_64.item()),
                dz=(dz_k - dz_p).abs().max().item() / scale,
                dz_f64=(dz_k.double() - dz_64).abs().max().item() / scale,
                plain_dz_f64=(dz_p.double() - dz_64).abs().max().item() / scale)
            finite = bool(torch.isfinite(loss_k).item() and torch.isfinite(dz_k).all().item())
            ok = finite and max(err['loss'], err['loss_f64']) <= LOSS_REL_TOL and \
                max(err['dz'], err['dz_f64']) <= TRIPLET_GRAD_REL_TOL

            # the composed yardstick on the same chunks, unmasked
            chunk = [[z.detach()[off + p[i::n_chunks][:m]] for i in range(n_chunks)]
                     for off, p in zip(range(0, N, BUCKET), perms)]
            leaves = [[c.clone().requires_grad_(True) for c in ch] for ch in chunk]

            def composed():
                loss = sum(F.triplet_margin_loss(leaves[a][i], leaves[a][j], leaves[b][k],
                                                 margin=1.0)
                           for a, i, j, b, k in pat['triplets'])
                loss = loss + sum(F.pairwise_distance(leaves[s][i], leaves[s][j]).mean()
                                  for s, i, j in pat['pulls'])
                (loss / pat['n_terms']).backward()
            plain_ms = [median_ms(f, samples=3, inner=2, warmup=1)
                        for f in (plain_fwd, plain_bwd)]
            composed_ms = median_ms(composed)
            nbytes_in = 4 * (N * N_BACKGROUND + 2 * N) + 4 * (5 * len(pat['triplets']) +
                                                            3 * len(pat['pulls']))
            n_terms = len(pat['triplets']) + len(pat['pulls'])
            layer = '%d-sessions-%s' % (n, mask_name)
            common = dict(phase='triplet_check', layer=layer, frames=N, seg_lens=list(seg_lens),
                          latents=N_BACKGROUND, m=m, row_stride=z.stride(0), errors=err,
                          loss=loss_k.item(), plain_loss=loss_p.item(),
                          loss_rel_tol=LOSS_REL_TOL, grad_rel_tol=TRIPLET_GRAD_REL_TOL,
                          finite=finite, library_ms=None, composed_ms=composed_ms,
                          composed='F.triplet_margin_loss + F.pairwise_distance on '
                                   'pre-gathered chunks, unmasked, fwd + bwd')
            fwd_rec = dict(common, kernel='triplet_loss',
                           max_abs_err=abs(loss_k.item() - loss_p.item()),
                           ms=median_ms(fwd), plain_ms=plain_ms[0],
                           **bound(triplet_ops(N, n, m, N_BACKGROUND, False),
                                   nbytes_in + 4 * (1 + n_terms)))
            bwd_rec = dict(common, kernel='triplet_loss_grad',
                           max_abs_err=(dz_k - dz_p).abs().max().item(),
                           ms=median_ms(bwd), plain_ms=plain_ms[1],
                           **bound(triplet_ops(N, n, m, N_BACKGROUND, True),
                                   nbytes_in + 4 * (n_terms + 1) + 4 * N * N_BACKGROUND))
            emit(fwd_rec)
            emit(bwd_rec)
            rows += [fwd_rec, bwd_rec]
            if not ok:
                raise AssertionError('K25 / K26 disagree with their plain versions at %s: %s'
                                     % (layer, err))
    return rows


class MultiSessionSource:
    """Two in-memory sessions (``TrialSource``s of ``n`` trials each, the
    second MSPS_BRIGHTNESS brighter) with the multi-session generator's
    interface: a train batch is a list of one trial from each session (both
    sessions have as many train trials); val and test batches are single
    trials, the sessions in a shuffled order."""

    n_datasets = 2
    n_sessions_per_batch = 2

    def __init__(self, n, seed, n_labels):
        self.sessions = [TrialSource(n, seed + i, n_labels, brightness=MSPS_BRIGHTNESS * i)
                         for i in range(2)]
        tot = {k: sum(s.n_tot_batches[k] for s in self.sessions) for k in ('val', 'test')}
        self.n_tot_batches = dict(tot, train=self.sessions[0].n_tot_batches['train'])
        self.trials = self.sessions[0].trials
        self.reset_iterators('all')

    def reset_iterators(self, dtype):
        for s in self.sessions:
            s.reset_iterators(dtype)
        for dt in (('val', 'test') if dtype == 'all' else [dtype]):
            if dt != 'train':
                order = [i for i, s in enumerate(self.sessions)
                         for _ in range(s.n_tot_batches[dt])]
                setattr(self, '_sessions_' + dt, list(np.random.permutation(order)))

    def next_batch(self, dtype):
        if dtype == 'train':
            return [s.next_batch(dtype)[0] for s in self.sessions], [0, 1]
        i = int(getattr(self, '_sessions_' + dtype).pop(0))
        return self.sessions[i].next_batch(dtype)[0], i


def fit_msps(port, hp, tmp, source):
    """Main path: ``fit`` of the MSPS-VAE on two sessions on the card (an
    eval epoch, then two train epochs); every logged number finite, the
    triplet term above 0 in the train rows and 0 in the val and test rows
    (single-session batches), and K1-K7, K25 and K26 launched inside it."""
    ops = port.ops
    hp = dict(hp, model_class='msps-vae', n_ae_latents=N_MSPS_LATENTS,
              learning_rate=LEARNING_RATE, l2_reg=L2_REG, rng_seed_train=SEED,
              max_n_epochs=VAE_FIT_EPOCHS, min_n_epochs=1, val_check_interval=1,
              enable_early_stop=False, early_stop_history=10, export_latents=False,
              rng_seed_data=SEED, device=DEVICE, experiment_name='msps-vae', **MSPS_CLASS)
    exp = port.experiment.Experiment('msps-vae', tmp)
    hp['expt_dir'] = os.path.join(tmp, 'msps-vae')
    vdir = os.path.join(hp['expt_dir'], 'version_%d' % exp.version)
    model = port.vaes.MSPSVAE(hp)

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
    triplet_ok = min(logged['tr_loss_triplet']) > 0 and \
        max(logged['val_loss_triplet'] + logged['test_loss_triplet']) == 0
    steps = VAE_FIT_EPOCHS * source.n_tot_batches['train']
    emit(dict(phase='fit', model_class='msps-vae', epochs=list(range(VAE_FIT_EPOCHS + 1)),
              sessions=2, train_steps=steps, frames_per_step=2 * BUCKET, seconds=fit_s,
              launches=launches, finite=finite, triplet_ok=triplet_ok,
              losses={k: v for k, v in logged.items()
                      if 'loss' in k or 'r2' in k or 'delta' in k}))
    missing = [k for k in MSPS_KERNELS if launches[k] == 0]
    if missing or not finite or not triplet_ok:
        raise AssertionError('the MSPS-VAE fit never launched %s, logged non-finite numbers '
                             'or a wrong triplet term' % missing)
    return dict(hp, version=exp.version), model, vdir, best, launches


def msps_batch(source):
    """The step's batch: trial 0 of each session in the 192-frame bucket,
    concatenated (host arrays)."""
    parts = []
    for s in source.sessions:
        part = {'images': np.zeros((BUCKET,) + s.trials[0].shape[1:], np.uint8),
                'labels': np.zeros((BUCKET, N_LABELS), np.float32),
                'frame_mask': np.zeros(BUCKET, np.float32)}
        part['images'][:TRIAL], part['labels'][:TRIAL] = s.trials[0], s.labels[0]
        part['frame_mask'][:TRIAL] = 1.0
        parts.append(part)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def plain_msps_loss(model, ops, losses, batch, eps, perms, kw, seg_lens, replay=None):
    """The MSPS-VAE's loss (JAX: vaes.py:424) through the plain versions
    only, from given eps and permutations; ``replay`` as for
    ``plain_layer``."""
    k, k_bg = model.n_labels, model.n_labels + model.n_background
    if replay is not None and not isinstance(replay, Replay):
        replay = list(replay)
    flat = plain_features(model, ops, batch['images'], replay=replay)
    mu_ff, logvar = model.encoding.FF(flat), model.encoding.logvar(flat)
    z_s = model.encoding.A(mu_ff)
    mu = torch.cat([z_s, model.encoding.C(mu_ff), model.encoding.B(mu_ff)], dim=1)
    z = eps * torch.exp(logvar) + mu
    fm = batch['frame_mask']

    def ll(pred, target):
        n = pred[0].numel()
        return -0.5 * losses.LN2PI * n - 0.5 * n * losses.mse_plain(pred, target, None, fm)[0]
    mi, tc, dwkl = losses.decomposed_kl_plain(z[:, k_bg:], mu[:, k_bg:], logvar[:, k_bg:], fm)
    return -ll(plain_decode(model, ops, z, replay=replay), batch['images']) \
        - kw['alpha'] * ll(model.encoding.D(z_s), batch['labels']) \
        + losses.kl_div_to_std_normal(mu[:, :k], logvar[:, :k], fm) \
        + kw['kl'] * mi + kw['beta'] * tc + kw['kl'] * dwkl \
        + kw['delta'] * losses.triplet_loss_plain(mu[:, k:k_bg], seg_lens, perms, 1.0, fm)


def msps_step(port, hp, model, source):
    """An MSPS-VAE train step on the card (384 frames: two sessions' trials
    in their buckets) at the annealed loss weights: its gradients against the
    plain path's with the same eps and permutations (the generator draws the
    eps, then one permutation a session), run in float64 (the plain path in
    float32 drifts from it as cuDNN's float32 algorithms do, its distance is
    reported beside the kernel path's), and the kernel path's leaky-ReLU
    signs replayed (``recorded_decisions``: a pre-activation within float32
    rounding of 0 sends its gradient down another branch, ~2% of the
    2 x 2 -> 8 x 8 layer's weight gradient; the distance from the float32
    plain path without the replay is reported beside it). The replayed
    signs are held to the float64 path's own: at most SIGN_FLIPS_MAX may
    differ, each at a pre-activation within SIGN_FLIP_TOL of 0 (relative
    to max(1, its layer's largest)), so a kernel fault that flips signs
    away from the kink fails here. Then its time beside the plain step's
    (cuDNN autograd, torch's fused AMSGrad), and its profile."""
    ops, losses = port.ops, port.losses
    host_batch = msps_batch(source)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host_batch.items()}
    seg_lens = (BUCKET, BUCKET)
    kw = model.loss_kwargs(len(model.beta_vals) - 1)   # alpha 1000, beta 5, kl 1, delta 50

    def generator():
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED)
        return gen

    def draws(gen):
        eps = torch.randn((2 * BUCKET, N_MSPS_LATENTS), generator=gen, device=DEVICE)
        return eps, [torch.randperm(n, generator=gen, device=DEVICE) for n in seg_lens]
    model.zero_grad(set_to_none=True)
    with recorded_decisions(model, ops) as decisions:
        loss_k = model.loss_fn(batch, generator=generator(), seg_lens=seg_lens, **kw)[0]
        loss_k.backward()
    grads_k = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    def plain_grads(replay, dtype=torch.float32):
        """The plain path's loss and gradients, on a copy of the model in
        ``dtype`` (frames as x / 255 in it)."""
        twin = port.vaes.MSPSVAE(hp).to(DEVICE, dtype)
        twin.load_state_dict(model.state_dict())
        data = batch if dtype == torch.float32 else dict(
            images=batch['images'].to(dtype) / 255.0, labels=batch['labels'].to(dtype),
            frame_mask=batch['frame_mask'].to(dtype))
        eps, perms = draws(generator())
        loss = plain_msps_loss(twin, ops, losses, data, eps.to(dtype), perms, kw, seg_lens,
                               replay)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in twin.named_parameters()}

    def rel_errs(got, ref):
        return {k: (got[k].double() - ref[k].double()).abs().max().item()
                / max(ref[k].abs().max().item(), 1e-30) for k in ref}
    unreplayed = rel_errs(grads_k, plain_grads(None)[1])
    grads_32 = plain_grads(Replay(decisions))[1]
    replay = Replay(decisions)
    loss_p, grads_64 = plain_grads(replay, torch.float64)
    del decisions
    grad_errs, plain_errs = rel_errs(grads_k, grads_64), rel_errs(grads_32, grads_64)
    vs_plain_f32 = rel_errs(grads_k, grads_32)
    flips = replay.flips
    n_flips = sum(f['flips'] for f in flips)
    far = [i for i, f in enumerate(flips)
           if f['max_abs_at_flips'] > SIGN_FLIP_TOL * max(1.0, f['max_abs'])]
    worst = max(grad_errs, key=grad_errs.get)
    worst_plain = max(plain_errs, key=plain_errs.get)
    worst_vs_f32 = max(vs_plain_f32, key=vs_plain_f32.get)
    worst_unreplayed = max(unreplayed, key=unreplayed.get)
    loss_err = abs(loss_k.item() - loss_p) / abs(loss_p)
    emit(dict(phase='msps_grads', frames=2 * BUCKET, seg_lens=list(seg_lens), loss_weights=kw,
              reference='plain_float64', loss=loss_k.item(), plain_loss=loss_p,
              loss_rel_err=loss_err, rel_tol=GRAD_REL_TOL, max_rel_err=grad_errs[worst],
              worst=worst, plain_f32_max_rel_err=plain_errs[worst_plain],
              plain_f32_worst=worst_plain,
              kernel_vs_plain_f32_max_rel_err=vs_plain_f32[worst_vs_f32],
              kernel_vs_plain_f32_worst=worst_vs_f32,
              unreplayed_max_rel_err=unreplayed[worst_unreplayed],
              unreplayed_worst=worst_unreplayed, sign_flips=n_flips,
              sign_flips_max=SIGN_FLIPS_MAX, sign_flip_tol=SIGN_FLIP_TOL,
              sign_flip_layers=[dict(f, layer=i) for i, f in enumerate(flips) if f['flips']],
              rel_err=grad_errs, plain_f32_rel_err=plain_errs))
    if grad_errs[worst] > GRAD_REL_TOL or loss_err > GRAD_REL_TOL:
        raise AssertionError('MSPS-VAE gradients on the card disagree with the plain '
                             'path: %s=%.3g, loss %.3g' % (worst, grad_errs[worst], loss_err))
    if n_flips > SIGN_FLIPS_MAX or far:
        raise AssertionError('MSPS-VAE: %d replayed leaky-ReLU signs differ from the plain '
                             'path\'s own (at most %d), at layers %s beyond %.0e of 0'
                             % (n_flips, SIGN_FLIPS_MAX, far, SIGN_FLIP_TOL))

    opt = port.optim.AMSGrad(model.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG)
    twin = port.vaes.MSPSVAE(hp).to(DEVICE)
    twin.load_state_dict(model.state_dict())
    adam = torch.optim.Adam(twin.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG,
                            amsgrad=True, fused=True)
    gen = generator()

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss_fn(batch, generator=gen, seg_lens=seg_lens, **kw)[0].backward()
        opt.step()

    def plain_step():
        adam.zero_grad(set_to_none=True)
        plain_msps_loss(twin, ops, losses, batch, *draws(gen), kw, seg_lens).backward()
        adam.step()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    step()
    torch.cuda.synchronize()
    per_step = dict(ops.LAUNCHES)
    ms, plain_ms = request_ms(step), request_ms(plain_step)
    rec = dict(phase='msps_step', frames=2 * TRIAL, bucket=2 * BUCKET, ms=ms,
               frames_per_s=2 * TRIAL / ms * 1e3, plain_ms=plain_ms,
               plain_frames_per_s=2 * TRIAL / plain_ms * 1e3, launches_per_step=per_step)
    emit(rec)
    if per_step['triplet_loss'] != 1 or per_step['triplet_loss_grad'] != 1:
        raise AssertionError('an MSPS-VAE step ran K25 / K26 %d / %d times'
                             % (per_step['triplet_loss'], per_step['triplet_loss_grad']))
    emit(profile_steps(lambda: step_from_host(step, host_batch, batch), phase='msps_profile',
                       frames=2 * TRIAL, bucket=2 * BUCKET))
    return per_step, rec


def serve_msps(port, hp, vdir, best, source):
    """Main path: the fitted MSPS-VAE's ``best_val_model.pt`` serves through
    ``load_version``: ``encode`` gives [z_s, z_b, z_u] and ``reconstruct``
    decodes it, at 1, 189 and 1024 frames, within SERVE_ABS_TOL of the plain
    path on the card; serving launches no triplet kernel."""
    ops = port.ops
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(dict(hp, training_completed=True), f)
    frames = np.concatenate(list(source.trials[:6]))[:max(REQUEST_SIZES)]
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bundle = port.serving.load_version(vdir)
    answers = {(head, n): getattr(bundle, head)(frames[:n])
               for n in REQUEST_SIZES for head in ('encode', 'reconstruct')}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    served = dict(bundle.model.state_dict())
    same = all(torch.equal(served[k].cpu(), v) for k, v in
               port.weights.params_to_state_dict(bundle.model, best).items())
    model = bundle.model
    recs = []
    for n in REQUEST_SIZES:
        with torch.inference_mode():
            mu_ff = model.encoding.FF(plain_features(model, ops, bundle._frames(frames[:n])))
            ref_z = torch.cat([model.encoding.A(mu_ff), model.encoding.C(mu_ff),
                               model.encoding.B(mu_ff)], dim=1)
            ref_y = plain_decode(model, ops, ref_z)
        for head, ref in (('encode', ref_z), ('reconstruct', ref_y)):
            out = answers[(head, n)]
            want = (n, N_MSPS_LATENTS) if head == 'encode' else (n, IMG[1], IMG[2], IMG[0])
            err = (out - ref).abs().max().item()
            tol = SERVE_ABS_TOL * max(1.0, ref.abs().max().item())
            ok = tuple(out.shape) == want and bool(torch.isfinite(out).all().item()) and \
                err <= tol
            rec = dict(phase='serve_msps', head=head, frames=n, max_abs_err=err, tol=tol,
                       ok=ok, ms=request_ms(lambda: getattr(bundle, head)(frames[:n])))
            emit(rec)
            recs.append(rec)
    emit(dict(phase='serve_msps_launches', weights_equal=same, launches=launches))
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    triplet = launches['triplet_loss'] + launches['triplet_loss_grad']
    if missing or triplet or not same or not all(r['ok'] for r in recs):
        raise AssertionError('the fitted MSPS-VAE does not serve: missing %s, %d triplet '
                             'launches, weights equal %s' % (missing, triplet, same))
    return launches


# ------------------------------------------------------------------ ARHMM


def reset_launches(build):
    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0


def bound(n_ops, n_bytes, peak_flops=PEAK_F32_FLOPS):
    """The least time of a call: the larger of its operations at the f32
    peak (``PEAK_F64_FLOPS`` for float64 work) and its bytes (each input
    read once, each output written once) at the memory rate."""
    t_ops = n_ops / peak_flops * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), t_ops_ms=t_ops, t_bytes_ms=t_bytes,
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def sample_arhmm(n, frames, k, d, seed, path_seed=None):
    """(n, frames, d) float32 trials from a seeded AR(1) HMM with k states:
    dynamics 0.9 times a random rotation, offsets of scale 0.3, noise 0.1,
    a state kept with probability 0.95 a frame. With ``path_seed`` the
    states and noise come from that seed, the model from ``seed``."""
    rs = np.random.RandomState(seed)
    A = 0.9 * np.linalg.qr(rs.randn(k, d, d))[0]
    b = 0.3 * rs.randn(k, d)
    if path_seed is not None:
        rs = np.random.RandomState(path_seed)
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
    ``log_normalizer`` (K13's with ``parallel``), K10's (K14's) ``viterbi``
    and the M-step's K11 ``solve_small``, K31 ``mstep_stats`` /
    ``mstep_cov``, K40 ``recurrent_mstep`` and K41 ``nu_mstep``, for the
    plain twin of a run on the card."""
    am, hmm = port.arhmm, port.hmm

    def log_likes(x, mask, As, bs, Sigmas, lags, diagonal):
        prec, logdet = am.obs_precision(Sigmas, diagonal)
        return am.log_likes_plain(x, mask, As, bs, prec, logdet, lags, diagonal)

    def robust_log_likes(x, mask, As, bs, Sigmas, nus, lags, diagonal, with_tau=False):
        prec, logdet = am.obs_precision(Sigmas, diagonal)
        nus, c = am.student_t_terms(nus, logdet, x.shape[2])
        return am.robust_log_likes_plain(x, mask, As, bs, prec, c, nus, lags, diagonal,
                                         with_tau)
    def log_normalizer(*args, parallel=False):
        return (hmm.forward_parallel_plain if parallel else hmm.forward_plain)(*args)[1]

    def viterbi(*args, parallel=False):
        return (hmm.viterbi_parallel_plain if parallel else hmm.viterbi_plain)(*args)
    routes = ((am, 'log_likes', log_likes), (am, 'robust_log_likes', robust_log_likes),
              (am, 'solve_small', port.smallmat.solve_small_plain),
              (am, 'mstep_stats', am.mstep_stats_plain), (am, 'mstep_cov', am.mstep_cov_plain),
              (am, 'recurrent_mstep', am.recurrent_mstep_plain),
              (am, 'nu_mstep', am.nu_mstep_plain),
              (hmm, 'forward_backward', hmm.forward_backward_plain),
              (hmm, 'log_normalizer', log_normalizer), (hmm, 'viterbi', viterbi))
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


def recurrent_arhmm(port, model, transitions, observations, parallel_scan=False):
    """A fresh ``transitions`` / ``observations`` ARHMM at the EM shapes
    (its own seeded Rs, r and dof 4) holding ``model``'s initialized
    ``log_pi0``, ``log_Ps`` and AR params."""
    m = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, observations=observations,
                         transitions=transitions, rng_seed=SEED, parallel_scan=parallel_scan,
                         device=DEVICE)
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


# ------------------------------------------- K31 and the float64 launchers


def mstep_case_inputs(port, model, trials, K, robust, gen):
    """The K31 check's inputs at the EM shape: the EM trials cut to seeded
    lengths in MSTEP_LENGTHS (x zero past them), the mask, gammas (K = 16:
    the model's posteriors; else seeded draws normalized over states) and,
    robust, tau from K8's Student's-t launcher at dof 4."""
    am, hmm = port.arhmm, port.hmm
    x, mask = trials
    N, T, _ = x.shape
    lo, hi = MSTEP_LENGTHS
    lengths = torch.randint(lo, hi + 1, (N,), generator=gen, device=DEVICE)
    m = (torch.arange(T, device=DEVICE)[None] < lengths[:, None]).to(x.dtype) * mask
    xm = x * m[:, :, None]
    p = model.params
    if K == model.K:
        gammas = hmm.forward_backward(p['log_pi0'], model._log_P(p), model._log_likes(p, xm, m),
                                      m)[0]
    else:
        g = torch.rand((N, T, K), generator=gen, device=DEVICE) + 0.05
        gammas = g / g.sum(dim=2, keepdim=True) * m[:, :, None]
    tau = None
    if robust:
        nus = torch.full((model.K,), 4.0, device=DEVICE)
        tau = am.robust_log_likes(xm, m, p['As'], p['bs'], p['Sigmas'], nus, model.lags, False,
                                  with_tau=True)[1]
    return xm, m, gammas, tau


def mstep_beta(XtWX, XtWY):
    """The regression of the M-step from float64 sums (equilibrated and
    ridged as the port's ``_m_step``), by ``torch.linalg.solve``: a beta for
    the covariance pass's check at every width (K11 takes P <= 16)."""
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(XtWX, dim1=1, dim2=2), min=1e-8))
    eye = torch.eye(XtWX.shape[1], dtype=XtWX.dtype, device=XtWX.device)
    A = XtWX * s[:, :, None] * s[:, None, :] + 1e-5 * eye[None]
    return s[:, :, None] * torch.linalg.solve(A, XtWY * s[:, :, None])


def composed_mstep_cov(am, x, mask, gammas, tau, beta, lags, diagonal):
    """The port's residual sums before K31: the residuals of every frame and
    state, then per state and trial a (D, D) ``bmm`` summed over trials
    (diagonal: a weighted sum of squares). The yardstick of K31's second
    pass; the port never calls it."""
    N, T, D = x.shape
    K = gammas.shape[2]
    Xd = am._design(x, lags)
    Xf, Yf = Xd.reshape(-1, Xd.shape[2]), x.reshape(-1, D)
    Wf = am._mstep_weights(gammas, mask, tau, lags).reshape(-1, K)
    resid = Yf[:, None, :] - torch.einsum('np,kpd->nkd', Xf, beta)
    if diagonal:
        return torch.sum(Wf[:, :, None] * resid ** 2, dim=0)
    R = resid.transpose(0, 1).reshape(K * N, T, D)
    RW = (resid * Wf[:, :, None]).transpose(0, 1).reshape(K * N, T, D)
    return torch.bmm(RW.transpose(1, 2), R).reshape(K, N, D, D).sum(dim=1)


def rel_err(got, want):
    """max |got - want| over the largest |want|, in float64."""
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max().clamp(min=1e-300)).item()


def mstep_bounds(frames, K, D, P, diagonal, robust, cov, itemsize):
    """K31's work for ``frames`` weighted frames: the weight (2 or 3
    multiplies), then per state P (P + 1) / 2 + P D multiply-adds (the
    statistics) or P D + D (D + 1) / 2 (diagonal: + D) (the residual sums);
    bytes: x, the mask, gammas (and tau), beta for the covariance, the
    outputs."""
    macs = P * D + (D if diagonal else D * (D + 1) // 2) if cov else P * (P + 1) // 2 + P * D
    n_ops = frames * K * (2 * macs + (3 if robust else 2))
    n_in = frames * (D + 1 + K * (2 if robust else 1)) + (K * P * D if cov else 0)
    n_out = (K * D if diagonal else K * D * D) if cov else K * (P * P + P * D + 1)
    return n_ops, itemsize * (n_in + n_out)


def check_mstep(port, model, trials):
    """K31 (the M-step's weighted sums, both passes, float32 and float64)
    against its plain version on ragged trials of MSTEP_LENGTHS frames at
    the EM shape, cases MSTEP_CASES: every float32 output within
    MSTEP_F32_REL_TOL of its largest entry from the plain version run in
    float64 and no farther from it than the plain float32 version (or one
    float32 ulp of that entry); every float64 output within
    MSTEP_F64_REL_TOL; a second call equal to the first, bit for bit. The
    main path's case ('full') is timed beside the plain versions and the
    composed einsum / bmm path it replaced."""
    am = port.arhmm
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 13)
    cases, timed = {}, {}
    for name, (K, lags, diagonal, robust) in MSTEP_CASES.items():
        x, m, g, tau = mstep_case_inputs(port, model, trials, K, robust, gen)
        f64 = [None if t is None else t.double() for t in (x, m, g, tau)]
        st64 = am.mstep_stats_plain(*f64, lags)
        beta64 = mstep_beta(*st64[:2])
        beta = beta64.float()
        cv64 = am.mstep_cov_plain(*f64, beta.double(), lags, diagonal)
        st32, st32b = am.mstep_stats_cuda(x, m, g, tau, lags), am.mstep_stats_cuda(x, m, g, tau,
                                                                                   lags)
        cv32, cv32b = (am.mstep_cov_cuda(x, m, g, tau, beta, lags, diagonal) for _ in range(2))
        stk64, stk64b = (am.mstep_stats_cuda(*f64, lags) for _ in range(2))
        cvk64, cvk64b = (am.mstep_cov_cuda(*f64, beta.double(), lags, diagonal)
                         for _ in range(2))
        stp32 = am.mstep_stats_plain(x, m, g, tau, lags)
        cvp32 = am.mstep_cov_plain(x, m, g, tau, beta, lags, diagonal)
        torch.cuda.synchronize()
        c = dict(states=K, lags=lags, diagonal=diagonal, robust=robust, P=EM_DIM * lags + 1,
                 frames=m.sum().item(),
                 stats_f32_err=max(rel_err(a, b) for a, b in zip(st32, st64)),
                 stats_plain_f32_err=max(rel_err(a, b) for a, b in zip(stp32, st64)),
                 stats_f64_err=max(rel_err(a, b) for a, b in zip(stk64, st64)),
                 cov_f32_err=rel_err(cv32, cv64), cov_plain_f32_err=rel_err(cvp32, cv64),
                 cov_f64_err=rel_err(cvk64, cv64),
                 same_bits=all(torch.equal(a, b) for a, b in
                               list(zip(st32, st32b)) + list(zip(stk64, stk64b))
                               + [(cv32, cv32b), (cvk64, cvk64b)]),
                 finite=all(bool(torch.isfinite(t).all().item())
                            for t in st32 + stk64 + (cv32, cvk64)))
        c['ok'] = bool(
            c['same_bits'] and c['finite'] and
            all(c[k + '_f32_err'] <= MSTEP_F32_REL_TOL and
                c[k + '_f32_err'] <= max(c[k + '_plain_f32_err'], F32_ULP)
                for k in ('stats', 'cov')) and
            max(c['stats_f64_err'], c['cov_f64_err']) <= MSTEP_F64_REL_TOL)
        cases[name] = c
        if name == 'full':
            timed = dict(inputs=(x, m, g, tau), f64=f64, beta=beta, lags=lags, K=K,
                         frames=c['frames'])
        del st64, cv64, st32, st32b, cv32, cv32b, stk64, stk64b, cvk64, cvk64b, stp32, cvp32
    rows = []
    x, m, g, tau = timed['inputs']
    lags, K, frames = timed['lags'], timed['K'], timed['frames']
    P = EM_DIM * lags + 1
    for suffix, args, beta, itemsize, peak in (
            ('', (x, m, g, tau), timed['beta'], 4, PEAK_F32_FLOPS),
            ('_f64', timed['f64'], timed['beta'].double(), 8, PEAK_F64_FLOPS)):
        for kernel, fn, plain, library, cov in (
                ('arhmm_mstep_stats', lambda a=args: am.mstep_stats_cuda(*a, lags),
                 lambda a=args: am.mstep_stats_plain(*a, lags),
                 lambda a=args: am.mstep_stats_plain(*a, lags), False),
                ('arhmm_mstep_cov', lambda a=args, b=beta: am.mstep_cov_cuda(*a, b, lags, False),
                 lambda a=args, b=beta: am.mstep_cov_plain(*a, b, lags, False),
                 lambda a=args, b=beta: composed_mstep_cov(am, *a, b, lags, False), True)):
            n_ops, n_bytes = mstep_bounds(frames, K, EM_DIM, P, False, tau is not None, cov,
                                          itemsize)
            err = max(v[('cov' if cov else 'stats') + ('_f64_err' if suffix else '_f32_err')]
                      for v in cases.values())
            rows.append(dict(
                phase='arhmm_kernel_check', kernel=kernel + suffix, layer='m_step',
                frames=EM_TRIALS * EM_FRAMES, weighted_frames=frames, states=K, dim=EM_DIM,
                max_abs_err=err, rel_tol=MSTEP_F64_REL_TOL if suffix else MSTEP_F32_REL_TOL,
                ms=median_ms(fn), plain_ms=median_ms(plain, samples=3, inner=2),
                library_ms=median_ms(library, samples=3, inner=2),
                library='the einsum / bmm path K31 replaced',
                gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes, peak)))
    rec = dict(phase='arhmm_mstep_check', lengths=MSTEP_LENGTHS, f32_rel_tol=MSTEP_F32_REL_TOL,
               f64_rel_tol=MSTEP_F64_REL_TOL, f32_ulp=F32_ULP, cases=cases,
               timed={r['kernel']: dict(ms=r['ms'], plain_ms=r['plain_ms'],
                                        library_ms=r['library_ms'], bound_ms=r['bound_ms'])
                      for r in rows})
    emit(rec)
    for r in rows:
        emit(r)
    bad = [name for name, c in cases.items() if not c['ok']]
    if bad:
        raise AssertionError('K31 disagrees with its plain version (%s): %s' % (bad, rec))
    return rows


def f64_params(model):
    """``model``'s parameters as float64 tensors."""
    return {k: v.double() for k, v in model.params.items()}


def check_f64_kernels(port, model, rec_models, trials):
    """The float64 launchers of K8 (both), K9 (stationary, time-varying with
    xi, the forward pass alone, stationary and time-varying), K10 (both) and
    K11 against their plain versions in float64, at the EM shape (the EM
    workload's trials and model; the seeded 'recurrent' robust model's
    time-varying log_P) and at the CLI's (CLI_TRIALS trials of TRIAL
    frames, the first F64_CLI_STATES states): log-likelihoods, tau,
    log_Z, gamma, xi and solutions within F64_REL_TOL of their largest
    entry, Viterbi paths as K10's float32 ones are held."""
    am, hmm, sm = port.arhmm, port.hmm, port.smallmat
    x32, mask32 = trials
    shapes = {'em': (x32.double(), mask32.double(), EM_STATES),
              'cli': (x32[:CLI_TRIALS, :TRIAL].double(), mask32[:CLI_TRIALS, :TRIAL].double(),
                      F64_CLI_STATES)}
    rows, bad = [], []

    def row(kernel, shape, err, fn, plain, n_ops, n_bytes, library=None, **extra):
        r = dict(phase='arhmm_f64_check', kernel=kernel, layer=shape,
                 frames=extra.pop('frames'), max_abs_err=err, rel_tol=F64_REL_TOL,
                 ms=median_ms(fn, samples=3, inner=5),
                 plain_ms=median_ms(plain, samples=3, inner=1, warmup=1),
                 library_ms=None if library is None else median_ms(library),
                 gflop=n_ops / 1e9, mbytes=n_bytes / 1e6,
                 **bound(n_ops, n_bytes, PEAK_F64_FLOPS), **extra)
        emit(r)
        rows.append(r)
        if not (r['max_abs_err'] <= F64_REL_TOL and extra.get('paths_ok', True)):
            bad.append((kernel, shape))

    for shape, (x, mask, K) in shapes.items():
        N, T, D = x.shape
        frames = mask.sum().item()
        p = {k: v[:K, :K] if k == 'log_Ps' else v[:K] for k, v in f64_params(model).items()}
        p['log_pi0'] = torch.log_softmax(p['log_pi0'], dim=0)
        prec, logdet = am.obs_precision(p['Sigmas'], False)
        a = (x, mask, p['As'], p['bs'], prec, logdet, 1, False)
        per_state = 2 * D * D + D * (D + 1) + 4 * D
        row('arhmm_log_likes_f64', shape, rel_err(am.log_likes_cuda(*a), am.log_likes_plain(*a)),
            lambda: am.log_likes_cuda(*a), lambda: am.log_likes_plain(*a),
            N * (T - 1) * K * per_state, 8 * (x.numel() + mask.numel() + N * T * K + 2 * K * D
                                              + K * D * D + K), frames=N * T)
        rp = {k: v[:K] for k, v in f64_params(rec_models['recurrent']).items()}
        prec_r, logdet_r = am.obs_precision(rp['Sigmas'], False)
        nus, c = am.student_t_terms(rp['nus'], logdet_r, D)
        ra = (x, mask, rp['As'], rp['bs'], prec_r, c, nus, 1, False, True)
        (ll_k, tau_k), (ll_p, tau_p) = am.robust_log_likes_cuda(*ra), am.robust_log_likes_plain(*ra)
        row('arhmm_log_likes_robust_f64', shape, max(rel_err(ll_k, ll_p), rel_err(tau_k, tau_p)),
            lambda: am.robust_log_likes_cuda(*ra), lambda: am.robust_log_likes_plain(*ra),
            N * T * K * (per_state + 6),
            8 * (x.numel() + mask.numel() + 2 * N * T * K + 2 * K * D + K * D * D + 2 * K),
            frames=N * T)
        del ll_k, tau_k, ll_p, tau_p
        pi0, lp = p['log_pi0'], torch.log_softmax(p['log_Ps'], dim=1)
        ll = am.log_likes_plain(*a)
        out_k = hmm.forward_backward_cuda(pi0, lp, ll, mask)
        out_p = hmm.forward_backward_plain(pi0, lp, ll, mask)
        fz_k = hmm.log_normalizer_cuda(pi0, lp, ll, mask)
        n_ops = (20 * K * K + 6 * K) * frames
        row('hmm_forward_backward_f64', shape, max(rel_err(a_, b_) for a_, b_ in
                                                   zip(out_k, out_p)),
            lambda: hmm.forward_backward_cuda(pi0, lp, ll, mask),
            lambda: hmm.forward_backward_plain(pi0, lp, ll, mask), n_ops,
            8 * (ll.numel() + mask.numel() + K * K + K + N * T * K + N + N * K * K),
            frames=N * T)
        row('hmm_forward_f64', shape, rel_err(fz_k, out_p[1]),
            lambda: hmm.log_normalizer_cuda(pi0, lp, ll, mask),
            lambda: hmm.forward_plain(pi0, lp, ll, mask), 8 * K * K * frames,
            8 * (ll.numel() + mask.numel() + K * K + K + N), frames=N * T)
        path_k, path_p = hmm.viterbi_cuda(pi0, lp, ll, mask), hmm.viterbi_plain(pi0, lp, ll, mask)
        lp_k = hmm.path_log_prob(pi0, lp, ll, mask, path_k)
        lp_p = hmm.path_log_prob(pi0, lp, ll, mask, path_p)
        agree = (path_k == path_p).double().mean().item()
        lp_rel = ((lp_k - lp_p).abs() / lp_p.abs()).max().item()
        row('hmm_viterbi_f64', shape, rel_err(lp_k, lp_p),
            lambda: hmm.viterbi_cuda(pi0, lp, ll, mask),
            lambda: hmm.viterbi_plain(pi0, lp, ll, mask), 2 * K * K * frames,
            8 * (ll.numel() + mask.numel() + K * K + K) + 4 * path_k.numel(), frames=N * T,
            path_agreement=agree, path_log_prob_rel_err=lp_rel,
            paths_ok=agree >= PATH_AGREE and lp_rel <= F64_REL_TOL)
        del out_k, out_p
        # time-varying: the seeded 'recurrent' model's log_P in float64
        rpl = dict(rp, log_pi0=torch.log_softmax(rp['log_pi0'], dim=0),
                   log_Ps=rp['log_Ps'][:, :K])
        lpt = torch.log_softmax(rpl['log_Ps'][None, None] + torch.einsum(
            'kd,ntd->ntk', rpl['Rs'], x[:, :-1])[:, :, None, :], dim=3)
        llt = am.robust_log_likes_plain(*ra)[0]
        out_k = hmm.forward_backward_cuda(rpl['log_pi0'], lpt, llt, mask, with_xi=True)
        out_p = hmm.forward_backward_plain(rpl['log_pi0'], lpt, llt, mask, with_xi=True)
        fz_k = hmm.log_normalizer_cuda(rpl['log_pi0'], lpt, llt, mask)
        row('hmm_forward_backward_tv_f64', shape,
            max(rel_err(a_, b_) for a_, b_ in zip(out_k, out_p)),
            lambda: hmm.forward_backward_cuda(rpl['log_pi0'], lpt, llt, mask, with_xi=True),
            lambda: hmm.forward_backward_plain(rpl['log_pi0'], lpt, llt, mask, with_xi=True),
            n_ops, 8 * (llt.numel() + mask.numel() + lpt.numel() + K + N * T * K + N
                        + N * K * K + lpt.numel()), frames=N * T)
        row('hmm_forward_tv_f64', shape, rel_err(fz_k, out_p[1]),
            lambda: hmm.log_normalizer_cuda(rpl['log_pi0'], lpt, llt, mask),
            lambda: hmm.forward_plain(rpl['log_pi0'], lpt, llt, mask), 8 * K * K * frames,
            8 * (llt.numel() + mask.numel() + lpt.numel() + K + N), frames=N * T)
        del out_k, out_p
        path_k = hmm.viterbi_cuda(rpl['log_pi0'], lpt, llt, mask)
        path_p = hmm.viterbi_plain(rpl['log_pi0'], lpt, llt, mask)
        lp_k = hmm.path_log_prob(rpl['log_pi0'], lpt, llt, mask, path_k)
        lp_p = hmm.path_log_prob(rpl['log_pi0'], lpt, llt, mask, path_p)
        agree = (path_k == path_p).double().mean().item()
        lp_rel = ((lp_k - lp_p).abs() / lp_p.abs()).max().item()
        row('hmm_viterbi_tv_f64', shape, rel_err(lp_k, lp_p),
            lambda: hmm.viterbi_cuda(rpl['log_pi0'], lpt, llt, mask),
            lambda: hmm.viterbi_plain(rpl['log_pi0'], lpt, llt, mask), 2 * K * K * frames,
            8 * (llt.numel() + mask.numel() + lpt.numel() + K) + 4 * path_k.numel(),
            frames=N * T, path_agreement=agree, path_log_prob_rel_err=lp_rel,
            paths_ok=agree >= PATH_AGREE and lp_rel <= F64_REL_TOL)
        del lpt, llt
        # K11 at the systems a float64 M-step solves on these trials
        g = torch.softmax(ll, dim=2) * mask[:, :, None]
        XtWX, XtWY, _ = am.mstep_stats_plain(x, mask, g, None, 1)
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(XtWX, dim1=1, dim2=2), min=1e-8))
        A = XtWX * s[:, :, None] * s[:, None, :] + 1e-5 * torch.eye(
            D + 1, dtype=torch.float64, device=DEVICE)[None]
        Y = XtWY * s[:, :, None]
        B, n, k = Y.shape
        row('solve_small_f64', shape, rel_err(sm.solve_small_cuda(A, Y),
                                              sm.solve_small_plain(A, Y)),
            lambda: sm.solve_small_cuda(A, Y), lambda: sm.solve_small_plain(A, Y),
            2 * B * n * n * (n + k), 8 * (A.numel() + 2 * Y.numel()),
            library=lambda: torch.linalg.solve(A, Y), frames=B)
    torch.cuda.synchronize()
    # K9's double instances stop at 16 states: 17 raises before any launch
    before = dict(port.build.LAUNCHES)
    z = torch.zeros((1, 4, 17), dtype=torch.float64, device=DEVICE)
    try:
        hmm.forward_backward_cuda(z[0, 0], torch.zeros_like(z[0, 0, :, None].expand(17, 17)), z,
                                  z[:, :, 0])
        bad.append(('hmm_forward_backward_f64', 'accepted 17 states'))
    except NotImplementedError:
        pass
    if port.build.LAUNCHES != before:
        bad.append(('hmm_forward_backward_f64', 'launched at 17 states'))
    if bad:
        raise AssertionError('float64 launchers disagree with their plain versions: %s' % bad)
    return rows


def row18c_inputs(port, model, trials, cut):
    """K40's and K41's inputs under ``model`` on the EM trials (every tenth
    cut to EM_CUT frames with ``cut``): x zero past the cut, the mask, gammas
    and the per-step xis (K9) and tau (K8's Student's-t launcher)."""
    x, mask = trials
    m = mask.clone()
    if cut:
        m[::10, EM_CUT:] = 0.0
    xm = x * m[:, :, None]
    p = model.params
    ll, tau = model._log_likes(p, xm, m, with_tau=True)
    gammas, _, _, xis = port.hmm.forward_backward(p['log_pi0'], model._log_P(p, xm), ll, m,
                                                  with_xi=True)
    return xm, m, gammas, tau, xis


def first_grad_ratio(am, trans, x, xis, transitions):
    """The smallest |entry| of the recurrent objective's gradient at the
    start over its largest (float64 autograd; the entries the objective
    reads)."""
    leaves = [t.double().requires_grad_(True) for t in trans]
    loss = -torch.sum(xis.double() * am.recurrent_log_P(*leaves, x.double(), transitions))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = torch.cat([v.flatten() for v in grads if v is not None]).abs()
    return (g.min() / g.max()).item()


def row18c_case(am, model, inputs, transitions):
    """One row-18c case: K40 and K41 on ``inputs`` (``row18c_inputs``) under
    ``model``'s params, float32 and float64, one part and the trials halved
    into two, against their plain versions in float64 (the tolerances
    above). Returns the case's record, with ``ok``."""
    keys = ('log_Ps', 'Rs', 'r')

    def dist(a, b):
        return max((u.double() - v.double()).abs().max().item() for u, v in zip(a, b))

    def nu_dist(a, b):
        return ((a.double() - b) / b).abs().max().item()
    x, m, g, tau, xis = inputs
    D, half = x.shape[2], x.shape[0] // 2
    p = model.params
    trans = [p[k] for k in keys]
    t64 = [t.double() for t in trans]
    x64, xis64 = x.double(), xis.double()
    k32, k32b = (am.recurrent_mstep_cuda(*trans, [x], [xis], transitions) for _ in range(2))
    k64, k64b = (am.recurrent_mstep_cuda(*t64, [x64], [xis64], transitions) for _ in range(2))
    two = am.recurrent_mstep_cuda(*trans, [x[:half], x[half:]], [xis[:half], xis[half:]],
                                  transitions)
    p64 = am.recurrent_mstep_plain(*t64, [x64], [xis64], transitions)
    p32 = am.recurrent_mstep_plain(*trans, [x], [xis], transitions)
    nus = p['nus']
    parts = [(m, g, tau)]
    n32, n32b = (am.nu_mstep_cuda(nus, parts, D) for _ in range(2))
    parts64 = [(m.double(), g.double(), tau.double())]
    n64, n64b = (am.nu_mstep_cuda(nus.double(), parts64, D) for _ in range(2))
    n_two = am.nu_mstep_cuda(nus, [(m[:half], g[:half], tau[:half]),
                                   (m[half:], g[half:], tau[half:])], D)
    wide = torch.cat([torch.ones_like(tau[:, :2]), tau], dim=1)[:, 2:]
    n_strided = am.nu_mstep_cuda(nus, [(m, g, wide)], D)
    pn64 = am.nu_mstep_plain(nus.double(), parts64, D)
    pn32 = am.nu_mstep_plain(nus, parts, D)
    torch.cuda.synchronize()
    kept = keys.index('r' if transitions == 'recurrent' else 'log_Ps')
    c = dict(
        states=len(nus), trials=x.shape[0], frames_per_trial=x.shape[1],
        steps=int((m[:, :-1] * m[:, 1:]).sum().item()),
        first_grad_min_over_max=first_grad_ratio(am, trans, x, xis, transitions),
        rec_f32_err=dist(k32, p64), rec_plain_f32_err=dist(p32, p64),
        rec_f64_err=dist(k64, p64), rec_two_parts_err=dist(two, p64),
        rec_kept=bool(torch.equal(k32[kept], trans[kept]) and torch.equal(k64[kept], t64[kept])),
        nu_f32_rel_err=nu_dist(n32, pn64), nu_plain_f32_rel_err=nu_dist(pn32, pn64),
        nu_f64_rel_err=nu_dist(n64, pn64), nu_two_parts_rel_err=nu_dist(n_two, pn64),
        nu_strided_equal=bool(torch.equal(n_strided, n32)),
        nus=n64.tolist(),
        same_bits=all(torch.equal(a, b) for a, b in
                      list(zip(k32, k32b)) + list(zip(k64, k64b)) + [(n32, n32b), (n64, n64b)]),
        finite=all(bool(torch.isfinite(t).all().item()) for t in k32 + k64 + (n32, n64)))
    c['rec_f32_tol'] = min(REC_F32_ABS_CAP, max(REC_F32_ABS_TOL, 2 * c['rec_plain_f32_err']))
    c['nu_f32_tol'] = min(NU_F32_REL_CAP, max(NU_F32_REL_TOL, 2 * c['nu_plain_f32_rel_err']))
    c['ok'] = bool(
        c['same_bits'] and c['finite'] and c['rec_kept'] and c['nu_strided_equal'] and
        max(c['rec_f32_err'], c['rec_two_parts_err']) <= c['rec_f32_tol'] and
        c['rec_f64_err'] <= REC_F64_ABS_TOL and
        max(c['nu_f32_rel_err'], c['nu_two_parts_rel_err']) <= c['nu_f32_tol'] and
        c['nu_f64_rel_err'] <= NU_F64_REL_TOL)
    return c


def cli_recurrent_model(port, k):
    """A ``k``-state 'recurrent' / 'robust_ar' ARHMM (the CLI's
    ``transitions: recurrent``, ``noise_type: studentst``) initialized on the
    CLI's latents (50 trials of TRIAL frames, D = EM_DIM), its dofs drawn in
    [2, 10] and Rs and r at REC_DRIVE; and those latents as padded trials."""
    datas = list(sample_arhmm(CLI_TRIALS, TRIAL, 8, EM_DIM, SEED + 5))
    m = port.arhmm.ARHMM(k, EM_DIM, lags=1, observations='robust_ar', transitions='recurrent',
                         rng_seed=SEED, device=DEVICE)
    m.initialize(datas)
    rs = np.random.RandomState(SEED + 30 + k)
    m.params.update(m._tensors({'nus': rs.uniform(2, 10, k), 'Rs': REC_DRIVE * rs.randn(k, EM_DIM),
                                'r': REC_DRIVE * rs.randn(k)}))
    return m, m.pad(datas)


def check_row18c(port, models, trials):
    """K40 and K41 (row 18c) against their plain versions in float64 on the
    card (``row18c_case``): at the EM shape, full and cut trials,
    'recurrent' and 'recurrent_only'; at the CLI's shape over REC_CLI_GRID
    under 'recurrent' and 'robust_ar'. Each launcher timed beside its plain
    version on the EM shape's full trials under 'recurrent'; the device
    digamma against torch.digamma."""
    am, build = port.arhmm, port.build
    cases, timed = {}, {}
    for transitions, model in models.items():
        for cut in (False, True):
            inputs = row18c_inputs(port, model, trials, cut)
            c = cases['%s_%s' % (transitions, 'cut' if cut else 'full')] = row18c_case(
                am, model, inputs, transitions)
            if transitions == 'recurrent' and not cut:
                x, m, g, tau, xis = inputs
                timed = dict(trans=[model.params[k] for k in ('log_Ps', 'Rs', 'r')], x=x,
                             xis=xis, parts=[(m, g, tau)], nus=model.params['nus'],
                             steps=c['steps'], frames=int(m.sum().item()))
            del inputs
    for k in REC_CLI_GRID:
        model, cli_trials = cli_recurrent_model(port, k)
        cases['cli_k%d' % k] = row18c_case(am, model, row18c_inputs(port, model, cli_trials,
                                                                    False), 'recurrent')
    xs = torch.linspace(*DIGAMMA_RANGE, 100001, device=DEVICE, dtype=torch.float64)
    ys = torch.empty_like(xs)
    err = build.library('arhmm_nu_mstep', 'bn_arhmm_digamma')(
        xs.data_ptr(), ys.data_ptr(), xs.numel(), torch.cuda.current_stream().cuda_stream)
    ref = torch.digamma(xs)
    digamma_err = ((ys - ref).abs() / ref.abs().clamp(min=1.0)).max().item()

    rows = []
    K, D, steps, frames = EM_STATES, EM_DIM, timed['steps'], timed['frames']
    trans, x, xis, parts, nus = (timed[k] for k in ('trans', 'x', 'xis', 'parts', 'nus'))
    for suffix, dt, itemsize, peak in (('', torch.float32, 4, PEAK_F32_FLOPS),
                                       ('_f64', torch.float64, 8, PEAK_F64_FLOPS)):
        tr = [t.to(dt) for t in trans]
        xd, xid = x.to(dt), xis.to(dt)
        pd = [tuple(t.to(dt) for t in part) for part in parts]
        nd = nus.to(dt)
        # K40: per Adam step and step t -> t+1 the drive (2 K D), the K
        # softmaxes (7 K^2: adds, max, subtractions, exps, sums, products)
        # and the gradient's sums (2 K D); the prep 3 K^2 + 2 K D once; bytes:
        # xis and x read, the parameters read and written
        n_ops = steps * (ADAM_STEPS * (4 * K * D + 7 * K * K) + 3 * K * K + 2 * K * D)
        n_bytes = itemsize * (xid.numel() + xd.numel() + 2 * (K * K + K * D + K))
        rows.append(dict(
            phase='arhmm_kernel_check', kernel='arhmm_recurrent_mstep' + suffix,
            layer='m_step_recurrent', frames=EM_TRIALS * EM_FRAMES, steps=steps, states=K,
            dim=D, adam_steps=ADAM_STEPS,
            max_abs_err=max(c['rec_f64_err' if suffix else 'rec_f32_err']
                            for c in cases.values()),
            ms=median_ms(lambda: am.recurrent_mstep_cuda(*tr, [xd], [xid], 'recurrent'),
                         samples=5, inner=3),
            plain_ms=median_ms(lambda: am.recurrent_mstep_plain(*tr, [xd], [xid], 'recurrent'),
                               samples=3, inner=1, warmup=1),
            library_ms=None, library='none: no PyTorch call computes the 25 Adam steps',
            gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes, peak)))
        # K41: per frame and state the weight, log tau and the weighted sum
        # (6); bytes: gammas, mask and tau read, the nus read and written
        n_ops = 6 * frames * K
        n_bytes = itemsize * (pd[0][1].numel() + pd[0][0].numel() + pd[0][2].numel() + 2 * K)
        rows.append(dict(
            phase='arhmm_kernel_check', kernel='arhmm_nu_mstep' + suffix, layer='m_step_nu',
            frames=EM_TRIALS * EM_FRAMES, states=K, dim=D,
            max_abs_err=max((c['nu_f64_rel_err' if suffix else 'nu_f32_rel_err'])
                            * max(c['nus']) for c in cases.values()),
            ms=median_ms(lambda: am.nu_mstep_cuda(nd, pd, D)),
            plain_ms=median_ms(lambda: am.nu_mstep_plain(nd, pd, D), samples=3, inner=2),
            library_ms=None, library='none: no PyTorch call computes the Newton steps',
            gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes, peak)))
    rec = dict(phase='arhmm_row18c_check', rec_f32_abs_tol=REC_F32_ABS_TOL,
               rec_f32_abs_cap=REC_F32_ABS_CAP, rec_f64_abs_tol=REC_F64_ABS_TOL,
               nu_f32_rel_tol=NU_F32_REL_TOL, nu_f32_rel_cap=NU_F32_REL_CAP,
               nu_f64_rel_tol=NU_F64_REL_TOL, digamma_range=DIGAMMA_RANGE,
               digamma_err=digamma_err, digamma_tol=DIGAMMA_TOL, digamma_launch_error=err,
               cases=cases,
               timed={r['kernel']: dict(ms=r['ms'], plain_ms=r['plain_ms'],
                                        bound_ms=r['bound_ms'], bound_by=r['bound_by'])
                      for r in rows})
    emit(rec)
    for r in rows:
        emit(r)
    bad = [name for name, c in cases.items() if not c['ok']]
    if bad or err != 0 or not digamma_err <= DIGAMMA_TOL:
        raise AssertionError('K40 / K41 disagree with their plain versions (%s): %s'
                             % (bad, rec))
    return rows


def arhmm_em_f64(port, init_params, rec_params, trials):
    """Main path 6e: float64 EM on the card. ``ARHMM(dtype='float64')`` from
    the EM workload's initialized parameters (cast up) fits F64_EM_ITERS
    iterations of the EM trials (cast up by ``pad``): every LL finite and
    non-decreasing, F64_EM_KERNELS every iteration; the first iteration's
    LL and parameters within F64_PARAM_REL_TOL (of each parameter's largest
    entry) of a plain float64 iteration on the card; an iteration's time
    beside the plain one's, and its profile. Then one iteration of a
    float64 'recurrent' + 'robust_ar' model (the seeded recurrent model's
    parameters) against its plain twin, its ``log_likelihood`` and
    ``most_likely_states_batch`` of ten trials (K9's forward pass and K10,
    time-varying, in float64)."""
    am, build = port.arhmm, port.build
    kw = dict(lags=1, rng_seed=SEED, dtype='float64', device=DEVICE)
    m64 = am.ARHMM(EM_STATES, EM_DIM, **kw)
    m64.params = {k: v.double() for k, v in init_params.items()}
    padded = m64.pad(am.PaddedTrials(*trials))
    x, mask = padded
    p0 = dict(m64.params)
    new_k, ll_k = m64._em_step(p0, x, mask)
    with plain_arhmm(port):
        new_p, ll_p = m64._em_step(p0, x, mask)
    torch.cuda.synchronize()
    param_err = {k: rel_err(new_k[k], new_p[k]) for k in new_p}
    ll_rel = abs(ll_k.item() - ll_p.item()) / abs(ll_p.item())
    dtypes_ok = all(v.dtype == torch.float64 for v in new_k.values())
    del new_k, new_p

    reset_launches(build)
    t0 = time.perf_counter()
    lls = m64.fit(padded, num_iters=F64_EM_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    finite = bool(np.isfinite(lls).all())
    rising = all(b >= a - EM_LL_REL_TOL * abs(a) for a, b in zip(lls, lls[1:]))
    missing = [k for k in F64_EM_KERNELS if launches[k] < F64_EM_ITERS]

    def step(m=m64):
        m.fit(padded, num_iters=1)
    twin = am.ARHMM(EM_STATES, EM_DIM, **kw)
    twin.params = dict(m64.params)
    ms = request_ms(step, reps=EM_TIMED_ITERS, warmup=2)
    with plain_arhmm(port):
        plain_ms = request_ms(lambda: step(twin), reps=3, warmup=1)
    prof = profile_steps(step, phase='arhmm_em_f64_profile', frames=EM_TRIALS * EM_FRAMES,
                         bucket=None)

    rec = am.ARHMM(EM_STATES, EM_DIM, observations='robust_ar', transitions='recurrent', **kw)
    rec.params = {k: v.double() for k, v in rec_params.items()}
    p0 = dict(rec.params)
    reset_launches(build)
    rnew_k, rll_k = rec._em_step(p0, x, mask)
    rec.params = rnew_k
    rec_ll = rec.log_likelihood(padded)
    paths = rec.most_likely_states_batch([x[i].cpu().numpy() for i in range(10)])
    torch.cuda.synchronize()
    rec_launches = dict(build.LAUNCHES)
    with plain_arhmm(port):
        rnew_p, rll_p = rec._em_step(p0, x, mask)
    rec_err = {k: rel_err(rnew_k[k], rnew_p[k]) for k in rnew_p}
    rec_ll_rel = abs(rll_k.item() - rll_p.item()) / abs(rll_p.item())
    rec_missing = [k for k in F64_REC_EM_KERNELS + ('hmm_forward_tv_f64', 'hmm_viterbi_tv_f64')
                   if rec_launches[k] == 0]
    del rnew_k, rnew_p
    out = dict(phase='arhmm_em_f64', trials=EM_TRIALS, frames_per_trial=EM_FRAMES,
               states=EM_STATES, dim=EM_DIM, iterations=F64_EM_ITERS, fit_seconds=fit_s,
               lls=lls, finite=finite, non_decreasing=rising, dtypes_float64=dtypes_ok,
               launches={k: v for k, v in launches.items() if v},
               launches_per_iteration={k: launches[k] / F64_EM_ITERS for k in F64_EM_KERNELS},
               first_iteration=dict(ll_rel_err=ll_rel, param_rel_err=param_err,
                                    rel_tol=F64_PARAM_REL_TOL),
               ms_per_iteration=ms, iterations_per_s=1e3 / ms, plain_ms_per_iteration=plain_ms,
               device_idle_share=prof['device_idle_share'],
               recurrent=dict(ll_rel_err=rec_ll_rel, param_rel_err=rec_err,
                              log_likelihood=rec_ll, paths=len(paths),
                              launches={k: v for k, v in rec_launches.items() if v}))
    emit(out)
    emit(prof)
    if missing or rec_missing or not finite or not rising or not dtypes_ok or \
            max(list(param_err.values()) + list(rec_err.values()) + [ll_rel, rec_ll_rel]) > \
            F64_PARAM_REL_TOL:
        raise AssertionError('float64 EM on the card failed (missing %s, %s): %s'
                             % (missing, rec_missing, out))
    return {k: launches[k] + rec_launches[k] for k in launches}


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
    ``kernels`` launched inside it. Returns the version dir of each K, the
    latents, the launches and the store."""
    def load(name):
        with open(os.path.join(ARHMM_CONFIGS, 'arhmm_%s.json' % name)) as f:
            return json.load(f)
    model_cfg, training_cfg, compute_cfg = load('model'), load('training'), load('compute')
    model_cfg.update(model)
    training_cfg['export_train_plots'] = False
    training_cfg['export_states'] = True
    compute_cfg.pop('device')
    ids = CLI_IDS
    f64 = '_f64' if model_cfg.get('em_dtype') == 'float64' else ''
    tmp = os.path.join(tmp, 'arhmm_cli_%s_%s%s%s' % (
        model_cfg['transitions'], model_cfg['noise_type'],
        '_parallel' if model_cfg.get('parallel_scan') else '', f64))
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
    rec = dict(phase='arhmm_cli' + f64, transitions=model_cfg['transitions'],
               noise_type=model_cfg['noise_type'], em_dtype=model_cfg.get('em_dtype', 'float32'),
               parallel_scan=bool(model_cfg.get('parallel_scan', False)),
               trials=CLI_TRIALS, frames_per_trial=TRIAL,
               dim=model_cfg['n_ae_latents'], iterations=training_cfg['n_iters'],
               grid=model_cfg['n_arhmm_states'], seconds_per_grid_point=seconds,
               launches=launches, results=results)
    emit(rec)
    if missing or not all(r['completed'] and r['finite'] and r['states_ok']
                          for r in results.values()):
        raise AssertionError('the ARHMM CLI failed (missing %s): %s' % (missing, rec))
    return types.SimpleNamespace(vdirs=vdirs, latents=latents, launches=launches,
                                 save_dir=save_dir)


def arhmm_serve(port, vdir, latents, kernels=('arhmm_log_likes', 'hmm_forward_backward',
                                               'hmm_viterbi'), dtype='float32'):
    """Main path 8: a fitted ``best_val_model.pt`` loads through
    ``load_arhmm`` on the card, its parameters in ``dtype``, and decodes one
    trial: the Viterbi path and the posteriors against the plain path's on
    the card, ``kernels`` launched."""
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
    dtypes = sorted({str(v.dtype) for v in model.params.values()})
    rec = dict(phase='arhmm_serve', transitions=model.transitions,
               observations=model.observations, parallel_scan=model.parallel_scan,
               dtype=model.dtype, param_dtypes=dtypes, states=model.K, frames=TRIAL,
               device=str(model.device),
               path_agreement=agree, path_log_prob_rel_err=lp_rel, gamma_max_abs_err=gamma_err,
               launches=launches,
               most_likely_states_ms=request_ms(lambda: model.most_likely_states(trial)),
               expected_states_ms=request_ms(lambda: model.expected_states(trial)))
    emit(rec)
    missing = [k for k in kernels if launches[k] == 0]
    if missing or agree < PATH_AGREE or lp_rel > PATH_LP_REL_TOL or \
            gamma_err > GAMMA_ABS_TOL or model.device.type != torch.device(DEVICE).type or \
            model.dtype != dtype or dtypes != ['torch.' + dtype]:
        raise AssertionError('the fitted ARHMM does not serve (missing %s): %s'
                             % (missing, rec))
    return launches


# ------------------------------------------- parallel scans and sampling


def scan_cases(port, model, rec_models, trials):
    """The inputs of the K13-K15 checks at the EM shapes: (name, log_pi0,
    log_P, log_lik, mask) of the stationary model on full trials and on the
    copy with every tenth trial cut to EM_CUT frames, and of the seeded
    'recurrent' (full trials) and 'recurrent_only' (cut) models, whose
    log_P is (100, 999, 16, 16)."""
    x, mask = trials
    cut = mask.clone()
    cut[::10, EM_CUT:] = 0.0
    p = model.params
    ll = model._log_likes(p, x, mask)
    cases = [('stationary_full', p['log_pi0'], model._log_P(p), ll, mask),
             ('stationary_cut', p['log_pi0'], model._log_P(p), ll * cut[:, :, None], cut)]
    for name, m, label in (('recurrent', mask, 'recurrent_full'),
                           ('recurrent_only', cut, 'recurrent_only_cut')):
        rm = rec_models[name]
        rp = rm.params
        cases.append((label, rp['log_pi0'], rm._log_P(rp, x), rm._log_likes(rp, x, m), m))
    return cases


def case_row(kernel, cases, extra, bad_of):
    """The check line of one kernel (or launcher) over its cases: the first
    case's numbers on the line, every case's under ``cases``; raises if any
    case fails ``bad_of``."""
    first = next(iter(cases.values()))
    rec = dict(phase='arhmm_kernel_check', kernel=kernel, layer=next(iter(cases)),
               frames=first['frames'], trials=EM_TRIALS, states=EM_STATES, library_ms=None,
               cases=cases, **extra,
               **{k: first[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                                        't_ops_ms', 't_bytes_ms', 'bound_by')})
    for k in ('ms', 'plain_ms', 'bound_ms', 't_ops_ms', 't_bytes_ms'):
        rec[k] = sum(c[k] for c in cases.values())
    rec['max_abs_err'] = max(c['max_abs_err'] for c in cases.values())
    emit(rec)
    bad = [name for name, c in cases.items() if bad_of(c)]
    if bad:
        raise AssertionError('%s disagrees with its plain version (%s): %s' % (kernel, bad, rec))
    return rec


def check_scan(port, cases):
    """K13 against the plain parallel version (``forward_backward_plain``
    with ``parallel``) and against K9 on the four cases: log_Z (and that of
    the forward phases alone) within LOGZ_REL_TOL of the plain version's,
    xi_sum within XI_REL_TOL of plain's; log_Z, gamma and (time-varying) the
    per-step xi within the module's tolerances of the plain parallel version
    run in float64, and log_Z within that tolerance plus K9's own error of
    K9's (a trial whose log_Z is near 0 makes a relative error large: K9's
    sequential float32 recursions carry ~1e-3 of absolute error over 1000
    frames). Returns the stationary and the time-varying launcher's
    lines."""
    hmm = port.hmm
    rows = []
    for kernel, tv in (('hmm_scan', False), ('hmm_scan_tv', True)):
        res = {}
        for name, pi0, lp, ll, m in cases:
            if (lp.dim() == 4) != tv:
                continue
            N, T, K = ll.shape
            out_k = hmm.forward_backward_scan_cuda(pi0, lp, ll, m, with_xi=tv)
            out_9 = hmm.forward_backward_cuda(pi0, lp, ll, m, with_xi=tv)
            out_p = hmm.forward_backward_plain(pi0, lp, ll, m, with_xi=tv, parallel=True)
            out_d = hmm.forward_backward_plain(*(t.double() for t in (pi0, lp, ll, m)),
                                               with_xi=tv, parallel=True)
            fz_k = hmm.forward_scan_cuda(pi0, lp, ll, m)
            torch.cuda.synchronize()

            def vs_f64(out):
                err = (out[0].double() - out_d[0]).abs().max().item()
                if tv:
                    err = max(err, (out[3].double() - out_d[3]).abs().max().item())
                return err
            errs = {who: vs_f64(o) for who, o in (('kernel', out_k), ('k9', out_9),
                                                   ('plain', out_p))}
            z_d = out_d[1]
            z_errs = {who: ((o[1].double() - z_d).abs() / z_d.abs()).max().item()
                      for who, o in (('kernel', out_k), ('k9', out_9), ('plain', out_p))}
            (g_k, z_k, s_k), (g_9, z_9), (g_p, z_p, s_p) = out_k[:3], out_9[:2], out_p[:3]
            pair = (m[:, :-1] * m[:, 1:]) == 0
            padded = bool((g_k[m == 0] == 0).all().item())
            if tv:
                padded = padded and bool((out_k[3][pair] == 0).all().item())
            frames = m.sum().item()
            # the function's own operations, as K9's bound counts them (the
            # same outputs from the same inputs); the chunk products' K-term
            # reductions for K rows and K lanes (5 K^3 a frame: add, max,
            # subtract, exp, sum) are work the chunked design adds, reported
            # beside the bound as chunk_gflop
            n_ops = (20 * K * K + 6 * K) * frames
            n_bytes = 4 * (ll.numel() + m.numel() + lp.numel() + K + g_k.numel() + N
                           + s_k.numel() + (out_k[3].numel() if tv else 0))
            res[name] = dict(
                frames=N * T, real_frames=frames,
                log_z_rel_err=((z_k - z_p).abs() / z_p.abs()).max().item(),
                log_z_rel_err_vs_k9=((z_k - z_9).abs() / z_9.abs()).max().item(),
                forward_log_z_rel_err=((fz_k - z_p).abs() / z_p.abs()).max().item(),
                max_abs_err=(g_k - g_p).abs().max().item(),
                gamma_max_abs_err_vs_k9=(g_k - g_9).abs().max().item(),
                xi_sum_rel_err=(s_k - s_p).abs().max().item() / s_p.abs().max().item(),
                err_vs_f64=errs, log_z_rel_err_vs_f64=z_errs,
                posterior_tol=max(GAMMA_ABS_TOL, 2 * max(errs['k9'], errs['plain'])),
                log_z_tol=max(LOGZ_REL_TOL, 2 * max(z_errs['k9'], z_errs['plain'])),
                max_abs_log_z=z_p.abs().max().item(), padded_zero=padded,
                finite=bool(torch.isfinite(g_k).all().item()),
                ms=median_ms(lambda: hmm.forward_backward_scan_cuda(pi0, lp, ll, m,
                                                                    with_xi=tv)),
                fwd_ms=median_ms(lambda: hmm.forward_scan_cuda(pi0, lp, ll, m)),
                k9_ms=median_ms(lambda: hmm.forward_backward_cuda(pi0, lp, ll, m, with_xi=tv)),
                plain_ms=median_ms(lambda: hmm.forward_backward_plain(
                    pi0, lp, ll, m, with_xi=tv, parallel=True), samples=3, inner=1, warmup=1),
                gflop=n_ops / 1e9, chunk_gflop=5 * K ** 3 * frames / 1e9,
                mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
            del out_k, out_9, out_p, out_d
        rows.append(case_row(
            kernel, res, dict(log_z_rel_tol=LOGZ_REL_TOL, xi_rel_tol=XI_REL_TOL,
                              bound_note='the chains of the chunks, not these'),
            lambda c: (not c['finite'] or not c['padded_zero']
                       or max(c['log_z_rel_err'], c['forward_log_z_rel_err']) > LOGZ_REL_TOL
                       or c['log_z_rel_err_vs_f64']['kernel'] > c['log_z_tol']
                       or c['log_z_rel_err_vs_k9'] > c['log_z_tol']
                       + c['log_z_rel_err_vs_f64']['k9']
                       or c['xi_sum_rel_err'] > XI_REL_TOL
                       or c['err_vs_f64']['kernel'] > c['posterior_tol'])))
    return rows


def path_lp64(port, pi0, lp, ll, m, path):
    """Joint log-probabilities (N,) of paths, in float64."""
    return port.hmm.path_log_prob(pi0.double(), lp.double(), ll.double(), m.double(), path)


def check_viterbi_scan(port, cases):
    """K14 against the plain parallel version and K10 on the four cases:
    paths equal on at least PATH_AGREE of the frames, the joint
    log-probabilities (float64) within PATH_LP_REL_TOL."""
    hmm = port.hmm
    rows = []
    for kernel, tv in (('hmm_viterbi_scan', False), ('hmm_viterbi_scan_tv', True)):
        res = {}
        for name, pi0, lp, ll, m in cases:
            if (lp.dim() == 4) != tv:
                continue
            N, T, K = ll.shape
            path_k = hmm.viterbi_scan_cuda(pi0, lp, ll, m)
            path_10 = hmm.viterbi_cuda(pi0, lp, ll, m)
            path_p = hmm.viterbi_parallel_plain(pi0, lp, ll, m)
            torch.cuda.synchronize()
            lps = {who: path_lp64(port, pi0, lp, ll, m, z)
                   for who, z in (('kernel', path_k), ('k10', path_10), ('plain', path_p))}

            def rel(a, b):
                return ((lps[a] - lps[b]).abs() / lps[b].abs()).max().item()
            frames = m.sum().item()
            # the function's own operations, as K10's bound counts them (the
            # same paths from the same inputs); the (max, +) chunk products
            # (3 K^3 a frame: add, compare, select) are work the chunked
            # design adds, reported beside the bound as chunk_gflop
            n_ops = 2 * K * K * frames
            n_bytes = 4 * (ll.numel() + m.numel() + lp.numel() + K + path_k.numel())
            res[name] = dict(
                frames=N * T, real_frames=frames,
                path_agreement=(path_k == path_p).float().mean().item(),
                path_agreement_vs_k10=(path_k == path_10).float().mean().item(),
                path_log_prob_rel_err=rel('kernel', 'plain'),
                path_log_prob_rel_err_vs_k10=rel('kernel', 'k10'),
                max_abs_err=(lps['kernel'] - lps['plain']).abs().max().item(),
                ms=median_ms(lambda: hmm.viterbi_scan_cuda(pi0, lp, ll, m)),
                k10_ms=median_ms(lambda: hmm.viterbi_cuda(pi0, lp, ll, m)),
                plain_ms=median_ms(lambda: hmm.viterbi_parallel_plain(pi0, lp, ll, m),
                                   samples=3, inner=1, warmup=1),
                gflop=n_ops / 1e9, chunk_gflop=3 * K ** 3 * frames / 1e9,
                mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
        rows.append(case_row(
            kernel, res, dict(agree_tol=PATH_AGREE, rel_tol=PATH_LP_REL_TOL,
                              bound_note='the chains of the chunks and the backtrace'),
            lambda c: (min(c['path_agreement'], c['path_agreement_vs_k10']) < PATH_AGREE
                       or max(c['path_log_prob_rel_err'],
                              c['path_log_prob_rel_err_vs_k10']) > PATH_LP_REL_TOL)))
    return rows


def draw_gaps(hmm, la, lp, m, u_last, u_maps, path_k, path_p):
    """For each trial whose kernel and plain posterior paths differ, the gap
    between the two chosen states' scores at the last frame where they
    differ (the paths agree after it, so both drew from the same row)."""
    gaps = []
    N, T, K = la.shape
    diff = path_k != path_p
    for n in torch.nonzero(diff.any(dim=1)).flatten().tolist():
        t = int(torch.nonzero(diff[n]).max())
        a, b = int(path_k[n, t]), int(path_p[n, t])
        if t == T - 1:
            last = la[n, -1]
            s = last - last.max() + hmm.gumbel(u_last[n])
        else:
            k = int(path_p[n, t + 1])
            lpt = lp if lp.dim() == 2 else lp[n, t]
            logits = la[n, t] + lpt[:, k]
            shift = logits.max()
            shift = shift if torch.isfinite(shift) else torch.zeros_like(shift)
            s = (logits - shift) + hmm.gumbel(u_maps[n, t, k])
        gaps.append(abs(s[a] - s[b]).item())
    return gaps


def check_sample_posterior(port, cases, gen):
    """K15 against the plain draws and composition from the same uniforms
    and the same filtered alphas, on the four cases, the alphas from K13's
    forward phases and from K9's forward pass: paths equal, or agreeing on
    PATH_AGREE of the frames with each first differing draw a near-tie."""
    hmm = port.hmm
    rows = []
    for kernel, tv in (('hmm_sample_posterior', False), ('hmm_sample_posterior_tv', True)):
        res = {}
        for name, pi0, lp, ll, m in cases:
            if (lp.dim() == 4) != tv:
                continue
            N, T, K = ll.shape
            u_last = hmm.uniforms((N, K), gen, ll.device)
            u_maps = hmm.uniforms((N, T - 1, K, K), gen, ll.device)
            alphas = {'k13': hmm.forward_scan_cuda(pi0, lp, ll, m, with_alpha=True)[0],
                      'k9': hmm.forward_alpha_cuda(pi0, lp, ll, m)[0]}
            sub = {}
            for src, la in alphas.items():
                path_k = hmm.sample_posterior_cuda(la, lp, m, u_last, u_maps)
                z_last, psi = hmm.presample_path_draws_plain(la, lp, m, u_last, u_maps)
                path_p = hmm._backtrace(psi, z_last, parallel=True)
                torch.cuda.synchronize()
                gaps = draw_gaps(hmm, la, lp, m, u_last, u_maps, path_k, path_p)
                sub[src] = dict(equal=bool(torch.equal(path_k, path_p)),
                                agreement=(path_k == path_p).float().mean().item(),
                                differing_trials=len(gaps),
                                max_gap=max(gaps) if gaps else 0.0)
            la = alphas['k13']
            # per entry of the (N, T-1, K, K) draws: an add, a subtract, the
            # max, two logs and a negation, an add and a compare
            n_ops = 8 * N * (T - 1) * K * K
            n_bytes = 4 * (la.numel() + lp.numel() + m.numel() + u_last.numel()
                           + u_maps.numel() + N * T)

            def plain(la=la):
                z_last, psi = hmm.presample_path_draws_plain(la, lp, m, u_last, u_maps)
                return hmm._backtrace(psi, z_last, parallel=True)
            res[name] = dict(
                frames=N * T, real_frames=m.sum().item(), from_alphas=sub,
                max_abs_err=float(max(1.0 - v['agreement'] for v in sub.values())),
                ms=median_ms(lambda: hmm.sample_posterior_cuda(la, lp, m, u_last, u_maps)),
                plain_ms=median_ms(plain, samples=3, inner=1, warmup=1),
                gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
            del alphas, u_maps
        rows.append(case_row(
            kernel, res, dict(agree_tol=PATH_AGREE, tie_tol=DRAW_TIE_TOL,
                              err_note='max_abs_err: the share of frames that differ'),
            lambda c: any(not v['equal'] and (v['agreement'] < PATH_AGREE
                                               or v['max_gap'] > DRAW_TIE_TOL)
                          for v in c['from_alphas'].values())))
    return rows


def check_forward_alpha(port, cases):
    """K9's forward pass that writes the filtered alphas (K15's input
    without ``parallel``) against ``forward_plain`` on the four cases:
    log_Z within LOGZ_REL_TOL of the plain version's, each frame's filtered
    probabilities (softmax of log_alpha over the states) within
    GAMMA_ABS_TOL, and log_alpha itself, every frame padded ones included
    (K15 draws z_T from the last), against the plain version in float64
    within LOGZ_REL_TOL of the trial's largest |log_alpha| or twice the
    plain float32 version's own distance."""
    hmm = port.hmm
    rows = []
    for kernel, tv in (('hmm_forward_alpha', False), ('hmm_forward_alpha_tv', True)):
        res = {}
        for name, pi0, lp, ll, m in cases:
            if (lp.dim() == 4) != tv:
                continue
            N, T, K = ll.shape
            a_k, z_k = hmm.forward_alpha_cuda(pi0, lp, ll, m)
            a_p, z_p = hmm.forward_plain(pi0, lp, ll, m)
            a_d = hmm.forward_plain(*(t.double() for t in (pi0, lp, ll, m)))[0]
            torch.cuda.synchronize()
            scale = a_d.abs().amax(dim=(1, 2))
            err_k = ((a_k.double() - a_d).abs().amax(dim=(1, 2)) / scale).max().item()
            err_p = ((a_p.double() - a_d).abs().amax(dim=(1, 2)) / scale).max().item()
            filt_err = (torch.softmax(a_k, dim=2) - torch.softmax(a_p, dim=2)).abs().max().item()
            frames = m.sum().item()
            # per frame the forward recursion's K-term logsumexp for K
            # states (5 K^2: add, max, subtract, exp, sum) and the masked
            # log-likelihood added (2 K)
            n_ops = (5 * K * K + 2 * K) * frames
            n_bytes = 4 * (ll.numel() + m.numel() + lp.numel() + K + a_k.numel() + N)
            res[name] = dict(
                frames=N * T, real_frames=frames,
                log_z_rel_err=((z_k - z_p).abs() / z_p.abs()).max().item(),
                filtered_max_abs_err=filt_err, alpha_rel_err_vs_f64=err_k,
                plain_alpha_rel_err_vs_f64=err_p,
                alpha_rel_tol=max(LOGZ_REL_TOL, 2 * err_p), max_abs_err=filt_err,
                finite=bool(torch.isfinite(a_k).all().item()),
                ms=median_ms(lambda: hmm.forward_alpha_cuda(pi0, lp, ll, m)),
                plain_ms=median_ms(lambda: hmm.forward_plain(pi0, lp, ll, m),
                                   samples=3, inner=1, warmup=1),
                gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))
            del a_k, a_p, a_d
        rows.append(case_row(
            kernel, res, dict(log_z_rel_tol=LOGZ_REL_TOL, abs_tol=GAMMA_ABS_TOL,
                              err_note='max_abs_err: of the filtered probabilities',
                              bound_note='the T-step dependence chain, not these'),
            lambda c: (not c['finite'] or c['log_z_rel_err'] > LOGZ_REL_TOL
                       or c['filtered_max_abs_err'] > GAMMA_ABS_TOL
                       or c['alpha_rel_err_vs_f64'] > c['alpha_rel_tol'])))
    return rows


def chain_gaps(hmm, pi0, lp, u0, u, path_k, path_p):
    """For each chain whose kernel and plain state paths differ, the gap
    between the two chosen states' scores at the first step where they
    differ (both drew from the same row there)."""
    gaps = []
    diff = path_k != path_p
    for b in torch.nonzero(diff.any(dim=1)).flatten().tolist():
        t = int(torch.nonzero(diff[b]).min())
        logits = pi0 if t == 0 else lp[path_p[b, t - 1].long()]
        s = logits + hmm.gumbel(u0[b] if t == 0 else u[b, t - 1])
        gaps.append(abs(s[int(path_k[b, t])] - s[int(path_p[b, t])]).item())
    return gaps


def check_sample_states(port, model, gen):
    """K16 against its plain version from the same uniforms on CHAINS chains
    of CHAIN_STEPS steps of the model's stationary chain (paths equal, or
    each first differing draw a near-tie), and its transition frequencies
    over those steps (and initial-state frequencies) against
    softmax(log_Ps) (softmax(log_pi0)) within SAMPLE_SE standard errors."""
    hmm = port.hmm
    pi0 = model.params['log_pi0']
    lp = torch.log_softmax(model.params['log_Ps'], dim=1)
    K = pi0.shape[0]
    B, T = CHAINS, CHAIN_STEPS
    u0 = hmm.uniforms((B, K), gen, pi0.device)
    u = hmm.uniforms((B, T - 1, K), gen, pi0.device)
    path_k = hmm.sample_states_cuda(pi0, lp, u0, u)
    path_p = hmm.sample_states_plain(pi0, lp, u0, u)
    torch.cuda.synchronize()
    gaps = chain_gaps(hmm, pi0, lp, u0, u, path_k, path_p)
    z = path_k.long()
    counts = torch.bincount((z[:, :-1] * K + z[:, 1:]).flatten(), minlength=K * K).reshape(
        K, K).double()
    rows_n = counts.sum(dim=1, keepdim=True)
    P = torch.softmax(lp.double(), dim=1)
    freq = counts / rows_n.clamp(min=1)
    trans_z = ((freq - P).abs() / torch.sqrt(P * (1 - P) / rows_n.clamp(min=1))
               .clamp(min=1e-30))
    trans_ok = bool(((freq - P).abs() <= SAMPLE_SE * torch.sqrt(P * (1 - P) / rows_n)
                     + 1.0 / rows_n.clamp(min=1)).all().item())
    p0 = torch.softmax(pi0.double(), dim=0)
    f0 = torch.bincount(z[:, 0], minlength=K).double() / B
    init_ok = bool(((f0 - p0).abs() <= SAMPLE_SE * torch.sqrt(p0 * (1 - p0) / B)
                    + 1.0 / B).all().item())
    n_ops = 5 * B * T * K
    n_bytes = 4 * (K + K * K + u0.numel() + u.numel() + B * T)
    rec = dict(phase='arhmm_kernel_check', kernel='hmm_sample_states', layer='chains',
               frames=B * T, chains=B, steps=T, states=K, equal=bool(torch.equal(path_k, path_p)),
               agreement=(path_k == path_p).float().mean().item(), differing_chains=len(gaps),
               max_gap=max(gaps) if gaps else 0.0, tie_tol=DRAW_TIE_TOL,
               max_abs_err=1.0 - (path_k == path_p).float().mean().item(),
               err_note='max_abs_err: the share of steps that differ',
               transition_max_z=trans_z.max().item(), transitions_ok=trans_ok,
               initial_ok=init_ok, se_tol=SAMPLE_SE,
               ms=median_ms(lambda: hmm.sample_states_cuda(pi0, lp, u0, u)),
               plain_ms=median_ms(lambda: hmm.sample_states_plain(pi0, lp, u0, u),
                                  samples=3, inner=1, warmup=1),
               library_ms=None, gflop=n_ops / 1e9, mbytes=n_bytes / 1e6,
               bound_note='the T-step chain of each thread', **bound(n_ops, n_bytes))
    emit(rec)
    if (not rec['equal'] and rec['max_gap'] > DRAW_TIE_TOL) or not trans_ok or not init_ok:
        raise AssertionError('K16 disagrees with its plain version or its chain: %s' % rec)
    return rec


def check_posterior_marginals(port, model, trials, gen):
    """K15's draws follow the posterior: SAMPLE_DRAWS draws of the first EM
    trial (repeated over the trial axis, one ``sample_posterior`` call with
    ``parallel``: K13's alphas, then K15), each frame's state frequencies
    within SAMPLE_SE standard errors (plus 1 / SAMPLE_DRAWS) of K13's
    gamma."""
    hmm = port.hmm
    x, mask = trials
    p = model.params
    n = SAMPLE_DRAWS
    xs, ms = x[:1].expand(n, -1, -1).contiguous(), mask[:1].expand(n, -1).contiguous()
    pi0, lp = p['log_pi0'], model._log_P(p)
    ll = model._log_likes(p, xs, ms)
    gamma = hmm.forward_backward_scan_cuda(pi0, lp, ll[:1], ms[:1])[0][0].double()
    paths = hmm.sample_posterior(pi0, lp, ll, ms, parallel=True, generator=gen).long()
    K = gamma.shape[1]
    freq = torch.stack([(paths == k).double().mean(dim=0) for k in range(K)], dim=1)
    se = torch.sqrt(gamma * (1 - gamma) / n)
    dev = (freq - gamma).abs()
    ok = bool((dev <= SAMPLE_SE * se + 1.0 / n).all().item())
    rec = dict(phase='arhmm_posterior_marginals', draws=n, frames=x.shape[1], states=K,
               max_abs_dev=dev.max().item(), se_tol=SAMPLE_SE, ok=ok,
               frames_over_3se=int((dev > 3 * se + 1.0 / n).sum().item()))
    emit(rec)
    if not ok:
        raise AssertionError("K15's draws do not follow the posterior: %s" % rec)


def arhmm_em_parallel(port, model, trials, kernels, iters):
    """Main paths 6c and 6d: ``ARHMM.fit`` with ``parallel_scan`` for
    ``iters`` EM iterations on the card (K13 and ``kernels`` every
    iteration; every LL finite and, stationary, non-decreasing, recurrent,
    the last above the first). Before it, one iteration from the same
    params beside the sequential EM's (LL within EM_LL_REL_TOL, every new
    parameter within REC_PARAM_REL_TOL of its largest entry); after it,
    an iteration's time beside the sequential one's and its profile; a
    recurrent model then decodes and samples one trial (K14's and K15's
    time-varying launchers)."""
    build = port.build
    x, mask = trials
    twin = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, observations=model.observations,
                            transitions=model.transitions, rng_seed=SEED, device=DEVICE)
    twin.params = dict(model.params)
    p0 = dict(model.params)
    new_par, ll_par = model._em_step(p0, x, mask)
    new_seq, ll_seq = twin._em_step(p0, x, mask)
    ll_par, ll_seq = ll_par.item(), ll_seq.item()
    ll_rel = abs(ll_par - ll_seq) / abs(ll_seq)
    param_err = {k: (new_par[k] - new_seq[k]).abs().max().item()
                 / max(new_seq[k].abs().max().item(), 1e-30) for k in new_seq}
    del new_par, new_seq

    reset_launches(build)
    t0 = time.perf_counter()
    lls = model.fit(trials, num_iters=iters)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    decode = {}
    if model.recurrent:
        trial = x[0].cpu().numpy()
        decode['path'] = model.most_likely_states(trial)
        decode['sample'] = model.posterior_sample(trial, generator=torch.Generator(
            device=DEVICE).manual_seed(SEED))
        torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    finite = bool(np.isfinite(lls).all())
    if model.recurrent:
        rising = lls[-1] > lls[0]
    else:
        rising = all(b >= a - EM_LL_REL_TOL * abs(a) for a, b in zip(lls, lls[1:]))
    missing = [k for k in kernels if launches[k] < iters]
    missing += [k for k in (PARALLEL_REC_DECODE_KERNELS if model.recurrent else ())
                if launches[k] == 0]

    def step(m=model):
        m.fit(trials, num_iters=1)
    twin.params = dict(model.params)
    ms = request_ms(step, reps=EM_TIMED_ITERS, warmup=2)
    seq_ms = request_ms(lambda: step(twin), reps=EM_TIMED_ITERS, warmup=2)
    rec = dict(phase='arhmm_em_parallel', transitions=model.transitions,
               observations=model.observations, trials=EM_TRIALS, frames_per_trial=EM_FRAMES,
               states=EM_STATES, dim=EM_DIM, iterations=iters, fit_seconds=fit_s, lls=lls,
               finite=finite, rising=rising, launches=launches,
               launches_per_iteration={k: launches[k] / iters for k in kernels},
               one_iteration=dict(ll=ll_par, sequential_ll=ll_seq, ll_rel_err=ll_rel,
                                  ll_rel_tol=EM_LL_REL_TOL, param_rel_err=param_err,
                                  param_rel_tol=REC_PARAM_REL_TOL),
               ms_per_iteration=ms, sequential_ms_per_iteration=seq_ms,
               decoded={k: [int(v.min()), int(v.max()), len(v)] for k, v in decode.items()})
    emit(rec)
    if missing or not finite or not rising or ll_rel > EM_LL_REL_TOL or \
            max(param_err.values()) > REC_PARAM_REL_TOL:
        raise AssertionError('EM with parallel_scan on the card failed (missing %s): %s'
                             % (missing, rec))
    emit(profile_steps(step, phase='arhmm_em_parallel_profile', frames=EM_TRIALS * EM_FRAMES,
                       bucket=None, transitions=model.transitions))
    return launches


def long_session(port, model):
    """Main path 6e: one LONG_FRAMES-frame session sampled from the seeded
    16-state ARHMM of the EM workload (its own states and noise), decoded
    by the fitted EM model with ``parallel_scan``
    (``expected_states``: K13, ``most_likely_states``: K14) and without
    (K9, K10). K13's posteriors and log_Z against the plain parallel version
    in float64 within max(the K9 tolerances, twice K9's own error); K14's
    path against K10's by agreement and float64 joint log-probability. Each
    call timed, and the kernels alone on its inputs."""
    hmm, build = port.hmm, port.build
    t0 = time.perf_counter()
    data = sample_arhmm(1, LONG_FRAMES, EM_STATES, EM_DIM, SEED + 4, path_seed=SEED + 6)[0]
    sample_s = time.perf_counter() - t0
    par = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, parallel_scan=True,
                           device=DEVICE)
    seq = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, device=DEVICE)
    par.params = seq.params = dict(model.params)
    reset_launches(build)
    gamma_par, path_par = par.expected_states(data), par.most_likely_states(data)
    gamma_seq, path_seq = seq.expected_states(data), seq.most_likely_states(data)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)

    x, mask = par.pad([data])
    p = par.params
    pi0, lp, ll = p['log_pi0'], par._log_P(p), par._log_likes(p, x, mask)
    g_d, z_d, _ = hmm.forward_backward_plain(pi0.double(), lp.double(), ll.double(),
                                             mask.double(), parallel=True)
    g_d = g_d[0].cpu().numpy()
    z13, z9 = (hmm.log_normalizer(pi0, lp, ll, mask, parallel=flag) for flag in (True, False))
    z_err = {who: abs(z.item() - z_d.item()) / abs(z_d.item())
             for who, z in (('k13', z13), ('k9', z9))}
    g_err = {who: float(np.abs(g - g_d).max())
             for who, g in (('k13', gamma_par), ('k9', gamma_seq))}
    lps = [path_lp64(port, pi0, lp, ll, mask, torch.from_numpy(z[None]).to(DEVICE)).item()
           for z in (path_par, path_seq)]
    agree = float(np.mean(path_par == path_seq))
    lp_rel = abs(lps[0] - lps[1]) / abs(lps[1])
    g_tol = max(GAMMA_ABS_TOL, 2 * g_err['k9'])
    z_tol = max(LOGZ_REL_TOL, 2 * z_err['k9'])
    K = EM_STATES
    frames = LONG_FRAMES
    rec = dict(phase='arhmm_long_session', frames=frames, states=K, dim=EM_DIM,
               sample_seconds=sample_s, log_z=z_d.item(), launches=launches,
               log_z_rel_err_vs_f64=z_err, log_z_rel_tol=z_tol,
               gamma_max_abs_err_vs_f64=g_err, gamma_tol=g_tol,
               gamma_argmax_agreement=float(np.mean(gamma_par.argmax(1) == gamma_seq.argmax(1))),
               path_agreement=agree, agree_tol=PATH_AGREE, path_log_prob_rel_err=lp_rel,
               rel_tol=PATH_LP_REL_TOL,
               expected_states_ms=dict(k13=request_ms(lambda: par.expected_states(data), reps=5),
                                       k9=request_ms(lambda: seq.expected_states(data), reps=5)),
               most_likely_states_ms=dict(
                   k14=request_ms(lambda: par.most_likely_states(data), reps=5),
                   k10=request_ms(lambda: seq.most_likely_states(data), reps=5)),
               posterior_sample_ms=request_ms(lambda: par.posterior_sample(data), reps=5),
               kernel_ms=dict(
                   k13=median_ms(lambda: hmm.forward_backward_scan_cuda(pi0, lp, ll, mask),
                                 samples=3, inner=3),
                   k13_forward=median_ms(lambda: hmm.forward_scan_cuda(pi0, lp, ll, mask),
                                         samples=3, inner=3),
                   k9=median_ms(lambda: hmm.forward_backward_cuda(pi0, lp, ll, mask),
                                samples=3, inner=1, warmup=1),
                   k14=median_ms(lambda: hmm.viterbi_scan_cuda(pi0, lp, ll, mask),
                                 samples=3, inner=3),
                   k10=median_ms(lambda: hmm.viterbi_cuda(pi0, lp, ll, mask),
                                 samples=3, inner=1, warmup=1),
                   plain_parallel=median_ms(lambda: hmm.forward_backward_plain(
                       pi0, lp, ll, mask, parallel=True), samples=3, inner=1, warmup=1)),
               k13_bound_ms=bound((20 * K * K + 6 * K) * frames,
                                  4 * (ll.numel() * 2 + mask.numel() + K * K + K + 1 + K * K))
               ['bound_ms'],
               k14_bound_ms=bound(2 * K * K * frames,
                                  4 * (ll.numel() + mask.numel() + K * K + K + frames))
               ['bound_ms'])
    emit(rec)
    missing = [k for k in ('hmm_scan', 'hmm_viterbi_scan', 'hmm_forward_backward',
                           'hmm_viterbi') if launches[k] == 0]
    if missing or z_err['k13'] > z_tol or g_err['k13'] > g_tol or agree < PATH_AGREE or \
            lp_rel > PATH_LP_REL_TOL:
        raise AssertionError('the long session disagrees (missing %s): %s' % (missing, rec))
    return launches, dict(data=data, chain=(pi0, lp, ll, mask), gamma64=g_d, log_z64=z_d.item(),
                          gamma_tol=g_tol, log_z_tol=z_tol)


def sp_launchers(port, pi0, lp, ll, m, mesh, u_last, u_maps):
    """K32-K35 on every shard of ``mesh`` (one card) through
    ``parallel.seq``'s own stages, each from the outputs of the stages
    before it in one run: kernel -> a function that runs that stage (its
    launcher on every shard, with the exchange it reads). Also the shards
    and the filtered alphas of K33's alpha mode, joined (1, T, K)."""
    seq = port.seq
    shards = seq.shard_chain(lp, ll, m, mesh)
    t_log, t_max = seq.stage_totals(pi0, shards), seq.stage_totals(pi0, shards, maxplus=True)
    vit, al = seq.stage_viterbi(t_max, shards), seq.stage_alphas(t_log, shards)
    mp = seq.stage_maps(shards, vit)
    fns = {'hmm_shard_totals': lambda: seq.stage_totals(pi0, shards),
           'hmm_shard_totals_maxplus': lambda: seq.stage_totals(pi0, shards, maxplus=True),
           'hmm_shard_finish': lambda: seq.stage_finish(t_log, shards),
           'hmm_shard_finish_alpha': lambda: seq.stage_alphas(t_log, shards),
           'hmm_shard_finish_viterbi': lambda: seq.stage_viterbi(t_max, shards),
           'hmm_shard_maps': lambda: seq.stage_maps(shards, vit),
           'hmm_shard_maps_sample': lambda: seq.stage_sample_maps(shards, al, u_last, u_maps),
           'hmm_shard_backtrace': lambda: seq.stage_backtrace(shards, [v[0] for v in vit], mp,
                                                              vit[-1][2])}
    return fns, shards, torch.cat([a for a, _ in al], dim=1)


def sp_bounds(K, frames, n_sh, tv):
    """Each launcher's bound over a trial of ``frames`` frames cut into
    ``n_sh`` shards, K13's accounting ((20 K^2 + 6 K) operations a frame,
    inputs read and outputs written once) split by launcher: K32 the
    forward chain's 5 K^2 (a K-term log-sum-exp a state: add, max,
    subtract, exp, sum), K33 the rest of K13's (posteriors: 15 K^2 + 6 K)
    or the alphas' 5 K^2; (max, +) K^2 each for K32 and K33 (K14's 2 K^2);
    K34 a gather a state a step (drawn: K15's 8 K^2); K35 one a frame."""
    F, KK = frames, K * K
    lp = 4 * (F * KK if tv else KK)
    chain = 4 * F * (K + 1) + lp                  # log_lik and mask, log_P
    tot = 4 * n_sh * (K + 1) * K                  # the gathered totals
    return {'hmm_shard_totals': bound(5 * KK * F, chain + tot),
            'hmm_shard_totals_maxplus': bound(KK * F, chain + tot),
            'hmm_shard_finish': bound((15 * KK + 6 * K) * F,
                                      chain + tot + 4 * F * K + 4 * n_sh * KK + 4),
            'hmm_shard_finish_alpha': bound(5 * KK * F, chain + tot + 4 * F * K),
            'hmm_shard_finish_viterbi': bound(KK * F, chain + tot + 4 * F * K),
            'hmm_shard_maps': bound(K * F, 4 * F * K + 4 * n_sh * K),
            'hmm_shard_maps_sample': bound(8 * KK * F, 4 * F * K + lp + 4 * F * KK
                                           + 4 * F * K + 4 * n_sh * K),
            'hmm_shard_backtrace': bound(F, 4 * F * K + 4 * n_sh * K + 4 * F)}


def frame_rel_err(a, ref):
    """The largest distance of log-alphas ``a`` (N, T, K) from the float64
    ``ref`` in a frame, relative to that frame's largest |ref| (at least
    1)."""
    return ((a.double() - ref).abs().amax(-1) / ref.abs().amax(-1).clamp(min=1.0)).max().item()


def sp_boundaries(port, pi0, lp, ll, m):
    """The shard boundaries and padding of K32-K35 on a short trial: the
    first SP_CUT_FRAMES frames of the chain (pi0, lp, ll, m), the frames
    from SP_CUT_VALID on masked, on meshes of SP_CUT_SHARDS shards of the
    card, against the plain passes on the same mesh. A boundary step's xi
    is one count among the trial's ~SP_CUT_VALID, so its loss or a second
    count shows in xi_sum's total (held to the number of steps between two
    valid frames) and in its entries."""
    seq = port.seq
    F, V = SP_CUT_FRAMES, SP_CUT_VALID
    lp = lp[:, :F - 1] if lp.dim() == 4 else lp
    ll, m = ll[:, :F], m[:, :F].clone()
    m[:, V:] = 0
    args = (pi0, lp, ll, m)
    steps = (m[:, 1:] * m[:, :-1]).double().sum().item()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    u = (port.hmm.uniforms((1, EM_STATES), gen, ll.device),
         port.hmm.uniforms((1, F - 1, EM_STATES, EM_STATES), gen, ll.device))
    out = {}
    for n in SP_CUT_SHARDS:
        mesh = port.mesh.Mesh([DEVICE] * n, ('sp',))
        fb, fb_p = seq.sp_forward_backward(*args, mesh=mesh), seq.sp_forward_backward_plain(
            *args, mesh)
        path, path_p = seq.sp_viterbi(*args, mesh=mesh), seq.sp_viterbi_plain(*args, mesh)
        draw = seq.sp_sample_posterior(*args, mesh=mesh, uniforms=u)
        draw_p = seq.sp_sample_posterior_plain(*args, *u, mesh)
        lps = [path_lp64(port, *args, z) for z in (path, path_p)]
        out[n] = dict(
            shard_frames=[t1 - t0 for t0, t1 in seq.shard_bounds(F, n)], valid_frames=V,
            steps=steps, xi_sum_max_abs_err=(fb[2] - fb_p[2]).abs().max().item(),
            xi_count_err=abs(fb[2].double().sum().item() - steps),
            plain_xi_count_err=abs(fb_p[2].double().sum().item() - steps),
            gamma_max_abs_err=(fb[0] - fb_p[0]).abs().max().item(),
            log_z_rel_err=abs(fb[1].item() - fb_p[1].item()) / abs(fb_p[1].item()),
            padded_zero=bool((fb[0][m == 0] == 0).all().item()),
            path_agreement=(path == path_p).float().mean().item(),
            path_log_prob_rel_err=((lps[0] - lps[1]).abs() / lps[1].abs()).max().item(),
            draw_agreement=(draw == draw_p).float().mean().item())
    return out


def check_sp_kernels(port, long, rec_model):
    """K32-K35 (``kernels/hmm_shard.cu``, row 19a) on the long session at
    full width (K = 16, LONG_FRAMES frames), stationary (the EM model, the
    chain and float64 reference of ``long_session``) and time-varying (the
    seeded 'recurrent' + 'robust_ar' model's (1, T-1, 16, 16) log_P), on
    meshes of SP_SHARDS shards of the card: ``parallel.seq``'s passes
    against their plain versions on the same mesh and inputs (gamma, log_Z,
    xi_sum; Viterbi paths; draws from the same uniforms), gamma and log_Z
    against the plain parallel pass in float64 within check_scan's
    tolerances, each launcher's outputs from the first run (the alphas
    against the plain forward pass), and with one shard K13's, K14's and
    K15's outputs bit for bit. Each launcher timed on every shard of the
    largest mesh beside the plain pass it serves; the passes timed whole at
    every mesh beside K13-K15. The shard boundaries and padding on a short
    trial (:func:`sp_boundaries`). Returns one line per launcher."""
    hmm, seq = port.hmm, port.seq
    x, mask = rec_model.pad([long['data']])
    rp = rec_model.params
    cases = [('stationary',) + long['chain'],
             ('time_varying', rp['log_pi0'], rec_model._log_P(rp, x),
              rec_model._log_likes(rp, x, mask), mask)]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 14)
    K, frames = EM_STATES, LONG_FRAMES
    res = {name: {} for name in SP_KERNELS}
    phase = dict(phase='sp_pass_check', frames=frames, states=K, shards=list(SP_SHARDS), cases={})
    for name, pi0, lp, ll, m in cases:
        tv = lp.dim() == 4
        u_last = hmm.uniforms((1, K), gen, ll.device)
        u_maps = hmm.uniforms((1, frames - 1, K, K), gen, ll.device)
        args = (pi0, lp, ll, m)
        if tv:
            g64, z64, _ = hmm.forward_backward_plain(*(t.double() for t in args), parallel=True)
            z64 = z64.item()
        else:
            g64, z64 = torch.from_numpy(long['gamma64']).to(ll.device)[None], long['log_z64']
        k13 = hmm.forward_backward_scan_cuda(*args)
        k14 = hmm.viterbi_scan_cuda(*args)
        la13 = hmm.forward_scan_cuda(*args, with_alpha=True)[0]
        a64 = hmm.forward_parallel_plain(*(t.double() for t in args))[0]
        k15 = hmm.sample_posterior_cuda(la13, lp, m, u_last, u_maps)
        torch.cuda.synchronize()
        per_n = {}
        for n in SP_SHARDS:
            mesh = port.mesh.Mesh([DEVICE] * n, ('sp',))
            fb = seq.sp_forward_backward(*args, mesh=mesh)
            fb_p = seq.sp_forward_backward_plain(*args, mesh)
            path, path_p = seq.sp_viterbi(*args, mesh=mesh), seq.sp_viterbi_plain(*args, mesh)
            draw = seq.sp_sample_posterior(*args, mesh=mesh, uniforms=(u_last, u_maps))
            draw_p = seq.sp_sample_posterior_plain(*args, u_last, u_maps, mesh)
            fns, _, alphas = sp_launchers(port, *args, mesh, u_last, u_maps)
            scan = functools.partial(seq.sp_scan, mesh=mesh)
            alphas_p = hmm.forward_parallel_plain(*args, scan=scan)[0]
            torch.cuda.synchronize()
            a_errs = {who: frame_rel_err(a, a64)
                      for who, a in (('kernel', alphas), ('plain', alphas_p), ('k13', la13))}
            lps = [path_lp64(port, *args, z) for z in (path, path_p, draw, draw_p)]
            errs = {who: (o[0].double() - g64).abs().max().item()
                    for who, o in (('kernel', fb), ('plain', fb_p), ('k13', k13))}
            z_errs = {who: abs(o[1].item() - z64) / abs(z64)
                      for who, o in (('kernel', fb), ('plain', fb_p), ('k13', k13))}
            c = dict(
                gamma_max_abs_err=(fb[0] - fb_p[0]).abs().max().item(),
                log_z_rel_err=abs(fb[1].item() - fb_p[1].item()) / abs(fb_p[1].item()),
                xi_sum_rel_err=(fb[2] - fb_p[2]).abs().max().item() / fb_p[2].abs().max().item(),
                gamma_err_vs_f64=errs, log_z_rel_err_vs_f64=z_errs,
                posterior_tol=max(GAMMA_ABS_TOL, 2 * max(errs['plain'], errs['k13'])),
                log_z_tol=max(LOGZ_REL_TOL, 2 * max(z_errs['plain'], z_errs['k13'])),
                alpha_rel_err=(alphas - alphas_p).abs().max().item()
                / alphas_p.abs().max().item(),
                alpha_frame_rel_err_vs_f64=a_errs,
                alpha_frame_tol=max(LOGZ_REL_TOL, 2 * max(a_errs['plain'], a_errs['k13'])),
                path_agreement=(path == path_p).float().mean().item(),
                path_log_prob_rel_err=((lps[0] - lps[1]).abs() / lps[1].abs()).max().item(),
                draw_agreement=(draw == draw_p).float().mean().item(),
                draw_log_prob_rel_err=((lps[2] - lps[3]).abs() / lps[3].abs()).max().item(),
                padded_zero=bool((fb[0][m == 0] == 0).all().item()),
                finite=bool(torch.isfinite(fb[0]).all().item()),
                pass_ms=dict(
                    forward_backward=median_ms(lambda: seq.sp_forward_backward(*args, mesh=mesh),
                                               samples=3, inner=3),
                    viterbi=median_ms(lambda: seq.sp_viterbi(*args, mesh=mesh),
                                      samples=3, inner=3),
                    sample=median_ms(lambda: seq.sp_sample_posterior(
                        *args, mesh=mesh, uniforms=(u_last, u_maps)), samples=3, inner=3)))
            if n == 1:
                c['equal_to_k13_k14_k15'] = [bool(torch.equal(a, b)) for a, b in (
                    (fb[0], k13[0]), (fb[1], k13[1]), (fb[2], k13[2]), (path, k14), (draw, k15))]
            per_n[n] = c
            if n == max(SP_SHARDS):
                plain = dict(
                    forward_backward=median_ms(lambda: seq.sp_forward_backward_plain(*args, mesh),
                                               samples=3, inner=1, warmup=1),
                    alpha=median_ms(lambda: hmm.forward_parallel_plain(*args, scan=scan),
                                    samples=3, inner=1, warmup=1),
                    viterbi=median_ms(lambda: seq.sp_viterbi_plain(*args, mesh),
                                      samples=3, inner=1, warmup=1),
                    sample=median_ms(lambda: seq.sp_sample_posterior_plain(
                        *args, u_last, u_maps, mesh), samples=3, inner=1, warmup=1))
                serves = {'hmm_shard_totals': 'forward_backward',
                          'hmm_shard_finish': 'forward_backward',
                          'hmm_shard_finish_alpha': 'alpha', 'hmm_shard_maps_sample': 'sample'}
                err = {'forward_backward': c['gamma_max_abs_err'],
                       'alpha': c['alpha_rel_err'], 'viterbi': 1.0 - c['path_agreement'],
                       'sample': 1.0 - c['draw_agreement']}
                bounds = sp_bounds(K, frames, n, tv)
                for kernel, fn in fns.items():
                    pas = serves.get(kernel, 'viterbi')
                    res[kernel]['%s_x%d' % (name, n)] = dict(
                        frames=frames, shards=n, serves=pas, max_abs_err=err[pas],
                        ms=median_ms(fn, samples=3, inner=5), plain_ms=plain[pas],
                        **bounds[kernel])
            del fb, fb_p, path, path_p, draw, draw_p, fns, alphas, alphas_p
        phase['cases'][name] = dict(
            boundaries=sp_boundaries(port, *args),
            k13_ms=median_ms(lambda: hmm.forward_backward_scan_cuda(*args), samples=3, inner=3),
            k14_ms=median_ms(lambda: hmm.viterbi_scan_cuda(*args), samples=3, inner=3),
            k15_ms=median_ms(lambda: hmm.sample_posterior_cuda(
                hmm.forward_scan_cuda(*args, with_alpha=True)[0], lp, m, u_last, u_maps),
                samples=3, inner=3),
            by_shards=per_n)
        del k13, k14, k15, la13, a64, u_maps, g64
    emit(phase)
    bad = ['%s x%d' % (name, n) for name, c in phase['cases'].items()
           for n, v in c['by_shards'].items()
           if not v['finite'] or not v['padded_zero'] or not all(v.get('equal_to_k13_k14_k15', [1]))
           or v['gamma_err_vs_f64']['kernel'] > v['posterior_tol']
           or v['log_z_rel_err_vs_f64']['kernel'] > v['log_z_tol']
           or v['log_z_rel_err'] > LOGZ_REL_TOL or v['xi_sum_rel_err'] > XI_REL_TOL
           or v['alpha_rel_err'] > LOGZ_REL_TOL
           or v['alpha_frame_rel_err_vs_f64']['kernel'] > v['alpha_frame_tol']
           or v['path_agreement'] < PATH_AGREE
           or v['path_log_prob_rel_err'] > PATH_LP_REL_TOL or v['draw_agreement'] < PATH_AGREE]
    bad += ['%s boundaries x%d' % (name, n) for name, c in phase['cases'].items()
            for n, v in c['boundaries'].items()
            if v['xi_sum_max_abs_err'] > SP_XI_ABS_TOL or v['xi_count_err'] > SP_XI_COUNT_TOL
            or v['gamma_max_abs_err'] > GAMMA_ABS_TOL or v['log_z_rel_err'] > LOGZ_REL_TOL
            or not v['padded_zero'] or v['path_agreement'] < PATH_AGREE
            or v['path_log_prob_rel_err'] > PATH_LP_REL_TOL or v['draw_agreement'] < PATH_AGREE]
    if bad:
        raise AssertionError('the time-sharded passes disagree (%s): %s' % (bad, phase))
    rows = []
    for kernel in SP_KERNELS:
        rec = dict(phase='sp_kernel_check', kernel=kernel, layer=next(iter(res[kernel])),
                   frames=frames, states=K, library_ms=None, cases=res[kernel],
                   bound_note='the chains of the chunks and the n-step folds, not these',
                   err_note='max_abs_err: gamma for the posterior launchers, the alphas\' '
                            'error relative to their largest magnitude for the alpha mode, '
                            'the share of frames that differ for paths and draws; plain_ms: '
                            'the plain pass the launcher serves')
        for k in ('ms', 'plain_ms', 'bound_ms', 't_ops_ms', 't_bytes_ms'):
            rec[k] = sum(c[k] for c in res[kernel].values())
        rec['max_abs_err'] = max(c['max_abs_err'] for c in res[kernel].values())
        rec['bound_by'] = 'operations' if rec['t_ops_ms'] >= rec['t_bytes_ms'] else 'bytes'
        emit(rec)
        rows.append(rec)
    return rows


def arhmm_em_sp(port, init_params, rec_params, session, trials):
    """Main path 6f: EM on meshes of the card. The time layout
    (``fit(mesh=SP_EM_SHARDS shards, shard_time=True)``) on two
    LONG_FRAMES-frame sessions (the long session and its time reversal), and
    the trial layout (``fit(mesh=SP_TRIAL_SHARDS shards)``) on the EM
    workload, each for SP_EM_ITERS iterations from the EM model's
    initialized params, one at a time and SP_DISPATCH to a dispatch: LLs finite and
    non-decreasing, within SP_EM_REL_TOL of the unsharded fit's (K13 on the
    long sessions, K9 on the EM workload); K32 and K33 on every shard every
    iteration of the time layout, K9 on every shard of the trial layout.
    Then an iteration of each timed beside the unsharded one, and the time
    layout's profiled (its chunked phases show under K13's names, which
    they share). Last, the seeded 'recurrent' + 'robust_ar' model
    (``rec_params``) in the trial layout for SP_REC_ITERS iterations against
    its unsharded fit (LLs and parameters): K40's prep and step passes and
    K41's pass on each part, their sums and updates on the first."""
    build, ARHMM, Mesh = port.build, port.arhmm.ARHMM, port.mesh.Mesh
    p0 = dict(init_params)
    sessions = port.arhmm.pad_trials([session, session[::-1].copy()], DEVICE)
    layouts = {'time': (Mesh([DEVICE] * SP_EM_SHARDS, ('sp',)), True, sessions),
               'trials': (Mesh([DEVICE] * SP_TRIAL_SHARDS, ('dp',)), False, trials)}

    def fresh(parallel_scan=False):
        m = ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, parallel_scan=parallel_scan,
                  device=DEVICE)
        m.params = dict(p0)
        return m
    rec = dict(phase='arhmm_em_sp', states=EM_STATES, dim=EM_DIM, iterations=SP_EM_ITERS,
               layouts={})
    refs = {name: fresh(shard_time).fit(data, num_iters=SP_EM_ITERS)
            for name, (_, shard_time, data) in layouts.items()}
    torch.cuda.synchronize()
    reset_launches(build)
    fits = {}
    for name, (mesh, shard_time, data) in layouts.items():
        for k in (1, SP_DISPATCH):
            m = fresh()
            t0 = time.perf_counter()
            lls = m.fit(data, num_iters=SP_EM_ITERS, mesh=mesh, shard_time=shard_time,
                        iters_per_dispatch=k)
            torch.cuda.synchronize()
            fits[name, k] = (lls, time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    for name, (mesh, shard_time, data) in layouts.items():
        ref = refs[name]
        out = dict(shards=mesh.size, shard_time=shard_time, unsharded_lls=ref,
                   frames=int(data.mask.sum().item()))
        for k in (1, SP_DISPATCH):
            lls, fit_s = fits[name, k]
            out['iters_per_dispatch_%d' % k] = dict(
                lls=lls, fit_seconds=fit_s, finite=bool(np.isfinite(lls).all()),
                rising=all(b >= a - EM_LL_REL_TOL * abs(a) for a, b in zip(lls, lls[1:])),
                rel_err_vs_unsharded=max(abs(a - b) / abs(b) for a, b in zip(lls, ref)))
        m = fresh()
        out['ms_per_iteration'] = request_ms(
            lambda: m.fit(data, num_iters=1, mesh=mesh, shard_time=shard_time), reps=5,
            warmup=2)
        u = fresh(shard_time)
        out['unsharded_ms_per_iteration'] = request_ms(lambda: u.fit(data, num_iters=1), reps=5,
                                                       warmup=2)
        rec['layouts'][name] = out
    per_iter = SP_EM_SHARDS * SP_EM_ITERS * 2
    need = {'hmm_shard_totals': per_iter, 'hmm_shard_finish': per_iter,
            'hmm_forward_backward': SP_TRIAL_SHARDS * SP_EM_ITERS * 2,
            'arhmm_log_likes': 1, 'arhmm_mstep_stats': 1, 'arhmm_mstep_cov': 1, 'solve_small': 1}
    missing = [k for k, v in need.items() if launches[k] < v]
    rec['launches'] = {k: launches[k] for k in need}
    emit(rec)
    bad = [(name, k) for name, out in rec['layouts'].items() for k, v in out.items()
           if k.startswith('iters_per_dispatch') and (not v['finite'] or not v['rising']
                                                      or v['rel_err_vs_unsharded'] > SP_EM_REL_TOL)]
    if missing or bad:
        raise AssertionError('EM on a mesh failed (missing %s, bad %s): %s'
                             % (missing, bad, rec))
    mesh, _, data = layouts['time']
    m = fresh()
    emit(profile_steps(lambda: m.fit(data, num_iters=1, mesh=mesh, shard_time=True),
                       phase='arhmm_em_sp_profile', frames=2 * LONG_FRAMES, bucket=None,
                       shards=SP_EM_SHARDS))
    rec_launches = recurrent_trial_layout(port, rec_params, trials,
                                          Mesh([DEVICE] * SP_TRIAL_SHARDS, ('dp',)))
    return {k: launches[k] + rec_launches[k] for k in launches}


def recurrent_trial_layout(port, rec_params, trials, mesh, unsharded=None):
    """The 'recurrent' + 'robust_ar' model from ``rec_params`` fitted
    SP_REC_ITERS iterations in the trial layout on ``mesh`` against
    ``unsharded`` (its fit without a mesh, made here when None: LLs, then
    the parameters): LLs within SP_EM_REL_TOL and each parameter within
    REC_PARAM_REL_TOL of its largest entry; K40 and K41 launched on each
    part every iteration. Emits the phase and returns the launches."""
    build = port.build

    def fresh():
        m = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, observations='robust_ar',
                             transitions='recurrent', rng_seed=SEED, device=DEVICE)
        m.params = dict(rec_params)
        return m
    if unsharded is None:
        ref = fresh()
        unsharded = (ref.fit(trials, num_iters=SP_REC_ITERS), ref.params)
    torch.cuda.synchronize()
    reset_launches(build)
    m = fresh()
    lls = m.fit(trials, num_iters=SP_REC_ITERS, mesh=mesh)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    ref_lls, ref_params = unsharded
    n = mesh.size
    # each iteration: K40's prep on each part, then 25 x (a step pass on
    # each part, the update); K41's pass on each part, then its finish
    need = {'arhmm_recurrent_mstep': SP_REC_ITERS * (n + ADAM_STEPS * (n + 1)),
            'arhmm_nu_mstep': SP_REC_ITERS * (n + 1)}
    rec = dict(phase='arhmm_em_sp_recurrent', shards=n, devices=[str(d) for d in mesh.devices],
               iterations=SP_REC_ITERS, lls=lls, unsharded_lls=ref_lls,
               ll_rel_err=max(abs(a - b) / abs(b) for a, b in zip(lls, ref_lls)),
               param_rel_err={k: rel_err(m.params[k], v.to(m.params[k].device))
                              for k, v in ref_params.items()},
               launches={k: launches[k] for k in need}, launches_needed=need)
    emit(rec)
    if any(launches[k] != v for k, v in need.items()) or rec['ll_rel_err'] > SP_EM_REL_TOL \
            or max(rec['param_rel_err'].values()) > REC_PARAM_REL_TOL:
        raise AssertionError('the recurrent EM in the trial layout failed: %s' % rec)
    return launches


def arhmm_sp_serve(port, model, long):
    """Main path 8d: one LONG_FRAMES-frame session served with a mesh:
    ``expected_states``, ``most_likely_states`` and ``posterior_sample(mesh=)``
    on meshes of 1 and SP_EM_SHARDS shards of the card (K32-K35), beside the
    unsharded ``parallel_scan`` calls (K13-K15): gamma against float64 within
    ``long_session``'s tolerance, paths agreeing on PATH_AGREE of the frames
    with their float64 joint log-probabilities within PATH_LP_REL_TOL, the
    draw from the same generator state agreeing on PATH_AGREE (one shard:
    equal); every call timed."""
    build, hmm = port.build, port.hmm
    data = long['data']
    par = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, parallel_scan=True,
                           device=DEVICE)
    par.params = dict(model.params)

    def gen():
        return torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    meshes = {n: port.mesh.Mesh([DEVICE] * n, ('sp',)) for n in (1, SP_EM_SHARDS)}
    reset_launches(build)
    got = {n: (model.expected_states(data, mesh=mesh), model.most_likely_states(data, mesh=mesh),
               model.posterior_sample(data, generator=gen(), mesh=mesh))
           for n, mesh in meshes.items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    ref = (par.expected_states(data), par.most_likely_states(data),
           par.posterior_sample(data, generator=gen()))
    pi0, lp, ll, m = long['chain']

    def lp64(z):
        return path_lp64(port, pi0, lp, ll, m, torch.from_numpy(z[None]).to(DEVICE)).item()
    rec = dict(phase='arhmm_sp_serve', frames=LONG_FRAMES, states=EM_STATES,
               launches={k: launches[k] for k in SP_KERNELS}, by_shards={})
    for n, (g, z, s) in got.items():
        lps = (lp64(z), lp64(ref[1]))
        rec['by_shards'][n] = dict(
            gamma_max_abs_err_vs_f64=float(np.abs(g - long['gamma64']).max()),
            gamma_tol=long['gamma_tol'], path_agreement=float(np.mean(z == ref[1])),
            path_log_prob_rel_err=abs(lps[0] - lps[1]) / abs(lps[1]),
            draw_agreement=float(np.mean(s == ref[2])), draw_equal=bool(np.array_equal(s, ref[2])),
            expected_states_ms=request_ms(lambda: model.expected_states(data, mesh=meshes[n]),
                                          reps=5),
            most_likely_states_ms=request_ms(
                lambda: model.most_likely_states(data, mesh=meshes[n]), reps=5),
            posterior_sample_ms=request_ms(
                lambda: model.posterior_sample(data, generator=gen(), mesh=meshes[n]), reps=5))
    rec['unsharded_parallel_scan_ms'] = dict(
        expected_states=request_ms(lambda: par.expected_states(data), reps=5),
        most_likely_states=request_ms(lambda: par.most_likely_states(data), reps=5),
        posterior_sample=request_ms(lambda: par.posterior_sample(data, generator=gen()), reps=5))
    emit(rec)
    missing = [k for k in SP_KERNELS if launches[k] == 0]
    bad = [n for n, v in rec['by_shards'].items()
           if v['gamma_max_abs_err_vs_f64'] > v['gamma_tol'] or v['path_agreement'] < PATH_AGREE
           or v['path_log_prob_rel_err'] > PATH_LP_REL_TOL or v['draw_agreement'] < PATH_AGREE
           or (n == 1 and not v['draw_equal'])]
    if missing or bad:
        raise AssertionError('serving with a mesh failed (missing %s, bad %s): %s'
                             % (missing, bad, rec))
    return launches


def mesh_cards(port, n):
    """``--cards n``: the mesh paths with every shard on a card of its own.
    On meshes of cards 0..n-1 ('cards') and 1..n-1, 0 ('rotated': the
    mesh's first device, where the sums are added and the M-step runs, is
    not the model's card) the EM model serves the long session
    (``expected_states``, ``most_likely_states``, ``posterior_sample(mesh=)``)
    and fits MESH_CARD_ITERS iterations in the time layout (two long
    sessions) and the trial layout (the EM workload), with and without
    ``iters_per_dispatch``; each against the same calls on a mesh that
    repeats card 0 n times (the same shards: gamma within GAMMA_ABS_TOL,
    paths and draws agreeing on PATH_AGREE of the frames, the LLs within
    SP_EM_REL_TOL; whether they are equal bit for bit is reported). An EM
    iteration timed on each mesh. The seeded 'recurrent' + 'robust_ar'
    model fits SP_REC_ITERS iterations in the trial layout on each mesh
    against its unsharded fit (``recurrent_trial_layout``: K40 and K41 on
    every card, their sums and updates on the mesh's first). The Bayesian
    decoder over the EM model decodes the long session of
    ``long_decoder_trial`` with
    ``decode(mesh=)`` on each mesh (K32-K35 and K36-K39 on every card),
    every output equal bit for bit to the one-card mesh's, each decode
    timed. Then the ARHMM CLI, which on more than one card shards EM over
    the trials (``_em_mesh``): it must say so and launch the EM kernels."""
    Mesh, build = port.mesh.Mesh, port.build
    cards = ['cuda:%d' % i for i in range(n)]
    meshes = {'one_card': [cards[0]] * n, 'cards': cards, 'rotated': cards[1:] + cards[:1]}
    model, trials, _ = em_workload(port)
    p0 = dict(model.params)
    data = sample_arhmm(1, LONG_FRAMES, EM_STATES, EM_DIM, SEED + 4, path_seed=SEED + 6)[0]
    layouts = {'time': (port.arhmm.pad_trials([data, data[::-1].copy()], DEVICE), True),
               'trials': (trials, False)}

    def fresh():
        m = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED, device=DEVICE)
        m.params = dict(p0)
        return m

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)
    got, rec = {}, dict(phase='mesh_cards', cards=n, meshes=meshes, by_mesh={})
    for name, devs in meshes.items():
        mesh = Mesh(devs, ('sp',))
        reset_launches(build)
        gen = torch.Generator(device=devs[0]).manual_seed(SEED + 17)
        served = (model.expected_states(data, mesh=mesh), model.most_likely_states(data, mesh=mesh),
                  model.posterior_sample(data, generator=gen, mesh=mesh))
        fits = {(layout, k): fresh().fit(trials_, num_iters=MESH_CARD_ITERS, mesh=mesh,
                                         shard_time=shard_time, iters_per_dispatch=k)
                for layout, (trials_, shard_time) in layouts.items() for k in (1, SP_DISPATCH)}
        sync_all()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        got[name] = served, fits
        ms = {}
        for layout, (trials_, shard_time) in layouts.items():
            m = fresh()
            ms[layout] = request_ms(lambda: (m.fit(trials_, num_iters=1, mesh=mesh,
                                                   shard_time=shard_time), sync_all()),
                                    reps=5, warmup=2)
        rec['by_mesh'][name] = dict(launches=launches, ms_per_iteration=ms)
    ref_served, ref_fits = got['one_card']
    for name in ('cards', 'rotated'):
        (g, z, d), fits = got[name]
        rec['by_mesh'][name].update(
            gamma_max_abs_err=float(np.abs(g - ref_served[0]).max()),
            path_agreement=float(np.mean(z == ref_served[1])),
            draw_agreement=float(np.mean(d == ref_served[2])),
            served_equal=[bool(np.array_equal(a, b)) for a, b in zip((g, z, d), ref_served)],
            fits={'%s_x%d' % key: dict(
                lls=lls, rel_err=max(abs(a - b) / abs(b) for a, b in zip(lls, ref_fits[key])),
                equal=lls == ref_fits[key],
                rising=all(b >= a - EM_LL_REL_TOL * abs(a) for a, b in zip(lls, lls[1:])))
                for key, lls in fits.items()})
    rec_params = dict(recurrent_models(port, model)['recurrent'].params)
    ref = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, observations='robust_ar',
                           transitions='recurrent', rng_seed=SEED, device=DEVICE)
    ref.params = dict(rec_params)
    unsharded = (ref.fit(trials, num_iters=SP_REC_ITERS), ref.params)
    for devs in meshes.values():
        recurrent_trial_layout(port, rec_params, trials, Mesh(devs, ('dp',)), unsharded)
    dec, _, y, q = long_decoder_trial(port, model)
    decoded = {}
    for name, devs in meshes.items():
        mesh = Mesh(devs, ('sp',))
        reset_launches(build)
        decoded[name] = dec.decode(y, q, mesh=mesh)
        rec['by_mesh'][name]['decode'] = dict(
            launches={k: build.LAUNCHES[k] for k in BAYES_SP_KERNELS},
            ms=request_ms(lambda: dec.decode(y, q, mesh=mesh), reps=5))
    for name in meshes:
        rec['by_mesh'][name]['decode']['equal'] = {
            key: bool(np.array_equal(val, decoded['one_card'][key]))
            for key, val in decoded[name].items()}
    with tempfile.TemporaryDirectory() as tmp:
        cli = arhmm_cli(port, tmp)
        with open(os.path.join(os.path.dirname(cli.save_dir), 'arhmm_cli.log')) as f:
            said = f.read()
    rec['cli'] = dict(sharded=('sharding EM over %d devices' % n) in said,
                      launches={k: cli.launches[k] for k in ARHMM_KERNELS})
    emit(rec)
    bad = [name for name in ('cards', 'rotated') for v in [rec['by_mesh'][name]]
           if v['gamma_max_abs_err'] > GAMMA_ABS_TOL or v['path_agreement'] < PATH_AGREE
           or v['draw_agreement'] < PATH_AGREE
           or any(f['rel_err'] > SP_EM_REL_TOL or not f['rising'] for f in v['fits'].values())]
    bad += ['%s decode' % name for name, v in rec['by_mesh'].items()
            if not all(v['decode']['equal'].values())]
    need = SP_KERNELS + ('arhmm_log_likes', 'hmm_forward_backward') + MSTEP_KERNELS
    missing = ['%s %s' % (name, k) for name, v in rec['by_mesh'].items() for k in need
               if k not in v['launches']]
    missing += ['%s decode %s' % (name, k) for name, v in rec['by_mesh'].items()
                for k, count in v['decode']['launches'].items() if count == 0]
    if bad or missing or not rec['cli']['sharded']:
        raise AssertionError('the mesh across cards failed (bad %s, missing %s): %s'
                             % (bad, missing, rec))


def arhmm_sample_serve(port, vdir, latents, kernels):
    """Main path 8c: a fitted model loads through ``load_arhmm`` and
    samples: ``posterior_sample`` of one trial (K9's forward pass writing
    the alphas, or with ``parallel_scan`` K13's forward phases; then K15)
    and, stationary, ``sample(SAMPLE_LEN)`` (K16 draws the state chain, the
    host the observations), ``kernels`` launched. The served draws are
    held against the plain versions from the same uniforms (the generator's
    state replayed): K15's path against the plain draws and composition
    from the same alphas, K16's chain against ``sample_states_plain``, each
    equal or differing only at near-ties, and the observations against
    ``sample_x`` of the plain chain from the same noise. States in range,
    observations finite, both calls timed."""
    hmm = port.hmm
    trial = latents[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    reset_launches(port.build)
    model = port.pickles.load_arhmm(os.path.join(vdir, 'best_val_model.pt'))
    post_state = gen.get_state()
    z = model.posterior_sample(trial, generator=gen)
    sample_state = gen.get_state()
    zs, xs = model.sample(SAMPLE_LEN, generator=gen)
    torch.cuda.synchronize()
    launches = dict(port.build.LAUNCHES)

    def replay(state):
        g = torch.Generator(device=DEVICE)
        g.set_state(state)
        return g
    x, mask = model.pad([trial])
    p = model.params
    pi0, lp, ll = p['log_pi0'], model._log_P(p, x), model._log_likes(p, x, mask)
    K = model.K
    g = replay(post_state)
    u_last = hmm.uniforms((1, K), g, x.device)
    u_maps = hmm.uniforms((1, TRIAL - 1, K, K), g, x.device)
    if model.parallel_scan:
        la = hmm.forward_scan_cuda(pi0, lp, ll, mask, with_alpha=True)[0]
    else:
        la = hmm.forward_alpha_cuda(pi0, lp, ll, mask)[0]
    z_last, psi = hmm.presample_path_draws_plain(la, lp, mask, u_last, u_maps)
    z_p = hmm._backtrace(psi, z_last, parallel=True)
    z_k = torch.from_numpy(z[None]).to(x.device)
    gaps = draw_gaps(hmm, la, lp, mask, u_last, u_maps, z_k, z_p)
    posterior = dict(equal=bool(torch.equal(z_k, z_p)), agreement=(z_k == z_p).float().mean()
                     .item(), max_gap=max(gaps) if gaps else 0.0)
    ok = ((posterior['equal'] or posterior['max_gap'] <= DRAW_TIE_TOL)
          and z.dtype == np.int32 and z.shape == (TRIAL,) and 0 <= z.min() and z.max() < K
          and zs.dtype == np.int32 and zs.shape == (SAMPLE_LEN,) and 0 <= zs.min()
          and zs.max() < K and xs.dtype == np.float32
          and xs.shape == (SAMPLE_LEN, model.D) and bool(np.isfinite(xs).all()))
    chain = None
    if not model.recurrent:
        lp_s = torch.log_softmax(p['log_Ps'], dim=1)
        g = replay(sample_state)
        u0 = hmm.uniforms((1, K), g, x.device)
        u = hmm.uniforms((1, SAMPLE_LEN - 1, K), g, x.device)
        zs_p = hmm.sample_states_plain(pi0, lp_s, u0, u)
        zs_k = torch.from_numpy(zs[None]).to(x.device)
        c_gaps = chain_gaps(hmm, pi0, lp_s, u0, u, zs_k, zs_p)
        xs_p = model.sample_x(zs_p[0].cpu().numpy(), generator=g)
        chain = dict(equal=bool(torch.equal(zs_k, zs_p)),
                     agreement=(zs_k == zs_p).float().mean().item(),
                     max_gap=max(c_gaps) if c_gaps else 0.0,
                     observations_equal=bool(np.array_equal(xs, xs_p)))
        ok = ok and (chain['observations_equal'] if chain['equal']
                     else chain['max_gap'] <= DRAW_TIE_TOL)
    lp64 = path_lp64(port, pi0, lp, ll, mask, z_k).item()
    rec = dict(phase='arhmm_sample_serve', transitions=model.transitions,
               observations=model.observations, states=K, frames=TRIAL,
               parallel_scan=model.parallel_scan, sample_len=SAMPLE_LEN, ok=bool(ok),
               posterior_vs_plain=posterior, chain_vs_plain=chain, tie_tol=DRAW_TIE_TOL,
               posterior_path_log_prob=lp64, sampled_states_used=int(len(np.unique(zs))),
               launches=launches,
               posterior_sample_ms=request_ms(lambda: model.posterior_sample(trial,
                                                                             generator=gen)),
               sample_ms=request_ms(lambda: model.sample(SAMPLE_LEN, generator=gen), reps=3))
    emit(rec)
    missing = [k for k in kernels if launches[k] == 0]
    if missing or not ok or not np.isfinite(lp64):
        raise AssertionError('the fitted ARHMM does not sample (missing %s): %s'
                             % (missing, rec))
    return launches


# ------------------------------------------------------ the Bayesian decoder


def decoder_trial(port, K, lags, frames, seed, bucket=None):
    """A decoder and one trial as ``decode`` sees them: a seeded stationary
    ARHMM with K states over the published 9 latents (AR weights ``0.9 /
    lags`` times random rotations, offsets of scale 0.3, noise covariances
    ~0.01), its decoder with R = 0.25 I, and a trial from ``sample_arhmm``
    observed through predictions with noise 0.5 and NaN in the decoders'
    ``n_max_lags`` frames at each end, NaN-padded to ``bucket`` frames.
    Returns (decoder, y with NaN rows set to 0, the observed mask, gamma
    from the discrete pass (K9)) on the card."""
    D = DEC_LATENTS
    rs = np.random.RandomState(seed)
    model = port.arhmm.ARHMM(K, D, lags=lags, rng_seed=seed, device=DEVICE)
    rot = np.linalg.qr(rs.randn(K * lags, D, D))[0].reshape(K, lags, D, D)
    m = rs.randn(K, D, D)
    P = 0.9 * np.eye(K) + 0.1 * rs.dirichlet(np.ones(K), size=K)
    params = {k: v.cpu().numpy() for k, v in model.params.items()}
    params.update(As=(0.9 / lags) * np.concatenate(list(rot.transpose(1, 0, 2, 3)), axis=2),
                  bs=0.3 * rs.randn(K, D), log_Ps=np.log(P),
                  Sigmas=0.002 * m @ m.transpose(0, 2, 1) + 0.01 * np.eye(D))
    model.params = model._tensors(params)
    dec = port.bayesian.BayesianDecoder(model, obs_noise=0.25 * np.eye(D))
    x = sample_arhmm(1, frames, 8, D, seed + 1)[0]
    y = x + 0.5 * rs.randn(frames, D).astype(np.float32)
    y[:DEC_HP['n_max_lags']] = y[frames - DEC_HP['n_max_lags']:] = np.nan
    T = bucket or frames
    y = np.concatenate([y, np.full((T - frames, D), np.nan, np.float32)])
    q = np.asarray(torch.softmax(torch.from_numpy(rs.randn(T, K)), dim=1), np.float32)
    q[np.isnan(y).any(axis=1)] = np.nan
    gamma = dec.decode(y, q, as_numpy=False)['states_posterior']
    m = torch.from_numpy((~np.isnan(y).any(axis=1)).astype(np.float32)).to(DEVICE)
    y0 = torch.from_numpy(np.nan_to_num(y)).to(DEVICE)
    return dec, y0, m, gamma


def imm_inputs(port, K, lags, frames, seed, bucket=None):
    """The inputs of K17 and K18 as ``decode`` forms them for one trial of
    :func:`decoder_trial`."""
    dec, y0, m, gamma = decoder_trial(port, K, lags, frames, seed, bucket)
    As, bs, Qs = dec._aug_dynamics()
    mu0, Sigma0 = dec._init_moments(y0, gamma)
    return (y0, m, gamma, As, bs, Qs, dec.R, mu0, Sigma0)


def imm_bounds(T, D, K, n, observed):
    """(operations, bytes) of K17 and of K18 on one trial: the function's
    own work (multiply-adds as two operations; a Gauss-Jordan pivot, as
    JAX's ``solve_small`` computes it, one division an entry of the pivot
    row and a multiply and a subtract an entry of the tile), each input
    read once, each output written once; the predict on the T - 1 later
    steps, the update only on the ``observed`` frames."""
    filt_ops = (T - 1) * (4 * K * n ** 3 + 8 * K * n ** 2) + \
        observed * (D * (2 * D + 1) * (D + n) + 2 * n ** 3 + 2 * n * D)
    filt_bytes = 4 * (T * (D + 1 + K) + 2 * K * n * n + K * n + D * D + n + n * n +
                      (2 * T - 1) * (n + n * n))
    smooth_ops = (T - 1) * (2 * K * n * n + 6 * n ** 3 + 6 * n * n + n * (2 * n + 1) * 2 * n)
    smooth_bytes = 4 * ((3 * T - 1) * (n + n * n) + T * K + K * n * n)
    return (filt_ops, filt_bytes), (smooth_ops, smooth_bytes)


def imm_errors(got, want):
    """Max |got - want| over the outputs, each relative to max(1, its max
    |want|)."""
    return max(((g.double() - w.double()).abs().max() / max(1.0, w.abs().max().item()))
               .item() for g, w in zip(got, want))


def check_imm(port):
    """K17 and K18 against their plain versions on the card (the smoother
    on the plain filter's moments), each case filter alone (``smooth``
    off) and filter + smoother (on): the CLI's shape (a 189-frame trial in
    the 192-frame bucket, K = 4, 9 latents, lags 1), lags 2 (n = 18, the
    shift block) and K = 12 (the published ARHMM grid's largest); then one
    IMM_LONG-frame trial, K17 then K18, against the plain versions in
    float64 on the host (on the card, a launch-bound chain of small ops,
    they took longer): within twice the float32 plain version's own
    distance."""
    imm = port.imm
    rows = {'imm_filter': {}, 'rts_smoother': {}}
    for name, (K, lags) in IMM_CASES.items():
        ins = imm_inputs(port, K, lags, TRIAL, SEED + 20, bucket=BUCKET)
        n = ins[3].shape[-1]
        f_k, f_p = imm.imm_filter_cuda(*ins), imm.imm_filter_plain(*ins)
        s_k = imm.rts_smoother_cuda(*f_p, ins[2], ins[3])
        s_p = imm.rts_smoother_plain(*f_p, ins[2], ins[3])
        torch.cuda.synchronize()
        observed = int(ins[1].sum().item())
        bounds = imm_bounds(BUCKET, DEC_LATENTS, K, n, observed)
        for kernel, err, fn, plain, (n_ops, n_bytes) in (
                ('imm_filter', imm_errors(f_k, f_p), lambda: imm.imm_filter_cuda(*ins),
                 lambda: imm.imm_filter_plain(*ins), bounds[0]),
                ('rts_smoother', imm_errors(s_k, s_p),
                 lambda: imm.rts_smoother_cuda(*f_p, ins[2], ins[3]),
                 lambda: imm.rts_smoother_plain(*f_p, ins[2], ins[3]), bounds[1])):
            ms = median_ms(fn)
            rows[kernel][name] = dict(
                frames=BUCKET, observed=observed, states=K, lags=lags, n=n, max_abs_err=err,
                finite=all(bool(torch.isfinite(t).all().item())
                           for t in (f_k if kernel == 'imm_filter' else s_k)),
                ms=ms, us_per_step=ms * 1e3 / BUCKET,
                plain_ms=median_ms(plain, samples=3, inner=1, warmup=1),
                gflop=n_ops / 1e9, mbytes=n_bytes / 1e6, **bound(n_ops, n_bytes))

    ins = [t.cpu() for t in imm_inputs(port, BAYES_STATES, 1, IMM_LONG, SEED + 21)]
    dev_ins = [t.to(DEVICE) for t in ins]
    t0 = time.perf_counter()
    f_k = imm.imm_filter_cuda(*dev_ins)
    s_k = imm.rts_smoother_cuda(*f_k, dev_ins[2], dev_ins[3])
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32 = imm.imm_filter_plain(*ins)
    s32 = imm.rts_smoother_plain(*f32, ins[2], ins[3])
    f64 = imm.imm_filter_plain(*ins, dtype=torch.float64)
    s64 = imm.rts_smoother_plain(*f64, ins[2], ins[3], dtype=torch.float64)
    reference_s = time.perf_counter() - t0
    long = {}
    for kernel, got, p32, p64 in (('imm_filter', f_k, f32, f64),
                                  ('rts_smoother', s_k, s32, s64)):
        k_err = imm_errors([t.cpu() for t in got], p64)
        p_err = imm_errors(p32, p64)
        long[kernel] = dict(frames=IMM_LONG, kernel_vs_float64=k_err, plain32_vs_float64=p_err,
                            tol=2 * p_err,
                            finite=all(bool(torch.isfinite(t).all().item()) for t in got))
    out = []
    for kernel, cases in rows.items():
        first = cases['cli']
        rec = dict(phase='bayesian_kernel_check', kernel=kernel, layer='cli', library_ms=None,
                   rel_tol=IMM_REL_TOL, cases=cases, long_trial=long[kernel],
                   long_trial_kernels_s=kernel_s, long_trial_references_s=reference_s,
                   bound_note='the T-step dependence chain, not these',
                   **{k: first[k] for k in ('frames', 'max_abs_err', 'ms', 'plain_ms',
                                            'bound_ms', 't_ops_ms', 't_bytes_ms', 'bound_by')})
        emit(rec)
        bad = [c for c, v in cases.items() if not v['finite'] or v['max_abs_err'] > IMM_REL_TOL]
        lg = long[kernel]
        if bad or not lg['finite'] or lg['kernel_vs_float64'] > lg['tol']:
            raise AssertionError('%s disagrees with its plain version (%s): %s'
                                 % (kernel, bad, rec))
        out.append(rec)
    return out


def general_lds(T, n, d, seed):
    """(F, c, Q, H, R, y, mask, m0, P0) on the card: the JAX package's
    Kalman tests' ``make_system`` (tests/test_ops/test_kalman.py:10; a
    time-varying F, a general H) at n states and d observations, a quarter
    of the steps and the first and last three unobserved."""
    rs = np.random.RandomState(seed)
    F = np.stack([np.eye(n) * 0.8 + 0.05 * rs.randn(n, n) for _ in range(T)])
    c = 0.1 * rs.randn(T, n)
    Q = np.tile(0.05 * np.eye(n), (T, 1, 1))
    H = rs.randn(d, n)
    R = 0.1 * np.eye(d)
    m0 = rs.randn(n)
    x = np.zeros((T, n))
    prev = m0
    for t in range(T):
        x[t] = F[t] @ prev + c[t] + rs.multivariate_normal(np.zeros(n), Q[t])
        prev = x[t]
    y = x @ H.T + rs.multivariate_normal(np.zeros(d), R, size=T)
    mask = (rs.rand(T) >= 0.25).astype(np.float32)
    mask[:3] = mask[T - 3:] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in (F, c, Q, H, R, y, mask, m0, np.eye(n)))


def soft_lds(port, K, lags, frames, seed, bucket=None):
    """(F, c, Q, H, R, y, mask, m0, P0) as ``decode(parallel=True)`` hands
    them to K19 for a :func:`decoder_trial`: the gamma-weighted dynamics."""
    dec, y0, m, gamma = decoder_trial(port, K, lags, frames, seed, bucket)
    F, c, Q, mu0, Sigma0 = dec._soft_dynamics(y0, gamma)
    return F, c, Q, dec._H, dec.R, y0, m, mu0, Sigma0


def kalman_bounds(T, d, n, observed):
    """(operations, bytes) of the sequential filter and of the sequential
    smoother (JAX's filter_sequential and smooth_sequential) on one trial:
    multiply-adds as two operations, a Gauss-Jordan pivot as imm_bounds
    counts it (d(2d+1)(d+n) a solve of S, n(2n+1)2n of P_pred + 1e-8 I), the
    update only on the ``observed`` steps, each input read once and each
    output written once. K19 and K20 are held to the same work (their own
    inputs and outputs); K21 also writes the predictions."""
    predict = 2 * n * n + n + 4 * n ** 3 + n * n + 2 * n * n   # F m + c; sym(F P F^T + Q)
    update = (2 * d * n * n + 2 * d * d * n + d * d             # H P, S = (H P) H^T + R
              + d * (2 * d + 1) * (d + n)                       # K^T = S^-1 H P
              + 2 * d * n + d + 2 * n * d + n                   # m + K (y - H m)
              + 2 * n * n * d + n * n + 2 * n * n)              # sym(P - K (H P))
    smooth = (2 * n ** 3 + n * n                                # F P_f, P_pred + 1e-8 I
              + n * (2 * n + 1) * (2 * n)                       # G^T = solve(., F P_f)
              + n + 2 * n * n + n                               # m_f + G (m_next - m_pred)
              + n * n + 4 * n ** 3 + n * n + 2 * n * n)         # sym(P_f + G D G^T)
    filt_ops = T * predict + observed * update
    smooth_ops = (T - 1) * smooth
    inputs = T * (2 * n * n + n + d + 1) + d * n + d * d + n + n * n
    moments = T * (n + n * n)
    return dict(filter_scan=(filt_ops, 4 * (inputs + moments)),
                filter=(filt_ops, 4 * (inputs + 2 * moments)),
                smoother_scan=(smooth_ops, 4 * (T * (2 * n * n + n) + 2 * moments)),
                smoother=(smooth_ops, 4 * (T * n * n + 3 * moments)))


def check_kalman(port):
    """K19-K22 against their plain versions on the card at KALMAN_CASES (the
    smoothers on their plain filters' moments), K19 / K20 against K21 /
    K22 (each filter, then its smoother), and every one against the
    float64 sequential versions on the host; then one IMM_LONG-frame
    trial, K19 and K20 at KALMAN_CHUNKS against the plain parallel
    versions in float64 on the card (float64 roundoff from the sequential
    ones, which took ~25 s on the host) within twice the float32 plain
    parallel version's distance; then K11's pivoting launcher
    (check_solve_pivot)."""
    kal = port.kalman
    rows = {k: {} for k in ('kalman_filter_scan', 'kalman_smoother_scan', 'kalman_filter',
                            'kalman_smoother')}
    cross = {}
    for case in KALMAN_CASES:
        if case == 'general':
            ins = general_lds(BUCKET, DEC_LATENTS, 5, SEED + 23)
        else:
            ins = soft_lds(port, BAYES_STATES, 2 if case == 'lags2' else 1, TRIAL, SEED + 20,
                           bucket=BUCKET)
        F, c, Q = ins[:3]
        host = [t.cpu() for t in ins]
        seq64 = kal.filter_sequential_plain(*host, dtype=torch.float64)
        sseq64 = kal.smooth_sequential_plain(*host[:3], *seq64, dtype=torch.float64)
        seq_p, par_p = kal.filter_sequential_plain(*ins), kal.filter_parallel_plain(*ins)
        sseq_p = kal.smooth_sequential_plain(F, c, Q, *seq_p)
        spar_p = kal.smooth_parallel_plain(F, c, Q, *par_p)
        k19, k21 = kal.filter_parallel_cuda(*ins), kal.filter_sequential_cuda(*ins)
        k20 = kal.smooth_parallel_cuda(F, c, Q, *par_p)
        k22 = kal.smooth_sequential_cuda(F, c, Q, *seq_p)
        cross[case] = dict(
            filter=imm_errors(k19, k21[:2]),
            smoother=imm_errors(kal.smooth_parallel_cuda(F, c, Q, *k19),
                                kal.smooth_sequential_cuda(F, c, Q, *k21)))
        torch.cuda.synchronize()
        n, d = F.shape[-1], ins[5].shape[-1]
        observed = int(ins[6].sum().item())
        bounds = kalman_bounds(BUCKET, d, n, observed)

        def host_err(got, want):
            return imm_errors([t.cpu() for t in got], want)
        for kernel, got, plain, f64, fn, plain_fn, work in (
                ('kalman_filter_scan', k19, par_p, seq64[:2],
                 lambda: kal.filter_parallel_cuda(*ins), lambda: kal.filter_parallel_plain(*ins),
                 bounds['filter_scan']),
                ('kalman_smoother_scan', k20, spar_p, sseq64,
                 lambda: kal.smooth_parallel_cuda(F, c, Q, *par_p),
                 lambda: kal.smooth_parallel_plain(F, c, Q, *par_p), bounds['smoother_scan']),
                ('kalman_filter', k21, seq_p, seq64, lambda: kal.filter_sequential_cuda(*ins),
                 lambda: kal.filter_sequential_plain(*ins), bounds['filter']),
                ('kalman_smoother', k22, sseq_p, sseq64,
                 lambda: kal.smooth_sequential_cuda(F, c, Q, *seq_p),
                 lambda: kal.smooth_sequential_plain(F, c, Q, *seq_p), bounds['smoother'])):
            plain_f64 = host_err(plain, f64)
            ms = median_ms(fn)
            rows[kernel][case] = dict(
                frames=BUCKET, observed=observed, n=n, d=d,
                max_abs_err=imm_errors(got, plain), vs_float64=host_err(got, f64),
                plain_vs_float64=plain_f64,
                tol_plain=max(KALMAN_REL_TOL, 3 * plain_f64),
                tol_float64=max(KALMAN_REL_TOL, 2 * plain_f64),
                finite=all(bool(torch.isfinite(t).all().item()) for t in got),
                ms=ms, us_per_step=ms * 1e3 / BUCKET,
                plain_ms=median_ms(plain_fn, samples=3, inner=1, warmup=1),
                gflop=work[0] / 1e9, mbytes=work[1] / 1e6, **bound(*work))

    ins = soft_lds(port, BAYES_STATES, 1, IMM_LONG, SEED + 21)
    F, c, Q = ins[:3]
    chunk = 8192 if IMM_LONG > 8192 else None   # decode's, JAX's chunked branch
    filt64 = kal.filter_parallel_plain(*ins, chunk=chunk, dtype=torch.float64)
    smooth64 = kal.smooth_parallel_plain(F, c, Q, *filt64, chunk=chunk, dtype=torch.float64)
    par_p = kal.filter_parallel_plain(*ins, chunk=chunk)
    spar_p = kal.smooth_parallel_plain(F, c, Q, *par_p, chunk=chunk)
    long = {'kalman_filter_scan': dict(plain32_vs_float64=imm_errors(par_p, filt64)),
            'kalman_smoother_scan': dict(plain32_vs_float64=imm_errors(spar_p, smooth64))}
    for kernel in long:
        long[kernel].update(frames=IMM_LONG, tol=2 * long[kernel]['plain32_vs_float64'],
                            plain_chunk=chunk, chunks={}, finite=True)
    for L in KALMAN_CHUNKS:
        k19 = kal.filter_parallel_cuda(*ins, chunk=L)
        k20 = kal.smooth_parallel_cuda(F, c, Q, *k19, chunk=L)
        key = str(L) if L else 'scan_chunk=%d' % port.hmm.scan_chunk(IMM_LONG)
        for kernel, got, want, fn in (
                ('kalman_filter_scan', k19, filt64,
                 lambda: kal.filter_parallel_cuda(*ins, chunk=L)),
                ('kalman_smoother_scan', k20, smooth64,
                 lambda: kal.smooth_parallel_cuda(F, c, Q, *k19, chunk=L))):
            long[kernel]['chunks'][key] = dict(
                vs_float64=imm_errors(got, want),
                ms=median_ms(fn, samples=3, inner=3))
            long[kernel]['finite'] &= all(bool(torch.isfinite(t).all().item()) for t in got)

    out = []
    for kernel, cases in rows.items():
        first = cases['cli']
        rec = dict(phase='kalman_kernel_check', kernel=kernel, layer='cli', library_ms=None,
                   rel_tol=KALMAN_REL_TOL, cases=cases,
                   kernel_vs_sequential_kernel=cross if kernel.endswith('_scan') else None,
                   long_trial=long.get(kernel),
                   bound_note='the dependence chains, not these',
                   **{k: first[k] for k in ('frames', 'max_abs_err', 'ms', 'plain_ms',
                                            'bound_ms', 't_ops_ms', 't_bytes_ms', 'bound_by')})
        emit(rec)
        bad = [c for c, v in cases.items() if not v['finite'] or
               v['max_abs_err'] > v['tol_plain'] or v['vs_float64'] > v['tol_float64']]
        if kernel.endswith('_scan'):
            which = 'filter' if kernel == 'kalman_filter_scan' else 'smoother'
            bad += ['%s vs sequential kernel' % c for c, v in cross.items()
                    if v[which] > max(rows[kernel][c]['tol_plain'], 2 * rows[kernel][c]
                                      ['tol_float64'])]
            lg = long[kernel]
            bad += ['long chunk %s' % L for L, v in lg['chunks'].items()
                    if v['vs_float64'] > lg['tol']]
            if not lg['finite']:
                bad.append('long not finite')
        if bad:
            raise AssertionError('%s disagrees (%s): %s' % (kernel, bad, rec))
        out.append(rec)
    out.append(check_solve_pivot(port))
    return out


def check_solve_pivot(port):
    """K11's pivoting launcher against ``solve_small_plain(pivot=True)`` at
    the associative filter's combine matrices I + C1 J2 with the identity on
    the right (adjacent elements of the CLI case, n = 9; of a general LDS
    at n = 16, K11's widest), within SOLVE_REL_TOL of max(1, max|plain|),
    and on the same with rows 0 and 1 swapped and a zero leading pivot,
    where the unpivoted elimination (K11's other launcher) gives non-finite
    output; the time beside ``torch.linalg.solve``'s."""
    sm, kal = port.smallmat, port.kalman
    cases = {}
    for name, ins in (('cli', soft_lds(port, BAYES_STATES, 1, TRIAL, SEED + 20, bucket=BUCKET)),
                      ('n16', general_lds(BUCKET, 16, 5, SEED + 26))):
        _, _, C, _, J = kal._filter_elements(*ins)
        n = C.shape[-1]
        eye = torch.eye(n, device=DEVICE)
        lhs = eye + C[:-1] @ J[1:]
        rhs = eye.expand(lhs.shape).contiguous()
        # rows 0 and 1 swapped, the new leading entry set to 0: still
        # nonsingular (the swapped identity of an unobserved step's I + C1 J2
        # already has it), but without a pivot at (0, 0)
        order = torch.arange(n, device=DEVICE)
        order[:2] = torch.tensor([1, 0], device=DEVICE)
        zero = lhs[:, order].clone()
        zero[:, 0, 0] = 0.0
        got, want = sm.solve_small_cuda(lhs, rhs, pivot=True), sm.solve_small_plain(lhs, rhs,
                                                                                   pivot=True)
        got0, want0 = sm.solve_small_cuda(zero, rhs, pivot=True), sm.solve_small_plain(
            zero, rhs, pivot=True)
        unpivoted = sm.solve_small_cuda(zero, rhs)
        torch.cuda.synchronize()
        B = lhs.shape[0]
        n_ops = B * n * (2 * n + 1) * (2 * n)
        n_bytes = 4 * B * 3 * n * n
        with tf32_off():
            lib = median_ms(lambda: torch.linalg.solve(lhs, rhs))
        cases[name] = dict(
            systems=B, n=n, max_abs_err=imm_errors([got], [want]),
            zero_pivot_err=imm_errors([got0], [want0]),
            zero_pivot_finite=bool(torch.isfinite(got0).all().item()),
            unpivoted_finite=bool(torch.isfinite(unpivoted).all().item()),
            ms=median_ms(lambda: sm.solve_small_cuda(lhs, rhs, pivot=True)),
            plain_ms=median_ms(lambda: sm.solve_small_plain(lhs, rhs, pivot=True), samples=3,
                               inner=1, warmup=1),
            library_ms=lib, **bound(n_ops, n_bytes))
    first = cases['cli']
    rec = dict(phase='solve_pivot_check', kernel='solve_small_pivot', layer='cli', frames=BUCKET,
               rel_tol=SOLVE_REL_TOL, cases=cases,
               **{k: first[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'library_ms',
                                        'bound_ms', 't_ops_ms', 't_bytes_ms', 'bound_by')})
    emit(rec)
    bad = [c for c, v in cases.items() if v['max_abs_err'] > SOLVE_REL_TOL or
           v['zero_pivot_err'] > SOLVE_REL_TOL or not v['zero_pivot_finite'] or
           v['unpivoted_finite']]
    if bad:
        raise AssertionError('solve_small_pivot disagrees (%s): %s' % (bad, rec))
    return rec


def kalman_ops(port):
    """Main path 15: the public ``ops.kalman`` and ``ops.smallmat`` API on
    the card, as a user filters and smooths a general LDS (general_lds at
    n = 9, d = 5, the 192-frame bucket): ``filter_sequential`` then
    ``smooth_sequential`` (K21, K22), ``filter_parallel`` then
    ``smooth_parallel`` (K19, K20), the two within max(KALMAN_REL_TOL, twice
    the plain parallel version's distance from the plain sequential one) of
    each other, and ``solve_small(pivot=True)`` (K11's pivoting launcher) of
    the combine's systems. Every output finite, every kernel launched."""
    kal, sm = port.kalman, port.smallmat
    ins = general_lds(BUCKET, DEC_LATENTS, 5, SEED + 23)
    F, c, Q = ins[:3]
    _, _, C, _, J = kal._filter_elements(*ins)
    eye = torch.eye(C.shape[-1], device=DEVICE)
    lhs = eye + C[:-1] @ J[1:]
    rhs = eye.expand(lhs.shape).contiguous()
    reset_launches(port.build)
    seq = kal.filter_sequential(*ins)
    sseq = kal.smooth_sequential(F, c, Q, *seq)
    par = kal.filter_parallel(*ins)
    spar = kal.smooth_parallel(F, c, Q, *par)
    X = sm.solve_small(lhs, rhs, pivot=True)
    torch.cuda.synchronize()
    launches = dict(port.build.LAUNCHES)
    seq_p = kal.filter_sequential_plain(*ins)
    par_p = kal.filter_parallel_plain(*ins)
    tol = max(KALMAN_REL_TOL, 2 * max(imm_errors(par_p, seq_p[:2]), imm_errors(
        kal.smooth_parallel_plain(F, c, Q, *par_p),
        kal.smooth_sequential_plain(F, c, Q, *seq_p))))
    errs = dict(filter=imm_errors(par, seq[:2]), smoother=imm_errors(spar, sseq),
                solve_residual=(lhs @ X - rhs).abs().max().item())
    finite = all(bool(torch.isfinite(t).all().item()) for t in (*seq, *sseq, *par, *spar, X))
    rec = dict(phase='kalman_ops', frames=BUCKET, n=F.shape[-1], d=ins[5].shape[-1],
               parallel_vs_sequential=errs, tol=tol, finite=finite, launches=launches)
    emit(rec)
    missing = [k for k in KALMAN_OPS_KERNELS if launches[k] == 0]
    if missing or not finite or errs['filter'] > tol or errs['smoother'] > tol or \
            errs['solve_residual'] > 1e-3:
        raise AssertionError('the public Kalman ops fail (missing %s): %s' % (missing, rec))
    return launches


@contextlib.contextmanager
def plain_bayesian(port):
    """The Bayesian decoder's plain twin: the ARHMM's kernel entry points
    (``plain_arhmm``), K17 / K18 and the public ``ops.kalman`` functions
    (K19-K22) routed to their plain versions."""
    imm, kal = port.imm, port.kalman
    routes = ((imm, 'imm_filter', imm.imm_filter_plain),
              (imm, 'rts_smoother', imm.rts_smoother_plain),
              (kal, 'filter_parallel', kal.filter_parallel_plain),
              (kal, 'smooth_parallel', kal.smooth_parallel_plain),
              (kal, 'filter_sequential', kal.filter_sequential_plain),
              (kal, 'smooth_sequential', kal.smooth_sequential_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    for mod, name, fn in routes:
        setattr(mod, name, fn)
    try:
        with plain_arhmm(port):
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def write_decoder_store(save_dir, ids, mc, parts, training_cfg, predictions):
    """A decoder's completed version holding a predictions pickle in the
    decoders' export format (``fitting.eval.export_predictions``)."""
    vdir = os.path.join(save_dir, *ids, mc, *parts, 'all', 'grid_search', 'version_0')
    os.makedirs(vdir)
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump({'rng_seed_data': training_cfg['rng_seed_data'],
                     'trial_splits': training_cfg['trial_splits'],
                     'training_completed': True}, f)
    with open(os.path.join(vdir, 'metrics.csv'), 'w', newline='') as f:
        csv.writer(f).writerows([['epoch', 'val_loss'], [0, 1.0]])
    trs = [int(v) for v in training_cfg['trial_splits'].split(';')]
    from behavenet_tpu_torch.data.generator import split_trials
    with open(os.path.join(vdir, '%s_predictions.pkl' % '_'.join(ids)), 'wb') as f:
        pickle.dump({'predictions': predictions,
                     'trials': split_trials(len(predictions), training_cfg['rng_seed_data'],
                                            *trs)}, f)


def decoder_exports(latents, states, K, seed):
    """What the two neural decoders would export for the CLI's trials: the
    latents plus seeded noise (0.5) and state logits (2 on the ARHMM's state,
    plus unit noise), NaN in the ``n_max_lags`` frames at each end."""
    rs = np.random.RandomState(seed)
    lag = DEC_HP['n_max_lags']
    preds, logits = [], []
    for x, z in zip(latents, states):
        p = (x + 0.5 * rs.randn(*x.shape)).astype(np.float32)
        g = (2.0 * np.eye(K)[z] + rs.randn(len(z), K)).astype(np.float32)
        for a in (p, g):
            a[:lag] = a[len(a) - lag:] = np.nan
        preds.append(p)
        logits.append(g)
    return preds, logits


def bayesian_cli(port, tmp, cli, kernels, name='bayesian_cli', parallel=False):
    """Main path 13: the port's ``bayesian_decoder_grid_search`` on the card
    at the published config (configs/bayesian_jsons, the compute config's
    device dropped) over the ARHMM CLI's store ``cli``: its AE latents, its
    K = BAYES_STATES version's ``best_val_model.pt`` and states pickle, and
    the two decoders' predictions written here (by the first call). With
    ``parallel`` (main path 13b) the model config says ``"parallel_scan":
    true`` and the experiment is named apart. ``kernels`` launched inside
    it, every exported trial finite and of its trial's length, the decoded
    test MSE below the raw predictions' on the same frames. Returns the
    launches and the predictions."""
    vdir, latents, store, ids = cli.vdirs[BAYES_STATES], cli.latents, cli.save_dir, CLI_IDS

    def load(cfg):
        with open(os.path.join(BAYES_CONFIGS, 'bayesian_%s.json' % cfg)) as f:
            return json.load(f)
    data_cfg, model_cfg, training_cfg, compute_cfg = (
        load(c) for c in ('data', 'model', 'training', 'compute'))
    compute_cfg.pop('device')
    data_cfg.update(dict(zip(('lab', 'expt', 'animal', 'session'), ids)), save_dir=store,
                    data_dir=os.path.join(tmp, 'bayes_data'))
    if parallel:
        model_cfg.update(parallel_scan=True,
                         experiment_name=model_cfg['experiment_name'] + '-parallel')
    with open(os.path.join(vdir, '%s_states.pkl' % '_'.join(ids)), 'rb') as f:
        states = pickle.load(f)['states']
    preds, logits = decoder_exports(latents, states, BAYES_STATES, SEED + 22)
    D = model_cfg['n_ae_latents']
    if not os.path.isdir(os.path.join(store, *ids, 'neural-ae')):
        write_decoder_store(store, ids, 'neural-ae', ['%02i_latents' % D, 'mlp'], training_cfg,
                            preds)
        write_decoder_store(store, ids, 'neural-arhmm',
                            ['%02i_latents' % D, '%02i_states' % BAYES_STATES,
                             model_cfg['transitions'], 'mlp'], training_cfg, logits)
    args = []
    for cfg_name, cfg in (('data', data_cfg), ('model', model_cfg), ('training', training_cfg),
                          ('compute', compute_cfg)):
        path = os.path.join(tmp, '%s_%s.json' % (name, cfg_name))
        with open(path, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % cfg_name, path]

    seconds = []

    def timed_main(hp):
        t0 = time.perf_counter()
        port.bayesian_decoder_grid_search.main(hp)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    reset_launches(port.build)
    with open(os.path.join(tmp, '%s.log' % name), 'w') as log, \
            contextlib.redirect_stdout(log):
        port.hyperparams.run_grid_search(timed_main, port.hyperparams.get_all_params(
            'grid_search', args))
    launches = dict(port.build.LAUNCHES)

    out_dir = os.path.join(store, *ids, model_cfg['model_class'], '%02i_latents' % D,
                           '%02i_states' % BAYES_STATES, model_cfg['transitions'],
                           model_cfg['noise_type'], 'all', model_cfg['experiment_name'],
                           'version_0')
    logged = read_metrics(out_dir)
    with open(os.path.join(out_dir, '%s_latents.pkl' % '_'.join(ids)), 'rb') as f:
        exported = pickle.load(f)
    with open(os.path.join(out_dir, '%s_states.pkl' % '_'.join(ids)), 'rb') as f:
        dec_states = pickle.load(f)['states']
    with open(os.path.join(out_dir, 'meta_tags.pkl'), 'rb') as f:
        completed = pickle.load(f)['training_completed']
    decoded = exported['latents']
    ok_shapes = all(z.shape == x.shape and np.isfinite(z).all() and s.shape == (len(x),)
                    and 0 <= s.min() and s.max() < BAYES_STATES
                    for z, s, x in zip(decoded, dec_states, latents))
    test = [int(i) for i in exported['trials']['test']]
    raw_se, dec_se = [], []
    for i in test:
        good = np.isfinite(preds[i]).all(axis=1)
        raw_se.append(((preds[i] - latents[i])[good] ** 2).ravel())
        dec_se.append(((decoded[i] - latents[i])[good] ** 2).ravel())
    raw_mse = float(np.mean(np.concatenate(raw_se)))
    dec_mse = float(np.mean(np.concatenate(dec_se)))
    missing = [k for k in kernels if launches[k] == 0]
    rec = dict(phase=name, trials=len(latents), frames_per_trial=TRIAL, states=BAYES_STATES,
               dim=D, parallel_scan=parallel, seconds_per_session=seconds, completed=completed, exports_ok=ok_shapes,
               test_trials=test, raw_test_mse=raw_mse, decoded_test_mse=dec_mse,
               logged={k: v for k, v in logged.items() if len(v)}, launches=launches)
    emit(rec)
    finite = all(np.isfinite(v).all() for v in logged.values() if len(v))
    if missing or not completed or not ok_shapes or not finite or not dec_mse < raw_mse:
        raise AssertionError('the Bayesian decoder CLI failed (missing %s): %s'
                             % (missing, rec))
    return launches, preds, logits


def bayesian_serve(port, vdir, latents, preds, logits, kernels, name='bayesian_serve',
                   parallel=False):
    """Main path 14: a fitted ``best_val_model.pt`` loads through
    ``load_arhmm`` on the card into a ``BayesianDecoder`` (R from the first
    40 trials' residuals), which decodes one 189-frame trial, with
    ``parallel`` (main path 14b) through ``decode(parallel=True)``:
    ``kernels`` launched, latents and covariances within BAYES_ABS_TOL of
    the plain twin's on the card (K9-K10 or K13-K14 and K17-K18 or K19-K20
    routed to their plain versions), states equal; latency with ``smooth``
    on and off beside the plain twin's, and a profile with the device's
    idle share."""
    model = port.pickles.load_arhmm(os.path.join(vdir, 'best_val_model.pt'))
    dec = port.bayesian.BayesianDecoder(model)
    dec.estimate_obs_noise(latents[:40], preds[:40])
    softmax = port.bayesian_decoder_grid_search._softmax_rows
    i = len(latents) - 1
    y, q = preds[i], softmax(logits[i])
    reset_launches(port.build)
    out = dec.decode(y, q, parallel=parallel)
    torch.cuda.synchronize()
    launches = dict(port.build.LAUNCHES)
    with plain_bayesian(port):
        out_p = dec.decode(y, q, parallel=parallel)
        plain_lat = {smooth: request_ms(lambda: dec.decode(y, q, smooth=smooth,
                                                           parallel=parallel), reps=3,
                                        warmup=1) for smooth in (True, False)}
    errs = {k: float(np.abs(out[k] - out_p[k]).max() / max(1.0, np.abs(out_p[k]).max()))
            for k in ('latents', 'latents_cov', 'states_posterior')}
    equal = bool(np.array_equal(out['states'], out_p['states']))
    rec = dict(phase=name, states=model.K, frames=len(y), parallel_scan=model.parallel_scan,
               parallel=parallel, device=str(dec.device), rel_errs=errs, states_equal=equal,
               abs_tol=BAYES_ABS_TOL, launches=launches,
               decode_ms={smooth: request_ms(lambda: dec.decode(y, q, smooth=smooth,
                                                                parallel=parallel))
                          for smooth in (True, False)},
               plain_decode_ms=plain_lat,
               raw_mse=float(np.nanmean((y - latents[i]) ** 2)),
               decoded_mse=float(np.mean((out['latents'] - latents[i]) ** 2)))
    emit(rec)
    emit(profile_steps(lambda: dec.decode(y, q, parallel=parallel), phase=name + '_profile',
                       frames=len(y), bucket=len(y), states=model.K,
                       parallel_scan=model.parallel_scan, parallel=parallel))
    missing = [k for k in kernels if launches[k] == 0]
    if missing or not equal or max(errs.values()) > BAYES_ABS_TOL or \
            not np.isfinite(out['latents']).all():
        raise AssertionError('the Bayesian decoder does not serve (missing %s): %s'
                             % (missing, rec))
    return launches


def bayesian_long_session(port, model):
    """Main path 14c: one LONG_FRAMES-frame trial drawn from the fitted EM
    workload's ARHMM (K = 16, D = 9; its state chain, then ``sample_x``),
    observed through predictions = latents + 0.5 noise (R from their
    residuals) and, as in JAX's test of these gates, state evidence (logits
    2 on the drawn state plus unit noise, as decoder_exports makes them).
    ``decode(parallel=True)`` (K13, K14,
    K19, K20 launched) timed beside the sequential ``decode`` (K9, K10, K17,
    K18) of the same trial, and the Kalman kernels alone on its inputs;
    JAX's gates: the parallel MSE below LONG_RAW_SHARE x the raw and
    LONG_SEQ_SHARE x the sequential decode's, every latent finite."""
    kal, imm, build = port.kalman, port.imm, port.build
    t0 = time.perf_counter()
    dec, x, y, q = long_decoder_trial(port, model)
    sample_s = time.perf_counter() - t0
    reset_launches(build)
    out_par = dec.decode(y, q, parallel=True)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    out_seq = dec.decode(y, q)
    mse = dict(raw=float(np.mean((y - x) ** 2)),
               parallel=float(np.mean((out_par['latents'] - x) ** 2)),
               sequential=float(np.mean((out_seq['latents'] - x) ** 2)))
    # the kernels alone on this trial's inputs
    y0 = torch.from_numpy(y).to(DEVICE)
    m = torch.ones(LONG_FRAMES, device=DEVICE)
    gamma = torch.from_numpy(out_par['states_posterior']).to(DEVICE)
    F, c, Q, mu0, Sigma0 = dec._soft_dynamics(y0, gamma)
    ins = (F, c, Q, dec._H, dec.R, y0, m, mu0, Sigma0)
    filt = kal.filter_parallel_cuda(*ins)
    As, bs, Qs = dec._aug_dynamics()
    imm_ins = (y0, m, gamma, As, bs, Qs, dec.R, *dec._init_moments(y0, gamma))
    imm_f = imm.imm_filter_cuda(*imm_ins)
    n, D = dec.n, dec.D
    work = kalman_bounds(LONG_FRAMES, D, n, LONG_FRAMES)
    rec = dict(phase='bayesian_long_session', frames=LONG_FRAMES, states=model.K, dim=D,
               sample_seconds=sample_s, mse=mse, launches=launches,
               raw_share_tol=LONG_RAW_SHARE, sequential_share_tol=LONG_SEQ_SHARE,
               chunk=port.hmm.scan_chunk(LONG_FRAMES),
               decode_ms=dict(
                   parallel=request_ms(lambda: dec.decode(y, q, parallel=True), reps=5),
                   parallel_filter_only=request_ms(
                       lambda: dec.decode(y, q, smooth=False, parallel=True), reps=5),
                   sequential=request_ms(lambda: dec.decode(y, q), reps=5, warmup=1)),
               kernel_ms=dict(
                   k19=median_ms(lambda: kal.filter_parallel_cuda(*ins), samples=3, inner=3),
                   k20=median_ms(lambda: kal.smooth_parallel_cuda(F, c, Q, *filt), samples=3,
                                 inner=3),
                   k17=median_ms(lambda: imm.imm_filter_cuda(*imm_ins), samples=3, inner=1,
                                 warmup=1),
                   k18=median_ms(lambda: imm.rts_smoother_cuda(*imm_f, gamma, As), samples=3,
                                 inner=1, warmup=1)),
               k19_bound_ms=bound(*work['filter_scan'])['bound_ms'],
               k20_bound_ms=bound(*work['smoother_scan'])['bound_ms'])
    emit(rec)
    missing = [k for k in BAYES_ASSOC_KERNELS if launches[k] == 0]
    finite = bool(np.isfinite(out_par['latents']).all())
    if missing or not finite or not mse['parallel'] < LONG_RAW_SHARE * mse['raw'] or \
            not mse['parallel'] < LONG_SEQ_SHARE * mse['sequential']:
        raise AssertionError('the long parallel decode fails (missing %s): %s' % (missing, rec))
    return launches, dict(dec=dec, x=x, y=y, q=q, ins=ins)


def long_decoder_trial(port, model):
    """The long session of :func:`bayesian_long_session`: a decoder over
    ``model`` and one LONG_FRAMES-frame trial drawn from it, (decoder,
    latents, predictions, state probabilities)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 24)
    z, x = model.sample(LONG_FRAMES, generator=gen)
    rs = np.random.RandomState(SEED + 25)
    y = (x + 0.5 * rs.randn(*x.shape)).astype(np.float32)
    q = port.bayesian_decoder_grid_search._softmax_rows(
        2.0 * np.eye(model.K)[z] + rs.randn(LONG_FRAMES, model.K))
    dec = port.bayesian.BayesianDecoder(model)
    dec.estimate_obs_noise([x], [y])
    return dec, x, y, q


def frame_err(got, ref):
    """The largest distance of the outputs ``got`` from ``ref`` (tuples of
    (T, ...) tensors) in a frame, relative to max(1, that frame's largest
    |ref|), over frames and outputs."""
    def one(g, r):
        r = r.double()
        d = (g.double() - r.to(g.device)).abs().flatten(1).amax(1)
        return (d / r.to(g.device).abs().flatten(1).amax(1).clamp(min=1.0)).max().item()
    return max(one(g, r) for g, r in zip(got, ref))


def kalman_f64(port, ins, chunk=None):
    """The plain parallel filter and the smoother on K19's moments, in
    float64 on the card: (filtered, smoothed, K19's moments)."""
    kal = port.kalman
    F, c, Q = ins[:3]
    k19 = kal.filter_parallel_cuda(*ins)
    return (kal.filter_parallel_plain(*ins, chunk=chunk, dtype=torch.float64),
            kal.smooth_parallel_plain(F, c, Q, *k19, chunk=chunk, dtype=torch.float64), k19)


def sp_kalman_bounds(T, d, n, observed, n_sh):
    """(operations, bytes) of K36-K39 over a T-frame trial cut into n_sh
    shards: each launcher held to one pass of the filter's (K36, K37) or
    the smoother's (K38, K39) recursion over the trial (kalman_bounds'
    count), its inputs read once (each shard's copy of H, R, m0, P0; the
    smoother's halo frames; the gathered totals, n_sh on every shard) and
    its outputs written once (the shards' totals or moments)."""
    work = kalman_bounds(T, d, n, observed)
    filt_ops, smooth_ops = work['filter_scan'][0], work['smoother_scan'][0]
    ef, sf, moments = 3 * n * n + 2 * n, 2 * n * n + n, T * (n + n * n)
    f_in = T * (2 * n * n + n + d + 1) + n_sh * (d * n + d * d + n + n * n)
    s_in = (T + n_sh - 1) * (2 * n * n + n) + moments
    return {'kalman_shard_filter_totals': (filt_ops, 4 * (f_in + n_sh * ef)),
            'kalman_shard_filter_finish': (filt_ops, 4 * (f_in + n_sh * n_sh * ef + moments)),
            'kalman_shard_smoother_totals': (smooth_ops, 4 * (s_in + n_sh * sf)),
            'kalman_shard_smoother_finish': (smooth_ops,
                                             4 * (s_in + n_sh * n_sh * sf + moments))}


def sp_kalman_errors(port, ins, mesh, refs, chunk=None):
    """The time-sharded filter (on ``ins``) and smoother (on K19's moments)
    on ``mesh``, kernels and plain passes, against ``refs`` = kalman_f64's:
    per-frame errors and their tolerances, and the kernels' outputs."""
    seq, kal = port.seq, port.kalman
    F, c, Q = ins[:3]
    f64, s64, k19 = refs
    got = (seq.sp_kalman_filter(*ins, mesh=mesh), seq.sp_kalman_smooth(F, c, Q, *k19, mesh=mesh))
    plain = (seq.sp_kalman_filter_plain(*ins, mesh, chunk=chunk),
             seq.sp_kalman_smooth_plain(F, c, Q, *k19, mesh, chunk=chunk))
    own = (k19, kal.smooth_parallel_cuda(F, c, Q, *k19))
    torch.cuda.synchronize()
    out = {}
    for i, which in enumerate(('filter', 'smoother')):
        ref = (f64, s64)[i]
        e_plain, e_own = frame_err(plain[i], ref), frame_err(own[i], ref)
        out[which] = dict(
            vs_plain=frame_err(got[i], plain[i]), vs_float64=frame_err(got[i], ref),
            plain_vs_float64=e_plain, unsharded_kernel_vs_float64=e_own,
            tol_float64=max(KALMAN_REL_TOL, 2 * max(e_plain, e_own)),
            tol_plain=max(KALMAN_REL_TOL, 3 * max(e_plain, e_own)),
            finite=all(bool(torch.isfinite(t).all().item()) for t in got[i]))
    return out, got, own


def sp_kalman_bad(errs):
    """The passes of sp_kalman_errors' ``errs`` out of their tolerances."""
    return [w for w in ('filter', 'smoother') if not errs[w]['finite'] or
            errs[w]['vs_plain'] > errs[w]['tol_plain'] or
            errs[w]['vs_float64'] > errs[w]['tol_float64']]


def sp_kalman_boundaries(port, ins):
    """K36-K39 at the shard boundaries: the first SP_KALMAN_CUT frames of
    ``ins`` with the observations masked on both sides of every cut of
    SP_CUT_SHARDS shards and from SP_KALMAN_VALID on, on those meshes; and
    the first SP_KALMAN_SHORT frames on 8 shards (empty shards; at 9
    frames the fifth shard holds only the terminal frame). Every frame
    against the plain pass on the same mesh and float64."""
    seq, Mesh = port.seq, port.mesh.Mesh
    cut = [t[:SP_KALMAN_CUT].clone() if t.dim() and t.shape[0] == ins[0].shape[0] else t
           for t in ins]
    mask = cut[6]
    mask[SP_KALMAN_VALID:] = 0
    for n_sh in SP_CUT_SHARDS:
        for t0, _ in seq.shard_bounds(SP_KALMAN_CUT, n_sh)[1:]:
            mask[t0 - 1:t0 + 1] = 0
    out = {}
    cases = [('cut', cut, n_sh) for n_sh in SP_CUT_SHARDS] + \
        [('short%d' % T, [t[:T] if t.dim() and t.shape[0] == ins[0].shape[0] else t
                          for t in ins], 8) for T in SP_KALMAN_SHORT]
    for name, case, n_sh in cases:
        T = case[0].shape[0]
        errs = sp_kalman_errors(port, case, Mesh([DEVICE] * n_sh, ('sp',)),
                                kalman_f64(port, case))[0]
        errs.update(frames=T, observed=int(case[6].sum().item()),
                    shard_frames=[t1 - t0 for t0, t1 in seq.shard_bounds(T, n_sh)])
        out['%s_x%d' % (name, n_sh)] = errs
    return out


def check_sp_kalman(port, cases):
    """K36-K39 (``kernels/kalman_shard.cu``, row 19b) through
    ``parallel.seq``'s time-sharded Kalman passes at ``cases`` (name ->
    the soft LDS (F, c, Q, H, R, y, mask, m0, P0) on the card: the long
    session's and the CLI's), on meshes of SP_SHARDS shards of the card:
    each against the plain sharded pass on the same mesh and both against
    the float64 plain pass, per frame (sp_kalman_errors); with one shard
    K19's and K20's outputs bit for bit. Each launcher timed through
    ``parallel.seq``'s stages (with the gathers it runs) on every shard of
    the largest mesh beside the plain pass it serves; the passes timed
    whole at every mesh beside K19 / K20. The shard boundaries
    (sp_kalman_boundaries). Returns one line per launcher."""
    kal, seq, Mesh = port.kalman, port.seq, port.mesh.Mesh
    res = {name: {} for name in SP_KALMAN_KERNELS}
    phase = dict(phase='sp_kalman_check', shards=list(SP_SHARDS), cases={})
    for name, ins in cases.items():
        F, c, Q = ins[:3]
        T, n, d = F.shape[0], F.shape[-1], ins[5].shape[-1]
        chunk = 8192 if T > 8192 else None   # decode's, JAX's chunked branch
        refs = kalman_f64(port, ins, chunk)
        k19 = refs[2]
        per_n = {}
        for n_sh in SP_SHARDS:
            mesh = Mesh([DEVICE] * n_sh, ('sp',))
            v, got, own = sp_kalman_errors(port, ins, mesh, refs, chunk)
            if n_sh == 1:
                v['equal_to_k19_k20'] = [bool(torch.equal(a, b)) for a, b in
                                         zip(got[0] + got[1], own[0] + own[1])]
            v['pass_ms'] = dict(
                filter=median_ms(lambda: seq.sp_kalman_filter(*ins, mesh=mesh), samples=3,
                                 inner=3),
                smoother=median_ms(lambda: seq.sp_kalman_smooth(F, c, Q, *k19, mesh=mesh),
                                   samples=3, inner=3))
            per_n[n_sh] = v
            if n_sh != max(SP_SHARDS):
                continue
            shards = seq.shard_lds(mesh, *ins)
            tot_f = seq.stage_kalman_filter_totals(shards)
            filt = [tuple(t) for t in seq.kalman_filter_shards(shards)]
            tot_s = seq.stage_kalman_smoother_totals(shards, filt)
            fns = {'kalman_shard_filter_totals': lambda: seq.stage_kalman_filter_totals(shards),
                   'kalman_shard_filter_finish': lambda: seq.stage_kalman_filter_finish(
                       tot_f, shards),
                   'kalman_shard_smoother_totals': lambda: seq.stage_kalman_smoother_totals(
                       shards, filt),
                   'kalman_shard_smoother_finish': lambda: seq.stage_kalman_smoother_finish(
                       tot_s, shards, filt)}
            plain = dict(filter=median_ms(lambda: seq.sp_kalman_filter_plain(
                *ins, mesh, chunk=chunk), samples=3, inner=1, warmup=1),
                         smoother=median_ms(lambda: seq.sp_kalman_smooth_plain(
                             F, c, Q, *k19, mesh, chunk=chunk), samples=3, inner=1, warmup=1))
            bounds = sp_kalman_bounds(T, d, n, int(ins[6].sum().item()), n_sh)
            for kernel, fn in fns.items():
                which = 'filter' if 'filter' in kernel else 'smoother'
                res[kernel]['%s_x%d' % (name, n_sh)] = dict(
                    frames=T, shards=n_sh, serves=which, max_abs_err=v[which]['vs_plain'],
                    ms=median_ms(fn, samples=3, inner=5), plain_ms=plain[which],
                    **bound(*bounds[kernel]))
        phase['cases'][name] = dict(
            frames=T, n=n, d=d, observed=int(ins[6].sum().item()), chunk=chunk,
            k19_ms=median_ms(lambda: kal.filter_parallel_cuda(*ins), samples=3, inner=3),
            k20_ms=median_ms(lambda: kal.smooth_parallel_cuda(F, c, Q, *k19), samples=3,
                             inner=3),
            by_shards=per_n)
        del refs, k19
    phase['boundaries'] = sp_kalman_boundaries(port, cases['long'])
    emit(phase)
    bad = ['%s x%d %s' % (name, n_sh, w) for name, c in phase['cases'].items()
           for n_sh, v in c['by_shards'].items() for w in sp_kalman_bad(v)]
    bad += ['%s x%d unequal' % (name, n_sh) for name, c in phase['cases'].items()
            for n_sh, v in c['by_shards'].items() if not all(v.get('equal_to_k19_k20', [1]))]
    bad += ['boundaries %s %s' % (name, w) for name, v in phase['boundaries'].items()
            for w in sp_kalman_bad(v)]
    if bad:
        raise AssertionError('the time-sharded Kalman passes disagree (%s): %s' % (bad, phase))
    rows = []
    for kernel in SP_KALMAN_KERNELS:
        rec = dict(phase='sp_kalman_kernel_check', kernel=kernel, layer=next(iter(res[kernel])),
                   frames=LONG_FRAMES, library_ms=None, cases=res[kernel],
                   bound_note='the chains of the chunks and the folds, not these',
                   err_note='max_abs_err: the pass\'s per-frame distance from the plain '
                            'sharded pass on the same mesh; plain_ms: that plain pass')
        for key in ('ms', 'plain_ms', 'bound_ms', 't_ops_ms', 't_bytes_ms'):
            rec[key] = sum(c[key] for c in res[kernel].values())
        rec['max_abs_err'] = max(c['max_abs_err'] for c in res[kernel].values())
        rec['bound_by'] = 'operations' if rec['t_ops_ms'] >= rec['t_bytes_ms'] else 'bytes'
        emit(rec)
        rows.append(rec)
    return rows


def decoder_chain(dec, y, q):
    """The discrete chain ``decode`` runs for predictions ``y`` (NaN rows
    unobserved) and state probabilities ``q``: (log_pi0, log_P, ll (T, K),
    the predictions with NaN rows zeroed, the observed mask)."""
    y = np.asarray(y, dtype=np.float32)
    m = dec._tensor((~np.any(np.isnan(y), axis=1)).astype(np.float32))
    y0 = dec._tensor(np.nan_to_num(y))
    p = dec.arhmm.params
    ll = dec._discrete_loglik(y0, None if q is None else dec._tensor(q)) * m[:, None]
    return p['log_pi0'], torch.log_softmax(p['log_Ps'], dim=1), ll, y0, m


def soft_lds64(dec, y0, m, gamma):
    """``decode``'s gamma-weighted dynamics (``BayesianDecoder._soft_dynamics``
    with ``_init_moments``) in float64: (F, c, Q, H, R, y, mask, m0, P0) as
    the Kalman passes take them."""
    f64 = dict(dtype=torch.float64, device=y0.device)
    As, bs, Qs = (t.double() for t in dec._aug_dynamics())
    g = gamma.double()
    F = torch.einsum('tk,kde->tde', g, As)
    c = torch.einsum('tk,kd->td', g, bs)
    Q = torch.einsum('tk,kde->tde', g, Qs)
    eye = torch.eye(dec.n, **f64)
    F[0], c[0], Q[0] = eye, 0.0, 1e-6 * eye
    I_L, R = torch.eye(dec.lags, **f64), dec.R.double()
    P0 = torch.kron(I_L, R) + torch.kron(
        I_L, torch.einsum('k,kde->de', g[0], dec.arhmm.params['Sigmas'].double()))
    return (F, c, Q, dec._H.double(), R, y0.double(), m.double(), y0[0].double().repeat(
        dec.lags), P0)


def bayesian_sp_serve(port, cases):
    """Main path 14d: ``decode(y, q, mesh=...)`` on meshes of SP_SHARDS
    shards of the card (K32-K35 for the discrete pass, K36-K39 for the
    continuous one) at ``cases`` (name -> (decoder, y, q): the long
    session's 100,000 frames, one 189-frame trial of the fitted K = 4 CLI
    model), against ``decode(parallel=True)`` of the same trial (K13, K14,
    K19, K20) and a float64 decode by the plain passes: gamma, paths and
    latents as the constants above say. Each decode timed and profiled
    (the device's idle share)."""
    build, kal, hmm, Mesh = port.build, port.kalman, port.hmm, port.mesh.Mesh
    meshes = {n: Mesh([DEVICE] * n, ('sp',)) for n in SP_SHARDS}
    reset_launches(build)
    got = {(name, n): dec.decode(y, q, mesh=mesh, as_numpy=False)
           for name, (dec, y, q) in cases.items() for n, mesh in meshes.items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    rec = dict(phase='bayesian_sp_serve', shards=list(SP_SHARDS), launches={
        k: launches[k] for k in BAYES_SP_KERNELS}, cases={})
    for name, (dec, y, q) in cases.items():
        ref = dec.decode(y, q, parallel=True, as_numpy=False)
        pi0, lp, ll, y0, m = decoder_chain(dec, y, q)
        g64 = hmm.forward_backward_plain(pi0.double(), lp.double(), ll[None].double(),
                                         parallel=True)[0][0]
        ref_g = (ref['states_posterior'].double() - g64).abs().max().item()
        gamma_tol = max(GAMMA_ABS_TOL, 2 * ref_g)
        T, D = len(y), dec.D
        chunk = 8192 if T > 8192 else None
        lds64 = soft_lds64(dec, y0, m, g64)
        dec64 = kal.smooth_parallel_plain(*lds64[:3], *kal.filter_parallel_plain(
            *lds64, chunk=chunk), chunk=chunk)
        dec64 = (dec64[0][:, :D], dec64[1][:, :D, :D])
        ref_lat = frame_err((ref['latents'], ref['latents_cov']), dec64)
        out = dict(frames=T, states=dec.K, gamma_tol=gamma_tol,
                   unsharded_gamma_vs_float64=ref_g, unsharded_latents_vs_float64=ref_lat,
                   latents_tol_decode64=max(KALMAN_REL_TOL, 2 * ref_lat),
                   latents_tol_unsharded=max(KALMAN_REL_TOL, 3 * ref_lat), by_shards={},
                   unsharded_decode_ms=request_ms(lambda: dec.decode(y, q, parallel=True),
                                                  reps=5))
        for n, mesh in meshes.items():
            o = got[name, n]
            F, c, Q, mu0, S0 = dec._soft_dynamics(y0, o['states_posterior'].to(dec.device))
            ins = (F, c, Q, dec._H, dec.R, y0, m, mu0, S0)
            f64, s64, k19 = kalman_f64(port, ins, chunk)
            own64 = (s64[0][:, :D], s64[1][:, :D, :D])
            plain = kal.smooth_parallel_plain(F, c, Q, *kal.filter_parallel_plain(
                *ins, chunk=chunk), chunk=chunk)
            own = kal.smooth_parallel_cuda(F, c, Q, *k19)
            errs = [frame_err((t[0][:, :D], t[1][:, :D, :D]), own64) for t in (plain, own)]
            prof = profile_steps(lambda: dec.decode(y, q, mesh=mesh), steps=3, warmup=1,
                                 phase='bayesian_sp_serve_profile', frames=T, bucket=T,
                                 case=name, shards=n)
            out['by_shards'][n] = dict(
                gamma_vs_float64=(o['states_posterior'].double() - g64.to(o['states_posterior']
                                                                          .device))
                .abs().max().item(),
                gamma_vs_unsharded=(o['states_posterior'] - ref['states_posterior'].to(
                    o['states_posterior'].device)).abs().max().item(),
                path_agreement=(o['states'].cpu() == ref['states'].cpu()).float().mean().item(),
                latents_vs_unsharded=frame_err((o['latents'], o['latents_cov']),
                                               (ref['latents'], ref['latents_cov'])),
                latents_vs_decode64=frame_err((o['latents'], o['latents_cov']), dec64),
                latents_vs_float64=frame_err((o['latents'], o['latents_cov']), own64),
                latents_tol_float64=max(KALMAN_REL_TOL, 2 * max(errs)),
                finite=bool(torch.isfinite(o['latents']).all().item()),
                decode_ms=request_ms(lambda: dec.decode(y, q, mesh=mesh), reps=5),
                device_busy_ms=prof['device_busy_ms_per_step'],
                device_idle_share=prof['device_idle_share'])
            if n == max(SP_SHARDS):
                emit(prof)
        rec['cases'][name] = out
    emit(rec)
    missing = [k for k in BAYES_SP_KERNELS if launches[k] == 0]
    bad = ['%s x%d' % (name, n) for name, c in rec['cases'].items()
           for n, v in c['by_shards'].items()
           if not v['finite'] or v['gamma_vs_float64'] > c['gamma_tol']
           or v['path_agreement'] < PATH_AGREE
           or v['latents_vs_unsharded'] > c['latents_tol_unsharded']
           or v['latents_vs_decode64'] > c['latents_tol_decode64']
           or v['latents_vs_float64'] > v['latents_tol_float64']]
    if missing or bad:
        raise AssertionError('decode with a mesh failed (missing %s, bad %s): %s'
                             % (missing, bad, rec))
    return launches


# ---------------------------------------------------------------- decoders


def decoder_window(frames=TRIAL, bucket=BUCKET, max_lags=DEC_HP['n_max_lags']):
    """The loss weights of a trial padded to its bucket: 1 on [max_lags,
    frames - max_lags), 0 on the lag borders and the padding."""
    w = torch.zeros(bucket, device=DEVICE)
    w[max_lags:frames - max_lags] = 1.0
    return w


def nll_inputs(gen, d):
    """K12's inputs at the decoder step's shapes (see check_gaussian_nll):
    (y_pred, y_true, cov) drawn from ``gen``."""
    dev = DEVICE
    y_pred = torch.randn((BUCKET, d), device=dev, generator=gen)
    y_true = torch.randn((BUCKET, d), device=dev, generator=gen)
    hidden = torch.relu(torch.randn((BUCKET, DEC_HP['n_hid_units']), device=dev,
                                    generator=gen))
    w_head = torch.randn((DEC_HP['n_hid_units'], d * d), device=dev, generator=gen) * 0.05
    L = (hidden @ w_head + torch.eye(d, device=dev).reshape(-1)).reshape(BUCKET, d, d)
    return y_pred, y_true, L @ L.transpose(1, 2)


def check_nll_draws(losses, d):
    """K12's gradients on NLL_DRAWS further draws of its inputs (a generator
    of their own), K12 and the plain float32 version each against the plain
    version in float64 on the same inputs: on every draw K12 within
    NLL_GRAD_REL_TOL of max|float64| and no farther from it than the plain
    float32 version."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 120 + d)
    fm = decoder_window()
    one = torch.ones((), device=DEVICE)
    k_errs, p_errs, kp_errs = [], [], []
    for _ in range(NLL_DRAWS):
        y_pred, y_true, cov = nll_inputs(gen, d)
        loss, den = losses.gaussian_neg_log_prob_cuda(y_pred, y_true, cov, fm)
        got = losses.gaussian_neg_log_prob_grad_cuda(y_pred, y_true, cov, fm, den, one)
        loss, den = losses.gaussian_neg_log_prob_plain(y_pred, y_true, cov, fm)
        plain = losses.gaussian_neg_log_prob_grad_plain(y_pred, y_true, cov, fm, den, one)
        y64, t64, c64, fm64 = (t.double() for t in (y_pred, y_true, cov, fm))
        loss, den = losses.gaussian_neg_log_prob_plain(y64, t64, c64, fm64)
        ref = losses.gaussian_neg_log_prob_grad_plain(y64, t64, c64, fm64, den, one.double())

        def rel(a, b):
            return max((x.double() - y.double()).abs().max().item() / y.abs().max().item()
                       for x, y in zip(a, b))
        k_errs.append(rel(got, ref))
        p_errs.append(rel(plain, ref))
        kp_errs.append(rel(got, plain))
    rec = dict(phase='nll_draws', kernel='gaussian_nll', dim=d, draws=NLL_DRAWS,
               k12_vs_float64=k_errs, plain_vs_float64=p_errs, k12_vs_plain=kp_errs,
               k12_nearer=sum(k <= p for k, p in zip(k_errs, p_errs)),
               rel_tol=NLL_GRAD_REL_TOL)
    emit(rec)
    if max(k_errs) > NLL_GRAD_REL_TOL or rec['k12_nearer'] < NLL_DRAWS:
        raise AssertionError('K12 is not within %g of float64, or farther from it than '
                             'the plain float32 version: %s' % (NLL_GRAD_REL_TOL, rec))
    return rec


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
    y_pred, y_true, cov = nll_inputs(gen, d)
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


def lstm_cell(h, gen):
    """One direction's (w (in + h, 4h), b (4h,)) over N_NEURAL inputs from
    torch's default bound 1 / sqrt(in + h), as ``LSTM.init_params`` draws
    them."""
    bound = 1.0 / np.sqrt(N_NEURAL + h)
    w = (torch.rand((N_NEURAL + h, 4 * h), device=DEVICE, generator=gen) * 2 - 1) * bound
    b = (torch.rand(4 * h, device=DEVICE, generator=gen) * 2 - 1) * bound
    return w, b


def lstm_library(flat, d_in, h):
    """``torch.nn.LSTM`` (cuDNN) with the cells' weights: weight_ih = W[:in]^T,
    weight_hh = W[in:]^T, bias_ih = b, bias_hh = 0; its gate order is JAX's.
    The yardstick only: the port never runs it."""
    lib = torch.nn.LSTM(d_in, h, batch_first=True, bidirectional=True).to(DEVICE)
    with torch.no_grad():
        for suffix, w, b in (('', flat[0], flat[1]), ('_reverse', flat[2], flat[3])):
            getattr(lib, 'weight_ih_l0' + suffix).copy_(w[:d_in].t())
            getattr(lib, 'weight_hh_l0' + suffix).copy_(w[d_in:].t())
            getattr(lib, 'bias_ih_l0' + suffix).copy_(b)
            getattr(lib, 'bias_hh_l0' + suffix).zero_()
    return lib


def lstm_bounds(T, d_in, h, with_dx, dirs=2):
    """(operations, bytes) of K23 and of K24 on one trial: multiply-adds as
    two operations, each activation, product and sum of the cell update as
    one (the four gates and tanh(c), c = f c + i g, h = o tanh(c): 8 an
    hidden unit a step forward, the chain rule through them ~16 backward);
    each input read once, each output written once. K23 reads x, w, b and
    writes hs; K24 reads x, W_hh (all of w with dx), the saved hs, cs and
    gate activations and the gradient of hs, and writes dw, db (and dx)."""
    g4 = 4 * h
    fwd_ops = dirs * T * ((d_in + h) * g4 * 2 + g4 + 8 * h)
    fwd_bytes = 4 * (T * d_in + dirs * ((d_in + h) * g4 + g4) + T * dirs * h)
    bwd_ops = dirs * T * ((d_in + h + 1) * g4 * 2 + h * g4 * 2 + 16 * h)
    bwd_bytes = 4 * (T * d_in + dirs * h * g4 + T * dirs * (3 * h + g4)
                     + dirs * (d_in + h + 1) * g4)
    if with_dx:
        bwd_ops += T * d_in * dirs * g4 * 2
        bwd_bytes += 4 * (dirs * d_in * g4 + T * d_in)
    return (fwd_ops, fwd_bytes), (bwd_ops, bwd_bytes)


def lstm_grad_err(got, want):
    """The largest distance of K24's outputs (dx, dw_f, db_f, dw_b, db_b;
    None skipped) from ``want``'s, each over its max|want|."""
    return max(((g.double() - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want) if g is not None)


def check_lstm(port):
    """K23 and K24 against the plain version on the card at each of
    LSTM_HIDDEN, both directions over a (1, 192, 256) trial: hidden states
    (the inference and the training launcher, which must agree bit for
    bit, and ``torch.nn.LSTM`` with TF32 off, one more check), dW and db
    (and dx at the config's width) against autograd through the plain
    version, K24 a second time bit for bit; then one LSTM_LONG-frame trial
    against the plain version in float64 on the card, K23's hidden states
    and K24's dx, dW and db. Times K23, K24, the plain version (forward, and
    autograd's backward through it) and ``nn.LSTM`` (forward, and its
    backward from the same graph), and splits K24's device time by launch
    (the chain, dW and db, dx; ``torch.profiler``); records K24's plan
    (``ops.lstm.bptt_plan``: cluster size, rows and threads a CTA; and
    ``dx_frames``; None on a checkout without the planner)."""
    lstm = port.lstm
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 30)
    cases = {'lstm_forward': {}, 'lstm_backward': {}}
    bad = []
    planner = getattr(lstm, 'bptt_plan', None)
    for h in LSTM_HIDDEN:
        flat = [t for _ in range(2) for t in lstm_cell(h, gen)]
        x = torch.randn((1, BUCKET, N_NEURAL), device=DEVICE, generator=gen)
        grad = torch.randn((1, BUCKET, 2 * h), device=DEVICE, generator=gen)
        with_dx = h == LSTM_HIDDEN[0]
        hs_k = lstm.lstm_forward_cuda(x, *flat)[0]
        hs_t, cs, acts = lstm.lstm_forward_cuda(x, *flat, train=True)
        grads_k = lstm.lstm_backward_cuda(x, flat[0], flat[2], hs_t, cs, acts, grad,
                                          with_dx=with_dx)
        grads_again = lstm.lstm_backward_cuda(x, flat[0], flat[2], hs_t, cs, acts, grad,
                                              with_dx=with_dx)
        leaves = [t.clone().requires_grad_(True) for t in [x] + flat]
        hs_p = lstm.lstm_scan_plain(*leaves)
        grads_p = torch.autograd.grad(hs_p, leaves, grad, retain_graph=True)
        lib = lstm_library(flat, N_NEURAL, h)
        with tf32_off():
            hs_lib = lib(x)[0]
        torch.cuda.synchronize()
        grad_errs = {name: ((gk - gp).abs().max() / gp.abs().max()).item()
                     for name, gk, gp in zip(('dx', 'dw_f', 'db_f', 'dw_b', 'db_b'),
                                             grads_k, grads_p) if gk is not None}
        rerun_equal = all(torch.equal(a, b) for a, b in zip(grads_k, grads_again)
                          if a is not None)
        fwd_err = (hs_k - hs_p).abs().max().item()
        finite = all(bool(torch.isfinite(t).all().item())
                     for t in [hs_k, hs_t] + [g for g in grads_k if g is not None])

        def backward():
            return lstm.lstm_backward_cuda(x, flat[0], flat[2], hs_t, cs, acts, grad)

        def backward_dx():
            return lstm.lstm_backward_cuda(x, flat[0], flat[2], hs_t, cs, acts, grad,
                                           with_dx=True)

        def plain_forward():
            with torch.no_grad():
                return lstm.lstm_scan_plain(x, *flat)

        def plain_backward():
            return torch.autograd.grad(hs_p, leaves[1:], grad, retain_graph=True)

        def library_forward():
            with torch.no_grad():
                return lib(x)[0]
        lib_params = list(lib.parameters())

        def library_backward():
            return torch.autograd.grad(hs_lib, lib_params, grad, retain_graph=True)
        with tf32_off():
            lib_fwd_ms = median_ms(library_forward)
            lib_bwd_ms = median_ms(library_backward)
        plain_slow = dict(samples=3, inner=1, warmup=1)
        (f_ops, f_bytes), (b_ops, b_bytes) = lstm_bounds(BUCKET, N_NEURAL, h, with_dx=False)
        fwd_ms = median_ms(lambda: lstm.lstm_forward_cuda(x, *flat))
        bwd_ms = median_ms(backward)
        split = profile_steps(backward_dx, groups=LSTM_SPLIT)
        split_ms = split['ms_per_step_by_kernel']
        split_complete = all(split['launches_per_step_by_kernel'][g] == 1 for g in LSTM_SPLIT)
        cases['lstm_forward'][h] = dict(
            max_abs_err=fwd_err, train_launcher_equal=torch.equal(hs_k, hs_t),
            library_max_abs_err=(hs_k - hs_lib).abs().max().item(), finite=finite,
            ms=fwd_ms, us_per_step=fwd_ms * 1e3 / BUCKET,
            train_ms=median_ms(lambda: lstm.lstm_forward_cuda(x, *flat, train=True)),
            plain_ms=median_ms(plain_forward, **plain_slow), library_ms=lib_fwd_ms,
            mflop=f_ops / 1e6, mbytes=f_bytes / 1e6, **bound(f_ops, f_bytes))
        cases['lstm_backward'][h] = dict(
            max_abs_err=max((gk - gp).abs().max().item()
                            for gk, gp in zip(grads_k, grads_p) if gk is not None),
            rel_err=grad_errs, max_rel_err=max(grad_errs.values()), with_dx=with_dx,
            rerun_equal=rerun_equal, finite=finite,
            plan=dict(planner(h, lstm._smem_optin()),
                      dx_frames=lstm.dx_frames(h, 2, lstm._smem_optin())) if planner else None,
            ms=bwd_ms, us_per_step=bwd_ms * 1e3 / BUCKET,
            dx_ms=median_ms(backward_dx), device_ms_with_dx=split_ms,
            split_complete=split_complete,
            chain_us_per_step=split_ms['bptt'] * 1e3 / BUCKET if split_complete else None,
            plain_ms=median_ms(plain_backward, **plain_slow), library_ms=lib_bwd_ms,
            vs_library=bwd_ms / lib_bwd_ms,
            mflop=b_ops / 1e6, mbytes=b_bytes / 1e6, **bound(b_ops, b_bytes))
        fwd, bwd = cases['lstm_forward'][h], cases['lstm_backward'][h]
        if not finite or fwd_err > LSTM_ABS_TOL or not fwd['train_launcher_equal'] or \
                fwd['library_max_abs_err'] > LSTM_ABS_TOL or \
                bwd['max_rel_err'] > LSTM_GRAD_REL_TOL or not rerun_equal:
            bad.append(h)
        del lib, hs_p, hs_lib, leaves, grads_p

    long = {}
    for h in LSTM_HIDDEN:
        flat = [t for _ in range(2) for t in lstm_cell(h, gen)]
        x = torch.randn((1, LSTM_LONG, N_NEURAL), device=DEVICE, generator=gen)
        grad = torch.randn((1, LSTM_LONG, 2 * h), device=DEVICE, generator=gen)
        hs_k = lstm.lstm_forward_cuda(x, *flat)[0].double()
        hs_t, cs, acts = lstm.lstm_forward_cuda(x, *flat, train=True)
        grads_k = lstm.lstm_backward_cuda(x, flat[0], flat[2], hs_t, cs, acts, grad,
                                          with_dx=True)
        with torch.no_grad():
            p32 = lstm.lstm_scan_plain(x, *flat).double()
            p64 = lstm.lstm_scan_plain(x, *flat, dtype=torch.float64)
        k_err = (hs_k - p64).abs().max().item()
        p_err = (p32 - p64).abs().max().item()
        grads = {}
        for dtype in (torch.float32, torch.float64):
            leaves = [t.to(dtype).requires_grad_(True) for t in [x] + flat]
            grads[dtype] = [g.double() for g in torch.autograd.grad(
                lstm.lstm_scan_plain(*leaves), leaves, grad.to(dtype))]
            del leaves
        gk_err = lstm_grad_err(grads_k, grads[torch.float64])
        gp_err = lstm_grad_err(grads[torch.float32], grads[torch.float64])
        long[h] = dict(frames=LSTM_LONG, kernel_vs_float64=k_err, plain32_vs_float64=p_err,
                       tol=max(LSTM_ABS_TOL, 2 * p_err),
                       grad_kernel_vs_float64=gk_err, grad_plain32_vs_float64=gp_err,
                       grad_tol=max(LSTM_GRAD_REL_TOL, 2 * gp_err),
                       finite=bool(torch.isfinite(hs_k).all().item()) and all(
                           bool(torch.isfinite(g).all().item()) for g in grads_k))
        if not long[h]['finite'] or k_err > long[h]['tol'] or gk_err > long[h]['grad_tol']:
            bad.append('long h=%d' % h)
        del grads
    out = []
    for kernel, by_h in cases.items():
        first = by_h[LSTM_HIDDEN[0]]
        rec = dict(phase='lstm_check', kernel=kernel, layer='h=%d' % LSTM_HIDDEN[0],
                   frames=BUCKET, channels=N_NEURAL, directions=2, abs_tol=LSTM_ABS_TOL,
                   grad_rel_tol=LSTM_GRAD_REL_TOL, cases=by_h, tf32=tf32_flags(),
                   long_trial=long, bound_note='the T-step dependence chain, not these',
                   **{k: first[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'library_ms',
                                            'bound_ms', 't_ops_ms', 't_bytes_ms',
                                            'bound_by')})
        emit(rec)
        out.append(rec)
    if bad:
        raise AssertionError('K23 / K24 disagree with the plain version at %s: %s'
                             % (bad, out))
    return out


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
    """Route the decoder's losses and the LSTM's recurrence to their plain
    versions (autograd through ``gaussian_neg_log_prob_plain``,
    ``mse_plain`` and ``lstm_scan_plain``), for the plain twin of a step on
    the card."""
    losses = port.losses
    routes = ((losses, 'gaussian_neg_log_prob',
               lambda *a, **k: losses.gaussian_neg_log_prob_plain(*a, **k)[0]),
              (losses, 'mse', lambda *a, **k: losses.mse_plain(*a, **k)[0]),
              (port.decoders, 'lstm_scan', port.lstm.lstm_scan_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    for mod, name, fn in routes:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
    K5 for ``mlp``, under the lag-trimmed window; with K23 / K24 for
    ``lstm``) against the plain path's: the plain loss (and recurrence)
    differentiated by autograd."""
    loss_kernel = 'gaussian_nll' if hp['noise_dist'] == 'gaussian-full' else 'masked_mse'
    need = (loss_kernel,) + (('lstm_forward', 'lstm_backward')
                             if hp['model_type'] == 'lstm' else ())
    reset_launches(port.build)
    model.zero_grad(set_to_none=True)
    loss_k = model.loss_fn(batch)[0]
    loss_k.backward()
    grads_k = {k: p.grad.clone() for k, p in model.named_parameters()}
    launched = min(port.build.LAUNCHES[k] for k in need)
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
              rel_tol=GRAD_REL_TOL, loss_kernel=loss_kernel, kernels=list(need),
              fewest_launches=launched, max_rel_err=grad_errs[worst], worst=worst,
              rel_err=grad_errs))
    if not launched or grad_errs[worst] > GRAD_REL_TOL or loss_err > GRAD_REL_TOL:
        raise AssertionError('%s gradients on the card (%s launched at least %d times) '
                             'disagree with the plain path: %s=%.3g, loss %.3g'
                             % (hp['experiment_name'], need, launched, worst,
                                grad_errs[worst], loss_err))


def decoder_step(port, hp, model, source):
    """A decoder's train step on the card (``mlp-mv``, ``lstm``): its
    gradients against the plain path's, its time beside the plain step's
    (plain losses and recurrence, torch's fused AMSGrad), and its
    profile."""
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
                       phase='decoder_profile', model=hp['experiment_name']))
    return per_step, rec


def lstm_wide_step(port, tmp):
    """Main path 19b: the LSTM decoder's train step at LSTM_STEP_HIDDEN units
    from its seeded init (K24 in a cluster): ``decoder_step``'s gradients
    against the plain path's, its time beside the plain twin's, its
    profile. Returns the step's launches."""
    hp = dict(decoder_hparams('neural-ae-lstm', tmp), n_hid_units=LSTM_STEP_HIDDEN,
              experiment_name='neural-ae-lstm-h%d' % LSTM_STEP_HIDDEN)
    source = DecoderSource(TRAIN_TRIALS, SEED + 13, hp['output_signal'], hp['output_size'])
    model = port.decoders.Decoder(hp).to(DEVICE)
    return decoder_step(port, hp, model, source)[0]


def reference_predict(port, model, x):
    """The decoder's forward in float64 on the card, written out: the
    temporal conv as one matmul over the unfolded +-n_lags window; an LSTM's
    recurrence through ``lstm_scan_plain`` in float64."""
    sd = {k: v.double() for k, v in model.state_dict().items()}
    if model.hparams['model_type'] == 'lstm':
        h = port.lstm.lstm_scan_plain(x.double(), *(sd['model.%s.%s' % (cell, leaf)]
                                          for cell in ('fwd', 'bwd')
                                          for leaf in ('weight', 'bias')))
        return h @ sd['model.out.weight'].t() + sd['model.out.bias']
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
    """Main paths 12 and 19: a fitted decoder's (``mlp-mv``, ``lstm``)
    ``best_val_model.pt`` serves ``predict`` through ``load_version`` on the
    card, for a 189-frame and a 1000-frame trial, within 1e-4 of the
    float64 forward; an LSTM's requests must launch K23 and never K24.
    Returns the requests' launches."""
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(dict(hp, training_completed=True), f)
    rs = np.random.RandomState(SEED + 7)
    trials = {TRIAL: source.neural[0],
              1000: rs.randn(1000, N_NEURAL).astype(np.float32)}
    bundle = port.serving.load_version(vdir)
    served = dict(bundle.model.state_dict())
    same = all(torch.equal(served[k].cpu(), v) for k, v in
               port.weights.params_to_state_dict(bundle.model, best).items())
    reset_launches(port.build)
    outs = {frames: bundle.predict(x) for frames, x in trials.items()}
    torch.cuda.synchronize()
    launches = dict(port.build.LAUNCHES)
    lstm = hp['model_type'] == 'lstm'
    kernels_ok = not lstm or (launches['lstm_forward'] == len(trials) and
                              launches['lstm_backward'] == 0)
    rows = {}
    for frames, x in trials.items():
        out = outs[frames]
        with torch.inference_mode():
            ref = reference_predict(port, bundle.model, torch.from_numpy(x).to(DEVICE))
        err = (out.double() - ref).abs().max().item()
        tol = PREDICT_ABS_TOL * max(1.0, ref.abs().max().item())
        rows[frames] = dict(shape=list(out.shape), max_abs_err=err, tol=tol,
                            finite=bool(torch.isfinite(out).all().item()),
                            ms=request_ms(lambda: bundle.predict(x)))
    ok = same and kernels_ok and bundle.names() == ['predict'] and all(
        r['finite'] and r['max_abs_err'] <= r['tol'] and r['shape'] == [f, DEC_LATENTS]
        for f, r in rows.items())
    rec = dict(phase='decoder_serve', model=hp['experiment_name'], device=str(bundle.device),
               tf32=tf32_flags(), launches={k: v for k, v in launches.items() if v},
               weights_equal=same, requests=rows, ok=ok)
    emit(rec)
    if not ok:
        raise AssertionError('the fitted decoder does not serve: %s' % rec)
    return launches


# ------------------------------------------------------------ row 6: K27-K30


def pool_hparams(arch):
    """POOL_ARCH resolved at the 2-view frames (dims and paddings as the
    reference generator computes them), 12 latents."""
    hp = arch.get_handcrafted_dims(dict(POOL_ARCH, ae_input_dim=list(IMG),
                                        n_ae_latents=N_LATENTS), symmetric=True)
    return dict(hp, model_class='ae', model_type='conv', n_ae_latents=N_LATENTS,
                n_input_channels=IMG[0], y_pixels=IMG[1], x_pixels=IMG[2],
                rng_seed_model=SEED)


def row6_shapes(hp, n):
    """(pools, batch norms) of a pooling / batch-norm arch at batch ``n``:
    each encoder pool (its mirrored unpool takes the pooled output back to
    the pool's input plane) and each batch norm, with the activation fused
    into its epilogue."""
    pools, bns = [], []
    h, w = IMG[1], IMG[2]
    types = hp['ae_encoding_layer_type']
    for i, t in enumerate(types):
        c = hp['ae_encoding_n_channels'][i]
        if t == 'maxpool':
            pools.append(dict(layer='pool.maxpool_%d' % (i - 1), n=n, h=h, w=w, c=c,
                              ceil=hp['ae_padding_type'] != 'valid', ties=False))
        else:
            pool = i + 1 < len(types) and types[i + 1] == 'maxpool'
            bns.append(dict(layer='pool.encoder.bn_%d' % i, n=n, h=hp['ae_encoding_y_dim'][i],
                            w=hp['ae_encoding_x_dim'][i], c=c,
                            act=None if pool else 'leaky_relu'))
        h, w = hp['ae_encoding_y_dim'][i], hp['ae_encoding_x_dim'][i]
    last = len(hp['ae_decoding_layer_type']) - 1
    for i, t in enumerate(hp['ae_decoding_layer_type']):
        if t == 'convtranspose' and i < last:
            bns.append(dict(layer='pool.decoder.bn_%d' % i, n=n, h=hp['ae_decoding_y_dim'][i],
                            w=hp['ae_decoding_x_dim'][i], c=hp['ae_decoding_n_channels'][i],
                            act='leaky_relu'))
    return pools, bns


def check_pool(L, ops, gen):
    """K27 (``bn_max_pool2d`` with the encoder's leaky ReLU, and its
    backward) and K28 (the mirrored unpool, and its backward) against their
    plain versions at one pool's shape; values, indices and gradients must
    be equal. With ``ties`` the input lies on a coarse grid, so that most
    windows hold tied maxima and the backward's even split runs. The
    yardsticks, never called by the port: ``F.max_pool2d(...,
    return_indices=True)``, ``F.max_unpool2d`` and their autograd backwards
    (which send a window's cotangent to one index)."""
    dev, ceil, hw = DEVICE, L['ceil'], (L['h'], L['w'])
    shape = (L['n'], L['h'], L['w'], L['c'])
    if L['ties']:
        x = torch.randint(-2, 3, shape, device=dev, generator=gen).float()
    else:
        x = torch.randn(shape, device=dev, generator=gen)
    ho, wo = ops.pool_out_hw(L['h'], L['w'], ceil)
    pooled = (L['n'], ho, wo, L['c'])
    g = torch.randn(pooled, device=dev, generator=gen)
    gu = torch.randn(shape, device=dev, generator=gen)
    yp, ip = ops.max_pool2d_plain(x, ceil, 'leaky_relu')
    passes = {
        'max_pool2d': (lambda: ops.max_pool2d_cuda(x, ceil, 'leaky_relu'),
                       lambda: ops.max_pool2d_plain(x, ceil, 'leaky_relu')),
        'max_pool2d_grad': (lambda: (ops.max_pool2d_grad_cuda(x, g, ceil),),
                            lambda: (ops.max_pool2d_grad_plain(x, g, ceil),)),
        'max_unpool2d': (lambda: (ops.max_unpool2d_cuda(yp, ip, hw),),
                         lambda: (ops.max_unpool2d_plain(yp, ip, hw),)),
        'max_unpool2d_grad': (lambda: (ops.max_unpool2d_grad_cuda(gu, ip),),
                              lambda: (ops.max_unpool2d_grad_plain(gu, ip),)),
    }
    xl = x.permute(0, 3, 1, 2).requires_grad_(True)
    yl, il = F.max_pool2d(xl, 2, 2, ceil_mode=ceil, return_indices=True)
    vl = yl.detach().requires_grad_(True)
    ul = F.max_unpool2d(vl, il, 2, 2, output_size=hw)
    library = {
        'max_pool2d': lambda: F.max_pool2d(xl.detach(), 2, 2, ceil_mode=ceil,
                                           return_indices=True),
        'max_pool2d_grad': lambda: torch.autograd.grad(yl, xl, g.permute(0, 3, 1, 2),
                                                       retain_graph=True),
        'max_unpool2d': lambda: F.max_unpool2d(vl.detach(), il, 2, 2, output_size=hw),
        'max_unpool2d_grad': lambda: torch.autograd.grad(ul, vl, gu.permute(0, 3, 1, 2),
                                                         retain_graph=True),
    }
    n_in, n_out = x.numel(), g.numel()
    # each input read once, each output written once (values and indices 4 B)
    n_bytes = {'max_pool2d': 4 * (n_in + 2 * n_out), 'max_pool2d_grad': 4 * (2 * n_in + n_out),
               'max_unpool2d': 4 * (2 * n_out + n_in), 'max_unpool2d_grad': 4 * (n_in + 2 * n_out)}
    n_ops = {'max_pool2d': 4 * n_out, 'max_pool2d_grad': 8 * n_out, 'max_unpool2d': n_out,
             'max_unpool2d_grad': n_out}
    rows, bad = [], []
    for name, (kernel, plain) in passes.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a.float()).all().item()) for a in got)
        del got, want
        rec = dict(phase='pool_check', kernel=name, layer=L['layer'], frames=L['n'],
                   input=list(shape), pooled=list(pooled), ceil_mode=ceil, ties=L['ties'],
                   max_abs_err=err, finite=finite, ms=median_ms(kernel),
                   plain_ms=median_ms(plain), library_ms=median_ms(library[name]),
                   **bound(n_ops[name], n_bytes[name]))
        emit(rec)
        rows.append(rec)
        if err != 0 or not finite:
            bad.append(name)
    if bad:
        raise AssertionError('%s: %s disagree with their plain versions: %s'
                             % (L['layer'], bad, rows))
    return rows


def check_bn(L, ops, gen):
    """K29 (train mode with the running update at the arch's cumulative
    momentum, and eval mode with running statistics) and K30 (with batch
    statistics) against their plain versions at one batch-norm layer's
    shape, on per-channel offsets and scales like a conv's output; a second
    train-mode call bit for bit. The yardsticks, never called by the port:
    ``F.batch_norm`` in train mode and its autograd backward. K29's and the
    library call's device time alone are timed too (``device_ms``: a small
    layer's call is bound by the host)."""
    dev, c = DEVICE, L['c']
    shape = (L['n'], L['h'], L['w'], c)
    x = torch.randn(shape, device=dev, generator=gen) \
        * (torch.rand(c, device=dev, generator=gen) * 1.5 + 0.5) \
        + torch.randn(c, device=dev, generator=gen)
    gamma = torch.rand(c, device=dev, generator=gen) + 0.5
    beta = torch.randn(c, device=dev, generator=gen) * 0.1
    rm = torch.randn(c, device=dev, generator=gen) * 0.1
    rv = torch.rand(c, device=dev, generator=gen) + 0.5
    g = torch.randn(shape, device=dev, generator=gen)
    momentum, act = POOL_ARCH['ae_batch_norm_momentum'], L['act']
    count = torch.full((), 3, dtype=torch.int64, device=dev)

    run_k = (rm.clone(), rv.clone(), count.clone())
    yk, mk, vk = ops.batch_norm_cuda(x, gamma, beta, running=run_k, momentum=momentum,
                                     activation=act)
    yk2, mk2, vk2 = ops.batch_norm_cuda(x, gamma, beta, activation=act)
    rerun_bitwise = all(bool(torch.equal(a, b)) for a, b in ((yk, yk2), (mk, mk2), (vk, vk2)))
    del yk2, mk2, vk2
    mp, vp = ops.batch_norm_stats_plain(x)
    yp = ops.batch_norm_plain(x, gamma, beta, mp, vp, activation=act)
    new = ops.batch_norm_update(x, {'running_mean': rm, 'running_var': rv,
                                    'num_batches': count}, momentum)
    ye = ops.batch_norm_cuda(x, gamma, beta, mean=rm, var=rv, activation=act)[0]
    yep = ops.batch_norm_plain(x, gamma, beta, rm, rv, activation=act)
    gk = ops.batch_norm_backward_cuda(g, x, gamma, mp, vp, True)
    gp = ops.batch_norm_backward_plain(g, x, gamma, mp, vp, True)
    torch.cuda.synchronize()

    def stat_err(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())
    max_abs, abs_tol, max_rel, finite = errors(yk, yp)
    eval_abs, _, eval_rel, eval_finite = errors(ye, yep)
    stat = max(stat_err(mk, mp), stat_err(vk, vp), stat_err(run_k[0], new['running_mean']),
               stat_err(run_k[1], new['running_var']))
    count_ok = int(run_k[2].item()) == int(new['num_batches'].item()) == 4
    grad_err = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(gk, gp))
    grad_abs = max((a - b).abs().max().item() for a, b in zip(gk, gp))
    grad_finite = all(bool(torch.isfinite(a).all().item()) for a in gk)
    del yk, yp, ye, yep, gk, gp

    run_t = (rm.clone(), rv.clone(), count.clone())
    xl = x.permute(0, 3, 1, 2)
    xg = xl.detach().requires_grad_(True)
    wg, bg = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)
    out_l = F.batch_norm(xg, rm.clone(), rv.clone(), wg, bg, training=True, momentum=0.1)
    gl = g.permute(0, 3, 1, 2)
    n = x.numel()

    def bn_train():
        return ops.batch_norm_cuda(x, gamma, beta, running=run_t, momentum=momentum,
                                   activation=act)

    def bn_eval():
        return ops.batch_norm_cuda(x, gamma, beta, mean=rm, var=rv, activation=act)

    def library_train():
        return F.batch_norm(xl, run_t[0], run_t[1], gamma, beta, training=True, momentum=0.1)
    eval_ms = median_ms(bn_eval)
    rows = []
    for name, kernel, plain, library, n_bytes, n_ops, extra in (
            ('batch_norm', bn_train,
             lambda: ops.batch_norm_plain(x, gamma, beta, activation=act),
             library_train, 8 * n, 10 * n,
             dict(max_abs_err=max_abs, abs_tol=abs_tol, max_rel_err=max_rel, rel_tol=REL_TOL,
                  eval_max_abs_err=eval_abs, eval_max_rel_err=eval_rel,
                  stat_rel_err=stat, stat_rel_tol=BN_STAT_REL_TOL, count_ok=count_ok,
                  rerun_bitwise=rerun_bitwise, eval_ms=eval_ms,
                  eval_share_of_bound=bound(10 * n, 8 * n)['bound_ms'] / eval_ms,
                  device_ms=device_ms(bn_train), eval_device_ms=device_ms(bn_eval),
                  library_device_ms=device_ms(library_train),
                  plan=ops.bn_plan(n // c, c, aligned=x.data_ptr() % 16 == 0))),
            ('batch_norm_backward',
             lambda: ops.batch_norm_backward_cuda(g, x, gamma, mp, vp, True),
             lambda: ops.batch_norm_backward_plain(g, x, gamma, mp, vp, True),
             lambda: torch.autograd.grad(out_l, (xg, wg, bg), gl, retain_graph=True),
             12 * n, 12 * n,
             dict(max_abs_err=grad_abs, grad_rel_err=grad_err,
                  grad_rel_tol=BN_GRAD_REL_TOL))):
        rec = dict(phase='bn_check', kernel=name, layer=L['layer'], frames=L['n'],
                   input=list(shape), activation=act, ms=median_ms(kernel),
                   plain_ms=median_ms(plain), library_ms=median_ms(library),
                   **extra, **bound(n_ops, n_bytes))
        emit(rec)
        rows.append(rec)
    if not (finite and eval_finite and grad_finite and count_ok and rerun_bitwise) \
            or max_abs > abs_tol \
            or max_rel > REL_TOL or eval_abs > abs_tol or eval_rel > REL_TOL \
            or stat > BN_STAT_REL_TOL or grad_err > BN_GRAD_REL_TOL:
        raise AssertionError('%s: K29 / K30 disagree with their plain versions: %s'
                             % (L['layer'], rows))
    return rows


def check_row6(ops, hp, gen):
    """K27-K30 at every pool and batch-norm layer of the pooling arch at the
    192-frame bucket, then K27 / K28 at POOL_ODD in ceil and floor mode with
    planted ties, and K29 / K30 at RAGGED_BN_WIDTHS channels (K29's 4-byte
    path)."""
    pools, bns = row6_shapes(hp, BUCKET)
    odd = [dict(layer='odd_%s' % ('ceil' if ceil else 'floor'), n=4, h=POOL_ODD[0],
                w=POOL_ODD[1], c=8, ceil=ceil, ties=True) for ceil in (True, False)]
    bns = bns + [dict(layer='bn_ragged_%d' % c, n=2 * RAGGED_FRAMES, h=POOL_ODD[0],
                      w=POOL_ODD[1], c=c, act='leaky_relu') for c in RAGGED_BN_WIDTHS]
    rows = []
    for L in pools + odd:
        rows += check_pool(L, ops, gen)
    for L in bns:
        rows += check_bn(L, ops, gen)
    return rows


@contextlib.contextmanager
def recorded_decisions(model, ops):
    """The discrete decisions of every layer ``model`` runs inside the
    block, in order (forward hooks): a pool's indices, its window weights
    (1 / count at each maximum: the even split of a tie) and its output's
    signs, and a fused leaky ReLU's output signs. Max pooling and the leaky
    ReLU's kink are discontinuous: where two float32 paths put a window's
    two largest values, or a pre-activation and 0, within their rounding of
    each other, they send the value and its gradient down different
    branches, and batch norm centres the activations on the kink. One such
    switch moves a small layer's weight gradient (a sum of ~1e4 terms) by
    ~1% of its largest entry, so a plain twin is held to the kernel path
    with these decisions replayed (K27's own are checked exactly)."""
    decisions = []

    def hook(mod, inp, out):
        if type(mod).__name__ == 'MaxPool':
            xw = ops.pool_windows(inp[0].detach(), mod.ceil_mode)
            top = (xw == xw.amax(dim=-1, keepdim=True)).float()
            decisions.append((out[1], top / top.sum(dim=-1, keepdim=True),
                              out[0].detach() >= 0))
        elif mod.activation == 'leaky_relu':
            decisions.append(out.detach() >= 0)
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if type(m).__name__ in ('MaxPool', 'BatchNorm', 'ConvLayer', 'ConvTransposeLayer')]
    try:
        yield decisions
    finally:
        for h in hooks:
            h.remove()


def bn_parameters_close(model, twin):
    """Each parameter's gradient against the plain twin's, relative to the
    largest plain gradient of its layer (a conv bias ahead of batch norm has
    an exact gradient of 0 and only rounding noise of its own); the running
    statistics against the twin's."""
    twin_grads = {k: p.grad for k, p in twin.named_parameters()}
    scale = {}
    for k, gr in twin_grads.items():
        layer = k.rsplit('.', 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), gr.abs().max().item())
    grad_errs = {k: (p.grad - twin_grads[k]).abs().max().item()
                 / max(scale[k.rsplit('.', 1)[0]], 1e-30)
                 for k, p in model.named_parameters()}
    twin_buf = dict(twin.named_buffers())
    run_errs = {k: (b.float() - twin_buf[k].float()).abs().max().item()
                / max(1.0, twin_buf[k].float().abs().max().item())
                for k, b in model.named_buffers() if 'running' in k or 'num_batches' in k}
    return grad_errs, run_errs


def fit_bn(port, hp, tmp, source):
    """Main path 16: ``fit`` of the max-pooling + batch-norm AE on the card
    (an eval epoch, then one train epoch), every logged loss finite, K27-K30
    launched inside it, and in the trainer's resume checkpoint after the
    train epoch every batch norm's count at the train steps and its running
    statistics moved from their init (0, 1) (the best-val model may be the
    epoch-0 one); then ``export_latents`` of the best-val model (main path
    17) in eval mode: no K30 or pool backward, the running statistics
    untouched, and the exported latents those of the plain path in eval
    mode."""
    ops = port.ops
    hp = dict(hp, learning_rate=LEARNING_RATE, l2_reg=L2_REG, rng_seed_train=SEED,
              max_n_epochs=1, min_n_epochs=1, val_check_interval=1, enable_early_stop=False,
              early_stop_history=10, export_latents=False, rng_seed_data=SEED, device=DEVICE,
              experiment_name='pool_bn')
    exp = port.experiment.Experiment('pool_bn', tmp)
    hp['expt_dir'] = os.path.join(tmp, 'pool_bn')
    vdir = os.path.join(hp['expt_dir'], 'version_%d' % exp.version)
    model = port.aes.AE(hp)

    # the main path: every launch from here to the read below is counted
    reset_launches(port.build)
    t0 = time.perf_counter()
    best = port.training.fit(hp, model, source, exp)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    logged = read_metrics(vdir)
    finite = all(len(v) and np.isfinite(v).all() for v in logged.values())
    bns = [k for k, m in model.named_modules() if type(m).__name__ == 'BatchNorm']
    with open(os.path.join(vdir, 'last_checkpoint.pkl'), 'rb') as f:
        trained = pickle.load(f)['model']
    steps = source.n_tot_batches['train']
    moved = {k: int(trained[k + '.num_batches_tracked']) == steps
             and bool(np.abs(trained[k + '.running_mean']).max() > 0)
             and bool(np.abs(trained[k + '.running_var'] - 1).max() > 0) for k in bns}
    emit(dict(phase='fit_bn', epochs=[0, 1], train_trials=steps, frames_per_trial=TRIAL,
              bucket=BUCKET, seconds=fit_s, launches=launches, finite=finite,
              batch_norms=len(bns), trained_stats_moved=all(moved.values()),
              best_num_batches_tracked=sorted({int(b.item()) for k, b in model.named_buffers()
                                               if k.endswith('num_batches_tracked')}),
              losses={k: v for k, v in logged.items() if 'loss' in k}))
    missing = [k for k in BN_KERNELS if launches[k] == 0]
    if missing or not finite or not all(moved.values()):
        raise AssertionError('the pooling + batch-norm fit never launched %s, logged '
                             'non-finite losses or left running statistics at their init: %s'
                             % (missing, moved))

    before = {k: b.clone() for k, b in model.named_buffers()}
    reset_launches(port.build)
    files = port.fit_eval.export_latents(source, model, version=exp.version,
                                         expt_dir=hp['expt_dir'])
    torch.cuda.synchronize()
    export_launches = dict(ops.LAUNCHES)
    untouched = all(torch.equal(b, before[k]) for k, b in model.named_buffers())
    with open(files[0], 'rb') as f:
        exported = pickle.load(f)['latents']
    with torch.inference_mode():
        _, ref = plain_forward(model, ops, torch.from_numpy(source.trials[0]).to(DEVICE),
                               decode=False)
    err = float(np.abs(exported[0] - ref.cpu().numpy()).max())
    tol = SERVE_ABS_TOL * max(1.0, ref.abs().max().item())
    rec = dict(phase='export_bn', trials=len(exported), launches=export_launches,
               running_stats_untouched=untouched, max_abs_err=err, tol=tol)
    emit(rec)
    if not untouched or err > tol or export_launches['batch_norm'] == 0 \
            or export_launches['max_pool2d'] == 0 or export_launches['batch_norm_backward'] \
            or export_launches['max_pool2d_grad']:
        raise AssertionError('export_latents did not run the fitted model in eval mode: %s'
                             % rec)
    return dict(hp, version=exp.version), model, vdir, best, launches, export_launches


def bn_step(port, hp, model, source):
    """One train step of the fitted max-pooling + batch-norm AE (train
    mode) against its plain twin (the plain versions with autograd, the
    kernel path's decisions replayed: ``recorded_decisions``; the twin's
    convolutions with cuDNN off, PyTorch's native CUDA ones: at these
    stride-1 k5 layers cuDNN's float32 algorithms drift from float64 by up
    to ~1e-3, beyond the bounds, see ``check_backward_layer``):
    gradients and running statistics (``bn_parameters_close``); the
    step's time (median of 10 after 3 warm-ups) beside the twin's with
    torch's fused AMSGrad, launches per step, and a profile of five steps
    with K27-K30's device time and the idle share."""
    ops, losses = port.ops, port.losses
    images = np.zeros((BUCKET,) + source.trials[0].shape[1:], np.uint8)
    images[:TRIAL] = source.trials[0]
    frame_mask = np.zeros(BUCKET, np.float32)
    frame_mask[:TRIAL] = 1.0
    batch = {'images': torch.from_numpy(images).to(DEVICE),
             'frame_mask': torch.from_numpy(frame_mask).to(DEVICE)}
    twin = port.aes.AE(hp).to(DEVICE)
    twin.load_state_dict(model.state_dict())
    model.train()
    twin.train()
    model.zero_grad(set_to_none=True)
    with recorded_decisions(model, ops) as decisions:
        model.loss_fn(batch)[0].backward()
    twin.zero_grad(set_to_none=True)
    with torch.backends.cudnn.flags(enabled=False):
        plain_loss(twin, ops, losses, batch, train=True, replay=decisions).backward()
    del decisions
    grad_errs, run_errs = bn_parameters_close(model, twin)
    worst = max(grad_errs, key=grad_errs.get)
    worst_run = max(run_errs, key=run_errs.get)
    emit(dict(phase='bn_step_grads', frames=BUCKET, rel_tol=GRAD_REL_TOL,
              max_rel_err=grad_errs[worst], worst=worst, running_rel_tol=BN_RUNNING_REL_TOL,
              running_max_rel_err=run_errs[worst_run], running_worst=worst_run,
              rel_err=grad_errs))
    if grad_errs[worst] > GRAD_REL_TOL or run_errs[worst_run] > BN_RUNNING_REL_TOL:
        raise AssertionError('the batch-norm step disagrees with the plain twin: %s=%.3g, '
                             '%s=%.3g' % (worst, grad_errs[worst], worst_run,
                                          run_errs[worst_run]))

    opt = port.optim.AMSGrad(model.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG)
    adam = torch.optim.Adam(twin.parameters(), lr=LEARNING_RATE, weight_decay=L2_REG,
                            amsgrad=True, fused=True)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss_fn(batch)[0].backward()
        opt.step()

    def plain_step():
        adam.zero_grad(set_to_none=True)
        plain_loss(twin, ops, losses, batch, train=True).backward()
        adam.step()
    reset_launches(port.build)
    step()
    torch.cuda.synchronize()
    per_step = dict(ops.LAUNCHES)
    ms, plain_ms = request_ms(step), request_ms(plain_step)
    emit(dict(phase='bn_step', frames=TRIAL, bucket=BUCKET, ms=ms,
              frames_per_s=TRIAL / ms * 1e3, plain_ms=plain_ms,
              plain_frames_per_s=TRIAL / plain_ms * 1e3, launches_per_step=per_step))
    host_batch = {'images': images, 'frame_mask': frame_mask}
    emit(profile_steps(lambda: step_from_host(step, host_batch, batch), phase='bn_step_profile',
                       arch='pool_bn'))
    model.eval()
    return per_step


def device_ms(fn, calls=10):
    """Device time of one call of ``fn``: its kernels' time over ``calls``
    calls (``torch.profiler``, after two warm-up calls), divided by
    ``calls``; None where the profiler saw no kernel."""
    rec = profile_steps(fn, steps=calls, phase='device_ms', groups={'all': ('',)})
    return rec['ms_per_step_by_kernel']['all'] if rec['device_events'] else None


def device_kernels(fn):
    """The names of the device kernels that one call of ``fn`` ran
    (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


def serve_bn(port, hp, vdir, best, source):
    """Main path 18: the fitted max-pooling + batch-norm version served
    through ``serving.load_version`` (eval mode): ``encode`` and
    ``reconstruct`` of 1, 189 and 1024 frames within SERVE_ABS_TOL of the
    plain path in eval mode (the request's pool decisions replayed:
    ``recorded_decisions``), each answer the same bits when asked again,
    the served weights the fitted ones, no
    backward launched, the running statistics untouched, and no batch
    statistics pass in a request's profile (K29 applies the running
    statistics alone)."""
    ops = port.ops
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump(dict(hp, training_completed=True), f)
    frames = source.trials.reshape((-1,) + source.trials.shape[2:])
    reset_launches(port.build)
    bundle = port.serving.load_version(vdir)
    answers = {(head, n): getattr(bundle, head)(frames[:n])
               for n in REQUEST_SIZES for head in ('encode', 'reconstruct')}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    served = dict(bundle.model.state_dict())
    same = all(torch.equal(served[k].cpu(), v) for k, v in
               port.weights.params_to_state_dict(bundle.model, best).items())
    untouched = all(torch.equal(served[k].cpu(), v) for k, v in
                    port.weights.params_to_state_dict(bundle.model, best).items()
                    if 'running' in k or 'num_batches' in k)
    names = device_kernels(lambda: bundle.reconstruct(frames[:TRIAL]))
    stats_pass = sorted(n for n in names if 'bn_train_kernel' in n)
    apply_seen = any('bn_apply_kernel' in n for n in names)
    emit(dict(phase='serve_bn_launches', device=str(bundle.device), launches=launches,
              weights_equal=same, running_stats_untouched=untouched,
              stats_kernels_in_request=stats_pass, apply_kernel_in_request=apply_seen))
    missing = [k for k in BN_SERVE_KERNELS if launches[k] == 0]
    backward = [k for k in ('max_pool2d_grad', 'max_unpool2d_grad', 'batch_norm_backward',
                            'conv2d_grad_w_nhwc') if launches[k]]
    if missing or backward or not same or not untouched or stats_pass or not apply_seen:
        raise AssertionError('serving the batch-norm version: missing %s, backward %s, '
                             'weights equal %s, statistics untouched %s, statistics pass %s'
                             % (missing, backward, same, untouched, stats_pass))
    for n in REQUEST_SIZES:
        for head in ('encode', 'reconstruct'):
            with torch.inference_mode(), recorded_decisions(bundle.model, ops) as decisions:
                again = getattr(bundle, head)(frames[:n])
                y, z = plain_forward(bundle.model, ops,
                                     torch.from_numpy(frames[:n]).to(bundle.device),
                                     decode=head == 'reconstruct', replay=decisions)
            ref = z if head == 'encode' else y
            del decisions, y, z
            out = answers[(head, n)]
            want = (n, N_LATENTS) if head == 'encode' else (n, IMG[1], IMG[2], IMG[0])
            ok_shape = tuple(out.shape) == want and out.dtype == torch.float32
            finite = bool(torch.isfinite(out).all().item())
            same = torch.equal(out, again)
            err = (out - ref).abs().max().item()
            tol = SERVE_ABS_TOL * max(1.0, ref.abs().max().item())
            rec = dict(phase='serve_bn', head=head, frames=n, shape=list(out.shape),
                       finite=finite, repeatable=same, max_abs_err=err, tol=tol,
                       ms=request_ms(lambda: getattr(bundle, head)(frames[:n]), reps=3,
                                     warmup=1),
                       plain_ms=request_ms(lambda: plain_request(bundle, ops, frames[:n], head),
                                           reps=3, warmup=1))
            rec['frames_per_s'] = n / rec['ms'] * 1e3
            emit(rec)
            if not (ok_shape and finite and same and err <= tol):
                raise AssertionError('served %s of %d frames is wrong: %s' % (head, n, rec))
    return launches


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


def only_conv(port, ctx):
    """Every conv layer of both archs (forward and backward), the ragged
    shapes and ``conv_summary``."""
    with tf32_off():
        checks = arch_conv_checks(port.ops, ctx.hp, ctx.gen)
        checks += arch_conv_checks(port.ops, ctx.pool_hp, ctx.pool_gen, 'pool.', POOL_TIMING)
        check_ragged(port.ops, ctx.ragged_gen)
    conv_summary(checks)


def only_optimizer(port, ctx):
    """K6's ``optimizer_check`` over the default AE's parameters."""
    with tf32_off():
        check_amsgrad(port.optim, port.aes.AE(ctx.hp).to(DEVICE), ctx.gen)


def only_lstm_step(port, ctx):
    """The LSTM decoder step at LSTM_STEP_HIDDEN beside its plain twin."""
    with tempfile.TemporaryDirectory() as tmp:
        lstm_wide_step(port, tmp)


def only_bn(port, ctx):
    """K27-K30 at every row-6 layer (``check_row6``)."""
    with tf32_off():
        check_row6(port.ops, ctx.pool_hp, ctx.pool_gen)


def only_ae_steps(port, ctx):
    """The default AE's train step (``train``: its ``fit``, gradients, step
    and profile), the pooling + batch-norm AE's (``fit_bn``, ``bn_step``)
    and the MSPS-VAE's (``fit_msps``, ``msps_step``), each beside its plain
    twin."""
    with tempfile.TemporaryDirectory() as tmp, tf32_off():
        train(port, ctx.hp, tmp)
        bn_source = TrialSource(BN_FIT_TRIALS, SEED + 5)
        bn_hp, bn_model = fit_bn(port, ctx.pool_hp, tmp, bn_source)[:2]
        bn_step(port, bn_hp, bn_model, bn_source)
        del bn_model
        msps_source = MultiSessionSource(TRAIN_TRIALS, SEED + 4, N_LABELS)
        ms_hp, ms_model = fit_msps(port, ctx.hp, tmp, msps_source)[:2]
        msps_step(port, ms_hp, ms_model, msps_source)


# the phases ``--only`` may name: each takes the port and main's context
ONLY_PHASES = {'conv': only_conv, 'optimizer': only_optimizer,
               'lstm': lambda port, ctx: check_lstm(port), 'lstm_step': only_lstm_step,
               'bn': only_bn, 'ae_steps': only_ae_steps}


def main():
    parser = argparse.ArgumentParser(description='Chip smoke test of behavenet_tpu_torch.')
    parser.add_argument('--cards', type=int, default=None,
                        help='run only the mesh paths across this many cards (mesh_cards)')
    parser.add_argument('--only', default=None, metavar='PHASE[,PHASE]',
                        help='run only these phases, in this order: %s'
                             % ', '.join(ONLY_PHASES))
    args = parser.parse_args()
    only = args.only.split(',') if args.only else []
    if any(name not in ONLY_PHASES for name in only):
        parser.error('--only takes phases of %s' % ', '.join(ONLY_PHASES))
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
    emit(dict(phase='build', seconds=seconds, library_seconds=port.build.build_seconds(),
              ptxas=port.build.ptxas_info()))
    conv_ptxas(port.build)
    lstm_optim_ptxas(port.build)
    if args.cards is not None:
        if not 2 <= args.cards <= torch.cuda.device_count():
            raise SystemExit('--cards takes 2..%d here' % torch.cuda.device_count())
        mesh_cards(port, args.cards)
        emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                     'count': torch.cuda.device_count()}})
        return 0

    hp = model_hparams(port.arch)
    pool_hp = pool_hparams(port.arch)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    # row 6's and the ragged checks draw from generators of their own: the
    # earlier checks keep their inputs
    pool_gen = torch.Generator(device=DEVICE)
    pool_gen.manual_seed(SEED + 12)
    ragged_gen = torch.Generator(device=DEVICE)
    ragged_gen.manual_seed(SEED + 17)
    if only:
        ctx = types.SimpleNamespace(hp=hp, pool_hp=pool_hp, gen=gen, pool_gen=pool_gen,
                                    ragged_gen=ragged_gen)
        for name in only:
            ONLY_PHASES[name](port, ctx)
        return 0
    with tf32_off():
        checks = arch_conv_checks(ops, hp, gen)
        checks.append(check_mse(port.losses, gen))
        checks.append(check_amsgrad(port.optim, port.aes.AE(hp).to(DEVICE), gen))
        checks += [check_decomposed_kl(port.losses, gen, d) for d in KL_DIMS]
        em_model, em_trials, init_s = em_workload(port)
        checks += [check(port, em_model, em_trials) for check in (
            check_arhmm_log_likes, check_forward_backward, check_viterbi, check_solve_small)]
        init_params = dict(em_model.params)
        rec_models = recurrent_models(port, em_model)
        checks.append(check_robust_log_likes(port, rec_models['recurrent'], em_trials))
        checks += [check(port, rec_models, em_trials)
                   for check in (check_forward_backward_tv, check_viterbi_tv)]
        checks += check_mstep(port, em_model, em_trials)
        checks += check_f64_kernels(port, em_model, rec_models, em_trials)
        checks += check_row18c(port, rec_models, em_trials)
        rec_params = dict(rec_models['recurrent'].params)
        scan_in = scan_cases(port, em_model, rec_models, em_trials)
        for check in (check_scan, check_viterbi_scan):
            checks += check(port, scan_in)
        checks += check_sample_posterior(port, scan_in, gen)
        checks += check_forward_alpha(port, scan_in)
        del scan_in
        checks.append(check_sample_states(port, em_model, gen))
        check_posterior_marginals(port, em_model, em_trials, gen)
        checks += check_imm(port)
        checks += check_kalman(port)
        checks += check_triplet(port)
        checks += arch_conv_checks(ops, pool_hp, pool_gen, 'pool.', POOL_TIMING)
        checks += check_row6(ops, pool_hp, pool_gen)
        check_ragged(ops, ragged_gen)
    conv_summary(checks)
    checks += [check_gaussian_nll(port.losses, gen, d) for d in NLL_DIMS]
    for d in NLL_DIMS:
        check_nll_draws(port.losses, d)
    checks.append(check_mse(port.losses, gen, decoder=True))
    checks += check_lstm(port)

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
            msps_source = MultiSessionSource(TRAIN_TRIALS, SEED + 4, N_LABELS)
            ms_hp, ms_model, ms_dir, ms_best, launches['fit_msps-vae'] = fit_msps(
                port, hp, tmp, msps_source)
            msps_step(port, ms_hp, ms_model, msps_source)
            launches['serve_msps-vae'] = serve_msps(port, ms_hp, ms_dir, ms_best, msps_source)
            del ms_model
            bn_source = TrialSource(BN_FIT_TRIALS, SEED + 5)
            bn_hp, bn_model, bn_dir, bn_best, launches['fit_bn'], launches['export_bn'] = \
                fit_bn(port, pool_hp, tmp, bn_source)
            launches['bn_step'] = bn_step(port, bn_hp, bn_model, bn_source)
            launches['serve_bn'] = serve_bn(port, bn_hp, bn_dir, bn_best, bn_source)
            del bn_model
            launches['arhmm_em'] = arhmm_em(port, em_model, em_trials, init_s)
            par_model = port.arhmm.ARHMM(EM_STATES, EM_DIM, lags=1, rng_seed=SEED,
                                         parallel_scan=True, device=DEVICE)
            par_model.params = init_params
            launches['arhmm_em_parallel'] = arhmm_em_parallel(
                port, par_model, em_trials, PARALLEL_EM_KERNELS, EM_ITERS)
            launches['arhmm_em_recurrent'] = arhmm_em_recurrent(
                port, recurrent_arhmm(port, em_model, 'recurrent', 'robust_ar'), em_trials)
            launches['arhmm_em_recurrent_parallel'] = arhmm_em_parallel(
                port, recurrent_arhmm(port, em_model, 'recurrent', 'robust_ar',
                                      parallel_scan=True),
                em_trials, PARALLEL_REC_EM_KERNELS, REC_EM_ITERS)
            launches['arhmm_em_f64'] = arhmm_em_f64(port, init_params, rec_params, em_trials)
            launches['arhmm_long_session'], long_run = long_session(port, em_model)
            checks += check_sp_kernels(port, long_run, rec_models['recurrent'])
            launches['arhmm_em_sp'] = arhmm_em_sp(port, init_params, rec_params,
                                                  long_run['data'], em_trials)
            launches['arhmm_sp_serve'] = arhmm_sp_serve(port, em_model, long_run)
            del long_run
            launches['bayesian_long_session'], long_case = bayesian_long_session(port, em_model)
            checks += check_sp_kalman(port, {'long': long_case['ins'], 'cli': soft_lds(
                port, BAYES_STATES, 1, TRIAL, SEED + 20, bucket=BUCKET)})
            del em_model, em_trials, rec_models, par_model, init_params, rec_params
            stat_cli = arhmm_cli(port, tmp)
            launches['arhmm_cli'] = stat_cli.launches
            vdir, cli_latents = stat_cli.vdirs[max(stat_cli.vdirs)], stat_cli.latents
            launches['arhmm_serve'] = arhmm_serve(port, vdir, cli_latents)
            launches['arhmm_sample_serve'] = arhmm_sample_serve(
                port, vdir, cli_latents, ('hmm_forward_alpha', 'hmm_sample_posterior',
                                          'hmm_sample_states'))
            cli = arhmm_cli(port, tmp, RECURRENT_KERNELS, transitions='recurrent',
                            noise_type='studentst')
            launches['arhmm_cli_recurrent'] = cli.launches
            vdir, cli_latents = cli.vdirs[max(cli.vdirs)], cli.latents
            launches['arhmm_serve_recurrent'] = arhmm_serve(
                port, vdir, cli_latents, ('arhmm_log_likes_robust', 'hmm_forward_backward_tv',
                                          'hmm_viterbi_tv'))
            launches['arhmm_sample_serve_recurrent'] = arhmm_sample_serve(
                port, vdir, cli_latents, ('hmm_forward_alpha_tv', 'hmm_sample_posterior_tv'))
            par_cli = arhmm_cli(port, tmp, PARALLEL_CLI_KERNELS, parallel_scan=True)
            launches['arhmm_cli_parallel'] = par_cli.launches
            vdir, cli_latents = par_cli.vdirs[max(par_cli.vdirs)], par_cli.latents
            launches['arhmm_serve_parallel'] = arhmm_serve(
                port, vdir, cli_latents, ('arhmm_log_likes', 'hmm_scan', 'hmm_viterbi_scan'))
            launches['arhmm_sample_serve_parallel'] = arhmm_sample_serve(
                port, vdir, cli_latents, ('hmm_scan', 'hmm_sample_posterior',
                                          'hmm_sample_states'))
            f64_cli = arhmm_cli(port, tmp, F64_CLI_KERNELS, em_dtype='float64',
                                n_arhmm_states=F64_CLI_GRID)
            launches['arhmm_cli_f64'] = f64_cli.launches
            launches['arhmm_serve_f64'] = arhmm_serve(
                port, f64_cli.vdirs[max(f64_cli.vdirs)], f64_cli.latents,
                ('arhmm_log_likes_f64', 'hmm_forward_backward_f64', 'hmm_viterbi_f64'),
                dtype='float64')
            launches['bayesian_cli'], preds, logits = bayesian_cli(
                port, tmp, stat_cli, BAYES_KERNELS)
            launches['bayesian_serve'] = bayesian_serve(
                port, stat_cli.vdirs[BAYES_STATES], stat_cli.latents, preds, logits,
                BAYES_KERNELS)
            launches['bayesian_serve_parallel'] = bayesian_serve(
                port, par_cli.vdirs[BAYES_STATES], par_cli.latents, preds, logits,
                BAYES_PARALLEL_KERNELS, name='bayesian_serve_parallel')
            launches['bayesian_cli_parallel'] = bayesian_cli(
                port, tmp, stat_cli, BAYES_ASSOC_KERNELS, name='bayesian_cli_parallel',
                parallel=True)[0]
            launches['bayesian_decode_parallel'] = bayesian_serve(
                port, stat_cli.vdirs[BAYES_STATES], stat_cli.latents, preds, logits,
                BAYES_ASSOC_KERNELS, name='bayesian_decode_parallel', parallel=True)
            launches['kalman_ops'] = kalman_ops(port)
            cli_dec = port.bayesian.BayesianDecoder(port.pickles.load_arhmm(
                os.path.join(stat_cli.vdirs[BAYES_STATES], 'best_val_model.pt')))
            cli_dec.estimate_obs_noise(stat_cli.latents[:40], preds[:40])
            softmax = port.bayesian_decoder_grid_search._softmax_rows
            launches['bayesian_sp_serve'] = bayesian_sp_serve(port, {
                'long': (long_case['dec'], long_case['y'], long_case['q']),
                'cli': (cli_dec, preds[-1], softmax(logits[-1]))})
            del long_case, cli_dec
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
        lstm_hp, lstm_model, lstm_dir, lstm_best, lstm_source, _ = fitted['neural-ae-lstm']
        launches['decoder_step_lstm'] = decoder_step(port, lstm_hp, lstm_model, lstm_source)[0]
        launches['decoder_serve_lstm'] = serve_decoder(port, lstm_hp, lstm_dir, lstm_best,
                                                       lstm_source)
        launches['decoder_step_lstm%d' % LSTM_STEP_HIDDEN] = lstm_wide_step(port, tmp)

    rows = [kernel_row(name, [r for r in checks if r['kernel'] == name], launches)
            for name in KERNELS]
    idle = [r['name'] for r in rows if r['launches'] == 0]
    if idle:
        raise AssertionError('kernels that no main path launched: %s' % idle)
    emit({'kernels': rows})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
