"""Build the port's CUDA kernels with ``nvcc``, load them with ``ctypes``
and launch them.

Each ``.cu`` source in this directory compiles, at first use, into its own
shared library (two for the sources in ``_SPLIT_F64``: their float and
float64 launchers) with a plain C interface (``extern "C"`` launchers that take
device pointers and a CUDA stream, and return the ``cudaError_t`` of the
launch). The libraries go into ``behavenet_tpu_torch/_build/`` (git-ignored),
named by a hash of every source and header and of the flags, so an edited
source rebuilds and a stale library is never loaded. All libraries compile
in parallel, one ``nvcc`` process each.

There is no fallback: a missing ``nvcc`` or a failed build raises, and so
does a launch that returns an error. :func:`launch` counts each launch in
``LAUNCHES``, which callers may zero to see what a piece of work ran: under
the kernel's name, or under the name of a variant (``VARIANTS``) for the
launchers that a later slice added beside a kernel's first ones.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ['SOURCES', 'VARIANTS', 'LAUNCHES', 'build_all', 'library', 'launch', 'dtype_suffix',
           'check_device', 'ptxas_info', 'build_seconds']

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')

# kernel name -> its source in this directory
SOURCES = {
    'conv2d_nhwc': 'conv2d_nhwc.cu',
    'conv_transpose2d_nhwc': 'conv_transpose2d_nhwc.cu',
    'conv_transpose2d_smallcout_sigmoid': 'conv_transpose2d_smallcout_sigmoid.cu',
    'conv2d_grad_w_nhwc': 'conv2d_grad_w_nhwc.cu',
    'masked_mse': 'masked_mse.cu',
    'amsgrad_step': 'amsgrad_step.cu',
    'decomposed_kl': 'decomposed_kl.cu',
    'arhmm_log_likes': 'arhmm_log_likes.cu',
    'hmm_forward_backward': 'hmm_forward_backward.cu',
    'hmm_viterbi': 'hmm_viterbi.cu',
    'solve_small': 'solve_small.cu',
    'gaussian_nll': 'gaussian_nll.cu',
    'hmm_scan': 'hmm_scan.cu',
    'hmm_sample_posterior': 'hmm_sample.cu',
    'imm_filter': 'imm.cu',
    'kalman_filter_scan': 'kalman.cu',
    'lstm_forward': 'lstm.cu',
    'triplet_loss': 'triplet.cu',
    'max_pool2d': 'pool.cu',
    'batch_norm': 'batch_norm.cu',
    'arhmm_mstep_stats': 'arhmm_mstep.cu',
    'hmm_shard_totals': 'hmm_shard.cu',
    'kalman_shard_filter_totals': 'kalman_shard.cu',
    'arhmm_recurrent_mstep': 'arhmm_recurrent_mstep.cu',
    'arhmm_nu_mstep': 'arhmm_nu_mstep.cu',
}
_HEADERS = ('conv_tiles.h', 'igemm_sm90.cuh', 'hmm.cuh', 'hmm_backtrace.cuh', 'hmm_scan.cuh',
            'kalman_scan.cuh')

# launchers counted under a name of their own: variant -> (kernel, symbols);
# K14 and K16 share a source with K13 and K15, K18 (the RTS smoother) with
# K17 (the IMM filter), K20-K22 (the associative smoother, the sequential
# filter and smoother) with K19 (the associative filter), K24 (the LSTM's
# backward) with K23 (its forward), K26 (the triplet loss's backward) with
# K25 (its forward), K27's backward and K28 (the unpool, forward and
# backward) with K27 (the max pool), K30 (batch norm's backward) with K29
# (batch norm), K31's second pass (the residual covariance) with its first
# (the statistics), K33-K35 (a time shard's finish, map total and
# backtrace) with K32 (its totals), K37-K39 (the time-sharded Kalman
# filter's finish, the smoother's totals and finish) with K36 (the
# filter's totals); K40's prep, step and update launchers and K41's pass
# and finish count as their kernel; K9's
# forward pass that writes the
# filtered alphas for K15 and K11's pivoting solve are counted apart from
# their kernels' other launchers, and so is every float64 launcher
# (``_f64``: float64 EM), K32's (max, +) form and each of K33's and K34's
# modes
VARIANTS = {
    'arhmm_log_likes_robust': ('arhmm_log_likes', ('bn_arhmm_log_likes_robust',)),
    'hmm_forward_backward_tv': ('hmm_forward_backward',
                                ('bn_hmm_forward_backward_tv', 'bn_hmm_forward_tv')),
    'hmm_forward_alpha': ('hmm_forward_backward', ('bn_hmm_forward_alpha',)),
    'hmm_forward_alpha_tv': ('hmm_forward_backward', ('bn_hmm_forward_alpha_tv',)),
    'hmm_viterbi_tv': ('hmm_viterbi', ('bn_hmm_viterbi_tv',)),
    'hmm_scan_tv': ('hmm_scan', ('bn_hmm_scan_forward_backward_tv', 'bn_hmm_scan_forward_tv')),
    'hmm_viterbi_scan': ('hmm_scan', ('bn_hmm_viterbi_scan',)),
    'hmm_viterbi_scan_tv': ('hmm_scan', ('bn_hmm_viterbi_scan_tv',)),
    'hmm_sample_posterior_tv': ('hmm_sample_posterior', ('bn_hmm_sample_posterior_tv',)),
    'hmm_sample_states': ('hmm_sample_posterior', ('bn_hmm_sample_states',)),
    'rts_smoother': ('imm_filter', ('bn_rts_smoother',)),
    'solve_small_pivot': ('solve_small', ('bn_solve_small_pivot',)),
    'kalman_smoother_scan': ('kalman_filter_scan', ('bn_kalman_smoother_scan',)),
    'kalman_filter': ('kalman_filter_scan', ('bn_kalman_filter',)),
    'kalman_smoother': ('kalman_filter_scan', ('bn_kalman_smoother',)),
    'lstm_backward': ('lstm_forward', ('bn_lstm_backward',)),
    'triplet_loss_grad': ('triplet_loss', ('bn_triplet_loss_grad',)),
    'max_pool2d_grad': ('max_pool2d', ('bn_max_pool2d_grad',)),
    'max_unpool2d': ('max_pool2d', ('bn_max_unpool2d',)),
    'max_unpool2d_grad': ('max_pool2d', ('bn_max_unpool2d_grad',)),
    'batch_norm_backward': ('batch_norm', ('bn_batch_norm_backward',)),
    'arhmm_mstep_cov': ('arhmm_mstep_stats', ('bn_arhmm_mstep_cov',)),
    'arhmm_mstep_stats_f64': ('arhmm_mstep_stats', ('bn_arhmm_mstep_stats_f64',)),
    'arhmm_mstep_cov_f64': ('arhmm_mstep_stats', ('bn_arhmm_mstep_cov_f64',)),
    'arhmm_log_likes_f64': ('arhmm_log_likes', ('bn_arhmm_log_likes_f64',)),
    'arhmm_log_likes_robust_f64': ('arhmm_log_likes', ('bn_arhmm_log_likes_robust_f64',)),
    'hmm_forward_backward_f64': ('hmm_forward_backward', ('bn_hmm_forward_backward_f64',)),
    'hmm_forward_backward_tv_f64': ('hmm_forward_backward',
                                    ('bn_hmm_forward_backward_tv_f64',)),
    'hmm_forward_f64': ('hmm_forward_backward', ('bn_hmm_forward_f64',)),
    'hmm_forward_tv_f64': ('hmm_forward_backward', ('bn_hmm_forward_tv_f64',)),
    'hmm_viterbi_f64': ('hmm_viterbi', ('bn_hmm_viterbi_f64',)),
    'hmm_viterbi_tv_f64': ('hmm_viterbi', ('bn_hmm_viterbi_tv_f64',)),
    'solve_small_f64': ('solve_small', ('bn_solve_small_f64',)),
    'hmm_shard_totals_maxplus': ('hmm_shard_totals', ('bn_hmm_shard_totals_maxplus',
                                                      'bn_hmm_shard_totals_maxplus_tv')),
    'hmm_shard_finish': ('hmm_shard_totals', ('bn_hmm_shard_finish', 'bn_hmm_shard_finish_tv')),
    'hmm_shard_finish_alpha': ('hmm_shard_totals', ('bn_hmm_shard_alpha',
                                                    'bn_hmm_shard_alpha_tv')),
    'hmm_shard_finish_viterbi': ('hmm_shard_totals', ('bn_hmm_shard_viterbi',
                                                      'bn_hmm_shard_viterbi_tv')),
    'hmm_shard_maps': ('hmm_shard_totals', ('bn_hmm_shard_maps',)),
    'hmm_shard_maps_sample': ('hmm_shard_totals', ('bn_hmm_shard_sample_maps',
                                                   'bn_hmm_shard_sample_maps_tv')),
    'hmm_shard_backtrace': ('hmm_shard_totals', ('bn_hmm_shard_backtrace',)),
    'kalman_shard_filter_finish': ('kalman_shard_filter_totals',
                                   ('bn_kalman_shard_filter_finish',)),
    'kalman_shard_smoother_totals': ('kalman_shard_filter_totals',
                                     ('bn_kalman_shard_smoother_totals',)),
    'kalman_shard_smoother_finish': ('kalman_shard_filter_totals',
                                     ('bn_kalman_shard_smoother_finish',)),
    'arhmm_recurrent_mstep_f64': ('arhmm_recurrent_mstep', (
        'bn_arhmm_recurrent_prep_f64', 'bn_arhmm_recurrent_step_f64',
        'bn_arhmm_recurrent_update_f64')),
    'arhmm_nu_mstep_f64': ('arhmm_nu_mstep', ('bn_arhmm_nu_pass_f64', 'bn_arhmm_nu_finish_f64')),
}
_COUNTED_AS = {sym: variant for variant, (_, syms) in VARIANTS.items() for sym in syms}

# launches of each kernel and variant since the last reset (callers may zero them)
LAUNCHES = {name: 0 for name in list(SOURCES) + list(VARIANTS)}
_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
          '-shared', '-Xcompiler', '-fPIC', '-lineinfo', '-Xptxas', '-v']

_P, _I, _L, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_double)
# C signature of each launcher: kernel name -> {symbol: argtypes}; the first
# symbol is the kernel's default launcher
_SIGNATURES = {
    'conv2d_nhwc': {'bn_conv2d_nhwc': [_P, _I, _P, _P, _P] + [_I] * 18 + [_P]},
    'conv_transpose2d_nhwc': {
        'bn_conv_transpose2d_nhwc': [_P, _P, _P, _P] + [_I] * 20 + [_P]},
    'conv_transpose2d_smallcout_sigmoid': {
        'bn_conv_transpose2d_smallcout': [_P, _P, _P, _P] + [_I] * 12 + [_P]},
    'conv2d_grad_w_nhwc': {
        'bn_conv2d_grad_w_nhwc': [_P, _I, _P, _P, _P] + [_I] * 24 + [_P]},
    'masked_mse': {
        'bn_masked_mse_fwd': [_P, _P, _I, _P, _P, _P, _P, _I, _L, _I, _P],
        'bn_masked_mse_bwd': [_P, _P, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P]},
    'amsgrad_step': {'bn_amsgrad_step': [_P, _I] + [_F] * 7 + [_P]},
    'decomposed_kl': {
        'bn_decomposed_kl_fwd': [_P] * 4 + [_I] * 2 + [_P] * 6,
        'bn_decomposed_kl_bwd': [_P] * 4 + [_I] * 2 + [_P] * 8},
    'arhmm_log_likes': {
        'bn_arhmm_log_likes': [_P] * 6 + [_I] * 7 + [_P, _P],
        'bn_arhmm_log_likes_robust': [_P] * 7 + [_I] * 7 + [_P] * 3,
        'bn_arhmm_log_likes_f64': [_P] * 6 + [_I] * 7 + [_P, _P],
        'bn_arhmm_log_likes_robust_f64': [_P] * 7 + [_I] * 7 + [_P] * 3},
    'hmm_forward_backward': {
        'bn_hmm_forward_backward': [_P] * 4 + [_I] * 3 + [_P] * 6,
        'bn_hmm_forward': [_P] * 4 + [_I] * 3 + [_P] * 2,
        'bn_hmm_forward_backward_tv': [_P] * 4 + [_I] * 3 + [_P] * 7,
        'bn_hmm_forward_tv': [_P] * 4 + [_I] * 3 + [_P] * 2,
        'bn_hmm_forward_alpha': [_P] * 4 + [_I] * 3 + [_P] * 3,
        'bn_hmm_forward_alpha_tv': [_P] * 4 + [_I] * 3 + [_P] * 3,
        'bn_hmm_forward_backward_f64': [_P] * 4 + [_I] * 3 + [_P] * 6,
        'bn_hmm_forward_backward_tv_f64': [_P] * 4 + [_I] * 3 + [_P] * 7,
        'bn_hmm_forward_f64': [_P] * 4 + [_I] * 3 + [_P] * 2,
        'bn_hmm_forward_tv_f64': [_P] * 4 + [_I] * 3 + [_P] * 2},
    'hmm_viterbi': {'bn_hmm_viterbi': [_P] * 4 + [_I] * 3 + [_P] * 3,
                    'bn_hmm_viterbi_tv': [_P] * 4 + [_I] * 3 + [_P] * 3,
                    'bn_hmm_viterbi_f64': [_P] * 4 + [_I] * 3 + [_P] * 3,
                    'bn_hmm_viterbi_tv_f64': [_P] * 4 + [_I] * 3 + [_P] * 3},
    'solve_small': {'bn_solve_small': [_P] * 3 + [_I] * 3 + [_P],
                    'bn_solve_small_pivot': [_P] * 3 + [_I] * 3 + [_P],
                    'bn_solve_small_f64': [_P] * 3 + [_I] * 3 + [_P]},
    'gaussian_nll': {
        'bn_gaussian_nll_fwd': [_P] * 6 + [_I] * 2 + [_P],
        'bn_gaussian_nll_bwd': [_P] * 8 + [_I] * 2 + [_P]},
    'hmm_scan': {
        'bn_hmm_scan_forward_backward': [_P] * 4 + [_I] * 4 + [_P] * 9,
        'bn_hmm_scan_forward_backward_tv': [_P] * 4 + [_I] * 4 + [_P] * 10,
        'bn_hmm_scan_forward': [_P] * 4 + [_I] * 4 + [_P] * 5,
        'bn_hmm_scan_forward_tv': [_P] * 4 + [_I] * 4 + [_P] * 5,
        'bn_hmm_viterbi_scan': [_P] * 4 + [_I] * 4 + [_P] * 7,
        'bn_hmm_viterbi_scan_tv': [_P] * 4 + [_I] * 4 + [_P] * 7},
    'hmm_sample_posterior': {
        'bn_hmm_sample_posterior': [_P] * 5 + [_I] * 4 + [_P] * 5,
        'bn_hmm_sample_posterior_tv': [_P] * 5 + [_I] * 4 + [_P] * 5,
        'bn_hmm_sample_states': [_P] * 4 + [_I] * 3 + [_P] * 2},
    'imm_filter': {
        'bn_imm_filter': [_P] * 9 + [_I] * 4 + [_P] * 5,
        'bn_rts_smoother': [_P] * 6 + [_I] * 3 + [_P] * 3},
    'kalman_filter_scan': {
        'bn_kalman_filter_scan': [_P] * 9 + [_I] * 4 + [_P] * 4,
        'bn_kalman_smoother_scan': [_P] * 5 + [_I] * 3 + [_P] * 4,
        'bn_kalman_filter': [_P] * 9 + [_I] * 3 + [_P] * 5,
        'bn_kalman_smoother': [_P] * 5 + [_I] * 2 + [_P] * 3},
    'lstm_forward': {
        'bn_lstm_forward': [_P] * 5 + [_I] * 5 + [_P] * 5,
        'bn_lstm_backward': [_P] * 7 + [_I] * 8 + [_P] * 4},
    'triplet_loss': {
        'bn_triplet_loss': [_P, _I, _I, _P, _P, _P] + [_I] * 9 + [_F, _F] + [_P] * 4,
        'bn_triplet_loss_grad': [_P, _I, _I, _P, _P, _P] + [_I] * 9 + [_F, _F] + [_P] * 3
        + [_I, _P]},
    'max_pool2d': {
        'bn_max_pool2d': [_P] * 3 + [_I] * 7 + [_P],
        'bn_max_pool2d_grad': [_P] * 3 + [_I] * 6 + [_P],
        'bn_max_unpool2d': [_P] * 3 + [_I] * 6 + [_P],
        'bn_max_unpool2d_grad': [_P] * 3 + [_I] * 6 + [_P]},
    'batch_norm': {
        'bn_batch_norm': [_P, _P],   # a packed BnArgs (batch_norm.cu)
        'bn_batch_norm_backward': [_P] * 9 + [_L, _I, _I, _L, _F, _I, _P]},
    'arhmm_mstep_stats': {
        'bn_arhmm_mstep_stats': [_P] * 4 + [_I] * 6 + [_P] * 5,
        'bn_arhmm_mstep_cov': [_P] * 5 + [_I] * 7 + [_P] * 3,
        'bn_arhmm_mstep_stats_f64': [_P] * 4 + [_I] * 6 + [_P] * 5,
        'bn_arhmm_mstep_cov_f64': [_P] * 5 + [_I] * 7 + [_P] * 3},
    'hmm_shard_totals': {
        'bn_hmm_shard_totals': [_P] * 5 + [_I] * 4 + [_P] * 3,
        'bn_hmm_shard_totals_tv': [_P] * 5 + [_I] * 4 + [_P] * 3,
        'bn_hmm_shard_totals_maxplus': [_P] * 5 + [_I] * 4 + [_P] * 3,
        'bn_hmm_shard_totals_maxplus_tv': [_P] * 5 + [_I] * 4 + [_P] * 3,
        'bn_hmm_shard_finish': [_P, _I, _I] + [_P] * 6 + [_I] * 4 + [_P] * 10,
        'bn_hmm_shard_finish_tv': [_P, _I, _I] + [_P] * 6 + [_I] * 4 + [_P] * 10,
        'bn_hmm_shard_alpha': [_P, _I, _I] + [_P] * 5 + [_I] * 4 + [_P] * 5,
        'bn_hmm_shard_alpha_tv': [_P, _I, _I] + [_P] * 5 + [_I] * 4 + [_P] * 5,
        'bn_hmm_shard_viterbi': [_P, _I, _I] + [_P] * 5 + [_I] * 4 + [_P] * 7,
        'bn_hmm_shard_viterbi_tv': [_P, _I, _I] + [_P] * 5 + [_I] * 4 + [_P] * 7,
        'bn_hmm_shard_maps': [_P] * 2 + [_I] * 4 + [_P] * 3,
        'bn_hmm_shard_sample_maps': [_P] * 8 + [_I] * 4 + [_P] * 6,
        'bn_hmm_shard_sample_maps_tv': [_P] * 8 + [_I] * 4 + [_P] * 6,
        'bn_hmm_shard_backtrace': [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 4 + [_P] * 3},
    'kalman_shard_filter_totals': {
        'bn_kalman_shard_filter_totals': [_P] * 9 + [_I] * 5 + [_P] * 3,
        'bn_kalman_shard_filter_finish': [_P, _I, _I] + [_P] * 9 + [_I] * 4 + [_P] * 4,
        'bn_kalman_shard_smoother_totals': [_P] * 5 + [_I] * 4 + [_P] * 3,
        'bn_kalman_shard_smoother_finish': [_P, _I, _I] + [_P] * 5 + [_I] * 3 + [_P] * 4},
    'arhmm_recurrent_mstep': {
        'bn_arhmm_recurrent_prep': [_P] * 2 + [_I] * 6 + [_P] * 3,
        'bn_arhmm_recurrent_step': [_P] * 3 + [_I] * 6 + [_P] * 2,
        'bn_arhmm_recurrent_update': [_P, _I, _P, _I] + [_I] * 4 + [_D] + [_P] * 4,
        'bn_arhmm_recurrent_prep_f64': [_P] * 2 + [_I] * 6 + [_P] * 3,
        'bn_arhmm_recurrent_step_f64': [_P] * 3 + [_I] * 6 + [_P] * 2,
        'bn_arhmm_recurrent_update_f64': [_P, _I, _P, _I] + [_I] * 4 + [_D] + [_P] * 4},
    'arhmm_nu_mstep': {
        'bn_arhmm_nu_pass': [_P] * 3 + [_L, _P] + [_I] * 5 + [_P] * 2,
        'bn_arhmm_nu_finish': [_P, _I, _I] + [_P] * 3,
        'bn_arhmm_nu_pass_f64': [_P] * 3 + [_L, _P] + [_I] * 5 + [_P] * 2,
        'bn_arhmm_nu_finish_f64': [_P, _I, _I] + [_P] * 3,
        'bn_arhmm_digamma': [_P, _P, _I, _P]},
}

# sources built as two libraries side by side: the float launchers
# (``-DBN_F64=0``) and the float64 ones (``-DBN_F64=1``, the ``_f64``
# symbols), whose double instances alone take nvcc as long as the rest
_SPLIT_F64 = ('arhmm_log_likes', 'hmm_forward_backward')

_lock = threading.Lock()
_launchers = {}
_ptxas = {}
_seconds = {}


def _parts(name):
    """(library suffix, nvcc flags) of each library kernel ``name`` builds."""
    if name in _SPLIT_F64:
        return (('', ['-DBN_F64=0']), ('_f64', ['-DBN_F64=1']))
    return (('', []),)


def _nvcc():
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, $PATH and '
                       '/usr/local/cuda/bin); the CUDA kernels cannot be built')


def _tag():
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    for fname in sorted(SOURCES.values()) + list(_HEADERS):
        with open(os.path.join(_HERE, fname), 'rb') as f:
            h.update(fname.encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def build_all():
    """Compile every kernel that is not built yet (in parallel) and load it.

    Returns the seconds spent compiling (0.0 when every library was there).
    Raises ``RuntimeError`` with nvcc's output if a build fails.
    """
    import time
    with _lock:
        if len(_launchers) == len(SOURCES):
            return 0.0
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = _tag()
        jobs = {}
        for name, src in SOURCES.items():
            for part, defines in _parts(name):
                so = os.path.join(BUILD_DIR, 'lib%s%s_%s.so' % (name, part, tag))
                if os.path.exists(so):
                    continue
                tmp = '%s.tmp.%d' % (so, os.getpid())
                cmd = [_nvcc()] + _FLAGS + defines + ['-o', tmp, os.path.join(_HERE, src)]
                log = open(tmp + '.log', 'w+b')
                jobs[name + part] = (so, tmp, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT))
        failed = []
        while jobs:  # as each finishes, so that its seconds are its own
            for lib_name, (so, tmp, log, proc) in list(jobs.items()):
                if proc.poll() is None:
                    continue
                del jobs[lib_name]
                _seconds[lib_name] = time.perf_counter() - t0
                log.seek(0)
                out = log.read().decode(errors='replace')
                log.close()
                os.remove(tmp + '.log')
                _ptxas[lib_name] = [ln.strip() for ln in out.splitlines() if 'Used' in ln or
                                    'spill' in ln or 'Function properties' in ln]
                if proc.returncode != 0:
                    failed.append('%s (nvcc rc %d):\n%s' % (lib_name, proc.returncode, out))
                    continue
                os.replace(tmp, so)  # atomic: concurrent builds converge
            time.sleep(0.05)
        if failed:
            raise RuntimeError('CUDA kernel build failed: ' + '\n'.join(failed))
        for name in SOURCES:
            libs = {part: ctypes.CDLL(os.path.join(BUILD_DIR, 'lib%s%s_%s.so' % (name, part, tag)))
                    for part, _ in _parts(name)}
            fns = {}
            for sym, argtypes in _SIGNATURES[name].items():
                fn = getattr(libs['_f64' if '_f64' in libs and sym.endswith('_f64') else ''], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[sym] = fn
            _launchers[name] = fns
        return time.perf_counter() - t0


def library(name, symbol=None):
    """The ``ctypes`` launcher ``symbol`` (default: the first) of kernel
    ``name``, building on first use."""
    if name not in _launchers:
        build_all()
    fns = _launchers[name]
    return fns[symbol or next(iter(_SIGNATURES[name]))]


def launch(name, *args, symbol=None):
    """Launch kernel ``name`` (its launcher ``symbol``) on PyTorch's current
    stream with ``args``; raise if the launch fails, else count it under
    the kernel's name or its variant's."""
    import torch
    # the raw handle of torch.cuda.current_stream(), without building its
    # Python object (a few microseconds a launch)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = library(name, symbol)(*args, stream)
    if err != 0:
        raise RuntimeError('%s: kernel launch failed (cudaError %d)' % (name, err))
    LAUNCHES[_COUNTED_AS.get(symbol, name)] += 1


def dtype_suffix(name, tensors, float64=True):
    """Check a launch's ``tensors``: all float32, or (with ``float64``) all
    float64, on one CUDA device. Returns the suffix of the launchers of
    that dtype: '' or '_f64'."""
    import torch
    x = tensors[0]
    dtypes = (torch.float32, torch.float64) if float64 else (torch.float32,)
    if any(t.dtype not in dtypes or t.dtype != x.dtype for t in tensors):
        raise ValueError('%s: tensors must be all float32%s, got %s'
                         % (name, ' or all float64' if float64 else '',
                            [t.dtype for t in tensors]))
    check_device(name, tensors)
    return '_f64' if x.dtype == torch.float64 else ''


def check_device(name, tensors):
    """Raise unless every tensor lies on one CUDA device and that device is
    the current one, whose stream :func:`launch` takes: a caller with
    tensors on another card runs its launches under
    ``torch.cuda.device(...)``."""
    import torch
    dev = tensors[0].device
    if any(t.device.type != 'cuda' or t.device != dev for t in tensors):
        raise ValueError('%s: every tensor must lie on one CUDA device, got %s'
                         % (name, [str(t.device) for t in tensors]))
    if dev.index != torch.cuda.current_device():
        raise ValueError('%s: the tensors lie on %s but the current device is cuda:%d; launch '
                         'under torch.cuda.device(%r)'
                         % (name, dev, torch.cuda.current_device(), str(dev)))


def ptxas_info():
    """Register and spill lines nvcc printed for each library built here
    (a kernel's name, ``_f64`` appended for the float64 library of a split
    source), each spill line after the (mangled) name of its function."""
    return dict(_ptxas)


def build_seconds():
    """Seconds from the start of the last build to the end of each
    library's ``nvcc`` (named as in :func:`ptxas_info`)."""
    return dict(_seconds)
