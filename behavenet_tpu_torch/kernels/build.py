"""Build the port's CUDA kernels with ``nvcc``, load them with ``ctypes``
and launch them.

Each ``.cu`` source in this directory compiles, at first use, into its own
shared library with a plain C interface (``extern "C"`` launchers that take
device pointers and a CUDA stream, and return the ``cudaError_t`` of the
launch). The libraries go into ``behavenet_tpu_torch/_build/`` (git-ignored),
named by a hash of every source and header and of the flags, so an edited
source rebuilds and a stale library is never loaded. All sources compile in
parallel, one ``nvcc`` process each.

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

__all__ = ['SOURCES', 'VARIANTS', 'LAUNCHES', 'build_all', 'library', 'launch', 'ptxas_info']

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
}
_HEADERS = ('igemm.cuh', 'hmm.cuh', 'hmm_backtrace.cuh')

# launchers counted under a name of their own: variant -> (kernel, symbols);
# K14 and K16 share a source with K13 and K15, and K9's forward pass that
# writes the filtered alphas for K15 is counted apart from its other
# launchers
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
}
_COUNTED_AS = {sym: variant for variant, (_, syms) in VARIANTS.items() for sym in syms}

# launches of each kernel and variant since the last reset (callers may zero them)
LAUNCHES = {name: 0 for name in list(SOURCES) + list(VARIANTS)}
_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
          '-shared', '-Xcompiler', '-fPIC', '-lineinfo', '-Xptxas', '-v']

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each launcher: kernel name -> {symbol: argtypes}; the first
# symbol is the kernel's default launcher
_SIGNATURES = {
    'conv2d_nhwc': {'bn_conv2d_nhwc': [_P, _I, _P, _P, _P] + [_I] * 12 + [_P]},
    'conv_transpose2d_nhwc': {
        'bn_conv_transpose2d_nhwc': [_P, _P, _P, _P] + [_I] * 12 + [_P]},
    'conv_transpose2d_smallcout_sigmoid': {
        'bn_conv_transpose2d_smallcout': [_P, _P, _P, _P] + [_I] * 12 + [_P]},
    'conv2d_grad_w_nhwc': {
        'bn_conv2d_grad_w_nhwc': [_P, _I, _P, _P, _P] + [_I] * 14 + [_P]},
    'masked_mse': {
        'bn_masked_mse_fwd': [_P, _P, _I, _P, _P, _P, _P, _I, _L, _I, _P],
        'bn_masked_mse_bwd': [_P, _P, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P]},
    'amsgrad_step': {'bn_amsgrad_step': [_P, _I] + [_F] * 7 + [_P]},
    'decomposed_kl': {
        'bn_decomposed_kl_fwd': [_P] * 4 + [_I] * 2 + [_P] * 6,
        'bn_decomposed_kl_bwd': [_P] * 4 + [_I] * 2 + [_P] * 8},
    'arhmm_log_likes': {
        'bn_arhmm_log_likes': [_P] * 6 + [_I] * 7 + [_P, _P],
        'bn_arhmm_log_likes_robust': [_P] * 7 + [_I] * 7 + [_P] * 3},
    'hmm_forward_backward': {
        'bn_hmm_forward_backward': [_P] * 4 + [_I] * 3 + [_P] * 6,
        'bn_hmm_forward': [_P] * 4 + [_I] * 3 + [_P] * 2,
        'bn_hmm_forward_backward_tv': [_P] * 4 + [_I] * 3 + [_P] * 7,
        'bn_hmm_forward_tv': [_P] * 4 + [_I] * 3 + [_P] * 2,
        'bn_hmm_forward_alpha': [_P] * 4 + [_I] * 3 + [_P] * 3,
        'bn_hmm_forward_alpha_tv': [_P] * 4 + [_I] * 3 + [_P] * 3},
    'hmm_viterbi': {'bn_hmm_viterbi': [_P] * 4 + [_I] * 3 + [_P] * 3,
                    'bn_hmm_viterbi_tv': [_P] * 4 + [_I] * 3 + [_P] * 3},
    'solve_small': {'bn_solve_small': [_P] * 3 + [_I] * 3 + [_P]},
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
}

_lock = threading.Lock()
_launchers = {}
_ptxas = {}


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
            so = os.path.join(BUILD_DIR, 'lib%s_%s.so' % (name, tag))
            if os.path.exists(so):
                continue
            tmp = '%s.tmp.%d' % (so, os.getpid())
            cmd = [_nvcc()] + _FLAGS + ['-o', tmp, os.path.join(_HERE, src)]
            jobs[name] = (so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        failed = []
        for name, (so, tmp, proc) in jobs.items():
            log = proc.communicate()[0].decode(errors='replace')
            _ptxas[name] = [ln.strip() for ln in log.splitlines()
                            if 'Used' in ln or 'spill' in ln]
            if proc.returncode != 0:
                failed.append('%s (nvcc rc %d):\n%s' % (name, proc.returncode, log))
                continue
            os.replace(tmp, so)  # atomic: concurrent builds converge
        if failed:
            raise RuntimeError('CUDA kernel build failed: ' + '\n'.join(failed))
        for name in SOURCES:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, 'lib%s_%s.so' % (name, tag)))
            fns = {}
            for sym, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, sym)
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
    err = library(name, symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError('%s: kernel launch failed (cudaError %d)' % (name, err))
    LAUNCHES[_COUNTED_AS.get(symbol, name)] += 1


def ptxas_info():
    """Register and spill lines nvcc printed for each kernel built here."""
    return dict(_ptxas)
