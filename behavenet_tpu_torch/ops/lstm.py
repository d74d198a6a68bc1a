"""The LSTM decoder's recurrence (the port of ``behavenet_tpu/models/
decoders.py:168 LSTM._run`` and of its autodiff).

One direction maps a trial ``x`` (T, in) to its hidden states ``hs`` (T, h)
through the step of JAX, with zero initial state::

    gates = [x_t, h] @ w + b           w (in + h, 4h), b (4h,)
    i, f, g, o = split(gates, 4)
    c = sigmoid(f) c + sigmoid(i) tanh(g)
    h = sigmoid(o) tanh(c)

``w`` keeps the JAX package's layout: rows the input then the hidden units,
columns the gate blocks i, f, g, o. The reversed direction walks t = T-1 ...
0 over the whole array it is given (JAX runs ``x[::-1]`` and reverses the
outputs), padding rows included: a trial padded to its bucket starts that
chain on the zero rows, as in JAX.

:func:`lstm_scan` runs one or both directions in one call, as a
``torch.autograd.Function`` picked by the input's device and by nothing
else: on a ``cuda`` tensor K23 (``bn_lstm_forward``, ``kernels/lstm.cu``)
forward and K24 (``bn_lstm_backward``, counted as ``lstm_backward``) for
the gradients; on a ``cpu`` tensor the plain version, differentiated by
autograd. When no input needs a gradient (``torch.no_grad``,
``torch.inference_mode``, serving), the forward saves nothing and the
kernel writes the hidden states only.
"""

import torch

from behavenet_tpu_torch.kernels.build import launch
from behavenet_tpu_torch.ops.hmm import _check_tensors

__all__ = ['lstm_scan', 'lstm_scan_plain', 'lstm_run_plain', 'lstm_forward_cuda',
           'lstm_backward_cuda', 'bptt_plan', 'dx_frames']


def lstm_run_plain(x, w, b, reverse=False, dtype=None):
    """Hidden states (..., T, h) of one direction over ``x`` (..., T, in)
    (JAX: models/decoders.py:168 ``LSTM._run``, step for step; ``reverse``
    as JAX :185 runs ``x[::-1]``), in ``dtype`` (default: the inputs')."""
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    h_dim = w.shape[1] // 4
    T = x.shape[-2]
    h = x.new_zeros(x.shape[:-2] + (h_dim,))
    c = x.new_zeros(x.shape[:-2] + (h_dim,))
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = torch.cat([x[..., t, :], h], dim=-1) @ w + b
        i, f, g, o = gates.split(h_dim, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=-2)


def lstm_scan_plain(x, w_f, b_f, w_b=None, b_b=None, dtype=None):
    """The plain version of :func:`lstm_scan`: the forward direction's hidden
    states, and the reversed one's beside them, in ``dtype``."""
    hs = lstm_run_plain(x, w_f, b_f, dtype=dtype)
    if w_b is None:
        return hs
    return torch.cat([hs, lstm_run_plain(x, w_b, b_b, reverse=True, dtype=dtype)], dim=-1)


# -------------------------------------------------------------- the kernels


def _sizes(name, x, ws, bs=None):
    """(N, T, in, h, directions) of a call on (N, T, in) inputs with the
    weights ``ws`` (and biases ``bs``) of each direction, all float32 on one
    CUDA device."""
    bs = [] if bs is None else list(bs)
    _check_tensors(name, [x] + list(ws) + bs, [torch.float32] * (1 + len(ws) + len(bs)))
    if x.dim() != 3 or ws[0].dim() != 2 or ws[0].shape[1] % 4:
        raise ValueError('%s: takes x (N, T, in) and w (in + h, 4h), got %s and %s'
                         % (name, tuple(x.shape), tuple(ws[0].shape)))
    N, T, d_in = x.shape
    h = ws[0].shape[1] // 4
    if any(tuple(w.shape) != (d_in + h, 4 * h) for w in ws) or \
            any(tuple(b.shape) != (4 * h,) for b in bs):
        raise ValueError('%s: takes w (%d, %d) and b (%d,) beside x %s, got %s'
                         % (name, d_in + h, 4 * h, 4 * h, tuple(x.shape),
                            [tuple(t.shape) for t in list(ws) + bs]))
    if min(N, T, d_in, h) < 1:
        raise ValueError('%s: takes nonempty x and h >= 1, got x %s, h %d'
                         % (name, tuple(x.shape), h))
    return N, T, d_in, h, len(ws)


def _ptr(t):
    return None if t is None else t.data_ptr()


# K24's chain (kernels/lstm.cu): cluster sizes, threads a row of W_hh, a CTA
BPTT_CLUSTERS = (1, 2, 4, 8)
BPTT_MAX_THREADS = 1024


def bptt_plan(h, smem_optin):
    """K24's chain at width ``h`` on a device whose blocks may opt in to
    ``smem_optin`` shared bytes: the fewest CTAs a cluster (``cluster``) whose
    share of W_hh, ``rows`` = ceil(h / cluster) rows of 4h floats, fits
    beside the two dG buffers of 4h floats (``smem`` bytes), with
    ``threads_per_row`` 8, 16 or 32 (at most 16 column chunks of 4 floats a
    thread where the CTA's 1024 threads allow) and ``threads`` a CTA. Above
    the widest h that 8 CTAs hold, ``cluster`` 0: the one-block chain, with
    the ``rows`` that fit on chip (padded to 4h + 1 floats beside 6h) and a
    thread a row, the others read through L2."""
    for c in BPTT_CLUSTERS:
        rows = -(-h // c)
        smem = 4 * (rows + 2) * 4 * h
        tpr = 8 if h <= 128 else 16 if h <= 256 else 32
        while rows * tpr > BPTT_MAX_THREADS and tpr > 8:
            tpr //= 2
        if smem <= smem_optin and rows * tpr <= BPTT_MAX_THREADS:
            return dict(cluster=c, rows=rows, threads_per_row=tpr,
                        threads=-(-rows * tpr // 32) * 32, smem=smem)
    base = 4 * 6 * h
    rows = max(0, min(h, (smem_optin - base) // (4 * (4 * h + 1))))
    return dict(cluster=0, rows=rows, threads_per_row=1,
                threads=min(BPTT_MAX_THREADS, -(-h // 32) * 32), smem=base + rows * 4 * (4 * h + 1))


# frames of dG one block of K24's dx kernel stages (kernels/lstm.cu)
DX_FRAMES = (8, 4, 2, 1)


def dx_frames(h, dirs, smem_optin):
    """The frames of dG (``dirs`` 4h floats each) one block of K24's dx
    kernel stages in shared memory: the most of DX_FRAMES that fit in
    ``smem_optin`` bytes, 0 when not even one frame does."""
    return next((f for f in DX_FRAMES if f * dirs * 16 * h <= smem_optin), 0)


def _smem_optin():
    """The shared bytes a block may opt in to on the current CUDA device
    (48 KiB, what every device allows, where torch does not say)."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return getattr(props, 'shared_memory_per_block_optin', 48 * 1024)


def _on_cpu(t):
    return t.device.type == 'cpu'


def lstm_forward_cuda(x, w_f, b_f, w_b=None, b_b=None, train=False):
    """K23 on the card: ``hs`` (N, T, h * directions) of x (N, T, in), the
    forward direction's then the reversed one's, as :func:`lstm_scan_plain`. With
    ``train`` also what K24 reads: the cell states (N, directions, T, h) and
    the gate activations (N, directions, T, 4h)."""
    name = 'lstm_forward'
    N, T, d_in, h, nd = _sizes(name, x, [w_f] + ([] if w_b is None else [w_b]),
                               [b_f] + ([] if b_b is None else [b_b]))
    x, w_f, b_f = x.contiguous(), w_f.contiguous(), b_f.contiguous()
    if nd == 2:
        w_b, b_b = w_b.contiguous(), b_b.contiguous()
    dev = x.device
    gx = torch.empty((N, nd, T, 4 * h), device=dev, dtype=torch.float32)
    hs = torch.empty((N, T, nd * h), device=dev, dtype=torch.float32)
    cs = torch.empty((N, nd, T, h), device=dev, dtype=torch.float32) if train else None
    acts = torch.empty((N, nd, T, 4 * h), device=dev, dtype=torch.float32) if train else None
    launch(name, x.data_ptr(), w_f.data_ptr(), b_f.data_ptr(), _ptr(w_b), _ptr(b_b),
           N, T, d_in, h, nd, gx.data_ptr(), hs.data_ptr(), _ptr(cs), _ptr(acts),
           symbol='bn_lstm_forward')
    return hs, cs, acts


def lstm_backward_cuda(x, w_f, w_b, hs, cs, acts, grad_hs, with_dx=False):
    """K24 on the card: BPTT of :func:`lstm_forward_cuda` from its saved
    ``hs``, ``cs`` and ``acts`` at upstream gradient ``grad_hs`` (N, T,
    h * directions). Returns (dx (N, T, in) or None, dw_f, db_f, dw_b, db_b),
    the reversed direction's None without it; dw and db are fixed-order sums
    over the trials and frames. The chain runs as :func:`bptt_plan` picks
    for h and the device, dx in blocks of :func:`dx_frames` frames."""
    name = 'lstm_backward'
    N, T, d_in, h, nd = _sizes(name, x, [w_f] + ([] if w_b is None else [w_b]))
    _check_tensors(name, (hs, cs, acts, grad_hs), [torch.float32] * 4)
    if tuple(hs.shape) != (N, T, nd * h) or tuple(grad_hs.shape) != (N, T, nd * h) or \
            tuple(cs.shape) != (N, nd, T, h) or tuple(acts.shape) != (N, nd, T, 4 * h):
        raise ValueError('%s: takes the forward\'s hs, cs and acts and a gradient of hs\'s '
                         'shape %s' % (name, (N, T, nd * h)))
    x, w_f, grad_hs = x.contiguous(), w_f.contiguous(), grad_hs.contiguous()
    w_b = None if w_b is None else w_b.contiguous()
    dev = x.device
    dg = torch.empty((N, nd, T, 4 * h), device=dev, dtype=torch.float32)
    dwb = torch.empty((nd, d_in + h + 1, 4 * h), device=dev, dtype=torch.float32)
    dx = torch.empty_like(x) if with_dx else None
    optin = _smem_optin()
    plan = bptt_plan(h, optin)
    frames = dx_frames(h, nd, optin) if with_dx else 0
    if with_dx and not frames:
        raise ValueError('%s: dx needs %d shared bytes a block at h = %d, the device allows %d'
                         % (name, nd * 16 * h, h, optin))
    launch('lstm_forward', x.data_ptr(), w_f.data_ptr(), _ptr(w_b), hs.data_ptr(),
           cs.data_ptr(), acts.data_ptr(), grad_hs.data_ptr(), N, T, d_in, h, nd,
           plan['cluster'], plan['threads_per_row'], frames, dg.data_ptr(), dwb.data_ptr(),
           _ptr(dx), symbol='bn_lstm_backward')
    grads = [dwb[0, :d_in + h], dwb[0, d_in + h]]
    grads += [dwb[1, :d_in + h], dwb[1, d_in + h]] if nd == 2 else [None, None]
    return (dx,) + tuple(grads)


class _LSTMFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, train, x, w_f, b_f, w_b, b_b):
        if _on_cpu(x):
            if train:
                ctx.save_for_backward(x, w_f, b_f, w_b, b_b)
            return lstm_scan_plain(x, w_f, b_f, w_b, b_b)
        hs, cs, acts = lstm_forward_cuda(x[None], w_f, b_f, w_b, b_b, train=train)
        if train:
            ctx.save_for_backward(x, w_f, w_b, hs, cs, acts)
        return hs[0]

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[1:]
        if _on_cpu(grad):
            # the plain version again, differentiated by autograd
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_(n)
                          for t, n in zip(ctx.saved_tensors, need)]
                wanted = [t for t in leaves if t is not None and t.requires_grad]
                got = iter(torch.autograd.grad(lstm_scan_plain(*leaves), wanted, grad))
            return (None,) + tuple(next(got) if t is not None and t.requires_grad else None
                                   for t in leaves)
        x, w_f, w_b, hs, cs, acts = ctx.saved_tensors
        dx, *rest = lstm_backward_cuda(x[None], w_f, w_b, hs, cs, acts, grad[None],
                                       with_dx=need[0])
        dx = None if dx is None else dx[0]
        return (None,) + tuple(g if n else None for g, n in zip([dx] + rest, need))


def lstm_scan(x, w_f, b_f, w_b=None, b_b=None):
    """Hidden states of the LSTM over a trial ``x`` (T, in): the forward
    direction (``w_f`` (in + h, 4h), ``b_f`` (4h,)), and with ``w_b``,
    ``b_b`` the reversed one beside it, (T, h) or (T, 2h) (JAX:
    models/decoders.py:183-186). K23 / K24 on the card, the plain version
    on the CPU; gradients reach every input."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('lstm_scan: no implementation for device %s' % x.device)
    if x.dim() != 2:
        raise ValueError('lstm_scan: takes one trial (T, in), got %s' % (tuple(x.shape),))
    if (w_b is None) != (b_b is None):
        raise ValueError('lstm_scan: the reversed direction takes both w_b and b_b')
    inputs = [t for t in (x, w_f, b_f, w_b, b_b) if t is not None]
    # grad mode is off inside a Function's forward, so it is read here
    train = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    return _LSTMFn.apply(train, x, w_f, b_f, w_b, b_b)
