"""Kalman filtering and smoothing of a time-varying linear-Gaussian model:
sequential scans and parallel associative scans (the port of
``behavenet_tpu/ops/kalman.py``).

    x_t = F_t x_{t-1} + c_t + w_t,   w_t ~ N(0, Q_t)      (t = 1..T-1)
    x_0 ~ N(F_0 m0 + c_0, F_0 P0 F_0^T + Q_0)
    y_t = H x_t + v_t,               v_t ~ N(0, R)        (t = 0..T-1)

(F_0 = I, c_0 = 0, Q_0 ~ 0 use N(m0, P0) directly as the prior of x_0.)
``mask`` marks the steps with an observation; the others are pure
predictions. Shapes: F (T, n, n), c (T, n), Q (T, n, n), H (d, n), R (d, d),
y (T, d), mask (T,), m0 (n,), P0 (n, n).

The parallel forms reassociate the recursions as prefix products of
five-tuple (filter) and three-tuple (smoother) elements (Sarkka and
Garcia-Fernandez, IEEE TAC 2021), scanned by ``ops.scans``. The Bayesian
decoder's ``decode(parallel=True)`` runs them over its gamma-weighted
dynamics.

Each public function runs a kernel of ``kernels/kalman.cu`` on ``cuda``
tensors and its plain PyTorch version on ``cpu`` tensors, picked from the
input's device and from nothing else:

- :func:`filter_parallel`: K19 (``bn_kalman_filter_scan``);
- :func:`smooth_parallel`: K20 (``bn_kalman_smoother_scan``, counted as
  ``kalman_smoother_scan``);
- :func:`filter_sequential`: K21 (``bn_kalman_filter``, ``kalman_filter``);
- :func:`smooth_sequential`: K22 (``bn_kalman_smoother``,
  ``kalman_smoother``).

``parallel.seq``'s time-sharded passes run K36-K39 of
``kernels/kalman_shard.cu`` through the ``shard_*_cuda`` wrappers here: a
shard's filtering total (K36, ``bn_kalman_shard_filter_totals``) and its
filtered moments from the gathered totals (K37,
``kalman_shard_filter_finish``), its smoothing total (K38,
``kalman_shard_smoother_totals``) and its smoothed moments (K39,
``kalman_shard_smoother_finish``). They have no public dispatcher of their
own: their plain versions are ``parallel.seq``'s ``sp_kalman_*_plain``.

K19 and K20 compute what the associative scans compute, not their tree:
each chunk of L = ``ops.hmm.scan_chunk(T)`` steps is composed into one
element, the chunk totals are carried in order, and each chunk then runs
the sequential recursion from its entry moments. ``chunk`` of the public
parallel functions is the plain version's two-level scan (JAX's, which
bounds its compile time); the kernels chunk by L whatever it is.

The plain versions are JAX's, line for line and in its operation order,
with the JAX package's Gauss-Jordan solve (pivoted in the filter's
combine); their ``dtype`` lets a caller run them in float64.
"""

import torch

from behavenet_tpu_torch.kernels.build import launch
from behavenet_tpu_torch.ops.hmm import _check_tensors, _dispatch, scan_chunk
from behavenet_tpu_torch.ops.scans import chunked_prefix_scan, prefix_scan
from behavenet_tpu_torch.ops.smallmat import solve_small_plain

__all__ = ['filter_sequential', 'filter_parallel', 'smooth_sequential', 'smooth_parallel',
           'filter_sequential_plain', 'filter_parallel_plain', 'smooth_sequential_plain',
           'smooth_parallel_plain', 'filter_sequential_cuda', 'filter_parallel_cuda',
           'smooth_sequential_cuda', 'smooth_parallel_cuda', 'shard_filter_totals_cuda',
           'shard_filter_finish_cuda', 'shard_smoother_totals_cuda',
           'shard_smoother_finish_cuda', 'MAX_N', 'MAX_D']

MAX_N = 32   # the widest state the kernels take (the decoder's D = 16 at lags 2)
MAX_D = 16   # the widest observation


def _cast(dtype, *tensors):
    return [t if dtype is None else t.to(dtype) for t in tensors]


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    """Batched matrix-vector product (..., n, m) @ (..., m) -> (..., n)."""
    return (M @ v[..., None])[..., 0]


# ------------------------------------------------------------ plain versions


def filter_sequential_plain(F, c, Q, H, R, y, mask, m0, P0, dtype=None):
    """The Kalman filter as a sequential scan (JAX: ops/kalman.py:38).
    Returns (ms (T, n), Ps (T, n, n), m_pred (T, n), P_pred (T, n, n)), in
    ``dtype`` (default: the inputs')."""
    F, c, Q, H, R, y, mask, m0, P0 = _cast(dtype, F, c, Q, H, R, y, mask, m0, P0)

    def update(m_p, P_p, y_t, msk):
        S = H @ P_p @ H.T + R
        K = solve_small_plain(S, H @ P_p).T   # (n, d)
        m_u = m_p + K @ (y_t - H @ m_p)
        P_u = _sym(P_p - K @ H @ P_p)
        return torch.where(msk > 0, m_u, m_p), torch.where(msk > 0, P_u, P_p)

    m, P = m0, P0
    outs = []
    for t in range(y.shape[0]):
        m_p = F[t] @ m + c[t]
        P_p = _sym(F[t] @ P @ F[t].T + Q[t])
        m, P = update(m_p, P_p, y[t], mask[t])
        outs.append((m, P, m_p, P_p))
    return tuple(torch.stack(x) for x in zip(*outs))


def _filter_elements(F, c, Q, H, R, y, mask, m0, P0):
    """Per-step associative filtering elements (A, b, C, eta, J) (JAX:
    ops/kalman.py:70); element 0 absorbs the prior."""
    n = F.shape[1]
    S = H @ Q @ H.T + R                                  # (T, d, d)
    K = solve_small_plain(S, H @ Q).transpose(-1, -2)    # (T, n, d)
    A = F - K @ H @ F
    v = y - _mv(H, c)
    b = c + _mv(K, v)
    C = _sym(Q - K @ H @ Q)
    HS = solve_small_plain(S, H @ F)                     # S^-1 H F (T, d, n)
    eta = _mv(HS.transpose(-1, -2), v)
    J = _sym(HS.transpose(-1, -2) @ (H @ F))
    # masked step: pure prediction element
    on = mask > 0
    A = torch.where(on[:, None, None], A, F)
    b = torch.where(on[:, None], b, c)
    C = torch.where(on[:, None, None], C, Q)
    eta = torch.where(on[:, None], eta, torch.zeros_like(eta))
    J = torch.where(on[:, None, None], J, torch.zeros_like(J))

    # element 0 absorbs the prior: predict through (F_0, c_0, Q_0), update
    m_p0 = F[0] @ m0 + c[0]
    P_p0 = _sym(F[0] @ P0 @ F[0].T + Q[0])
    S0 = H @ P_p0 @ H.T + R
    K0 = solve_small_plain(S0, H @ P_p0).T
    b0_u = m_p0 + K0 @ (y[0] - H @ m_p0)
    C0_u = _sym(P_p0 - K0 @ H @ P_p0)
    A, b, C, eta, J = (x.clone() for x in (A, b, C, eta, J))
    A[0] = 0.0
    b[0] = torch.where(mask[0] > 0, b0_u, m_p0)
    C[0] = torch.where(mask[0] > 0, C0_u, P_p0)
    eta[0] = 0.0
    J[0] = 0.0
    return A, b, C, eta, J


def _filter_combine(e1, e2):
    """Associative filtering-element combination (JAX: ops/kalman.py:111;
    Sarkka and Garcia-Fernandez eq. 10-11). M = (I + C1 J2)^-1 by the
    pivoted solve: I + C1 J2 is not symmetric, and its leading minors need
    not be nonsingular."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = A1.shape[-1]
    I = torch.eye(n, dtype=A1.dtype, device=A1.device)
    lhs = I + C1 @ J2
    M = solve_small_plain(lhs, I.expand(lhs.shape), pivot=True)
    A = A2 @ M @ A1
    b = (A2 @ M @ (b1[..., None] + C1 @ eta2[..., None]))[..., 0] + b2
    C = _sym(A2 @ M @ C1 @ A2.transpose(-1, -2) + C2)
    N = M.transpose(-1, -2)
    eta = (A1.transpose(-1, -2) @ N @ (eta2[..., None] - J2 @ b1[..., None]))[..., 0] + eta1
    J = _sym(A1.transpose(-1, -2) @ N @ J2 @ A1 + J1)
    return A, b, C, eta, J


def filter_parallel_plain(F, c, Q, H, R, y, mask, m0, P0, chunk=None, dtype=None):
    """The parallel-prefix Kalman filter (JAX: ops/kalman.py:132): (ms, Ps),
    the same as :func:`filter_sequential_plain`'s first two outputs up to
    roundoff; ``chunk`` scans in chunks of that many steps (JAX's two-level
    scan)."""
    F, c, Q, H, R, y, mask, m0, P0 = _cast(dtype, F, c, Q, H, R, y, mask, m0, P0)
    n = F.shape[1]
    elems = _filter_elements(F, c, Q, H, R, y, mask, m0, P0)
    if chunk:
        z = F.new_zeros
        identity = (torch.eye(n, dtype=F.dtype, device=F.device), z(n), z(n, n), z(n),
                    z(n, n))
        A, b, C, eta, J = chunked_prefix_scan(_filter_combine, elems, identity, chunk)
    else:
        A, b, C, eta, J = prefix_scan(_filter_combine, elems)
    return b, C


def smooth_sequential_plain(F, c, Q, ms, Ps, m_pred, P_pred, dtype=None):
    """The RTS smoother as a reverse sequential scan over the filtered and
    predicted moments (JAX: ops/kalman.py:152); ``m_pred[t], P_pred[t]`` are
    the prediction into step t. Returns (ms_s, Ps_s)."""
    F, ms, Ps, m_pred, P_pred = _cast(dtype, F, ms, Ps, m_pred, P_pred)
    n = F.shape[1]
    eye = torch.eye(n, dtype=F.dtype, device=F.device)
    m_next, P_next = ms[-1], Ps[-1]
    outs = [(m_next, P_next)]
    for t in range(ms.shape[0] - 2, -1, -1):
        m_f, P_f, F_n, m_pn, P_pn = ms[t], Ps[t], F[t + 1], m_pred[t + 1], P_pred[t + 1]
        G = solve_small_plain(P_pn + 1e-8 * eye, F_n @ P_f).T
        m_next = m_f + G @ (m_next - m_pn)
        P_next = _sym(P_f + G @ (P_next - P_pn) @ G.T)
        outs.append((m_next, P_next))
    return tuple(torch.stack(x[::-1]) for x in zip(*outs))


def _smooth_combine(later, earlier):
    """Associative smoothing-element combination (JAX: ops/kalman.py:177).
    Under a suffix scan (``reverse``) the FIRST argument is the combined
    suffix of later steps and the second the earlier element:
    E = E_e E_l, g = E_e g_l + g_e, L = E_e L_l E_e^T + L_e."""
    E_l, g_l, L_l = later
    E_e, g_e, L_e = earlier
    E = E_e @ E_l
    g = _mv(E_e, g_l) + g_e
    L = _sym(E_e @ L_l @ E_e.transpose(-1, -2) + L_e)
    return E, g, L


def _smooth_elements(F, c, Q, ms, Ps):
    """Per-step associative smoothing elements (E, g, L) (JAX:
    ops/kalman.py:195); the last is the terminal (0, ms[-1], Ps[-1])."""
    n = ms.shape[1]
    m_f, P_f, F_n, c_n, Q_n = ms[:-1], Ps[:-1], F[1:], c[1:], Q[1:]
    P_pred = _sym(F_n @ P_f @ F_n.transpose(-1, -2) + Q_n)
    eye = torch.eye(n, dtype=F.dtype, device=F.device)
    E = solve_small_plain(P_pred + 1e-8 * eye, F_n @ P_f).transpose(-1, -2)
    g = m_f - _mv(E, _mv(F_n, m_f) + c_n)
    L = _sym(P_f - E @ F_n @ P_f)
    E = torch.cat([E, E.new_zeros((1, n, n))], dim=0)
    g = torch.cat([g, ms[-1:]], dim=0)
    L = torch.cat([L, Ps[-1:]], dim=0)
    return E, g, L


def smooth_parallel_plain(F, c, Q, ms, Ps, chunk=None, dtype=None):
    """The parallel-prefix RTS smoother over the filtered moments (JAX:
    ops/kalman.py:214): (ms_s, Ps_s), the same as
    :func:`smooth_sequential_plain`'s up to roundoff; ``chunk`` as in
    :func:`filter_parallel_plain`."""
    F, c, Q, ms, Ps = _cast(dtype, F, c, Q, ms, Ps)
    n = ms.shape[1]
    elems = _smooth_elements(F, c, Q, ms, Ps)
    if chunk:
        identity = (torch.eye(n, dtype=F.dtype, device=F.device), F.new_zeros(n),
                    F.new_zeros(n, n))
        E, g, L = chunked_prefix_scan(_smooth_combine, elems, identity, chunk, reverse=True)
    else:
        E, g, L = prefix_scan(_smooth_combine, elems, reverse=True)
    return g, L


# -------------------------------------------------------------- the kernels


def _check(name, tensors, shapes):
    """Each tensor float32 on one CUDA device with its expected shape.
    Returns the tensors made contiguous."""
    bad = [t.dtype for t in tensors if t.dtype != torch.float32]
    if bad:
        raise ValueError('%s: takes float32 tensors, got %s' % (name, bad[0]))
    _check_tensors(name, tensors, [torch.float32] * len(tensors))
    if any(tuple(t.shape) != shape for t, shape in zip(tensors, shapes)):
        raise ValueError('%s: expected shapes %s, got %s'
                         % (name, shapes, [tuple(t.shape) for t in tensors]))
    return [t.contiguous() for t in tensors]


def _sizes(name, F, d=1):
    """(T, n) of the call, within the kernels' limits with d observations."""
    if F.dim() != 3:
        raise ValueError('%s: F must be (T, n, n), got %s' % (name, tuple(F.shape)))
    T, n = F.shape[:2]
    if not (1 <= n <= MAX_N and 1 <= d <= MAX_D and T >= 1):
        raise ValueError('%s: takes n <= %d, 1 <= d <= %d and T >= 1, got n=%d, d=%d, T=%d'
                         % (name, MAX_N, MAX_D, n, d, T))
    return T, n


def _filter_shapes(T, n, d):
    return ((T, n, n), (T, n), (T, n, n), (d, n), (d, d), (T, d), (T,), (n,), (n, n))


def _filter_scratch(n, C):
    """The floats of K19's and K36 / K37's scratch: C composites (3 n^2 +
    2 n), then C entry moments (n^2 + n)."""
    return C * (4 * n * n + 3 * n)


def _smoother_scratch(n, C):
    """The floats of K20's and K38 / K39's scratch: C composites (2 n^2 +
    n), then C exit moments (n^2 + n)."""
    return C * (3 * n * n + 2 * n)


def _chunks(T, chunk):
    L = int(chunk) if chunk else scan_chunk(T)
    if L < 1:
        raise ValueError('chunk must be positive, got %d' % L)
    return L, -(-T // L)


def filter_parallel_cuda(F, c, Q, H, R, y, mask, m0, P0, chunk=None):
    """K19 on the card: (ms, Ps) of :func:`filter_parallel_plain`, in
    chunks of ``chunk`` steps (default ``scan_chunk(T)``): each chunk's
    elements composed by a block, the chunk totals carried by one block, each
    chunk's filter run from its entry moments."""
    name = 'kalman_filter_scan'
    d = y.shape[-1]
    T, n = _sizes(name, F, d)
    ts = _check(name, (F, c, Q, H, R, y, mask, m0, P0), _filter_shapes(T, n, d))
    L, C = _chunks(T, chunk)
    dev = y.device
    scratch = torch.empty(_filter_scratch(n, C), device=dev, dtype=torch.float32)
    ms = torch.empty((T, n), device=dev, dtype=torch.float32)
    Ps = torch.empty((T, n, n), device=dev, dtype=torch.float32)
    launch(name, *(t.data_ptr() for t in ts), T, n, d, L, scratch.data_ptr(), ms.data_ptr(),
           Ps.data_ptr(), symbol='bn_kalman_filter_scan')
    return ms, Ps


def smooth_parallel_cuda(F, c, Q, ms, Ps, chunk=None):
    """K20 on the card: (ms_s, Ps_s) of :func:`smooth_parallel_plain`, in
    chunks as K19."""
    name = 'kalman_smoother_scan'
    T, n = _sizes(name, F)
    ts = _check(name, (F, c, Q, ms, Ps), ((T, n, n), (T, n), (T, n, n), (T, n), (T, n, n)))
    L, C = _chunks(T, chunk)
    scratch = torch.empty(_smoother_scratch(n, C), device=F.device, dtype=torch.float32)
    ms_s = torch.empty_like(ts[3])
    Ps_s = torch.empty_like(ts[4])
    launch('kalman_filter_scan', *(t.data_ptr() for t in ts), T, n, L, scratch.data_ptr(),
           ms_s.data_ptr(), Ps_s.data_ptr(), symbol='bn_kalman_smoother_scan')
    return ms_s, Ps_s


def filter_sequential_cuda(F, c, Q, H, R, y, mask, m0, P0):
    """K21 on the card: (ms, Ps, m_pred, P_pred) of
    :func:`filter_sequential_plain`, the whole chain in one block."""
    name = 'kalman_filter'
    d = y.shape[-1]
    T, n = _sizes(name, F, d)
    ts = _check(name, (F, c, Q, H, R, y, mask, m0, P0), _filter_shapes(T, n, d))
    dev = y.device
    out = [torch.empty(shape, device=dev, dtype=torch.float32)
           for shape in ((T, n), (T, n, n), (T, n), (T, n, n))]
    launch('kalman_filter_scan', *(t.data_ptr() for t in ts), T, n, d,
           *(t.data_ptr() for t in out), symbol='bn_kalman_filter')
    return tuple(out)


def smooth_sequential_cuda(F, c, Q, ms, Ps, m_pred, P_pred):
    """K22 on the card: (ms_s, Ps_s) of :func:`smooth_sequential_plain`, the
    whole backward chain in one block (``c`` and ``Q`` are not read, as in
    the plain version)."""
    name = 'kalman_smoother'
    T, n = _sizes(name, F)
    ts = _check(name, (F, c, Q, ms, Ps, m_pred, P_pred),
                ((T, n, n), (T, n), (T, n, n), (T, n), (T, n, n), (T, n), (T, n, n)))
    F, _, _, ms, Ps, m_pred, P_pred = ts
    ms_s = torch.empty_like(ms)
    Ps_s = torch.empty_like(Ps)
    launch('kalman_filter_scan', F.data_ptr(), ms.data_ptr(), Ps.data_ptr(), m_pred.data_ptr(),
           P_pred.data_ptr(), T, n, ms_s.data_ptr(), Ps_s.data_ptr(),
           symbol='bn_kalman_smoother')
    return ms_s, Ps_s


# ------------------------------------------------- the time-sharded kernels

_SHARD = 'kalman_shard_filter_totals'   # the source of K36-K39


def _filter_elem(n):
    return 3 * n * n + 2 * n   # [A | b | C | eta | J]


def _smoother_elem(n):
    return 2 * n * n + n       # [E | g | L]


def _check_shard_state(name, totals, s, width, scratch, size):
    """The gathered totals (n_sh, width) and 0 <= s < n_sh, and a totals
    stage's scratch of ``size`` floats; returns n_sh."""
    if totals.dim() != 2 or totals.shape[1] != width or not 0 <= s < totals.shape[0]:
        raise ValueError('%s: takes totals (n_sh, %d) and 0 <= s < n_sh, got %s and s=%d'
                         % (name, width, tuple(totals.shape), s))
    if tuple(scratch.shape) != (size,):
        raise ValueError('%s: the totals stage\'s scratch has %d floats here, got %s'
                         % (name, size, tuple(scratch.shape)))
    return totals.shape[0]


def _filter_shard(name, F, c, Q, H, R, y, mask, m0, P0, extra=(), extra_shapes=()):
    """(T, n, d, L, C, the inputs checked and made contiguous) of a filter
    shard's launch."""
    d = y.shape[-1]
    T, n = _sizes(name, F, d)
    ts = _check(name, (F, c, Q, H, R, y, mask, m0, P0) + tuple(extra),
                _filter_shapes(T, n, d) + tuple(extra_shapes))
    return (T, n, d) + _chunks(T, None) + (ts,)


def shard_filter_totals_cuda(F, c, Q, H, R, y, mask, m0, P0, first):
    """K36 on the card, for a time shard of T frames (the inputs as
    :func:`filter_parallel_cuda`'s): its total, the fold of its chunks'
    filtering elements (3 n^2 + 2 n,) laid out [A | b | C | eta | J], and
    the scratch holding the chunk composites that K37 reads. ``first``:
    the shard holds the trial's first frame, whose element absorbs the
    prior (m0, P0; a later shard does not read them)."""
    name = 'kalman_shard_filter_totals'
    T, n, d, L, C, ts = _filter_shard(name, F, c, Q, H, R, y, mask, m0, P0)
    kw = dict(device=y.device, dtype=torch.float32)
    scratch, total = torch.empty(_filter_scratch(n, C), **kw), torch.empty(_filter_elem(n), **kw)
    launch(_SHARD, *(t.data_ptr() for t in ts), T, n, d, L, int(bool(first)),
           scratch.data_ptr(), total.data_ptr(), symbol='bn_kalman_shard_filter_totals')
    return total, scratch


def shard_filter_finish_cuda(totals, s, F, c, Q, H, R, y, mask, m0, P0, scratch):
    """K37 on shard ``s``: from the gathered K36 totals (n_sh, 3 n^2 + 2 n)
    and this shard's K36 scratch, its filtered (ms (T, n), Ps (T, n, n))."""
    name = 'kalman_shard_filter_finish'
    T, n, d, L, C, ts = _filter_shard(name, F, c, Q, H, R, y, mask, m0, P0, (totals, scratch),
                                      (tuple(totals.shape), tuple(scratch.shape)))
    n_sh = _check_shard_state(name, totals, s, _filter_elem(n), scratch,
                              _filter_scratch(n, C))
    kw = dict(device=y.device, dtype=torch.float32)
    ms, Ps = torch.empty((T, n), **kw), torch.empty((T, n, n), **kw)
    launch(_SHARD, ts[9].data_ptr(), n_sh, s, *(t.data_ptr() for t in ts[:9]), T, n, d, L,
           ts[10].data_ptr(), ms.data_ptr(), Ps.data_ptr(),
           symbol='bn_kalman_shard_filter_finish')
    return ms, Ps


def _smoother_shard(name, F, c, Q, ms, Ps, extra=(), extra_shapes=()):
    """(T, n, terminal, L, C, the inputs checked and made contiguous) of a
    smoother shard's launch: F, c, Q hold T + 1 frames on a shard before the
    trial's last, T on the last (``terminal``)."""
    Tf, n = _sizes(name, F)
    T = ms.shape[0]
    if Tf not in (T, T + 1):
        raise ValueError('%s: F, c, Q take T + 1 frames (T on the trial\'s last shard) beside '
                         'T = %d filtered frames, got %d' % (name, T, Tf))
    ts = _check(name, (F, c, Q, ms, Ps) + tuple(extra),
                ((Tf, n, n), (Tf, n), (Tf, n, n), (T, n), (T, n, n)) + tuple(extra_shapes))
    return (T, n, Tf == T) + _chunks(T, None) + (ts,)


def shard_smoother_totals_cuda(F, c, Q, ms, Ps):
    """K38 on the card, for a time shard of T frames: from its filtered
    (ms (T, n), Ps (T, n, n)) and F, c, Q at T + 1 frames (the next shard's
    first frame at T; T frames on the trial's last shard, which holds the
    terminal element), its total, the fold of its chunks' smoothing
    elements (2 n^2 + n,) laid out [E | g | L], and the scratch holding the
    chunk composites that K39 reads."""
    name = 'kalman_shard_smoother_totals'
    T, n, terminal, L, C, ts = _smoother_shard(name, F, c, Q, ms, Ps)
    kw = dict(device=ms.device, dtype=torch.float32)
    scratch = torch.empty(_smoother_scratch(n, C), **kw)
    total = torch.empty(_smoother_elem(n), **kw)
    launch(_SHARD, *(t.data_ptr() for t in ts), T, n, L, int(terminal), scratch.data_ptr(),
           total.data_ptr(), symbol='bn_kalman_shard_smoother_totals')
    return total, scratch


def shard_smoother_finish_cuda(totals, s, F, c, Q, ms, Ps, scratch):
    """K39 on shard ``s``: from the gathered K38 totals (n_sh, 2 n^2 + n)
    and this shard's K38 scratch, its smoothed (ms_s (T, n), Ps_s (T, n,
    n)); the last shard, and only it, is the terminal one."""
    name = 'kalman_shard_smoother_finish'
    T, n, terminal, L, C, ts = _smoother_shard(name, F, c, Q, ms, Ps, (totals, scratch),
                                               (tuple(totals.shape), tuple(scratch.shape)))
    n_sh = _check_shard_state(name, totals, s, _smoother_elem(n), scratch,
                              _smoother_scratch(n, C))
    if terminal != (s == n_sh - 1):
        raise ValueError('%s: shard %d of %d takes F, c, Q of %d frames beside T = %d'
                         % (name, s, n_sh, T + (s < n_sh - 1), T))
    ms_s, Ps_s = torch.empty_like(ts[3]), torch.empty_like(ts[4])
    launch(_SHARD, ts[5].data_ptr(), n_sh, s, *(t.data_ptr() for t in ts[:5]), T, n, L,
           ts[6].data_ptr(), ms_s.data_ptr(), Ps_s.data_ptr(),
           symbol='bn_kalman_shard_smoother_finish')
    return ms_s, Ps_s


# -------------------------------------------------------- the public functions


def filter_sequential(F, c, Q, H, R, y, mask, m0, P0):
    """(ms, Ps, m_pred, P_pred) (JAX: ops/kalman.py:38): K21 on the card, the
    plain version on the CPU."""
    if _dispatch('filter_sequential', y):
        return filter_sequential_plain(F, c, Q, H, R, y, mask, m0, P0)
    return filter_sequential_cuda(F, c, Q, H, R, y, mask, m0, P0)


def filter_parallel(F, c, Q, H, R, y, mask, m0, P0, chunk=None):
    """(ms, Ps) (JAX: ops/kalman.py:132): K19 on the card (in chunks of its
    own), the plain version with ``chunk`` on the CPU."""
    if _dispatch('filter_parallel', y):
        return filter_parallel_plain(F, c, Q, H, R, y, mask, m0, P0, chunk=chunk)
    return filter_parallel_cuda(F, c, Q, H, R, y, mask, m0, P0)


def smooth_sequential(F, c, Q, ms, Ps, m_pred, P_pred):
    """(ms_s, Ps_s) (JAX: ops/kalman.py:152): K22 on the card, the plain
    version on the CPU."""
    if _dispatch('smooth_sequential', ms):
        return smooth_sequential_plain(F, c, Q, ms, Ps, m_pred, P_pred)
    return smooth_sequential_cuda(F, c, Q, ms, Ps, m_pred, P_pred)


def smooth_parallel(F, c, Q, ms, Ps, chunk=None):
    """(ms_s, Ps_s) (JAX: ops/kalman.py:214): K20 on the card (in chunks of
    its own), the plain version with ``chunk`` on the CPU."""
    if _dispatch('smooth_parallel', ms):
        return smooth_parallel_plain(F, c, Q, ms, Ps, chunk=chunk)
    return smooth_parallel_cuda(F, c, Q, ms, Ps)
