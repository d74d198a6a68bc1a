"""Batched linear algebra of small matrices (the port of
``behavenet_tpu/ops/smallmat.py``).

:func:`solve_small` runs K11 (``kernels/solve_small.cu``) on a ``cuda``
tensor and the plain PyTorch version beside it on a ``cpu`` tensor, picked
from the input's device and from nothing else. The ARHMM's M-step solves its
K equilibrated, ridged (P, P) normal equations with it.

:func:`cholesky_small` and :func:`solve_tril_small` are the plain versions of
the unrolled Cholesky and forward substitution, in the JAX package's
operation order; on the card they run inside K12 (``kernels/gaussian_nll.cu``,
``ops.losses.gaussian_neg_log_prob``), their one caller.
"""

import torch

from behavenet_tpu_torch.kernels.build import launch

__all__ = ['solve_small', 'solve_small_plain', 'solve_small_cuda', 'cholesky_small',
           'solve_tril_small']

_MAX_N = 16      # widest system K11 takes (one register per row)
_MAX_COLS = 64   # n + k: two columns of [A | Y] per lane of a warp


def _prepare(A, Y):
    """(vec, Y broadcast to A's batch as a matrix right-hand side)."""
    vec = Y.dim() == A.dim() - 1
    if not vec and Y.dim() < A.dim() - 1:
        raise ValueError(
            'solve_small: Y with shape %s is neither a matrix RHS nor a '
            'batch-matched vector RHS for A with shape %s; broadcast the '
            'vector across A\'s batch dims first' % (tuple(Y.shape), tuple(A.shape)))
    if vec:
        Y = Y[..., None]
    return vec, Y.expand(A.shape[:-2] + Y.shape[-2:])


def solve_small_plain(A, Y, pivot=False):
    """Batched solve A @ X = Y for small (n, n) systems: unrolled
    Gauss-Jordan elimination, line for line as the JAX package's (same
    operation order). Without pivoting (the default) it is safe for SPD
    systems; ``pivot=True`` adds partial row pivoting.

    A: (..., n, n); Y: (..., n, k) or a batch-matched vector (..., n).
    Returns X shaped like the broadcast Y.
    """
    vec, Y = _prepare(A, Y)
    n = A.shape[-1]
    M = torch.cat([A, Y.to(A.dtype)], dim=-1)   # (..., n, n+k)
    ar = torch.arange(n, device=A.device)
    for i in range(n):
        if pivot:
            col = torch.where(ar >= i, M[..., :, i].abs(),
                              torch.full_like(M[..., :, i], float('-inf')))
            p = torch.argmax(col, dim=-1)[..., None]
            idx = torch.where(ar == i, p, torch.where(ar == p, torch.full_like(p, i), ar))
            M = torch.take_along_dim(M, idx[..., None].expand(M.shape), dim=-2)
        piv = M[..., i:i + 1, :] / M[..., i:i + 1, i:i + 1]
        M = M - M[..., :, i:i + 1] * piv
        M[..., i, :] = piv[..., 0, :]
    X = M[..., :, n:]
    return X[..., 0] if vec else X


def solve_small_cuda(A, Y):
    """K11 on the card: the solution of every (n, n) system of the batch,
    n <= 16 and n + k <= 64, float32, without pivoting."""
    for t in (A, Y):
        if t.device.type != 'cuda' or t.device != A.device:
            raise ValueError('solve_small_cuda: A and Y must lie on one CUDA device, '
                             'got %s and %s' % (A.device, Y.device))
        if t.dtype != torch.float32:
            raise ValueError('solve_small_cuda: takes float32, got %s' % t.dtype)
    vec, Y = _prepare(A, Y)
    n, k = A.shape[-1], Y.shape[-1]
    if A.shape[-2] != n or Y.shape[-2] != n:
        raise ValueError('solve_small_cuda: A must be (..., n, n) and Y (..., n, k), '
                         'got %s and %s' % (tuple(A.shape), tuple(Y.shape)))
    if not 1 <= n <= _MAX_N or n + k > _MAX_COLS:
        raise ValueError('solve_small_cuda: takes n <= %d and n + k <= %d, got n=%d, k=%d'
                         % (_MAX_N, _MAX_COLS, n, k))
    batch = A.shape[:-2]
    a = A.reshape(-1, n, n).contiguous()
    y = Y.reshape(-1, n, k).contiguous()
    x = torch.empty_like(y)
    if a.shape[0]:
        launch('solve_small', a.data_ptr(), y.data_ptr(), x.data_ptr(),
               a.shape[0], n, k)
    x = x.reshape(batch + (n, k))
    return x[..., 0] if vec else x


def solve_small(A, Y, pivot=False):
    """Batched solve A @ X = Y for small (n, n) systems (JAX:
    ops/smallmat.py:17): K11 on a ``cuda`` tensor, the plain version on a
    ``cpu`` one. ``pivot=True`` exists in the plain version only; on the
    card it raises."""
    if A.device.type == 'cpu':
        return solve_small_plain(A, Y, pivot=pivot)
    if A.device.type != 'cuda':
        raise ValueError('solve_small: no implementation for device %s' % A.device)
    if pivot:
        raise NotImplementedError('solve_small(pivot=True) has no kernel yet; the '
                                  'ARHMM M-step never pivots')
    return solve_small_cuda(A, Y)


def cholesky_small(A):
    """Batched lower Cholesky factor of small SPD (..., n, n) matrices (JAX:
    ops/smallmat.py:59): column by column, reading only the lower triangle
    ``A[j, j]``, ``A[j+1:, j]``, in the JAX package's operation order."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        s = A[..., j, j]
        if j:
            s = s - torch.sum(torch.stack([c[..., j] for c in cols], dim=-1) ** 2, dim=-1)
        ljj = torch.sqrt(s)
        col = torch.zeros_like(A[..., :, j])
        col[..., j] = ljj
        if j + 1 < n:
            r = A[..., j + 1:, j]
            if j:
                prev = torch.stack(cols, dim=-1)                     # (..., n, j)
                r = r - torch.einsum('...ik,...k->...i', prev[..., j + 1:, :],
                                     prev[..., j, :])
            col[..., j + 1:] = r / ljj[..., None]
        cols.append(col)
    return torch.stack(cols, dim=-1)


def solve_tril_small(L, b):
    """Batched forward substitution ``L x = b`` for lower (..., n, n) ``L``
    and (..., n) ``b`` (JAX: ops/smallmat.py:81), in its operation order."""
    xs = []
    for i in range(L.shape[-1]):
        acc = b[..., i]
        for j in range(i):
            acc = acc - L[..., i, j] * xs[j]
        xs.append(acc / L[..., i, i])
    return torch.stack(xs, dim=-1)
