"""Prefix and suffix scans over a leading axis, plain PyTorch (the port of
``behavenet_tpu/ops/scans.py``).

:func:`prefix_scan` is an inclusive scan by recursive doubling (log2(T)
vectorized ``combine`` calls over shifted copies); :func:`chunked_prefix_scan`
runs it inside fixed-size chunks and carries the running total across the
chunks in a loop, as the JAX package's two-level scan does. The HMM's
parallel-prefix forms (``ops.hmm``) and the associative Kalman filter and
smoother (``ops.kalman``) use them on their plain path; the kernels that
replace them on the card (K13-K15, K19-K20) scan in chunks of their own.

An element is one tensor or a tuple of tensors that share the leading axis
(the Kalman filter's five-tuple, the smoother's three-tuple), as a pytree
of JAX's. ``combine(a, b)`` takes and returns elements of that structure and
follows ``lax.associative_scan``'s convention: ``a`` is the accumulated
block on the scan's origin side (the earlier elements of a prefix scan, the
later ones of a suffix scan with ``reverse``). It must accept a leading
batch axis and broadcast.
"""

import torch

__all__ = ['prefix_scan', 'chunked_prefix_scan']


def _map(fn, *elems):
    """``fn`` over the tensors of one or more elements of the same structure."""
    if isinstance(elems[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*elems))
    return fn(*elems)


def _length(elems):
    return (elems[0] if isinstance(elems, tuple) else elems).shape[0]


def prefix_scan(combine, elems, reverse=False, axis=0):
    """Inclusive scan of ``elems`` along ``axis``: out[t] = e_0 * ... * e_t
    (with ``reverse``, out[t] = e_t * ... * e_{T-1}, accumulated from the
    end), as ``lax.associative_scan(combine, elems, reverse=reverse)``."""
    x = _map(lambda e: e.movedim(axis, 0), elems)
    if reverse:
        x = _map(lambda e: e.flip(0), x)
    T, d = _length(x), 1
    while d < T:
        new = combine(_map(lambda e: e[:-d], x), _map(lambda e: e[d:], x))
        x = _map(lambda e, n: torch.cat([e[:d], n], dim=0), x, new)
        d *= 2
    if reverse:
        x = _map(lambda e: e.flip(0), x)
    return _map(lambda e: e.movedim(0, axis), x)


def chunked_prefix_scan(combine, elems, identity, chunk, reverse=False):
    """Two-level prefix (suffix with ``reverse``) scan over the leading axis
    of ``elems`` (JAX: ops/scans.py:10): :func:`prefix_scan` within chunks of
    ``chunk`` elements, the running total carried across chunks. ``identity``
    has the elements' structure and is a two-sided identity of ``combine``
    that broadcasts to one element (each tensor's ``shape[1:]``); it pads
    the last chunk and starts the carry."""
    T = _length(elems)
    chunk = int(chunk)
    if T <= chunk:
        return prefix_scan(combine, elems, reverse)
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    ident = _map(lambda i, e: i.to(e.dtype).expand(e.shape[1:]), identity, elems)
    if pad:
        elems = _map(lambda e, i: torch.cat([e, i.expand((pad,) + e.shape[1:])], dim=0),
                     elems, ident)
    within = prefix_scan(combine, _map(lambda e: e.reshape((n_chunks, chunk) + e.shape[1:]),
                                       elems), reverse, axis=1)
    order = range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)
    carry, out = ident, [None] * n_chunks
    for c in order:
        full = combine(_map(lambda e: e[None], carry), _map(lambda e: e[c], within))
        carry = _map(lambda e: e[0] if reverse else e[-1], full)
        out[c] = full
    return _map(lambda *parts: torch.cat(parts, dim=0)[:T], *out)
