"""Prefix and suffix scans over a leading axis, plain PyTorch (the port of
``behavenet_tpu/ops/scans.py``).

:func:`prefix_scan` is an inclusive scan by recursive doubling (log2(T)
vectorized ``combine`` calls over shifted copies); :func:`chunked_prefix_scan`
runs it inside fixed-size chunks and carries the running total across the
chunks in a loop, as the JAX package's two-level scan does. The HMM's
parallel-prefix forms (``ops.hmm``) use them on their plain path; the
kernels that replace them on the card (K13-K15) scan in chunks of their own.

``combine(a, b)`` follows ``lax.associative_scan``'s convention: ``a`` is
the accumulated block on the scan's origin side (the earlier elements of a
prefix scan, the later ones of a suffix scan with ``reverse``). It must
accept a leading batch axis and broadcast.
"""

import torch

__all__ = ['prefix_scan', 'chunked_prefix_scan']


def prefix_scan(combine, elems, reverse=False, axis=0):
    """Inclusive scan of ``elems`` along ``axis``: out[t] = e_0 * ... * e_t
    (with ``reverse``, out[t] = e_t * ... * e_{T-1}, accumulated from the
    end), as ``lax.associative_scan(combine, elems, reverse=reverse)``."""
    x = elems.movedim(axis, 0)
    if reverse:
        x = x.flip(0)
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], combine(x[:-d], x[d:])], dim=0)
        d *= 2
    if reverse:
        x = x.flip(0)
    return x.movedim(0, axis)


def chunked_prefix_scan(combine, elems, identity, chunk, reverse=False):
    """Two-level prefix (suffix with ``reverse``) scan over the leading axis
    of ``elems`` (JAX: ops/scans.py:10): :func:`prefix_scan` within chunks of
    ``chunk`` elements, the running total carried across chunks. ``identity``
    is a two-sided identity of ``combine`` that broadcasts to one element
    (``elems.shape[1:]``); it pads the last chunk and starts the carry."""
    T = elems.shape[0]
    chunk = int(chunk)
    if T <= chunk:
        return prefix_scan(combine, elems, reverse)
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    ident = identity.to(elems.dtype).expand(elems.shape[1:])
    if pad:
        elems = torch.cat([elems, ident.expand((pad,) + elems.shape[1:])], dim=0)
    within = prefix_scan(combine, elems.reshape((n_chunks, chunk) + elems.shape[1:]),
                         reverse, axis=1)
    order = range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)
    carry, out = ident, [None] * n_chunks
    for c in order:
        full = combine(carry[None], within[c])
        carry = full[0] if reverse else full[-1]
        out[c] = full
    return torch.cat(out, dim=0)[:T]
