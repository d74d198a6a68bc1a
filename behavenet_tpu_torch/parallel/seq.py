"""Time-sharded HMM message passing and Kalman filtering and smoothing
over a :class:`~.mesh.Mesh` (the port of ``behavenet_tpu/parallel/seq.py``,
kernel rows 19a and 19b).

The JAX package shards one long trial's time axis across chips with the
standard three-phase scan: each device scans its contiguous time shard,
the per-device totals are gathered and scanned (n elements), and each
device folds that offset into its own prefixes (seq.py:1-25). Here:

- :func:`sp_scan` is that scan in plain PyTorch, generic over a combine
  and tuples of tensors, each shard on its mesh device, the totals copied
  to the first device for the n-length scan and the offsets copied back.
  It is the plain building block; no call on the card reaches it.
- :func:`sp_forward_backward`, :func:`sp_viterbi` and
  :func:`sp_sample_posterior` take one trial (T, K) or a batch (N, T, K).
  On a mesh of CUDA devices they cut the chain into shards
  (:func:`shard_chain`) and run K32-K35 on each shard's device
  (``ops.hmm``'s ``shard_*_cuda``, ``kernels/hmm_shard.cu``): two or three
  launches a shard, with the shards' (K, K) totals (and, backtracing,
  (K,) index-map totals) copied between them. On a mesh of ``cpu``
  devices they run the plain versions, the port's parallel-prefix passes
  (``ops.hmm``) with :func:`sp_scan` as their scan: JAX's formulas. A mesh
  that mixes device types raises.
- :func:`forward_backward_shards`, :func:`viterbi_shards` and
  :func:`sample_posterior_shards` take a chain already cut into
  :class:`Shard`\\ s (the ARHMM computes each shard's log-likelihoods on
  its own device) and return per-shard outputs. On the card they run the
  ``stage_*`` functions in turn, each one launcher on every shard.
- ``sp_*_plain`` are the plain versions on the whole mesh, the reference
  the kernels are held to.

The Kalman passes (row 19b) follow the same plan over a linear-Gaussian
model's frames:

- :func:`sp_kalman_filter` and :func:`sp_kalman_smooth` take whole-trial
  tensors (``ops.kalman``'s shapes) and return (ms, Ps) or (ms_s, Ps_s) on
  the mesh's first device. They cut the trial with :func:`shard_lds` into
  :class:`KalmanShard`\\ s, each holding one frame of F, c, Q past its own
  (a frame's smoothing element reads the dynamics into the next frame).
  On CUDA devices each shard runs K36 and K37 (filter) or K38 and K39
  (smoother) of ``kernels/kalman_shard.cu`` (``ops.kalman``'s
  ``shard_*_cuda``), with the shards' element totals copied between
  them; on ``cpu`` devices the plain versions ``sp_kalman_filter_plain``
  and ``sp_kalman_smooth_plain``: ``ops.kalman``'s elements and combines
  scanned by :func:`sp_scan`, JAX's formulas.
- :func:`kalman_filter_shards` and :func:`kalman_smooth_shards` take and
  return per-shard tensors, so that the Bayesian decoder keeps the
  filtered moments on their shards for the smoother.
"""

import collections
import functools

import torch

from behavenet_tpu_torch.ops import hmm as hmm_ops
from behavenet_tpu_torch.ops import kalman as kalman_ops
from behavenet_tpu_torch.ops.scans import chunked_prefix_scan, prefix_scan
from behavenet_tpu_torch.parallel.mesh import Mesh, per_device

__all__ = ['sp_scan', 'Shard', 'shard_bounds', 'shard_chain', 'on_card',
           'stage_totals', 'stage_finish', 'stage_alphas', 'stage_viterbi', 'stage_maps',
           'stage_sample_maps', 'stage_backtrace',
           'forward_backward_shards', 'viterbi_shards', 'sample_posterior_shards',
           'sp_forward_backward', 'sp_viterbi', 'sp_sample_posterior',
           'sp_forward_backward_plain', 'sp_viterbi_plain', 'sp_sample_posterior_plain',
           'KalmanShard', 'shard_lds', 'stage_kalman_filter_totals',
           'stage_kalman_filter_finish', 'stage_kalman_smoother_totals',
           'stage_kalman_smoother_finish', 'kalman_filter_shards', 'kalman_smooth_shards',
           'joined_frames', 'sp_kalman_filter', 'sp_kalman_smooth', 'sp_kalman_filter_plain',
           'sp_kalman_smooth_plain']


def _map(fn, *elems):
    if isinstance(elems[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*elems))
    return fn(*elems)


def _axis_size(mesh, axis_name):
    if axis_name not in mesh.shape:
        raise ValueError('the mesh has axes %s, not %r' % (mesh.axis_names, axis_name))
    return mesh.shape[axis_name]


def sp_scan(combine, elems, identity, mesh, axis_name='sp', reverse=False, chunk=None):
    """``prefix_scan(combine, elems, reverse)`` with the leading (time) axis
    cut into ``mesh.size`` contiguous shards (JAX: seq.py:58).

    ``elems`` is a tensor or a tuple of tensors (T, ...); ``identity`` has
    its structure, is a two-sided identity of ``combine`` and broadcasts to
    one element. T is padded to a multiple of the mesh with it (seq.py:47
    ``_pad_to``). Each shard, on its mesh device, runs
    ``ops.scans.chunked_prefix_scan`` (chunks of ``chunk``, by default the
    HMM passes' 8192); the shards' totals are copied to the first device
    and scanned there, and each shard combines the total of everything on
    its origin side (left, or right with ``reverse``) into its prefixes.
    Returns the inclusive scan (T, ...) on the first device, equal to the
    unsharded one up to float reassociation."""
    n = _axis_size(mesh, axis_name)
    T = (elems[0] if isinstance(elems, tuple) else elems).shape[0]
    if T == 0:
        return elems
    m = -(-T // n)
    chunk = hmm_ops._CHUNK if chunk is None else chunk
    dev0 = mesh.devices[0]

    def pad(e, i):
        i = i.to(e.device, e.dtype)
        return torch.cat([e, i.expand((n * m - T,) + e.shape[1:])], dim=0)
    elems = _map(pad, elems, identity)
    within, totals = [], []
    for s, dev in enumerate(mesh.devices):
        local = _map(lambda e: e[s * m:(s + 1) * m].to(dev), elems)
        ident = _map(lambda i: i.to(dev), identity)
        w = chunked_prefix_scan(combine, local, ident, chunk, reverse=reverse)
        within.append(w)
        totals.append(_map(lambda x: (x[0] if reverse else x[-1]).to(dev0), w))
    scanned = prefix_scan(combine, _map(lambda *t: torch.stack(t), *totals), reverse=reverse)
    out = []
    for s, dev in enumerate(mesh.devices):
        src = s + 1 if reverse else s - 1
        w = within[s]
        if 0 <= src < n:
            off = _map(lambda x: x[src].to(dev), scanned)
            w = combine(_map(lambda o: o[None], off), w)
        out.append(_map(lambda x: x.to(dev0), w))
    return _map(lambda *parts: torch.cat(parts, dim=0)[:T], *out)


# ------------------------------------------------------ the cut chain

# One shard of a chain cut along time (frames [t0, t1) of every trial) on
# its device: log_lik (N, Ts, K), mask (N, Ts), log_P (K, K) or its own
# steps (N, Ts-1, K, K); entry_P, the step into t0 ((K, K) or (N, K, K)),
# and m_prev, the mask of frame t0 - 1 (N,), None on the first shard.
Shard = collections.namedtuple('Shard', ['device', 'log_lik', 'mask', 'log_P', 'entry_P',
                                         'm_prev'])


def shard_bounds(T, n):
    """The frames [t0, t1) of each of ``n`` shards of a T-frame axis:
    ceil(T / n) frames each, the last shards shorter or empty."""
    m = -(-T // n)
    return [(min(s * m, T), min((s + 1) * m, T)) for s in range(n)]


def shard_chain(log_P, log_lik, mask, mesh, axis_name='sp'):
    """The chain (log_P (K, K) or (N, T-1, K, K), log_lik (N, T, K), mask
    (N, T)) cut by :func:`shard_bounds` into :class:`Shard`\\ s on the mesh's
    devices; empty shards are left out."""
    n = _axis_size(mesh, axis_name)
    tv = log_P.dim() == 4
    shards = []
    for (t0, t1), dev in zip(shard_bounds(log_lik.shape[1], n), mesh.devices):
        if t1 == t0:
            continue
        if tv:
            lp = log_P[:, t0:t1 - 1].to(dev)
            entry = log_P[:, t0 - 1].to(dev) if t0 else None
        else:
            lp = log_P.to(dev)
            entry = lp if t0 else None
        shards.append(Shard(dev, log_lik[:, t0:t1].to(dev), mask[:, t0:t1].to(dev), lp, entry,
                            mask[:, t0 - 1].to(dev) if t0 else None))
    return shards


def on_card(devices):
    """True for CUDA devices (the kernels), False for ``cpu`` ones (the plain
    versions); raises on a mix or another type."""
    types = {torch.device(d).type for d in devices}
    if types == {'cuda'}:
        return True
    if types == {'cpu'}:
        return False
    raise ValueError('a mesh runs on cuda devices or on cpu ones, not %s' % sorted(types))


def _gather_chain(shards):
    """The shards' chain put back together on the first shard's device:
    (log_P, log_lik, mask)."""
    dev = shards[0].device
    ll = torch.cat([sh.log_lik.to(dev) for sh in shards], dim=1)
    mask = torch.cat([sh.mask.to(dev) for sh in shards], dim=1)
    if shards[0].log_P.dim() == 2:
        return shards[0].log_P, ll, mask
    steps = [shards[0].log_P.to(dev)]
    for sh in shards[1:]:
        steps += [sh.entry_P[:, None].to(dev), sh.log_P.to(dev)]
    return torch.cat(steps, dim=1), ll, mask


def _split(full, shards):
    """(N, T, ...) on the first device -> each shard's frames on its device."""
    out, t0 = [], 0
    for sh in shards:
        t1 = t0 + sh.log_lik.shape[1]
        out.append(full[:, t0:t1].to(sh.device))
        t0 = t1
    return out


def _shard_mesh(shards):
    """The mesh of the shards' devices (empty shards are left out)."""
    return Mesh([sh.device for sh in shards])


def _plain_scan(shards):
    mesh = _shard_mesh(shards)
    return functools.partial(sp_scan, mesh=mesh, axis_name=mesh.axis_names[0])


def _gather(tensors, device):
    """Each shard's total copied to ``device``, stacked in shard order."""
    return torch.stack([t.to(device) for t in tensors])


# The stages of the passes on the card: each runs one launcher (K32-K35) on
# every shard, under the shard's device, from the outputs of the stages
# before it (per-shard lists), gathering the totals it reads to the shard.

def stage_totals(log_pi0, shards, maxplus=False):
    """K32: (the shard's log_pi0 copy, its totals, its chunk products) each."""
    def totals(sh):
        pi0 = log_pi0.to(sh.device)
        return (pi0,) + hmm_ops.shard_totals_cuda(pi0, sh.log_P, sh.entry_P, sh.log_lik,
                                                  sh.mask, maxplus=maxplus)
    return per_device(totals, shards)


def _finish_args(sh, s, tot):
    """K33's leading arguments on shard ``s``: the gathered totals, s, its
    log_pi0 copy and its chain."""
    return (_gather([t[1] for t in tot], sh.device), s, tot[s][0], sh.log_P, sh.entry_P,
            sh.log_lik, sh.mask)


def stage_finish(tot, shards):
    """K33's posteriors from :func:`stage_totals`' ``tot``: (gamma, log_Z on
    the last shard else None, the shard's xi_sum) each."""
    return per_device(lambda sh, s: hmm_ops.shard_forward_backward_cuda(
        *_finish_args(sh, s, tot), sh.m_prev, tot[s][2]), shards, range(len(shards)))


def stage_alphas(tot, shards):
    """K33's filtered alphas: (log_alpha, the alpha of frame t0 - 1 or None)
    each."""
    return per_device(lambda sh, s: hmm_ops.shard_forward_alpha_cuda(
        *_finish_args(sh, s, tot), tot[s][2]), shards, range(len(shards)))


def stage_viterbi(tot, shards):
    """K33's Viterbi mode from the (max, +) totals: (psi, the entry step's
    psi or None, z_{T-1} on the last shard else None) each."""
    return per_device(lambda sh, s: hmm_ops.shard_viterbi_cuda(
        *_finish_args(sh, s, tot), tot[s][2]), shards, range(len(shards)))


def stage_maps(shards, vit):
    """K34 from :func:`stage_viterbi`'s backpointers: (G, chunk maps) each."""
    return per_device(lambda sh, v: hmm_ops.shard_maps_cuda(v[0], v[1], sh.log_lik.shape[1]),
                      shards, vit)


def stage_sample_maps(shards, alphas, u_last, u_maps):
    """K34 drawing each shard's predecessor maps from :func:`stage_alphas`'
    ``alphas`` and its slice of the uniforms u_last (N, K), u_maps (N, T-1,
    K, K): (G, chunk maps, psi, z_{T-1} on the last shard else None) each."""
    t0s = [0]
    for sh in shards[:-1]:
        t0s.append(t0s[-1] + sh.log_lik.shape[1])
    last = len(shards) - 1

    def draw(sh, s, al):
        t0, T_s = t0s[s], sh.log_lik.shape[1]
        return hmm_ops.shard_sample_maps_cuda(
            al[0], sh.log_P, sh.mask, u_maps[:, t0:t0 + T_s - 1].to(sh.device),
            u_last.to(sh.device) if s == last else None, al[1], sh.entry_P,
            u_maps[:, t0 - 1].to(sh.device) if s else None)
    return per_device(draw, shards, range(len(shards)), alphas)


def stage_backtrace(shards, psis, maps, z_last):
    """K35 from each shard's backpointers ``psis`` (or drawn maps), K34's
    ``maps`` ((G, chunk maps) each) and z_{T-1}: each shard's path."""
    G = [g for g, _ in maps]
    return per_device(lambda sh, s: hmm_ops.shard_backtrace_cuda(
        _gather(G, sh.device), z_last.to(sh.device), s, psis[s], maps[s][1],
        sh.log_lik.shape[1]), shards, range(len(shards)))


def forward_backward_shards(log_pi0, shards):
    """Posteriors of a cut chain: (gamma of each shard (N, Ts, K) on its
    device, log_Z (N,) and xi_sum (N, K, K) on the first shard's device;
    the shards' xi sums added there in shard order). On CUDA devices K32
    then K33 on every shard; on the CPU the plain version over the chain
    put back together."""
    dev0 = shards[0].device
    if not on_card([sh.device for sh in shards]):
        gamma, log_Z, xi_sum = hmm_ops.forward_backward_plain(
            log_pi0.to(dev0), *_gather_chain(shards), parallel=True, scan=_plain_scan(shards))
        return _split(gamma, shards), log_Z, xi_sum
    fin = stage_finish(stage_totals(log_pi0, shards), shards)
    return ([f[0] for f in fin], fin[-1][1].to(dev0),
            functools.reduce(torch.add, [f[2].to(dev0) for f in fin]))


def viterbi_shards(log_pi0, shards):
    """Viterbi paths of a cut chain, each shard's (N, Ts) int32 on its
    device. On CUDA devices K32 in (max, +), K33's Viterbi mode, K34, K35;
    on the CPU the plain version over the chain put back together."""
    if not on_card([sh.device for sh in shards]):
        path = hmm_ops.viterbi_parallel_plain(log_pi0.to(shards[0].device),
                                              *_gather_chain(shards), scan=_plain_scan(shards))
        return _split(path, shards)
    vit = stage_viterbi(stage_totals(log_pi0, shards, maxplus=True), shards)
    return stage_backtrace(shards, [v[0] for v in vit], stage_maps(shards, vit), vit[-1][2])


def sample_posterior_shards(log_pi0, shards, u_last, u_maps):
    """Posterior paths of a cut chain from the uniforms u_last (N, K) and
    u_maps (N, T-1, K, K) (as ``ops.hmm.sample_posterior`` draws them, on
    any device), each shard's (N, Ts) int32 on its device. On CUDA devices
    K32, K33's alphas, K34 drawing each shard's maps from its slice of the
    uniforms, K35; on the CPU the plain version over the chain put back
    together."""
    if not on_card([sh.device for sh in shards]):
        dev0 = shards[0].device
        path = hmm_ops.sample_posterior_plain(
            log_pi0.to(dev0), *_gather_chain(shards), u_last.to(dev0), u_maps.to(dev0),
            parallel=True, scan=_plain_scan(shards))
        return _split(path, shards)
    drawn = stage_sample_maps(shards, stage_alphas(stage_totals(log_pi0, shards), shards),
                              u_last, u_maps)
    return stage_backtrace(shards, [d[2] for d in drawn], [d[:2] for d in drawn],
                           drawn[-1][3])


# ------------------------------------------------------ the public passes


def _batched(log_lik, mask):
    single = log_lik.dim() == 2
    if single:
        log_lik = log_lik[None]
        mask = None if mask is None else mask[None]
    return log_lik, hmm_ops._mask(log_lik, mask), single


def _check_mesh(mesh, log_P, single):
    if mesh is None:
        raise ValueError('the sp_* passes need a mesh to shard the time axis over')
    if single and log_P.dim() == 3:   # one trial's time-varying (T-1, K, K)
        return log_P[None]
    return log_P


def sp_forward_backward_plain(log_pi0, log_P, log_lik, mask, mesh, axis_name='sp'):
    """The plain version of :func:`sp_forward_backward` (batched (N, T, K)
    inputs): ``ops.hmm.forward_backward_plain(parallel=True)`` with
    :func:`sp_scan` over ``mesh`` as its scan (JAX: seq.py:143)."""
    scan = functools.partial(sp_scan, mesh=mesh, axis_name=axis_name)
    return hmm_ops.forward_backward_plain(log_pi0, log_P, log_lik, mask, parallel=True,
                                          scan=scan)


def sp_viterbi_plain(log_pi0, log_P, log_lik, mask, mesh, axis_name='sp'):
    """The plain version of :func:`sp_viterbi` (batched inputs):
    ``ops.hmm.viterbi_parallel_plain`` with :func:`sp_scan` (JAX:
    seq.py:182)."""
    scan = functools.partial(sp_scan, mesh=mesh, axis_name=axis_name)
    return hmm_ops.viterbi_parallel_plain(log_pi0, log_P, log_lik, mask, scan=scan)


def sp_sample_posterior_plain(log_pi0, log_P, log_lik, mask, u_last, u_maps, mesh,
                              axis_name='sp'):
    """The plain version of :func:`sp_sample_posterior` (batched inputs, the
    uniforms given): ``ops.hmm.sample_posterior_plain(parallel=True)`` with
    :func:`sp_scan` (JAX: seq.py:214)."""
    scan = functools.partial(sp_scan, mesh=mesh, axis_name=axis_name)
    return hmm_ops.sample_posterior_plain(log_pi0, log_P, log_lik, mask, u_last, u_maps,
                                          parallel=True, scan=scan)


def _joined(per_shard, device):
    return torch.cat([t.to(device) for t in per_shard], dim=1)


def sp_forward_backward(log_pi0, log_P, log_lik, mask=None, mesh=None, axis_name='sp'):
    """HMM posteriors with the time axis sharded over ``mesh`` (JAX:
    seq.py:143): (gamma, log_Z, xi_sum) as ``ops.hmm.forward_backward(...,
    parallel=True)``, for one trial (log_lik (T, K), mask (T,), log_P (K,
    K) or (T-1, K, K)) or a batch (N, T, K), on the mesh's first device:
    :func:`forward_backward_shards` of :func:`shard_chain`."""
    log_lik, mask, single = _batched(log_lik, mask)
    shards = shard_chain(_check_mesh(mesh, log_P, single), log_lik, mask, mesh, axis_name)
    gammas, log_Z, xi_sum = forward_backward_shards(log_pi0, shards)
    out = (_joined(gammas, mesh.devices[0]), log_Z, xi_sum)
    return tuple(t[0] for t in out) if single else out


def sp_viterbi(log_pi0, log_P, log_lik, mask=None, mesh=None, axis_name='sp'):
    """Most likely state paths, (T,) or (N, T) int32, with the time axis
    sharded over ``mesh`` (JAX: seq.py:182), on its first device:
    :func:`viterbi_shards`."""
    log_lik, mask, single = _batched(log_lik, mask)
    shards = shard_chain(_check_mesh(mesh, log_P, single), log_lik, mask, mesh, axis_name)
    path = _joined(viterbi_shards(log_pi0, shards), mesh.devices[0])
    return path[0] if single else path


def sp_sample_posterior(log_pi0, log_P, log_lik, mask=None, mesh=None, axis_name='sp',
                        generator=None, uniforms=None):
    """A posterior state path, (T,) or (N, T) int32, by forward filtering,
    backward sampling with the time axis sharded over ``mesh`` (JAX:
    seq.py:214), on its first device: :func:`sample_posterior_shards`. The
    uniforms are ``uniforms`` = (u_last (N, K), u_maps (N, T-1, K, K)), or
    drawn from ``generator`` on the mesh's first device in that order,
    unsharded, as ``ops.hmm.sample_posterior`` draws them: the same
    generator state gives the same path with a mesh or without one, up to
    float reassociation at a near-tie."""
    log_lik, mask, single = _batched(log_lik, mask)
    log_P = _check_mesh(mesh, log_P, single)
    N, T, K = log_lik.shape
    dev0 = mesh.devices[0]
    if uniforms is None:
        gen = hmm_ops.generator_for(dev0, generator)
        uniforms = (hmm_ops.uniforms((N, K), gen, dev0),
                    hmm_ops.uniforms((N, max(T - 1, 0), K, K), gen, dev0))
    u_last, u_maps = (u if u.dim() == d else u[None] for u, d in zip(uniforms, (2, 4)))
    paths = sample_posterior_shards(log_pi0, shard_chain(log_P, log_lik, mask, mesh, axis_name),
                                    u_last, u_maps)
    path = _joined(paths, dev0)
    return path[0] if single else path


# ------------------------------------------------------ the Kalman passes

# One shard of a linear-Gaussian model's trial cut along time (its
# ``frames`` frames [t0, t1)) on its device: F, c, Q with frames + 1 rows,
# the next shard's first frame last (``frames`` rows on the trial's last
# shard); y (frames, d) and mask (frames,); copies of H, R, m0, P0. The
# smoother reads F, c, Q only (the rest may be None).
KalmanShard = collections.namedtuple('KalmanShard', ['device', 'frames', 'F', 'c', 'Q', 'H',
                                                     'R', 'y', 'mask', 'm0', 'P0'])


def shard_lds(mesh, F, c, Q, H=None, R=None, y=None, mask=None, m0=None, P0=None,
              axis_name='sp'):
    """The model (F, c, Q (T, ...), H, R, y, mask, m0, P0 as ``ops.kalman``
    takes them) cut by :func:`shard_bounds` into :class:`KalmanShard`\\ s
    on the mesh's devices; empty shards are left out."""
    n = _axis_size(mesh, axis_name)
    T = F.shape[0]

    def on(t, dev, rows=None):
        return None if t is None else (t if rows is None else t[rows]).to(dev)
    shards = []
    for (t0, t1), dev in zip(shard_bounds(T, n), mesh.devices):
        if t1 == t0:
            continue
        halo, own = slice(t0, min(t1 + 1, T)), slice(t0, t1)
        shards.append(KalmanShard(dev, t1 - t0, on(F, dev, halo), on(c, dev, halo),
                                  on(Q, dev, halo), on(H, dev), on(R, dev), on(y, dev, own),
                                  on(mask, dev, own), on(m0, dev), on(P0, dev)))
    return shards


def _filter_ins(sh):
    """A shard's filter inputs, as ``ops.kalman`` takes them."""
    T = sh.frames
    return sh.F[:T], sh.c[:T], sh.Q[:T], sh.H, sh.R, sh.y, sh.mask, sh.m0, sh.P0


def joined_frames(per_shard, device):
    """Per-shard tuples of (Ts, ...) tensors joined along time on
    ``device``."""
    return tuple(torch.cat([t.to(device) for t in parts], dim=0) for parts in zip(*per_shard))


def _split_frames(full, shards):
    """A tuple of (T, ...) tensors -> each shard's frames on its device."""
    out, t0 = [], 0
    for sh in shards:
        out.append(tuple(t[t0:t0 + sh.frames].to(sh.device) for t in full))
        t0 += sh.frames
    return out


# The stages of the Kalman passes on the card, as the HMM passes' above:
# each runs one launcher (K36-K39) on every shard, under its device.

def stage_kalman_filter_totals(shards):
    """K36: (its filtering total, its chunk composites) each."""
    return per_device(lambda sh, s: kalman_ops.shard_filter_totals_cuda(
        *_filter_ins(sh), first=s == 0), shards, range(len(shards)))


def stage_kalman_filter_finish(tot, shards):
    """K37 from :func:`stage_kalman_filter_totals`' ``tot``: (ms, Ps) each."""
    return per_device(lambda sh, s: kalman_ops.shard_filter_finish_cuda(
        _gather([t[0] for t in tot], sh.device), s, *_filter_ins(sh), tot[s][1]),
        shards, range(len(shards)))


def stage_kalman_smoother_totals(shards, filtered):
    """K38 from each shard's filtered (ms, Ps): (its smoothing total, its
    chunk composites) each."""
    return per_device(lambda sh, f: kalman_ops.shard_smoother_totals_cuda(
        sh.F, sh.c, sh.Q, *f), shards, filtered)


def stage_kalman_smoother_finish(tot, shards, filtered):
    """K39 from :func:`stage_kalman_smoother_totals`' ``tot``: (ms_s, Ps_s)
    each."""
    return per_device(lambda sh, s, f: kalman_ops.shard_smoother_finish_cuda(
        _gather([t[0] for t in tot], sh.device), s, sh.F, sh.c, sh.Q, *f, tot[s][1]),
        shards, range(len(shards)), filtered)


def sp_kalman_filter_plain(F, c, Q, H, R, y, mask, m0, P0, mesh, axis_name='sp', chunk=None):
    """The plain version of :func:`sp_kalman_filter` (JAX: seq.py:238):
    ``ops.kalman``'s filtering elements (element 0 absorbing the prior)
    scanned by :func:`sp_scan` over ``mesh``, T padded with the identity
    element, each shard's scan in chunks of ``chunk``. (ms, Ps) on the
    mesh's first device."""
    n = F.shape[1]
    elems = kalman_ops._filter_elements(F, c, Q, H, R, y, mask, m0, P0)
    z = F.new_zeros
    identity = (torch.eye(n, dtype=F.dtype, device=F.device), z(n), z(n, n), z(n), z(n, n))
    _, b, C, _, _ = sp_scan(kalman_ops._filter_combine, elems, identity, mesh,
                            axis_name=axis_name, chunk=chunk)
    return b, C


def sp_kalman_smooth_plain(F, c, Q, ms, Ps, mesh, axis_name='sp', chunk=None):
    """The plain version of :func:`sp_kalman_smooth` (JAX: seq.py:258):
    ``ops.kalman``'s smoothing elements (the last the terminal one) suffix
    scanned by :func:`sp_scan` over ``mesh``. (ms_s, Ps_s) on the mesh's
    first device."""
    n = ms.shape[1]
    elems = kalman_ops._smooth_elements(F, c, Q, ms, Ps)
    identity = (torch.eye(n, dtype=F.dtype, device=F.device), F.new_zeros(n), F.new_zeros(n, n))
    _, g, L = sp_scan(kalman_ops._smooth_combine, elems, identity, mesh, axis_name=axis_name,
                      reverse=True, chunk=chunk)
    return g, L


def kalman_filter_shards(shards, chunk=None):
    """Filtered moments of a cut model: (ms (Ts, n), Ps (Ts, n, n)) of each
    shard on its device. On CUDA devices K36 then K37 on every shard; on
    the CPU the plain version over the trial put back together, its scan
    in chunks of ``chunk``."""
    if on_card([sh.device for sh in shards]):
        return stage_kalman_filter_finish(stage_kalman_filter_totals(shards), shards)
    sh0 = shards[0]
    F, c, Q, y, mask = joined_frames([_filter_ins(sh)[:3] + (sh.y, sh.mask) for sh in shards],
                                     sh0.device)
    return _split_frames(sp_kalman_filter_plain(F, c, Q, sh0.H, sh0.R, y, mask, sh0.m0, sh0.P0,
                                                _shard_mesh(shards), chunk=chunk), shards)


def kalman_smooth_shards(shards, filtered, chunk=None):
    """Smoothed moments of a cut model from each shard's filtered (ms, Ps):
    (ms_s, Ps_s) of each shard on its device. On CUDA devices K38 then K39
    on every shard; on the CPU the plain version over the trial put back
    together."""
    if on_card([sh.device for sh in shards]):
        return stage_kalman_smoother_finish(stage_kalman_smoother_totals(shards, filtered),
                                            shards, filtered)
    ins = joined_frames([_filter_ins(sh)[:3] + tuple(f) for sh, f in zip(shards, filtered)],
                        shards[0].device)
    return _split_frames(sp_kalman_smooth_plain(*ins, _shard_mesh(shards), chunk=chunk), shards)


def sp_kalman_filter(F, c, Q, H, R, y, mask, m0, P0, mesh, axis_name='sp', chunk=None):
    """The Kalman filter with the time axis sharded over ``mesh`` (JAX:
    seq.py:238): (ms, Ps) as ``ops.kalman.filter_parallel``, on the mesh's
    first device; :func:`kalman_filter_shards` of :func:`shard_lds`."""
    shards = shard_lds(mesh, F, c, Q, H, R, y, mask, m0, P0, axis_name=axis_name)
    return joined_frames(kalman_filter_shards(shards, chunk), mesh.devices[0])


def sp_kalman_smooth(F, c, Q, ms, Ps, mesh, axis_name='sp', chunk=None):
    """The RTS smoother with the time axis sharded over ``mesh`` (JAX:
    seq.py:258): (ms_s, Ps_s) as ``ops.kalman.smooth_parallel`` from the
    filtered (ms, Ps), on the mesh's first device:
    :func:`kalman_smooth_shards`."""
    shards = shard_lds(mesh, F, c, Q, axis_name=axis_name)
    filtered = _split_frames((ms, Ps), shards)
    return joined_frames(kalman_smooth_shards(shards, filtered, chunk), mesh.devices[0])
