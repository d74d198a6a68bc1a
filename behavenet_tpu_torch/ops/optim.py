"""torch's Adam(amsgrad=True) with L2, as the reference trains (the port of
``behavenet_tpu/ops/optim.py``).

The reference's optimizer is ``torch.optim.Adam(lr, weight_decay=l2,
amsgrad=True)`` (reference fitting/training.py:284-286), which the JAX
package rebuilds as ``optax.add_decayed_weights(l2)`` chained with its
torch-exact AMSGrad recursion: the raw second moment is maxed and divided
by the *current* step's bias correction (optax's own amsgrad maxes the
corrected moment, which differs after an early gradient spike). The L2 term
is added to the gradient before the moments (not AdamW).

:class:`AMSGrad` runs that recursion. On ``cuda`` parameters one ``step()``
is one launch of kernel K6 (``kernels/amsgrad_step.cu``) over every
parameter; on ``cpu`` parameters it runs the plain recursion
(:func:`amsgrad_plain_`). Each parameter group keeps K6's table of
pointers, checked when it is built; a step writes only the gradients'
pointers and the bias corrections (once per distinct step count) into it,
so its host cost is a few microseconds a tensor.
"""

import operator

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import launch

__all__ = ['AMSGrad', 'amsgrad_plain_', 'amsgrad_cuda_']

B1, B2, EPS = 0.9, 0.999, 1e-8
_STATE = ('exp_avg', 'exp_avg_sq', 'max_exp_avg_sq')

# one tensor of K6's table (kernels/amsgrad_step.cu, struct Entry: 64 bytes)
_ENTRY = np.dtype([('p', '<u8'), ('g', '<u8'), ('m', '<u8'), ('v', '<u8'), ('vmax', '<u8'),
                   ('n', '<i8'), ('first_block', '<i8'), ('bc1', '<f4'),
                   ('inv_sqrt_bc2', '<f4')])


def _scalars(lr, wd, b1, b2, eps):
    # float32 scalars as the JAX package forms them ((1 - b) in double, then
    # rounded once), so both recursions see the same numbers
    f = np.float32
    return f(lr), f(wd), f(b1), f(1.0 - b1), f(b2), f(1.0 - b2), f(eps)


_ONE = np.float32(1.0)


def _corrections(step, b1, b2):
    """(1 - b1^t, 1 / sqrt(1 - b2^t)) in float32, as JAX's optim.py:50-53
    (``b1`` and ``b2`` may come as float32 already)."""
    t = np.float32(step)
    bc1 = _ONE - np.power(np.float32(b1), t)
    inv_sqrt_bc2 = _ONE / np.sqrt(_ONE - np.power(np.float32(b2), t))
    return bc1, inv_sqrt_bc2


def _on_cpu(t):
    return t.device.type == 'cpu'


def amsgrad_plain_(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs, steps,
                   lr, weight_decay=0.0, b1=B1, b2=B2, eps=EPS):
    """One AMSGrad step in place, plain PyTorch, per tensor; ``steps`` are
    each tensor's step count after this step."""
    lr, wd, b1, c1, b2, c2, eps = _scalars(lr, weight_decay, b1, b2, eps)
    for p, g, m, v, vmax, step in zip(params, grads, exp_avgs, exp_avg_sqs,
                                      max_exp_avg_sqs, steps):
        bc1, inv_sqrt_bc2 = _corrections(step, b1, b2)
        if wd != 0:
            g = g + float(wd) * p
        m.copy_(float(b1) * m + float(c1) * g)
        v.copy_(float(b2) * v + float(c2) * (g * g))
        torch.maximum(vmax, v, out=vmax)
        update = (m / float(bc1)) / (torch.sqrt(vmax) * float(inv_sqrt_bc2) + float(eps))
        p.sub_(float(lr) * update)


_ptr, _numel = torch.Tensor.data_ptr, torch.Tensor.numel
_dtype, _grad = operator.attrgetter('dtype'), operator.attrgetter('grad')
_STATE_OF = [operator.itemgetter(k) for k in _STATE]


def _table_key(params, exp_avgs, exp_avg_sqs, max_exp_avg_sqs):
    """What a K6 table holds: the tensors' pointers and the sizes."""
    return (list(map(_ptr, params)), list(map(_ptr, exp_avgs)), list(map(_ptr, exp_avg_sqs)),
            list(map(_ptr, max_exp_avg_sqs)), list(map(_numel, params)))


class _Table:
    """K6's table of one parameter group: (p, m, v, vmax, n) of each tensor,
    checked once, here; each step writes the gradients' pointers and the
    bias corrections into it and launches K6 once.

    ``key`` is exactly what the table holds (:func:`_table_key`), so a
    caller that compares it with the live tensors' key never launches on a
    stale pointer."""

    def __init__(self, name, params, exp_avgs, exp_avg_sqs, max_exp_avg_sqs):
        dev = params[0].device
        for p, ts in zip(params, zip(exp_avgs, exp_avg_sqs, max_exp_avg_sqs)):
            for t in (p,) + ts:
                if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() \
                        or t.numel() != p.numel():
                    raise ValueError('%s: every tensor must be contiguous float32 on one '
                                     'CUDA device, of its parameter\'s size' % name)
        self.key = _table_key(params, exp_avgs, exp_avg_sqs, max_exp_avg_sqs)
        self.entries = np.zeros(len(params), _ENTRY)
        for field, col in zip(('p', 'm', 'v', 'vmax', 'n'), self.key):
            self.entries[field] = col
        self.address = self.entries.ctypes.data
        self.scalars = None   # (the step's arguments, K6's scalars, float32 b1 and b2)

    def step(self, grads, steps, lr, weight_decay, b1, b2, eps):
        """Launch K6 over the table with ``grads`` (a non-contiguous one is
        copied) at the tensors' step counts ``steps``: the float32
        corrections are computed once per distinct count."""
        if not all(map(torch.Tensor.is_contiguous, grads)):
            grads = [g.contiguous() for g in grads]
        if list(map(_dtype, grads)).count(torch.float32) != len(grads):
            raise ValueError('amsgrad_step: gradients must be float32')
        e = self.entries
        e['g'] = list(map(_ptr, grads))
        args = (lr, weight_decay, b1, b2, eps)
        if self.scalars is None or self.scalars[0] != args:
            f32 = _scalars(*args)
            self.scalars = args, [float(v) for v in f32], (f32[2], f32[4])
        b1_32, b2_32 = self.scalars[2]   # the same float32 values as b1, b2
        if steps.count(steps[0]) == len(steps):
            e['bc1'], e['inv_sqrt_bc2'] = _corrections(steps[0], b1_32, b2_32)
        else:
            corr = {s: _corrections(s, b1_32, b2_32) for s in set(steps)}
            e['bc1'] = [corr[s][0] for s in steps]
            e['inv_sqrt_bc2'] = [corr[s][1] for s in steps]
        launch('amsgrad_step', self.address, len(e), *self.scalars[1])


def amsgrad_cuda_(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs, steps,
                  lr, weight_decay=0.0, b1=B1, b2=B2, eps=EPS):
    """K6 ``amsgrad_step``: :func:`amsgrad_plain_` over every tensor in one
    launch (float32, contiguous, one CUDA device). Builds its table on
    every call; :class:`AMSGrad` keeps one a parameter group."""
    name = 'amsgrad_step'
    if any(t.device.type != 'cuda' for t in list(params) + list(grads)):
        raise ValueError('%s: every tensor must be contiguous float32 on one CUDA device, '
                         'of its parameter\'s size' % name)
    if any(g.device != p.device or g.shape != p.shape for p, g in zip(params, grads)):
        raise ValueError('%s: each gradient must lie beside its parameter, of its shape'
                         % name)
    _Table(name, params, exp_avgs, exp_avg_sqs, max_exp_avg_sqs).step(
        grads, steps, lr, weight_decay, b1, b2, eps)


class AMSGrad(torch.optim.Optimizer):
    """``torch.optim.Adam(params, lr, weight_decay=weight_decay,
    amsgrad=True)`` with the JAX package's float32 bias corrections.

    State per parameter, as torch's Adam names it: ``step`` (int),
    ``exp_avg``, ``exp_avg_sq`` and ``max_exp_avg_sq``. Parameters without a
    gradient are skipped and keep their step count.
    """

    def __init__(self, params, lr, weight_decay=0.0):
        if lr < 0 or weight_decay < 0:
            raise ValueError('lr and weight_decay must be >= 0')
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        tables = self.__dict__.setdefault('_tables', {})
        for i, group in enumerate(self.param_groups):
            params = group['params']
            grads = list(map(_grad, params))
            live = [p for p, g in zip(params, grads) if g is not None]
            if not live:
                continue
            grads = [g for g in grads if g is not None]
            if live[0].device.type not in ('cpu', 'cuda'):
                raise ValueError('AMSGrad: no implementation for device %s' % live[0].device)
            args = (group['lr'], group['weight_decay'], B1, B2, EPS)
            sts = [self.state[p] for p in live]
            for p, st in zip(live, sts):
                if not st:
                    st['step'] = 0
                    for k in _STATE:
                        st[k] = torch.zeros_like(p, memory_format=torch.contiguous_format)
                st['step'] += 1
            steps = [st['step'] for st in sts]
            states = [list(map(get, sts)) for get in _STATE_OF]
            if _on_cpu(live[0]):
                if not all(map(_on_cpu, live)):
                    raise ValueError('AMSGrad: a parameter group must lie on one device')
                with torch.no_grad():
                    amsgrad_plain_(live, grads, *states, steps, *args)
                continue
            # K6's table of the group, rebuilt when a pointer or a size
            # changed: a parameter gaining or losing its gradient, ``.to()``,
            # ``load_state_dict``, a reset of the state
            table = tables.get(i)
            if table is None or table.key != _table_key(live, *states):
                table = tables[i] = _Table('AMSGrad', live, *states)
            table.step(grads, steps, *args)
        return loss
