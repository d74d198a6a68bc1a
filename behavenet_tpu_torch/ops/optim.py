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
(:func:`amsgrad_plain_`).
"""

import ctypes

import numpy as np
import torch

from behavenet_tpu_torch.kernels.build import launch

__all__ = ['AMSGrad', 'amsgrad_plain_', 'amsgrad_cuda_']

B1, B2, EPS = 0.9, 0.999, 1e-8


class _Entry(ctypes.Structure):
    # one tensor of K6's table (kernels/amsgrad_step.cu, struct Entry)
    _fields_ = [('p', ctypes.c_void_p), ('g', ctypes.c_void_p), ('m', ctypes.c_void_p),
                ('v', ctypes.c_void_p), ('vmax', ctypes.c_void_p), ('n', ctypes.c_longlong),
                ('first_block', ctypes.c_longlong), ('bc1', ctypes.c_float),
                ('inv_sqrt_bc2', ctypes.c_float)]


def _scalars(lr, wd, b1, b2, eps):
    # float32 scalars as the JAX package forms them ((1 - b) in double, then
    # rounded once), so both recursions see the same numbers
    f = np.float32
    return f(lr), f(wd), f(b1), f(1.0 - b1), f(b2), f(1.0 - b2), f(eps)


def _corrections(step, b1, b2):
    """(1 - b1^t, 1 / sqrt(1 - b2^t)) in float32, as JAX's optim.py:50-53."""
    t = np.float32(step)
    bc1 = np.float32(1.0) - np.power(np.float32(b1), t)
    inv_sqrt_bc2 = np.float32(1.0) / np.sqrt(np.float32(1.0) - np.power(np.float32(b2), t))
    return bc1, inv_sqrt_bc2


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


def amsgrad_cuda_(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs, steps,
                  lr, weight_decay=0.0, b1=B1, b2=B2, eps=EPS):
    """K6 ``amsgrad_step``: :func:`amsgrad_plain_` over every tensor in one
    launch (float32, contiguous, one CUDA device)."""
    name = 'amsgrad_step'
    table = (_Entry * len(params))()
    keep = []  # contiguous copies of gradients stay alive until the launch
    dev = params[0].device
    for i, (p, g, m, v, vmax, step) in enumerate(zip(
            params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs, steps)):
        g = g.contiguous()
        keep.append(g)
        for t in (p, g, m, v, vmax):
            if t.device != dev or t.device.type != 'cuda' or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError('%s: every tensor must be contiguous float32 on one '
                                 'CUDA device, of its parameter\'s size' % name)
        bc1, inv_sqrt_bc2 = _corrections(step, b1, b2)
        table[i] = _Entry(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                          vmax.data_ptr(), p.numel(), 0, bc1, inv_sqrt_bc2)
    launch(name, ctypes.addressof(table), len(params),
           *(float(s) for s in _scalars(lr, weight_decay, b1, b2, eps)))


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

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            live = [p for p in group['params'] if p.grad is not None]
            if not live:
                continue
            cols = {k: [] for k in ('exp_avg', 'exp_avg_sq', 'max_exp_avg_sq', 'step')}
            for p in live:
                st = self.state[p]
                if not st:
                    st['step'] = 0
                    for k in ('exp_avg', 'exp_avg_sq', 'max_exp_avg_sq'):
                        st[k] = torch.zeros_like(p, memory_format=torch.contiguous_format)
                st['step'] += 1
                for k in cols:
                    cols[k].append(st[k])
            on_cpu = live[0].device.type == 'cpu'
            if any((p.device.type == 'cpu') != on_cpu for p in live):
                raise ValueError('AMSGrad: a parameter group must lie on one device')
            update = amsgrad_plain_ if on_cpu else amsgrad_cuda_
            update(live, [p.grad for p in live], cols['exp_avg'], cols['exp_avg_sq'],
                   cols['max_exp_avg_sq'], cols['step'], group['lr'],
                   group['weight_decay'])
        return loss
