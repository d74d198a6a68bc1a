"""The port's AMSGrad against the JAX package's torch-exact recursion and
against ``torch.optim.Adam(amsgrad=True)``.

The gradients include an early spike, the case in which optax's own
amsgrad (which maxes the bias-corrected moment) departs from torch's
(behavenet_tpu/ops/optim.py:1-13). Tolerance: float32, rtol 1e-5 and atol
1e-7 on the parameters after each of six steps.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from behavenet_tpu.ops import optim as joptim
from behavenet_tpu_torch.ops import optim as toptim

LR, WD = 1e-2, 1e-3


def _problem(seed=0, steps=6):
    rng = np.random.RandomState(seed)
    params = {'a': rng.randn(4, 3).astype(np.float32), 'b': rng.randn(5).astype(np.float32)}
    grads = []
    for i in range(steps):
        scale = 50.0 if i == 1 else 1.0   # the spike that sets the max early
        grads.append({k: (scale * rng.randn(*v.shape)).astype(np.float32)
                      for k, v in params.items()})
    return params, grads


def _run_port(params, grads, wd):
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ('a', 'b')]
    opt = toptim.AMSGrad(ps, lr=LR, weight_decay=wd)
    out = []
    for g in grads:
        for p, k in zip(ps, ('a', 'b')):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        out.append({k: p.detach().numpy().copy() for p, k in zip(ps, ('a', 'b'))})
    return out, opt


@pytest.mark.parametrize('wd', [0.0, WD])
def test_matches_jax_torch_exact_amsgrad(wd):
    params, grads = _problem()
    chain = [optax.add_decayed_weights(wd)] if wd else []
    tx = optax.chain(*chain, joptim.amsgrad(LR))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    port, _ = _run_port(params, grads, wd)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in params:
            np.testing.assert_allclose(port[step][k], np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg='step %d %s' % (step, k))


@pytest.mark.parametrize('wd', [0.0, WD])
def test_matches_torch_adam_amsgrad(wd):
    params, grads = _problem(seed=1)
    port, _ = _run_port(params, grads, wd)
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ('a', 'b')]
    ref = torch.optim.Adam(ps, lr=LR, weight_decay=wd, amsgrad=True)
    for step, g in enumerate(grads):
        for p, k in zip(ps, ('a', 'b')):
            p.grad = torch.from_numpy(g[k])
        ref.step()
        for p, k in zip(ps, ('a', 'b')):
            np.testing.assert_allclose(port[step][k], p.detach().numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg='step %d %s' % (step, k))


def test_state_dict_round_trip_resumes_exactly():
    params, grads = _problem(seed=2)
    full, _ = _run_port(params, grads, WD)
    half, opt = _run_port(params, grads[:3], WD)
    ps = [torch.nn.Parameter(torch.from_numpy(half[-1][k].copy())) for k in ('a', 'b')]
    opt2 = toptim.AMSGrad(ps, lr=LR, weight_decay=WD)
    opt2.load_state_dict(opt.state_dict())
    for g in grads[3:]:
        for p, k in zip(ps, ('a', 'b')):
            p.grad = torch.from_numpy(g[k])
        opt2.step()
    for p, k in zip(ps, ('a', 'b')):
        np.testing.assert_array_equal(p.detach().numpy(), full[-1][k])


def test_parameters_without_grad_are_skipped():
    p, q = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    opt = toptim.AMSGrad([p, q], lr=LR)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(q.detach(), torch.ones(2)) and q not in opt.state
    assert opt.state[p]['step'] == 1 and not torch.equal(p.detach(), torch.ones(3))


def test_kernel_wrapper_refuses_cpu_tensors():
    t = torch.zeros(3)
    with pytest.raises(ValueError, match='CUDA'):
        toptim.amsgrad_cuda_([t], [t], [t], [t], [t], [1], LR)
