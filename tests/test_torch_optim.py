"""The port's AMSGrad against the JAX package's torch-exact recursion and
against ``torch.optim.Adam(amsgrad=True)``.

The gradients include an early spike, the case in which optax's own
amsgrad (which maxes the bias-corrected moment) departs from torch's
(behavenet_tpu/ops/optim.py:1-13). Tolerance: float32, rtol 1e-5 and atol
1e-7 on the parameters after each of six steps.

K6's table (the CUDA path of ``AMSGrad.step``) is driven here with CPU
tensors: the device test is patched to send them down that path and
``launch`` to a stand-in that reads the table and applies the plain
recursion to the tensors its pointers name, so the parameters must equal
the CPU path's bit for bit, and a stale pointer names no tensor.
"""

import copy
import ctypes

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


class _FakeK6:
    """K6's launch on CPU tensors: keeps each table it is handed and runs
    the kernel's update on the tensors ``tensors()`` whose pointers the
    table names, with the table's own bias corrections."""

    def __init__(self, tensors):
        self.tensors = tensors
        self.tables = []

    def __call__(self, name, address, count, lr, wd, b1, c1, b2, c2, eps):
        assert name == 'amsgrad_step'
        size = count * toptim._ENTRY.itemsize
        e = np.frombuffer(ctypes.string_at(address, size), toptim._ENTRY).copy()
        self.tables.append(e)
        by_ptr = {t.data_ptr(): t.detach() for t in self.tensors()}
        for row in e:
            p, g, m, v, vmax = (by_ptr[int(row[k])] for k in ('p', 'g', 'm', 'v', 'vmax'))
            assert p.numel() == row['n']
            if wd != 0:
                g = g + wd * p
            m.copy_(b1 * m + c1 * g)
            v.copy_(b2 * v + c2 * (g * g))
            torch.maximum(vmax, v, out=vmax)
            p.sub_(lr * ((m / float(row['bc1'])) / (torch.sqrt(vmax) * float(row['inv_sqrt_bc2'])
                                                     + eps)))


def _k6_path(monkeypatch, ps, opt):
    """Send ``opt``'s CPU parameters down K6's table path; returns the fake
    launch that records the tables."""
    fake = _FakeK6(lambda: list(ps) + [p.grad for p in ps if p.grad is not None] + [
        t for st in opt.state.values() for t in st.values() if torch.is_tensor(t)])
    monkeypatch.setattr(toptim, '_on_cpu', lambda t: False)
    monkeypatch.setattr(toptim, 'launch', fake)
    return fake


def _drive(ps, opt, grads, events=None):
    """Steps of ``opt`` over ``grads`` (a None leaves a parameter without a
    gradient); ``events[i]`` runs before step i. Returns the parameters
    after each step."""
    out = []
    for i, g in enumerate(grads):
        if events and i in events:
            events[i](ps, opt)
        for p, k in zip(ps, ('a', 'b')):
            p.grad = None if g[k] is None else torch.from_numpy(g[k])
        opt.step()
        out.append([p.detach().clone() for p in ps])
    return out


def _k6_problem(seed, drop_b_at=()):
    params, grads = _problem(seed=seed)
    for i in drop_b_at:
        grads[i]['b'] = None
    return params, grads


def _new(params):
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ('a', 'b')]
    return ps, toptim.AMSGrad(ps, lr=LR, weight_decay=WD)


def test_k6_table_entries_are_the_per_tensor_corrections(monkeypatch):
    # b has no gradient at step 2, so from step 3 on the two step counts differ
    params, grads = _k6_problem(3, drop_b_at=(1,))
    ps, opt = _new(params)
    want = _drive(ps, opt, grads)
    ps, opt = _new(params)
    fake = _k6_path(monkeypatch, ps, opt)
    got = _drive(ps, opt, grads)
    assert len(fake.tables) == len(grads)
    counts = {'a': 0, 'b': 0}
    for i, (e, g) in enumerate(zip(fake.tables, grads)):
        live = [k for k in ('a', 'b') if g[k] is not None]
        for k in live:
            counts[k] += 1
        assert len(e) == len(live)
        for row, k in zip(e, live):
            p = ps[('a', 'b').index(k)]
            bc1, inv_sqrt_bc2 = toptim._corrections(counts[k], toptim.B1, toptim.B2)
            assert row['bc1'] == bc1 and row['inv_sqrt_bc2'] == inv_sqrt_bc2, (i, k)
            assert row['n'] == p.numel() and row['first_block'] == 0
    assert counts['a'] != counts['b']
    assert [opt.state[p]['step'] for p in ps] == [counts['a'], counts['b']]
    for step, (w, g) in enumerate(zip(want, got)):
        for a, b in zip(w, g):
            assert torch.equal(a, b), step


def test_k6_table_is_kept_and_rebuilt_when_a_pointer_changes(monkeypatch):
    params, grads = _k6_problem(4)
    ps, opt = _new(params)
    want = _drive(ps, opt, grads)
    ps, opt = _new(params)
    fake = _k6_path(monkeypatch, ps, opt)
    tables = []

    def move_a(ps, opt):           # a's storage moves, as under .to() or .data =
        ps[0].data = ps[0].data.clone()

    def reload(ps, opt):           # a checkpoint's state: every state tensor is new
        opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    events = {2: move_a, 4: reload}

    def record(i):
        return lambda ps, opt: (tables.append(opt._tables[0]), events.get(i, lambda *a: 0)(
            ps, opt))
    got = _drive(ps, opt, grads, {i: record(i) for i in range(1, len(grads))})
    tables.append(opt._tables[0])
    # tables[i] is the one step i used: kept through steps 0-1, 2-3 and 4-5
    assert tables[0] is tables[1] and tables[2] is tables[3] and tables[4] is tables[5]
    assert tables[1] is not tables[2] and tables[3] is not tables[4]
    e_before, e_moved, e_reloaded = fake.tables[1], fake.tables[2], fake.tables[4]
    assert e_moved[0]['p'] != e_before[0]['p'] and e_moved[0]['p'] == ps[0].data_ptr()
    state = [opt.state[p] for p in ps]
    for k, field in (('exp_avg', 'm'), ('exp_avg_sq', 'v'), ('max_exp_avg_sq', 'vmax')):
        assert list(e_reloaded[field]) == [st[k].data_ptr() for st in state]
        assert all(a != b for a, b in zip(e_reloaded[field], fake.tables[3][field]))
    for step, (w, g) in enumerate(zip(want, got)):
        for a, b in zip(w, g):
            assert torch.equal(a, b), step


def test_k6_table_leaves_out_a_parameter_without_gradient(monkeypatch):
    # b has no gradient for its first two steps, then joins
    params, grads = _k6_problem(5, drop_b_at=(0, 1))
    ps, opt = _new(params)
    want = _drive(ps, opt, grads)
    ps, opt = _new(params)
    fake = _k6_path(monkeypatch, ps, opt)
    got = _drive(ps, opt, grads[:2])
    assert [len(e) for e in fake.tables] == [1, 1]
    assert all(e[0]['p'] == ps[0].data_ptr() for e in fake.tables)
    assert ps[1] not in opt.state and torch.equal(ps[1].detach(), torch.from_numpy(params['b']))
    got += _drive(ps, opt, grads[2:])
    assert len(fake.tables[2]) == 2 and fake.tables[2][1]['p'] == ps[1].data_ptr()
    assert [opt.state[p]['step'] for p in ps] == [len(grads), len(grads) - 2]
    for step, (w, g) in enumerate(zip(want, got)):
        for a, b in zip(w, g):
            assert torch.equal(a, b), step


@pytest.mark.parametrize('reset', ['clear', 'del'])
def test_k6_table_follows_a_reset_of_the_state(monkeypatch, reset):
    """``opt.state.clear()`` (or ``del opt.state[p]``) between steps: new
    state is made and named by the table, the step counts start again, and
    the parameters equal the CPU path's under the same reset."""
    params, grads = _k6_problem(6)

    def clear(ps, opt):
        if reset == 'clear':
            opt.state.clear()
        else:
            del opt.state[ps[0]]
    ps, opt = _new(params)
    want = _drive(ps, opt, grads, {3: clear})
    want_steps = [opt.state[p]['step'] for p in ps]
    ps, opt = _new(params)
    fake = _k6_path(monkeypatch, ps, opt)
    got = _drive(ps, opt, grads, {3: clear})
    assert [opt.state[p]['step'] for p in ps] == want_steps
    assert want_steps[0] == len(grads) - 3
    state = [opt.state[p] for p in ps]
    for k, field in (('exp_avg', 'm'), ('exp_avg_sq', 'v'), ('max_exp_avg_sq', 'vmax')):
        assert list(fake.tables[-1][field]) == [st[k].data_ptr() for st in state]
    assert fake.tables[3][0]['bc1'] == toptim._corrections(1, toptim.B1, toptim.B2)[0]
    assert len(opt.state_dict()['state']) == 2
    for step, (w, g) in enumerate(zip(want, got)):
        for a, b in zip(w, g):
            assert torch.equal(a, b), step
