"""The port's pooling, unpooling and batch-norm ops (ops/conv.py, kernels K27-K30
on the card) against the JAX package's (behavenet_tpu/ops/conv.py:367-462).

Inputs are drawn with numpy from a seed. Tolerances: the pool, its indices,
its gradient, the unpool and its gradient are exact (comparisons, copies and
one division by the tie count); batch norm is float32 arithmetic in another
summation order, atol 1e-5 on outputs of order 1 and on the running
statistics, its gradients within 1e-5 of max|JAX|. The JAX references of
the module compile at level 0 as one program (``tests/jax_low.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.ops import conv as jops
from behavenet_tpu_torch.kernels.build import LAUNCHES
from behavenet_tpu_torch.ops import conv as ops
from tests.jax_low import jit_low

# (case, (H, W), ceil_mode): an even floor-mode plane, and an odd one in
# ceil mode (padded windows) and floor mode (a cut row and column)
POOL_CASES = {'14x14_floor': ((14, 14), False), '13x17_ceil': ((13, 17), True),
              '13x17_floor': ((13, 17), False)}
BN_SHAPE = (3, 5, 6, 4)
GRAD_REL = 1e-5


def _pool_input(hw, seed):
    """(2, H, W, 3) values on a coarse grid, so that many windows hold tied
    maxima; one window is all zeros (a four-way tie)."""
    x = np.random.RandomState(seed).randint(-3, 4, (2,) + hw + (3,)).astype(np.float32)
    x[0, :2, :2, 0] = 0.0
    return x


def _bn_inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*BN_SHAPE) * 2 + 1).astype(np.float32)
    c = BN_SHAPE[-1]
    return {'x': x, 'gamma': rs.uniform(0.5, 1.5, c).astype(np.float32),
            'beta': rs.randn(c).astype(np.float32),
            'mean': rs.randn(c).astype(np.float32),
            'var': rs.uniform(0.5, 2.0, c).astype(np.float32),
            'g': rs.randn(*BN_SHAPE).astype(np.float32),
            'stats': {'running_mean': rs.randn(c).astype(np.float32),
                      'running_var': rs.uniform(0.5, 2.0, c).astype(np.float32),
                      'num_batches': np.float32(3.0)}}


def _jax_refs(args):
    out = {}
    for name, (hw, ceil) in POOL_CASES.items():
        x, g = args['pool'][name]
        y, idx = jops.max_pool2d_with_indices(x, ceil_mode=ceil)
        gx = jax.grad(lambda v: jnp.sum(jops.max_pool2d_with_indices(v, ceil)[0] * g))(x)
        up = jops.max_unpool2d(y, idx, hw)
        gup = jax.grad(lambda v: jnp.sum(jops.max_unpool2d(v, idx, hw) * x))(y)
        out[name] = {'y': y, 'idx': idx, 'gx': gx, 'unpool': up, 'unpool_g': gup}
    b = args['bn']

    def bn_loss(x, gamma, beta, fixed):
        kw = {'mean': b['mean'], 'var': b['var']} if fixed else {}
        return jnp.sum(jops.batch_norm(x, gamma, beta, **kw) * b['g'])
    for fixed in (False, True):
        key = 'running' if fixed else 'batch'
        kw = {'mean': b['mean'], 'var': b['var']} if fixed else {}
        out['bn_' + key] = jops.batch_norm(b['x'], b['gamma'], b['beta'], **kw)
        out['bn_grad_' + key] = jax.grad(bn_loss, argnums=(0, 1, 2))(
            b['x'], b['gamma'], b['beta'], fixed)
    out['update_0.1'] = jops.batch_norm_update(b['x'], b['stats'], momentum=0.1)
    out['update_None'] = jops.batch_norm_update(b['x'], b['stats'], momentum=None)
    return out


@pytest.fixture(scope='module')
def refs():
    pool = {}
    for i, (name, (hw, _)) in enumerate(POOL_CASES.items()):
        x = _pool_input(hw, i)
        ho, wo = ops.pool_out_hw(hw[0], hw[1], POOL_CASES[name][1])
        g = np.random.RandomState(10 + i).randn(2, ho, wo, 3).astype(np.float32)
        pool[name] = (x, g)
    args = {'pool': pool, 'bn': _bn_inputs()}
    return args, jax.tree_util.tree_map(np.asarray, jit_low(_jax_refs, args))


@pytest.mark.parametrize('case', list(POOL_CASES))
def test_pool_and_unpool_match_jax(case, refs):
    """Values, first-maximum indices, the even split of the gradient among
    tied maxima, the unpool and its gradient: all exact."""
    args, out = refs
    (hw, ceil), (x, g) = POOL_CASES[case], args['pool'][case]
    want = out[case]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, idx = ops.max_pool2d_with_indices(xt, ceil_mode=ceil)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(y.detach().numpy(), want['y'])
    np.testing.assert_array_equal(idx.numpy(), want['idx'])
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want['gx'])
    # the planted all-zero window splits its cotangent four ways
    assert set(np.unique(want['gx'][0, :2, :2, 0])) == {g[0, 0, 0, 0] / 4}

    yt = torch.tensor(want['y']).requires_grad_(True)
    up = ops.max_unpool2d(yt, idx, hw)
    np.testing.assert_array_equal(up.detach().numpy(), want['unpool'])
    (up * torch.from_numpy(x)).sum().backward()
    np.testing.assert_array_equal(yt.grad.numpy(), want['unpool_g'])


@pytest.mark.parametrize('mode', ['batch', 'running'])
def test_batch_norm_matches_jax(mode, refs):
    args, out = refs
    b = args['bn']
    t = {k: torch.from_numpy(b[k]) for k in ('x', 'gamma', 'beta', 'mean', 'var', 'g')}
    x, gamma, beta = (t[k].clone().requires_grad_(True) for k in ('x', 'gamma', 'beta'))
    kw = {'mean': t['mean'], 'var': t['var']} if mode == 'running' else {}
    y = ops.batch_norm(x, gamma, beta, **kw)
    np.testing.assert_allclose(y.detach().numpy(), out['bn_' + mode], atol=1e-5, rtol=0)
    (y * t['g']).sum().backward()
    for got, want in zip((x.grad, gamma.grad, beta.grad), out['bn_grad_' + mode]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max())


@pytest.mark.parametrize('momentum', [0.1, None])
def test_batch_norm_update_matches_jax(momentum, refs):
    """The running statistics, the plain function and the in-place update
    that batch_norm runs in train mode, against JAX's batch_norm_update."""
    args, out = refs
    b = args['bn']
    want = out['update_%s' % momentum]
    stats = {k: torch.tensor(v) for k, v in b['stats'].items()}
    got = ops.batch_norm_update(torch.from_numpy(b['x']), stats, momentum=momentum)
    running = (torch.tensor(b['stats']['running_mean']),
               torch.tensor(b['stats']['running_var']), torch.tensor(3, dtype=torch.int64))
    ops.batch_norm(torch.from_numpy(b['x']), torch.from_numpy(b['gamma']),
                   torch.from_numpy(b['beta']), running=running, momentum=momentum)
    for key, val in (('running_mean', running[0]), ('running_var', running[1])):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-5, rtol=0)
        np.testing.assert_allclose(val.numpy(), want[key], atol=1e-5, rtol=0)
    assert float(got['num_batches']) == float(want['num_batches']) == 4.0
    assert running[2].item() == 4


def test_written_out_backwards_match_autograd():
    """The backwards the kernels implement, against autograd of the plain
    forwards: the pool (amax splits ties evenly too) with a leaky ReLU after
    it, the unpool, and batch norm with batch and with given statistics."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randint(-2, 3, (2, 7, 9, 3)).astype(np.float32))
    for ceil in (True, False):
        xa = x.clone().requires_grad_(True)
        y, idx = ops.max_pool2d_plain(xa, ceil, 'leaky_relu')
        g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
        (y * g).sum().backward()
        g_pre = torch.where(y >= 0, g, 0.05 * g)
        torch.testing.assert_close(ops.max_pool2d_grad_plain(x, g_pre, ceil), xa.grad,
                                   rtol=0, atol=0)
        v = y.detach().clone().requires_grad_(True)
        up = ops.max_unpool2d_plain(v, idx, (7, 9))
        gu = torch.from_numpy(rs.randn(*up.shape).astype(np.float32))
        (up * gu).sum().backward()
        torch.testing.assert_close(ops.max_unpool2d_grad_plain(gu, idx), v.grad, rtol=0, atol=0)

    b = {k: torch.from_numpy(v) for k, v in _bn_inputs(6).items() if k != 'stats'}
    for batch_stats in (True, False):
        xa, ga, ba = (b[k].clone().requires_grad_(True) for k in ('x', 'gamma', 'beta'))
        kw = {} if batch_stats else {'mean': b['mean'], 'var': b['var']}
        (ops.batch_norm_plain(xa, ga, ba, **kw) * b['g']).sum().backward()
        mean, var = ops.batch_norm_stats_plain(b['x']) if batch_stats else (b['mean'], b['var'])
        got = ops.batch_norm_backward_plain(b['g'], b['x'], b['gamma'], mean, var, batch_stats)
        for a, want in zip(got, (xa.grad, ga.grad, ba.grad)):
            torch.testing.assert_close(a, want, rtol=0, atol=GRAD_REL * want.abs().max().item())


def test_cpu_dispatch_launches_nothing_and_wrappers_refuse_cpu():
    """On the CPU every op runs its plain version (no kernel count moves);
    each CUDA wrapper refuses a CPU tensor."""
    names = ('max_pool2d', 'max_pool2d_grad', 'max_unpool2d', 'max_unpool2d_grad',
             'batch_norm', 'batch_norm_backward')
    before = {k: LAUNCHES[k] for k in names}
    x = torch.rand(2, 6, 6, 4, requires_grad=True)
    gamma, beta = torch.ones(4, requires_grad=True), torch.zeros(4, requires_grad=True)
    running = (torch.zeros(4), torch.ones(4), torch.zeros((), dtype=torch.int64))
    h = ops.batch_norm(x, gamma, beta, running=running, momentum=None)
    y, idx = ops.max_pool2d_with_indices(h, activation='leaky_relu')
    ops.max_unpool2d(y, idx, (6, 6)).sum().backward()
    assert {k: LAUNCHES[k] for k in names} == before
    xd = x.detach()
    idx32 = torch.zeros((2, 3, 3, 4), dtype=torch.int32)
    calls = [lambda: ops.max_pool2d_cuda(xd), lambda: ops.max_pool2d_grad_cuda(xd, y.detach()),
             lambda: ops.max_unpool2d_cuda(y.detach(), idx32, (6, 6)),
             lambda: ops.max_unpool2d_grad_cuda(xd, idx32),
             lambda: ops.batch_norm_cuda(xd, gamma.detach(), beta.detach()),
             lambda: ops.batch_norm_backward_cuda(xd, xd, gamma.detach(), running[0],
                                                  running[1])]
    for call in calls:
        with pytest.raises(ValueError, match='CUDA'):
            call()
