"""The port's LSTM decoder (``ops.lstm``: the plain version of K23 / K24,
``models.decoders.LSTM``, its weights) against the JAX package's, on the
CPU, at small sizes: 6 input channels, 3 outputs, h in {4, 8}, 30-frame
trials and one 29-frame trial padded to the 32-frame bucket.

Inputs and weights are drawn with numpy from a seed and handed to both
packages; JAX's functions run in one program compiled at LLVM optimization
level 0.
Tolerances: hidden states atol 1e-5 (float32, the same step, JAX's dot
over in + h terms in one sum); gradients within 1e-4 of max|JAX| (JAX
transposes the scan, the port runs autograd through the plain version);
the padded trial's loss and metrics rtol 1e-5; the weights exactly.

K24's planner (``ops.lstm.bptt_plan``) is checked against an H100's
232,448 opt-in shared bytes at widths around its limits: up to the widest
width a cluster of 8 holds (330) every row of W_hh is on chip.

The padded trial pins JAX's bucket padding: the reversed chain starts on
the zero rows, so the outputs at real frames depend on the padding (by
~1e-2 here), and a port that stopped that chain at the last real frame
would fail the loss comparison.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.models import base as jbase
from behavenet_tpu.models.decoders import LSTM as JaxLSTM
from behavenet_tpu.models.decoders import Decoder as JaxDecoder
from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.models.decoders import LSTM, Decoder
from behavenet_tpu_torch.ops import lstm
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params
from tests.jax_low import jit_low

IN, OUT, T = 6, 3, 30
BUCKET, VALID = 32, 29
NOISES = ('gaussian', 'gaussian-full', 'poisson', 'categorical')


def _hp(noise='gaussian', h=8, bidirectional=True):
    return dict(model_class='neural-ae', model_type='lstm', input_size=IN, output_size=OUT,
                n_hid_units=h, n_max_lags=4, noise_dist=noise, bidirectional=bidirectional,
                rng_seed_model=0)


def _cell(rs, h):
    return {'w': rs.uniform(-0.5, 0.5, (IN + h, 4 * h)).astype(np.float32),
            'b': rs.uniform(-0.5, 0.5, 4 * h).astype(np.float32)}


def _jax_params(hp, seed=0):
    """Params in the JAX layout (shapes from ``jax.eval_shape`` of the JAX
    init, numbers from numpy), the precision head's bias set to I and its
    weights scaled by 0.1 (a well-conditioned covariance)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(JaxDecoder(hp).init, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda a: rs.uniform(-0.5, 0.5, a.shape).astype(np.float32), shapes)
    if 'precision_sqrt' in params:
        params['precision_sqrt']['w'] *= 0.1
        params['precision_sqrt']['b'] = np.eye(OUT, dtype=np.float32).reshape(-1)
    return params


def _port(hp, params):
    model = Decoder(hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return model


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


RUN_HIDDEN = (4, 8)
GRAD_CASES = {'bidirectional': (True, 8), 'forward': (False, 4)}


def _run_inputs(h):
    rs = np.random.RandomState(h)
    x = rs.randn(T, IN).astype(np.float32)
    return _cell(rs, h), _cell(rs, h), x


def _grad_inputs(bidirectional, h):
    hp = _hp(h=h, bidirectional=bidirectional)
    rs = np.random.RandomState(2)
    return hp, _jax_params(hp, seed=1), rs.randn(T, IN).astype(np.float32), \
        rs.randn(T, OUT).astype(np.float32)


def _padded_batch(noise, seed=3):
    rs = np.random.RandomState(seed)
    x = np.zeros((BUCKET, IN), np.float32)
    x[:VALID] = rs.randn(VALID, IN)
    if noise == 'categorical':
        y = np.zeros(BUCKET, np.int32)
        y[:VALID] = rs.randint(0, OUT, VALID)
    else:
        y = np.zeros((BUCKET, OUT), np.float32)
        y[:VALID] = rs.poisson(2.0, (VALID, OUT)) if noise == 'poisson' else \
            rs.randn(VALID, OUT)
    fm = np.zeros(BUCKET, np.float32)
    fm[:VALID] = 1.0
    return {'predictors': x, 'targets': y, 'frame_mask': fm}


def _loss_inputs(noise):
    hp = _hp(noise)
    return hp, _jax_params(hp, seed=4), _padded_batch(noise)


@pytest.fixture(scope='module')
def jax_ref():
    """Every JAX reference of this file from one program compiled at level
    0: case name -> its outputs. ``_run`` over x and x[::-1] for each of
    RUN_HIDDEN; ``jax.grad`` of sum(outputs * G) of ``LSTM.apply`` for each
    of GRAD_CASES; ``jax.value_and_grad`` of ``Decoder.loss_fn`` on the
    padded trial for each noise distribution."""
    fns, args = {}, {}
    for h in RUN_HIDDEN:
        run = functools.partial(JaxLSTM._run, h_dim=h)
        fns['run%d' % h] = lambda f, b, x, run=run: (run(f, x), run(b, x[::-1])[::-1])
        args['run%d' % h] = _run_inputs(h)
    for case, (bidirectional, h) in GRAD_CASES.items():
        hp, params, x, G = _grad_inputs(bidirectional, h)
        fns[case] = jax.grad(lambda p, x, G, m=JaxLSTM(hp): (m.apply(p, x)[0] * G).sum(),
                             argnums=(0, 1))
        args[case] = (params, x, G)
    for noise in NOISES:
        hp, params, batch = _loss_inputs(noise)
        fns[noise] = jax.value_and_grad(
            lambda p, b, m=JaxDecoder(hp): m.loss_fn(p, b, None), has_aux=True)
        args[noise] = (params, batch)
    names = list(fns)
    out = jit_low(lambda *a: [fns[n](*x) for n, x in zip(names, a)],
                  *[args[n] for n in names])
    return dict(zip(names, out))


@pytest.mark.parametrize('h', RUN_HIDDEN)
def test_plain_matches_jax_run(jax_ref, h):
    """``lstm_run_plain`` forward and reversed against JAX ``LSTM._run``
    over x and over x[::-1]; ``lstm_scan`` and ``lstm_scan_plain`` are the
    two side by side."""
    fwd, bwd, x = _run_inputs(h)
    want_f, want_b = jax_ref['run%d' % h]
    got_f = lstm.lstm_run_plain(_t(x), _t(fwd['w']), _t(fwd['b']))
    got_b = lstm.lstm_run_plain(_t(x), _t(bwd['w']), _t(bwd['b']), reverse=True)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-5)
    cells = [_t(fwd['w']), _t(fwd['b']), _t(bwd['w']), _t(bwd['b'])]
    both = torch.cat([got_f, got_b], dim=1)
    assert torch.equal(lstm.lstm_scan(_t(x), *cells), both)
    assert torch.equal(lstm.lstm_scan_plain(_t(x), *cells), both)
    got64 = lstm.lstm_run_plain(_t(x), _t(fwd['w']), _t(fwd['b']), dtype=torch.float64)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)


@pytest.mark.parametrize('case', list(GRAD_CASES))
def test_grads_match_jax(jax_ref, case):
    """Gradients of sum(outputs * G) with respect to every parameter and to
    the input: the port's autograd Function (the plain version on the CPU)
    against ``jax.grad`` of JAX ``LSTM.apply``."""
    hp, params, x, G = _grad_inputs(*GRAD_CASES[case])
    want_p, want_x = jax_ref[case]
    model = _port(hp, params)
    xt = _t(x, grad=True)
    (model(xt)[0] * _t(G)).sum().backward()
    got_p = state_dict_to_params(model, {k: p.grad for k, p in model.named_parameters()})
    assert sorted(got_p) == sorted(want_p)
    pairs = [('x', xt.grad.numpy(), want_x)] + [
        ('%s/%s' % (layer, leaf), got_p[layer][leaf], want_p[layer][leaf])
        for layer in want_p for leaf in want_p[layer]]
    for name, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize('noise', NOISES)
def test_padded_loss_matches_jax(jax_ref, noise):
    """``Decoder.loss_fn`` of a 29-frame trial padded to the 32-frame bucket,
    as ``fit`` hands it over: the loss, metrics and gradients of JAX's."""
    hp, params, batch = _loss_inputs(noise)
    (want, want_m), want_g = jax_ref[noise]
    model = _port(hp, params)
    loss, metrics = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for key in ('r2', 'fc'):
        np.testing.assert_allclose(metrics[key].item(), float(want_m[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    got_g = state_dict_to_params(model, {k: p.grad for k, p in model.named_parameters()})
    for layer in want_g:
        for leaf in want_g[layer]:
            ref = np.asarray(want_g[layer][leaf])
            np.testing.assert_allclose(got_g[layer][leaf], ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg='%s/%s' % (layer, leaf))
    # the padding reaches the real frames through the reversed chain
    with torch.no_grad():
        padded = model(torch.from_numpy(batch['predictors']))[0][:VALID]
        unpadded = model(torch.from_numpy(batch['predictors'][:VALID]))[0]
    assert (padded - unpadded).abs().max().item() > 1e-3


def test_weights_round_trip(tmp_path):
    """The JAX pytree of an LSTM with a precision head to the port's state
    dict and back, and the port's to the pytree and back, bit for bit; a
    checkpoint the JAX package writes loads into the port's model."""
    hp = _hp('gaussian-full')
    params = _jax_params(hp, seed=5)
    model = Decoder(hp)
    sd = params_to_state_dict(model, params)
    assert sorted(sd) == ['model.bwd.bias', 'model.bwd.weight', 'model.fwd.bias',
                          'model.fwd.weight', 'model.out.bias', 'model.out.weight',
                          'model.precision_sqrt.bias', 'model.precision_sqrt.weight']
    back = state_dict_to_params(model, sd)
    assert sorted(back) == sorted(params)
    for layer in params:
        for leaf in params[layer]:
            assert np.array_equal(back[layer][leaf], params[layer][leaf])
            assert back[layer][leaf].shape == params[layer][leaf].shape
    own = model.state_dict()
    again = params_to_state_dict(model, state_dict_to_params(model))
    assert all(torch.equal(again[k], v) for k, v in own.items())
    assert isinstance(model.model, LSTM)

    path = str(tmp_path / 'best_val_model.pt')
    jbase.save_params(params, path, extra={'model_class': 'neural-ae'})
    loaded, extra = base.load_params(path)
    model.load_state_dict(params_to_state_dict(model, loaded))
    assert extra == {'model_class': 'neural-ae'}
    assert torch.equal(model.model.fwd.weight, torch.from_numpy(params['fwd']['w']))


def test_cpu_function_runs_plain_and_launches_nothing(monkeypatch):
    """On CPU tensors the autograd Function is the plain version (forward
    and gradients equal autograd through it) and launches no kernel; with
    no gradient asked for, nothing is saved; the kernel wrappers refuse CPU
    tensors."""
    def no_launch(*args, **kwargs):
        raise AssertionError('a kernel was launched for CPU tensors')
    monkeypatch.setattr(lstm, 'launch', no_launch)
    rs = np.random.RandomState(6)
    x = rs.randn(T, IN).astype(np.float32)
    fwd, bwd = _cell(rs, 4), _cell(rs, 4)
    ins = [x, fwd['w'], fwd['b'], bwd['w'], bwd['b']]
    G = torch.from_numpy(rs.randn(T, 8).astype(np.float32))
    a = [_t(v, grad=True) for v in ins]
    b = [_t(v, grad=True) for v in ins]
    out = lstm.lstm_scan(*a)
    ref = lstm.lstm_scan_plain(*b)
    assert torch.equal(out, ref)
    (out * G).sum().backward()
    (ref * G).sum().backward()
    assert all(torch.allclose(p.grad, q.grad, rtol=0, atol=1e-6) for p, q in zip(a, b))
    with torch.inference_mode():
        assert not lstm.lstm_scan(*a).requires_grad
    with torch.no_grad():
        assert lstm.lstm_scan(*a).grad_fn is None
    with pytest.raises(ValueError, match='one trial'):
        lstm.lstm_scan(a[0][None], *a[1:])
    plain = [_t(v) for v in ins]
    plain[0] = plain[0][None]
    with pytest.raises(ValueError, match='CUDA'):
        lstm.lstm_forward_cuda(*plain)
    with pytest.raises(ValueError, match='CUDA'):
        lstm.lstm_backward_cuda(plain[0], plain[1], plain[3], ref.detach()[None],
                                torch.zeros(1, 2, T, 4), torch.zeros(1, 2, T, 16), G[None])


H100_SMEM_OPTIN = 232448        # bytes of shared memory a block may opt in to
PLAN_WIDTHS = (1, 32, 64, 117, 118, 128, 150, 165, 256, 330, 400)


def _widest_on_chip(optin):
    return max(h for h in range(1, 1025) if lstm.bptt_plan(h, optin)['cluster'])


@pytest.mark.parametrize('h', PLAN_WIDTHS)
def test_bptt_plan_holds_every_row_on_chip_up_to_its_widest(h):
    """Up to the widest width a cluster of 8 holds: the fewest CTAs (1, 2,
    4 or 8) whose rows of W_hh fit beside two dG buffers, every row on
    chip, no empty CTA, within the opt-in limit, 8-32 threads a row and at
    most 1024 a CTA. Above it: the one-block chain (cluster 0), the rows
    that fit on chip, the others read through L2."""
    plan = lstm.bptt_plan(h, H100_SMEM_OPTIN)
    widest = _widest_on_chip(H100_SMEM_OPTIN)
    assert widest == 330
    c, rows, tpr = plan['cluster'], plan['rows'], plan['threads_per_row']
    if h > widest:
        assert c == 0 and 0 < rows < h and plan['smem'] <= H100_SMEM_OPTIN
        assert plan['smem'] == 4 * 6 * h + rows * 4 * (4 * h + 1)
        return
    assert c in (1, 2, 4, 8)
    assert c * rows >= h and (c - 1) * rows < h
    assert plan['smem'] == 4 * (rows + 2) * 4 * h <= H100_SMEM_OPTIN
    if c > 1:   # the fewest CTAs: half as many would not hold their rows
        assert 4 * (-(-h // (c // 2)) + 2) * 4 * h > H100_SMEM_OPTIN
    assert tpr in (8, 16, 32) and plan['threads'] % 32 == 0
    assert rows * tpr <= plan['threads'] < rows * tpr + 32 and plan['threads'] <= 1024


DX_WIDTHS = (1, 128, 908, 909, 1816, 1817, 3632, 3633, 7264, 7265)


@pytest.mark.parametrize('h', DX_WIDTHS)
def test_dx_frames_fit_the_opt_in_limit_at_every_width_the_chain_takes(h):
    """K24's dx blocks stage the most frames of dG (8, 4, 2 or 1; two
    directions of 4h floats each) that fit the opt-in limit, so that every
    width whose one frame fits (h <= 7264 on an H100) still launches; one
    direction fits twice as many."""
    f = lstm.dx_frames(h, 2, H100_SMEM_OPTIN)
    if h > H100_SMEM_OPTIN // 32:
        assert f == 0
        return
    assert f in (1, 2, 4, 8) and f * 2 * 16 * h <= H100_SMEM_OPTIN
    assert f == 8 or 2 * f * 2 * 16 * h > H100_SMEM_OPTIN
    assert lstm.dx_frames(h, 1, H100_SMEM_OPTIN) == min(8, 2 * f)
