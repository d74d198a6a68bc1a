"""The port's Bayesian decoder against the JAX package's, on the CPU (the
plain versions of K17, the IMM filter, and K18, the RTS smoother; with
``parallel=True`` those of K19 and K20, the associative Kalman filter and
smoother of ``ops.kalman``).

The ARHMMs are JAX ``ARHMM``s with seeded numpy params (no fit), pickled and
loaded into the port through ``utils.pickles.load_arhmm``. Trials carry NaN
lag borders, as the neural decoders' prediction exports do, and one a NaN
tail pad, as the CLI's length buckets do. JAX's functions run compiled at
LLVM optimization level 0 (the same XLA programs, built in less time),
each decoder's programs shared across the cases of its module fixture.

Tolerances (float32 on both sides, the same operations in another order
over chains of 48-64 steps, or scans whose trees differ): latents and
covariances within rtol 1e-4, atol 1e-5 (measured: ~2e-6), the discrete
posteriors within 1e-5, the Viterbi states equal. The CLI's exports and
metrics against the JAX CLI's on a copy of the same store likewise, with
and without ``parallel_scan``.
"""

import csv
import json
import os
import pickle
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.fitting import bayesian_decoder_grid_search as jcli
from behavenet_tpu.fitting import hyperparams as jhyper
from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.models.bayesian import BayesianDecoder as JaxDecoder
from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu_torch.fitting import bayesian_decoder_grid_search as tcli
from behavenet_tpu_torch.fitting import hyperparams as thyper
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.models.bayesian import BayesianDecoder
from behavenet_tpu_torch.ops import imm
from behavenet_tpu_torch.utils import pickles
from tests.jax_low import compile_low

RTOL, ATOL, GAMMA_TOL = 1e-4, 1e-5, 1e-5
BORDER = 3        # NaN rows at each end of a prediction export


def _compile_low(fn):
    """``jax.jit(fn)`` compiled at LLVM optimization level 0, once per
    argument signature."""
    cache = {}

    def run(*args):
        key = tuple(None if a is None else (np.shape(a), str(np.asarray(a).dtype))
                    for a in args)
        if key not in cache:
            cache[key] = compile_low(fn, *args)
        return cache[key](*args)
    return run


_FORWARD_BACKWARD = _compile_low(jhmm.forward_backward)


def _jax_states_posterior(jdec, ae_predictions, arhmm_predictions):
    """JAX's ``states_posterior``, its (eager) forward-backward compiled at
    level 0."""
    mod = sys.modules[JaxDecoder.__module__]
    real = mod.hmm_ops
    mod.hmm_ops = types.SimpleNamespace(forward_backward=_FORWARD_BACKWARD)
    try:
        return jdec.states_posterior(ae_predictions, arhmm_predictions)
    finally:
        mod.hmm_ops = real


def _low_opt_decoder(dec):
    """A JAX decoder whose per-instance jit cache compiles at level 0. The
    associative Kalman pass (``decode(parallel=True)``) compiles once for
    both ``smooth`` settings: one program returns the smoothed and the
    filtered moments, and each setting reads its own."""
    cache = {}

    def jitted(key, fn):
        if key[0] == 'soft-parallel':
            both_key = ('soft-parallel-both',) + key[2:]
            if both_key not in cache:
                cache[both_key] = _compile_low(lambda y, m, g: tuple(
                    dec._soft_kalman_parallel(y, m, g, smooth) for smooth in (True, False)))
            return lambda *args: cache[both_key](*args)[0 if key[1] else 1]
        if key not in cache:
            cache[key] = _compile_low(fn)
        return cache[key]
    dec._jitted = jitted
    return dec


def _arhmm_params(K, D, lags, seed):
    rs = np.random.RandomState(seed)
    P = 0.8 * np.eye(K) + 0.2 * rs.dirichlet(np.ones(K), size=K)
    m = rs.randn(K, D, D)
    return {
        'log_pi0': np.log(rs.dirichlet(np.ones(K))),
        'log_Ps': np.log(P),
        'As': 0.5 * rs.randn(K, D, D * lags) / np.sqrt(D * lags),
        'bs': 0.2 * rs.randn(K, D),
        'Sigmas': 0.1 * m @ np.swapaxes(m, 1, 2) / D + 0.05 * np.eye(D),
        'nus': np.full(K, 4.0),
    }


def _models(tmp, K, D, lags, seed, parallel_scan=False):
    """A JAX ARHMM with seeded params, pickled, and the port's load of it."""
    j = JaxARHMM(K, D, lags=lags, rng_seed=seed, parallel_scan=parallel_scan)
    j.params = {k: jax.numpy.asarray(v, dtype=np.float32)
                for k, v in _arhmm_params(K, D, lags, seed).items()}
    path = os.path.join(tmp, 'arhmm_%d_%d_%d_%d.pt' % (K, D, lags, parallel_scan))
    with open(path, 'wb') as f:
        pickle.dump(j, f)
    return j, pickles.load_arhmm(path, device='cpu')


def _trial(T, K, D, seed, pad=0):
    """Predictions (T + pad, D) and state probabilities (T + pad, K) with NaN
    borders and ``pad`` NaN tail rows; the true latents (T, D)."""
    rs = np.random.RandomState(seed)
    x = np.cumsum(0.3 * rs.randn(T, D), axis=0)
    y = x + 0.4 * rs.randn(T, D)
    q = rs.dirichlet(np.ones(K), size=T)
    y[:BORDER] = y[-BORDER:] = np.nan
    q[:BORDER] = q[-BORDER:] = np.nan
    y = np.concatenate([y, np.full((pad, D), np.nan)])
    q = np.concatenate([q, np.full((pad, K), np.nan)])
    return x.astype(np.float32), y.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope='module')
def tmpdir_module(tmp_path_factory):
    return str(tmp_path_factory.mktemp('bayes'))


# name -> (K, D, lags, parallel_scan, T, tail pad, seed)
_CASES = {'lags1': (3, 3, 1, False, 48, 0, 1), 'lags2': (2, 2, 2, False, 50, 14, 2),
          'parallel_scan': (3, 2, 1, True, 24, 8, 3)}


@pytest.fixture(scope='module')
def pairs(tmpdir_module):
    """name -> a JAX decoder and the port's on the same ARHMM and R, with a
    trial; built on first use, its JAX programs shared by the cases."""
    made = {}

    def get(name):
        if name not in made:
            K, D, lags, par, T, pad, seed = _CASES[name]
            j, t = _models(tmpdir_module, K, D, lags, seed, parallel_scan=par)
            rs = np.random.RandomState(5)
            m = rs.randn(D, D)
            R = (0.2 * m @ m.T / D + 0.1 * np.eye(D)).astype(np.float32)
            x, y, q = _trial(T, K, D, seed=7, pad=pad)
            made[name] = (_low_opt_decoder(JaxDecoder(j, obs_noise=R)),
                          BayesianDecoder(t, obs_noise=R), x, y, q)
        return made[name]
    return get


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', ['lags1', 'lags2'])
def test_imm_filter_and_rts_smoother_match_jax(pairs, name):
    """``ops.imm`` on the inputs JAX's ``_kalman_filter`` and
    ``_rts_smoother`` take (its own companion dynamics and prior moments, a
    seeded discrete posterior, the NaN-border rows unobserved), against
    their outputs; the float64 plain versions agree too."""
    jdec, tdec, _, y, q = pairs(name)
    mask = (~np.isnan(y).any(axis=1)).astype(np.float32)
    y0 = np.nan_to_num(y)
    gamma = np.random.RandomState(9).dirichlet(np.ones(jdec.K), size=len(y)).astype(np.float32)

    def both(y_d, m_d, g_d):
        f = jdec._kalman_filter(y_d, m_d, g_d)
        return (jdec._aug_dynamics() + jdec._init_moments(y_d, g_d),
                f + jdec._rts_smoother(*f, g_d))
    ins, want = _compile_low(both)(y0, mask, gamma)
    As, bs, Qs, mu0, Sigma0 = (np.asarray(a) for a in ins)
    ins = [torch.from_numpy(np.array(a)) for a in
           (y0, mask, gamma, As, bs, Qs, jdec.R, mu0, Sigma0)]
    want = [np.asarray(a) for a in want]
    filt = imm.imm_filter(*ins)
    smooth = imm.rts_smoother(*filt, ins[2], ins[3])
    for got, w in zip(filt + smooth, want):
        _close(got, w)
    filt64 = imm.imm_filter_plain(*ins, dtype=torch.float64)
    smooth64 = imm.rts_smoother_plain(*filt64, ins[2], ins[3], dtype=torch.float64)
    assert filt64[0].dtype == torch.float64
    for got, w in zip(filt64 + smooth64, want):
        _close(got, w)


@pytest.mark.parametrize('name,evidence,smooth', [
    ('lags1', True, True), ('lags1', True, False), ('lags1', False, True),
    ('lags2', True, True), ('parallel_scan', True, True)],
    ids=['lags1-states-smooth', 'lags1-states-filter', 'lags1-latents-only',
         'lags2-tail-pad', 'parallel_scan'])
def test_decode_matches_jax(pairs, name, evidence, smooth):
    """``decode`` of one trial: latents and their covariances within the
    tolerance, the Viterbi states equal, the posteriors within 1e-5; the
    lags-2 trial has a NaN tail pad, the parallel_scan ARHMM's discrete pass
    is the parallel one on both sides."""
    jdec, tdec, _, y, q = pairs(name)
    q = q if evidence else None
    want = jdec.decode(y, arhmm_predictions=q, smooth=smooth)
    got = tdec.decode(y, arhmm_predictions=q, smooth=smooth)
    assert set(got) == set(want)
    _close(got['latents'], want['latents'])
    _close(got['latents_cov'], want['latents_cov'])
    np.testing.assert_array_equal(got['states'], want['states'])
    np.testing.assert_allclose(got['states_posterior'], want['states_posterior'],
                               rtol=0, atol=GAMMA_TOL)
    assert np.isfinite(got['latents']).all() and got['latents'].shape == (len(y), tdec.D)


@pytest.mark.parametrize('name,smooth', [('parallel_scan', True), ('parallel_scan', False),
                                         ('lags2', True), ('lags2', False)],
                         ids=['lags1-smooth', 'lags1-filter', 'lags2-smooth', 'lags2-filter'])
def test_decode_parallel_matches_jax(pairs, name, smooth):
    """``decode(parallel=True)``: the associative filter and smoother over
    the gamma-weighted dynamics and the parallel-prefix discrete pass,
    against JAX's on trials with NaN borders and a NaN tail pad. At lags 1
    the ARHMM has ``parallel_scan`` (the discrete programs are the
    ``parallel_scan`` case's); at lags 2 it has not, and the decode asks for
    the parallel pass itself."""
    jdec, tdec, _, y, q = pairs(name)
    want = jdec.decode(y, arhmm_predictions=q, smooth=smooth, parallel=True)
    got = tdec.decode(y, arhmm_predictions=q, smooth=smooth, parallel=True)
    assert tdec.arhmm.parallel_scan == (name == 'parallel_scan') and set(got) == set(want)
    _close(got['latents'], want['latents'])
    _close(got['latents_cov'], want['latents_cov'])
    np.testing.assert_array_equal(got['states'], want['states'])
    np.testing.assert_allclose(got['states_posterior'], want['states_posterior'],
                               rtol=0, atol=GAMMA_TOL)
    assert np.isfinite(got['latents']).all() and got['latents'].shape == (len(y), tdec.D)


def test_states_posterior_and_obs_noise_match_jax(pairs):
    jdec, tdec, x, y, q = pairs('lags1')
    real = len(x)
    lat = [x[:real // 2], x[real // 2:]]
    pred = [y[:real // 2], y[real // 2:real]]
    np.testing.assert_allclose(tdec.estimate_obs_noise(lat, pred).numpy(),
                               np.asarray(jdec.estimate_obs_noise(lat, pred)), rtol=1e-6)
    inner = slice(BORDER, real - BORDER)
    for args in ((y[inner], q[inner]), (None, q[inner]), (y[inner], None)):
        np.testing.assert_allclose(tdec.states_posterior(*args),
                                   _jax_states_posterior(jdec, *args), rtol=0, atol=GAMMA_TOL)


def test_unported_paths_raise(pairs):
    """``mesh=`` takes a ``parallel.Mesh`` and nothing else; the CUDA wrappers
    refuse CPU tensors and shapes past their limits, launching nothing."""
    _, tdec, _, y, q = pairs('lags1')
    with pytest.raises(TypeError, match='Mesh'):
        tdec.decode(y, q, mesh=object())
    before = dict(build.LAUNCHES)
    K, n, T, D = tdec.K, tdec.n, 8, tdec.D
    f = torch.zeros
    args = (f(T, D), f(T), f(T, K), f(K, n, n), f(K, n), f(K, n, n), f(D, D), f(n), f(n, n))
    with pytest.raises(ValueError, match='CUDA'):
        imm.imm_filter_cuda(*args)
    with pytest.raises(ValueError, match='CUDA'):
        imm.rts_smoother_cuda(f(T, n), f(T, n, n), f(T - 1, n), f(T - 1, n, n), f(T, K),
                              f(K, n, n))
    K2 = imm.MAX_K + 1
    with pytest.raises(ValueError, match='K <= %d' % imm.MAX_K):
        imm.imm_filter_cuda(f(T, D), f(T), f(T, K2), f(K2, n, n), f(K2, n), f(K2, n, n),
                            f(D, D), f(n), f(n, n))
    n2 = imm.MAX_N + 1
    with pytest.raises(ValueError, match='n <= %d' % imm.MAX_N):
        imm.rts_smoother_cuda(f(T, n2), f(T, n2, n2), f(T - 1, n2), f(T - 1, n2, n2),
                              f(T, K), f(K, n2, n2))
    assert build.LAUNCHES == before


# ------------------------------------------------------------------ the CLI

IDS = dict(lab='lab', expt='expt', animal='animal', session='sess')
SESS = '_'.join(IDS.values())
N_TRIALS, CLI_K, CLI_D = 10, 2, 3


def _version(path, rows=((0, 1.0),)):
    """A completed upstream version dir with the run's data seed and splits."""
    os.makedirs(path)
    with open(os.path.join(path, 'meta_tags.pkl'), 'wb') as f:
        pickle.dump({'rng_seed_data': 0, 'trial_splits': '8;1;1;0',
                     'training_completed': True}, f)
    with open(os.path.join(path, 'metrics.csv'), 'w', newline='') as f:
        csv.writer(f).writerows([('epoch', 'val_loss')] + list(rows))
    return path


def _write_store(save_dir, tmp):
    """The upstream versions a Bayesian decoding run reads: the AE's latents,
    the ARHMM (a JAX-written ``best_val_model.pt``) with its states, and the
    two decoders' predictions with NaN borders."""
    rs = np.random.RandomState(3)
    sess_dir = os.path.join(save_dir, *IDS.values())
    j, t = _models(tmp, CLI_K, CLI_D, 1, seed=11)
    lats, states, preds, logits = [], [], [], []
    for i in range(N_TRIALS):
        x, y, q = _trial(20 + i, CLI_K, CLI_D, seed=20 + i)
        lats.append(x)
        z = t.most_likely_states(x)
        states.append(z)
        preds.append(y)
        lg = 2.0 * np.eye(CLI_K)[z] + rs.randn(len(x), CLI_K)
        lg[np.isnan(q).any(axis=1)] = np.nan
        logits.append(lg.astype(np.float32))

    vdir = _version(os.path.join(sess_dir, 'ae', 'conv', '%02i_latents' % CLI_D, 'ae-expt',
                                 'version_0'))
    with open(os.path.join(vdir, '%s_latents.pkl' % SESS), 'wb') as f:
        pickle.dump({'latents': lats, 'trials': None}, f)
    vdir = _version(os.path.join(sess_dir, 'arhmm', '%02i_latents' % CLI_D,
                                 '%02i_states' % CLI_K, 'stationary', 'gaussian', 'arhmm-expt',
                                 'version_0'))
    with open(os.path.join(vdir, '%s_states.pkl' % SESS), 'wb') as f:
        pickle.dump({'states': states, 'trials': None}, f)
    with open(os.path.join(vdir, 'best_val_model.pt'), 'wb') as f:
        pickle.dump(j, f)
    # two decoder versions each; "best" picks version_1 by val loss
    for mc, parts, value in (
            ('neural-ae', ['%02i_latents' % CLI_D, 'mlp'], preds),
            ('neural-arhmm', ['%02i_latents' % CLI_D, '%02i_states' % CLI_K, 'stationary',
                              'mlp'], logits)):
        for v, loss in ((0, 2.0), (1, 1.0)):
            vdir = _version(os.path.join(sess_dir, mc, *parts, 'all', 'dec-expt',
                                         'version_%d' % v), rows=((0, loss),))
            with open(os.path.join(vdir, '%s_predictions.pkl' % SESS), 'wb') as f:
                pickle.dump({'predictions': value if v else [p + 9.0 for p in value],
                             'trials': None}, f)
    return lats


def _cli_args(tmp, save_dir, device, parallel=False):
    cfgs = {
        'data': dict(IDS, save_dir=save_dir, data_dir=os.path.join(tmp, 'data'),
                     all_source='save'),
        'model': {'experiment_name': 'bayes-expt', 'model_class': 'bayesian-decoding',
                  'model_type': 'bayes', 'rng_seed_model': 0,
                  'ae_experiment_name': 'ae-expt', 'ae_version': 'best',
                  'ae_model_class': 'ae', 'ae_model_type': 'conv', 'n_ae_latents': CLI_D,
                  'arhmm_experiment_name': 'arhmm-expt', 'n_arhmm_states': CLI_K,
                  'n_arhmm_lags': 1, 'kappa': 0.0, 'noise_type': 'gaussian',
                  'transitions': 'stationary', 'arhmm_version': 'best',
                  'neural_ae_experiment_name': 'dec-expt', 'neural_ae_model_type': 'mlp',
                  'neural_ae_version': 'best', 'neural_arhmm_experiment_name': 'dec-expt',
                  'neural_arhmm_model_type': 'mlp', 'neural_arhmm_version': 'best',
                  'state_evidence_weight': 1.0, 'use_state_evidence': True, 'smooth': True,
                  'parallel_scan': parallel},
        'training': {'export_latents': True, 'export_states': True, 'batch_load': True,
                     'rng_seed_data': 0, 'train_frac': 1.0, 'trial_splits': '8;1;1;0'},
        'compute': {'device': device, 'tt_n_cpu_workers': 1},
    }
    args = []
    for name, cfg in cfgs.items():
        path = os.path.join(tmp, '%s_%s_%s.json' % (os.path.basename(save_dir), device, name))
        with open(path, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, path]
    return args


def _run(cli, hyper, args):
    for hp in hyper.get_all_params('grid_search', args).trials():
        cli.main(hp)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory, monkeypatch_module):
    """The port's CLI and the JAX CLI on copies of one store."""
    tmp = str(tmp_path_factory.mktemp('bayes_cli'))
    port_dir, jax_dir = os.path.join(tmp, 'port'), os.path.join(tmp, 'jax')
    lats = _write_store(port_dir, tmp)
    shutil.copytree(port_dir, jax_dir)
    shutil.copytree(port_dir, os.path.join(tmp, 'store'))
    monkeypatch_module.setattr(JaxDecoder, '_jitted', lambda self, key, fn: self._jit_cache
                               .setdefault(key, _compile_low(fn)))
    _run(tcli, thyper, _cli_args(tmp, port_dir, 'cpu'))
    _run(jcli, jhyper, _cli_args(tmp, jax_dir, 'cpu'))
    return tmp, port_dir, jax_dir, lats


@pytest.fixture(scope='module')
def cli_runs_parallel(cli_runs):
    """Both CLIs with ``parallel_scan: true`` on fresh copies of the store."""
    tmp, _, _, lats = cli_runs
    port_dir, jax_dir = os.path.join(tmp, 'port_par'), os.path.join(tmp, 'jax_par')
    for d in (port_dir, jax_dir):
        shutil.copytree(os.path.join(tmp, 'store'), d)
    _run(tcli, thyper, _cli_args(tmp, port_dir, 'cpu', parallel=True))
    _run(jcli, jhyper, _cli_args(tmp, jax_dir, 'cpu', parallel=True))
    return port_dir, jax_dir, lats


@pytest.fixture(scope='module')
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _outputs(save_dir):
    vdir = os.path.join(save_dir, *IDS.values(), 'bayesian-decoding', '%02i_latents' % CLI_D,
                        '%02i_states' % CLI_K, 'stationary', 'gaussian', 'all', 'bayes-expt',
                        'version_0')
    out = {}
    for key in ('latents', 'states'):
        with open(os.path.join(vdir, '%s_%s.pkl' % (SESS, key)), 'rb') as f:
            out[key] = pickle.load(f)
    with open(os.path.join(vdir, 'metrics.csv'), newline='') as f:
        out['metrics'] = list(csv.DictReader(f))
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        out['meta'] = pickle.load(f)
    return vdir, out


def _exports_match(port_dir, jax_dir, lats):
    """The port's exports equal the JAX CLI's within the tolerance (states
    equal) and its metrics.csv logs the same losses. Returns the port's
    version directory."""
    vdir, got = _outputs(port_dir)
    _, want = _outputs(jax_dir)
    assert got['meta']['training_completed']
    for a, b, x in zip(got['latents']['latents'], want['latents']['latents'], lats):
        assert a.shape == x.shape and np.isfinite(a).all()
        _close(a, b)
    for a, b in zip(got['states']['states'], want['states']['states']):
        np.testing.assert_array_equal(a, b)
    for key in ('train', 'val', 'test'):
        np.testing.assert_array_equal(got['latents']['trials'][key],
                                      want['latents']['trials'][key])
    assert len(got['metrics']) == len(want['metrics']) == 3
    for a, b in zip(got['metrics'], want['metrics']):
        assert a.keys() == b.keys()
        for k in a:
            if a[k] not in ('', b[k]):
                np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-4)
    return vdir


def test_cli_exports_match_jax(cli_runs):
    """The port's exports and metrics equal the JAX CLI's, and a second run
    dedups."""
    tmp, port_dir, jax_dir, lats = cli_runs
    vdir = _exports_match(port_dir, jax_dir, lats)
    _run(tcli, thyper, _cli_args(tmp, port_dir, 'cpu'))
    assert sorted(os.listdir(os.path.dirname(vdir))) == ['version_0']


def test_cli_parallel_scan_matches_jax(cli_runs_parallel):
    """``"parallel_scan": true``: the port's exports and metrics equal the
    JAX CLI's (both decode with ``parallel=True``)."""
    _exports_match(*cli_runs_parallel)
    with open(os.path.join(_outputs(cli_runs_parallel[0])[0], 'meta_tags.pkl'), 'rb') as f:
        assert pickle.load(f)['parallel_scan']


def test_cli_refuses_what_is_not_ported(cli_runs):
    """The GPU is the default device (no GPU here) and ``"tpu"`` is refused,
    before any work."""
    tmp = cli_runs[0]
    hp = next(thyper.get_all_params('grid_search', _cli_args(
        tmp, os.path.join(tmp, 'none'), 'cpu')).trials())
    hp.pop('device')
    with pytest.raises(RuntimeError, match='CUDA'):
        tcli.main(hp)
    with pytest.raises(ValueError, match='tpu'):
        tcli.main(dict(hp, device='tpu'))
    assert not os.path.exists(os.path.join(tmp, 'none'))
