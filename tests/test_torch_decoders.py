"""The port's neural decoders (``models.decoders``, the decoder data path,
``fit(method='nll')``, ``export_predictions``, the ``decoder_grid_search``
CLI and ``predict`` serving) against the JAX package's, on the CPU (the
plain versions of K5, K6 and K12), at tiny widths: 8 neural channels, 3
latents / labels / states, 40-frame trials, weights carried across by
``utils.weights``.

Where the precision head runs, its bias is set to the identity and its
weights scaled by 0.1, so that the covariance the loss factors is well
conditioned and float32 in two
operation orders agrees to ~1e-7 (from a random init its condition number
reaches ~1e3 and the two packages differ by ~1e-4). Tolerances: forward
atol 1e-5, losses and metrics rtol 1e-5, gradients 1e-5 of max|JAX|, a
two-epoch ``fit`` per-epoch losses rtol 1e-4 (as the AE's).
"""

import csv
import json
import os
import pickle

import h5py
import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.data.generator import ConcatSessionsGenerator as JaxGenerator
from behavenet_tpu.data.utils import build_data_generator as jax_build_data_generator
from behavenet_tpu.fitting import eval as jeval
from behavenet_tpu.fitting.experiment import Experiment as JaxExperiment
from behavenet_tpu.fitting.training import fit as jax_fit
from behavenet_tpu.models import Decoder as JaxDecoder
from behavenet_tpu.models import base as jbase
from behavenet_tpu_torch import serving
from behavenet_tpu_torch.data.generator import ConcatSessionsGenerator
from behavenet_tpu_torch.fitting import decoder_grid_search, hyperparams
from behavenet_tpu_torch.fitting.experiment import Experiment
from behavenet_tpu_torch.fitting.training import fit
from behavenet_tpu_torch.models.decoders import Decoder
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params

IDS = {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's'}
N, OUT, T, N_TRIALS = 8, 3, 40, 10
NOISES = ('gaussian', 'gaussian-full', 'poisson', 'categorical')


def _hp(noise, n_hid_layers=1, activation='relu', **kw):
    return dict(model_class='neural-ae', model_type='mlp-mv' if noise == 'gaussian-full'
                else 'mlp', input_size=N, output_size=OUT, n_hid_layers=n_hid_layers,
                n_hid_units=10, n_lags=2, n_max_lags=4, noise_dist=noise,
                activation=activation, rng_seed_model=0, **kw)


def _jax_params(hp, seed=0):
    """Params in the JAX layout (shapes from ``jax.eval_shape`` of the JAX
    init, numbers from numpy at torch's init scale), the precision head's
    bias set to I."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(JaxDecoder(hp).init, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda a: rs.uniform(-0.3, 0.3, a.shape).astype(np.float32), shapes)
    if 'precision_sqrt' in params:
        params['precision_sqrt']['w'] *= 0.1
        params['precision_sqrt']['b'] = np.eye(OUT, dtype=np.float32).reshape(-1)
    return params


def _jit(fn, *args):
    """``fn`` compiled for ``args`` at LLVM optimization level 0 (the same
    XLA program, built faster), called on them."""
    return jax.jit(fn).lower(*args).compile({'xla_backend_optimization_level': 0})(*args)


def _port(hp, params):
    model = Decoder(hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return model


def _batch(noise, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(T, N).astype(np.float32)
    if noise == 'categorical':
        y = rs.randint(0, OUT, T).astype(np.int32)
    elif noise == 'poisson':
        y = rs.poisson(2.0, (T, OUT)).astype(np.float32)
    else:
        y = rs.randn(T, OUT).astype(np.float32)
    fm = np.ones(T, np.float32)
    fm[T - 6:] = 0.0          # bucket padding after a 34-frame trial
    return {'predictors': x, 'targets': y, 'frame_mask': fm}


@pytest.mark.parametrize('noise', NOISES)
@pytest.mark.parametrize('n_hid_layers', [0, 1, 2])
def test_mlp_forward_matches_jax(noise, n_hid_layers):
    hp = _hp(noise, n_hid_layers, activation='lrelu' if n_hid_layers == 2 else 'relu')
    params = _jax_params(hp)
    x = _batch(noise)['predictors']
    want, want_prec = _jit(JaxDecoder(hp).forward, params, x)
    got, got_prec = _port(hp, params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if noise == 'gaussian-full':
        np.testing.assert_allclose(got_prec.detach().numpy(), np.asarray(want_prec),
                                   rtol=0, atol=1e-5)
    else:
        assert got_prec is None and want_prec is None
    assert sorted(state_dict_to_params(_port(hp, params))) == sorted(params)


@pytest.mark.parametrize('masked', [False, True], ids=['window', 'frame-mask'])
@pytest.mark.parametrize('noise', NOISES)
def test_loss_metrics_and_grads_match_jax(noise, masked):
    hp = _hp(noise)
    params = _jax_params(hp)
    batch = _batch(noise)
    if not masked:
        del batch['frame_mask']
    jmodel = JaxDecoder(hp)
    (want, want_m), want_g = _jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, None), has_aux=True), params, batch)
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
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg='%s/%s' % (layer, leaf))


def test_unported_decoders_raise():
    with pytest.raises(NotImplementedError, match='LSTM'):
        Decoder(dict(_hp('gaussian'), model_type='lstm'))
    with pytest.raises(ValueError, match='noise'):
        Decoder(_hp('bogus'))


# ------------------------------------------------- the store, fit and CLI


def _write_pickle(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(obj, f)


def _upstream_version(vdir, key, per_trial, trials):
    """A completed upstream version (found by ``*_version: "best"``) with a
    per-trial pickle under ``key``."""
    _write_pickle(os.path.join(vdir, 'meta_tags.pkl'), {
        'rng_seed_data': 0, 'trial_splits': '8;1;1;0', 'training_completed': True,
        'ae_model_latents_file': '/upstream/latents.pkl'})
    with open(os.path.join(vdir, 'metrics.csv'), 'w', newline='') as f:
        csv.writer(f).writerows([['epoch', 'val_loss'], [0, 1.0]])
    name = 'l_e_a_s_%s.pkl' % ('latents' if key == 'latents' else 'states')
    _write_pickle(os.path.join(vdir, name), {key: per_trial, 'trials': trials})
    return os.path.join(vdir, name)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """An HDF5 store of neural activity (and labels) and the upstream AE
    latents and ARHMM states, all linear in the neural activity."""
    from behavenet_tpu_torch.data.generator import split_trials
    root = str(tmp_path_factory.mktemp('store'))
    data_dir, save_dir = os.path.join(root, 'data'), os.path.join(root, 'save')
    rs = np.random.RandomState(0)
    neural = rs.randn(N_TRIALS, T, N).astype(np.float32)
    w = rs.randn(N, OUT).astype(np.float32)
    latents = neural @ w + 0.1 * rs.randn(N_TRIALS, T, OUT).astype(np.float32)
    states = np.argmax(latents, axis=-1).astype(np.int32)
    h5 = os.path.join(data_dir, 'l', 'e', 'a', 's', 'data.hdf5')
    os.makedirs(os.path.dirname(h5))
    with h5py.File(h5, 'w', libver='latest') as f:
        for group, arr in (('neural', neural), ('labels', latents)):
            g = f.create_group(group)
            for i in range(N_TRIALS):
                g.create_dataset('trial_%04i' % i, data=arr[i])
    trials = split_trials(N_TRIALS, 0, 8, 1, 1, 0)
    sess = os.path.join(save_dir, 'l', 'e', 'a', 's')
    pkl = _upstream_version(os.path.join(sess, 'ae', 'conv', '03_latents', 'ae-x', 'version_0'),
                            'latents', list(latents), trials)
    _upstream_version(os.path.join(sess, 'arhmm', '03_latents', '03_states', 'stationary',
                                   'gaussian', 'arhmm-x', 'version_0'),
                      'states', list(states), trials)
    return data_dir, save_dir, h5, pkl


def _fit_hp(expt_dir):
    return dict(_hp('gaussian-full'), learning_rate=1e-3, l2_reg=1e-4, rng_seed_train=0,
                max_n_epochs=2, min_n_epochs=1, val_check_interval=1,
                enable_early_stop=False, early_stop_history=10, export_predictions=False,
                expt_dir=expt_dir, rng_seed_data=0, device='cpu', input_signal='neural',
                output_signal='ae_latents')


def _generator(cls, store):
    data_dir, _, h5, pkl = store
    np.random.seed(0)
    return cls(data_dir, [IDS], signals_list=[['neural', 'ae_latents']],
               transforms_list=[[None, None]], paths_list=[[h5, pkl]], rng_seed=0,
               trial_splits={'train_tr': 8, 'val_tr': 1, 'test_tr': 1, 'gap_tr': 0})


def _rows(expt_dir):
    with open(os.path.join(expt_dir, 'version_0', 'metrics.csv')) as f:
        return list(csv.DictReader(f))


def test_fit_matches_jax_fit(store, tmp_path):
    """A two-epoch ``mlp-mv`` fit (eval epoch, then AMSGrad) from one init:
    the port's per-epoch losses and r2 are the JAX ``fit``'s."""
    hp = _fit_hp(str(tmp_path / 'jax' / 'x'))
    init = _jax_params(hp)
    jmodel = JaxDecoder(hp)
    jmodel.init = lambda key: init   # warm_start replaces the JAX init anyway
    jax_fit(hp, jmodel, _generator(JaxGenerator, store),
            JaxExperiment('x', str(tmp_path / 'jax')), method='nll',
            warm_start=lambda params: init)
    port_hp = _fit_hp(str(tmp_path / 'port' / 'x'))
    best = fit(port_hp, Decoder(port_hp), _generator(ConcatSessionsGenerator, store),
               Experiment('x', str(tmp_path / 'port')), method='nll',
               warm_start=lambda params: init)
    jrows, prows = _rows(hp['expt_dir']), _rows(port_hp['expt_dir'])
    assert len(jrows) == len(prows) == 3 * 2 + 1   # epochs 0-2: tr + val; 1 test trial
    for jr, pr in zip(jrows, prows):
        for key in ('epoch', 'trial', 'dataset', 'best_val_epoch'):
            assert jr.get(key) == pr.get(key), key
        for key in ('tr_loss', 'val_loss', 'test_loss', 'tr_r2', 'val_r2', 'test_r2'):
            if jr.get(key):
                np.testing.assert_allclose(float(pr[key]), float(jr[key]), rtol=1e-4,
                                           err_msg='%s epoch %s' % (key, jr['epoch']))
    assert float(prows[4]['tr_loss']) < float(prows[0]['tr_loss'])   # it trained
    jp, _ = jbase.load_params(os.path.join(hp['expt_dir'], 'version_0', 'best_val_model.pt'))
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_allclose(best[layer][leaf], np.asarray(jp[layer][leaf]),
                                       atol=1e-5, err_msg='%s/%s' % (layer, leaf))


CLI_CASES = {'neural-ae-mlp': ('neural-ae', 'mlp'), 'neural-ae-mlp-mv': ('neural-ae', 'mlp-mv'),
             'neural-arhmm': ('neural-arhmm', 'mlp')}


def _configs(tmp, store, model_class, model_type, device='cpu'):
    data_dir, save_dir, _, _ = store
    configs = {
        'data': dict(IDS, sessions_csv='', all_source='data', neural_type='ca',
                     neural_thresh=1.0, neural_bin_size=None, subsample_method='none',
                     subsample_idxs_group_0=None, subsample_idxs_group_1=None,
                     data_dir=data_dir, save_dir=save_dir),
        'model': {'experiment_name': 'port', 'model_class': model_class,
                  'model_type': model_type, 'n_lags': [2], 'n_max_lags': 4, 'l2_reg': 1e-4,
                  'rng_seed_model': 0, 'n_hid_layers': [1], 'n_hid_units': [10],
                  'activation': 'relu', 'n_ae_latents': OUT, 'ae_experiment_name': 'ae-x',
                  'ae_version': 'best', 'ae_model_class': 'ae', 'ae_model_type': 'conv',
                  'arhmm_experiment_name': 'arhmm-x', 'arhmm_version': 'best',
                  'n_arhmm_states': OUT, 'n_arhmm_lags': 1, 'kappa': 0.0,
                  'noise_type': 'gaussian', 'transitions': 'stationary'},
        'training': {'export_predictions': True, 'val_check_interval': 1,
                     'learning_rate': 1e-3, 'max_n_epochs': 2, 'min_n_epochs': 1,
                     'enable_early_stop': False, 'early_stop_history': 10,
                     'rng_seed_train': 0, 'batch_load': True, 'rng_seed_data': 0,
                     'train_frac': 1.0, 'trial_splits': '8;1;1;0'},
        'compute': {'device': device, 'tt_n_cpu_workers': 1},
    }
    args = []
    for name, cfg in configs.items():
        path = os.path.join(tmp, '%s_%s_%s.json' % (model_class, model_type, name))
        with open(path, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, path]
    return args


@pytest.fixture(scope='module')
def cli_versions(store, tmp_path_factory):
    """One run of the port's ``decoder_grid_search`` per case (and a second
    of the first, which must dedup); case -> its version dir."""
    tmp = str(tmp_path_factory.mktemp('configs'))
    _, save_dir, _, _ = store
    sess = os.path.join(save_dir, 'l', 'e', 'a', 's')
    out = {}
    for case, (mc, mt) in CLI_CASES.items():
        grid = hyperparams.get_all_params(args=_configs(tmp, store, mc, mt))
        hyperparams.run_grid_search(decoder_grid_search.main, grid)
        sub = ('03_latents', mt) if mc == 'neural-ae' else \
            ('03_latents', '03_states', 'stationary', mt)
        out[case] = os.path.join(sess, mc, *sub, 'all', 'port', 'version_0')
    mc, mt = CLI_CASES['neural-ae-mlp']
    hyperparams.run_grid_search(decoder_grid_search.main, hyperparams.get_all_params(
        args=_configs(tmp, store, mc, mt)))
    return out


def _trial(store, i=0):
    with h5py.File(store[2], 'r') as f:
        return f['neural']['trial_%04i' % i][()]


@pytest.mark.parametrize('case', list(CLI_CASES))
def test_decoder_grid_search_writes_a_version_both_packages_load(cli_versions, store, case):
    vdir = cli_versions[case]
    assert sorted(os.listdir(os.path.dirname(vdir))) == ['version_0']   # deduped rerun
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        hp = pickle.load(f)
    assert hp['training_completed'] is True
    assert (hp['input_size'], hp['output_size']) == (N, OUT)
    mc, mt = CLI_CASES[case]
    upstream = 'ae_model_latents_file' if mc == 'neural-ae' else 'arhmm_model_states_file'
    assert os.path.exists(hp[upstream])
    assert hp['noise_dist'] == {'mlp': 'gaussian', 'mlp-mv': 'gaussian-full'}[mt] \
        if mc == 'neural-ae' else hp['noise_dist'] == 'categorical'
    with open(os.path.join(vdir, 'metrics.csv')) as f:
        rows = list(csv.DictReader(f))
    assert all(np.isfinite(float(r[k])) for r in rows for k in r
               if k.endswith(('loss', 'r2', 'fc')) and r[k])

    # the JAX package loads the version and predicts what the port serves
    params, extra = jbase.load_params(os.path.join(vdir, 'best_val_model.pt'))
    assert extra == {'model_class': mc}
    x = ((_trial(store) - _trial(store).mean(0)) / _trial(store).std(0)).astype(np.float32)
    want = np.asarray(_jit(JaxDecoder(hp).forward, params, x)[0])
    bundle = serving.load_version(vdir, device='cpu')
    assert bundle.names() == ['predict']
    got = bundle.predict(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match='float32'):
        bundle.predict(x[:, :-1])


@pytest.mark.parametrize('case', ['neural-ae-mlp-mv', 'neural-arhmm'])
def test_export_predictions_matches_jax(cli_versions, case, tmp_path):
    """The predictions pickle the port's CLI wrote is what the JAX
    ``export_predictions`` writes from the same version: NaN lag borders,
    gap trials empty, the same split."""
    vdir = cli_versions[case]
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        hp = pickle.load(f)
    params, _ = jbase.load_params(os.path.join(vdir, 'best_val_model.pt'))
    gen = jax_build_data_generator(dict(hp), [IDS], export_csv=False)
    path = str(tmp_path / 'jax_predictions.pkl')
    jeval.export_predictions(gen, JaxDecoder(hp), params, filename=path, version=0)
    with open(path, 'rb') as f:
        want = pickle.load(f)
    with open(os.path.join(vdir, 'l_e_a_s_predictions.pkl'), 'rb') as f:
        got = pickle.load(f)
    for dtype in ('train', 'val', 'test'):
        np.testing.assert_array_equal(got['trials'][dtype], want['trials'][dtype])
    assert len(got['predictions']) == len(want['predictions']) == N_TRIALS
    for g, w in zip(got['predictions'], want['predictions']):
        assert g.shape == w.shape == (T, OUT) and g.dtype == np.float32
        assert np.isnan(g[:4]).all() and np.isnan(g[-4:]).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_decoder_entry_points_need_a_gpu_unless_asked(cli_versions, store, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    trial = next(hyperparams.get_all_params(args=_configs(
        str(tmp_path), store, 'neural-ae', 'mlp')).trials())
    trial.pop('device')
    with pytest.raises(RuntimeError, match='CUDA'):
        decoder_grid_search.main(trial)
    with pytest.raises(NotImplementedError, match='LSTM'):
        decoder_grid_search.main(dict(trial, model_type='lstm', device='cpu'))
    with pytest.raises(RuntimeError, match='CUDA'):
        serving.load_version(cli_versions['neural-ae-mlp'])
