"""The port's trainer and CLI against the JAX package's.

On the tiny HDF5 store of tests/test_fitting/test_resume.py (1x16x12 frames,
20-frame trials padded to 32, two conv layers), the port's ``fit`` starts
from the JAX init (carried in with ``warm_start``) and batches in the JAX
``fit``'s order. Tolerance: the per-epoch losses in metrics.csv within rtol
1e-4, the best-val parameters within atol 1e-5 (float32, other summation
orders over 16 AMSGrad steps).
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
from behavenet_tpu.fitting.experiment import Experiment as JaxExperiment
from behavenet_tpu.fitting.training import fit as jax_fit
from behavenet_tpu.models import AE as JaxAE
from behavenet_tpu.models import arch as jarch
from behavenet_tpu.models import base as jbase
from behavenet_tpu_torch import serving
from behavenet_tpu_torch.data.generator import ConcatSessionsGenerator
from behavenet_tpu_torch.fitting import ae_grid_search, hyperparams
from behavenet_tpu_torch.fitting.experiment import Experiment
from behavenet_tpu_torch.fitting.training import fit
from behavenet_tpu_torch.models.aes import AE
from behavenet_tpu_torch.models.base import load_params

IDS = {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's'}


def _write_store(data_dir, n_trials=12, frames=20, shape=(1, 16, 12), seed=0):
    path = os.path.join(data_dir, 'l', 'e', 'a', 's', 'data.hdf5')
    os.makedirs(os.path.dirname(path))
    rng = np.random.RandomState(seed)
    with h5py.File(path, 'w', libver='latest') as f:
        gi = f.create_group('images')
        for i in range(n_trials):
            gi.create_dataset('trial_%04i' % i, dtype='uint8',
                              data=rng.randint(0, 255, (frames,) + shape))
    return path


def _hparams(expt_dir, max_n_epochs, **kw):
    small = {
        'ae_network_type': 'strides_only', 'ae_padding_type': 'same',
        'ae_batch_norm': 0, 'symmetric_arch': 1,
        'ae_encoding_n_channels': [8, 16], 'ae_encoding_kernel_size': [5, 5],
        'ae_encoding_stride_size': [2, 2], 'ae_encoding_layer_type': ['conv', 'conv'],
        'ae_decoding_last_FF_layer': 0, 'ae_input_dim': [1, 16, 12], 'n_ae_latents': 3,
    }
    small = jarch.get_handcrafted_dims(small, symmetric=True)
    return dict(small, model_class='ae', model_type='conv', n_ae_latents=3,
                n_input_channels=1, y_pixels=16, x_pixels=12, learning_rate=1e-3,
                l2_reg=1e-4, rng_seed_model=0, rng_seed_train=0,
                max_n_epochs=max_n_epochs, min_n_epochs=1, val_check_interval=1,
                enable_early_stop=False, early_stop_history=10, export_latents=False,
                expt_dir=expt_dir, rng_seed_data=0, device='cpu', **kw)


def _generator(cls, data_dir, path):
    np.random.seed(0)
    return cls(data_dir, [IDS], signals_list=[['images']], transforms_list=[[None]],
               paths_list=[[path]], rng_seed=0,
               trial_splits={'train_tr': 8, 'val_tr': 1, 'test_tr': 1, 'gap_tr': 0})


def _rows(expt_dir):
    with open(os.path.join(expt_dir, 'version_0', 'metrics.csv')) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp('data'))
    return data_dir, _write_store(data_dir)


@pytest.fixture(scope='module')
def jax_run(store, tmp_path_factory):
    data_dir, path = store
    expt = str(tmp_path_factory.mktemp('jax'))
    hp = _hparams(os.path.join(expt, 'x'), 2)
    exp = JaxExperiment('x', expt)
    model = JaxAE(hp)
    init = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))
    jax_fit(hp, model, _generator(JaxGenerator, data_dir, path), exp, method='ae')
    return hp['expt_dir'], init


def _port_fit(store, expt, init, max_n_epochs, **kw):
    data_dir, path = store
    hp = _hparams(os.path.join(expt, 'x'), max_n_epochs, **kw)
    exp = Experiment('x', expt, version=0 if kw.get('resume_version') is not None else None)
    best = fit(hp, AE(hp), _generator(ConcatSessionsGenerator, data_dir, path), exp,
               method='ae', warm_start=lambda params: init)
    return hp['expt_dir'], best


def test_fit_matches_jax_fit(store, jax_run, tmp_path):
    jax_dir, init = jax_run
    port_dir, best = _port_fit(store, str(tmp_path), init, 2)
    jrows, prows = _rows(jax_dir), _rows(port_dir)
    assert len(jrows) == len(prows) == 3 * 2 + 1   # epochs 0-2: tr + val; 1 test trial
    for jr, pr in zip(jrows, prows):
        for key in ('epoch', 'trial', 'dataset', 'best_val_epoch'):
            assert jr.get(key) == pr.get(key), key
        for key in ('tr_loss', 'val_loss', 'test_loss'):
            if jr.get(key):
                np.testing.assert_allclose(float(pr[key]), float(jr[key]), rtol=1e-4,
                                           err_msg='%s epoch %s' % (key, jr['epoch']))
    assert float(prows[4]['tr_loss']) < float(prows[0]['tr_loss'])  # it trained
    jp, _ = jbase.load_params(os.path.join(jax_dir, 'version_0', 'best_val_model.pt'))
    pp, extra = load_params(os.path.join(port_dir, 'version_0', 'best_val_model.pt'))
    assert extra == {'model_class': 'ae'}
    for group in jp:
        for layer in jp[group]:
            for leaf in jp[group][layer]:
                np.testing.assert_allclose(pp[group][layer][leaf],
                                           np.asarray(jp[group][layer][leaf]), atol=1e-5,
                                           err_msg='%s/%s/%s' % (group, layer, leaf))
                np.testing.assert_array_equal(best[group][layer][leaf],
                                              pp[group][layer][leaf])


def test_resumed_fit_matches_uninterrupted(store, jax_run, tmp_path):
    _, init = jax_run
    straight, _ = _port_fit(store, str(tmp_path / 'a'), init, 3)
    stopped, _ = _port_fit(store, str(tmp_path / 'b'), init, 1)
    assert os.path.exists(os.path.join(stopped, 'version_0', 'last_checkpoint.pkl'))
    resumed, _ = _port_fit(store, str(tmp_path / 'b'), init, 3, resume_version=0)
    a, _ = load_params(os.path.join(straight, 'version_0', 'best_val_model.pt'))
    b, _ = load_params(os.path.join(resumed, 'version_0', 'best_val_model.pt'))
    for group in a:
        for layer in a[group]:
            for leaf in a[group][layer]:
                np.testing.assert_array_equal(a[group][layer][leaf], b[group][layer][leaf])
    assert [r['tr_loss'] for r in _rows(straight) if r.get('tr_loss')] == \
        [r['tr_loss'] for r in _rows(resumed) if r.get('tr_loss')]


@pytest.mark.parametrize('key,value', [
    ('steps_per_dispatch', 2), ('prefetch_workers', 2), ('tp_devices', 2),
    ('dp_sharding', True), ('profile_dir', '/x')])
def test_unported_fit_options_raise(key, value, store, tmp_path):
    hp = _hparams(str(tmp_path), 1, **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        fit(hp, AE(hp), None, None)


def test_fit_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    hp = _hparams(str(tmp_path), 1)
    hp.pop('device')
    with pytest.raises(RuntimeError, match='CUDA'):
        fit(hp, AE(hp), None, None)
    with pytest.raises(ValueError, match='cuda'):
        fit(dict(hp, device='tpu'), AE(hp), None, None)


def _write_configs(tmp, data_dir, save_dir, device='cpu'):
    configs = {
        'data': {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's',
                 'sessions_csv': '', 'all_source': 'data', 'n_input_channels': 1,
                 'y_pixels': 16, 'x_pixels': 12, 'use_output_mask': False,
                 'approx_batch_size': 200, 'data_dir': data_dir, 'save_dir': save_dir},
        'model': {'experiment_name': 'port', 'model_type': 'conv', 'n_ae_latents': 3,
                  'l2_reg': 0.0, 'rng_seed_model': 0, 'fit_sess_io_layers': False,
                  'ae_arch_json': None, 'model_class': 'ae'},
        'training': {'export_train_plots': False, 'export_latents': True,
                     'pretrained_weights_path': None, 'val_check_interval': 1,
                     'learning_rate': 1e-3, 'max_n_epochs': 1, 'min_n_epochs': 1,
                     'enable_early_stop': False, 'early_stop_history': 10,
                     'rng_seed_train': 0, 'batch_load': True, 'rng_seed_data': 0,
                     'train_frac': 1.0, 'trial_splits': '8;1;1;0'},
        'compute': {'device': device, 'tt_n_cpu_workers': 1},
    }
    args = []
    for name, cfg in configs.items():
        p = os.path.join(tmp, '%s.json' % name)
        with open(p, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, p]
    return args


def test_ae_grid_search_writes_a_version_both_packages_load(store, tmp_path):
    data_dir, _ = store
    save_dir = str(tmp_path / 'save')
    args = _write_configs(str(tmp_path), data_dir, save_dir)
    hyperparams.run_grid_search(ae_grid_search.main, hyperparams.get_all_params(args=args))
    vdir = os.path.join(save_dir, 'l', 'e', 'a', 's', 'ae', 'conv', '03_latents', 'port',
                        'version_0')
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        hp = pickle.load(f)
    assert hp['training_completed'] is True
    with open(os.path.join(vdir, 'l_e_a_s_latents.pkl'), 'rb') as f:
        latents = pickle.load(f)
    assert sum(len(z) for z in latents['latents']) == 10 * 20  # 10 split trials

    frames = np.random.RandomState(1).randint(0, 256, (4, 16, 12, 1)).astype(np.uint8)
    params, _ = jbase.load_params(os.path.join(vdir, 'best_val_model.pt'))
    ref_y, ref_z = JaxAE(hp).forward(params, frames.astype(np.float32) / 255.0)
    bundle = serving.load_version(vdir, device='cpu')
    np.testing.assert_allclose(bundle.encode(frames).numpy(), np.asarray(ref_z), atol=1e-5)
    np.testing.assert_allclose(bundle.reconstruct(frames).numpy(), np.asarray(ref_y),
                               atol=1e-5)

    # a second run of the same grid point finds the completed version
    hyperparams.run_grid_search(ae_grid_search.main, hyperparams.get_all_params(args=args))
    assert sorted(os.listdir(os.path.dirname(vdir))) == ['version_0']


def test_ae_grid_search_refuses_tpu_and_unported_classes(store, tmp_path):
    data_dir, _ = store
    args = _write_configs(str(tmp_path), data_dir, str(tmp_path / 'save'), device='tpu')
    grid = hyperparams.get_all_params(args=args)
    with pytest.raises(ValueError, match='cuda'):
        hyperparams.run_grid_search(ae_grid_search.main, grid)
    trial = dict(next(grid.trials()), device='cpu', model_class='vae')
    with pytest.raises(NotImplementedError, match='vae'):
        ae_grid_search.main(trial)
