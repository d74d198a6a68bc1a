"""The port's VAE, beta-TC-VAE and PS-VAE against the JAX package's.

The models' losses, metrics and parameter gradients are held against JAX's
with the same weights (carried by utils/weights.py) and the same eps: JAX's
and torch's generators differ, so both ``reparameterize``s are patched to
one numpy draw per shape. Tolerances (float32, other summation orders):
metrics rtol 1e-5, gradients within 1e-5 of each tensor's largest entry, a
PS-VAE ``fit``'s per-epoch losses rtol 1e-4 against the JAX ``fit`` on a
tiny HDF5 store with a ``labels`` group (1x16x12 frames, 20-frame trials
padded to 32, two conv layers), served answers atol 1e-5.

The weights are the JAX init's tree (``jax.eval_shape``, which compiles
nothing) drawn with numpy at the init's scale, with the PS-VAE's fixed
A and B maps the init's own: the eager JAX init compiles some 25
random-number programs (~9 s on the CPU) for numbers whose distribution no
parity test here reads.
"""

import csv
import json
import os
import pickle

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.data.generator import ConcatSessionsGenerator as JaxGenerator
from behavenet_tpu.fitting import training as jax_training
from behavenet_tpu.fitting.experiment import Experiment as JaxExperiment
from behavenet_tpu.fitting.training import fit as jax_fit
from behavenet_tpu.models import arch as jarch
from behavenet_tpu.models import base as jbase
from behavenet_tpu.models import vaes as jvaes
from behavenet_tpu.utils.torch_import import params_to_torch_state_dict
from behavenet_tpu_torch import serving
from behavenet_tpu_torch.data.generator import ConcatSessionsGenerator
from behavenet_tpu_torch.fitting import ae_grid_search, hyperparams
from behavenet_tpu_torch.fitting.experiment import Experiment
from behavenet_tpu_torch.fitting.training import fit
from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.models import vaes
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params
from tests.jax_low import LowOptJax, jit_low

IDS = {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's'}
N_LATENTS, N_LABELS = 4, 2
# each class's own hparams (ps-vae: the published alpha, beta, anneal epochs)
CLASSES = {
    'vae': {'vae.beta': 2.0},
    'beta-tcvae': {'beta_tcvae.beta': 5.0, 'beta_tcvae.beta_anneal_epochs': 3},
    'ps-vae': {'ps_vae.alpha': 1000.0, 'ps_vae.beta': 5.0, 'ps_vae.anneal_epochs': 100,
               'n_labels': N_LABELS},
}
JAX_MODELS = {'vae': jvaes.VAE, 'beta-tcvae': jvaes.BetaTCVAE, 'ps-vae': jvaes.PSVAE}
PORT_MODELS = {'vae': vaes.VAE, 'beta-tcvae': vaes.BetaTCVAE, 'ps-vae': vaes.PSVAE}


def _hparams(mc, expt_dir=None, max_n_epochs=4, **kw):
    small = {
        'ae_network_type': 'strides_only', 'ae_padding_type': 'same',
        'ae_batch_norm': 0, 'symmetric_arch': 1,
        'ae_encoding_n_channels': [8, 16], 'ae_encoding_kernel_size': [5, 5],
        'ae_encoding_stride_size': [2, 2], 'ae_encoding_layer_type': ['conv', 'conv'],
        'ae_decoding_last_FF_layer': 0, 'ae_input_dim': [1, 16, 12],
        'n_ae_latents': N_LATENTS,
    }
    small = jarch.get_handcrafted_dims(small, symmetric=True)
    return dict(small, model_class=mc, model_type='conv', n_ae_latents=N_LATENTS,
                n_input_channels=1, y_pixels=16, x_pixels=12, learning_rate=1e-3,
                l2_reg=1e-4, rng_seed_model=0, rng_seed_train=0,
                max_n_epochs=max_n_epochs, min_n_epochs=1, val_check_interval=1,
                enable_early_stop=False, early_stop_history=10, export_latents=False,
                expt_dir=expt_dir, rng_seed_data=0, device='cpu', **dict(CLASSES[mc], **kw))


def _fan_in(shape):
    """HWIO kernels: kh * kw * Cin; dense (in, out): in; biases: 400."""
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 400


def _fixed_maps(jmodel, key):
    """The PS-VAE init's A and B (numpy-made orthogonal maps): compiled
    alone, every random draw of the init is dead code."""
    return jax.tree_util.tree_map(np.asarray, jit_low(
        lambda k: {n: jmodel.init(k)['encoder'][n] for n in ('A', 'B')}, key))


def _numpy_init(jmodel, seed=0):
    """Params of the JAX init's tree, drawn with numpy at its scale; a
    PS-VAE's A and B are the init's own."""
    rs = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    params = jax.tree_util.tree_map(
        lambda a: rs.uniform(-1, 1, a.shape).astype(np.float32) / _fan_in(a.shape) ** 0.5,
        jax.eval_shape(jmodel.init, key))
    if 'A' in params['encoder']:
        params['encoder'].update(_fixed_maps(jmodel, key))
    return params


def _pair(mc, seed=0, **kw):
    hp = _hparams(mc, **kw)
    jmodel = JAX_MODELS[mc](hp)
    params = _numpy_init(jmodel, seed)
    model = PORT_MODELS[mc](hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return hp, jmodel, params, model


def _eps(shape):
    """The one eps of a shape, for both packages."""
    return np.random.RandomState(shape[0] * 100 + shape[1]).randn(*shape).astype(np.float32)


def _jax_reparameterize(key, mu, logvar):
    return jnp.asarray(_eps(mu.shape)) * jnp.exp(logvar) + mu


def _port_reparameterize(mu, logvar, generator=None):
    return torch.from_numpy(_eps(tuple(mu.shape))) * torch.exp(logvar) + mu


@pytest.fixture
def fixed_eps(monkeypatch):
    monkeypatch.setattr(jvaes, 'reparameterize', _jax_reparameterize)
    monkeypatch.setattr(vaes, 'reparameterize', _port_reparameterize)


def _batch(mc, n=10, n_valid=8, seed=1):
    rs = np.random.RandomState(seed)
    batch = {'images': rs.randint(0, 256, (n, 16, 12, 1)).astype(np.uint8),
             'frame_mask': (np.arange(n) < n_valid).astype(np.float32)}
    if mc == 'ps-vae':
        batch['labels'] = rs.randn(n, N_LABELS).astype(np.float32)
        batch['labels_masks'] = (rs.rand(n, N_LABELS) > 0.2).astype(np.float32)
    return batch


@pytest.mark.parametrize('mc', list(CLASSES))
def test_loss_metrics_and_grads_match_jax(mc, fixed_eps):
    hp, jmodel, params, model = _pair(mc)
    batch = _batch(mc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch['images'] = jbatch['images'].astype(jnp.float32) / 255.0
    epoch = 2   # inside every anneal
    jkw, kw = jmodel.loss_kwargs(epoch), model.loss_kwargs(epoch)
    assert {k: float(v) for k, v in jkw.items()} == kw
    (_, jmetrics), jgrads = jit_low(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jbatch, jax.random.PRNGKey(0), **jkw),
        has_aux=True), params)

    loss, metrics = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss.backward()
    assert sorted(metrics) == sorted(jmodel.metrics_keys) == sorted(model.metrics_keys)
    for key in jmodel.metrics_keys:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    ref = params_to_state_dict(model, jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize('mc,kw', [
    ('vae', {'vae.beta_anneal_epochs': 3}), ('vae', {}),
    ('beta-tcvae', {}), ('ps-vae', {'ps_vae.anneal_epochs': 3})],
    ids=['vae_anneal', 'vae', 'beta-tcvae', 'ps-vae_anneal'])
def test_loss_schedules_match_jax(mc, kw):
    """Per-epoch loss weights, the VAE's jump to 1.0 after its anneal
    included (JAX vaes.py:79-87)."""
    hp = _hparams(mc, max_n_epochs=6, **kw)
    jmodel, model = JAX_MODELS[mc](hp), PORT_MODELS[mc](hp)
    for epoch in range(7):
        assert {k: float(v) for k, v in jmodel.loss_kwargs(epoch).items()} == \
            model.loss_kwargs(epoch), epoch


def test_psvae_heads_equal_jax_bits_and_get_no_update():
    for seed in (0, 5):
        hp = dict(_hparams('ps-vae'), rng_seed_model=seed)
        jp = _fixed_maps(JAX_MODELS['ps-vae'](hp), jax.random.PRNGKey(0))
        sd = PORT_MODELS['ps-vae'](hp).state_dict()
        np.testing.assert_array_equal(sd['encoding.A.weight'].numpy().T, np.asarray(jp['A']))
        np.testing.assert_array_equal(sd['encoding.B.weight'].numpy().T, np.asarray(jp['B']))
    model = PORT_MODELS['ps-vae'](hp)
    names = {n for n, _ in model.named_parameters()}
    assert 'encoding.D.weight' in names and 'encoding.logvar.weight' in names
    assert not names & {'encoding.A.weight', 'encoding.B.weight'}
    assert len(names) == 2 * 4 + 2 * 4   # 4 conv / FF layers, logvar, D


@pytest.mark.parametrize('mc', list(CLASSES))
def test_weights_round_trip(mc):
    """The port's state dict is the reference's export key for key, and
    ``state_dict_to_params`` gives the JAX params back bit for bit."""
    hp, jmodel, params, model = _pair(mc, seed=3)
    ref = params_to_torch_state_dict(jmodel, params)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    back = state_dict_to_params(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_reparameterize_draws_with_std_exp_logvar():
    mu, lv = torch.randn(6, 3), torch.randn(6, 3)
    z = vaes.reparameterize(mu, lv, torch.Generator().manual_seed(4))
    eps = torch.randn((6, 3), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(z, eps * torch.exp(lv) + mu)


# ------------------------------------------------------------------ fit


def _write_store(data_dir, n_trials=12, frames=20, seed=0):
    path = os.path.join(data_dir, 'l', 'e', 'a', 's', 'data.hdf5')
    os.makedirs(os.path.dirname(path))
    rng = np.random.RandomState(seed)
    with h5py.File(path, 'w', libver='latest') as f:
        gi, gl = f.create_group('images'), f.create_group('labels')
        for i in range(n_trials):
            gi.create_dataset('trial_%04i' % i, dtype='uint8',
                              data=rng.randint(0, 255, (frames, 1, 16, 12)))
            gl.create_dataset('trial_%04i' % i, dtype='float32',
                              data=rng.randn(frames, N_LABELS).astype(np.float32))
    return path


def _generator(cls, data_dir, path):
    np.random.seed(0)
    return cls(data_dir, [IDS], signals_list=[['images', 'labels']],
               transforms_list=[[None, None]], paths_list=[[path, path]], rng_seed=0,
               trial_splits={'train_tr': 8, 'val_tr': 1, 'test_tr': 1, 'gap_tr': 0})


def _rows(expt_dir):
    with open(os.path.join(expt_dir, 'version_0', 'metrics.csv')) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp('data'))
    return data_dir, _write_store(data_dir)


PS_FIT = {'ps_vae.alpha': 10.0, 'ps_vae.anneal_epochs': 2}


@pytest.fixture(scope='module')
def jax_psvae_run(store, tmp_path_factory):
    data_dir, path = store
    expt = str(tmp_path_factory.mktemp('jax'))
    hp = dict(_hparams('ps-vae', os.path.join(expt, 'x'), 2), **PS_FIT)
    model = JAX_MODELS['ps-vae'](hp)
    init = _numpy_init(model)
    model.init = lambda key: jax.tree_util.tree_map(jnp.asarray, init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvaes, 'reparameterize', _jax_reparameterize)
        mp.setattr(jax_training, 'jax', LowOptJax())   # its steps compiled at level 0
        jax_fit(hp, model, _generator(JaxGenerator, data_dir, path),
                JaxExperiment('x', expt), method='ae')
    return hp['expt_dir'], init


def _port_fit(store, expt, init, max_n_epochs, **kw):
    data_dir, path = store
    hp = dict(_hparams('ps-vae', os.path.join(expt, 'x'), max_n_epochs, **kw), **PS_FIT)
    exp = Experiment('x', expt, version=0 if kw.get('resume_version') is not None else None)
    best = fit(hp, PORT_MODELS['ps-vae'](hp),
               _generator(ConcatSessionsGenerator, data_dir, path), exp,
               method='ae', warm_start=lambda params: init)
    return hp['expt_dir'], best


def test_psvae_fit_matches_jax_fit(store, jax_psvae_run, tmp_path, fixed_eps):
    jax_dir, init = jax_psvae_run
    port_dir, _ = _port_fit(store, str(tmp_path), init, 2)
    jrows, prows = _rows(jax_dir), _rows(port_dir)
    assert len(jrows) == len(prows) == 3 * 2 + 1   # epochs 0-2: tr + val; 1 test trial
    for jr, pr in zip(jrows, prows):
        assert sorted(k for k, v in jr.items() if v) == sorted(k for k, v in pr.items() if v)
        for key in ('epoch', 'trial', 'dataset', 'best_val_epoch'):
            assert jr.get(key) == pr.get(key), key
        for key, v in jr.items():
            if v and key.split('_')[0] in ('tr', 'val', 'test'):
                np.testing.assert_allclose(float(pr[key]), float(v), rtol=1e-4, atol=1e-6,
                                           err_msg='%s epoch %s' % (key, jr['epoch']))
    assert float(prows[4]['tr_loss']) < float(prows[0]['tr_loss'])  # it trained


def test_psvae_resumed_fit_draws_the_same_eps(store, jax_psvae_run, tmp_path):
    """With the trainer's own eps generator, a fit stopped after epoch 1 and
    resumed ends where the uninterrupted fit ends."""
    _, init = jax_psvae_run
    straight, _ = _port_fit(store, str(tmp_path / 'a'), init, 2)
    stopped, _ = _port_fit(store, str(tmp_path / 'b'), init, 1)
    resumed, _ = _port_fit(store, str(tmp_path / 'b'), init, 2, resume_version=0)
    assert [r['tr_loss'] for r in _rows(straight) if r.get('tr_loss')] == \
        [r['tr_loss'] for r in _rows(resumed) if r.get('tr_loss')]
    a, _ = base.load_params(os.path.join(straight, 'version_0', 'best_val_model.pt'))
    b, _ = base.load_params(os.path.join(resumed, 'version_0', 'best_val_model.pt'))
    for (pa, la), (_, lb) in zip(jax.tree_util.tree_leaves_with_path(a),
                                 jax.tree_util.tree_leaves_with_path(b)):
        np.testing.assert_array_equal(la, lb, err_msg=str(pa))


def _write_configs(tmp, data_dir, save_dir, mc):
    model = {'experiment_name': 'port', 'model_type': 'conv', 'n_ae_latents': N_LATENTS,
             'l2_reg': 0.0, 'rng_seed_model': 0, 'fit_sess_io_layers': False,
             'ae_arch_json': None, 'model_class': mc}
    model.update({k: v for k, v in CLASSES[mc].items() if k != 'n_labels'})
    configs = {
        'data': {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's',
                 'sessions_csv': '', 'all_source': 'data', 'n_input_channels': 1,
                 'y_pixels': 16, 'x_pixels': 12, 'use_output_mask': False,
                 'use_label_mask': False, 'approx_batch_size': 200,
                 'data_dir': data_dir, 'save_dir': save_dir},
        'model': model,
        'training': {'export_train_plots': False, 'export_latents': True,
                     'pretrained_weights_path': None, 'val_check_interval': 1,
                     'learning_rate': 1e-3, 'max_n_epochs': 1, 'min_n_epochs': 1,
                     'enable_early_stop': False, 'early_stop_history': 10,
                     'rng_seed_train': 0, 'batch_load': True, 'rng_seed_data': 0,
                     'train_frac': 1.0, 'trial_splits': '8;1;1;0'},
        'compute': {'device': 'cpu', 'tt_n_cpu_workers': 1},
    }
    args = []
    for name, cfg in configs.items():
        p = os.path.join(tmp, '%s.json' % name)
        with open(p, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, p]
    return args


@pytest.mark.parametrize('mc', list(CLASSES))
def test_grid_search_version_serves_and_loads_in_jax(mc, store, tmp_path):
    """The port's CLI fits the class on the CPU; its version serves through
    ``load_version`` and loads in the JAX package, which gives the same
    posterior-mean answers."""
    data_dir, _ = store
    save_dir = str(tmp_path / 'save')
    args = _write_configs(str(tmp_path), data_dir, save_dir, mc)
    hyperparams.run_grid_search(ae_grid_search.main, hyperparams.get_all_params(args=args))
    vdir = os.path.join(save_dir, 'l', 'e', 'a', 's', mc, 'conv',
                        '%02i_latents' % N_LATENTS, 'port', 'version_0')
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        hp = pickle.load(f)
    assert hp['training_completed'] is True
    assert hp.get('n_labels') == (N_LABELS if mc == 'ps-vae' else None)
    with open(os.path.join(vdir, 'l_e_a_s_latents.pkl'), 'rb') as f:
        latents = pickle.load(f)['latents']
    assert sum(len(z) for z in latents) == 10 * 20 and latents[0].shape[1] == N_LATENTS

    frames = np.random.RandomState(1).randint(0, 256, (4, 16, 12, 1)).astype(np.uint8)
    params, extra = jbase.load_params(os.path.join(vdir, 'best_val_model.pt'))
    assert extra == {'model_class': mc}
    out = jit_low(lambda p, x, key: JAX_MODELS[mc](hp).forward(p, x, rng=key, use_mean=True),
                  params, frames.astype(np.float32) / 255.0, jax.random.PRNGKey(0))
    bundle = serving.load_version(vdir, device='cpu')
    np.testing.assert_allclose(bundle.encode(frames).numpy(), np.asarray(out[2]), atol=1e-5)
    np.testing.assert_allclose(bundle.reconstruct(frames).numpy(), np.asarray(out[0]),
                               atol=1e-5)
