"""The port's max-pooling and batch-norm conv archs against the JAX package's:
the arch's dims, forwards in train and eval mode, losses and gradients (AE
and PS-VAE), the running statistics, the padded-batch trap, the state dict
key for key, a ``fit`` on a tiny store, and the CLI with an
``ae_arch_json``.

The small arch is the reference generator's ``max_pooling`` type (conv ->
batch norm -> 2x2 max pool -> leaky ReLU, twice) on odd 14 x 11 frames, so
'same' padding pools in ceil mode. Weights are drawn with numpy on the JAX
init's tree (``jax.eval_shape``); batch norm's gamma, beta and running
statistics at values away from their init. Tolerances (float32, other
summation orders): latents, reconstructions, losses and running statistics
atol / rtol 1e-5; gradients within 1e-5 of the layer's largest JAX gradient
(a conv bias before batch norm has an exact gradient of 0 in train mode, so
its own largest value is rounding noise); ``fit``'s per-epoch losses rtol
1e-4 and its running statistics atol 1e-5 (conv biases are not compared:
under batch norm their gradient is noise that AMSGrad scales to the step
size, docs/tpu_design.md:258-264). JAX's references compile at level 0
(``tests/jax_low.py``), but for the JAX ``fit``: compiled at level 0, its
AMSGrad step on this batch-norm arch turns parameters to NaN in the
first train step (a level-0 fault; at the default level its losses are
finite and the port's match them), so its steps compile at the default
level.
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
from behavenet_tpu.fitting.experiment import Experiment as JaxExperiment
from behavenet_tpu.fitting.training import fit as jax_fit
from behavenet_tpu.models import AE as JaxAE
from behavenet_tpu.models import arch as jarch
from behavenet_tpu.models import base as jbase
from behavenet_tpu.models import vaes as jvaes
from behavenet_tpu.utils.torch_import import params_to_torch_state_dict
from behavenet_tpu_torch import serving
from behavenet_tpu_torch.data.generator import ConcatSessionsGenerator
from behavenet_tpu_torch.fitting import ae_grid_search, hyperparams
from behavenet_tpu_torch.fitting.experiment import Experiment
from behavenet_tpu_torch.fitting.training import fit
from behavenet_tpu_torch.models import arch, vaes
from behavenet_tpu_torch.models.aes import AE
from behavenet_tpu_torch.models.base import load_params
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params
from tests.jax_low import jit_low

IMG = (2, 14, 11)
N_LATENTS, N_LABELS = 4, 2
JAX_MODELS = {'ae': JaxAE, 'ps-vae': jvaes.PSVAE}
PORT_MODELS = {'ae': AE, 'ps-vae': vaes.PSVAE}
# the AE with the shipped cumulative momentum (None), the PS-VAE with the
# default 0.1 (JAX models/aes.py:136)
CLASS_KW = {'ae': {'ae_batch_norm_momentum': None},
            'ps-vae': {'n_labels': N_LABELS, 'ps_vae.alpha': 1000.0, 'ps_vae.beta': 5.0,
                       'ps_vae.anneal_epochs': 100}}
CASES = ['ae-train', 'ae-eval', 'ps-vae-train', 'ps-vae-eval']
BN_LEAVES = ('gamma', 'beta', 'running_mean', 'running_var', 'num_batches')


def _arch(img=IMG, channels=(4, 4, 8, 8)):
    a = {'ae_network_type': 'max_pooling', 'ae_padding_type': 'same', 'ae_batch_norm': 1,
         'symmetric_arch': 1, 'ae_encoding_n_channels': list(channels),
         'ae_encoding_kernel_size': [3, 2, 3, 2], 'ae_encoding_stride_size': [1, 2, 1, 2],
         'ae_encoding_layer_type': ['conv', 'maxpool', 'conv', 'maxpool'],
         'ae_decoding_last_FF_layer': 0, 'ae_input_dim': list(img),
         'n_ae_latents': N_LATENTS}
    return jarch.get_handcrafted_dims(a, symmetric=True)


def _hparams(mc='ae', img=IMG, **kw):
    return dict(_arch(img), model_class=mc, model_type='conv', n_ae_latents=N_LATENTS,
                n_input_channels=img[0], y_pixels=img[1], x_pixels=img[2],
                rng_seed_model=0, **dict(CLASS_KW[mc], **kw))


def _fan_in(shape):
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 400


def _numpy_params(jmodel, seed=0):
    """Params of the JAX init's tree drawn with numpy: weights at the init's
    scale, batch norm's leaves away from their init (gamma near 1, running
    variances in [0.5, 1.5], 3 batches seen); a PS-VAE's fixed maps A and B
    from its init."""
    rs = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)

    def draw(path, a):
        name = path[-1].key
        if name == 'gamma':
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ('beta', 'running_mean'):
            return (0.1 * rs.randn(*a.shape)).astype(np.float32)
        if name == 'running_var':
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == 'num_batches':
            return np.float32(3.0)
        return (rs.uniform(-1, 1, a.shape) / _fan_in(a.shape) ** 0.5).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(jmodel.init, key))
    if 'A' in params['encoder']:
        params['encoder'].update(jax.tree_util.tree_map(np.asarray, jit_low(
            lambda k: {n: jmodel.init(k)['encoder'][n] for n in ('A', 'B')}, key)))
    return params


def _pair(mc, **kw):
    hp = _hparams(mc, **kw)
    jmodel = JAX_MODELS[mc](hp)
    params = _numpy_params(jmodel)
    model = PORT_MODELS[mc](hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return hp, jmodel, params, model


def _batch(mc, n=8, n_valid=8, seed=1):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n,) + IMG[1:] + IMG[:1]).astype(np.uint8)
    images[n_valid:] = 0
    batch = {'images': images, 'frame_mask': (np.arange(n) < n_valid).astype(np.float32)}
    if mc == 'ps-vae':
        batch['labels'] = rs.randn(n, N_LABELS).astype(np.float32)
    return batch


def _eps(shape):
    return np.random.RandomState(shape[0] * 100 + shape[1]).randn(*shape).astype(np.float32)


@pytest.fixture
def fixed_eps(monkeypatch):
    """The one eps of a shape for both packages (their generators differ)."""
    monkeypatch.setattr(jvaes, 'reparameterize',
                        lambda key, mu, logvar: jnp.asarray(_eps(mu.shape)) * jnp.exp(logvar)
                        + mu)
    monkeypatch.setattr(vaes, 'reparameterize',
                        lambda mu, logvar, generator=None:
                        torch.from_numpy(_eps(tuple(mu.shape))) * torch.exp(logvar) + mu)


def _jax_case(jmodel, params, batch, kw, train):
    jbatch = dict(batch, images=batch['images'].astype(jnp.float32) / 255.0)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jbatch, jax.random.PRNGKey(0), train=train, **kw),
        has_aux=True)(params)
    out = jmodel.forward(params, jbatch['images'], use_mean=True, train=train)
    return {'loss': loss, 'state': metrics.get('_state', {}), 'grads': grads,
            'recon': out[0], 'latents': out[2] if len(out) > 2 else out[1]}


@pytest.fixture(scope='module')
def jax_cases():
    """case -> (port model, batch, loss kwargs, JAX loss, new running
    statistics, gradients, reconstruction, latents), JAX's from one
    program; the ps-vae's eps patched to the same numpy draw."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvaes, 'reparameterize',
                   lambda key, mu, logvar: jnp.asarray(_eps(mu.shape)) * jnp.exp(logvar) + mu)
        pairs, args = {}, {}
        for case in CASES:
            mc, mode = case.rsplit('-', 1)
            hp, jmodel, params, model = _pair(mc)
            kw = {k: float(v) for k, v in jmodel.loss_kwargs(2).items()} \
                if hasattr(jmodel, 'loss_kwargs') else {}
            batch = _batch(mc)
            pairs[case] = (jmodel, model, batch, kw, mode == 'train')
            args[case] = (params, batch, kw)
        refs = jit_low(lambda a: {c: _jax_case(pairs[c][0], *a[c], train=pairs[c][4])
                                  for c in a}, args)
    return {c: pairs[c][1:4] + (jax.tree_util.tree_map(np.asarray, refs[c]),) for c in CASES}


def test_recast_default_arch_dims_match_jax():
    """The published default arch recast as a max_pooling arch, at 2-view
    128 x 128: the port's dims and paddings equal JAX's; encoder 128 -> 64
    -> 32 -> 16 -> 8 -> 4, decoder starting at (512, 4, 4), mirrored as
    unpool, conv-transpose pairs."""
    def recast(module):
        a = {'ae_network_type': 'max_pooling', 'ae_padding_type': 'same',
             'ae_batch_norm': 1, 'ae_batch_norm_momentum': None, 'symmetric_arch': 1,
             'ae_encoding_n_channels': [32, 32, 64, 64, 128, 128, 256, 256, 512, 512],
             'ae_encoding_kernel_size': [5, 2] * 5, 'ae_encoding_stride_size': [1, 2] * 5,
             'ae_encoding_layer_type': ['conv', 'maxpool'] * 5,
             'ae_decoding_last_FF_layer': 0, 'ae_input_dim': [2, 128, 128],
             'n_ae_latents': 12}
        return module.get_handcrafted_dims(a, symmetric=True)
    port, ref = recast(arch), recast(jarch)
    assert port == ref
    assert port['ae_encoding_y_dim'][1::2] == [64, 32, 16, 8, 4]
    assert port['ae_decoding_starting_dim'] == [512, 4, 4]
    assert port['ae_decoding_layer_type'] == ['unpool', 'convtranspose'] * 5
    hp = dict(port, model_class='ae', model_type='conv', n_input_channels=2, y_pixels=128,
              x_pixels=128)
    model = AE(hp)
    assert list(model.decoding.decoder)[:3] == ['unpool0', 'convtranspose0', 'batchnorm0']
    shapes = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(JaxAE(hp).init, jax.random.PRNGKey(0)))[0]
    n_jax = sum(int(np.prod(a.shape)) for path, a in shapes
                if path[-1].key not in ('running_mean', 'running_var', 'num_batches'))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 8916430


@pytest.mark.parametrize('case', CASES)
def test_forward_matches_jax(case, jax_cases, fixed_eps):
    """Latents and reconstructions in train mode (batch statistics) and eval
    mode (the running statistics)."""
    model, batch, _, ref = jax_cases[case]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train(case.endswith('train'))
    with torch.no_grad():
        x = torch.from_numpy(batch['images'])
        np.testing.assert_allclose(model.latents(x).numpy(), ref['latents'], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(model.reconstruct(x).numpy(), ref['recon'], atol=1e-5,
                                   rtol=1e-5)
    model.load_state_dict(before)   # train-mode forwards moved the running statistics


@pytest.mark.parametrize('case', CASES)
def test_loss_grads_and_running_stats_match_jax(case, jax_cases, fixed_eps):
    """The loss and every gradient, in train mode (then also the running
    statistics the step leaves) and in eval mode (no update)."""
    model, batch, kw, ref = jax_cases[case]
    train = case.endswith('train')
    model.train(train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref['loss']), rtol=1e-5)
    want = params_to_state_dict(model, ref['grads'])
    named = dict(model.named_parameters())
    for name, p in named.items():
        layer = name.rsplit('.', 1)[0]
        scale = max(np.abs(want[k].numpy()).max() for k in named if k.rsplit('.', 1)[0] == layer)
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    after = state_dict_to_params(model)
    for group, layers in ref['state'].items():
        for layer, leaves in layers.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(after[group][layer][k], v, atol=1e-5, rtol=0,
                                           err_msg='%s/%s/%s' % (group, layer, k))
    if train:
        assert ref['state'] and after['encoder']['bn_0']['num_batches'] == 4.0
    else:
        assert not ref['state']
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    model.load_state_dict(before)


def test_padded_frames_enter_batch_statistics():
    """The JAX-side trap the port copies: batch norm takes no frame mask, so
    the zero frames that pad a 5-frame trial to 8 shift the batch
    statistics, the running statistics and the real frames' loss. The
    port's padded loss and statistics equal JAX's, and differ from the
    unpadded ones."""
    hp, jmodel, params, model = _pair('ae')
    padded, plain = _batch('ae', n=8, n_valid=5), _batch('ae', n=5, n_valid=5)

    def jax_loss(p, b):
        b = dict(b, images=b['images'].astype(jnp.float32) / 255.0)
        loss, metrics = jmodel.loss_fn(p, b, None, train=True)
        return loss, metrics['_state']['encoder']['bn_0']
    (jl, jstate) = jax.tree_util.tree_map(np.asarray, jit_low(jax_loss, params, padded))
    out = {}
    for name, b in (('padded', padded), ('plain', plain)):
        model.load_state_dict(params_to_state_dict(model, params))
        model.train()
        loss, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in b.items()})
        out[name] = (loss.item(), state_dict_to_params(model)['encoder']['bn_0'])
    np.testing.assert_allclose(out['padded'][0], float(jl), rtol=1e-5)
    for k in ('running_mean', 'running_var'):
        np.testing.assert_allclose(out['padded'][1][k], jstate[k], atol=1e-5, rtol=0)
        assert np.abs(out['padded'][1][k] - out['plain'][1][k]).max() > 1e-3
    assert abs(out['padded'][0] - out['plain'][0]) > 1e-4 * abs(out['plain'][0])


@pytest.mark.parametrize('track', [True, False], ids=['tracked', 'untracked'])
def test_state_dict_matches_reference_export(track):
    """Key for key and value for value the JAX exporter's state dict: convs,
    conv-transposes and batch norms numbered among their kind (``conv1`` is
    ``conv_2``), the running statistics and an int64 batch count when
    tracked. Untracked, eval mode uses the batch's statistics too."""
    hp, jmodel, params, model = _pair('ae', track_running_stats=track)
    ref = params_to_torch_state_dict(jmodel, params)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    assert ('encoding.encoder.batchnorm1.num_batches_tracked' in sd) == track
    assert 'encoding.encoder.conv1.weight' in sd and 'decoding.decoder.convtranspose1.weight' in sd
    for k, v in ref.items():
        assert sd[k].dtype == (torch.int64 if k.endswith('num_batches_tracked')
                               else torch.float32), k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    if not track:
        x = torch.from_numpy(_batch('ae')['images'])
        with torch.no_grad():
            y_train = model.train()(x)[0]
            y_eval = model.eval()(x)[0]
        assert torch.equal(y_train, y_eval)


# ---------------------------------------------------------------- fit

IDS = {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's'}
STORE_IMG = (1, 16, 12)


def _fit_hparams(expt_dir, max_n_epochs, **kw):
    return dict(_hparams('ae', STORE_IMG), learning_rate=1e-3, l2_reg=1e-4,
                rng_seed_train=0, max_n_epochs=max_n_epochs, min_n_epochs=1,
                val_check_interval=1, enable_early_stop=False, early_stop_history=10,
                export_latents=True, expt_dir=expt_dir, rng_seed_data=0, device='cpu',
                **kw)


def _generator(cls, data_dir, path):
    np.random.seed(0)
    return cls(data_dir, [IDS], signals_list=[['images']], transforms_list=[[None]],
               paths_list=[[path]], rng_seed=0,
               trial_splits={'train_tr': 8, 'val_tr': 1, 'test_tr': 1, 'gap_tr': 0})


def _rows(expt_dir):
    with open(os.path.join(expt_dir, 'version_0', 'metrics.csv')) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def bn_store(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp('data'))
    path = os.path.join(data_dir, 'l', 'e', 'a', 's', 'data.hdf5')
    os.makedirs(os.path.dirname(path))
    rng = np.random.RandomState(0)
    with h5py.File(path, 'w', libver='latest') as f:
        gi = f.create_group('images')
        for i in range(12):
            gi.create_dataset('trial_%04i' % i, dtype='uint8',
                              data=rng.randint(0, 255, (20,) + STORE_IMG))
    return data_dir, path


def test_fit_matches_jax_fit(bn_store, tmp_path):
    """Two epochs of ``fit`` from the same parameters (20-frame trials in
    the 32-frame bucket, so the padding enters the statistics): per-epoch
    losses, the best-val running statistics, and the exported latents
    (eval mode) against JAX's."""
    data_dir, path = bn_store
    jdir, pdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jhp = _fit_hparams(os.path.join(jdir, 'x'), 2)
    jmodel = JaxAE(jhp)
    init = _numpy_params(jmodel)
    jmodel.init = lambda key: jax.tree_util.tree_map(jnp.asarray, init)
    jax_fit(jhp, jmodel, _generator(JaxGenerator, data_dir, path), JaxExperiment('x', jdir),
            method='ae')
    php = _fit_hparams(os.path.join(pdir, 'x'), 2)
    fit(php, AE(php), _generator(ConcatSessionsGenerator, data_dir, path),
        Experiment('x', pdir), method='ae', warm_start=lambda params: init)

    jrows, prows = _rows(jhp['expt_dir']), _rows(php['expt_dir'])
    assert len(jrows) == len(prows)
    for jr, pr in zip(jrows, prows):
        for key in ('tr_loss', 'val_loss', 'test_loss'):
            if jr.get(key):
                np.testing.assert_allclose(float(pr[key]), float(jr[key]), rtol=1e-4,
                                           err_msg='%s epoch %s' % (key, jr['epoch']))
    jp, _ = jbase.load_params(os.path.join(jhp['expt_dir'], 'version_0', 'best_val_model.pt'))
    pp, _ = load_params(os.path.join(php['expt_dir'], 'version_0', 'best_val_model.pt'))
    for group in ('encoder', 'decoder'):
        for layer, leaves in jp[group].items():
            for k in BN_LEAVES:
                if k in leaves:
                    np.testing.assert_allclose(pp[group][layer][k], np.asarray(leaves[k]),
                                               atol=1e-5, rtol=0, err_msg='%s/%s' % (layer, k))
    latents = []
    for hp in (jhp, php):
        with open(os.path.join(hp['expt_dir'], 'version_0', 'l_e_a_s_latents.pkl'), 'rb') as f:
            latents.append(pickle.load(f)['latents'])
    for a, b in zip(*latents):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)


def test_ae_grid_search_fits_a_pooling_bn_arch_json(bn_store, tmp_path):
    """The port's CLI with an ``ae_arch_json`` of the small max-pooling +
    batch-norm arch (cumulative momentum) on the CPU: the version holds the
    batch norms' running statistics after its train epoch, and it serves
    (eval mode) as the JAX model's forward of the same checkpoint does
    (atol 1e-5)."""
    data_dir, _ = bn_store
    arch_json = str(tmp_path / 'arch.json')
    with open(arch_json, 'w') as f:
        arch_keys = {k: v for k, v in _arch(STORE_IMG).items()
                     if not k.startswith('ae_encoding_') or k in (
                         'ae_encoding_n_channels', 'ae_encoding_kernel_size',
                         'ae_encoding_stride_size', 'ae_encoding_layer_type')
                     if not k.startswith('ae_decoding_') or k == 'ae_decoding_last_FF_layer'}
        json.dump(dict(arch_keys, ae_batch_norm_momentum=None), f)
    save_dir = str(tmp_path / 'save')
    configs = {
        'data': {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's',
                 'sessions_csv': '', 'all_source': 'data', 'n_input_channels': 1,
                 'y_pixels': 16, 'x_pixels': 12, 'use_output_mask': False,
                 'approx_batch_size': 200, 'data_dir': data_dir, 'save_dir': save_dir},
        'model': {'experiment_name': 'port', 'model_type': 'conv',
                  'n_ae_latents': N_LATENTS, 'l2_reg': 0.0, 'rng_seed_model': 0,
                  'fit_sess_io_layers': False, 'ae_arch_json': arch_json,
                  'model_class': 'ae'},
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
        path = str(tmp_path / ('%s.json' % name))
        with open(path, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, path]
    hyperparams.run_grid_search(ae_grid_search.main, hyperparams.get_all_params(args=args))

    vdir = os.path.join(save_dir, 'l', 'e', 'a', 's', 'ae', 'conv', '%02i_latents' % N_LATENTS,
                        'port', 'version_0')
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        hp = pickle.load(f)
    assert hp['training_completed'] and hp['ae_batch_norm'] and hp['ae_batch_norm_momentum'] is None
    assert 'maxpool' in hp['ae_encoding_layer_type']
    with open(os.path.join(vdir, 'last_checkpoint.pkl'), 'rb') as f:
        trained = pickle.load(f)['model']
    assert int(trained['encoding.encoder.batchnorm0.num_batches_tracked']) == 8
    params, _ = jbase.load_params(os.path.join(vdir, 'best_val_model.pt'))
    assert set(params['encoder']['bn_0']) == set(BN_LEAVES)
    frames = np.random.RandomState(2).randint(0, 256, (5, 16, 12, 1)).astype(np.uint8)
    ref_y, ref_z = jax.tree_util.tree_map(np.asarray, jit_low(
        JaxAE(hp).forward, params, frames.astype(np.float32) / 255.0))
    bundle = serving.load_version(vdir, device='cpu')
    np.testing.assert_allclose(bundle.encode(frames).numpy(), ref_z, atol=1e-5)
    np.testing.assert_allclose(bundle.reconstruct(frames).numpy(), ref_y, atol=1e-5)
