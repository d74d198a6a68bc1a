"""The port's MSPS-VAE (multi-session PS-VAE) against the JAX package's.

- The cross-session triplet loss (``ops.losses.triplet_loss_plain``) against
  JAX's ``ops/losses.py:246 triplet_loss`` for 2, 3 and 4 sessions, equal and
  unequal segment lengths, with and without a row mask: JAX's permutations
  are recomputed from its key (``jax.random.split``, then
  ``jax.random.permutation``) and handed to the port. The loss within atol
  1e-6, its gradient within 1e-5 of max|JAX's| (float32, other summation
  orders); the written-out backward (``triplet_loss_grad_plain``) within 1e-6
  of max|autograd's| through the plain forward; the 2-session case within
  1e-6 of the upstream reference's ``t_triplet_2ds``.
- ``MSPSVAE.loss_fn``'s metrics (rtol 1e-5, atol 1e-6) and parameter
  gradients (within 1e-5 of each tensor's largest entry; C's bias, a sum of
  per-row gradients whose triplet part cancels, within 1e-5 of the largest
  of them) against JAX's, with
  the same weights and eps (both ``reparameterize``s patched to one numpy
  draw, as in tests/test_torch_vaes.py) and JAX's permutations from its
  ``rng_t``.
- The PS-VAE's and the MSPS-VAE's label and latent maps against JAX's (atol
  1e-5), the C map and its bias through ``utils/weights.py`` both ways
  (exact), the multi-session generator's draws and the trainer's collation
  against JAX's (exact), and a CPU run of the port's ``ae_grid_search`` on a
  two-session store whose version JAX loads: the port's exported latents and
  served ``encode`` within atol 1e-5 of JAX's forward.

The JAX references compile at LLVM optimization level 0 (``tests/jax_low.py``):
all the triplet cases in one program (JAX's permutations, from a program of
their own, handed to its ``jax.random.permutation`` calls), the weights drawn
with numpy from ``jax.eval_shape`` of the JAX init.
"""

import csv
import glob
import json
import os
import pickle
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.data import generator as jgen
from behavenet_tpu.fitting import training as jax_training
from behavenet_tpu.models import arch as jarch
from behavenet_tpu.models import base as jbase
from behavenet_tpu.models import vaes as jvaes
from behavenet_tpu.ops import losses as jlosses
from behavenet_tpu.utils.torch_import import params_to_torch_state_dict
from behavenet_tpu_torch import serving
from behavenet_tpu_torch.data import generator as tgen
from behavenet_tpu_torch.fitting import ae_grid_search, hyperparams
from behavenet_tpu_torch.fitting import training
from behavenet_tpu_torch.kernels import build
from behavenet_tpu_torch.models import vaes
from behavenet_tpu_torch.ops import losses
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params
from tests.jax_low import jit_low
from tests.test_utils.torch_ref_models import t_triplet_2ds

# ------------------------------------------------------------- triplet loss

# name -> padded seg_lens; each case runs with and without a row mask
TRIPLET_CASES = {'2-equal': (30, 30), '3-unequal': (36, 37, 40),
                 '4-unequal': (45, 38, 50, 40)}
D_BG = 3


def _triplet_inputs(lens):
    rs = np.random.RandomState(sum(lens))
    z = rs.randn(sum(lens), D_BG).astype(np.float32)
    mask = (rs.rand(sum(lens)) > 0.2).astype(np.float32)
    return z, mask, jax.random.PRNGKey(len(lens))


def _jax_perms(key, lens):
    """JAX's permutations of each segment, as triplet_loss draws them."""
    keys = jax.random.split(key, len(lens))
    return [jax.random.permutation(keys[i], n) for i, n in enumerate(lens)]


class _GivenPermutations:
    """The ``jax`` module with ``random.permutation`` handing out the given
    permutations in call order: patched in as ``behavenet_tpu.ops.losses``'s
    ``jax``, JAX's triplet_loss runs on the permutations it would draw, but
    in a program without the permutations' sorts (half the compile time)."""

    def __init__(self, perms):
        self._perms = list(perms)
        self.random = types.SimpleNamespace(split=jax.random.split,
                                            permutation=self._permutation)

    def _permutation(self, key, n):
        perm = self._perms.pop(0)
        assert perm.shape == (n,)
        return jnp.asarray(perm)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture(scope='module')
def jax_triplets():
    """(loss, grad, permutations) of JAX's triplet_loss for every case and
    mask: the permutations from one program, the losses and gradients from
    another."""
    inputs = {name: _triplet_inputs(lens) for name, lens in TRIPLET_CASES.items()}
    perms = jax.tree_util.tree_map(np.asarray, jit_low(lambda keys: {
        name: _jax_perms(keys[name], lens) for name, lens in TRIPLET_CASES.items()},
        {name: v[2] for name, v in inputs.items()}))

    def all_cases(zs, masks):
        out = {}
        for name, lens in TRIPLET_CASES.items():
            for masked in (False, True):
                def f(z):
                    return jlosses.triplet_loss(inputs[name][2], z, lens,
                                                seg_mask=masks[name] if masked else None)
                out[name, masked] = jax.value_and_grad(f)(zs[name])
        return out
    given = [p for name in TRIPLET_CASES for _ in range(2) for p in perms[name]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, 'jax', _GivenPermutations(given))
        refs = jit_low(all_cases, {name: v[0] for name, v in inputs.items()},
                       {name: v[1] for name, v in inputs.items()})
    return inputs, {k: (float(v), np.asarray(g), perms[k[0]]) for k, (v, g) in refs.items()}


@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('case', list(TRIPLET_CASES))
def test_triplet_plain_matches_jax(case, masked, jax_triplets):
    inputs, refs = jax_triplets
    lens = TRIPLET_CASES[case]
    z, mask, _ = inputs[case]
    want, want_grad, perms = refs[case, masked]
    mask_t = torch.from_numpy(mask) if masked else None
    zt = torch.tensor(z, requires_grad=True)
    loss = losses.triplet_loss(zt, lens, seg_mask=mask_t, perms=perms)
    loss.backward()
    np.testing.assert_allclose(float(loss), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())
    # the written-out backward against autograd through the plain forward
    z2 = torch.tensor(z, requires_grad=True)
    losses.triplet_loss_plain(z2, lens, perms, seg_mask=mask_t).backward(torch.tensor(2.5))
    grad = losses.triplet_loss_grad_plain(torch.from_numpy(z), lens, perms, 1.0, mask_t,
                                          torch.tensor(2.5))
    np.testing.assert_allclose(grad.numpy(), z2.grad.numpy(), rtol=0,
                               atol=1e-6 * z2.grad.abs().max().item())
    if len(lens) == 2 and not masked:
        ref = t_triplet_2ds(torch.nn.TripletMarginLoss(margin=1.0, p=2),
                            torch.from_numpy(z), perms, lens)
        np.testing.assert_allclose(float(loss), float(ref), rtol=0, atol=1e-6)


def test_triplet_kink_gradient_and_refusals():
    """The hinge's gradient is 0.5 at exactly 0 (JAX's jnp.maximum rule),
    outside 2-4 sessions or with empty chunks the loss raises as JAX's,
    the CUDA wrappers refuse CPU tensors, and the CPU dispatch launches no
    kernel."""
    # two sessions of three rows: chunks of one row; the first triplet's
    # anchor, positive and negative are rows 0, 1 and 5 (row 5 is in no other
    # term), and the margin puts its hinge exactly at 0
    z = torch.from_numpy(np.random.RandomState(5).randn(6, 3).astype(np.float32))
    perms = [torch.arange(3), torch.arange(3)]
    d_ap, d_an = losses._pdist(z[:1], z[1:2]), losses._pdist(z[:1], z[5:6])
    margin = float(d_an - d_ap)
    assert float(d_ap - d_an + margin) == 0.0
    g = losses.triplet_loss_grad_plain(z, (3, 3), perms, margin, None, torch.tensor(1.0))
    u_an = (z[0] - z[5] + 1e-6) / d_an
    np.testing.assert_allclose(g[5].numpy(), (0.5 / 3 * u_an).numpy(), rtol=1e-6)
    zt = z.clone().requires_grad_(True)
    losses.triplet_loss_plain(zt, (3, 3), perms, margin=margin).backward()
    np.testing.assert_allclose(g.numpy(), zt.grad.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match='2-4 datasets'):
        losses.triplet_loss(torch.zeros(30, 3), (10, 10, 10, 0, 0))
    with pytest.raises(ValueError, match='too small'):
        losses.triplet_loss(torch.zeros(4, 3), (2, 2))
    perm = torch.arange(60, dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        losses.triplet_loss_cuda(torch.zeros(60, 3), (30, 30), perm)
    with pytest.raises(ValueError, match='CUDA'):
        losses.triplet_loss_grad_cuda(torch.zeros(60, 3), (30, 30), perm, 1.0, None,
                                      torch.ones(4), torch.ones(1))
    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0
    zt = torch.randn(60, 3, requires_grad=True)
    losses.triplet_loss(zt, (30, 30), seg_mask=torch.ones(60)).backward()
    assert zt.grad is not None and not any(build.LAUNCHES.values())


# ----------------------------------------------------------------- models

IDS = {'lab': 'l', 'expt': 'e', 'animal': 'a'}
N_LATENTS, N_LABELS, N_BG = 6, 2, 2
CLASS_HP = {
    'ps-vae': {'ps_vae.alpha': 1000.0, 'ps_vae.beta': 5.0, 'ps_vae.anneal_epochs': 100},
    'msps-vae': {'ps_vae.alpha': 1000.0, 'ps_vae.beta': 5.0, 'ps_vae.anneal_epochs': 100,
                 'ps_vae.delta': 50.0, 'n_background': N_BG, 'n_sessions_per_batch': 2},
}
JAX_MODELS = {'ps-vae': jvaes.PSVAE, 'msps-vae': jvaes.MSPSVAE}
PORT_MODELS = {'ps-vae': vaes.PSVAE, 'msps-vae': vaes.MSPSVAE}


def _hparams(mc='msps-vae', expt_dir=None, **kw):
    small = {
        'ae_network_type': 'strides_only', 'ae_padding_type': 'same',
        'ae_batch_norm': 0, 'symmetric_arch': 1,
        'ae_encoding_n_channels': [8, 16], 'ae_encoding_kernel_size': [5, 5],
        'ae_encoding_stride_size': [2, 2], 'ae_encoding_layer_type': ['conv', 'conv'],
        'ae_decoding_last_FF_layer': 0, 'ae_input_dim': [1, 16, 12],
        'n_ae_latents': N_LATENTS,
    }
    small = jarch.get_handcrafted_dims(small, symmetric=True)
    return dict(small, model_class=mc, model_type='conv', n_labels=N_LABELS,
                n_input_channels=1, y_pixels=16, x_pixels=12, learning_rate=1e-3,
                l2_reg=1e-4, rng_seed_model=0, rng_seed_train=0, max_n_epochs=4,
                expt_dir=expt_dir, rng_seed_data=0, device='cpu', **dict(CLASS_HP[mc], **kw))


def _pair(mc, seed=0):
    """JAX model, numpy-drawn params of its init's tree (the fixed maps its
    own), and the port model carrying them."""
    hp = _hparams(mc)
    jmodel = JAX_MODELS[mc](hp)
    key = jax.random.PRNGKey(seed)
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (rs.uniform(-1, 1, a.shape) /
                   (np.prod(a.shape[:-1]) if len(a.shape) > 1 else 400) ** 0.5
                   ).astype(np.float32), jax.eval_shape(jmodel.init, key))
    fixed = [n for n in ('A', 'B', 'C') if n in params['encoder']]
    params['encoder'].update(jax.tree_util.tree_map(np.asarray, jit_low(
        lambda k: {n: jmodel.init(k)['encoder'][n] for n in fixed}, key)))
    model = PORT_MODELS[mc](hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return hp, jmodel, params, model


def _eps(shape):
    return np.random.RandomState(shape[0] * 100 + shape[1]).randn(*shape).astype(np.float32)


def test_loss_metrics_and_grads_match_jax(monkeypatch):
    hp, jmodel, params, model = _pair('msps-vae')
    seg_lens = (16, 16)
    rs = np.random.RandomState(1)
    n = sum(seg_lens)
    fm = np.ones(n, np.float32)
    fm[13:16] = fm[30:] = 0.0     # each segment bucket-padded
    batch = {'images': rs.randint(0, 256, (n, 16, 12, 1)).astype(np.uint8),
             'labels': rs.randn(n, N_LABELS).astype(np.float32), 'frame_mask': fm}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch['images'] = jbatch['images'].astype(jnp.float32) / 255.0
    key = jax.random.PRNGKey(7)
    epoch = 2
    jkw, kw = jmodel.loss_kwargs(epoch), model.loss_kwargs(epoch)
    assert {k: float(v) for k, v in jkw.items()} == kw
    monkeypatch.setattr(jvaes, 'reparameterize',
                        lambda k, mu, lv: jnp.asarray(_eps(mu.shape)) * jnp.exp(lv) + mu)
    ((_, jmetrics), jgrads), perms = jit_low(lambda p: (jax.value_and_grad(
        lambda q: jmodel.loss_fn(q, jbatch, key, seg_lens=seg_lens, **jkw), has_aux=True)(p),
        _jax_perms(jax.random.split(key)[1], seg_lens)), params)   # JAX's rng_t

    monkeypatch.setattr(vaes, 'reparameterize', lambda mu, lv, generator=None:
                        torch.from_numpy(_eps(tuple(mu.shape))) * torch.exp(lv) + mu)
    triplet = losses.triplet_loss
    perms = [np.asarray(p) for p in perms]
    monkeypatch.setattr(losses, 'triplet_loss',
                        lambda *a, **k: triplet(*a, **dict(k, perms=perms)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = model.loss_fn(tbatch, seg_lens=seg_lens, **kw)
    loss.backward()
    assert sorted(metrics) == sorted(jmodel.metrics_keys) == sorted(model.metrics_keys)
    assert float(metrics['loss_triplet']) > 0
    for k in jmodel.metrics_keys:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # C's bias sums the background latents' per-row gradients; their triplet
    # part sums to 0 (the term reads only differences of rows), so in float32
    # the bias keeps rounding noise of the per-row size, which is ~1e3 times
    # its own: its bound is 1e-5 of the largest per-row gradient it sums
    with torch.no_grad():
        z_b = model.encode(tbatch['images'])[1]
        rows = 50.0 * losses.triplet_loss_grad_plain(
            z_b, seg_lens, perms, 1.0, tbatch['frame_mask'], torch.tensor(1.0))
    ref = params_to_state_dict(model, jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        scale = np.abs(want).max()
        if name == 'encoding.C.bias':
            scale = max(scale, rows.abs().max().item())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
    # one session: no triplet term, the rest as with it
    with torch.no_grad():
        loss1, metrics1 = model.loss_fn(tbatch, **kw)
    assert metrics1['loss_triplet'] == 0.0 and metrics1['delta'] == 50.0
    np.testing.assert_allclose(float(loss1), float(loss) - 50.0 * float(metrics['loss_triplet']),
                               rtol=1e-5)
    with pytest.raises(ValueError, match='n_sessions_per_batch'):
        vaes.MSPSVAE(dict(hp, n_sessions_per_batch=1))


def test_weights_round_trip_with_c_and_its_bias():
    """C = encoding.C.weight^T and C_b = encoding.C.bias, key for key as the
    JAX package's export, and back bit for bit; C is a buffer, its bias
    trained; a fresh model draws the fixed maps as the JAX init does."""
    hp, jmodel, params, model = _pair('msps-vae', seed=3)
    ref = params_to_torch_state_dict(jmodel, params)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref) and 'encoding.C.bias' in sd
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    back = jax.tree_util.tree_leaves_with_path(state_dict_to_params(model))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(back)
    for (path, leaf), (path_b, leaf_b) in zip(flat, back):
        assert path == path_b
        np.testing.assert_array_equal(leaf_b, leaf, err_msg=str(path))
    names = {n for n, _ in model.named_parameters()}
    assert 'encoding.C.bias' in names and 'encoding.C.weight' not in names
    # a fresh model's A, C and B are the JAX init's rows [:2], [2:4], [4:] of
    # its orthogonal draw, bit for bit; C's bias is U(+-1/sqrt(n_ae_latents))
    fresh = vaes.MSPSVAE(hp).state_dict()
    for name in ('A', 'B', 'C'):
        np.testing.assert_array_equal(fresh['encoding.%s.weight' % name].numpy().T,
                                      params['encoder'][name], err_msg=name)
    bias = fresh['encoding.C.bias'].numpy()
    assert bias.shape == (N_BG,) and np.abs(bias).max() <= N_LATENTS ** -0.5


@pytest.mark.parametrize('mc', list(CLASS_HP))
def test_label_and_latent_maps_match_jax(mc):
    """get_predicted_labels, get_transformed_latents (from latents and from
    frames) and get_inverse_transformed_latents (JAX vaes.py:336-360,
    :489-518)."""
    hp, jmodel, params, model = _pair(mc, seed=1)
    rs = np.random.RandomState(2)
    frames = rs.randint(0, 256, (5, 16, 12, 1)).astype(np.uint8)
    lat = rs.randn(5, N_LATENTS).astype(np.float32)

    def jax_maps(p, x, z):
        return (jmodel.get_predicted_labels(p, x), jmodel.get_transformed_latents(p, z),
                jmodel.get_transformed_latents(p, x), jmodel.get_inverse_transformed_latents(p, z))
    want = jit_low(jax_maps, params, frames.astype(np.float32) / 255.0, lat)
    with torch.no_grad():
        got = (model.get_predicted_labels(frames), model.get_transformed_latents(lat),
               model.get_transformed_latents(frames),
               model.get_inverse_transformed_latents(lat))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


# -------------------------------------------- generator, collation and the CLI

SESSIONS = {'s0': 10, 's1': 20}   # trials per session: the shorter runs out first


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """Two sessions of 20-frame 1x16x12 trials with 2 labels; session 1 is
    brighter."""
    data_dir = str(tmp_path_factory.mktemp('data'))
    rng = np.random.RandomState(0)
    paths = {}
    for i, (sess, n) in enumerate(SESSIONS.items()):
        path = os.path.join(data_dir, 'l', 'e', 'a', sess, 'data.hdf5')
        os.makedirs(os.path.dirname(path))
        with h5py.File(path, 'w', libver='latest') as f:
            gi, gl = f.create_group('images'), f.create_group('labels')
            for t in range(n):
                gi.create_dataset('trial_%04i' % t, dtype='uint8',
                                  data=rng.randint(0, 128, (20, 1, 16, 12)) + 100 * i)
                gl.create_dataset('trial_%04i' % t, dtype='float32',
                                  data=rng.randn(20, N_LABELS).astype(np.float32))
        paths[sess] = path
    return data_dir, paths


def test_multi_generator_and_collate_match_jax(store):
    data_dir, paths = store
    ids = [dict(IDS, session=s) for s in SESSIONS]
    signals = [['images', 'labels']] * 2
    gens = []
    for mod in (jgen, tgen):
        np.random.seed(0)
        gens.append(mod.ConcatSessionsGeneratorMulti(
            data_dir, ids, signals_list=signals, transforms_list=[[None, None]] * 2,
            paths_list=[[p, p] for p in paths.values()], rng_seed=1,
            n_sessions_per_batch=2))
    assert gens[0].n_tot_batches == gens[1].n_tot_batches
    assert gens[1].n_tot_batches['train'] == \
        sum(d.n_batches['train'] for d in gens[1].datasets) // 2
    hp = {'shape_bucket': 32}
    n_none = 0
    for epoch in range(2):
        for dtype in ('train', 'val'):
            draws = []
            for gen in gens:
                np.random.seed(10 + epoch)
                gen.reset_iterators(dtype)
                draws.append([gen.next_batch(dtype) for _ in range(gen.n_tot_batches[dtype])])
            for (ja, jd), (ta, td) in zip(*draws):
                assert jd == td
                if ta is None:
                    assert ja is None
                    n_none += 1
                    continue
                jb, _, jlens, jtrial = jax_training._collate(ja, jd, 'msps-vae', hp)
                tb, _, tlens, ttrial = training._collate(ta, td, hp)
                assert (jlens, jtrial) == (tlens, ttrial) and sorted(jb) == sorted(tb)
                for k in jb:
                    np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
                assert isinstance(td, list) == (dtype == 'train')
    assert n_none > 0   # the (None, None) batches once a session runs out


def _write_configs(tmp, data_dir, save_dir):
    model = {'experiment_name': 'port', 'model_type': 'conv', 'n_ae_latents': N_LATENTS,
             'l2_reg': 0.0, 'rng_seed_model': 0, 'fit_sess_io_layers': False,
             'ae_arch_json': None, 'model_class': 'msps-vae',
             **{k: v for k, v in CLASS_HP['msps-vae'].items()}}
    configs = {
        'data': {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 'all',
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
                     'train_frac': 0.5, 'trial_splits': '8;1;1;0'},
        'compute': {'device': 'cpu', 'tt_n_cpu_workers': 1},
    }
    args = []
    for name, cfg in configs.items():
        p = os.path.join(tmp, '%s.json' % name)
        with open(p, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, p]
    return args


def test_grid_search_version_exports_serves_and_loads_in_jax(store, tmp_path):
    """The port's CLI fits an MSPS-VAE on two sessions on the CPU (half the
    train trials, so the shorter session runs out first); JAX loads its
    version, and the port's exported latents (every trial of each session,
    one train split) and served ``encode`` give JAX's posterior means [z_s,
    z_b, z_u]."""
    data_dir, _ = store
    save_dir = str(tmp_path / 'save')
    args = _write_configs(str(tmp_path), data_dir, save_dir)
    hyperparams.run_grid_search(ae_grid_search.main, hyperparams.get_all_params(args=args))
    vdir, = glob.glob(os.path.join(save_dir, 'l', 'e', 'a', '*', 'msps-vae', 'conv',
                                   '%02i_latents' % N_LATENTS, 'port', 'version_0'))
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        hp = pickle.load(f)
    assert hp['training_completed'] is True and hp['n_labels'] == N_LABELS
    with open(os.path.join(vdir, 'metrics.csv')) as f:
        rows = list(csv.DictReader(f))
    # the triplet term in every train row (epoch 0's eval of train batches
    # too), not in the single-session val and test rows
    assert all(float(r['tr_loss_triplet']) > 0 for r in rows if r.get('tr_loss_triplet'))
    for key in ('val_loss_triplet', 'test_loss_triplet'):
        vals = [float(r[key]) for r in rows if r.get(key)]
        assert vals and not any(vals), key
    assert sum(1 for r in rows if r.get('tr_loss_triplet')) == 2

    params, extra = jbase.load_params(os.path.join(vdir, 'best_val_model.pt'))
    assert extra == {'model_class': 'msps-vae'}
    jmodel = jvaes.MSPSVAE(hp)
    bundle = serving.load_version(vdir, device='cpu')
    frames = {}
    for sess, n in SESSIONS.items():
        ds = tgen.SingleSessionDataset(
            data_dir, signals=['images'], transforms=[None], session=sess,
            paths=[os.path.join(data_dir, 'l', 'e', 'a', sess, 'data.hdf5')], **IDS)
        frames[sess] = np.concatenate([ds[i]['images'] for i in range(n)])
    both = np.concatenate(list(frames.values()))
    want = np.asarray(jit_low(lambda p, x, k: jmodel.forward(p, x, rng=k, use_mean=True)[2],
                              params, both.astype(np.float32) / 255.0, jax.random.PRNGKey(0)))
    start = 0
    for sess, n in SESSIONS.items():
        ref = want[start:start + 20 * n]
        start += 20 * n
        with open(os.path.join(vdir, 'l_e_a_%s_latents.pkl' % sess), 'rb') as f:
            exported = pickle.load(f)
        assert [len(exported['trials'][k]) for k in ('train', 'val', 'test')] == [n, 0, 0]
        np.testing.assert_allclose(np.concatenate(exported['latents']), ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(bundle.encode(frames[sess][:20]).numpy(), ref[:20], rtol=0,
                                   atol=1e-5)
