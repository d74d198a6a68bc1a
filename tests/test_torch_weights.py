"""Weights both ways between the packages, and the port's initializers.

``state_dict_to_params`` inverts ``params_to_state_dict`` exactly (a
permutation and transposes of float32 arrays). A fresh port ``AE`` draws
torch's default init, the distribution of the JAX package's
``models/base.py:22-58`` (the numbers differ: torch and JAX generators).
"""

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.models import AE as JaxAE
from behavenet_tpu.models import arch as jarch
from behavenet_tpu_torch.models import base
from behavenet_tpu_torch.models.aes import AE, load_pretrained_ae
from behavenet_tpu_torch.utils.weights import params_to_state_dict, state_dict_to_params
from tests.jax_low import jit_low


def _hparams(seed=0, n_latents=6):
    a = jarch.load_default_arch()
    a['ae_input_dim'] = [2, 32, 24]
    a['n_ae_latents'] = n_latents
    a = jarch.get_handcrafted_dims(a)
    return dict(a, model_class='ae', model_type='conv', n_ae_latents=n_latents,
                n_input_channels=2, y_pixels=32, x_pixels=24, rng_seed_model=seed)


def _leaves(tree, prefix=''):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + '/')
        else:
            yield prefix + k, np.asarray(v)


def test_state_dict_to_params_inverts_params_to_state_dict():
    hp = _hparams()
    rs = np.random.RandomState(7)   # any values: the maps are permutations
    params = jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32),
        jax.eval_shape(JaxAE(hp).init, jax.random.PRNGKey(7)))
    model = AE(hp)
    model.load_state_dict(params_to_state_dict(model, params))
    back = state_dict_to_params(model)
    got, want = dict(_leaves(back)), dict(_leaves(params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].flags['C_CONTIGUOUS'], k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fresh_model_has_the_jax_init_bounds():
    hp = _hparams()
    # jitted, at LLVM optimization level 0: the eager init's bits in less time
    key = jax.random.PRNGKey(0)
    jparams = dict(_leaves(jax.tree_util.tree_map(np.asarray, jit_low(JaxAE(hp).init, key))))
    port = dict(_leaves(state_dict_to_params(AE(hp))))
    assert sorted(port) == sorted(jparams)
    for k, w in port.items():
        group, layer, _ = k.split('/')
        kind = 'w' if layer == 'fc' else layer.split('_')[0]
        wshape = port['%s/%s/w' % (group, layer)].shape
        fan_in = wshape[0] if kind == 'w' else \
            (wshape[3] if kind == 'convt' else wshape[2]) * wshape[0] * wshape[1]
        bound = 1.0 / np.sqrt(fan_in)
        # every value inside the bound, and the draws fill it (>= 50 values)
        assert np.abs(w).max() <= bound, k
        assert np.abs(jparams[k]).max() <= bound * (1 + 1e-6), k
        if w.size >= 50:
            assert np.abs(w).max() > 0.8 * bound and abs(w.mean()) < 0.2 * bound, k


def test_init_follows_rng_seed_model():
    a = state_dict_to_params(AE(_hparams(seed=0)))
    b = state_dict_to_params(AE(_hparams(seed=0)))
    c = state_dict_to_params(AE(_hparams(seed=1)))
    w = 'encoder/conv_1/w'
    assert np.array_equal(dict(_leaves(a))[w], dict(_leaves(b))[w])
    assert not np.array_equal(dict(_leaves(a))[w], dict(_leaves(c))[w])


def test_params_finite():
    params = state_dict_to_params(AE(_hparams()))
    assert base.params_finite(params)
    params['decoder']['fc']['b'] = params['decoder']['fc']['b'].copy()
    params['decoder']['fc']['b'][0] = np.nan
    assert not base.params_finite(params)
    assert base.params_finite({'a': torch.ones(2)})


@pytest.mark.parametrize('n_latents,loads_fc', [(6, True), (4, False)])
def test_load_pretrained_ae(tmp_path, n_latents, loads_fc):
    src = state_dict_to_params(AE(_hparams(seed=3)))
    path = str(tmp_path / 'best_val_model.pt')
    base.save_params(src, path)
    hp = dict(_hparams(seed=0, n_latents=n_latents), pretrained_weights_path=path)
    fresh = state_dict_to_params(AE(hp))
    new = load_pretrained_ae(fresh, None, hp)
    np.testing.assert_array_equal(new['encoder']['conv_2']['w'],
                                  src['encoder']['conv_2']['w'])
    assert np.array_equal(new['encoder']['fc']['w'], src['encoder']['fc']['w']) == loads_fc
    assert load_pretrained_ae(fresh, None, dict(hp, pretrained_weights_path=None)) is fresh
