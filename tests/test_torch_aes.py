"""The port's AE against the JAX AE, with weights carried by utils/weights.py.

Tolerance: float32, atol 1e-5 on latents and reconstructions (the same
products summed in different orders through ten layers at a small size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavenet_tpu.models import AE as JaxAE
from behavenet_tpu.models import arch as jarch
from behavenet_tpu.utils.torch_import import params_to_torch_state_dict
from behavenet_tpu_torch.models.aes import AE
from behavenet_tpu_torch.utils.weights import params_to_state_dict


def _hparams(img=(2, 32, 24), n_latents=6, padding='same', **kw):
    a = jarch.load_default_arch()
    a['ae_padding_type'] = padding
    if padding == 'valid':
        # output padding 1 on two layers: 32x24 -> 14x10 -> 5x3 -> 2x1
        a['ae_encoding_n_channels'] = [32, 64, 128]
        a['ae_encoding_stride_size'] = [2, 2, 2]
        a['ae_encoding_kernel_size'] = [5, 5, 3]
        a['ae_encoding_layer_type'] = ['conv'] * 3
    a['ae_input_dim'] = list(img)
    a['n_ae_latents'] = n_latents
    a = jarch.get_handcrafted_dims(a)
    return dict(a, model_class='ae', model_type='conv', n_ae_latents=n_latents,
                n_input_channels=img[0], y_pixels=img[1], x_pixels=img[2], **kw)


def _pair(hp, seed=0):
    jmodel = JaxAE(hp)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = AE(hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return jmodel, params, model


@pytest.mark.parametrize('hp_kw', [
    {}, {'img': (1, 32, 24)}, {'subpixel_decoder': False}, {'padding': 'valid'}],
    ids=['2view', '1view', 'no_subpixel', 'valid'])
def test_forward_matches_jax(hp_kw):
    hp = _hparams(**hp_kw)
    jmodel, params, model = _pair(hp)
    x = np.random.RandomState(0).rand(3, hp['y_pixels'], hp['x_pixels'],
                                      hp['n_input_channels']).astype(np.float32)
    jy, jz = jmodel.forward(params, jnp.asarray(x))
    with torch.no_grad():
        y, z = model(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_uint8_frames_equal_normalized_floats():
    hp = _hparams()
    _, _, model = _pair(hp)
    x = np.random.RandomState(1).randint(0, 256, (2, 32, 24, 2)).astype(np.uint8)
    with torch.no_grad():
        y8, z8 = model(torch.from_numpy(x))
        yf, zf = model(torch.from_numpy(x).float() / 255.0)
    assert torch.equal(z8, zf) and torch.equal(y8, yf)


def test_state_dict_matches_reference_export():
    """The port's state dict is the reference's, key for key and value for
    value, as the JAX package's exporter writes it."""
    hp = _hparams()
    jmodel, params, model = _pair(hp, seed=3)
    ref = params_to_torch_state_dict(jmodel, params)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('change', [
    {'ae_batch_norm': True}, {'model_type': 'linear'},
    {'ae_encoding_layer_type': ['conv', 'maxpool', 'conv', 'conv', 'conv']}])
def test_unported_archs_raise(change):
    with pytest.raises(NotImplementedError):
        AE(dict(_hparams(), **change))
