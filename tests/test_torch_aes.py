"""The port's AE against the JAX AE, with weights carried by utils/weights.py.

Tolerance: float32, atol 1e-5 on latents and reconstructions (the same
products summed in different orders through ten layers at a small size).
"""

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.models import AE as JaxAE
from behavenet_tpu.models import arch as jarch
from behavenet_tpu.utils.torch_import import params_to_torch_state_dict
from behavenet_tpu_torch.models.aes import AE
from behavenet_tpu_torch.utils.weights import params_to_state_dict
from tests.jax_low import jit_low


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


def _fan_in(shape):
    """HWIO kernels: kh * kw * Cin; dense (in, out): in; biases: 400."""
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 400


def _pair(hp, seed=0):
    """The JAX model, params of its tree drawn with numpy at the init's
    scale (the tree from ``jax.eval_shape``, which compiles nothing), and the
    port model holding them."""
    jmodel = JaxAE(hp)
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(
        lambda a: rs.uniform(-1, 1, a.shape).astype(np.float32) / _fan_in(a.shape) ** 0.5,
        shapes)
    model = AE(hp)
    model.load_state_dict(params_to_state_dict(model, params))
    return jmodel, params, model



FORWARD_CASES = {'2view': {}, '1view': {'img': (1, 32, 24)},
                 'no_subpixel': {'subpixel_decoder': False}, 'valid': {'padding': 'valid'}}


def _forward_case(name):
    hp = _hparams(**FORWARD_CASES[name])
    jmodel, params, model = _pair(hp)
    x = np.random.RandomState(0).rand(2, hp['y_pixels'], hp['x_pixels'],
                                      hp['n_input_channels']).astype(np.float32)
    return jmodel, params, model, x


@pytest.fixture(scope='module')
def jax_forwards():
    """case -> (the port model, its input, the JAX model's forward
    (reconstruction, latents)), every JAX forward from one program."""
    cases = {name: _forward_case(name) for name in FORWARD_CASES}
    refs = jit_low(lambda args: {name: cases[name][0].forward(*args[name]) for name in args},
                   {name: (c[1], c[3]) for name, c in cases.items()})
    return {name: (c[2], c[3], refs[name]) for name, c in cases.items()}


@pytest.mark.parametrize('hp_kw', list(FORWARD_CASES.values()), ids=list(FORWARD_CASES))
def test_forward_matches_jax(hp_kw, jax_forwards):
    name = next(k for k, v in FORWARD_CASES.items() if v == hp_kw)
    model, x, (jy, jz) = jax_forwards[name]
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
    {'fit_sess_io_layers': True}, {'model_type': 'linear'},
    {'ae_decoding_last_FF_layer': 1},
    {'compute_dtype': 'bfloat16'}, {'bf16_pipeline': True}])
def test_unported_archs_raise(change):
    """Unported archs and dtypes raise; a float32 ``compute_dtype`` is the
    port's own and builds."""
    with pytest.raises(NotImplementedError):
        AE(dict(_hparams(), **change))
    if 'compute_dtype' in change:
        AE(dict(_hparams(), compute_dtype='float32', bf16_pipeline=False))
