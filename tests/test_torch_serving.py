"""The port's serving.load_version on a version the JAX package wrote.

Tolerance: float32, atol 1e-5 against the JAX ``model.forward(params, x/255)``,
as tests/test_serving.py holds the JAX heads.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.models import AE, arch
from behavenet_tpu.models import base as models_base
from behavenet_tpu_torch import serving
from tests.jax_low import jit_low

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')


@pytest.fixture(scope='module')
def version(tmp_path_factory):
    """A version dir as the JAX CLI writes it, the JAX model and its params."""
    img, n_latents = (2, 32, 24), 6
    a = arch.load_handcrafted_arch(list(img), n_latents, None, check_memory=False)
    hp = dict(a, model_class='ae', model_type='conv', n_ae_latents=n_latents,
              n_input_channels=img[0], y_pixels=img[1], x_pixels=img[2],
              learning_rate=1e-4, l2_reg=0.0, rng_seed_model=0)
    model = AE(hp)
    # weights of the init's tree (``jax.eval_shape`` compiles nothing) drawn
    # with numpy at a fan-in scale
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (rs.uniform(-1, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1]) if a.ndim > 1
                                                        else 400)).astype(np.float32),
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    vdir = tmp_path_factory.mktemp('store') / 'version_0'
    vdir.mkdir()
    with open(vdir / 'meta_tags.pkl', 'wb') as f:
        pickle.dump(hp, f)
    models_base.save_params(params, str(vdir / 'best_val_model.pt'),
                            extra={'model_class': 'ae'})
    return str(vdir), model, params



def test_encode_reconstruct_match_jax(version):
    vdir, model, params = version
    bundle = serving.load_version(vdir, device='cpu')
    assert bundle.names() == ['encode', 'reconstruct']
    frames = np.random.RandomState(0).randint(0, 256, (5, 32, 24, 2)).astype(np.uint8)
    # frames are independent, so the first n answers of one JAX call are
    # the reference for a request of n frames
    ref_y, ref_z = jit_low(model.forward, params, frames.astype(np.float32) / 255.0)
    for n in (1, 3, 5):
        z = bundle.encode(frames[:n])
        y = bundle.reconstruct(torch.from_numpy(frames[:n]))
        assert z.dtype == torch.float32 and y.dtype == torch.float32
        np.testing.assert_allclose(z.numpy(), np.asarray(ref_z)[:n], atol=1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y)[:n], atol=1e-5)


def test_frames_are_checked(version):
    bundle = serving.load_version(version[0], device='cpu')
    with pytest.raises(ValueError, match='uint8'):
        bundle.encode(np.zeros((2, 32, 24, 2), np.float32))
    with pytest.raises(ValueError, match='uint8'):
        bundle.encode(np.zeros((2, 24, 32, 2), np.uint8))


def test_default_device_is_cuda_and_never_falls_back(version, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        serving.load_version(version[0])


def test_other_model_classes_raise(tmp_path):
    with open(tmp_path / 'meta_tags.pkl', 'wb') as f:
        pickle.dump({'model_class': 'cond-vae'}, f)
    with pytest.raises(NotImplementedError):
        serving.load_version(str(tmp_path), device='cpu')


def test_loads_without_jax(version):
    """Unpickling the JAX CLI's files pulls neither jax nor behavenet_tpu
    into the serving process."""
    code = (
        'import sys\n'
        'from behavenet_tpu_torch import serving\n'
        'import numpy as np\n'
        'b = serving.load_version(sys.argv[1], device="cpu")\n'
        'z = b.encode(np.zeros((2, 32, 24, 2), np.uint8))\n'
        'assert tuple(z.shape) == (2, 6), z.shape\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("jax", "jaxlib", "behavenet_tpu"))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, '-c', code, version[0]], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
