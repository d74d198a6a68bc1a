"""The port's copy of models/arch.py gives the JAX package's arch dicts."""

import glob
import os

import pytest

from behavenet_tpu.models import arch as jarch
from behavenet_tpu_torch.models import arch as tarch

_CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs', 'ae_jsons')


@pytest.mark.parametrize('input_dim,n_latents', [
    ([1, 128, 128], 12), ([2, 128, 128], 12), ([2, 96, 128], 9),
    ([1, 64, 48], 10), ([2, 32, 24], 6)])
def test_default_arch(input_dim, n_latents):
    kw = dict(batch_size=189, check_memory=True)
    assert tarch.load_handcrafted_arch(list(input_dim), n_latents, None, **kw) == \
        jarch.load_handcrafted_arch(list(input_dim), n_latents, None, **kw)


@pytest.mark.parametrize('path', sorted(glob.glob(os.path.join(_CONFIGS, '*arch*.json'))))
def test_config_arch_jsons(path):
    kw = dict(batch_size=100, check_memory=False)
    assert tarch.load_handcrafted_arches([2, 64, 48], '4,8', path, **kw) == \
        jarch.load_handcrafted_arches([2, 64, 48], '4,8', path, **kw)


@pytest.mark.parametrize('seed', [3, 11])
def test_random_archs(seed):
    assert tarch.get_possible_arch([1, 64, 48], 10, arch_seed=seed) == \
        jarch.get_possible_arch([1, 64, 48], 10, arch_seed=seed)


def test_draw_archs_and_footprint():
    t = tarch.draw_archs(100, [1, 64, 48], 10, n_archs=4, check_memory=True)
    j = jarch.draw_archs(100, [1, 64, 48], 10, n_archs=4, check_memory=True)
    assert t == j
    assert tarch.estimate_model_footprint(t[0], [50, 1, 64, 48]) == \
        jarch.estimate_model_footprint(j[0], [50, 1, 64, 48])
