"""The port's data pipeline against the JAX package's copies.

Both packages must draw numpy's global RNG identically, so that the same
store is split and batched in the same order; transforms are numpy and must
agree exactly.
"""

import os

import h5py
import numpy as np
import pytest

from behavenet_tpu.data import generator as jgen
from behavenet_tpu.data import transforms as jtr
from behavenet_tpu_torch.data import generator as tgen
from behavenet_tpu_torch.data import transforms as ttr
from behavenet_tpu_torch.data.prefetch import prefetched


@pytest.mark.parametrize('n,seed,splits', [
    (12, 0, {}), (37, 3, {'train_tr': 5, 'val_tr': 2, 'test_tr': 2, 'gap_tr': 1})])
def test_split_trials_matches_jax(n, seed, splits):
    a = jgen.split_trials(n, rng_seed=seed, **splits)
    b = tgen.split_trials(n, rng_seed=seed, **splits)
    for k in ('train', 'val', 'test'):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp('data'))
    path = os.path.join(data_dir, 'l', 'e', 'a', 's', 'data.hdf5')
    os.makedirs(os.path.dirname(path))
    rng = np.random.RandomState(0)
    with h5py.File(path, 'w', libver='latest') as f:
        for sig in ('images', 'masks'):
            g = f.create_group(sig)
            for i in range(23):
                g.create_dataset('trial_%04i' % i, dtype='uint8',
                                 data=rng.randint(0, 255, (5 + i, 2, 6, 4)))
    return data_dir, path


@pytest.mark.parametrize('batch_load', [True, False])
def test_generator_batches_in_the_jax_order(store, batch_load):
    data_dir, path = store
    ids = {'lab': 'l', 'expt': 'e', 'animal': 'a', 'session': 's'}
    gens = []
    for mod in (jgen, tgen):
        np.random.seed(0)
        gens.append(mod.ConcatSessionsGenerator(
            data_dir, [ids], signals_list=[['images', 'masks']],
            transforms_list=[[None, None]], paths_list=[[path, path]], rng_seed=1,
            batch_load=batch_load, train_frac=0.5))
    for epoch in range(2):
        for dtype in ('train', 'val', 'test'):
            trials = []
            for gen in gens:
                np.random.seed(10 + epoch)
                gen.reset_iterators(dtype)
                trials.append([gen.next_batch(dtype)[0] for _ in
                               range(gen.n_tot_batches[dtype])])
            assert [s['batch_idx'] for s in trials[0]] == \
                [s['batch_idx'] for s in trials[1]]
            for a, b in zip(*trials):
                assert b['images'].dtype == np.uint8 and b['masks'].dtype == np.float32
                np.testing.assert_array_equal(a['images'], b['images'])
                np.testing.assert_array_equal(a['masks'], b['masks'])


def test_unported_signals_raise(store):
    """Pickles of predictions are not ported yet; latents and states
    pickles are, and a missing one raises as in the JAX package."""
    data_dir, path = store
    with pytest.raises(NotImplementedError, match='ae_predictions'):
        tgen.SingleSessionDataset(data_dir, 'l', 'e', 'a', 's', signals=['ae_predictions'],
                                  transforms=[None], paths=['x.pkl'])
    with pytest.raises(NotImplementedError, match='Could not open x.pkl'):
        tgen.SingleSessionDataset(data_dir, 'l', 'e', 'a', 's', signals=['arhmm_states'],
                                  transforms=[None], paths=['x.pkl'])
    with pytest.raises(NotImplementedError, match='Could not open x.pkl'):
        tgen.SingleSessionDataset(data_dir, 'l', 'e', 'a', 's', signals=['ae_latents'],
                                  transforms=[None], paths=['x.pkl'])


def test_transforms_match_jax():
    rng = np.random.RandomState(2)
    states = np.array([0, 0, 1, 1, 1, 2, 0, 0, 3], dtype=float)
    sig = rng.rand(30, 7)
    labels = rng.rand(5, 4) * 10
    pairs = [
        (jtr.BlockShuffle(3), ttr.BlockShuffle(3), states),
        (jtr.MakeOneHot(5), ttr.MakeOneHot(5), states),
        (jtr.MakeOneHot2D(12, 10), ttr.MakeOneHot2D(12, 10), labels),
        (jtr.MotionEnergy(), ttr.MotionEnergy(), sig),
        (jtr.SelectIdxs([0, 3]), ttr.SelectIdxs([0, 3]), sig),
        (jtr.Threshold(5.0, 25), ttr.Threshold(5.0, 25), sig),
        (jtr.ZScore(), ttr.ZScore(), sig),
        (jtr.ClipNormalize(0.5), ttr.ClipNormalize(0.5), sig),
        (jtr.Compose([jtr.ZScore(), jtr.SelectIdxs([1])]),
         ttr.Compose([ttr.ZScore(), ttr.SelectIdxs([1])]), sig),
    ]
    for j, t, x in pairs:
        np.testing.assert_array_equal(t(x.copy()), j(x.copy()), err_msg=repr(j))
        assert repr(t) == repr(j)


def test_prefetched_keeps_order_and_raises_producer_errors():
    it = iter(range(5))
    assert list(prefetched(lambda: next(it), 5, depth=2)) == list(range(5))

    def boom():
        raise KeyError('producer')
    with pytest.raises(KeyError, match='producer'):
        list(prefetched(boom, 3))
