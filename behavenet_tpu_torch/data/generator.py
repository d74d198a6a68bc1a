"""Trial-store datasets and multi-session batch servers (numpy, host side).

The port's copy of ``behavenet_tpu/data/generator.py`` for the signals an
HDF5 trial store holds. One trial is one batch; batches are dicts of numpy
arrays, images uint8 NHWC (normalized on the device, in the first conv's
load). The numpy RNG is drawn exactly as the JAX copy draws it (same seeds,
same calls in the same order), so both packages split and batch a store in
the same order.

``h5py`` is imported only where an HDF5 file is opened. Trials are read
through h5py; the JAX package's raw-offset reader (``data/raw_h5.py``) is
not ported yet. Of the signals that live in export pickles, the AE latents
(``'ae_latents'``, ``'latents'``: key ``'latents'`` of
``<lab>_<expt>_<animal>_<session>_latents.pkl``, float32) and the ARHMM
states (``'arhmm_states'``, ``'arhmm'``: key ``'states'`` of ``..._states.pkl``,
int32) are read, with their transforms (motion energy, block shuffle, one-hot
states, which widens int states to float32 (T, K)), and a session that asks
for no HDF5 signal takes its trial count from the pickle, so a latents-only
run never imports h5py. Predictions pickles belong to model classes not
ported yet and raise.
"""

import os
import pickle
from collections import OrderedDict

import numpy as np

__all__ = ['split_trials', 'SingleSessionDataset', 'ConcatSessionsGenerator']


def split_trials(n_trials, rng_seed=0, train_tr=8, val_tr=1, test_tr=1, gap_tr=0):
    """Split trials into train/val/test blocks with gap trials between them.

    Block layout: ``train | gap | val | gap | test | gap``. RNG-stream
    compatible with the reference (data_generator.py:42-103).
    """
    np.random.seed(rng_seed)

    tr_per_block = train_tr + gap_tr + val_tr + gap_tr + test_tr + gap_tr
    n_blocks = int(np.floor(n_trials / tr_per_block))
    if n_blocks == 0:
        raise ValueError(
            'Not enough trials (n=%i) for the train/test/val/gap values %i/%i/%i/%i' %
            (n_trials, train_tr, val_tr, test_tr, gap_tr))

    leftover_trials = n_trials - tr_per_block * n_blocks
    if leftover_trials > 0:
        offset = np.random.randint(0, high=leftover_trials)
    else:
        offset = 0
    idxs_block = np.random.permutation(n_blocks)

    batch_idxs = {'train': [], 'test': [], 'val': []}
    for block in idxs_block:
        curr_tr = block * tr_per_block + offset
        batch_idxs['train'].append(np.arange(curr_tr, curr_tr + train_tr))
        curr_tr += (train_tr + gap_tr)
        batch_idxs['val'].append(np.arange(curr_tr, curr_tr + val_tr))
        curr_tr += (val_tr + gap_tr)
        batch_idxs['test'].append(np.arange(curr_tr, curr_tr + test_tr))

    for dtype in ['train', 'val', 'test']:
        batch_idxs[dtype] = np.concatenate(batch_idxs[dtype], axis=0)

    return batch_idxs


def _to_nhwc(arr):
    """(T, C, H, W) -> (T, H, W, C)."""
    return np.ascontiguousarray(np.transpose(arr, (0, 2, 3, 1)))


# pickle-backed signal -> (key in the pickle, dtype) (JAX: data/generator.py:199)
_PKL_KEYS = {'ae_latents': ('latents', 'float32'), 'latents': ('latents', 'float32'),
             'arhmm_states': ('states', 'int32'), 'arhmm': ('states', 'int32')}


def _load_pkl(path, key, dtype, idx=None):
    """Per-trial arrays of an export pickle (JAX: data/generator.py:69)."""
    with open(path, 'rb') as f:
        data = pickle.load(f)[key]
    if idx is None:
        return [np.asarray(d).astype(dtype) for d in data]
    return np.asarray(data[idx]).astype(dtype)


def _open_h5(path):
    import h5py
    return h5py.File(path, 'r', libver='latest', swmr=True)


class SingleSessionDataset:
    """One session's trial store; lazy (per-trial HDF5 reads) or fully in RAM
    (``batch_load=False``). JAX: data/generator.py:83.

    Image-like signals ('images', 'masks', 'labels_sc') are returned NHWC;
    'images' stay uint8.
    """

    _h5_signals = ('images', 'masks', 'neural', 'labels', 'labels_sc', 'labels_masks')
    _pkl_signals = tuple(_PKL_KEYS)

    def __init__(self, data_dir, lab='', expt='', animal='', session='', signals=None,
                 transforms=None, paths=None, batch_load=True):
        self.lab = lab
        self.expt = expt
        self.animal = animal
        self.session = session
        self.data_dir = os.path.join(data_dir, lab, expt, animal, session)
        self.name = os.path.join(lab, expt, animal, session)
        self.sess_str = '%s_%s_%s_%s' % (lab, expt, animal, session)

        self.signals = list(signals)
        unported = [s for s in self.signals
                    if s not in self._h5_signals + self._pkl_signals]
        if unported:
            raise NotImplementedError('signals %s (export pickles) are not ported yet'
                                      % unported)
        self.transforms = OrderedDict()
        self.paths = OrderedDict()
        for signal, transform, path in zip(signals, transforms, paths):
            self.transforms[signal] = transform
            self.paths[signal] = path

        # total trials from the first countable signal
        self.n_trials = None
        for signal in self.signals:
            if signal in ('images', 'neural', 'labels', 'labels_sc', 'labels_masks'):
                with _open_h5(self.paths[signal]) as f:
                    self.n_trials = len(f[signal])
                break
            elif signal in self._pkl_signals:
                self.n_trials = len(self._read_pkl(signal))
                break

        # set by ConcatSessionsGenerator
        self.batch_idxs = None
        self.n_batches = None

        self.batch_load = batch_load
        self._cache = None
        if not batch_load:
            self._cache = {s: self._read_pkl(s) if s in self._pkl_signals else
                           [self._load_signal_trial(s, tr) for tr in range(self.n_trials)]
                           for s in self.signals}

    def __len__(self):
        return self.n_trials

    def __str__(self):
        fmt = '%s\n' % self.sess_str
        fmt += '    signals: {}\n'.format(self.signals)
        fmt += '    transforms: {}\n'.format(self.transforms)
        fmt += '    paths: {}\n'.format(self.paths)
        return fmt

    def _read_h5_trial(self, signal, idx):
        with _open_h5(self.paths[signal]) as f:
            return f[signal]['trial_%04i' % idx][()]

    def _read_pkl(self, signal, idx=None):
        """Every trial (or trial ``idx``) of a pickle-backed signal, its
        transform applied (JAX: data/generator.py:198-241)."""
        key, dtype = _PKL_KEYS[signal]
        try:
            data = _load_pkl(self.paths[signal], key, dtype, idx=idx)
        except FileNotFoundError:
            raise NotImplementedError('Could not open %s\nMust create %s from model'
                                      % (self.paths[signal], key))
        transform = self.transforms.get(signal)
        if transform is None:
            return data

        def post(d):
            d = transform(d)
            # a one-hot transform widens int state vectors to (T, K) floats
            return d.astype('float32') if d.ndim > 1 and dtype == 'int32' else d.astype(dtype)
        return post(data) if idx is not None else [post(d) for d in data]

    def _load_signal_trial(self, signal, idx):
        """Load a single trial of one signal; returns numpy array."""
        if signal in self._pkl_signals:
            return self._read_pkl(signal, idx)
        if signal == 'images':
            return _to_nhwc(self._read_h5_trial(signal, idx))
        arr = self._read_h5_trial(signal, idx).astype('float32')
        if self.transforms.get(signal) is not None:
            arr = self.transforms[signal](arr).astype('float32')
        if signal in ('masks', 'labels_sc') and arr.ndim == 4:
            return _to_nhwc(arr)
        return arr

    def __getitem__(self, idx):
        sample = OrderedDict()
        for signal in self.signals:
            if self._cache is not None:
                sample[signal] = self._cache[signal][idx]
            else:
                sample[signal] = self._load_signal_trial(signal, idx)
        sample['batch_idx'] = idx
        return sample


class ConcatSessionsGenerator(object):
    """Serves single-trial batches drawn across sessions (JAX:
    data/generator.py:254; reference :432)."""

    _dtypes = {'train', 'val', 'test'}

    def __init__(self, data_dir, ids_list, signals_list=None, transforms_list=None,
                 paths_list=None, batch_load=True, rng_seed=0, trial_splits=None,
                 train_frac=1.0):
        if isinstance(ids_list, dict):
            ids_list = [ids_list]
        self.ids = ids_list
        self.batch_load = batch_load

        self.datasets = []
        self.datasets_info = []
        self.signals = signals_list
        self.transforms = transforms_list
        self.paths = paths_list
        for ids, signals, transforms, paths in zip(
                ids_list, signals_list, transforms_list, paths_list):
            self.datasets.append(SingleSessionDataset(
                data_dir, lab=ids['lab'], expt=ids['expt'], animal=ids['animal'],
                session=ids['session'], signals=signals, transforms=transforms, paths=paths,
                batch_load=batch_load))
            self.datasets_info.append({
                'lab': ids['lab'], 'expt': ids['expt'], 'animal': ids['animal'],
                'session': ids['session']})

        self.n_datasets = len(self.datasets)

        if trial_splits is None:
            trial_splits = {'train_tr': 8, 'val_tr': 1, 'test_tr': 1, 'gap_tr': 0}
        self.batch_ratios = [None] * self.n_datasets
        for i, dataset in enumerate(self.datasets):
            dataset.batch_idxs = split_trials(len(dataset), rng_seed=rng_seed, **trial_splits)
            dataset.n_batches = {}
            for dtype in self._dtypes:
                if dtype == 'train':
                    if train_frac != 1.0:
                        n_batches = len(dataset.batch_idxs[dtype])
                        if train_frac < 1.0:
                            n_idxs = int(np.floor(train_frac * n_batches))
                            if n_idxs <= 0:
                                print('warning: attempting to use invalid number of training '
                                      'batches; defaulting to all training batches')
                                n_idxs = n_batches
                        else:
                            train_frac = n_batches if train_frac > n_batches else train_frac
                            n_idxs = int(train_frac)
                        idxs_rand = np.random.choice(n_batches, size=n_idxs, replace=False)
                        dataset.batch_idxs[dtype] = dataset.batch_idxs[dtype][idxs_rand]
                    self.batch_ratios[i] = len(dataset.batch_idxs[dtype])
                dataset.n_batches[dtype] = len(dataset.batch_idxs[dtype])
        self.batch_ratios = np.array(self.batch_ratios) / np.sum(self.batch_ratios)

        self.n_tot_batches = {}
        for dtype in self._dtypes:
            self.n_tot_batches[dtype] = int(np.sum(
                [dataset.n_batches[dtype] for dataset in self.datasets]))

        # per-dataset shuffled iteration state; each dtype owns a private
        # RNG stream seeded from the global stream at reset, so a prefetch
        # thread cannot perturb the order
        self._iter_order = [dict() for _ in range(self.n_datasets)]
        self._iter_pos = [dict() for _ in range(self.n_datasets)]
        self._choice_rng = {}
        self.reset_iterators('all')

    def __str__(self):
        fmt = 'Generator contains %i SingleSessionDataset objects:\n' % self.n_datasets
        for dataset in self.datasets:
            fmt += dataset.__str__()
        return fmt

    def __len__(self):
        return self.n_datasets

    def reset_iterators(self, dtype):
        """Reshuffle trial order and rewind; dtype in {'train','val','test','all'}."""
        dtypes = self._dtypes if dtype == 'all' else [dtype]
        for dt in dtypes:
            self._choice_rng[dt] = np.random.RandomState(np.random.randint(0, 2 ** 31 - 1))
        for i, dataset in enumerate(self.datasets):
            for dt in dtypes:
                self._iter_order[i][dt] = np.random.permutation(dataset.batch_idxs[dt])
                self._iter_pos[i][dt] = 0

    def _next_from(self, dataset_idx, dtype):
        pos = self._iter_pos[dataset_idx][dtype]
        order = self._iter_order[dataset_idx][dtype]
        if pos >= len(order):
            raise StopIteration
        self._iter_pos[dataset_idx][dtype] = pos + 1
        return self.datasets[dataset_idx][int(order[pos])]

    def next_batch(self, dtype):
        """Next (sample, dataset_idx); sessions drawn by batch-ratio multinomial."""
        rng = self._choice_rng.get(dtype, np.random)
        while True:
            dataset = int(rng.choice(np.arange(self.n_datasets), p=self.batch_ratios))
            try:
                sample = self._next_from(dataset, dtype)
                break
            except StopIteration:
                continue
        return sample, dataset
