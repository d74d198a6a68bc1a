"""Per-signal numpy transforms applied at load time.

The port's copy of ``behavenet_tpu/data/transforms.py`` (semantics of the
reference's behavenet/data/transforms.py); they run on the host, before
batches go to the device.
"""

import numpy as np

__all__ = ['Compose', 'Transform', 'BlockShuffle', 'ClipNormalize', 'MakeOneHot',
           'MakeOneHot2D', 'MotionEnergy', 'SelectIdxs', 'Threshold', 'ZScore']


class Transform(object):
    """Abstract base class for transforms."""

    def __call__(self, *args):
        raise NotImplementedError

    def __repr__(self):
        raise NotImplementedError


class Compose(Transform):
    """Chain several transforms (reference transforms.py:10)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, signal):
        for t in self.transforms:
            signal = t(signal)
        return signal

    def __repr__(self):
        return 'Compose(%s)' % ', '.join(repr(t) for t in self.transforms)


class BlockShuffle(Transform):
    """Shuffle runs of contiguous discrete states within a trial (reference :58).

    Used as a null control for decoding ARHMM states.
    """

    def __init__(self, rng_seed):
        self.rng_seed = rng_seed

    def __call__(self, sample):
        np.random.seed(self.rng_seed)
        n_time = len(sample)
        if not any(np.isnan(sample)):
            state_change = np.where(np.concatenate([[0], np.diff(sample)]) != 0)[0]
            runs = []
            prev_beg = 0
            for curr_beg in state_change:
                runs.append(np.arange(prev_beg, curr_beg))
                prev_beg = curr_beg
            runs.append(np.arange(prev_beg, n_time))
            rand_perm = np.random.permutation(len(runs))
            sample_shuff = sample[np.concatenate([runs[i] for i in rand_perm])]
        else:
            sample_shuff = np.full(n_time, fill_value=np.nan)
        return sample_shuff

    def __repr__(self):
        return 'BlockShuffle(rng_seed=%i)' % self.rng_seed


class ClipNormalize(Transform):
    """Clip upper level of signal and divide by clip value (reference :112)."""

    def __init__(self, clip_val):
        if clip_val <= 0:
            raise ValueError('clip value must be positive')
        self.clip_val = clip_val

    def __call__(self, signal):
        return np.minimum(signal, self.clip_val) / self.clip_val

    def __repr__(self):
        return 'ClipNormalize(clip_val=%f)' % self.clip_val


class MakeOneHot(Transform):
    """Categorical vector (time,) -> one-hot (time, K) (reference :149).

    ``n_classes`` fixes the output width; without it K is inferred per
    trial from the max label, which breaks batch-to-batch shape
    consistency when a trial does not visit every state.
    """

    def __init__(self, n_classes=None):
        self.n_classes = n_classes

    def __call__(self, sample):
        if len(sample.shape) == 2:  # already one-hot
            return sample
        n_time = len(sample)
        n_classes = self.n_classes or int(np.nanmax(sample)) + 1
        onehot = np.zeros((n_time, n_classes), dtype='float32')
        if not any(np.isnan(sample)):
            onehot[np.arange(n_time), sample.astype('int')] = 1
        else:
            onehot[:] = np.nan
        return onehot

    def __repr__(self):
        return 'MakeOneHot()'


class MakeOneHot2D(Transform):
    """Continuous (x, y) label coordinates -> spatial one-hot maps (reference :186).

    Input (time, 2*n_labels) with x values first; output
    (time, n_labels, y_pix, x_pix) with a single 1 at each label's position.
    """

    def __init__(self, y_pixels, x_pixels):
        self.y_pixels = y_pixels
        self.x_pixels = x_pixels

    def __call__(self, sample):
        time, n_labels_ = sample.shape
        n_labels = int(n_labels_ / 2)
        labels_2d = np.zeros((time, n_labels, self.y_pixels, self.x_pixels))

        x_vals = np.array(sample[:, :n_labels], dtype=float)
        x_vals[np.isnan(x_vals)] = -1
        x_vals = np.clip(x_vals, 0, self.x_pixels - 1)
        x_vals = np.round(x_vals).astype(int)

        y_vals = np.array(sample[:, n_labels:], dtype=float)
        y_vals[np.isnan(y_vals)] = -1
        y_vals = np.clip(y_vals, 0, self.y_pixels - 1)
        y_vals = np.round(y_vals).astype(int)

        for n in range(n_labels):
            labels_2d[np.arange(time), n, y_vals[:, n], x_vals[:, n]] = 1
        return labels_2d

    def __repr__(self):
        return 'MakeOneHot2D(y_pixels=%i, x_pixels=%i)' % (self.y_pixels, self.x_pixels)


class MotionEnergy(Transform):
    """|diff| over time, zero-padded at t=0 (reference :251)."""

    def __call__(self, sample):
        return np.vstack([np.zeros((1, sample.shape[1])), np.abs(np.diff(sample, axis=0))])

    def __repr__(self):
        return 'MotionEnergy()'


class SelectIdxs(Transform):
    """Index-based subsampling of neural channels (reference :277)."""

    def __init__(self, idxs, sample_name=''):
        self.sample_name = sample_name
        self.idxs = idxs

    def __call__(self, sample):
        return sample[:, self.idxs]

    def __repr__(self):
        return 'SelectIdxs(idxs=idxs, sample_name=%s)' % self.sample_name


class Threshold(Transform):
    """Drop channels whose mean firing rate is below a threshold (reference :313)."""

    def __init__(self, threshold, bin_size):
        if bin_size <= 0:
            raise ValueError('bin size must be positive')
        if threshold < 0:
            raise ValueError('threshold must be non-negative')
        self.threshold = threshold
        self.bin_size = bin_size

    def __call__(self, sample):
        frs = np.squeeze(np.mean(sample, axis=0)) / (self.bin_size * 1e-3)
        fr_mask = frs > self.threshold
        return sample[:, fr_mask].astype(float)

    def __repr__(self):
        return 'Threshold(threshold=%f, bin_size=%f)' % (self.threshold, self.bin_size)


class ZScore(Transform):
    """Z-score each channel over the trial (reference :360)."""

    def __call__(self, sample):
        sample = sample - np.mean(sample, axis=0)
        sample = sample / np.std(sample, axis=0)
        return sample

    def __repr__(self):
        return 'ZScore()'
