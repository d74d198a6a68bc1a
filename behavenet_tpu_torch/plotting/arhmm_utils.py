"""ARHMM helpers of ``behavenet_tpu/plotting/arhmm_utils.py`` that the
ARHMM CLI needs; the plots themselves are not ported."""

import numpy as np

__all__ = ['get_latent_arrays_by_dtype']


def get_latent_arrays_by_dtype(data_generator, sess_idxs=0, data_key='ae_latents'):
    """Per-split lists of trial arrays of ``data_key`` and their trial
    indices, over the sessions ``sess_idxs`` (JAX: plotting/arhmm_utils.py:56;
    reference :102-132)."""
    if isinstance(sess_idxs, int):
        sess_idxs = [sess_idxs]
    dtypes = ['train', 'val', 'test']
    latents = {key: [] for key in dtypes}
    trial_idxs = {key: [] for key in dtypes}
    for sess_idx in sess_idxs:
        dataset = data_generator.datasets[sess_idx]
        for data_type in dtypes:
            curr_idxs = dataset.batch_idxs[data_type]
            trial_idxs[data_type] += list(curr_idxs)
            latents[data_type] += [
                np.asarray(dataset[int(i_trial)][data_key]) for i_trial in curr_idxs]
    return latents, trial_idxs
