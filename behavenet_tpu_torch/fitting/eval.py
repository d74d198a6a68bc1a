"""Export of a fitted model's outputs (the port of the AE part of
``behavenet_tpu/fitting/eval.py``; reference behavenet/fitting/eval.py).

``{lab}_{expt}_{animal}_{session}_latents.pkl`` holds ``'latents'`` (one
(T, n_latents) array per trial, empty for gap trials) and ``'trials'`` (the
train/val/test split), as the JAX package writes it.
"""

import os
import pickle

import numpy as np
import torch

__all__ = ['export_latents']


def export_latents(data_generator, model, filename=None, version=None, expt_dir=None):
    """Encode every train/val/test trial with ``model`` (on its device) and
    pickle the latents per session (JAX: eval.py:55; reference eval.py:6-118)."""
    if model.hparams['model_class'] != 'ae':
        raise NotImplementedError('exporting latents of model_class "%s" is not '
                                  'ported yet' % model.hparams['model_class'])
    device = next(model.parameters()).device
    latents = [[np.array([]) for _ in range(dataset.n_trials)]
               for dataset in data_generator.datasets]

    for dtype in ['train', 'val', 'test']:
        data_generator.reset_iterators(dtype)
        for _ in range(data_generator.n_tot_batches[dtype]):
            data, sess = data_generator.next_batch(dtype)
            with torch.no_grad():
                z = model.encode(torch.from_numpy(data['images']).to(device))
            latents[sess][data['batch_idx']] = z.cpu().numpy()

    expt_dir = expt_dir if expt_dir is not None else model.hparams['expt_dir']
    version = version if version is not None else getattr(model, 'version')

    filenames = []
    for sess, dataset in enumerate(data_generator.datasets):
        if filename is None:
            sess_id = '%s_%s_%s_%s_latents.pkl' % (
                dataset.lab, dataset.expt, dataset.animal, dataset.session)
            filename_save = os.path.join(expt_dir, 'version_%i' % version, sess_id)
        else:
            filename_save = filename
        print('saving latents %i of %i:\n%s' % (
            sess + 1, data_generator.n_datasets, filename_save))
        with open(filename_save, 'wb') as f:
            pickle.dump({'latents': latents[sess], 'trials': dataset.batch_idxs}, f)
        filenames.append(filename_save)
    return filenames
