"""Export of a fitted model's outputs (the port of the autoencoder, ARHMM
and decoder parts of ``behavenet_tpu/fitting/eval.py``; reference
behavenet/fitting/eval.py).

``{lab}_{expt}_{animal}_{session}_latents.pkl`` holds ``'latents'`` (one
(T, n_latents) array per trial, empty for gap trials) and ``'trials'`` (the
train/val/test split), as the JAX package writes it: the AE's latents, the
posterior means of the VAE and beta-TC-VAE, ``[y, w]`` of the PS-VAE and
``[z_s, z_b, z_u]`` of the MSPS-VAE (JAX: eval.py:32-52), each model's
``latents``; the MSPS-VAE's over one train split of every trial.
``{lab}_{expt}_{animal}_{session}_states.pkl`` holds ``'states'`` (one
(T,) int32 Viterbi path per trial, empty for gap trials) and ``'trials'``.
``{lab}_{expt}_{animal}_{session}_predictions.pkl`` holds ``'predictions'``
(a decoder's (T, output_size) float32 predictions per trial, NaN in the
``n_max_lags`` frames at each end, empty for gap trials) and ``'trials'``.
"""

import os
import pickle

import numpy as np
import torch

from behavenet_tpu_torch.models import AE_MODELS

__all__ = ['export_latents', 'export_states', 'export_predictions']


def export_latents(data_generator, model, filename=None, version=None, expt_dir=None):
    """Encode every train/val/test trial with ``model`` (on its device, in
    eval mode: batch norm's running statistics) and pickle the latents per
    session (JAX: eval.py:55; reference eval.py:6-118)."""
    if model.hparams['model_class'] not in AE_MODELS:
        raise NotImplementedError('exporting latents of model_class "%s" is not '
                                  'ported yet' % model.hparams['model_class'])
    if model.hparams['model_class'] == 'msps-vae':
        # a single-session generator over every trial (JAX: eval.py:62-70;
        # reference vaes.py:1200-1273)
        from behavenet_tpu_torch.data.utils import build_data_generator
        hp_new = dict(model.hparams, n_sessions_per_batch=1, train_frac=1,
                      trial_splits='1;0;0;0')
        data_generator = build_data_generator(hp_new, data_generator.datasets_info,
                                              export_csv=False)
    device = next(model.parameters()).device
    model.eval()
    latents = [[np.array([]) for _ in range(dataset.n_trials)]
               for dataset in data_generator.datasets]

    for dtype in ['train', 'val', 'test']:
        data_generator.reset_iterators(dtype)
        for _ in range(data_generator.n_tot_batches[dtype]):
            data, sess = data_generator.next_batch(dtype)
            with torch.no_grad():
                z = model.latents(torch.from_numpy(data['images']).to(device))
            latents[sess][data['batch_idx']] = z.cpu().numpy()

    expt_dir = expt_dir if expt_dir is not None else model.hparams['expt_dir']
    version = version if version is not None else getattr(model, 'version')
    return _save_per_session(data_generator, latents, 'latents', expt_dir, version, filename)


def _save_per_session(data_generator, per_trial, key, expt_dir, version, filename):
    """Pickle ``{key: per_trial[sess], 'trials': ...}`` for each session."""
    filenames = []
    for sess, dataset in enumerate(data_generator.datasets):
        if filename is None:
            sess_id = '%s_%s_%s_%s_%s.pkl' % (
                dataset.lab, dataset.expt, dataset.animal, dataset.session, key)
            filename_save = os.path.join(expt_dir, 'version_%i' % version, sess_id)
        else:
            filename_save = filename
        print('saving %s %i of %i to %s' % (
            key, sess + 1, data_generator.n_datasets, filename_save))
        with open(filename_save, 'wb') as f:
            pickle.dump({key: per_trial[sess], 'trials': dataset.batch_idxs}, f)
        filenames.append(filename_save)
    return filenames


def export_predictions(data_generator, model, filename=None, version=None, expt_dir=None):
    """Pickle a decoder's predictions of every train/val/test trial per
    session, NaN in the lag borders (JAX: eval.py:142; reference
    eval.py:191-283); each trial in one forward pass on the model's device,
    unpadded as JAX runs it (an LSTM's reversed chain starts at its last
    frame)."""
    device = next(model.parameters()).device
    hp = model.hparams
    max_lags = int(hp['n_max_lags'])
    predictions = [[np.array([]) for _ in range(dataset.n_trials)]
                   for dataset in data_generator.datasets]
    for dtype in ['train', 'val', 'test']:
        data_generator.reset_iterators(dtype)
        for _ in range(data_generator.n_tot_batches[dtype]):
            data, sess = data_generator.next_batch(dtype)
            trial_len = data[hp['output_signal']].shape[0]
            pred = np.full((trial_len, int(hp['output_size'])), np.nan, dtype='float32')
            with torch.no_grad():
                out = model.predict(torch.from_numpy(
                    np.asarray(data[hp['input_signal']], dtype=np.float32)).to(device))
            pred[max_lags:trial_len - max_lags] = \
                out.cpu().numpy()[max_lags:trial_len - max_lags]
            predictions[sess][data['batch_idx']] = pred

    expt_dir = expt_dir if expt_dir is not None else hp['expt_dir']
    version = version if version is not None else getattr(model, 'version')
    return _save_per_session(data_generator, predictions, 'predictions', expt_dir,
                             version, filename)


def export_states(hparams, data_generator, model, filename=None):
    """Pickle the most likely state path of every train/val/test trial per
    session (JAX: eval.py:108; reference eval.py:121-188). The paths of a
    session's trials come from one batched Viterbi launch on the model's
    device."""
    data_key = 'labels' if hparams['model_class'].find('label') > -1 else 'ae_latents'
    states = [[np.array([]) for _ in range(dataset.n_trials)]
              for dataset in data_generator.datasets]
    for sess, dataset in enumerate(data_generator.datasets):
        idxs = [int(i) for dtype in ('train', 'val', 'test')
                for i in dataset.batch_idxs[dtype]]
        paths = model.most_likely_states_batch(
            [np.asarray(dataset[i][data_key]) for i in idxs])
        for i, path in zip(idxs, paths):
            states[sess][i] = path

    return _save_per_session(data_generator, states, 'states', hparams['expt_dir'],
                             hparams['version'], filename)
