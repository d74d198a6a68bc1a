"""CLI: fit (AR)HMM segmentation models over a hyperparameter grid, in PyTorch.

The port of ``behavenet_tpu/fitting/arhmm_grid_search.py`` (reference
behavenet/fitting/arhmm_grid_search.py)::

    python -m behavenet_tpu_torch.fitting.arhmm_grid_search \
        --data_config d.json --model_config m.json \
        --training_config t.json --compute_config c.json

It fits on the GPU unless the compute config sets ``"device": "cpu"``, and
does what the JAX CLI does: AE latents (``arhmm``/``hmm``) or labels
(``*-labels``) collected per split; the port's k-means initialization;
epoch 0 logs the initialized model, then one EM iteration per epoch with
per-datapoint train and val negative log-likelihoods for the aggregate
(dataset -1) and each session; relative-tolerance early stopping on the
val LL after epoch 10; per-trial test LLs; states sorted by Viterbi usage;
the model pickled into ``best_val_model.pt``; with ``export_states`` the
``<lab>_<expt>_<animal>_<session>_states.pkl`` of each session. Every
trial's frames go to the device once; the logged LLs run the forward pass
alone. A fit with non-finite parameters is not marked completed.

Every ``noise_type`` (``gaussian``, ``studentst`` and their diagonal forms)
and every ``transitions`` (``stationary``/``standard``, ``sticky``,
``recurrent``, ``recurrent_only``) is fitted, into the JAX CLI's
``<transitions>/<noise_type>`` directory. ``parallel_scan: true`` runs the
message passes as parallel-prefix scans (K13, K14). ``em_dtype: float64``
fits in float64: the latents are padded in float64, and the states and the
float64 model are written as for float32. On more than one CUDA device EM
is sharded over the trials (``parallel.make_mesh(axis_name='dp')``, as the
JAX CLI's multi-device branch; float64 EM stays on one device: a mesh in
float64 is ROADMAP A1c). Not ported, and raising ``NotImplementedError``:
``em_dtype: float64`` with ``parallel_scan: true`` (ROADMAP A1c) and
``export_train_plots``.
"""

import os
import pickle

import numpy as np
import torch

from behavenet_tpu_torch.data.utils import build_data_generator
from behavenet_tpu_torch.fitting.eval import export_states
from behavenet_tpu_torch.fitting.experiment import (
    _clean_dir, create_experiment, export_hparams)
from behavenet_tpu_torch.fitting.hyperparams import (
    get_all_params, print_hparams, run_grid_search)
from behavenet_tpu_torch.models.arhmm import ARHMM, check_ported
from behavenet_tpu_torch.parallel import make_mesh
from behavenet_tpu_torch.plotting.arhmm_utils import get_latent_arrays_by_dtype
from behavenet_tpu_torch.utils.device import resolve_device

__all__ = ['main', 'cli']

_OBS_TYPES = {  # noise_type -> (observations without lags, with lags)
    'gaussian': ('gaussian', 'ar'),
    'studentst': ('studentst', 'robust_ar'),
    'diagonal_gaussian': ('diagonal_gaussian', 'diagonal_ar'),
    'diagonal_studentst': ('diagonal_studentst', 'diagonal_robust_ar'),
}


def _em_mesh(device):
    """The mesh of EM (JAX: arhmm_grid_search.py:126-133): on more than one
    CUDA device, the trials sharded over all of them; else None."""
    if device.type == 'cuda' and torch.cuda.device_count() > 1:
        mesh = make_mesh(axis_name='dp')
        print('sharding EM over %i devices' % mesh.size)
        return mesh
    return None


def main(hparams, *args):
    """Fit one ARHMM grid trial (JAX: arhmm_grid_search.py:31; reference
    :20-234)."""
    if not isinstance(hparams, dict):
        hparams = vars(hparams)

    if hparams['transitions'] == 'sticky' and hparams['kappa'] == 0:
        print('Cannot fit sticky transitions with kappa=0! Aborting fit')
        return
    if hparams['transitions'] != 'sticky' and hparams['kappa'] > 0:
        print('Cannot fit %s transitions with kappa>0! Aborting fit' % hparams['transitions'])
        return
    if hparams['noise_type'] not in _OBS_TYPES:
        raise ValueError('%s is not a valid noise type' % hparams['noise_type'])
    if hparams['transitions'] not in ('stationary', 'standard', 'sticky', 'recurrent',
                                      'recurrent_only'):
        raise ValueError('%s is not a valid transition type' % hparams['transitions'])
    obs_type = _OBS_TYPES[hparams['noise_type']][int(hparams['n_arhmm_lags'] > 0)]
    transitions = 'stationary' if hparams['transitions'] == 'standard' \
        else hparams['transitions']
    if hparams.get('export_train_plots', False):
        raise NotImplementedError('training plots are not ported yet; set '
                                  '"export_train_plots": false')
    device = resolve_device(hparams.get('device'))   # fail before any work
    em_dtype = hparams.get('em_dtype', 'float32')
    check_ported(obs_type, transitions, em_dtype, bool(hparams.get('parallel_scan', False)))

    print_hparams(hparams)

    hparams, sess_ids, exp = create_experiment(hparams)
    if hparams is None:
        print('Experiment exists! Aborting fit')
        return

    data_generator = build_data_generator(hparams, sess_ids)

    # collect all observations into memory
    n_datasets = len(data_generator)
    print('collecting observations from data generator...', end='')
    data_key = 'labels' if hparams['model_class'].find('labels') > -1 else 'ae_latents'
    latents, trial_idxs = get_latent_arrays_by_dtype(
        data_generator, sess_idxs=list(range(n_datasets)), data_key=data_key)
    obs_dim = latents['train'][0].shape[1]
    hparams['total_train_length'] = int(np.sum([z.shape[0] for z in latents['train']]))
    latents_sess, trial_idxs_sess = {}, {}
    for d in range(n_datasets):
        latents_sess[d], trial_idxs_sess[d] = get_latent_arrays_by_dtype(
            data_generator, sess_idxs=d, data_key=data_key)
    print('done')

    if hparams['model_class'] in ('arhmm', 'hmm'):
        hparams['ae_model_path'] = os.path.dirname(
            data_generator.datasets[0].paths['ae_latents'])
        hparams['ae_model_latents_file'] = data_generator.datasets[0].paths['ae_latents']

    if hparams['n_arhmm_lags'] > 0:
        if hparams['model_class'][:5] != 'arhmm':
            raise ValueError('Must specify model_class as arhmm when using AR lags')
    elif hparams['model_class'][:3] != 'hmm':
        raise ValueError('Must specify model_class as hmm when using 0 AR lags')

    print('constructing model...', end='')
    np.random.seed(hparams['rng_seed_model'])
    hmm = ARHMM(
        hparams['n_arhmm_states'], obs_dim, lags=hparams['n_arhmm_lags'],
        observations=obs_type, transitions=transitions, kappa=hparams.get('kappa', 0),
        rng_seed=hparams['rng_seed_model'],
        parallel_scan=bool(hparams.get('parallel_scan', False)), dtype=em_dtype,
        device=device)
    hmm.initialize(latents['train'], localize=hparams['n_arhmm_lags'] > 0)
    hparams['training_completed'] = False
    export_hparams(hparams, exp)
    hmm.hparams = hparams
    print('done')

    # logging scopes: the aggregate row (dataset -1), then one row per
    # session, each with its splits padded and on the device once
    def normalized(arrs):
        return {dtype: (hmm.pad(arrs[dtype]), int(np.vstack(arrs[dtype]).size))
                for dtype in ('train', 'val')}
    scopes = [(-1, normalized(latents))]
    scopes += [(d, normalized(latents_sess[d])) for d in range(n_datasets)]
    train = scopes[0][1]['train'][0]
    mesh = _em_mesh(device) if em_dtype == 'float32' else None

    def neg_ll_rows(epoch):
        return [{'epoch': epoch, 'dataset': d, 'trial': -1,
                 'tr_loss': -hmm.log_likelihood(arrs['train'][0]) / arrs['train'][1],
                 'val_loss': -hmm.log_likelihood(arrs['val'][0]) / arrs['val'][1]}
                for d, arrs in scopes]

    tolerance = hparams.get('arhmm_es_tol', 0)
    val_ll_hist = []
    epoch = 0
    for epoch in range(hparams['n_iters'] + 1):
        print('epoch %03i/%03i' % (epoch, hparams['n_iters']))
        if epoch > 0:
            hmm.fit(train, method='em', num_iters=1, initialize=False, mesh=mesh)
        rows = neg_ll_rows(epoch)
        for row in rows:
            exp.log(row)
        val_ll_hist.append(rows[0]['val_loss'])
        if epoch > 10 and len(val_ll_hist) >= 2 and np.abs(
                (val_ll_hist[-1] - val_ll_hist[-2]) / val_ll_hist[-1]) < tolerance:
            print('relative val-LL change below tolerance=%1.2f; stopping EM' % tolerance)
            break

    # per-trial test LLs
    for d in range(n_datasets):
        for i, b in enumerate(trial_idxs_sess[d]['test']):
            n = latents_sess[d]['test'][i].size
            test_ll = -hmm.log_likelihood(latents_sess[d]['test'][i]) / n
            exp.log({'epoch': epoch, 'dataset': d, 'test_loss': test_ll, 'trial': int(b)})
    exp.save()

    # usage-sort the states by the Viterbi paths of the train trials
    zs = hmm.most_likely_states_batch(latents['train'])
    usage = np.bincount(np.concatenate(zs), minlength=hmm.K)
    hmm.permute(np.argsort(usage)[::-1])

    filepath = os.path.join(
        hparams['expt_dir'], 'version_%i' % exp.version, 'best_val_model.pt')
    with open(filepath, 'wb') as f:
        pickle.dump(hmm, f)

    if hparams.get('export_states', False):
        export_states(hparams, data_generator, hmm)

    # a diverged fit (non-finite params) is not a completed experiment;
    # leaving the flag False lets a re-run replace it instead of deduping
    finite = all(bool(v.isfinite().all()) for v in hmm.params.values())
    if not finite:
        print('WARNING: fit produced non-finite parameters; '
              'not marking experiment as completed')
    hparams['training_completed'] = finite
    export_hparams(hparams, exp)

    _clean_dir(hparams)


def cli():
    """Console entry point."""
    run_grid_search(main, get_all_params('grid_search'))


if __name__ == '__main__':
    cli()
