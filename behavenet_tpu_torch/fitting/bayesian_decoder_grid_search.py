"""CLI: Bayesian decoding, fusing ARHMM dynamics with neural-decoder outputs,
in PyTorch.

The port of ``behavenet_tpu/fitting/bayesian_decoder_grid_search.py``::

    python -m behavenet_tpu_torch.fitting.bayesian_decoder_grid_search \
        --data_config d.json --model_config m.json \
        --training_config t.json --compute_config c.json

It decodes on the GPU unless the compute config sets ``"device": "cpu"``
(``"tpu"``, the JAX configs' value, is refused). It does what the JAX CLI
does: loads the fitted ARHMM that sits next to the upstream states pickle
(``best_val_model.pt``, written by either package's ARHMM CLI, through
``utils.pickles.load_arhmm``), estimates the neural predictions' observation
noise from the train trials' decoder residuals, decodes every trial with
:class:`~behavenet_tpu_torch.models.bayesian.BayesianDecoder` (each trial
NaN-padded to a multiple of ``shape_bucket`` frames, 32 by default, and cut
back after), logs the train and val decoding MSE and the per-trial test
MSE and R^2 to the experiment store, and exports the decoded latents and
states pickles in the standard formats. The inputs are export pickles only
(the AE latents, the two neural decoders' predictions and the ARHMM
states), so no HDF5 store is opened. Use a ``save_dir`` of its own: the two
CLIs would otherwise dedup each other's versions.

Model-config keys: the ae_*/arhmm_*/neural_* upstream selectors (as in the
decoder configs), plus optional ``state_evidence_weight`` (float, weight on
the neural state-decoder evidence), ``use_state_evidence`` (bool, default
true), ``smooth`` (bool, run the backward pass; default true) and
``parallel_scan`` (bool, decode with ``parallel=True``: the associative
Kalman filter and smoother and the parallel-prefix discrete pass; default
false).
"""

import os
import pickle

import numpy as np

from behavenet_tpu_torch.data.utils import build_data_generator
from behavenet_tpu_torch.fitting.experiment import (
    _clean_dir, create_experiment, export_hparams)
from behavenet_tpu_torch.fitting.hyperparams import (
    get_all_params, print_hparams, run_grid_search)
from behavenet_tpu_torch.models.bayesian import BayesianDecoder
from behavenet_tpu_torch.utils.device import resolve_device
from behavenet_tpu_torch.utils.pickles import load_arhmm

__all__ = ['main', 'cli']


def _softmax_rows(logits):
    """State-decoder logits -> probabilities; NaN border rows stay NaN."""
    logits = np.asarray(logits, dtype=np.float64)
    z = logits - np.nanmax(logits, axis=1, keepdims=True)
    e = np.exp(z)
    return (e / np.sum(e, axis=1, keepdims=True)).astype(np.float32)


def _decode_metrics(latents_true, latents_dec):
    """(MSE, variance-weighted R^2) over rows where the truth is finite."""
    good = np.all(np.isfinite(latents_true), axis=1) & \
        np.all(np.isfinite(latents_dec), axis=1)
    t, d = latents_true[good], latents_dec[good]
    mse = float(np.mean((t - d) ** 2))
    ss_res = np.sum((t - d) ** 2)
    ss_tot = np.sum((t - np.mean(t, axis=0)) ** 2)
    r2 = float(1.0 - ss_res / max(ss_tot, 1e-12))
    return mse, r2


def main(hparams, *args):
    """Run one bayesian-decoding trial over the four-signal generator (JAX:
    bayesian_decoder_grid_search.py:60)."""
    if not isinstance(hparams, dict):
        hparams = vars(hparams)
    device = resolve_device(hparams.get('device'))   # fail before any work
    print_hparams(hparams)

    hparams, sess_ids, exp = create_experiment(hparams)
    if hparams is None:
        print('Experiment exists! Aborting fit')
        return

    data_generator = build_data_generator(hparams, sess_ids)

    # the fitted ARHMM lives next to its exported states pickle
    arhmm_file = os.path.join(
        os.path.dirname(data_generator.datasets[0].paths['arhmm_states']),
        'best_val_model.pt')
    hmm = load_arhmm(arhmm_file, device=device)
    print('loaded ARHMM (K=%i, D=%i, lags=%i) from %s'
          % (hmm.K, hmm.D, hmm.lags, arhmm_file))

    hparams['training_completed'] = False
    export_hparams(hparams, exp)

    # ---- observation noise from train-trial decoder residuals
    lat_tr, pred_tr = [], []
    data_generator.reset_iterators('train')
    for _ in range(data_generator.n_tot_batches['train']):
        data, _ = data_generator.next_batch('train')
        lat_tr.append(np.asarray(data['ae_latents']))
        pred_tr.append(np.asarray(data['ae_predictions']))
    dec = BayesianDecoder(
        hmm, state_evidence_weight=hparams.get('state_evidence_weight', 1.0))
    dec.estimate_obs_noise(lat_tr, pred_tr)

    smooth = bool(hparams.get('smooth', True))
    parallel = bool(hparams.get('parallel_scan', False))
    use_state_evidence = bool(hparams.get('use_state_evidence', True))
    # length-bucket trials by NaN-padding: padded rows carry zero evidence,
    # which is exact for the valid prefix (a no-evidence future contributes
    # nothing to the smoothed past)
    bucket = int(hparams.get('shape_bucket', 32) or 0)

    def pad_nan(arr):
        T = arr.shape[0]
        if not bucket or T % bucket == 0:
            return arr
        pad = -(-T // bucket) * bucket - T
        return np.concatenate(
            [arr, np.full((pad,) + arr.shape[1:], np.nan, dtype=arr.dtype)])

    latents_out = [[np.array([]) for _ in range(ds.n_trials)]
                   for ds in data_generator.datasets]
    states_out = [[np.array([]) for _ in range(ds.n_trials)]
                  for ds in data_generator.datasets]

    for dtype in ('train', 'val', 'test'):
        data_generator.reset_iterators(dtype)
        mses = []
        for _ in range(data_generator.n_tot_batches[dtype]):
            data, sess = data_generator.next_batch(dtype)
            preds = np.asarray(data['ae_predictions'])
            T = preds.shape[0]
            q = _softmax_rows(data['arhmm_predictions']) if use_state_evidence else None
            out = dec.decode(pad_nan(preds),
                             arhmm_predictions=None if q is None else pad_nan(q),
                             smooth=smooth, parallel=parallel)
            trial = int(data['batch_idx'])
            latents_out[sess][trial] = out['latents'][:T]
            states_out[sess][trial] = out['states'][:T]
            mse, r2 = _decode_metrics(
                np.asarray(data['ae_latents']), latents_out[sess][trial])
            mses.append(mse)
            if dtype == 'test':
                exp.log({'epoch': 0, 'dataset': sess, 'trial': trial,
                         'test_loss': mse, 'test_r2': r2})
        prefix = {'train': 'tr', 'val': 'val', 'test': 'test'}[dtype]
        if dtype != 'test' and mses:
            exp.log({'epoch': 0, 'dataset': -1, 'trial': -1,
                     '%s_loss' % prefix: float(np.mean(mses))})
    exp.save()

    # ---- exports (standard pickle formats)
    version_dir = os.path.join(hparams['expt_dir'], 'version_%i' % exp.version)
    for sess, ds in enumerate(data_generator.datasets):
        sess_str = '%s_%s_%s_%s' % (ds.lab, ds.expt, ds.animal, ds.session)
        if hparams.get('export_latents', True):
            with open(os.path.join(version_dir, '%s_latents.pkl' % sess_str), 'wb') as f:
                pickle.dump({'latents': latents_out[sess],
                             'trials': ds.batch_idxs}, f)
        if hparams.get('export_states', True):
            with open(os.path.join(version_dir, '%s_states.pkl' % sess_str), 'wb') as f:
                pickle.dump({'states': states_out[sess],
                             'trials': ds.batch_idxs}, f)

    hparams['training_completed'] = True
    export_hparams(hparams, exp)
    _clean_dir(hparams)


def cli():
    """Console entry point."""
    run_grid_search(main, get_all_params('grid_search'))


if __name__ == '__main__':
    cli()
