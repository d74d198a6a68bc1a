"""CLI: fit neural <-> latents / states / labels decoders over a
hyperparameter grid, in PyTorch.

The port of ``behavenet_tpu/fitting/decoder_grid_search.py`` (reference
behavenet/fitting/decoder_grid_search.py), for the MLP decoders
(``model_type`` ``'mlp'``, or ``'mlp-mv'`` for a full-covariance Gaussian)
and the LSTM decoder (``'lstm'``) of ``model_class`` ``'neural-ae'``,
``'neural-ae-me'``, ``'ae-neural'``, ``'neural-labels'``,
``'labels-neural'``, ``'neural-arhmm'`` and ``'arhmm-neural'``::

    python -m behavenet_tpu_torch.fitting.decoder_grid_search \
        --data_config d.json --model_config m.json \
        --training_config t.json --compute_config c.json

It trains on the GPU unless the compute config sets ``"device": "cpu"``.
The neural activity comes from the session's HDF5 store (``h5py``), the AE
latents or ARHMM states from the upstream version's pickle. It writes the
version the JAX CLI writes (``meta_tags.pkl`` with the upstream artifact
paths, ``metrics.csv``, ``best_val_model.pt`` in the JAX package's layout
and, with ``export_predictions``, the predictions pickle), which both
packages load. Use a ``save_dir`` of its own: the two CLIs would otherwise
dedup each other's versions.
"""

import os

from behavenet_tpu_torch.data.utils import SIGNAL_WIDTHS, build_data_generator
from behavenet_tpu_torch.fitting.experiment import (
    _clean_dir, create_experiment, export_hparams)
from behavenet_tpu_torch.fitting.hyperparams import (
    get_all_params, print_hparams, run_grid_search)
from behavenet_tpu_torch.fitting.training import fit
from behavenet_tpu_torch.models.base import params_finite
from behavenet_tpu_torch.models.decoders import DECODER_CLASSES, Decoder
from behavenet_tpu_torch.utils import pickles
from behavenet_tpu_torch.utils.device import resolve_device

__all__ = ['main', 'cli']


def main(hparams, *args):
    """Fit one decoder grid trial (JAX: decoder_grid_search.py:21; reference
    :19-111)."""
    if not isinstance(hparams, dict):
        hparams = vars(hparams)
    mc = hparams['model_class']
    if mc not in DECODER_CLASSES:
        raise ValueError('%s is an invalid model class' % mc)
    resolve_device(hparams.get('device'))  # fail before any work

    print_hparams(hparams)

    hparams, sess_ids, exp = create_experiment(hparams)
    if hparams is None:
        print('Experiment exists! Aborting fit')
        return

    data_generator = build_data_generator(hparams, sess_ids)

    # sizes from an example trial (a neural input's output_size is set with
    # the data generator's inputs)
    dataset = data_generator.datasets[0]
    example = dataset[int(dataset.batch_idxs['train'][0])]
    i_sig, o_sig = hparams['input_signal'], hparams['output_signal']
    if i_sig == 'neural':
        hparams['input_size'] = example[i_sig].shape[1]
    else:
        hparams['input_size'] = hparams[SIGNAL_WIDTHS[i_sig]]
        hparams['output_size'] = example[o_sig].shape[1]

    # upstream artifact paths, for downstream chaining
    if 'ae_latents' in dataset.paths:
        hparams['ae_model_path'] = os.path.dirname(dataset.paths['ae_latents'])
        hparams['ae_model_latents_file'] = dataset.paths['ae_latents']
    elif 'arhmm_states' in dataset.paths:
        hparams['arhmm_model_path'] = os.path.dirname(dataset.paths['arhmm_states'])
        hparams['arhmm_model_states_file'] = dataset.paths['arhmm_states']
        with open(os.path.join(hparams['arhmm_model_path'], 'meta_tags.pkl'), 'rb') as f:
            tags = pickles.Unpickler(f).load()
        hparams['ae_model_latents_file'] = tags.get('ae_model_latents_file')

    print('constructing model...', end='')
    model = Decoder(hparams)
    model.version = exp.version

    hparams['training_completed'] = False
    export_hparams(hparams, exp)
    print('done')

    best_params = fit(hparams, model, data_generator, exp, method='nll')

    # a diverged fit is not a completed experiment
    ok = best_params is not None and params_finite(best_params)
    if not ok:
        print('WARNING: fit produced no finite best-val parameters; '
              'not marking experiment as completed')
    hparams['training_completed'] = ok
    export_hparams(hparams, exp)

    _clean_dir(hparams)


def cli():
    """Console entry point."""
    run_grid_search(main, get_all_params('grid_search'))


if __name__ == '__main__':
    cli()
