"""CLI: fit conv autoencoders over a hyperparameter grid, in PyTorch.

The port of ``behavenet_tpu/fitting/ae_grid_search.py`` (reference
behavenet/fitting/ae_grid_search.py), for ``model_class`` ``'ae'``,
``'vae'``, ``'beta-tcvae'``, ``'ps-vae'`` and ``'msps-vae'`` (with
``n_sessions_per_batch`` of 2-4 and a session list that many sessions long)::

    python -m behavenet_tpu_torch.fitting.ae_grid_search \
        --data_config d.json --model_config m.json \
        --training_config t.json --compute_config c.json

It trains on the GPU unless the compute config sets ``"device": "cpu"``,
and writes the experiment-store version the JAX CLI writes (``meta_tags.pkl``,
``metrics.csv``, ``best_val_model.pt`` in the JAX package's layout, the
latents pickle), which both packages load. Use a ``save_dir`` of its own:
the two CLIs would otherwise dedup each other's versions.
"""

from behavenet_tpu_torch.data.utils import build_data_generator
from behavenet_tpu_torch.fitting.experiment import (
    _clean_dir, create_experiment, export_hparams)
from behavenet_tpu_torch.fitting.hyperparams import (
    get_all_params, print_hparams, run_grid_search)
from behavenet_tpu_torch.fitting.training import fit
from behavenet_tpu_torch.models import AE_MODELS
from behavenet_tpu_torch.models.aes import load_pretrained_ae
from behavenet_tpu_torch.models.base import params_finite
from behavenet_tpu_torch.utils.device import resolve_device

__all__ = ['main', 'cli']


def _set_n_labels(data_generator, hparams):
    """The labels' width from one val batch (JAX: ae_grid_search.py:42)."""
    data, _ = data_generator.next_batch('val')
    if isinstance(data, list):
        data = data[0]
    hparams['n_labels'] = int(data['labels'].shape[1])
    data_generator.reset_iterators('val')


def main(hparams, *args):
    """Fit one grid trial (JAX: ae_grid_search.py:21; reference :20-146)."""
    if not isinstance(hparams, dict):
        hparams = vars(hparams)
    if hparams['model_class'] not in AE_MODELS:
        raise NotImplementedError('model_class "%s" is not ported yet'
                                  % hparams['model_class'])
    if hparams.get('export_train_plots', False):
        raise NotImplementedError('training plots are not ported yet; set '
                                  '"export_train_plots": false')
    resolve_device(hparams.get('device'))  # fail before any work

    if hparams['model_type'] == 'conv':
        # blend outer hparams with architecture hparams
        hparams = {**hparams['architecture_params'], **hparams}

    print_hparams(hparams)

    if hparams['model_type'] == 'conv' and hparams['n_ae_latents'] > hparams['max_latents']:
        raise ValueError('Number of latents higher than max latents, architecture will not work')

    hparams, sess_ids, exp = create_experiment(hparams)
    if hparams is None:
        print('Experiment exists! Aborting fit')
        return

    data_generator = build_data_generator(hparams, sess_ids)

    print('constructing model...', end='')
    hparams['n_datasets'] = len(sess_ids)
    if hparams['model_class'] in ('ps-vae', 'msps-vae'):
        _set_n_labels(data_generator, hparams)
    model = AE_MODELS[hparams['model_class']](hparams)
    model.version = exp.version

    hparams['training_completed'] = False
    export_hparams(hparams, exp)
    print('done')

    best_params = fit(hparams, model, data_generator, exp, method='ae',
                      warm_start=lambda params: load_pretrained_ae(params, model, hparams))

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
