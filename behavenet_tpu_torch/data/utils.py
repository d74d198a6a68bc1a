"""Signal/path resolution wiring model classes to data sources.

The port's copy of the conv-AE part of ``behavenet_tpu/data/utils.py``
(reference behavenet/data/utils.py). Model classes other than ``'ae'``
raise ``NotImplementedError`` until their slice is ported.
"""

import os

__all__ = ['get_data_generator_inputs', 'build_data_generator']


def get_data_generator_inputs(hparams, sess_ids):
    """Per-session (signals, transforms, paths) of the model class
    (JAX: data/utils.py:17; reference :15-339)."""
    if hparams['model_class'] != 'ae':
        raise NotImplementedError('model_class "%s" is not ported yet'
                                  % hparams['model_class'])
    signals_list, transforms_list, paths_list = [], [], []
    for sess_id in sess_ids:
        hdf5 = os.path.join(
            hparams['data_dir'], sess_id['lab'], sess_id['expt'],
            sess_id['animal'], sess_id['session'], 'data.hdf5')
        signals, transforms, paths = ['images'], [None], [hdf5]
        if hparams.get('use_output_mask', False):
            signals.append('masks')
            transforms.append(None)
            paths.append(hdf5)
        signals_list.append(signals)
        transforms_list.append(transforms)
        paths_list.append(paths)
    return hparams, signals_list, transforms_list, paths_list


def build_data_generator(hparams, sess_ids, export_csv=True):
    """Build a multi-session data generator from hparams (JAX: data/utils.py:229)."""
    from behavenet_tpu_torch.data.generator import ConcatSessionsGenerator
    from behavenet_tpu_torch.fitting.experiment import export_session_info_to_csv
    if hparams.get('n_sessions_per_batch', 1) != 1:
        raise NotImplementedError('n_sessions_per_batch > 1 (MSPS-VAE) is not ported yet')
    hparams, signals, transforms, paths = get_data_generator_inputs(hparams, sess_ids)
    if hparams.get('trial_splits', None) is not None:
        trs = [int(tr) for tr in hparams['trial_splits'].split(';')]
        trial_splits = {'train_tr': trs[0], 'val_tr': trs[1], 'test_tr': trs[2],
                        'gap_tr': trs[3]}
    else:
        trial_splits = None
    data_generator = ConcatSessionsGenerator(
        hparams['data_dir'], sess_ids,
        signals_list=signals, transforms_list=transforms, paths_list=paths,
        batch_load=hparams.get('batch_load', True), rng_seed=hparams['rng_seed_data'],
        trial_splits=trial_splits, train_frac=hparams.get('train_frac', 1.0))
    if export_csv:
        export_session_info_to_csv(os.path.join(
            hparams['expt_dir'], 'version_%i' % hparams['version']), sess_ids)
    return data_generator
