"""Signal/path resolution wiring model classes to data sources.

The port's copy of the parts of ``behavenet_tpu/data/utils.py`` (reference
behavenet/data/utils.py) for the model classes the port fits: the
autoencoders ``'ae'``, ``'vae'``, ``'beta-tcvae'`` and ``'ps-vae'`` (video
frames, labels) and the segmentation models ``'arhmm'`` / ``'hmm'`` (AE
latents from an experiment-store latents pickle) and ``'arhmm-labels'`` /
``'hmm-labels'`` (labels). Other model classes raise
``NotImplementedError`` until their slice is ported.
"""

import os

__all__ = ['get_data_generator_inputs', 'build_data_generator', 'check_same_training_split',
           'get_latents_path']

_IMAGES_ONLY = ('ae', 'vae', 'beta-tcvae')
_WITH_LABELS = ('ps-vae',)
_ON_LATENTS = ('arhmm', 'hmm')
_ON_LABELS = ('arhmm-labels', 'hmm-labels')


def get_data_generator_inputs(hparams, sess_ids):
    """Per-session (signals, transforms, paths) of the model class
    (JAX: data/utils.py:17-56, :152-174; reference :15-339)."""
    mc = hparams['model_class']
    if mc not in _IMAGES_ONLY + _WITH_LABELS + _ON_LATENTS + _ON_LABELS:
        raise NotImplementedError('model_class "%s" is not ported yet' % mc)
    if hparams.get('conditional_encoder', False):
        raise NotImplementedError('a conditional encoder is not ported yet')
    signals_list, transforms_list, paths_list = [], [], []
    for sess_id in sess_ids:
        hdf5 = os.path.join(
            hparams['data_dir'], sess_id['lab'], sess_id['expt'],
            sess_id['animal'], sess_id['session'], 'data.hdf5')
        if mc in _ON_LATENTS + _ON_LABELS:
            if mc in _ON_LATENTS:
                signals = ['ae_latents']
                transforms, paths = [None], [get_latents_path(hparams, sess_id)]
            else:
                signals, transforms, paths = ['labels'], [None], [hdf5]
            for flag, signal in (('load_videos', 'images'), ('use_output_mask', 'masks')):
                if hparams.get(flag, False):
                    signals.append(signal)
                    transforms.append(None)
                    paths.append(hdf5)
            signals_list.append(signals)
            transforms_list.append(transforms)
            paths_list.append(paths)
            continue
        signals = ['images'] if mc in _IMAGES_ONLY else ['images', 'labels']
        if hparams.get('use_output_mask', False):
            signals.append('masks')
        if mc == 'ps-vae' and hparams.get('use_label_mask', False):
            signals.append('labels_masks')
        transforms, paths = [None] * len(signals), [hdf5] * len(signals)
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


def check_same_training_split(model_path, hparams):
    """Ensure the data rng seed and trial splits match an upstream model's
    (JAX: data/utils.py:263; reference :397)."""
    import pickle
    with open(os.path.join(os.path.dirname(model_path), 'meta_tags.pkl'), 'rb') as f:
        import_params = pickle.load(f)
    if import_params['rng_seed_data'] != hparams['rng_seed_data'] and \
            hparams.get('check_rng_seed_data', True):
        raise ValueError('Different data random seed from existing models')
    if import_params['trial_splits'] != hparams['trial_splits'] and \
            hparams.get('check_trial_splits', True):
        raise ValueError('Different trial split from existing models')


def get_latents_path(hparams, sess_id):
    """The AE latents pickle of a session (the ``'ae_latents'`` branch of
    JAX: data/utils.py:276 get_transforms_paths; reference :412-605): the
    ``ae_latents_file`` hparam, else the one of the upstream AE's version
    (``ae_version``, or the best one by val loss when ``"best"``). Its
    version must share this run's data seed and trial splits."""
    from behavenet_tpu_torch.fitting.experiment import get_best_model_version, get_expt_dir

    if 'ae_latents_file' in hparams:
        path = hparams['ae_latents_file']
    else:
        ae_dir = get_expt_dir(
            hparams, model_class=hparams['ae_model_class'],
            expt_name=hparams['ae_experiment_name'],
            model_type=hparams['ae_model_type'])
        if 'ae_version' in hparams and hparams['ae_version'] != 'best':
            if isinstance(hparams['ae_version'], str):
                hparams['ae_version'] = int(hparams['ae_version'])
            ae_version = 'version_%i' % hparams['ae_version']
        else:
            ae_version = 'version_%i' % get_best_model_version(ae_dir, 'val_loss')[0]
        path = os.path.join(ae_dir, ae_version, '%s_%s_%s_%s_latents.pkl' % (
            sess_id['lab'], sess_id['expt'], sess_id['animal'], sess_id['session']))
    check_same_training_split(path, hparams)
    return path
