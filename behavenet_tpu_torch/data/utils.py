"""Signal/path resolution wiring model classes to data sources.

The port's copy of the parts of ``behavenet_tpu/data/utils.py`` (reference
behavenet/data/utils.py) for the model classes the port fits: the
autoencoders ``'ae'``, ``'vae'``, ``'beta-tcvae'``, ``'ps-vae'`` and
``'msps-vae'`` (video frames, labels), the segmentation models ``'arhmm'``
/ ``'hmm'`` (AE latents from an experiment-store latents pickle) and
``'arhmm-labels'`` / ``'hmm-labels'`` (labels), the neural decoders (neural activity from the
HDF5 store against AE latents, labels or ARHMM states) and the Bayesian
decoder ``'bayesian-decoding'`` (AE latents, the neural decoders'
predictions and ARHMM states, all from export pickles). Other model
classes, and neural subsampling, raise ``NotImplementedError`` until their
slice is ported.
"""

import os

__all__ = ['get_data_generator_inputs', 'build_data_generator', 'check_same_training_split',
           'get_latents_path', 'get_states_path', 'get_predictions_path',
           'get_neural_transform', 'SIGNAL_WIDTHS']

_IMAGES_ONLY = ('ae', 'vae', 'beta-tcvae')
_WITH_LABELS = ('ps-vae', 'msps-vae')
_ON_LATENTS = ('arhmm', 'hmm')
_ON_LABELS = ('arhmm-labels', 'hmm-labels')
_BAYESIAN = 'bayesian-decoding'
# the hparam that holds the width of a decoder's non-neural signal
SIGNAL_WIDTHS = {'ae_latents': 'n_ae_latents', 'labels': 'n_labels',
                 'arhmm_states': 'n_arhmm_states'}


def get_neural_transform(hparams):
    """The transform of the neural signal (JAX: data/utils.py:288-317):
    ``Threshold`` of spikes when ``neural_thresh`` > 0, ``ZScore`` of calcium
    traces (unless ``model_type`` ends in 'neural', as JAX reads it),
    nothing for 'ca-zscored'."""
    from behavenet_tpu_torch.data.transforms import Compose, Threshold, ZScore
    if hparams.get('subsample_method', 'none') != 'none':
        raise NotImplementedError('neural subsampling is not ported yet')
    transforms = []
    if hparams['neural_type'] == 'spikes':
        if hparams['neural_thresh'] > 0:
            transforms.append(Threshold(threshold=hparams['neural_thresh'],
                                        bin_size=hparams['neural_bin_size']))
    elif hparams['neural_type'] == 'ca':
        if hparams['model_type'][-6:] != 'neural':
            transforms.append(ZScore())
    elif hparams['neural_type'] != 'ca-zscored':
        raise ValueError('"%s" is an invalid neural type' % hparams['neural_type'])
    return Compose(transforms) if transforms else None


def _decoder_inputs(hparams, sess_id, hdf5):
    """(signals, transforms, paths) of one session of a decoder, and its
    ``input_signal``, ``output_signal``, ``output_size`` and ``noise_dist``
    set in ``hparams`` (JAX: data/utils.py:68-150)."""
    from behavenet_tpu_torch.data.transforms import BlockShuffle, Compose, MakeOneHot, \
        MotionEnergy
    mc = hparams['model_class']
    gaussian = 'gaussian-full' if hparams['model_type'][-2:] == 'mv' else 'gaussian'
    other = mc.replace('neural', '').strip('-')            # 'ae', 'ae-me', 'labels', 'arhmm'
    signal = {'ae': 'ae_latents', 'ae-me': 'ae_latents', 'labels': 'labels',
              'arhmm': 'arhmm_states'}[other]
    if other.startswith('ae'):
        transform = MotionEnergy() if other == 'ae-me' else None
        path = get_latents_path(hparams, sess_id)
    elif other == 'labels':
        transform, path = None, hdf5
    else:
        transform = BlockShuffle(hparams['shuffle_rng_seed']) \
            if hparams.get('shuffle_rng_seed') is not None else None
        path = get_states_path(hparams, sess_id)

    if mc.startswith('neural-'):
        hparams['input_signal'], hparams['output_signal'] = 'neural', signal
        hparams['output_size'] = hparams[SIGNAL_WIDTHS[signal]]
        hparams['noise_dist'] = 'categorical' if other == 'arhmm' else gaussian
    else:
        hparams['input_signal'], hparams['output_signal'] = signal, 'neural'
        hparams['output_size'] = None
        if hparams['neural_type'] == 'ca':
            hparams['noise_dist'] = gaussian
        elif hparams['neural_type'] == 'spikes':
            hparams['noise_dist'] = 'poisson'
        if other == 'arhmm':
            # decoder inputs must be (time, K) one-hot; the reference ships
            # MakeOneHot but never wires it in (JAX :141-147 departs here)
            onehot = MakeOneHot(n_classes=hparams.get('n_arhmm_states'))
            transform = Compose([transform, onehot]) if transform else onehot
    return (['neural', signal], [get_neural_transform(hparams), transform], [hdf5, path])


def get_data_generator_inputs(hparams, sess_ids):
    """Per-session (signals, transforms, paths) of the model class
    (JAX: data/utils.py:17-174; reference :15-339)."""
    from behavenet_tpu_torch.models.decoders import DECODER_CLASSES
    mc = hparams['model_class']
    if mc not in _IMAGES_ONLY + _WITH_LABELS + _ON_LATENTS + _ON_LABELS + DECODER_CLASSES + \
            (_BAYESIAN,):
        raise NotImplementedError('model_class "%s" is not ported yet' % mc)
    if hparams.get('conditional_encoder', False):
        raise NotImplementedError('a conditional encoder is not ported yet')
    signals_list, transforms_list, paths_list = [], [], []
    for sess_id in sess_ids:
        hdf5 = os.path.join(
            hparams['data_dir'], sess_id['lab'], sess_id['expt'],
            sess_id['animal'], sess_id['session'], 'data.hdf5')
        if mc in DECODER_CLASSES:
            signals, transforms, paths = _decoder_inputs(hparams, sess_id, hdf5)
            signals_list.append(signals)
            transforms_list.append(transforms)
            paths_list.append(paths)
            continue
        if mc in _ON_LATENTS + _ON_LABELS + (_BAYESIAN,):
            if mc in _ON_LATENTS:
                signals = ['ae_latents']
                transforms, paths = [None], [get_latents_path(hparams, sess_id)]
            elif mc == _BAYESIAN:
                signals, transforms, paths = _bayesian_inputs(hparams, sess_id)
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


def _bayesian_inputs(hparams, sess_id):
    """(signals, transforms, paths) of one session of the Bayesian decoder
    (JAX: data/utils.py:176-185): the AE latents, the two neural decoders'
    predictions (of the session the hparams name, as in JAX) and the ARHMM
    states, block-shuffled when ``shuffle_rng_seed`` is set."""
    from behavenet_tpu_torch.data.transforms import BlockShuffle
    ae_path = get_latents_path(hparams, sess_id)
    states_path = get_states_path(hparams, sess_id)
    own = {key: hparams[key] for key in ('lab', 'expt', 'animal', 'session')}
    ae_pred = get_predictions_path(hparams, own, 'neural-ae')
    arhmm_pred = get_predictions_path(hparams, own, 'neural-arhmm')
    shuffle = BlockShuffle(hparams['shuffle_rng_seed']) \
        if hparams.get('shuffle_rng_seed') is not None else None
    return (['ae_latents', 'ae_predictions', 'arhmm_predictions', 'arhmm_states'],
            [None, None, None, shuffle], [ae_path, ae_pred, arhmm_pred, states_path])


def build_data_generator(hparams, sess_ids, export_csv=True):
    """Build a multi-session data generator from hparams (JAX: data/utils.py:229):
    with ``n_sessions_per_batch`` > 1 (the MSPS-VAE) one whose train batches
    hold trials of distinct sessions."""
    from behavenet_tpu_torch.data.generator import (
        ConcatSessionsGenerator, ConcatSessionsGeneratorMulti)
    from behavenet_tpu_torch.fitting.experiment import export_session_info_to_csv
    hparams, signals, transforms, paths = get_data_generator_inputs(hparams, sess_ids)
    if hparams.get('trial_splits', None) is not None:
        trs = [int(tr) for tr in hparams['trial_splits'].split(';')]
        trial_splits = {'train_tr': trs[0], 'val_tr': trs[1], 'test_tr': trs[2],
                        'gap_tr': trs[3]}
    else:
        trial_splits = None
    kwargs = dict(signals_list=signals, transforms_list=transforms, paths_list=paths,
                  batch_load=hparams.get('batch_load', True),
                  rng_seed=hparams['rng_seed_data'], trial_splits=trial_splits,
                  train_frac=hparams.get('train_frac', 1.0))
    if hparams.get('n_sessions_per_batch', 1) == 1:
        data_generator = ConcatSessionsGenerator(hparams['data_dir'], sess_ids, **kwargs)
    else:
        data_generator = ConcatSessionsGeneratorMulti(
            hparams['data_dir'], sess_ids,
            n_sessions_per_batch=hparams['n_sessions_per_batch'], **kwargs)
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


def get_states_path(hparams, sess_id):
    """The ARHMM states pickle of a session (the ``'arhmm_states'`` branch of
    JAX: data/utils.py:336-351): the ``arhmm_states_file`` hparam, else the
    one of the upstream ARHMM's version (``arhmm_version`` when an int, else
    the best one by val loss). Its version must share this run's data seed
    and trial splits."""
    from behavenet_tpu_torch.fitting.experiment import get_best_model_version, get_expt_dir

    if 'arhmm_states_file' in hparams:
        path = hparams['arhmm_states_file']
    else:
        arhmm_dir = get_expt_dir(hparams, model_class='arhmm',
                                 expt_name=hparams['arhmm_experiment_name'])
        if isinstance(hparams.get('arhmm_version'), int):
            version = 'version_%i' % hparams['arhmm_version']
        else:
            version = 'version_%i' % get_best_model_version(arhmm_dir, 'val_loss')[0]
        path = os.path.join(arhmm_dir, version, '%s_%s_%s_%s_states.pkl' % (
            sess_id['lab'], sess_id['expt'], sess_id['animal'], sess_id['session']))
    check_same_training_split(path, hparams)
    return path


def get_predictions_path(hparams, sess_id, model_class):
    """A neural decoder's predictions pickle of a session (the
    ``'neural_ae_predictions'`` and ``'neural_arhmm_predictions'`` branches
    of JAX: data/utils.py:353-386) for ``model_class`` ``'neural-ae'`` or
    ``'neural-arhmm'``: the ``ae_predictions_file`` / ``arhmm_predictions_file``
    hparam, else the one of the decoder's version (``neural_ae_version`` /
    ``neural_arhmm_version`` when an int, else the best one by val loss).
    Its version must share this run's data seed and trial splits."""
    from behavenet_tpu_torch.fitting.experiment import get_best_model_version, get_expt_dir

    key = {'neural-ae': 'ae', 'neural-arhmm': 'arhmm'}[model_class]
    if '%s_predictions_file' % key in hparams:
        path = hparams['%s_predictions_file' % key]
    else:
        expt_dir = get_expt_dir(
            hparams, model_class=model_class,
            expt_name=hparams['neural_%s_experiment_name' % key],
            model_type=hparams['neural_%s_model_type' % key])
        version = hparams.get('neural_%s_version' % key)
        if not isinstance(version, int):
            version = get_best_model_version(expt_dir, 'val_loss')[0]
        path = os.path.join(expt_dir, 'version_%i' % version, '%s_%s_%s_%s_predictions.pkl' % (
            sess_id['lab'], sess_id['expt'], sess_id['animal'], sess_id['session']))
    check_same_training_split(path, hparams)
    return path
