"""Experiment store: versioned results tree, metrics logging, dedup.

The port's copy of what ``ae_grid_search``, ``arhmm_grid_search``,
``decoder_grid_search`` and ``bayesian_decoder_grid_search`` need from
``behavenet_tpu/fitting/experiment.py``
(reference behavenet/fitting/utils.py, with test-tube's Experiment replaced
by :class:`Experiment`). The
on-disk layout is the JAX package's, bit for bit: ``version_%i/``
directories, ``metrics.csv``, ``meta_tags.pkl``, ``session_info.csv``, e.g.
``ae/conv/08_latents/expt/version_0/best_val_model.pt``. Both packages read
each other's stores, so the two must not share a ``save_dir``:
:func:`experiment_exists` would take one's version for the other's.
"""

import csv
import os
import pickle

from behavenet_tpu_torch.models.decoders import DECODER_CLASSES

__all__ = [
    'Experiment', 'get_subdirs', 'get_session_dir', 'get_expt_dir',
    'read_session_info_from_csv', 'export_session_info_to_csv', 'experiment_exists',
    'get_model_params', 'export_hparams', 'create_experiment', 'get_best_model_version',
    'get_region_dir',
]

_AE_FAMILY = ('ae', 'vae', 'beta-tcvae', 'cond-vae', 'cond-ae', 'cond-ae-msp',
              'ps-vae', 'msps-vae')
_ARHMM_ON_LATENTS = ('arhmm', 'hmm')
_ARHMM_ON_LABELS = ('arhmm-labels', 'hmm-labels')
# the decoder classes by the directory layout of their upstream signal
_DECODERS_ON_LATENTS = ('neural-ae', 'neural-ae-me', 'ae-neural')
_DECODERS_ON_LABELS = ('neural-labels', 'labels-neural')
_DECODERS_ON_STATES = ('neural-arhmm', 'arhmm-neural')
_BAYESIAN = 'bayesian-decoding'


class Experiment(object):
    """Minimal versioned metrics logger (replaces test_tube.Experiment).

    Creates ``save_dir/name/version_%i``; ``log(row)`` buffers metric rows;
    ``save()`` writes ``metrics.csv`` with the union of row keys as columns.
    """

    def __init__(self, name, save_dir, version=None):
        self.name = name
        self.save_dir = save_dir
        base = os.path.join(save_dir, name)
        os.makedirs(base, exist_ok=True)
        if version is None:
            # atomic version allocation: retry on collision so concurrent
            # grid-search workers never share a version dir (the reference
            # merely sleeps a random 1-3 s, ae_grid_search.py:35-37)
            existing = [d for d in os.listdir(base)
                        if d.startswith('version_') and
                        os.path.isdir(os.path.join(base, d))]
            versions = sorted(int(d.split('_')[-1]) for d in existing)
            version = (versions[-1] + 1) if versions else 0
            while True:
                try:
                    os.makedirs(os.path.join(base, 'version_%i' % version),
                                exist_ok=False)
                    break
                except FileExistsError:
                    version += 1
        self.version = version
        self.version_dir = os.path.join(base, 'version_%i' % version)
        os.makedirs(self.version_dir, exist_ok=True)
        self._rows = []
        self._tags = {}
        # resumed versions keep their logged history
        metrics_file = os.path.join(self.version_dir, 'metrics.csv')
        if os.path.exists(metrics_file):
            with open(metrics_file, newline='') as f:
                for row in csv.DictReader(f):
                    self._rows.append({k: v for k, v in row.items() if v != ''})

    def log(self, row):
        self._rows.append(dict(row))

    def tag(self, tags):
        self._tags.update(tags)

    def save(self):
        if self._rows:
            cols = []
            for row in self._rows:
                for key in row:
                    if key not in cols:
                        cols.append(key)
            with open(os.path.join(self.version_dir, 'metrics.csv'), 'w', newline='') as f:
                writer = csv.DictWriter(f, fieldnames=cols, restval='')
                writer.writeheader()
                for row in self._rows:
                    writer.writerow(row)
        if self._tags:
            with open(os.path.join(self.version_dir, 'meta_tags.csv'), 'w', newline='') as f:
                writer = csv.writer(f)
                writer.writerow(['key', 'value'])
                for k, v in self._tags.items():
                    writer.writerow([k, v])


def get_subdirs(path):
    """First-level subdirectories of ``path`` (reference :16)."""
    if not os.path.exists(path):
        raise NotADirectoryError('%s is not a path' % path)
    try:
        s = next(os.walk(path))[1]
    except StopIteration:
        raise StopIteration('%s does not contain any subdirectories' % path)
    if len(s) == 0:
        raise StopIteration('%s does not contain any subdirectories' % path)
    return s


def _get_multisession_paths(base_dir, lab='', expt='', animal=''):
    multi_paths = []
    try:
        sub_dirs = get_subdirs(os.path.join(base_dir, lab, expt, animal))
        for sub_dir in sub_dirs:
            if sub_dir[:5] == 'multi':
                multi_paths.append(os.path.join(base_dir, lab, expt, animal, sub_dir))
    except (ValueError, NotADirectoryError, StopIteration):
        print('warning: did not find requested multisession(s)')
    return multi_paths


def _get_single_sessions(base_dir, depth, curr_depth):
    session_list = []
    if curr_depth < depth:
        curr_depth += 1
        sub_dirs = get_subdirs(base_dir)
        for sub_dir in sub_dirs:
            if sub_dir[:12] != 'multisession':
                session_list += _get_single_sessions(
                    os.path.join(base_dir, sub_dir), depth=depth, curr_depth=curr_depth)
    elif curr_depth == depth:
        sess_path = base_dir.split(os.sep)
        session_list = [{
            'lab': sess_path[-4], 'expt': sess_path[-3],
            'animal': sess_path[-2], 'session': sess_path[-1]}]
    return session_list


_SESSION_HIERARCHY = ('lab', 'expt', 'animal', 'session')


def _session_identity(sess):
    """Hashable identity of one session dict (save_dir is location, not identity)."""
    return tuple(sorted((k, v) for k, v in sess.items() if k != 'save_dir'))


def _load_session_infos(csv_file):
    sessions = read_session_info_from_csv(csv_file)
    for sess in sessions:
        sess.pop('save_dir', None)
    return sessions


def _match_or_allocate_multisession(multisession_paths, sessions_single):
    """Index of the multisession dir whose session_info.csv holds exactly
    this session set, or the next free index if none matches."""
    want = {_session_identity(s) for s in sessions_single}
    for path in multisession_paths:
        have = {_session_identity(s)
                for s in _load_session_infos(os.path.join(path, 'session_info.csv'))}
        if have == want:
            return int(path.split('-')[-1])
    taken = [int(p.split('-')[-1]) for p in multisession_paths]
    return max(taken) + 1 if taken else 0


def get_session_dir(hparams, session_source='save'):
    """Resolve the session-level results directory + list of single sessions.

    (reference fitting/utils.py:135-304 contract: identical resolution
    rules — sessions_csv overrides; 'all' keywords expand one hierarchy
    level; multi-session sets live in ``multisession-%02i`` dirs matched by
    identity against each dir's session_info.csv, allocating the next free
    index on a miss; an explicit ``multisession`` hparam selects a dir and
    reads its membership back.)
    """
    save_dir = hparams['save_dir']
    if session_source not in ('save', 'data'):
        raise ValueError('"%s" is an invalid session_source' % session_source)
    enum_root = hparams['%s_dir' % session_source]

    if len(hparams.get('sessions_csv', [])) > 0:
        # explicit membership list: base dir = deepest level on which every
        # listed session agrees, checked most-specific first
        sessions_single = _load_session_infos(hparams['sessions_csv'])
        for depth in (4, 3, 2, 1, 0):
            if depth == 0:
                raise NotImplementedError('multiple labs not currently supported')
            level = _SESSION_HIERARCHY[depth - 1]
            if len({s[level] for s in sessions_single}) == 1:
                break
        shared = [sessions_single[0][lvl] for lvl in _SESSION_HIERARCHY[:depth]]
        session_dir_base = os.path.join(save_dir, *shared)
        scope = dict(zip(('lab', 'expt', 'animal'), shared[:3]))
        multisession_paths = _get_multisession_paths(save_dir, **scope)
    elif 'all' in [hparams[lvl] for lvl in _SESSION_HIERARCHY]:
        # 'all' keyword: enumerate every session below the fixed prefix
        if hparams['lab'] == 'all':
            raise NotImplementedError('multiple labs not currently supported')
        n_fixed = [hparams[lvl] for lvl in _SESSION_HIERARCHY].index('all')
        prefix = [hparams[lvl] for lvl in _SESSION_HIERARCHY[:n_fixed]]
        session_dir_base = os.path.join(save_dir, *prefix)
        sessions_single = _get_single_sessions(
            os.path.join(enum_root, *prefix), depth=4 - n_fixed, curr_depth=0)
        multisession_paths = _get_multisession_paths(
            save_dir, **dict(zip(('lab', 'expt', 'animal'), prefix)))
    else:
        # one fully specified session
        sessions_single = [{lvl: hparams[lvl] for lvl in _SESSION_HIERARCHY}]
        session_dir_base = os.path.join(
            save_dir, *(hparams[lvl] for lvl in _SESSION_HIERARCHY))
        multisession_paths = []

    if hparams.get('multisession', None) is not None and \
            len(hparams.get('sessions_csv', [])) == 0:
        session_dir = os.path.join(
            session_dir_base, 'multisession-%02i' % hparams['multisession'])
        sessions_single = _load_session_infos(
            os.path.join(session_dir, 'session_info.csv'))
    elif len(sessions_single) > 1:
        multi_idx = _match_or_allocate_multisession(multisession_paths, sessions_single)
        session_dir = os.path.join(session_dir_base, 'multisession-%02i' % multi_idx)
    else:
        session_dir = session_dir_base

    return session_dir, sessions_single


def _get_transition_str(hparams):
    if hparams['transitions'] == 'sticky':
        return 'sticky_%.0e' % hparams['kappa']
    return hparams['transitions']


def get_expt_dir(hparams, model_class=None, model_type=None, expt_name=None):
    """Model-class-specific experiment directory (JAX: experiment.py:230;
    reference :307-434), for the autoencoder family, the (AR)HMMs, the
    neural decoders and the Bayesian decoder."""
    import copy

    if model_class is None:
        model_class = hparams['model_class']
    if model_type is None:
        model_type = hparams['model_type']
    if expt_name is None:
        expt_name = hparams['experiment_name']

    if model_class in _AE_FAMILY:
        model_path = os.path.join(
            model_class, model_type, '%02i_latents' % hparams['n_ae_latents'])
        multi_key = 'ae_multisession'
    elif model_class in _ARHMM_ON_LATENTS + _ARHMM_ON_LABELS:
        model_path = os.path.join(
            model_class,
            *(['%02i_latents' % hparams['n_ae_latents']]
              if model_class in _ARHMM_ON_LATENTS else []),
            '%02i_states' % hparams['n_arhmm_states'],
            _get_transition_str(hparams), hparams['noise_type'])
        multi_key = 'arhmm_multisession'
    elif model_class in DECODER_CLASSES:
        region = get_region_dir(hparams)
        if model_class in _DECODERS_ON_LATENTS:
            parts = ['%02i_latents' % hparams['n_ae_latents'], model_type]
        elif model_class in _DECODERS_ON_LABELS:
            parts = [model_type]
        else:
            parts = ['%02i_latents' % hparams['n_ae_latents'],
                     '%02i_states' % hparams['n_arhmm_states'],
                     _get_transition_str(hparams), model_type]
        model_path = os.path.join(model_class, *parts, region)
        multi_key = None
    elif model_class == _BAYESIAN:
        model_path = os.path.join(
            model_class, '%02i_latents' % hparams['n_ae_latents'],
            '%02i_states' % hparams['n_arhmm_states'],
            _get_transition_str(hparams), hparams['noise_type'], get_region_dir(hparams))
        multi_key = None
    else:
        raise NotImplementedError('model_class "%s" is not ported yet' % model_class)
    if multi_key is not None and hparams.get(multi_key, None) is not None:
        hparams_ = copy.deepcopy(hparams)
        hparams_['session'] = 'all'
        hparams_['multisession'] = hparams[multi_key]
        session_dir, _ = get_session_dir(hparams_)
    else:
        session_dir = hparams['session_dir']
    return os.path.join(session_dir, model_path, expt_name)


def read_session_info_from_csv(session_file):
    """Read session_info.csv -> list of session dicts (reference :437)."""
    sessions_multi = []
    with open(session_file) as csv_file:
        csv_reader = csv.DictReader(csv_file)
        for row in csv_reader:
            sessions_multi.append(dict(row))
    return sessions_multi


def export_session_info_to_csv(session_dir, ids_list):
    """Write session_info.csv (reference :461)."""
    session_file = os.path.join(session_dir, 'session_info.csv')
    if not os.path.isdir(session_dir):
        os.makedirs(session_dir)
    with open(session_file, mode='w', newline='') as f:
        session_writer = csv.DictWriter(f, fieldnames=list(ids_list[0].keys()))
        session_writer.writeheader()
        for ids in ids_list:
            session_writer.writerow(ids)


def experiment_exists(hparams, which_version=False):
    """Dedup: search versions for a completed run with matching model params (reference :569)."""
    if 'expt_dir' not in hparams:
        if 'session_dir' not in hparams:
            hparams['session_dir'], _ = get_session_dir(
                hparams, session_source=hparams.get('all_source', 'save'))
        hparams['expt_dir'] = get_expt_dir(hparams)

    try:
        versions = get_subdirs(hparams['expt_dir'])
    except (StopIteration, NotADirectoryError):
        return (False, None) if which_version else False

    hparams_less = get_model_params(hparams)

    found_match = False
    version = None
    for version in versions:
        version_file = os.path.join(hparams['expt_dir'], version, 'meta_tags.pkl')
        try:
            with open(version_file, 'rb') as f:
                hparams_ = pickle.load(f)
            if all(hparams_[key] == hparams_less[key] for key in hparams_less.keys()):
                if hparams_['training_completed']:
                    found_match = True
                    break
        except (IOError, KeyError):
            continue

    if which_version and found_match:
        return found_match, int(version.split('_')[-1])
    elif which_version:
        return found_match, None
    return found_match


def get_region_dir(hparams):
    """'all', '<name>-single' or '<name>-loo' (JAX: experiment.py:558;
    reference :806)."""
    method = hparams.get('subsample_method', 'none')
    if method == 'none':
        return 'all'
    if method in ('single', 'loo'):
        return '%s-%s' % (hparams['subsample_idxs_name'], method)
    raise ValueError('"%s" is an invalid sampling type' % method)


def get_model_params(hparams):
    """The identity key set that dedups an experiment (JAX: experiment.py:420;
    reference :633-753), for the autoencoder family, the (AR)HMMs, the
    neural decoders and the Bayesian decoder."""
    model_class = hparams['model_class']
    if model_class not in _AE_FAMILY + _ARHMM_ON_LATENTS + _ARHMM_ON_LABELS + DECODER_CLASSES \
            + (_BAYESIAN,):
        raise NotImplementedError('model_class "%s" is not ported yet' % model_class)

    hparams_less = {
        'rng_seed_data': hparams['rng_seed_data'],
        'trial_splits': hparams['trial_splits'],
        'train_frac': hparams['train_frac'],
        'rng_seed_model': hparams['rng_seed_model'],
        'model_class': hparams['model_class'],
        'model_type': hparams['model_type'],
    }
    if model_class in DECODER_CLASSES:
        return dict(hparams_less, **_decoder_params(hparams))
    if model_class == _BAYESIAN:
        return dict(hparams_less, n_ae_latents=hparams['n_ae_latents'],
                    n_arhmm_states=hparams['n_arhmm_states'])
    if model_class not in _AE_FAMILY:
        for key in ('n_arhmm_lags', 'noise_type', 'transitions'):
            hparams_less[key] = hparams[key]
        if hparams['transitions'] == 'sticky':
            hparams_less['kappa'] = hparams['kappa']
        if model_class in _ARHMM_ON_LATENTS:
            for key in ('ae_experiment_name', 'ae_version', 'ae_model_class',
                        'ae_model_type', 'n_ae_latents'):
                hparams_less[key] = hparams[key]
        return hparams_less

    hparams_less.update({
        'n_ae_latents': hparams['n_ae_latents'],
        'fit_sess_io_layers': hparams['fit_sess_io_layers'],
        'learning_rate': hparams['learning_rate'],
        'l2_reg': hparams['l2_reg'],
    })
    if model_class in ('cond-ae', 'cond-vae'):
        hparams_less['conditional_encoder'] = hparams.get('conditional_encoder', False)
    if model_class == 'cond-ae-msp':
        hparams_less['msp.alpha'] = hparams['msp.alpha']
    if model_class in ('vae', 'cond-vae'):
        hparams_less['vae.beta'] = hparams['vae.beta']
    if model_class == 'beta-tcvae':
        hparams_less['beta_tcvae.beta'] = hparams['beta_tcvae.beta']
    if model_class in ('ps-vae', 'msps-vae'):
        hparams_less['ps_vae.alpha'] = hparams['ps_vae.alpha']
        hparams_less['ps_vae.beta'] = hparams['ps_vae.beta']
        if model_class == 'msps-vae':
            hparams_less['ps_vae.delta'] = hparams['ps_vae.delta']
            hparams_less['n_background'] = hparams['n_background']
            hparams_less['n_sessions_per_batch'] = hparams['n_sessions_per_batch']
    return hparams_less


def _decoder_params(hparams):
    """A decoder's dedup keys beyond the common ones (JAX: experiment.py:471-533):
    its upstream model's, then its architecture's."""
    model_class = hparams['model_class']
    keys = []
    if model_class in _DECODERS_ON_LATENTS:
        keys = ['ae_experiment_name', 'ae_version', 'ae_model_class', 'ae_model_type',
                'n_ae_latents']
    elif model_class in _DECODERS_ON_STATES:
        keys = ['arhmm_experiment_name', 'arhmm_version', 'n_arhmm_states', 'n_arhmm_lags',
                'noise_type', 'transitions']
        if hparams['transitions'] == 'sticky':
            keys.append('kappa')
        keys += ['ae_model_class', 'ae_model_type', 'n_ae_latents']
    keys += ['learning_rate', 'n_lags', 'l2_reg', 'model_type', 'n_hid_layers']
    if hparams['n_hid_layers'] != 0:
        keys.append('n_hid_units')
    keys += ['activation', 'subsample_method']
    if hparams['subsample_method'] != 'none':
        keys += ['subsample_idxs_name', 'subsample_idxs_group_0', 'subsample_idxs_group_1']
    return {key: hparams[key] for key in keys}


def get_best_model_version(expt_dir, measure='val_loss'):
    """The completed version of ``expt_dir`` with the lowest ``measure`` in
    its ``metrics.csv``, as a one-element list (JAX: experiment.py:609;
    reference :879), read with the csv module."""
    scores = []
    for version in get_subdirs(expt_dir):
        meta_file = os.path.join(expt_dir, version, 'meta_tags.pkl')
        if not os.path.exists(meta_file):
            continue
        with open(meta_file, 'rb') as f:
            if not pickle.load(f)['training_completed']:
                continue
        with open(os.path.join(expt_dir, version, 'metrics.csv'), newline='') as f:
            vals = [float(row[measure]) for row in csv.DictReader(f)
                    if row.get(measure, '') != '']
        vals = [v for v in vals if v == v]   # pandas' min skips NaN
        if vals:
            scores.append((min(vals), version))
    if not scores:
        raise ValueError('no completed version with "%s" in %s' % (measure, expt_dir))
    return [int(min(scores, key=lambda sv: sv[0])[1].split('_')[-1])]


def export_hparams(hparams, exp):
    """Write meta_tags.pkl + tag csv (reference :756)."""
    meta_file = os.path.join(
        hparams['expt_dir'], 'version_%i' % exp.version, 'meta_tags.pkl')
    with open(meta_file, 'wb') as f:
        pickle.dump(hparams, f)
    exp.tag(hparams)
    exp.save()


def create_experiment(hparams):
    """Create experiment version dir for logging/storing models (reference :838).

    Returns (None, None, None) if a completed run with identical model params
    already exists.
    """
    hparams['session_dir'], sess_ids = get_session_dir(
        hparams, session_source=hparams.get('all_source', 'save'))
    if not os.path.isdir(hparams['session_dir']):
        os.makedirs(hparams['session_dir'])
        export_session_info_to_csv(hparams['session_dir'], sess_ids)
    hparams['expt_dir'] = get_expt_dir(hparams)
    if not os.path.isdir(hparams['expt_dir']):
        os.makedirs(hparams['expt_dir'])

    if hparams.get('resume_version') is not None:
        # reopen an interrupted version; fit() restores from its checkpoint
        exp = Experiment(
            name=hparams['experiment_name'],
            save_dir=os.path.dirname(hparams['expt_dir']),
            version=int(hparams['resume_version']))
        hparams['version'] = exp.version
        return hparams, sess_ids, exp

    if experiment_exists(hparams):
        return None, None, None

    exp = Experiment(
        name=hparams['experiment_name'],
        save_dir=os.path.dirname(hparams['expt_dir']))
    exp.save()
    hparams['version'] = exp.version

    return hparams, sess_ids, exp


def _clean_dir(hparams):
    """Delete unnecessary subdirectories in the version directory (reference :1066)."""
    import shutil
    version_dir = os.path.join(hparams['expt_dir'], 'version_%i' % hparams['version'])
    try:
        subdirs = get_subdirs(version_dir)
    except StopIteration:
        return
    for subdir in subdirs:
        shutil.rmtree(os.path.join(version_dir, subdir))

