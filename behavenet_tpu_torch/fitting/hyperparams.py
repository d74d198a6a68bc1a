"""Config -> hyperparameter-grid machinery (the port's copy of
``behavenet_tpu/fitting/hyperparams.py``; reference
behavenet/fitting/hyperparam_utils.py).

- the CLI accepts exactly four config JSONs (``--data_config
  --model_config --training_config --compute_config``) and nothing else;
- configs may contain // comments;
- every JSON key becomes a parameter; any list value becomes a grid
  dimension;
- ``n_ae_latents`` is renamed to ``n_latents`` (stringified) and expanded
  into per-latent-count architecture dicts, the ``architecture_params``
  grid dimension.

The compute config's ``device`` key picks the port's device: ``'cuda'``
(also when the key is absent) or ``'cpu'``; the JAX configs' ``'tpu'``
raises (``utils/device.py``).
"""

import itertools
import os
import sys
from collections import OrderedDict

from behavenet_tpu_torch.utils import jsonc

__all__ = ['get_all_params', 'HyperparamGrid', 'print_hparams', 'run_grid_search']

_AE_FAMILY = ('ae', 'vae', 'beta-tcvae', 'cond-vae', 'cond-ae', 'cond-ae-msp',
              'ps-vae', 'msps-vae', 'labels-images')
_TRIAL_ENV_VAR = 'BEHAVENET_TRIAL_IDX'


class HyperparamGrid(object):
    """Base params + named grid dimensions; iterates the cartesian product."""

    def __init__(self, base=None, grid=None):
        self.base = dict(base or {})
        self.grid = OrderedDict(grid or {})

    def add(self, key, value):
        self.base[key] = value

    def add_grid(self, key, options):
        self.grid[key] = list(options)

    def trials(self):
        """Yield one hparams dict per grid point."""
        if not self.grid:
            yield dict(self.base)
            return
        keys = list(self.grid.keys())
        for combo in itertools.product(*(self.grid[k] for k in keys)):
            hp = dict(self.base)
            hp.update(dict(zip(keys, combo)))
            yield hp


def get_all_params(search_type='grid_search', args=None):
    """Parse the four-config CLI into a :class:`HyperparamGrid` (JAX:
    hyperparams.py:75; reference :12-49)."""
    if args is None:
        args = sys.argv[1:]
    if len(args) != 8:
        raise ValueError('No command line arguments allowed other than config file names')

    flags = {}
    for i in range(0, 8, 2):
        name = args[i]
        if not name.startswith('--'):
            raise ValueError('Expected a --flag, got "%s"' % name)
        flags[name[2:]] = args[i + 1]
    required = ('data_config', 'model_config', 'training_config', 'compute_config')
    missing = [r for r in required if r not in flags]
    if missing:
        raise ValueError('Missing config arguments: %s' % missing)

    grid = HyperparamGrid()
    for key, path in flags.items():
        grid.add(key, path)

    for config in required:
        config_json = jsonc.load_file(flags[config])
        for key, value in config_json.items():
            _add_param(grid, key, value)

    # save/data dirs from user dotfiles unless supplied by a config
    if 'save_dir' not in grid.base or 'data_dir' not in grid.base:
        from behavenet_tpu_torch import get_user_dir
        for kind in ('save', 'data'):
            if '%s_dir' % kind not in grid.base:
                grid.add('%s_dir' % kind, get_user_dir(kind))

    _add_dependent_params(grid)
    return grid


def _add_param(grid, key, value):
    """JSON key -> base param or grid dimension (reference :52-59)."""
    if key == 'n_ae_latents':
        grid.add('n_latents', str(value))
    elif isinstance(value, list):
        grid.add_grid(key, value)
    else:
        grid.add(key, value)


def _add_dependent_params(grid):
    """Materialize params derived from json arguments (reference :62-122)."""
    base = grid.base
    model_class = base.get('model_class')

    if model_class in _AE_FAMILY:
        if base.get('model_type') == 'conv':
            from behavenet_tpu_torch.models.arch import load_handcrafted_arches
            grid.add('max_latents', 64)
            arch_dicts = load_handcrafted_arches(
                [base['n_input_channels'], base['y_pixels'], base['x_pixels']],
                base['n_latents'],
                base.get('ae_arch_json'),
                check_memory=False,
                batch_size=base.get('approx_batch_size'),
                mem_limit_gb=base.get('mem_limit_gb'))
            grid.add_grid('architecture_params', arch_dicts)
        elif base.get('model_type') == 'linear':
            grid.add('n_ae_latents', int(base['n_latents']))
        else:
            raise ValueError('%s is not a valid model type' % base.get('model_type'))
    elif base.get('n_latents'):
        grid.add('n_ae_latents', int(base['n_latents']))

    if model_class is not None and model_class.find('neural') > -1 \
            and base.get('subsample_method', 'none') != 'none':
        raise NotImplementedError('neural subsampling is not ported yet')


def print_hparams(hparams):
    """Pretty print the four config files' resolved values (reference utils.py:1076)."""
    for config_file in ('data', 'compute', 'training', 'model'):
        print('\n%s CONFIG:' % config_file.upper())
        path = hparams.get('%s_config' % config_file)
        if path is None:
            continue
        config_json = jsonc.load_file(path)
        for key in config_json.keys():
            key_ = 'n_latents' if key == 'n_ae_latents' else key
            print('    {}: {}'.format(key_, hparams.get(key_)))
    print('')


def run_grid_search(main_fn, hyperparams):
    """Run every grid trial (JAX: hyperparams.py:179), one after another in
    this process, or in ``tt_n_cpu_workers`` spawned processes when the
    compute config's device is ``'cpu'``. ``$BEHAVENET_TRIAL_IDX`` selects
    a single trial.

    The JAX package's slurm submission and grid-in-one-program trials
    (``vmap_trials``) are not ported yet and raise.
    """
    base = hyperparams.base
    if base.get('slurm'):
        raise NotImplementedError('slurm submission is not ported yet')
    if base.get('vmap_trials'):
        raise NotImplementedError('vmap_trials (grid-in-one-program) is not ported yet')
    trials = list(hyperparams.trials())
    idx = os.environ.get(_TRIAL_ENV_VAR)
    if idx not in (None, ''):
        print('running grid-search trial %i/%i' % (int(idx), len(trials)))
        main_fn(trials[int(idx)])
        return
    if len(trials) > 1 and base.get('resume_version') is not None:
        raise ValueError('resume_version names one version: resume one trial of a grid '
                         'alone (%s or a single-point config)' % _TRIAL_ENV_VAR)
    print('running %i grid-search trial(s)' % len(trials))
    n_workers = int(base.get('tt_n_cpu_workers', 1) or 1)
    if n_workers > 1 and base.get('device') == 'cpu':
        import multiprocessing
        with multiprocessing.get_context('spawn').Pool(n_workers) as pool:
            pool.map(main_fn, trials)
    else:
        for trial in trials:
            main_fn(trial)
