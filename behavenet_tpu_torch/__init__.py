"""BehaveNet in PyTorch on NVIDIA Hopper: the port of ``behavenet_tpu``.

The package mirrors ``behavenet_tpu``'s module names so each piece sits
beside its JAX counterpart. It imports ``torch`` and never ``jax`` or
``behavenet_tpu``: what it needs from the JAX package's numpy-only modules
it keeps as its own copy.

So far it fits a conv autoencoder (``fitting.ae_grid_search``, the
four-JSON grid-search CLI, over ``fitting.training.fit``) and serves a
fitted one (``serving.load_version``): ``encode`` and ``reconstruct`` on raw
uint8 frames. On a GPU the convolutions, their gradients, the loss and the
optimizer step run in hand-written CUDA kernels (``kernels/``). Entry points
run on ``'cuda'`` unless the caller asks for ``'cpu'``.

As in the JAX package (reference behavenet/__init__.py), user directories
come from ``~/.behavenet/directories.json`` (``$BEHAVENET_DIR`` overrides
the folder).
"""

import json
import os

__version__ = '0.1.0'


def get_params_dir():
    """Directory of the user's config files: ``$BEHAVENET_DIR`` or
    ``~/.behavenet``."""
    return os.environ.get(
        'BEHAVENET_DIR', os.path.join(os.path.expanduser('~'), '.behavenet'))


def get_user_dir(dir_type):
    """Base directory ``'data'``, ``'save'`` or ``'fig'`` from
    ``directories.json`` (reference behavenet/__init__.py:10-35)."""
    dirs_file = os.path.join(get_params_dir(), 'directories.json')
    if not os.path.exists(dirs_file):
        raise FileNotFoundError('Could not find %s; write it with the data, save and '
                                'fig directories first' % dirs_file)
    with open(dirs_file, 'r') as f:
        dirs = json.load(f)
    key = '%s_dir' % dir_type
    if key not in dirs:
        raise KeyError('"%s" not found in %s' % (key, dirs_file))
    return dirs[key]
