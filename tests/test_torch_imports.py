"""The port and its chip smoke test import neither jax nor behavenet_tpu."""

import ast
import glob
import os
import subprocess
import sys

import pytest

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
_FILES = sorted(glob.glob(os.path.join(_ROOT, 'behavenet_tpu_torch', '**', '*.py'),
                          recursive=True)) + [os.path.join(_ROOT, 'chip_smoke.py')]


def _forbidden(module):
    top = module.split('.')[0]
    return top in ('jax', 'jaxlib', 'behavenet_tpu')


@pytest.mark.parametrize('path', _FILES, ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_or_reference_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', None) == \
                'import_module' and node.args and isinstance(node.args[0], ast.Constant):
            if _forbidden(str(node.args[0].value)):
                bad.append(node.args[0].value)
    assert not bad, '%s imports %s' % (path, bad)


def test_training_path_does_not_import_h5py():
    """The trainer, the ops and the chip smoke test leave h5py out of a fresh
    process: the card's machine has no h5py, and only opening an HDF5 store
    needs it."""
    code = (
        'import sys\n'
        'sys.path.insert(0, sys.argv[1])\n'
        'import behavenet_tpu_torch.fitting.training\n'
        'import behavenet_tpu_torch.fitting.ae_grid_search\n'
        'import behavenet_tpu_torch.ops.conv, behavenet_tpu_torch.ops.losses\n'
        'import behavenet_tpu_torch.ops.optim\n'
        'import chip_smoke\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("h5py", "jax", "jaxlib", "behavenet_tpu"))\n'
        'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code, _ROOT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
