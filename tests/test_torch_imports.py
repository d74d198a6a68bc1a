"""The port and its chip smoke test import neither jax nor behavenet_tpu,
nor scikit-learn (the card's machine has none)."""

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
    return top in ('jax', 'jaxlib', 'behavenet_tpu', 'sklearn')


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
    """The trainer, the ops, the ARHMM and decoder CLIs, serving and the
    chip smoke test leave h5py and sklearn out of a fresh process, and so
    does a decoder ``fit`` from an in-memory trial source (``chip_smoke``'s,
    at 12 channels): the card's machine has neither, and only opening an
    HDF5 store needs h5py (``tests/test_torch_arhmm.py`` runs the ARHMM path
    in such a process)."""
    code = (
        'import sys, tempfile\n'
        'sys.path.insert(0, sys.argv[1])\n'
        'import behavenet_tpu_torch.fitting.training\n'
        'import behavenet_tpu_torch.fitting.ae_grid_search\n'
        'import behavenet_tpu_torch.fitting.arhmm_grid_search\n'
        'import behavenet_tpu_torch.fitting.decoder_grid_search\n'
        'import behavenet_tpu_torch.ops.conv, behavenet_tpu_torch.ops.losses\n'
        'import behavenet_tpu_torch.ops.optim, behavenet_tpu_torch.models.vaes\n'
        'import behavenet_tpu_torch.utils.pickles, behavenet_tpu_torch.serving\n'
        'import chip_smoke as cs\n'
        'from behavenet_tpu_torch.fitting.experiment import Experiment\n'
        'from behavenet_tpu_torch.fitting.training import fit\n'
        'from behavenet_tpu_torch.models.decoders import Decoder\n'
        'cs.DEVICE = "cpu"\n'
        'tmp = tempfile.mkdtemp()\n'
        'hp = dict(cs.decoder_hparams("neural-ae-mlp-mv", tmp), input_size=12,\n'
        '          max_n_epochs=1)\n'
        'src = cs.DecoderSource(10, 0, hp["output_signal"], hp["output_size"],\n'
        '                       frames=30, channels=12)\n'
        'fit(hp, Decoder(hp), src, Experiment(hp["experiment_name"], tmp), method="nll")\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("h5py", "sklearn", "jax", "jaxlib", "behavenet_tpu"))\n'
        'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code, _ROOT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
