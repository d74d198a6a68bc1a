"""The port's ARHMM (``behavenet_tpu_torch.models.arhmm``), its k-means
initialization, pickles, data path and ``arhmm_grid_search`` CLI against
the JAX package's, on the CPU (plain versions of K8-K11), at a few states,
a few dims and a few short trials (one shorter, so the mask path runs)."""

import csv
import functools
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from behavenet_tpu.fitting.experiment import get_best_model_version as jax_best_version
from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu_torch.fitting import arhmm_grid_search
from behavenet_tpu_torch.fitting.experiment import get_best_model_version
from behavenet_tpu_torch.models import arhmm
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.parallel import Mesh
from behavenet_tpu_torch.utils import pickles
from behavenet_tpu_torch.utils.weights import arhmm_params_from_jax
from tests.jax_low import compile_low, jit_low

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
K, D = 3, 3


def sample_trials(lengths, seed=0, ar=0.6, sep=4.0, noise=0.3, stay=0.9):
    """Trials of a seeded K-state AR(1) process: state k pulls x towards a
    mean of its own (means ``sep`` apart in scale), sticky switches."""
    rs = np.random.RandomState(seed)
    means = rs.randn(K, D) * sep
    As = [ar * np.eye(D) + 0.1 * rs.randn(D, D) for _ in range(K)]
    bs = [(np.eye(D) - A) @ m for A, m in zip(As, means)]
    trials = []
    for T in lengths:
        z = rs.randint(K)
        x = np.zeros((T, D))
        x[0] = means[z] + noise * rs.randn(D)
        for t in range(1, T):
            if rs.rand() > stay:
                z = rs.randint(K)
            x[t] = As[z] @ x[t - 1] + bs[z] + noise * rs.randn(D)
        trials.append(x.astype(np.float32))
    return trials


@pytest.fixture(scope='module')
def datas():
    # unit-scale means: f32 EM in two summation orders stays within 1e-4
    return sample_trials([36, 36, 24, 36, 36], sep=1.0)


def _np_params(model):
    return {k: np.asarray(v) for k, v in model.params.items()}


@functools.lru_cache(maxsize=None)
def _jax_decode():
    """JAX's Viterbi paths, posteriors and log_Z of padded trials (the
    per-trial functions behind ``most_likely_states``, ``expected_states``
    and ``log_likelihood``), vmapped and compiled once for the module."""
    m = JaxARHMM(K, D, lags=1)

    def one(params, xi, mi):
        ll = m._log_likes(params, xi, mi)
        lp = m._log_P(params, xi, mi)
        gamma, log_z, _ = jhmm.forward_backward(params['log_pi0'], lp, ll, mi)
        return jhmm.viterbi(params['log_pi0'], lp, ll, mi), gamma, log_z
    fn, compiled = jax.vmap(one, in_axes=(None, 0, 0)), {}

    def run(params, x, mask):
        key = tuple(np.shape(a) for a in jax.tree_util.tree_leaves((params, x, mask)))
        if key not in compiled:
            compiled[key] = compile_low(fn, params, x, mask)
        return compiled[key](params, x, mask)
    return run


def _decode_jax(j, datas):
    x, mask = ARHMM(K, D, device='cpu').pad(datas)
    paths, gammas, log_z = _jax_decode()(j.params, x.numpy(), mask.numpy())
    return ([np.asarray(paths)[i, :len(d)] for i, d in enumerate(datas)],
            [np.asarray(gammas)[i, :len(d)] for i, d in enumerate(datas)],
            np.asarray(log_z))


@pytest.mark.parametrize('obs', ['ar', 'diagonal_ar', 'gaussian'])
def test_fresh_model_equals_jax(obs):
    """A fresh model's parameters are JAX's, bit for bit, for the same seed."""
    j = JaxARHMM(4, D, lags=1, observations=obs, rng_seed=3)
    t = ARHMM(4, D, lags=1, observations=obs, rng_seed=3, device='cpu')
    assert t.lags == j.lags and t.diagonal == j.diagonal
    for key, want in _np_params(j).items():
        got = t.params[key]
        assert got.dtype == torch.float32 and got.shape == want.shape, key
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


@pytest.mark.parametrize('obs', ['ar', 'gaussian', 'diagonal_ar'])
def test_log_likes_match_jax(datas, obs):
    j = JaxARHMM(K, D, lags=1, observations=obs, rng_seed=1)
    j.initialize(datas)
    t = ARHMM(K, D, lags=1, observations=obs, rng_seed=1, device='cpu')
    t.params = arhmm_params_from_jax(_np_params(j), device='cpu')
    x, mask = t.pad(datas)
    got = t._log_likes(t.params, x, mask).numpy()
    want = jit_low(jax.vmap(j._log_likes, in_axes=(None, 0, 0)), j.params, x.numpy(),
                   mask.numpy())
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-6)
    assert np.all(got[2, 24:] == 0)   # padded frames


@pytest.fixture(scope='module', params=[('stationary', 0.0), ('sticky', 20.0)],
                ids=['stationary', 'sticky'])
def em_pair(request, datas):
    """5 EM iterations of JAX's ARHMM and the port's from JAX's initialized
    params (carried across by ``arhmm_params_from_jax``)."""
    transitions, kappa = request.param
    j = JaxARHMM(K, D, lags=1, transitions=transitions, kappa=kappa, rng_seed=2)
    j.initialize(datas)
    t = ARHMM(K, D, lags=1, transitions=transitions, kappa=kappa, rng_seed=2, device='cpu')
    t.params = arhmm_params_from_jax(_np_params(j), device='cpu')
    return j, t, j.fit(datas, num_iters=5), t.fit(datas, num_iters=5)


def test_em_matches_jax(em_pair, datas):
    j, t, lls_j, lls_t = em_pair
    assert all(isinstance(v, float) for v in lls_t)
    np.testing.assert_allclose(lls_t, lls_j, rtol=1e-5)
    assert lls_t[-1] > lls_t[0]
    for key, want in _np_params(j).items():
        np.testing.assert_allclose(t.params[key].numpy(), want, atol=1e-4, err_msg=key)
    paths, gammas, log_z = _decode_jax(j, datas)
    np.testing.assert_allclose(t.log_likelihood(datas), log_z.sum(), rtol=1e-5)
    for d, path, gamma in zip(datas, paths, gammas):
        np.testing.assert_array_equal(t.most_likely_states(d), path)
        np.testing.assert_allclose(t.expected_states(d), gamma, atol=1e-4)


def test_fit_tolerance_and_permute(em_pair, datas):
    """``permute`` relabels as the JAX package's (``log_Ps[ix_(perm, perm)]``,
    the rest along the state axis); ``fit``'s tolerance stops as ssm's."""
    t = em_pair[1]
    perm = np.array([2, 0, 1])
    before = {key: v.clone() for key, v in t.params.items()}
    t.permute(np.array([1, 0, 2])[::-1])   # a negative stride, as argsort()[::-1]
    for key in before:
        moved = before[key][perm][:, perm] if key == 'log_Ps' else before[key][perm]
        assert torch.equal(t.params[key], moved), key
    # relative-tolerance stop: a loose tolerance stops after two iterations
    assert len(t.fit(datas, num_iters=10, tolerance=1e9)) == 2


def test_kmeans_initialize_matches_sklearn():
    """On well-separated clusters the port's k-means gives sklearn's
    partition up to relabelling, and ``initialize``'s per-state fits then
    match the JAX package's (which uses sklearn) after the relabelling."""
    trials = sample_trials([30, 30, 22, 30], seed=5, ar=0.0, sep=6.0, noise=0.2, stay=0.8)
    stacked = np.vstack(trials).astype(np.float64)
    labels = arhmm.kmeans(stacked, K, rng_seed=0)[0]
    sk = KMeans(K, n_init=10, random_state=0).fit(stacked).labels_
    perm = np.array([np.bincount(labels[sk == k], minlength=K).argmax() for k in range(K)])
    assert sorted(perm) == list(range(K))
    np.testing.assert_array_equal(perm[sk], labels)

    j = JaxARHMM(K, D, lags=1, rng_seed=0)
    j.initialize(trials)
    t = ARHMM(K, D, lags=1, rng_seed=0, device='cpu')
    t.initialize(trials)
    for key in ('As', 'bs', 'Sigmas'):
        np.testing.assert_allclose(t.params[key].numpy()[perm], np.asarray(j.params[key]),
                                   atol=1e-5, err_msg=key)


def test_jax_written_model_loads_without_jax(datas, tmp_path):
    """A JAX-written ``best_val_model.pt`` (``ARHMM.save``, as the JAX CLI
    pickles it) loads through ``load_arhmm`` in a process that never
    imports jax or behavenet_tpu, and gives JAX's Viterbi paths; so does a
    recurrent, robust one (its paths as the port's of the same params), and
    a float64 one loads as a float64 model (its paths as the port's float64
    decoding of the same params); the same
    process reads a latents pickle, initializes (k-means), fits and pickles
    a model without importing sklearn or h5py."""
    j = JaxARHMM(K, D, lags=1, rng_seed=4)
    j.initialize(datas)
    path = str(tmp_path / 'best_val_model.pt')
    j.hparams = {'n_arhmm_states': K, 'noise_type': 'gaussian'}
    j.save(path)
    np.savez(str(tmp_path / 'io.npz'), *datas, *_decode_jax(j, datas)[0])
    # a recurrent, robust one: its Viterbi paths as the port decodes its
    # parameters here
    kw = dict(lags=1, observations='robust_ar', transitions='recurrent', rng_seed=4)
    jr = JaxARHMM(K, D, **kw)
    jr.params = dict(jr.params, As=j.params['As'], bs=j.params['bs'],
                     Sigmas=j.params['Sigmas'])
    jr.save(str(tmp_path / 'recurrent.pt'))
    tr = ARHMM(K, D, device='cpu', **kw)
    tr.params = arhmm_params_from_jax(_np_params(jr), device='cpu')
    np.savez(str(tmp_path / 'recurrent.npz'), *tr.most_likely_states_batch(datas))
    with jax.enable_x64(True):
        j64 = JaxARHMM(K, D, lags=1, rng_seed=4, dtype='float64')
        j64.params = dict(j64.params, **{k: jax.numpy.asarray(np.asarray(j.params[k]),
                                                              dtype=np.float64)
                                         for k in ('As', 'bs', 'Sigmas')})
        j64.save(str(tmp_path / 'f64.pt'))
        p64 = {k: np.array(v) for k, v in j64.params.items()}
    t64 = ARHMM(K, D, lags=1, rng_seed=4, dtype='float64', device='cpu')
    t64.params = arhmm_params_from_jax(p64, device='cpu', dtype=torch.float64)
    np.savez(str(tmp_path / 'f64.npz'), *t64.most_likely_states_batch(datas))
    with open(str(tmp_path / 'l_e_a_s_latents.pkl'), 'wb') as f:
        pickle.dump({'latents': datas, 'trials': None}, f)
    code = (
        'import os, sys\n'
        'import numpy as np\n'
        'from behavenet_tpu_torch.data.generator import SingleSessionDataset\n'
        'from behavenet_tpu_torch.models.arhmm import ARHMM\n'
        'from behavenet_tpu_torch.utils.pickles import load_arhmm\n'
        'tmp = sys.argv[1]\n'
        'm = load_arhmm(os.path.join(tmp, "best_val_model.pt"), device="cpu")\n'
        'io = np.load(os.path.join(tmp, "io.npz")); n = len(io.files) // 2\n'
        'for i in range(n):\n'
        '    got = m.most_likely_states(io["arr_%d" % i])\n'
        '    assert np.array_equal(got, io["arr_%d" % (n + i)]), i\n'
        'assert m.hparams["n_arhmm_states"] == m.K\n'
        'r = load_arhmm(os.path.join(tmp, "recurrent.pt"), device="cpu")\n'
        'want = np.load(os.path.join(tmp, "recurrent.npz"))\n'
        'assert r.recurrent and r.robust and r.params["Rs"].shape == (r.K, r.D)\n'
        'for i in range(n):\n'
        '    assert np.array_equal(r.most_likely_states(io["arr_%d" % i]),\n'
        '                          want["arr_%d" % i]), i\n'
        'f = load_arhmm(os.path.join(tmp, "f64.pt"), device="cpu")\n'
        'assert f.dtype == "float64"\n'
        'assert all(str(v.dtype) == "torch.float64" for v in f.params.values())\n'
        'want = np.load(os.path.join(tmp, "f64.npz"))\n'
        'for i in range(n):\n'
        '    assert np.array_equal(f.most_likely_states(io["arr_%d" % i]),\n'
        '                          want["arr_%d" % i]), i\n'
        'ds = SingleSessionDataset(tmp, signals=["ae_latents"], transforms=[None],\n'
        '                          paths=[os.path.join(tmp, "l_e_a_s_latents.pkl")])\n'
        'x = [ds[i]["ae_latents"] for i in range(len(ds))]\n'
        'assert np.array_equal(x[1], io["arr_1"])\n'
        'p = ARHMM(2, x[0].shape[1], device="cpu")\n'
        'p.fit(x, num_iters=2, initialize=True)\n'
        'p.save(os.path.join(tmp, "port.pt"))\n'
        'bad = sorted(x for x in sys.modules if x.split(".")[0] in\n'
        '             ("jax", "jaxlib", "behavenet_tpu", "sklearn", "h5py"))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize('name', [b'behavenet_tpu.models.aes\nAE', b'jax.numpy\narray'])
def test_pickle_loader_refuses_other_jax_names(tmp_path, name):
    path = str(tmp_path / 'other.pt')
    with open(path, 'wb') as f:
        f.write(b'c' + name + b'\n.')   # GLOBAL module name, STOP
    with pytest.raises(pickle.UnpicklingError, match=name.split(b'\n')[0].decode()):
        pickles.load(path, device='cpu')


def test_unpickled_model_goes_to_the_card_unless_asked(em_pair, tmp_path):
    """A plain ``pickle.load`` and ``pickles.load`` without a device put
    the model on 'cuda', as every entry point of the port does: with no GPU
    they raise rather than fall back to the CPU."""
    path = str(tmp_path / 'port.pt')
    em_pair[1].save(path)

    def plain_load():
        with open(path, 'rb') as f:
            return pickle.load(f)

    for load in (lambda: pickles.load(path), plain_load):
        if torch.cuda.is_available():
            assert load().device.type == 'cuda'
        else:
            with pytest.raises(RuntimeError, match='no CUDA device'):
                load()
    assert pickles.load(path, device='cpu').device.type == 'cpu'


def test_port_model_pickles_round_trip(em_pair, tmp_path, datas):
    t = em_pair[1]
    path = str(tmp_path / 'port.pt')
    t.save(path)
    back = ARHMM.load(path, device='cpu')
    for key, v in t.params.items():
        assert torch.equal(back.params[key], v), key
    np.testing.assert_array_equal(back.most_likely_states(datas[0]),
                                  t.most_likely_states(datas[0]))


def test_unported_configurations_raise():
    """float64 EM with ``parallel_scan`` or a mesh (the rest of ROADMAP A1c)
    is refused; float64 EM (tests/test_torch_arhmm_f64.py),
    ``parallel_scan``, posterior sampling and sampling
    (tests/test_torch_arhmm_sampling.py), meshes and ``iters_per_dispatch``
    (tests/test_torch_seq.py) are ported."""
    for kw in (dict(dtype='float64', parallel_scan=True),
               dict(observations='robust_ar', transitions='recurrent', dtype='float64',
                    parallel_scan=True)):
        with pytest.raises(NotImplementedError, match='A1c'):
            ARHMM(K, D, device='cpu', **kw)
    t = ARHMM(K, D, device='cpu', parallel_scan=True)
    assert t.parallel_scan
    with pytest.raises(NotImplementedError, match='A1c'):
        ARHMM(K, D, device='cpu', dtype='float64').fit([np.zeros((5, D))], mesh=Mesh(['cpu']))
    with pytest.raises(RuntimeError, match='CUDA'):
        ARHMM(K, D)   # device=None means 'cuda', which this machine lacks


# ------------------------------------------------------------------ the CLI

LAB, EXPT, ANIMAL, SESSION = 'lab', 'expt', 'animal', 'sess'
N_TRIALS = 10


def _write_ae_store(save_dir, latents):
    """Two completed versions of an upstream AE (the second with the lower
    val loss, so ``ae_version: "best"`` picks it) with a latents pickle."""
    ae_dir = os.path.join(save_dir, LAB, EXPT, ANIMAL, SESSION, 'ae', 'conv',
                          '%02i_latents' % D, 'ae-expt')
    for version, val_loss in ((0, 2.0), (1, 1.0)):
        vdir = os.path.join(ae_dir, 'version_%d' % version)
        os.makedirs(vdir)
        with open(os.path.join(vdir, 'meta_tags.pkl'), 'wb') as f:
            pickle.dump({'rng_seed_data': 0, 'trial_splits': '8;1;1;0',
                         'training_completed': True}, f)
        with open(os.path.join(vdir, 'metrics.csv'), 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(['epoch', 'val_loss'])
            w.writerows([[0, val_loss + 1.0], [1, val_loss]])
        with open(os.path.join(vdir, '%s_%s_%s_%s_latents.pkl'
                               % (LAB, EXPT, ANIMAL, SESSION)), 'wb') as f:
            pickle.dump({'latents': latents if version else [x + 100 for x in latents],
                         'trials': None}, f)
    return ae_dir


def _write_configs(tmp, save_dir, **model):
    cfgs = {
        'data': {'lab': LAB, 'expt': EXPT, 'animal': ANIMAL, 'session': SESSION,
                 'save_dir': save_dir, 'data_dir': os.path.join(tmp, 'data'),
                 'all_source': 'save'},
        'model': dict({'experiment_name': 'arhmm-expt', 'n_arhmm_states': [2, 3],
                       'rng_seed_model': 0, 'n_arhmm_lags': 1, 'kappa': 0,
                       'noise_type': 'gaussian', 'transitions': 'stationary',
                       'ae_experiment_name': 'ae-expt', 'ae_version': 'best',
                       'ae_model_class': 'ae', 'ae_model_type': 'conv',
                       'n_ae_latents': D, 'model_class': 'arhmm', 'model_type': None},
                      **model),
        'training': {'export_train_plots': False, 'export_states': True, 'n_iters': 3,
                     'rng_seed_train': None, 'arhmm_es_tol': 0, 'as_numpy': True,
                     'batch_load': False, 'rng_seed_data': 0, 'train_frac': 1.0,
                     'trial_splits': '8;1;1;0'},
        'compute': {'device': 'cpu', 'tt_n_cpu_workers': 1},
    }
    args = []
    for name, cfg in cfgs.items():
        path = os.path.join(tmp, '%s.json' % name)
        with open(path, 'w') as f:
            json.dump(cfg, f)
        args += ['--%s_config' % name, path]
    return args


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    """The port's CLI on the CPU over n_arhmm_states in {2, 3}."""
    from behavenet_tpu_torch.fitting.hyperparams import get_all_params, run_grid_search
    tmp = str(tmp_path_factory.mktemp('arhmm_cli'))
    save_dir = os.path.join(tmp, 'save')
    latents = sample_trials([24 + 2 * i for i in range(N_TRIALS)], seed=7)
    ae_dir = _write_ae_store(save_dir, latents)
    run_grid_search(arhmm_grid_search.main, get_all_params('grid_search',
                                                           _write_configs(tmp, save_dir)))
    return save_dir, ae_dir, latents, tmp


def _arhmm_version(save_dir, k):
    return os.path.join(save_dir, LAB, EXPT, ANIMAL, SESSION, 'arhmm', '%02i_latents' % D,
                        '%02i_states' % k, 'stationary', 'gaussian', 'arhmm-expt',
                        'version_0')


@pytest.mark.parametrize('k', [2, 3])
def test_cli_writes_a_version(cli_run, k):
    save_dir, ae_dir, latents, _ = cli_run
    vdir = _arhmm_version(save_dir, k)
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        meta = pickle.load(f)
    assert meta['training_completed'] and meta['n_arhmm_states'] == k
    assert meta['ae_model_latents_file'].startswith(os.path.join(ae_dir, 'version_1'))
    with open(os.path.join(vdir, 'metrics.csv'), newline='') as f:
        rows = list(csv.DictReader(f))
    epochs = [r for r in rows if r['tr_loss'] != '']
    assert [int(r['epoch']) for r in epochs] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(np.isfinite(float(r['tr_loss'])) and np.isfinite(float(r['val_loss']))
               for r in epochs)
    assert len([r for r in rows if r.get('test_loss')]) == 1

    # the CLI's epoch-0 rows: the JAX model's log-likelihood of the same
    # initialized params over the same train / val trials
    from behavenet_tpu_torch.data.generator import split_trials
    idxs = {k: list(v) for k, v in split_trials(
        N_TRIALS, rng_seed=0, train_tr=8, val_tr=1, test_tr=1, gap_tr=0).items()}
    init = ARHMM(k, D, lags=1, rng_seed=0, device='cpu')
    init.initialize([latents[i] for i in idxs['train']])
    j = JaxARHMM(k, D, lags=1, rng_seed=0)
    j.params = {key: jax.numpy.asarray(v.numpy()) for key, v in init.params.items()}
    log_z = _decode_jax(j, [latents[i] for i in idxs['train'] + idxs['val']])[2]
    for key, sel, trials in (('tr_loss', slice(0, 8), idxs['train']),
                             ('val_loss', slice(8, 9), idxs['val'])):
        want = -log_z[sel].sum() / np.vstack([latents[i] for i in trials]).size
        np.testing.assert_allclose(float(epochs[0][key]), want, rtol=1e-5)

    # best_val_model.pt: the fitted, usage-sorted model
    model = pickles.load(os.path.join(vdir, 'best_val_model.pt'), device='cpu')
    assert isinstance(model, ARHMM) and model.K == k
    usage = np.bincount(np.concatenate(model.most_likely_states_batch(
        [latents[i] for i in idxs['train']])), minlength=k)
    assert np.all(np.diff(usage) <= 0)

    # the states pickle: one int path per trial, each its trial's length
    with open(os.path.join(vdir, '%s_%s_%s_%s_states.pkl'
                           % (LAB, EXPT, ANIMAL, SESSION)), 'rb') as f:
        states = pickle.load(f)
    assert len(states['states']) == N_TRIALS
    for path, x in zip(states['states'], latents):
        assert path.dtype == np.int32 and path.shape == (len(x),)
        np.testing.assert_array_equal(path, model.most_likely_states(x))


def test_cli_best_ae_version_matches_jax(cli_run):
    _, ae_dir, _, _ = cli_run
    assert get_best_model_version(ae_dir, 'val_loss') == jax_best_version(ae_dir, 'val_loss')
    assert get_best_model_version(ae_dir, 'val_loss') == [1]


@pytest.mark.parametrize('model,exc', [
    (dict(em_dtype='float64', parallel_scan=True), NotImplementedError),
    (dict(transitions='recurrent', noise_type='studentst', parallel_scan=True), None),
    (dict(parallel_scan=True), None),
], ids=['model0-NotImplementedError', 'model1-NotImplementedError',
        'model2-NotImplementedError'])   # the ids of the cases' earlier refusals
def test_cli_refuses_unported_configurations(cli_run, model, exc):
    """``em_dtype: float64`` with ``parallel_scan: true`` is refused before
    any work (float64 alone fits: tests/test_torch_arhmm_f64.py);
    ``parallel_scan: true`` fits on the CPU: a completed version whose
    pickled model carries the flag and whose states pickle holds its
    Viterbi paths."""
    from behavenet_tpu_torch.fitting.hyperparams import get_all_params, run_grid_search
    _, _, latents, tmp = cli_run
    name = 'refused' if exc else 'parallel_%s' % model.get('transitions', 'stationary')
    save_dir = os.path.join(tmp, name)
    if exc:
        args = _write_configs(tmp, save_dir, **model)
        for hp in get_all_params('grid_search', args).trials():
            with pytest.raises(exc):
                arhmm_grid_search.main(hp)
        assert not os.path.exists(save_dir)
        return
    _write_ae_store(save_dir, latents)
    model = dict(model, n_arhmm_states=[2])
    run_grid_search(arhmm_grid_search.main, get_all_params(
        'grid_search', _write_configs(tmp, save_dir, **model)))
    transitions = model.get('transitions', 'stationary')
    noise_type = model.get('noise_type', 'gaussian')
    vdir = os.path.join(save_dir, LAB, EXPT, ANIMAL, SESSION, 'arhmm', '%02i_latents' % D,
                        '02_states', transitions, noise_type, 'arhmm-expt', 'version_0')
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        meta = pickle.load(f)
    assert meta['training_completed'] and meta['parallel_scan']
    fitted = pickles.load_arhmm(os.path.join(vdir, 'best_val_model.pt'), device='cpu')
    assert fitted.parallel_scan and fitted.transitions == transitions
    with open(os.path.join(vdir, '%s_%s_%s_%s_states.pkl'
                           % (LAB, EXPT, ANIMAL, SESSION)), 'rb') as f:
        states = pickle.load(f)['states']
    for path, x in zip(states, latents):
        np.testing.assert_array_equal(path, fitted.most_likely_states(x))


@pytest.mark.parametrize('transitions,noise_type', [('recurrent', 'studentst'),
                                                    ('recurrent_only', 'diagonal_studentst')])
def test_cli_writes_recurrent_and_robust_versions(cli_run, transitions, noise_type):
    """The CLI fits recurrent transitions with Student's-t noise into the
    experiment store's ``<transitions>/<noise_type>`` directory; the fitted,
    usage-sorted model decodes every trial into its states pickle."""
    from behavenet_tpu_torch.fitting.hyperparams import get_all_params, run_grid_search
    _, _, latents, tmp = cli_run
    save_dir = os.path.join(tmp, transitions)
    _write_ae_store(save_dir, latents)
    args = _write_configs(tmp, save_dir, n_arhmm_states=[2], transitions=transitions,
                          noise_type=noise_type)
    run_grid_search(arhmm_grid_search.main, get_all_params('grid_search', args))
    vdir = os.path.join(save_dir, LAB, EXPT, ANIMAL, SESSION, 'arhmm', '%02i_latents' % D,
                        '02_states', transitions, noise_type, 'arhmm-expt', 'version_0')
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        meta = pickle.load(f)
    assert meta['training_completed'] and meta['transitions'] == transitions
    with open(os.path.join(vdir, 'metrics.csv'), newline='') as f:
        losses = [float(r['tr_loss']) for r in csv.DictReader(f) if r['tr_loss'] != '']
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    model = pickles.load_arhmm(os.path.join(vdir, 'best_val_model.pt'), device='cpu')
    assert model.transitions == transitions and model.robust
    assert model.observations == ('robust_ar' if noise_type == 'studentst'
                                  else 'diagonal_robust_ar')
    with open(os.path.join(vdir, '%s_%s_%s_%s_states.pkl'
                           % (LAB, EXPT, ANIMAL, SESSION)), 'rb') as f:
        states = pickle.load(f)['states']
    assert len(states) == N_TRIALS
    for path, x in zip(states, latents):
        np.testing.assert_array_equal(path, model.most_likely_states(x))


def test_cli_runs_on_the_gpu_unless_asked_for_the_cpu(cli_run):
    from behavenet_tpu_torch.fitting.hyperparams import get_all_params
    _, _, _, tmp = cli_run
    args = _write_configs(tmp, os.path.join(tmp, 'gpu'))
    hp = next(get_all_params('grid_search', args).trials())
    hp.pop('device')
    with pytest.raises(RuntimeError, match='CUDA'):
        arhmm_grid_search.main(hp)
    hp['device'] = 'tpu'
    with pytest.raises(ValueError, match='tpu'):
        arhmm_grid_search.main(hp)
