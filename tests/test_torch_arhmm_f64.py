"""float64 EM of the port's ARHMM (``ARHMM(dtype='float64')``, the CLI's
``em_dtype: float64``) against the JAX package's ``ARHMM(dtype='float64')``
on the CPU (the plain versions of K8-K11 and K31), at K = 3 states, D = 3
and three trials of unequal length (30, 22, 26 frames).

JAX's float64 references run inside ``jax.enable_x64(True)`` only, never
through ``jax.config.update``: pytest-xdist runs many test files in one
worker process, and the JAX package's own tests behave differently with
x64 on. JAX's sequential Viterbi fails under x64 (its backpointers are
int64, its back scan's carry int32: ``behavenet_tpu/ops/hmm.py:199``,
``:209``, ``:216``), so ``most_likely_states`` is held to JAX's
``viterbi_parallel`` (``:225``), which computes the same paths.

Tolerances: float64 roundoff. The EM log-likelihoods within 1e-10
(relative), each parameter within 1e-9 of its largest entry after five
iterations (the dof's Newton steps and the recurrent transitions' 25 Adam
steps included), ``log_likelihood`` within 1e-10, ``expected_states``
within 1e-10, Viterbi paths exact.
"""

import csv
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.models.arhmm import _pad_datas
from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu_torch.fitting import arhmm_grid_search
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.utils import pickles
from behavenet_tpu_torch.utils.weights import arhmm_params_from_jax
from tests.jax_low import compile_low
from tests.test_torch_arhmm import (ANIMAL, EXPT, LAB, SESSION, _write_ae_store,
                                    _write_configs)

K, D = 3, 3
LENGTHS = (30, 22, 26)
EM_ITERS = 5
# config -> (observations, transitions, kappa)
CONFIGS = {'ar': ('ar', 'stationary', 0.0),
           'diagonal_ar-sticky': ('diagonal_ar', 'sticky', 10.0),
           'robust_ar-recurrent': ('robust_ar', 'recurrent', 0.0)}


def sample_trials(seed=0, df=4.0):
    """Trials of a seeded K-state AR(1) process with Student's-t noise."""
    rs = np.random.RandomState(seed)
    means = rs.randn(K, D)
    As = [0.6 * np.eye(D) + 0.1 * rs.randn(D, D) for _ in range(K)]
    trials = []
    for T in LENGTHS:
        z = rs.randint(K)
        x = np.zeros((T, D))
        x[0] = means[z]
        for t in range(1, T):
            if rs.rand() > 0.9:
                z = rs.randint(K)
            x[t] = As[z] @ (x[t - 1] - means[z]) + means[z] + 0.3 * rs.standard_t(df, size=D)
        trials.append(x)
    return trials


@pytest.fixture(scope='module')
def datas():
    return sample_trials()


def _jax_decode(j):
    """JAX's posteriors, log_Z and parallel Viterbi paths of padded trials."""
    def one(params, xi, mi):
        ll = j._log_likes(params, xi, mi)
        lp = j._log_P(params, xi, mi)
        gamma, log_z, _ = jhmm.forward_backward(params['log_pi0'], lp, ll, mi)
        return jhmm.viterbi_parallel(params['log_pi0'], lp, ll, mi), gamma, log_z
    return jax.vmap(one, in_axes=(None, 0, 0))


@pytest.fixture(scope='module', params=list(CONFIGS))
def em_pair(request, datas):
    """Five float64 EM iterations of JAX's ARHMM (its EM step compiled at
    level 0) and of the port's from JAX's initialized parameters, carried
    across unrounded; JAX's decoding of the fitted model."""
    obs, transitions, kappa = CONFIGS[request.param]
    kw = dict(lags=1, observations=obs, transitions=transitions, kappa=kappa, rng_seed=2,
              dtype='float64')
    with jax.enable_x64(True):
        j = JaxARHMM(K, D, **kw)
        j.initialize(datas)
        init = {k: np.array(v) for k, v in j.params.items()}
        x, mask = _pad_datas(datas, np.float64)
        j._fit_step = compile_low(j._em_step, j.params, x, mask)
        lls_j = j.fit(datas, num_iters=EM_ITERS)
        decoded = compile_low(_jax_decode(j), j.params, x, mask)(j.params, x, mask)
        decoded = [np.asarray(v) for v in decoded]
        params_j = {k: np.array(v) for k, v in j.params.items()}
    t = ARHMM(K, D, device='cpu', **kw)
    t.params = arhmm_params_from_jax(init, device='cpu', dtype=torch.float64)
    lls_t = t.fit(datas, num_iters=EM_ITERS)
    return t, params_j, lls_j, lls_t, decoded


def test_f64_em_matches_jax(em_pair):
    t, params_j, lls_j, lls_t, _ = em_pair
    np.testing.assert_allclose(lls_t, lls_j, rtol=1e-10, atol=0)
    assert lls_t[-1] > lls_t[0]
    assert set(t.params) == set(params_j)
    for key, want in params_j.items():
        got = t.params[key]
        assert got.dtype == torch.float64 and want.dtype == np.float64, key
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-9 * max(np.abs(want).max(), 1.0), (key, err)


def test_f64_decoding_matches_jax(em_pair, datas):
    """``log_likelihood``, ``expected_states`` and ``most_likely_states`` of
    the fitted float64 models: JAX's log_Z and posteriors, and the paths of
    JAX's ``viterbi_parallel``."""
    t, _, _, _, (paths, gammas, log_z) = em_pair
    np.testing.assert_allclose(t.log_likelihood(datas), log_z.sum(), rtol=1e-10, atol=0)
    for i, d in enumerate(datas):
        gamma = t.expected_states(d)
        assert gamma.dtype == np.float64
        np.testing.assert_allclose(gamma, gammas[i, :len(d)], rtol=0, atol=1e-10)
        np.testing.assert_array_equal(t.most_likely_states(d), paths[i, :len(d)])
    for got, want, d in zip(t.most_likely_states_batch(datas), paths, datas):
        np.testing.assert_array_equal(got, want[:len(d)])


def test_f64_pickles(em_pair, datas, tmp_path):
    """A port float64 model round-trips through its pickle, permuted; a
    JAX-written float64 ``best_val_model.pt`` loads as a float64 port model
    with JAX's parameters bit for bit (tests/test_torch_arhmm.py's
    subprocess loads one without importing jax)."""
    path = str(tmp_path / 'port.pt')
    em_pair[0].save(path)
    t = pickles.load_arhmm(path, device='cpu')   # a copy, permuted below
    t.permute(np.array([2, 0, 1]))
    t.save(path)
    back = pickles.load_arhmm(path, device='cpu')
    assert back.dtype == 'float64'
    for key, v in t.params.items():
        assert v.dtype == torch.float64 and torch.equal(back.params[key], v), key
    np.testing.assert_array_equal(back.most_likely_states(datas[0]),
                                  t.most_likely_states(datas[0]))
    with jax.enable_x64(True):
        j = JaxARHMM(K, D, lags=1, observations='robust_ar', transitions='recurrent',
                     rng_seed=5, dtype='float64')
        j.save(str(tmp_path / 'jax.pt'))
        want = {k: np.array(v) for k, v in j.params.items()}
    m = pickles.load_arhmm(str(tmp_path / 'jax.pt'), device='cpu')
    assert m.dtype == 'float64' and m.recurrent and m.robust
    for key, v in want.items():
        assert m.params[key].dtype == torch.float64, key
        np.testing.assert_array_equal(m.params[key].numpy(), v, err_msg=key)


def test_f64_cli_writes_a_version(tmp_path):
    """The port's CLI with ``em_dtype: float64`` on the CPU: a completed
    version whose pickled model is float64, whose train losses (the
    negative LL per datapoint) never rise, and whose states pickle holds the
    model's Viterbi paths."""
    from behavenet_tpu_torch.fitting.hyperparams import get_all_params, run_grid_search
    from tests.test_torch_arhmm import N_TRIALS, sample_trials as cli_trials
    tmp = str(tmp_path)
    save_dir = os.path.join(tmp, 'save')
    latents = cli_trials([24 + 2 * i for i in range(N_TRIALS)], seed=7)
    _write_ae_store(save_dir, latents)
    args = _write_configs(tmp, save_dir, n_arhmm_states=[2], em_dtype='float64')
    run_grid_search(arhmm_grid_search.main, get_all_params('grid_search', args))
    vdir = os.path.join(save_dir, LAB, EXPT, ANIMAL, SESSION, 'arhmm', '%02i_latents' % D,
                        '02_states', 'stationary', 'gaussian', 'arhmm-expt', 'version_0')
    with open(os.path.join(vdir, 'meta_tags.pkl'), 'rb') as f:
        meta = pickle.load(f)
    assert meta['training_completed'] and meta['em_dtype'] == 'float64'
    with open(os.path.join(vdir, 'metrics.csv'), newline='') as f:
        rows = [r for r in csv.DictReader(f) if r['tr_loss'] != '' and r['dataset'] == '-1']
    losses = [float(r['tr_loss']) for r in rows]
    assert len(losses) == 4 and all(b <= a for a, b in zip(losses, losses[1:])), losses
    model = pickles.load_arhmm(os.path.join(vdir, 'best_val_model.pt'), device='cpu')
    assert model.dtype == 'float64'
    assert all(v.dtype == torch.float64 for v in model.params.values())
    with open(os.path.join(vdir, '%s_%s_%s_%s_states.pkl'
                           % (LAB, EXPT, ANIMAL, SESSION)), 'rb') as f:
        states = pickle.load(f)['states']
    assert len(states) == N_TRIALS
    for path, x in zip(states, latents):
        np.testing.assert_array_equal(path, model.most_likely_states(x))


def test_f64_unported_paths_raise(datas):
    """float64 with ``parallel_scan``, ``posterior_sample``, ``sample`` and
    ``sample_x`` raise, naming the rest of ROADMAP A1c (K13-K16 in
    float64); float32 keeps them."""
    with pytest.raises(NotImplementedError, match='A1c'):
        ARHMM(K, D, dtype='float64', parallel_scan=True, device='cpu')
    m = ARHMM(K, D, dtype='float64', device='cpu')
    for call in (lambda: m.posterior_sample(datas[0]), lambda: m.sample(10),
                 lambda: m.sample_x(np.zeros(10, dtype=np.int32))):
        with pytest.raises(NotImplementedError, match='A1c'):
            call()
    with pytest.raises(ValueError, match='float64'):
        ARHMM(K, D, dtype='float16', device='cpu')
    assert ARHMM(K, D, device='cpu').sample(10)[1].shape == (10, D)


def test_f64_bayesian_decoder_refused():
    """The Bayesian decoder on a float64 ARHMM (as a float64
    ``best_val_model.pt`` loads) raises, naming the rest of ROADMAP A1c,
    before it builds any float32 tensor beside the float64 parameters; a
    float32 ARHMM still builds one."""
    from behavenet_tpu_torch.models.bayesian import BayesianDecoder
    with pytest.raises(NotImplementedError, match='A1c'):
        BayesianDecoder(ARHMM(K, D, dtype='float64', device='cpu'))
    assert BayesianDecoder(ARHMM(K, D, device='cpu')).K == K
