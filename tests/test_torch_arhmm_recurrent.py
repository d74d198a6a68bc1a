"""The port's recurrent transitions and Student's-t observations
(``behavenet_tpu_torch.ops.hmm`` over a time-varying ``log_P``,
``models.arhmm.robust_log_likes``, the recurrent and robust EM) against the
JAX package's, on the CPU (plain versions of K8-K11), at K = 3 states,
D = 3 and three trials of unequal length (40, 52, 60 frames), so the
padded, masked and wrapped-history paths all run.

Tolerances: log_Z rtol 1e-5 and posteriors atol 1e-5 (float32 recursions
in another summation order); log-likelihoods and tau rtol 1e-5; EM
log-likelihoods rtol 1e-5 (the standard of the stationary EM tests). The
EM parameters are held to atol 1e-4, and the Student's-t dof ``nus`` to
rtol 1e-4: the nu step differentiates ``log(nu/2) - digamma(nu/2)`` by a
forward difference of step 1e-3 nu in float32, which magnifies the last
bits in which ``torch.digamma`` and ``jax.scipy.special.digamma`` differ
(measured here: at most 5.3e-6 relative over three iterations).
"""

import jax
import numpy as np
import pytest
import torch

from behavenet_tpu.models.arhmm import ARHMM as JaxARHMM
from behavenet_tpu.ops import hmm as jhmm
from behavenet_tpu_torch.models import arhmm
from behavenet_tpu_torch.models.arhmm import ARHMM
from behavenet_tpu_torch.ops import hmm
from behavenet_tpu_torch.utils import pickles
from behavenet_tpu_torch.utils.weights import arhmm_params_from_jax

K, D = 3, 3
LENGTHS = (52, 40, 60)          # the last is the padded length: its lag wraps
T_MAX = max(LENGTHS)
EM_ITERS = 3


def sample_trials(seed=0, df=3.0):
    """Trials of a seeded K-state AR(1) process with Student's-t noise of
    ``df`` degrees of freedom (outliers for the robust observations)."""
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
            noise = rs.standard_t(df, size=D)
            x[t] = As[z] @ (x[t - 1] - means[z]) + means[z] + 0.3 * noise
        trials.append(x.astype(np.float32))
    return trials


@pytest.fixture(scope='module')
def datas():
    return sample_trials()


def _padded(datas):
    x, mask = ARHMM(K, D, device='cpu').pad(datas)
    return x, mask


def _np_params(model):
    return {k: np.asarray(v) for k, v in model.params.items()}


# ----------------------------------------------- time-varying message passing


@pytest.fixture(scope='module')
def chain():
    """A (N, T-1, K, K) log_P and (N, T, K) log-likelihoods of padded trials."""
    rs = np.random.RandomState(1)
    N = len(LENGTHS)
    logits = rs.randn(N, T_MAX - 1, K, K) * 1.5 + 2.0 * np.eye(K)
    log_P = logits - np.log(np.exp(logits).sum(axis=3, keepdims=True))
    mask = np.zeros((N, T_MAX))
    for i, T in enumerate(LENGTHS):
        mask[i, :T] = 1.0
    log_lik = rs.randn(N, T_MAX, K) * 3.0 * mask[:, :, None]
    pi0 = np.log(rs.dirichlet(np.ones(K)))
    f32 = np.float32
    return pi0.astype(f32), log_P.astype(f32), log_lik.astype(f32), mask.astype(f32)


@pytest.fixture(scope='module')
def jax_chain(chain):
    """JAX's forward, backward, forward-backward, expected transitions and
    Viterbi over the time-varying chain, vmapped and compiled once."""
    def one(pi0, lp, ll, m):
        alpha, log_z = jhmm.forward(pi0, lp, ll, m)
        return dict(alpha=alpha, log_z=log_z, beta=jhmm.backward(lp, ll, m),
                    fb=jhmm.forward_backward(pi0, lp, ll, m),
                    xi=jhmm.expected_transitions(pi0, lp, ll, m),
                    path=jhmm.viterbi(pi0, lp, ll, m))
    out = jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0)))(*chain)
    return jax.tree_util.tree_map(np.asarray, out)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_time_varying_forward_backward_match_jax(chain, jax_chain):
    pi0, lp, ll, m = _t(*chain)
    alpha, log_z = hmm.forward_plain(pi0, lp, ll, m)
    np.testing.assert_allclose(log_z.numpy(), jax_chain['log_z'], rtol=1e-5)
    np.testing.assert_allclose(alpha.numpy(), jax_chain['alpha'], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(hmm.backward_plain(lp, ll, m).numpy(), jax_chain['beta'],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(hmm.log_normalizer(pi0, lp, ll, m).numpy(),
                               jax_chain['log_z'], rtol=1e-5)


def test_time_varying_posteriors_match_jax(chain, jax_chain):
    """gamma, log_Z and xi_sum as JAX's ``forward_backward``, and the per-step
    xi of the same passes as its ``expected_transitions``: normalized per
    step, zero on every step that touches a padded frame."""
    gamma, log_z, xi_sum, xi = hmm.forward_backward(*_t(*chain), with_xi=True)
    want_gamma, want_z, want_xi_sum = jax_chain['fb']
    np.testing.assert_allclose(log_z.numpy(), want_z, rtol=1e-5)
    np.testing.assert_allclose(gamma.numpy(), want_gamma, atol=1e-5)
    np.testing.assert_allclose(xi_sum.numpy(), want_xi_sum, atol=1e-5)
    np.testing.assert_allclose(xi.numpy(), jax_chain['xi'], atol=1e-5)
    np.testing.assert_allclose(hmm.expected_transitions_plain(*_t(*chain)).numpy(),
                               jax_chain['xi'], atol=1e-5)
    np.testing.assert_array_equal(xi.sum(dim=1).numpy(), xi_sum.numpy())
    short = LENGTHS[1]
    assert np.all(xi.numpy()[1, short - 1:] == 0)
    np.testing.assert_allclose(xi.numpy()[1, :short - 1].sum(axis=(1, 2)), 1.0, rtol=1e-5)
    # a stationary log_P broadcast over the steps gives the same xi
    pi0, lp, ll, m = _t(*chain)
    stat = torch.log_softmax(lp[0, 0], dim=1)
    xi_s = hmm.forward_backward(pi0, stat, ll, m, with_xi=True)[3]
    want = hmm.expected_transitions_plain(pi0, stat.expand_as(lp), ll, m)
    np.testing.assert_allclose(xi_s.numpy(), want.numpy(), atol=1e-6)


def test_time_varying_viterbi_matches_jax(chain, jax_chain):
    pi0, lp, ll, m = _t(*chain)
    path = hmm.viterbi(pi0, lp, ll, m)
    assert path.dtype == torch.int32
    np.testing.assert_array_equal(path.numpy(), jax_chain['path'])
    # the path's joint log-prob beats one state flipped anywhere
    score = hmm.path_log_prob(pi0, lp, ll, m, path)
    flipped = path.clone()
    flipped[:, 7] = (flipped[:, 7] + 1) % K
    assert torch.all(score > hmm.path_log_prob(pi0, lp, ll, m, flipped))


# ------------------------------------------------ Student's-t log-likelihoods


def _random_params(model, seed):
    """Seeded parameters away from the fresh model's: AR weights, offsets,
    SPD covariances, dofs in [2, 10]."""
    rs = np.random.RandomState(seed)
    p = _np_params(model)
    p['As'] = (p['As'] * 0.5 + 0.1 * rs.randn(*p['As'].shape)).astype(np.float32)
    p['bs'] = rs.randn(K, D).astype(np.float32)
    B = rs.randn(K, D, D)
    p['Sigmas'] = (0.3 * B @ np.swapaxes(B, 1, 2) + 0.2 * np.eye(D)).astype(np.float32)
    p['nus'] = rs.uniform(2, 10, size=K).astype(np.float32)
    return p


@pytest.mark.parametrize('obs,lags', [('robust_ar', 1), ('diagonal_robust_ar', 2),
                                      ('studentst', 0), ('diagonal_studentst', 0)])
def test_robust_log_likes_and_tau_match_jax(datas, obs, lags):
    """Student's-t log-likelihoods as JAX's ``_log_likes`` and the
    scale-mixture weights as its ``_tau_weights``, every frame: tau of the
    first ``lags`` frames reads the wrapped history of the padded trial
    (``jnp.roll``), which is the longest trial's last frames."""
    j = JaxARHMM(K, D, lags=lags, observations=obs, rng_seed=0)
    j.params = _random_params(j, seed=lags + 5)
    t = ARHMM(K, D, lags=lags, observations=obs, rng_seed=0, device='cpu')
    t.params = arhmm_params_from_jax(j.params, device='cpu')
    x, mask = _padded(datas)

    def jax_fn(params, xs, ms):
        return (jax.vmap(j._log_likes, in_axes=(None, 0, 0))(params, xs, ms),
                j._tau_weights(params, xs, ms))
    want_ll, want_tau = jax.jit(jax_fn)(j.params, x.numpy(), mask.numpy())
    ll, tau = t._log_likes(t.params, x, mask, with_tau=True)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tau.numpy(), np.asarray(want_tau), rtol=1e-5)
    assert np.all(ll.numpy()[1, LENGTHS[1]:] == 0)   # padded frames
    if lags:
        # the wrapped frames are not the zero-history ones: with ``lags``
        # zero frames appended, the wrap reads zeros
        x0 = torch.cat([x, torch.zeros(x.shape[0], lags, D)], dim=1)
        zero_hist = arhmm._maha(x0, t.params['As'], t.params['bs'],
                                *arhmm.obs_precision(t.params['Sigmas'], t.diagonal)[:1],
                                lags, t.diagonal)[:, :T_MAX]
        nus = t.params['nus']
        assert not torch.allclose(tau[2, :lags], ((nus + D) / (nus + zero_hist))[2, :lags])
    assert torch.equal(t._log_likes(t.params, x, mask), ll)


# ------------------------------------------------------------------------ EM


@pytest.fixture(scope='module', params=[('recurrent', 'robust_ar'),
                                        ('recurrent_only', 'diagonal_studentst')],
                ids=['recurrent-robust_ar', 'recurrent_only-diagonal_studentst'])
def em_pair(request, datas):
    """Three EM iterations of JAX's ARHMM and the port's from the same
    initialized params."""
    transitions, obs = request.param
    kw = dict(lags=1, observations=obs, transitions=transitions, rng_seed=2)
    t = ARHMM(K, D, device='cpu', **kw)
    t.initialize(datas)   # the port's k-means: no sklearn to import
    j = JaxARHMM(K, D, **kw)
    j.params = {k: jax.numpy.asarray(v.numpy()) for k, v in t.params.items()}
    init = _np_params(j)
    return j, t, init, j.fit(datas, num_iters=EM_ITERS), t.fit(datas, num_iters=EM_ITERS)


def test_em_matches_jax(em_pair):
    j, t, init, lls_j, lls_t = em_pair
    np.testing.assert_allclose(lls_t, lls_j, rtol=1e-5)
    assert lls_t[-1] > lls_t[0]
    for key, want in _np_params(j).items():
        got = t.params[key].numpy()
        if key == 'nus':
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=key)
    # every parameter the M-step owns moved: the recurrent Adam steps, the
    # robust weights and the dof
    moved = [k for k in init if not np.array_equal(init[k], t.params[k].numpy())]
    want_moved = {'log_pi0', 'Rs', 'bs', 'Sigmas', 'nus',
                  'log_Ps' if t.transitions == 'recurrent' else 'r'} | \
        ({'As'} if t.lags else set())
    assert want_moved <= set(moved), moved


def test_recurrent_model_decodes_as_jax(em_pair, datas):
    """``log_likelihood``, ``most_likely_states`` and ``expected_states`` of
    the fitted recurrent model against JAX's, trial by trial."""
    j, t = em_pair[:2]
    x, mask = _padded(datas)

    def one(params, xi, mi):
        ll = j._log_likes(params, xi, mi)
        lp = j._log_P(params, xi, mi)
        gamma, log_z, _ = jhmm.forward_backward(params['log_pi0'], lp, ll, mi)
        return jhmm.viterbi(params['log_pi0'], lp, ll, mi), gamma, log_z
    paths, gammas, log_z = jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))(
        j.params, x.numpy(), mask.numpy())
    np.testing.assert_allclose(t.log_likelihood(datas), np.sum(log_z), rtol=1e-5)
    got_paths = t.most_likely_states_batch(datas)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(got_paths[i], np.asarray(paths)[i, :len(d)])
        np.testing.assert_array_equal(t.most_likely_states(d), got_paths[i])
        np.testing.assert_allclose(t.expected_states(d), np.asarray(gammas)[i, :len(d)],
                                   atol=1e-4)


def test_permute_matches_jax(em_pair):
    """``permute`` relabels ``Rs`` and ``r`` with the rest, as JAX's."""
    j, t = em_pair[:2]
    perm = np.array([2, 0, 1])
    jp = JaxARHMM(K, D, lags=1, observations=j.observations, transitions=j.transitions)
    jp.params = _np_params(t)   # numpy arrays: JAX's permute indexes them as numpy
    jp.permute(perm)
    t.permute(perm)
    assert set(jp.params) == set(t.params)
    for key, want in jp.params.items():
        np.testing.assert_array_equal(t.params[key].numpy(), want, err_msg=key)


def test_recurrent_robust_model_pickles_round_trip(em_pair, tmp_path, datas):
    j, t = em_pair[:2]
    path = str(tmp_path / 'port.pt')
    t.save(path)
    back = ARHMM.load(path, device='cpu')
    assert back.recurrent and back.robust == t.robust
    for key, v in t.params.items():
        assert torch.equal(back.params[key], v), key
    np.testing.assert_array_equal(back.most_likely_states(datas[2]),
                                  t.most_likely_states(datas[2]))
    # and a JAX-written one (the JAX CLI's pickle) loads as the port's, with
    # JAX's parameters bit for bit
    jpath = str(tmp_path / 'jax.pt')
    j.save(jpath)
    loaded = pickles.load_arhmm(jpath, device='cpu')
    assert loaded.recurrent and loaded.robust == t.robust
    want = _np_params(j)
    assert set(loaded.params) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(loaded.params[key].numpy(), v, err_msg=key)
    assert len(loaded.most_likely_states(datas[0])) == len(datas[0])


def test_recurrent_m_step_is_adam_on_the_expected_transitions(em_pair, datas):
    """The recurrent M-step's 25 Adam steps as ``optax.adam(1e-2)`` on the
    same objective and the same per-step xi."""
    import optax
    j, t = em_pair[:2]
    x, mask = _padded(datas)
    params = {k: v.clone() for k, v in t.params.items()}
    ll = t._log_likes(params, x, mask)
    xis = hmm.expected_transitions_plain(params['log_pi0'], t._log_P(params, x), ll, mask)
    got = t._m_step_recurrent(params, x, xis)
    jparams = {k: jax.numpy.asarray(v.numpy()) for k, v in params.items()}
    xis_j = jax.numpy.asarray(xis.numpy())

    def objective(trans):
        p = dict(jparams, **trans)
        lp = jax.vmap(lambda xi, mi: j._log_P(p, xi, mi))(jax.numpy.asarray(x.numpy()),
                                                          jax.numpy.asarray(mask.numpy()))
        return -jax.numpy.sum(xis_j * lp)

    @jax.jit
    def run(trans):
        tx = optax.adam(1e-2)
        state = tx.init(trans)

        def body(carry, _):
            trans, state = carry
            updates, state = tx.update(jax.grad(objective)(trans), state, trans)
            return (optax.apply_updates(trans, updates), state), None
        return jax.lax.scan(body, (trans, state), None, length=25)[0][0]
    want = run({k: jparams[k] for k in ('log_Ps', 'Rs', 'r')})
    for key in ('log_Ps', 'Rs', 'r'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)


def test_ported_configurations_construct():
    """Every observation type with every transition type builds, on the CPU
    as asked, with ``parallel_scan`` too; float64 EM still raises."""
    for obs in ('ar', 'robust_ar', 'diagonal_robust_ar', 'studentst', 'diagonal_studentst'):
        for transitions in ('stationary', 'sticky', 'recurrent', 'recurrent_only'):
            m = ARHMM(K, D, observations=obs, transitions=transitions, device='cpu')
            assert m.robust == (obs != 'ar')
            assert ('Rs' in m.params) == m.recurrent
    assert ARHMM(K, D, observations='robust_ar', transitions='recurrent', device='cpu',
                 parallel_scan=True).parallel_scan
    with pytest.raises(NotImplementedError, match='A1c'):
        ARHMM(K, D, observations='robust_ar', transitions='recurrent', device='cpu',
              dtype='float64')
    with pytest.raises(ValueError):
        ARHMM(K, D, transitions='bogus', device='cpu')


def test_new_launchers_refuse_cpu_tensors(chain, datas):
    """The robust and time-varying launchers' wrappers take CUDA tensors
    only; nothing is launched (or counted) for a refused call."""
    from behavenet_tpu_torch.kernels import build
    before = dict(build.LAUNCHES)
    pi0, lp, ll, m = _t(*chain)
    for call in (lambda: hmm.forward_backward_cuda(pi0, lp, ll, m, with_xi=True),
                 lambda: hmm.log_normalizer_cuda(pi0, lp, ll, m),
                 lambda: hmm.viterbi_cuda(pi0, lp, ll, m)):
        with pytest.raises(ValueError, match='CUDA'):
            call()
    t = ARHMM(K, D, lags=1, observations='robust_ar', device='cpu')
    x, mask = _padded(datas)
    p = t.params
    prec, logdet = arhmm.obs_precision(p['Sigmas'], False)
    nus, c = arhmm.student_t_terms(p['nus'], logdet, D)
    with pytest.raises(ValueError, match='CUDA'):
        arhmm.robust_log_likes_cuda(x, mask, p['As'], p['bs'], prec, c, nus, 1, False, True)
    assert build.LAUNCHES == before
