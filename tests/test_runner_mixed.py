"""run_gibbs end to end on mixed-family specs through the XLA blocked
sweep: growth, niw dimensions, other priors, tiling and step grouping.
Each case ends in checks.check_state (counts, rebuilt stats, joint
score)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributions_tpu import checks, clustering, mixture as mx
from distributions_tpu.inference import runner
from distributions_tpu.models import bb, dd, dpd, gp, nich, niw

PY = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})


def _mixed(R=512, C=64, seed=0):
    return checks.mixed_problem(R, C, n_true=8, seed=seed)


def test_mixed_spec_multi_tile_run():
    spec, cl, sh, values, labels = _mixed()
    state, an, log = runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(0), passes=4, block=64,
        initial_assignments=labels)
    checks.check_state(spec, cl, sh, values, state, an)
    assert len(log.rows) == 4


def test_mixed_spec_sweeps_per_step_boundaries():
    spec, cl, sh, values, labels = _mixed()
    state, an, log = runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(1), passes=7, block=128,
        initial_assignments=labels, sweeps_per_step=3)
    assert [r['sweeps'] for r in log.rows] == [3, 3, 1]
    assert [r['sweep'] for r in log.rows] == [2, 5, 6]
    checks.check_state(spec, cl, sh, values, state, an)


def test_mixed_spec_grows_capacity():
    """A random init over all slots of a small capacity forces growth;
    the grown state stays consistent with the assignments."""
    spec, cl, sh, values, _ = checks.mixed_problem(512, 16, n_true=12)
    state, an, log = runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(2), passes=3, block=128,
        init='random:16')
    assert state.counts.shape[0] >= 32
    grown = spec._replace(capacity=int(state.counts.shape[0]))
    checks.check_state(grown, cl, sh, values, state, an)


def test_dpd_growth_run():
    """dpd with capacity growth mid-run: the value table is unchanged and
    the per-slot counts stay exact."""
    rng = np.random.RandomState(5)
    spec = mx.make_spec([(dpd, 1), (nich, 1)], capacity=8, empties=1)
    sh = (dpd.shared_from_dict({'gamma': 1.0, 'alpha': 1.0,
                                'betas': {i: 1.0 / 8 for i in range(6)}},
                               cap=16),
          nich.shared_from_dict({'mu': 0., 'kappa': .1, 'sigmasq': 1.,
                                 'nu': 1.}))
    labels = rng.randint(0, 6, 384)
    values = (jnp.asarray(rng.randint(0, 6, (384, 1)), jnp.int32),
              jnp.asarray(3.0 * labels[:, None] + 0.3 * rng.randn(384, 1),
                          jnp.float32))
    state, an, _ = runner.run_gibbs(
        spec, PY, sh, values, jax.random.PRNGKey(3), passes=3, block=128,
        init='random:8')
    C = int(state.counts.shape[0])
    assert C > 8
    checks.check_state(spec._replace(capacity=C), PY, sh, values, state, an)


@pytest.mark.parametrize('d', [2, 3])
def test_niw_run_and_argmax_scores(d):
    """niw blocks of dimension d: run_gibbs keeps the invariants, and
    scored against the generating partition every well-separated row's
    best slot is its own cluster."""
    rng = np.random.RandomState(9)
    R, C = 384, 32
    spec = mx.make_spec([(niw, 1), (bb, 1)], capacity=C, empties=1)
    sh = (niw.shared_from_dict({'mu': np.zeros(d), 'kappa': 1.0,
                                'psi': np.eye(d), 'nu': d + 1.0}),
          bb.shared_from_dict({'alpha': 0.5, 'beta': 0.5}))
    labels = rng.randint(0, 3, R)
    centers = np.array([[-4.] * d, [0.] * d, [4.] * d])
    values = (jnp.asarray((centers[labels]
                           + 0.5 * rng.randn(R, d))[:, None, :],
                          jnp.float32),
              jnp.asarray((rng.rand(R) < 0.3)[:, None]))
    state = mx.state_from_assignments(spec, PY, sh, values,
                                      jnp.asarray(labels))
    scores = mx.score_batch(spec, PY, sh, state, values)
    np.testing.assert_array_equal(np.argmax(np.asarray(scores), 1), labels)
    state, an, _ = runner.run_gibbs(
        spec, PY, sh, values, jax.random.PRNGKey(4), passes=3, block=128,
        initial_assignments=labels)
    checks.check_state(spec, PY, sh, values, state, an)


def test_low_entropy_prior_run():
    spec, _, sh, values, labels = _mixed()
    le = clustering.LowEntropy.from_dict({'dataset_size': 512})
    state, an, _ = runner.run_gibbs(
        spec, le, sh, values, jax.random.PRNGKey(6), passes=3, block=128,
        initial_assignments=labels)
    checks.check_state(spec, le, sh, values, state, an)


def test_pure_discrete_spec_run():
    rng = np.random.RandomState(1)
    R, C = 256, 32
    spec = mx.make_spec([(dd, 1), (bb, 1), (gp, 1)], capacity=C, empties=1)
    sh = (dd.shared_from_dict({'alphas': [1.0, 0.5, 2.0, 1.5]}),
          bb.shared_from_dict({'alpha': 0.5, 'beta': 0.5}),
          gp.shared_from_dict({'alpha': 1.0, 'inv_beta': 0.5}))
    labels = rng.randint(0, 3, R)
    values = (jnp.asarray(np.where(labels == 0, rng.randint(0, 2, R),
                                   rng.randint(2, 4, R))[:, None],
                          jnp.int32),
              jnp.asarray((rng.rand(R) < 0.5)[:, None]),
              jnp.asarray(rng.poisson(2.0 + 4 * labels)[:, None],
                          jnp.int32))
    state, an, _ = runner.run_gibbs(
        spec, PY, sh, values, jax.random.PRNGKey(7), passes=3, block=64,
        initial_assignments=labels)
    checks.check_state(spec, PY, sh, values, state, an)
