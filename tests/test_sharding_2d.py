"""2-D (rows x components) mesh sweep tests on the 8-virtual-device CPU
mesh (2 row shards x 4 component shards)."""

import numpy as np

import jax
import jax.numpy as jnp

from distributions_tpu import clustering, mixture as mx
from distributions_tpu.models import nich
from distributions_tpu.parallel import sharding

PY = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})


def _saturated_problem(R=512, C=32, cols=2, seed=0):
    """Every slot occupied with a tight cluster: per-shard and global
    alive sets coincide (no empty slots), enabling exact-equality checks
    between the 2-D sharded sweep and the single-device scorer."""
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.1, 'nu': 1.}),)
    centers = 6.0 * rng.randn(C, cols).astype(np.float32)
    labels = np.concatenate([np.arange(C), rng.randint(0, C, R - C)])
    values = (jnp.asarray(
        centers[labels] + 0.1 * rng.randn(R, cols), jnp.float32),)
    assignments = jnp.asarray(labels, jnp.int32)
    return spec, shareds, values, assignments, labels


def test_2d_argmax_matches_single_device():
    spec, shareds, values, assignments, _ = _saturated_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    mesh = sharding.make_mesh_2d(2, 4)
    R = assignments.shape[0]

    st2, an2 = sharding.sharded_sweep_2d(
        spec, PY, shareds, sharding.shard_state_components(state, mesh),
        values, assignments, jax.random.PRNGKey(0), mesh, R // 2,
        sampling='argmax')

    # single-device reference: remove all, score, argmax, add all
    st = mx.remove_tile(spec, PY, shareds, state, values, assignments)
    scores = mx.score_batch(spec, PY, shareds, st, values)
    an_ref = jnp.argmax(scores, axis=1).astype(jnp.int32)
    st_ref = mx.add_tile(spec, PY, shareds, st, values, an_ref)

    np.testing.assert_array_equal(np.asarray(an2), np.asarray(an_ref))
    np.testing.assert_array_equal(np.asarray(st2.counts),
                                  np.asarray(st_ref.counts))
    assert int(st2.sample_size) == R


def test_2d_gumbel_sweep_invariants_and_purity():
    rng = np.random.RandomState(1)
    R, C, cols = 512, 32, 2
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    centers = np.array([[-4, -4], [4, 4], [-4, 4], [4, -4]], np.float32)
    labels = rng.randint(0, 4, R)
    values = (jnp.asarray(
        centers[labels] + 0.3 * rng.randn(R, cols), jnp.float32),)
    assignments = jnp.asarray(rng.randint(0, C, R), jnp.int32)
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    mesh = sharding.make_mesh_2d(2, 4)
    state = sharding.shard_state_components(state, mesh)

    key = jax.random.PRNGKey(2)
    for _ in range(15):
        key, sub = jax.random.split(key)
        state, assignments = sharding.sharded_sweep_2d(
            spec, PY, shareds, state, values, assignments, sub, mesh,
            block=32)

    counts = np.asarray(state.counts)
    a = np.asarray(assignments)
    assert counts.sum() == R
    np.testing.assert_array_equal(
        counts, np.bincount(a, minlength=C))
    assert int(state.sample_size) == R
    purity = sum(np.bincount(labels[a == k]).max()
                 for k in np.unique(a)) / len(labels)
    assert purity > 0.95, purity
    # every component shard keeps at least one alive empty slot
    alive = np.asarray(state.alive).reshape(4, -1)
    csh = counts.reshape(4, -1)
    assert ((alive & (csh == 0)).sum(axis=1) >= 1).all()
