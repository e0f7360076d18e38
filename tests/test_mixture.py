"""Mixture-state machinery tests (analog of reference
tests/test_models.py:503-594 mixture tests + test_clustering.py mixture
trajectory tests)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributions_tpu import clustering, mixture as mx
from distributions_tpu.models import nich, gp, bb
from distributions_tpu.models import base
from distributions_tpu.ops import gibbs
from tests.util import assert_close

C = 8
PY = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})


def make_problem(seed=0, R=12, cols=2):
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.}),)
    values = (jnp.asarray(rng.randn(R, cols), jnp.float32),)
    assignments = jnp.asarray(rng.randint(0, 3, R), jnp.int32)
    return spec, shareds, values, assignments


def naive_feature_scores(spec, shareds, values, assignments, row):
    """Per-slot feature scores built group-by-group with scalar ops."""
    R = assignments.shape[0]
    scores = np.zeros(C)
    for block, shared, vals, rowvals in zip(
            spec.blocks, shareds, values, row):
        for k in range(C):
            rows_k = [i for i in range(R) if int(assignments[i]) == k]
            for j in range(block.cols):
                g = block.module.group_init(shared)
                for i in rows_k:
                    g = block.module.add_value(shared, g, vals[i, j])
                scores[k] += float(block.module.score_value(
                    shared, g, rowvals[j]))
    return scores


def test_init_invariants():
    spec, shareds, values, assignments = make_problem()
    state = mx.init(spec, shareds)
    assert int(state.sample_size) == 0
    assert int(mx.group_count(state)) == 1  # one reserved empty
    state = mx.init(spec, shareds, counts=[3, 0, 2])
    assert int(state.sample_size) == 5
    alive = np.asarray(state.alive)
    counts = np.asarray(state.counts)
    assert alive[counts > 0].all()
    assert (alive & (counts == 0)).sum() == 1


def test_state_from_assignments_matches_sequential():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    # counts match bincount
    expected_counts = np.bincount(np.asarray(assignments), minlength=C)
    assert np.asarray(state.counts).tolist() == expected_counts.tolist()
    # feature group stats match per-group sequential construction
    block, shared = spec.blocks[0], shareds[0]
    for k in range(C):
        for j in range(block.cols):
            g = block.module.group_init(shared)
            for i in range(assignments.shape[0]):
                if int(assignments[i]) == k:
                    g = block.module.add_value(shared, g, values[0][i, j])
            got = jax.tree_util.tree_map(
                lambda a: a[k, j], state.groups[0])
            assert_close(block.module.group_to_dict(got),
                         block.module.group_to_dict(g), tol=1e-3)


def test_score_value_matches_naive():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    row = tuple(v[0] for v in values)
    scores = np.asarray(mx.score_value(spec, PY, shareds, state, row))

    counts = np.asarray(state.counts)
    alive = np.asarray(state.alive)
    cl_scores = np.asarray(clustering.py_score_value(
        PY, state.counts, state.alive, state.sample_size))
    feat = naive_feature_scores(spec, shareds, values, assignments, row)
    expected = cl_scores + np.where(alive, feat, 0.0)
    dead = ~alive
    assert np.isneginf(scores[dead]).all()
    assert_close(scores[alive], expected[alive], tol=1e-3)


def test_add_remove_roundtrip():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    row = tuple(v[3] for v in values)
    k = assignments[3]
    state2, died = mx.remove_value(spec, PY, shareds, state, k, row)
    state3, born = mx.add_value(spec, PY, shareds, state2, k, row)
    assert np.asarray(state3.counts).tolist() == \
        np.asarray(state.counts).tolist()
    assert int(state3.sample_size) == int(state.sample_size)
    for g3, g in zip(state3.groups, state.groups):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4), g3, g)


def test_group_birth_and_death():
    spec, shareds, values, _ = make_problem()
    state = mx.init(spec, shareds)
    row = tuple(v[0] for v in values)
    # add to the single empty slot -> birth: a new empty activates
    state, born = mx.add_value(spec, PY, shareds, state, 0, row)
    assert bool(born)
    assert int(mx.group_count(state)) == 2
    assert int(state.counts[0]) == 1
    # remove it -> death: slot deactivates
    state, died = mx.remove_value(spec, PY, shareds, state, 0, row)
    assert bool(died)
    assert int(state.counts.sum()) == 0


def test_score_batch_matches_score_value():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    batch = mx.score_batch(spec, PY, shareds, state, values)
    for i in range(assignments.shape[0]):
        row = tuple(v[i] for v in values)
        single = mx.score_value(spec, PY, shareds, state, row)
        alive = np.asarray(state.alive)
        assert_close(np.asarray(batch[i])[alive],
                     np.asarray(single)[alive], tol=1e-3)


def test_tile_roundtrip():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    state2 = mx.remove_tile(spec, PY, shareds, state, values, assignments)
    assert int(state2.sample_size) == 0
    assert int(np.asarray(state2.counts).sum()) == 0
    state3 = mx.add_tile(spec, PY, shareds, state2, values, assignments)
    assert np.asarray(state3.counts).tolist() == \
        np.asarray(state.counts).tolist()
    for g3, g in zip(state3.groups, state.groups):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-3), g3, g)


def test_score_data_matches_parts():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    total = float(mx.score_data(spec, PY, shareds, state))
    expected = float(clustering.score_counts(PY, state.counts))
    block, shared = spec.blocks[0], shareds[0]
    for k in range(C):
        for j in range(block.cols):
            g = jax.tree_util.tree_map(lambda a: a[k, j], state.groups[0])
            expected += float(block.module.score_data(shared, g))
    assert_close(total, expected, tol=1e-3)


def test_sweep_sequential_runs():
    spec, shareds, values, assignments = make_problem(R=16)
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    key = jax.random.PRNGKey(0)
    state2, assignments2 = gibbs.sweep_sequential(
        spec, PY, shareds, state, values, assignments, key)
    counts = np.asarray(state2.counts)
    assert counts.sum() == 16
    expected = np.bincount(np.asarray(assignments2), minlength=C)
    assert counts.tolist() == expected.tolist()
    alive = np.asarray(state2.alive)
    assert (alive & (counts == 0)).sum() >= 1


def test_sweep_blocked_runs():
    spec, shareds, values, assignments = make_problem(R=16)
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    key = jax.random.PRNGKey(0)
    for block_size in [1, 4, 16]:
        state2, assignments2 = gibbs.sweep_blocked(
            spec, PY, shareds, state, values, assignments, block_size,
            key=key)
        counts = np.asarray(state2.counts)
        assert counts.sum() == 16, block_size
        expected = np.bincount(np.asarray(assignments2), minlength=C)
        assert counts.tolist() == expected.tolist()


def test_sequential_init_runs():
    spec, shareds, values, _ = make_problem(R=16)
    state = mx.init(spec, shareds)
    key = jax.random.PRNGKey(1)
    state2, assignments = gibbs.sequential_init(
        spec, PY, shareds, state, values, key)
    assert int(state2.sample_size) == 16
    counts = np.asarray(state2.counts)
    expected = np.bincount(np.asarray(assignments), minlength=C)
    assert counts.tolist() == expected.tolist()


def test_grow_capacity():
    spec, shareds, values, assignments = make_problem()
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    score_before = float(mx.score_data(spec, PY, shareds, state))
    new_spec, new_state = mx.grow_capacity(spec, state, 2 * C)
    assert new_spec.capacity == 2 * C
    counts = np.asarray(new_state.counts)
    assert counts.shape == (2 * C,)
    assert counts[:C].tolist() == np.asarray(state.counts).tolist()
    assert (counts[C:] == 0).all()
    score_after = float(mx.score_data(new_spec, PY, shareds, new_state))
    assert abs(score_before - score_after) < 1e-3
    # sweeps keep working at the new capacity
    key = jax.random.PRNGKey(0)
    st, an = gibbs.sweep_blocked(
        new_spec, PY, shareds, new_state, values, assignments, 4, key=key)
    assert np.asarray(st.counts).sum() == assignments.shape[0]
    assert not mx.needs_growth(new_spec, new_state)


def test_heterogeneous_blocks():
    """Mixed feature blocks (nich x2 + gp x1 + bb x1) through init, scoring,
    blocked sweep, and score_data."""
    rng = np.random.RandomState(0)
    R = 48
    spec = mx.make_spec([(nich, 2), (gp, 1), (bb, 1)], capacity=C, empties=1)
    shareds = (
        nich.shared_from_dict({'mu': 0., 'kappa': .1, 'sigmasq': 1., 'nu': 1.}),
        gp.shared_from_dict({'alpha': 1.0, 'inv_beta': 0.5}),
        bb.shared_from_dict({'alpha': 0.5, 'beta': 0.5}),
    )
    labels = rng.randint(0, 2, R)
    values = (
        jnp.asarray(np.array([[-2., -2.], [2., 2.]])[labels]
                    + 0.3 * rng.randn(R, 2), jnp.float32),
        jnp.asarray(rng.poisson(np.where(labels == 0, 2.0, 20.0))[:, None]),
        jnp.asarray((rng.rand(R) < np.where(labels == 0, .1, .9))[:, None]),
    )
    assignments = jnp.asarray(rng.randint(0, 3, R), jnp.int32)
    state = mx.state_from_assignments(spec, PY, shareds, values, assignments)
    # score_batch matches per-row score_value on alive slots
    batch = np.asarray(mx.score_batch(spec, PY, shareds, state, values))
    row = tuple(v[0] for v in values)
    single = np.asarray(mx.score_value(spec, PY, shareds, state, row))
    alive = np.asarray(state.alive)
    np.testing.assert_allclose(batch[0][alive], single[alive],
                               rtol=1e-3, atol=1e-3)
    # sweeps converge toward the 2 true clusters
    key = jax.random.PRNGKey(0)
    for _ in range(12):
        key, sub = jax.random.split(key)
        state, assignments = gibbs.sweep_blocked(
            spec, PY, shareds, state, values, assignments, 16, key=sub)
    a = np.asarray(assignments)
    purity = sum(np.bincount(labels[a == k]).max()
                 for k in np.unique(a)) / R
    assert purity > 0.9, purity
    assert np.isfinite(float(mx.score_data(spec, PY, shareds, state)))


def test_log_predictive_matches_score_data_chain_rule():
    """log_predictive == logsumexp_k [score_data(state + x at k)
    - score_data(state)] (the reference's chain-rule identity,
    tests/test_models.py:229-251, marginalized over the assignment)."""
    import jax
    from distributions_tpu.models import nich as nich_mod
    rng = np.random.RandomState(4)
    spec = mx.make_spec([(nich_mod, 2)], capacity=8, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    shareds = (nich_mod.shared_from_dict(
        {'mu': 0., 'kappa': 0.5, 'sigmasq': 1.0, 'nu': 2.}),)
    values = (jnp.asarray(rng.randn(12, 2), jnp.float32),)
    assignments = jnp.asarray(rng.randint(0, 3, 12), jnp.int32)
    state = mx.state_from_assignments(spec, cl, shareds, values, assignments)

    new_rows = (jnp.asarray(rng.randn(5, 2), jnp.float32),)
    got = np.asarray(mx.log_predictive(spec, cl, shareds, state, new_rows))

    base = float(mx.score_data(spec, cl, shareds, state))
    want = []
    for i in range(5):
        row = tuple(v[i] for v in new_rows)
        per_k = []
        for k in range(spec.capacity):
            if not bool(state.alive[k]):
                continue
            st2, _ = mx.add_value(spec, cl, shareds, state, k, row)
            per_k.append(float(mx.score_data(spec, cl, shareds, st2)) - base)
        want.append(float(jax.scipy.special.logsumexp(jnp.asarray(per_k))))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_exact_onehot_matmul_is_exact():
    """The one-hot contraction (a Precision.HIGHEST matmul) must equal a
    float64 reference to within one f32 ulp of each output (a
    default-precision f32 matmul may run in TF32 on the GPU — this helper
    is what keeps the stat sums exact; see
    models/base.exact_onehot_matmul)."""
    import numpy as np
    from distributions_tpu.models import base

    rng = np.random.RandomState(0)
    B, K, S = 1024, 64, 6
    ids = rng.randint(0, K, B)
    onehot_t = (np.arange(K)[:, None] == ids[None, :]).astype(np.float32)
    # mix of large ints (log_prod-style), small floats, squares
    data = np.concatenate([
        rng.randint(0, 1 << 20, (B, 2)).astype(np.float32),
        rng.randn(B, 2).astype(np.float32) * 100,
        (rng.randn(B, 2).astype(np.float32) * 30) ** 2,
    ], axis=1)
    got = np.asarray(base.exact_onehot_matmul(
        jnp.asarray(onehot_t), jnp.asarray(data)))
    want = onehot_t.astype(np.float64) @ data.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-3)

    # integer sums below 2^24 reconstruct EXACTLY
    ints = rng.randint(0, 1 << 12, (B, 3)).astype(np.float32)
    got_i = np.asarray(base.exact_onehot_matmul(
        jnp.asarray(onehot_t), jnp.asarray(ints)))
    want_i = onehot_t.astype(np.float64) @ ints.astype(np.float64)
    np.testing.assert_array_equal(got_i, want_i.astype(np.float32))


def test_tile_deltas_fast_chunked_matches_unchunked(monkeypatch):
    """The row-chunked one-hot contraction (large-capacity regimes where
    a [C, B] one-hot would be too large) gives the SAME tile deltas as
    the single contraction — counts exactly, stats to f32 accumulation
    order."""
    from distributions_tpu import mixture as mx
    from distributions_tpu.models import nich

    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, 2)], capacity=16, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': .1, 'sigmasq': 1., 'nu': 1.}),)
    B = 4096
    values = (jnp.asarray(rng.randn(B, 2), jnp.float32),)
    an = jnp.asarray(rng.randint(0, 12, B), jnp.int32)
    rs = mx.precompute_row_stats(spec, shareds, values)

    cd_a, tiles_a = mx.tile_deltas_fast(spec, shareds, rs, an)
    monkeypatch.setattr(base, 'ONEHOT_CHUNK_LIMIT', 16 * 1500)  # 2 chunks + tail
    cd_b, tiles_b = mx.tile_deltas_fast(spec, shareds, rs, an)

    np.testing.assert_array_equal(np.asarray(cd_a), np.asarray(cd_b))
    for a, b in zip(jax.tree_util.tree_leaves(tiles_a),
                    jax.tree_util.tree_leaves(tiles_b)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-4)
    # counts agree with bincount ground truth
    np.testing.assert_array_equal(
        np.asarray(cd_a), np.bincount(np.asarray(an), minlength=16))


def test_segment_sum_chunked_matches(monkeypatch):
    """base.segment_sum's row-chunked path (large B*K) is exact,
    including a non-power-of-two tail chunk."""
    rng = np.random.RandomState(3)
    B, K = 1000, 16   # chunk=300 -> 3 chunks + a 100-row tail
    data = rng.randn(B, 3).astype(np.float32)
    ids = rng.randint(0, K, B).astype(np.int32)
    want = np.zeros((K, 3), np.float32)
    np.add.at(want, ids, data)

    got_plain = np.asarray(base.segment_sum(
        jnp.asarray(data), jnp.asarray(ids), K))
    monkeypatch.setattr(base, 'ONEHOT_CHUNK_LIMIT', 16 * 300)
    got_chunked = np.asarray(base.segment_sum(
        jnp.asarray(data), jnp.asarray(ids), K))
    np.testing.assert_allclose(got_plain, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_chunked, want, rtol=1e-6, atol=1e-4)
