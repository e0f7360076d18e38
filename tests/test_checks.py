"""The end-to-end checks of distributions_tpu.checks at small sizes on the
CPU (chip_smoke.py runs the same functions at full width on the GPU)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributions_tpu import checks, clustering, mixture as mx
from distributions_tpu.inference import runner
from distributions_tpu.models import nich
from distributions_tpu.parallel import sharding


def _single_family(family, R=512, C=32, seed=0):
    """The `family` block of checks.mixed_problem as a spec of its own."""
    spec, cl, sh, values, labels = checks.mixed_problem(R, C, n_true=8,
                                                        seed=seed)
    i = checks.MIXED_FAMILIES.index(family)
    one = mx.make_spec([(spec.blocks[i].module, spec.blocks[i].cols)],
                       capacity=C, empties=1)
    return one, cl, (sh[i],), (values[i],), labels


@pytest.mark.parametrize('family', checks.MIXED_FAMILIES + ('mixed',))
def test_score_batch_matches_hp(family):
    """mixture.score_batch agrees with the float64 hp flavor within each
    family's stated tolerance."""
    if family == 'mixed':
        spec, cl, sh, values, labels = checks.mixed_problem(512, 32,
                                                            n_true=8)
    else:
        spec, cl, sh, values, labels = _single_family(family)
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    rows = tuple(v[:64] for v in values)
    worst = checks.check_scores_vs_hp(spec, cl, sh, state, rows)
    assert set(worst) >= {'clustering'}
    assert all(np.isfinite(e) for e in worst.values())


@pytest.mark.parametrize('family', checks.MIXED_FAMILIES)
def test_run_gibbs_keeps_state_invariants(family):
    """Each family alone through run_gibbs from a random init keeps the
    invariants check_state asserts."""
    spec, cl, sh, values, _ = _single_family(family)
    state, an, log = runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(1), passes=3, block=128,
        init='random:4')
    res = checks.check_state(spec, cl, sh, values, state, an)
    assert res['rows'] == 512 and len(log.rows) == 3


def test_check_state_detects_drift():
    spec, cl, sh, values, labels = checks.flagship_problem(1024, 64)
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    checks.check_state(spec, cl, sh, values, state, labels)
    g = state.groups[0]
    bad = state._replace(groups=(g._replace(mean=g.mean * 1.01),))
    with pytest.raises(AssertionError, match='drifted'):
        checks.check_state(spec, cl, sh, values, bad, labels)
    moved = np.array(labels)
    moved[0] = (moved[0] + 1) % 64
    with pytest.raises(AssertionError):
        checks.check_state(spec, cl, sh, values, state, moved)


def test_check_scores_vs_hp_detects_error():
    spec, cl, sh, values, labels = _single_family('gp')
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    tight = dict(checks.SCORE_RTOL, gp=0.0)
    with pytest.raises(AssertionError, match='gp'):
        checks.check_scores_vs_hp(spec, cl, sh, state,
                                  tuple(v[:32] for v in values), rtol=tight)


def test_check_resume_small():
    spec, cl, sh, values, labels = checks.flagship_problem(1024, 64)
    res = checks.check_resume(spec, cl, sh, values, jax.random.PRNGKey(4),
                              passes=4, every=2, block=256,
                              initial_assignments=labels,
                              grow_headroom=0.0)
    assert res['differing_rows'] == 0


def test_first_tile_reference_matches_sharded_sweep():
    """The one-device first-tile reference reproduces the first global
    tile of a 4-shard row-sharded sweep bitwise (values on a 1/16 grid)."""
    spec, cl, sh, values, labels = checks.flagship_problem(
        4096, 64, quantum=1.0 / 16)
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    key = jax.random.PRNGKey(3)
    mesh = sharding.make_mesh(jax.devices()[:4])
    _, an = sharding.sharded_sweep_blocked(
        spec, cl, sh, state, values, jnp.asarray(labels), key, mesh, 256)
    rows, ref = checks.first_tile_reference(spec, cl, sh, state, values,
                                            labels, key, 4, 256)
    assert rows.shape == (1024,)
    np.testing.assert_array_equal(np.asarray(an)[rows], ref)


def test_tile_rows_layout():
    np.testing.assert_array_equal(checks.tile_rows(16, 2, 2, 1),
                                  [2, 3, 10, 11])


def test_check_row_mesh_small():
    res = checks.check_row_mesh(jax.devices()[:4], 4096, 64, 256, sweeps=1)
    assert res['first_tile_diff'] == 0
    assert res['first_tile_rows'] == 1024


def test_check_component_mesh_small():
    res = checks.check_component_mesh(jax.devices()[:4], 2048, 64, 512)
    assert res['differing_rows'] == 0


def test_check_2d_mesh_small():
    res = checks.check_2d_mesh(jax.devices()[:4], 2048, 64, 256)
    assert res['differing_rows'] == 0
    assert res['slots_emptied'] >= 1


def _emptying_problem(x):
    """64 rows x 8 slots x one nich column: tight clusters in slots 0 and
    2-5, slots 6 and 7 empty.  Slot 1 holds rows 0-3 only, so removing
    the first tile empties it; rows 1-3 sit far from every cluster, row 0
    at `x`, between the cluster of slot 5 (at 4) and the prior."""
    spec = mx.make_spec([(nich, 1)], capacity=8, empties=1)
    cl = clustering.PitmanYor.from_dict(checks.FLAGSHIP_CL)
    sh = (nich.shared_from_dict(checks.FLAGSHIP_NICH),)
    centers = np.array([-4., 7.5, -2., 0., 2., 4.])
    labels = np.concatenate([[1, 1, 1, 1], np.tile([0, 2, 3, 4, 5], 12)])
    X = centers[labels] + np.tile([-1., 0., 1.], 22)[:64] / 16
    X[0] = x
    return (spec, cl, sh, (jnp.asarray(X[:, None], jnp.float32),),
            labels.astype(np.int32))


def _empty_margin(x, n_rows, block):
    """Row 0's score for the emptied slot 1 minus its best occupied slot,
    after the first tile of a sweep over `n_rows` row shards is removed,
    one empty reserved."""
    spec, cl, sh, values, labels = _emptying_problem(x)
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    idx = jnp.asarray(checks.tile_rows(64, n_rows, block, 0))
    tv = tuple(v[idx] for v in values)
    st = mx.remove_tile(spec, cl, sh, state, tv, jnp.asarray(labels)[idx])
    s = np.asarray(mx.score_batch(spec, cl, sh, st, tv))[0]
    return s[1] - s[np.asarray(st.counts) > 0].max()


@pytest.mark.parametrize('layout', ['components', '2d'])
def test_sharded_argmax_reserves_empties_per_slot_range(layout):
    """Component-sharded sweeps reserve an empty slot in each slot range,
    so the seating mass of an empty slot splits over more slots than on
    one device.  Row 0 prefers the slot its tile's removal emptied by
    less than log 2: with one reserved empty it takes that slot; with
    one per range (slot 1 in the first, slot 6 in the last) its score
    halves and the row takes slot 5.  The sharded sweep follows the
    reference that reserves empties per range, row for row."""
    block = 8
    n_rows, n_slots = (1, 4) if layout == 'components' else (2, 2)
    lo, hi = 4.0, 8.0                    # margin(lo) < 0 < margin(hi)
    for _ in range(20):
        mid = (lo + hi) / 2
        if _empty_margin(mid, n_rows, block) < np.log(2) / 2:
            lo = mid
        else:
            hi = mid
    x = np.round(hi * 1024) / 1024
    assert 0.1 < _empty_margin(x, n_rows, block) < np.log(2) - 0.1
    spec, cl, sh, values, labels = _emptying_problem(x)
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    devices = jax.devices()[:4]
    if layout == 'components':
        st, an = sharding.sharded_sweep_components(
            spec, cl, sh, state, values, jnp.asarray(labels),
            jax.random.PRNGKey(0), sharding.make_component_mesh(devices),
            block, sampling='argmax')
    else:
        mesh = sharding.make_mesh_2d(2, 2, devices)
        st, an = sharding.sharded_sweep_2d(
            spec, cl, sh, sharding.shard_state_components(state, mesh),
            values, jnp.asarray(labels), jax.random.PRNGKey(0), mesh, block,
            sampling='argmax')
    one = checks.blocked_argmax_reference(spec, cl, sh, state, values,
                                          labels, block, n_rows)
    per_range = checks.blocked_argmax_reference(
        spec, cl, sh, state, values, labels, block, n_rows, n_slots)
    assert one[1][0] == 1 and per_range[1][0] == 5
    res = checks._compare_argmax(st, an, per_range)
    assert res['differing_rows'] == 0
    assert res['slots_emptied'] == 1
    assert res['rows_drawing_an_emptied_slot'] == 3
    assert np.asarray(an)[0] == 5


def test_check_onehot_contraction_small():
    res = checks.check_onehot_contraction(64, 4096)
    assert res['rel_err'] <= 1e-6
