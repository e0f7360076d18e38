"""End-to-end checks of the Gibbs main path, as plain functions.

`chip_smoke.py` runs them on the GPU at full width in one process; the
`gpu`-marked tests call the same functions there, and the CPU tests call
them at small sizes.  Each check raises AssertionError with a readable
message when it fails and returns a dict of what it measured otherwise.

Problem builders generate every dataset from a seed (no files):
- `flagship_problem`: R rows x C slots x 2 nich columns, PY(1, 0.1),
  7C/8 true clusters, warm-start labels (the benchmark configuration);
- `mixed_problem`: one spec with all seven families (bb, dd, dpd, gp, bnb,
  nich x2, niw d=2).
"""

import os
import tempfile
import time

import numpy as np
import scipy.stats

import jax
import jax.numpy as jnp

from distributions_tpu import clustering, mixture as mx
from distributions_tpu.models import bb, bnb, dd, dpd, gp, nich, niw

FLAGSHIP_CL = {'alpha': 1.0, 'd': 0.1}
FLAGSHIP_NICH = {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}

# float32 device scores vs the float64 hp flavor, per family:
# |core - hp| <= SCORE_RTOL[family] * max(1, |hp|).  Seating scores and
# bb/dd/dpd are a few log/lgamma terms of small arguments; gp and bnb add
# Stirling-differenced lgamma ratios of counts in the thousands; nich and
# niw carry f32 rounding of the posterior scatter of slots holding
# hundreds of rows.  All scoring is elementwise (no matrix product), so
# these hold at any matmul precision.
SCORE_RTOL = {'clustering': 1e-5, 'bb': 1e-5, 'dd': 1e-5, 'dpd': 1e-5,
              'gp': 5e-5, 'bnb': 5e-5, 'nich': 5e-5, 'niw': 2e-4}
# recomputed-state agreement, in raw sums over rows relative to each
# statistic's largest slot: stats rebuilt from the final assignments in one
# contraction vs stats carried through ~2 x tiles x sweeps f32 add/remove
# steps (measured ~1e-6 at 262,144 rows x C=1024 after 10 sweeps)
STATE_RTOL = 1e-5
SCORE_DATA_RTOL = 1e-5


# -- problems ---------------------------------------------------------------

def flagship_problem(R, C, cols=2, seed=0, quantum=None):
    """(spec, cl_model, shareds, values, labels) of the benchmark
    configuration: labels are the generating clusters (a warm start that
    keeps occupancy near 7/8, so capacity never grows).  `quantum` rounds
    the values to a multiple of it, which makes every stat sum exact in
    float32 and so independent of summation order."""
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    cl = clustering.PitmanYor.from_dict(FLAGSHIP_CL)
    shareds = (nich.shared_from_dict(FLAGSHIP_NICH),)
    n_true = C // 8 * 7
    labels = rng.randint(0, n_true, R)
    centers = rng.randn(n_true, cols).astype(np.float32)
    X = centers[labels] + 0.1 * rng.randn(R, cols).astype(np.float32)
    if quantum:
        X = np.clip(np.round(X / quantum) * quantum, -7.0, 7.0)
    return (spec, cl, shareds, (jnp.asarray(X, jnp.float32),),
            np.asarray(labels, np.int32))


MIXED_FAMILIES = ('bb', 'dd', 'dpd', 'gp', 'bnb', 'nich', 'niw')


def mixed_problem(R, C, n_true=None, seed=0):
    """(spec, cl_model, shareds, values, labels): one spec holding all
    seven families — bb, dd (4 categories), dpd (8 values), gp, bnb,
    nich x2 and niw (d=2) — with data drawn per generating cluster."""
    rng = np.random.RandomState(seed)
    n_true = n_true or C // 8 * 7
    spec = mx.make_spec(
        [(bb, 1), (dd, 1), (dpd, 1), (gp, 1), (bnb, 1), (nich, 2),
         (niw, 1)], capacity=C, empties=1)
    cl = clustering.PitmanYor.from_dict(FLAGSHIP_CL)
    shareds = (
        bb.shared_from_dict({'alpha': 0.5, 'beta': 0.5}),
        dd.shared_from_dict({'alphas': [0.5] * 4}),
        dpd.shared_from_dict({'gamma': 1.0, 'alpha': 1.0,
                              'betas': {i: 1.0 / 8 for i in range(8)}},
                             cap=16),
        gp.shared_from_dict({'alpha': 1.0, 'inv_beta': 0.5}),
        bnb.shared_from_dict({'alpha': 1.0, 'beta': 1.0, 'r': 1}),
        nich.shared_from_dict(
            {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),
        niw.shared_from_dict({'mu': np.zeros(2), 'kappa': 1.0,
                              'psi': np.eye(2), 'nu': 3.0}),
    )
    labels = rng.randint(0, n_true, R)
    p = rng.uniform(0.1, 0.9, n_true)
    dd_p = rng.dirichlet(np.ones(4), n_true)
    dpd_p = rng.dirichlet(np.ones(8), n_true)
    lam = rng.uniform(1.0, 10.0, n_true)
    values = (
        (rng.rand(R) < p[labels])[:, None],
        (rng.rand(R, 1) > np.cumsum(dd_p, 1)[labels, :-1])
        .sum(1, keepdims=True).astype(np.int32),
        (rng.rand(R, 1) > np.cumsum(dpd_p, 1)[labels, :-1])
        .sum(1, keepdims=True).astype(np.int32),
        rng.poisson(lam[labels])[:, None].astype(np.int32),
        rng.poisson(lam[labels][::-1])[:, None].astype(np.int32),
        (3 * rng.randn(n_true, 2)[labels]
         + 0.3 * rng.randn(R, 2)).astype(np.float32),
        (3 * rng.randn(n_true, 1, 2)[labels]
         + 0.5 * rng.randn(R, 1, 2)).astype(np.float32),
    )
    values = tuple(jnp.asarray(v) for v in values)
    return spec, cl, shareds, values, np.asarray(labels, np.int32)


# -- invariants -------------------------------------------------------------

def _raw_sums(block, group):
    """float64 host copies of a group's statistics as raw sums over rows.
    Every family but nich stores raw sums already; nich's Welford form
    (count, mean, count_times_variance) maps to (n, sum v, sum v^2), so
    drift is measured against what was summed rather than against the
    variance that cancellation leaves."""
    leaves = [np.asarray(jax.device_get(x), np.float64) for x in group]
    if block.module is nich:
        n, mean, m2 = leaves
        return [n, n * mean, m2 + n * mean * mean]
    return leaves


def check_state(spec, cl_model, shareds, values, state, assignments,
                rtol=STATE_RTOL, score_rtol=SCORE_DATA_RTOL):
    """The invariants a finished run must keep: counts sum to R and equal
    the assignment histogram; the state equals the one rebuilt from the
    final assignments (counts exactly, stat sums within `rtol` of their
    scale); the joint score is finite and within `score_rtol` of the
    rebuilt state's."""
    an = np.asarray(jax.device_get(assignments))
    R = an.shape[0]
    counts = np.asarray(jax.device_get(state.counts))
    C = counts.shape[0]
    assert counts.sum() == R, 'counts sum %d != R %d' % (counts.sum(), R)
    assert an.min() >= 0 and an.max() < C, 'assignment out of range'
    np.testing.assert_array_equal(
        counts, np.bincount(an, minlength=C),
        err_msg='counts differ from the assignment histogram')
    fresh = mx.state_from_assignments(
        spec, cl_model, shareds, values, jnp.asarray(an))
    np.testing.assert_array_equal(
        counts, np.asarray(fresh.counts), err_msg='rebuilt counts differ')
    assert int(state.sample_size) == R, int(state.sample_size)
    worst = 0.0
    for block, got_g, want_g in zip(spec.blocks, state.groups,
                                    fresh.groups):
        for got, want in zip(_raw_sums(block, got_g),
                             _raw_sums(block, want_g)):
            scale = max(1.0, float(np.abs(want).max()))
            err = float(np.abs(got - want).max()) / scale
            worst = max(worst, err)
            assert err <= rtol, '%s stat sums drifted: %.3g > %.3g' % (
                block.module.NAME, err, rtol)
    score = float(mx.score_data(spec, cl_model, shareds, state))
    assert np.isfinite(score), 'score_data is not finite: %r' % score
    rebuilt = float(mx.score_data(spec, cl_model, shareds, fresh))
    score_err = abs(score - rebuilt) / max(1.0, abs(rebuilt))
    assert score_err <= score_rtol, 'joint score drifted: %.3g > %.3g' % (
        score_err, score_rtol)
    return {'rows': R, 'nonempty': int((counts > 0).sum()),
            'stat_rel_err': worst, 'score_data': score,
            'score_rel_err': score_err}


# -- float64 hp reference for score_batch -----------------------------------

def _hp_group(hp_mod, core_mod, core_group, core_shared, hp_shared):
    try:
        raw = core_mod.group_to_dict(core_group)
    except TypeError:
        raw = core_mod.group_to_dict(core_group, core_shared)
    try:
        return hp_mod.group_from_dict(raw)
    except TypeError:
        return hp_mod.group_from_dict(raw, hp_shared)


def _family(block):
    """The hp.MODULES key of a feature block's model."""
    from distributions_tpu import hp
    return next(k for k, m in hp.MODULES.items()
                if m.NAME == block.module.NAME)


def hp_score_batch(spec, cl_model, shareds, state, values):
    """float64 scores from the independent hp flavor
    (distributions_tpu.hp): (seating scores [C], per-block [B, C] feature
    scores).  Discrete families call hp score_value once per (slot,
    distinct value); nich and niw evaluate hp's posterior (plus_group)
    with the same scipy densities hp's score_value uses, vectorized over
    rows.  Dead slots are -inf in the seating scores and 0 in the feature
    scores, as in mixture.score_batch."""
    from distributions_tpu import hp
    host = jax.device_get(state)
    counts = np.asarray(host.counts)
    alive = np.asarray(host.alive)
    C = counts.shape[0]
    hp_cl = hp.clustering.PitmanYor(float(cl_model.alpha),
                                    float(cl_model.d))
    nonempty = int((counts > 0).sum())
    n_empty = int((alive & (counts == 0)).sum())
    n = int(counts.sum())
    seating = np.array(
        [hp_cl.score_add_value(int(c), nonempty, n, n_empty) if a
         else -np.inf for c, a in zip(counts, alive)])
    blocks = []
    for block, shared, group, v in zip(spec.blocks, shareds, host.groups,
                                       values):
        name = _family(block)
        hp_mod = hp.MODULES[name]
        hp_shared = hp_mod.shared_from_dict(
            block.module.shared_to_dict(jax.device_get(shared)))
        v = np.asarray(jax.device_get(v))
        total = np.zeros((v.shape[0], C))
        for j in range(block.cols):
            vj = v[:, j]
            for k in np.flatnonzero(alive):
                g = jax.tree_util.tree_map(lambda a: a[k, j], group)
                hg = _hp_group(hp_mod, block.module, g, shared, hp_shared)
                if name == 'nich':
                    post = hp_mod.plus_group(hp_shared, hg)
                    scale = np.sqrt((1.0 + post.kappa) * post.sigmasq
                                    / post.kappa)
                    total[:, k] += scipy.stats.t.logpdf(
                        vj.astype(np.float64), df=post.nu, loc=post.mu,
                        scale=scale)
                elif name == 'niw':
                    post = hp_mod.plus_group(hp_shared, hg)
                    dof = post.nu - hp_mod.dim(hp_shared) + 1.0
                    sigma = post.psi * (post.kappa + 1.0) / (
                        post.kappa * dof)
                    total[:, k] += scipy.stats.multivariate_t.logpdf(
                        vj.astype(np.float64), loc=post.mu, shape=sigma,
                        df=dof)
                else:
                    uniq, inv = np.unique(vj, return_inverse=True)
                    table = np.array([hp_mod.score_value(hp_shared, hg, x)
                                      for x in uniq.tolist()])
                    total[:, k] += table[inv.reshape(-1)]
        blocks.append(total)
    return seating, blocks


def check_scores_vs_hp(spec, cl_model, shareds, state, values,
                       rtol=SCORE_RTOL):
    """mixture.score_batch on the default device vs the float64 hp
    flavor, block by block with each family's tolerance (SCORE_RTOL).
    Returns {family: worst |core - hp| / max(1, |hp|)}."""
    seating, blocks = hp_score_batch(spec, cl_model, shareds, state, values)
    alive = np.asarray(jax.device_get(state.alive))
    pairs = [('clustering', clustering.score_value(
        cl_model, state.counts, state.alive, state.sample_size), seating)]
    for block, shared, group, v, want in zip(
            spec.blocks, shareds, state.groups, values, blocks):
        got = jnp.where(state.alive[None, :], mx._block_score_batch(
            block, shared, group, jnp.asarray(v)), 0.0)
        pairs.append((_family(block), got, want))
    worst = {}
    for fam, got, want in pairs:
        g = np.asarray(got, np.float64)[..., alive]
        w = want[..., alive]
        assert np.isfinite(g).all(), '%s: non-finite scores' % fam
        err = float((np.abs(g - w) / np.maximum(1.0, np.abs(w))).max())
        worst[fam] = max(err, worst.get(fam, 0.0))
        assert err <= rtol[fam], '%s: rel err %.3g > %.3g' % (
            fam, err, rtol[fam])
    total = np.asarray(mx.score_batch(spec, cl_model, shareds, state,
                                      values))
    assert np.array_equal(np.isfinite(total[0]), alive), \
        'score_batch dead-slot pattern differs from the alive mask'
    return worst


# -- resume -----------------------------------------------------------------

def check_resume(spec, cl_model, shareds, values, key, passes=8, every=4,
                 **run_kw):
    """A run checkpointed (npz) every `every` sweeps and resumed from
    sweep `every` must equal the uninterrupted run bitwise."""
    from distributions_tpu.inference import runner
    with tempfile.TemporaryDirectory() as td:
        full = os.path.join(td, 'full.ckpt')
        part = os.path.join(td, 'part.ckpt')
        st_a, an_a, _ = runner.run_gibbs(
            spec, cl_model, shareds, values, key, passes=passes,
            checkpoint_path=full, checkpoint_every=every, resume=False,
            **run_kw)
        runner.run_gibbs(
            spec, cl_model, shareds, values, key, passes=every,
            checkpoint_path=part, checkpoint_every=every, resume=False,
            **run_kw)
        st_b, an_b, log_b = runner.run_gibbs(
            spec, cl_model, shareds, values, jax.random.PRNGKey(999),
            passes=passes, checkpoint_path=part, checkpoint_every=every,
            resume=True, **run_kw)
    a, b = np.asarray(an_a), np.asarray(an_b)
    n_diff = int((a != b).sum())
    assert n_diff == 0, 'resumed run differs in %d assignments' % n_diff
    np.testing.assert_array_equal(np.asarray(st_a.counts),
                                  np.asarray(st_b.counts))
    return {'rows': int(a.shape[0]), 'differing_rows': n_diff}


# -- device arithmetic ------------------------------------------------------

def check_onehot_contraction(C, B, cols=6, seed=0):
    """models/base.exact_onehot_matmul at [C, B] x [B, cols] on the
    default device against a float64 host sum: every product is exact, so
    the only error is float32 accumulation (bounded here by 1e-6 of each
    slot's sum of |values|).  Also reports, without a bound, how far a
    default-precision f32 matmul of the same operands lands (TF32 shows
    up there)."""
    from distributions_tpu.models import base
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, C, B)
    flat = rng.randn(B, cols).astype(np.float32)
    want = np.zeros((C, cols))
    np.add.at(want, ids, flat.astype(np.float64))
    scale = np.zeros((C, cols))
    np.add.at(scale, ids, np.abs(flat.astype(np.float64)))
    onehot_t = (jnp.arange(C)[:, None] == jnp.asarray(ids)[None, :]
                ).astype(jnp.float32)
    got = np.asarray(base.exact_onehot_matmul(onehot_t, jnp.asarray(flat)),
                     np.float64)
    plain = np.asarray(jnp.matmul(onehot_t, jnp.asarray(flat)), np.float64)
    bound = np.maximum(scale, 1.0)
    err = float((np.abs(got - want) / bound).max())
    assert err <= 1e-6, 'one-hot contraction rel err %.3g > 1e-6' % err
    return {'C': C, 'B': B, 'rel_err': err,
            'default_precision_matmul_rel_err':
                float((np.abs(plain - want) / bound).max())}


# -- multi-device references ------------------------------------------------

def tile_rows(R, n_shards, block, t):
    """Row ids of global tile `t` of a sweep whose rows are split into
    `n_shards` contiguous shards, each walked in tiles of `block` rows
    (sharding.sharded_sweep_blocked / sharded_sweep_2d)."""
    local = R // n_shards
    return (np.arange(n_shards)[:, None] * local + t * block
            + np.arange(block)[None, :]).reshape(-1)


def first_tile_reference(spec, cl_model, shareds, state, values,
                         assignments, key, n_shards, block):
    """On one device, the first global tile step of
    sharding.sharded_sweep_blocked over `n_shards` row shards: the tile is
    the union of each shard's first `block` rows; it is removed, scored
    and redrawn with the same per-row keys.  Returns (row ids, draws)."""
    from distributions_tpu.random import sample_from_scores
    rows = tile_rows(int(assignments.shape[0]), n_shards, block, 0)
    idx = jnp.asarray(rows)
    tile_vals = tuple(jnp.asarray(v)[idx] for v in values)
    tile_an = jnp.asarray(assignments)[idx]
    cd, tiles = mx.tile_deltas(spec, shareds, tile_vals, tile_an)
    st = mx.apply_tile_deltas(spec, shareds, state, cd, tiles, -1,
                              rows.shape[0])
    scores = mx.score_batch(spec, cl_model, shareds, st, tile_vals)
    row_keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(
        idx.astype(jnp.uint32))
    draws = jax.vmap(sample_from_scores)(row_keys, scores)
    return rows, np.asarray(draws.astype(jnp.int32))


def blocked_argmax_reference(spec, cl_model, shareds, state, values,
                             assignments, block, n_row_shards=1,
                             n_slot_shards=1):
    """One blocked sweep with deterministic argmax draws on one device
    (remove tile, score, argmax, add tile, tile after tile, with the
    tiles of a sweep over `n_row_shards` row shards) — the reference for
    component- and 2-D-sharded argmax sweeps.  A sweep whose slots are
    split into `n_slot_shards` contiguous ranges reserves `spec.empties`
    empty slots in each range, and the seating score of an empty slot
    splits its mass over all reserved empties; the reference keeps the
    same alive set after every removal.  Returns (state, assignments,
    gap, events): gap[r] is row r's best score minus its second best,
    the margin a last-bit difference in scoring would have to cross to
    change the draw; events counts the occupied slots that a removal
    emptied and the rows that drew a slot left empty by the removal of
    their tile."""
    R = int(assignments.shape[0])
    an = np.array(jax.device_get(assignments))
    gap = np.zeros(R)
    occupied = np.asarray(state.counts) > 0
    emptied = np.zeros_like(occupied)
    empty_draws = 0
    for t in range(R // (n_row_shards * block)):
        rows = tile_rows(R, n_row_shards, block, t)
        idx = jnp.asarray(rows)
        tv = tuple(jnp.asarray(v)[idx] for v in values)
        state = mx.remove_tile(spec, cl_model, shareds, state, tv,
                               jnp.asarray(an)[idx])
        if n_slot_shards > 1:
            alive = jax.vmap(mx._recompute_alive, in_axes=(0, None))(
                state.counts.reshape(n_slot_shards, -1), spec.empties)
            state = state._replace(alive=alive.reshape(-1))
        emptied |= occupied & (np.asarray(state.counts) == 0)
        scores = mx.score_batch(spec, cl_model, shareds, state, tv)
        new = jnp.argmax(scores, axis=1).astype(jnp.int32)
        top2 = jax.lax.top_k(scores, 2)[0]
        empty_draws += int(jnp.sum(state.counts[new] == 0))
        state = mx.add_tile(spec, cl_model, shareds, state, tv, new)
        an[rows] = np.asarray(new)
        gap[rows] = np.asarray(top2[:, 0] - top2[:, 1], np.float64)
    events = {'slots_emptied': int(emptied.sum()),
              'rows_drawing_an_emptied_slot': empty_draws}
    return state, an, gap, events


def check_row_mesh(devices, R, C, block, sweeps=5):
    """run_gibbs on a row mesh over `devices` against the same data on a
    one-device mesh with an n-times block.  The first global tile of the
    first sweep equals its one-device reference bitwise (values on a 1/16
    grid make every stat sum exact, so the psum order cannot matter);
    after `sweeps` sweeps both runs keep the state invariants of
    check_state.  The two runs walk different tile schedules, so their
    joint scores are reported, not compared."""
    from distributions_tpu.inference import runner
    from distributions_tpu.parallel import sharding
    n = len(devices)
    spec, cl, sh, values, labels = flagship_problem(R, C,
                                                    quantum=1.0 / 16)
    key = jax.random.PRNGKey(0)
    mesh = sharding.make_mesh(devices)
    kw = dict(initial_assignments=labels, grow_headroom=0.0)
    st1, an1, _ = runner.run_gibbs(spec, cl, sh, values, key, passes=1,
                                   block=block, mesh=mesh, **kw)
    # run_gibbs draws sweep 0 with the second half of split(key)
    state0 = mx.state_from_assignments(spec, cl, sh, values,
                                       jnp.asarray(labels))
    rows, ref = first_tile_reference(
        spec, cl, sh, state0, values, labels, jax.random.split(key)[1], n,
        block)
    got = np.asarray(jax.device_get(an1))[rows]
    n_diff = int((got != ref).sum())
    assert n_diff == 0, 'first global tile differs in %d of %d rows' % (
        n_diff, rows.shape[0])
    out = {'first_tile_rows': int(rows.shape[0]), 'first_tile_diff': 0}
    t0 = time.perf_counter()
    st_n, an_n, _ = runner.run_gibbs(spec, cl, sh, values, key,
                                     passes=sweeps, block=block, mesh=mesh,
                                     **kw)
    jax.block_until_ready((st_n, an_n))
    out['mesh_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_1, an_1, _ = runner.run_gibbs(
        spec, cl, sh, values, key, passes=sweeps, block=n * block,
        mesh=sharding.make_mesh(devices[:1]), **kw)
    jax.block_until_ready((st_1, an_1))
    out['one_device_s'] = time.perf_counter() - t0
    out['mesh'] = check_state(spec, cl, sh, values, st_n, an_n)
    out['one_device'] = check_state(spec, cl, sh, values, st_1, an_1)
    return out


# A sharded sweep computes the same scores in another program (slot
# ranges, sharded seating normalization), so they may differ in the last
# bits; a row may then take its second-best slot, but only when the
# one-device margin between its two best slots is below this (scores are
# O(10) in magnitude, f32 rounding O(1e-6)).
ARGMAX_TIE_GAP = 1e-4


def _compare_argmax(st, an, ref):
    """Sharded argmax sweep vs its one-device reference (the
    blocked_argmax_reference tuple): equal row for row, except rows
    whose reference margin is a near-tie (< ARGMAX_TIE_GAP); every count
    then differs by at most the number of such rows."""
    st_ref, an_ref, gap, events = ref
    an = np.asarray(jax.device_get(an))
    diff = an != an_ref
    n_diff = int(diff.sum())
    worst_gap = float(gap[diff].max()) if n_diff else 0.0
    assert worst_gap < ARGMAX_TIE_GAP, (
        'sharded argmax sweep differs in %d rows, one with a margin of '
        '%.3g' % (n_diff, worst_gap))
    dc = np.abs(np.asarray(jax.device_get(st.counts))
                - np.asarray(st_ref.counts))
    assert dc.sum() <= 2 * n_diff, 'counts differ beyond the tied rows'
    return dict(events, rows=int(an.shape[0]), differing_rows=n_diff,
                largest_margin_of_a_differing_row=worst_gap)


def _mesh_problem(R, C):
    """The flagship data on a 1/16 grid (exact stat sums, so the order of
    a psum cannot matter) and its state.  A warm-started sweep over it
    empties slots, which the sharded sweeps reserve per slot range."""
    spec, cl, sh, values, labels = flagship_problem(R, C, quantum=1.0 / 16)
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    return spec, cl, sh, values, labels, state


def check_component_mesh(devices, R, C, block):
    """One component-sharded argmax sweep (sharding
    .sharded_sweep_components) over len(devices) slot ranges against
    the one-device argmax sweep with the same reserved empties
    (_compare_argmax)."""
    from distributions_tpu.parallel import sharding
    spec, cl, sh, values, labels, state = _mesh_problem(R, C)
    ref = blocked_argmax_reference(spec, cl, sh, state, values, labels,
                                   block, n_slot_shards=len(devices))
    cmesh = sharding.make_component_mesh(devices)
    st, an = sharding.sharded_sweep_components(
        spec, cl, sh, state, values, jnp.asarray(labels),
        jax.random.PRNGKey(0), cmesh, block, sampling='argmax')
    return _compare_argmax(st, an, ref)


def check_2d_mesh(devices, R, C, block):
    """One argmax sweep on a 2x2 ('rows' x 'components') mesh (sharding
    .sharded_sweep_2d) against the one-device argmax sweep with the same
    tiles and reserved empties (_compare_argmax)."""
    from distributions_tpu.parallel import sharding
    spec, cl, sh, values, labels, state = _mesh_problem(R, C)
    ref = blocked_argmax_reference(spec, cl, sh, state, values, labels,
                                   block, n_row_shards=2, n_slot_shards=2)
    mesh = sharding.make_mesh_2d(2, 2, devices)
    st, an = sharding.sharded_sweep_2d(
        spec, cl, sh, sharding.shard_state_components(state, mesh), values,
        jnp.asarray(labels), jax.random.PRNGKey(0), mesh, block,
        sampling='argmax')
    return _compare_argmax(st, an, ref)
