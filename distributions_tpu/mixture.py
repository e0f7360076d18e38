"""Vectorized mixture-model machinery: the device-resident replacement for the
reference's MixtureDriver / MixtureSlave / MixtureIdTracker triple
(reference include/distributions/mixture.hpp:40-521, doc/overview.rst:171-204).

Design
------
The reference keeps groups dense via `Packed_` swap-compaction and an
always-one-empty-group invariant so score vectors stay contiguous.  On an
accelerator the analog is a **fixed-capacity padded component axis with an alive-mask**:

- `counts[C]`   int32 rows per slot (the clustering driver's state)
- `alive[C]`    slot is present: nonempty, or one of `empties` reserved
                empty slots ("sit at a new table" stays scoreable —
                mixture.hpp:152-153's invariant, generalized to E empties as
                in examples/mixture/main.py:51's EMPTY_GROUP_COUNT)
- per-feature-block `Group` pytrees batched `[C, cols]`

Slot ids are stable (no swap-compaction), so the reference's
`MixtureIdTracker` packed<->global id bijection (mixture.hpp:460-521) is
unnecessary: an assignment vector indexes slots directly and survives group
birth/death.

A "feature block" is (model module, Shared, n columns): `cols` same-model
features scored together in wide, vectorizable shapes.  The reference's one
slave per feature is the cols=1 case.

Scoring a row is one fused graph: clustering scores over [C] + sum over
blocks of batched posterior-predictive scores — the reference's cached
columnar scorers (e.g. nich's {score, log_coeff, precision, mean} —
src/models/nich.cc:33-67) appear as [C] intermediates that XLA fuses.

Two sweep kernels implement collapsed Gibbs (see ops/gibbs.py):
- `sweep_sequential`: lax.scan over rows; bitwise-faithful collapsed-Gibbs
  semantics (suff stats reflect all previous rows of the same sweep).
- `sweep_blocked`: rows processed in tiles; within a tile, scores are
  computed against tile-frozen suff stats (SAME-style blocked Gibbs; see
  PAPERS.md), then suff stats updated by segment-sum.  B=1 degenerates to
  sequential.  This is the throughput path.
"""

from typing import Any, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from distributions_tpu import clustering as _clustering
from distributions_tpu.models import base


class FeatureBlock(NamedTuple):
    """Static description of one block of same-model features."""
    module: Any   # model module (static python object)
    cols: int     # number of feature columns in this block


class MixtureSpec(NamedTuple):
    """Static structure of a mixture problem (hashable; passed as a static
    arg to jitted functions)."""
    blocks: Tuple[FeatureBlock, ...]
    capacity: int
    empties: int = 1


class MixtureState(NamedTuple):
    """Dynamic (pytree) state of a mixture."""
    counts: jnp.ndarray        # [C] int32
    alive: jnp.ndarray         # [C] bool
    sample_size: jnp.ndarray   # int32
    groups: Tuple               # per-block Group pytrees, batched [C, cols]


def make_spec(blocks, capacity, empties=1):
    return MixtureSpec(
        blocks=tuple(FeatureBlock(m, int(c)) for m, c in blocks),
        capacity=int(capacity), empties=int(empties))


# -- init -------------------------------------------------------------------

def init(spec, shareds, counts=None):
    """Create a mixture state.  `counts` (optional [<=C] int) seeds initial
    group sizes as in reference Mixture.init(model, counts)
    (lp/clustering.pyx:142-227); feature groups start empty."""
    C = spec.capacity
    if counts is None:
        counts_arr = jnp.zeros(C, jnp.int32)
    else:
        counts = jnp.asarray(counts, jnp.int32)
        counts_arr = jnp.zeros(C, jnp.int32).at[:counts.shape[0]].set(counts)
    groups = tuple(
        block.module.group_init(shared, (C, block.cols))
        for block, shared in zip(spec.blocks, shareds))
    state = MixtureState(
        counts=counts_arr,
        alive=_recompute_alive(counts_arr, spec.empties),
        sample_size=jnp.sum(counts_arr),
        groups=groups)
    return state


def _recompute_alive(counts, empties):
    """alive = nonempty slots + the first `empties` empty slots."""
    is_zero = counts == 0
    rank = jnp.cumsum(is_zero.astype(jnp.int32))
    return (~is_zero) | (is_zero & (rank <= empties))


def group_count(state):
    """Number of present groups incl. reserved empties (len(mixture))."""
    return jnp.sum(state.alive.astype(jnp.int32))


def nonempty_group_count(state):
    return jnp.sum((state.counts > 0).astype(jnp.int32))


# -- per-block scoring adapters --------------------------------------------

def _block_score_row(block, shared, group, values_row):
    """Score one row's `cols` values against all C slots -> [C]."""
    per_col = jax.vmap(
        lambda g, v: block.module.score_value(shared, g, v),
        in_axes=(1, 0), out_axes=0)(group, values_row)   # [cols, C]
    return jnp.sum(per_col, axis=0)


def _block_score_batch(block, shared, group, values):
    """Score [B, cols] values against all C slots -> [B, C]."""
    per_col = jax.vmap(
        lambda g, v: block.module.score_value_batch(shared, g, v),
        in_axes=(1, 1), out_axes=0)(group, values)        # [cols, B, C]
    return jnp.sum(per_col, axis=0)


def _block_update_row(block, shared, group, k, values_row, sign):
    """Add (sign=+1) or remove (sign=-1) one row's values to slot k."""
    sub = base.group_take(group, k)                       # [cols]
    fn = (block.module.add_value if sign > 0
          else block.module.remove_value)
    sub = jax.vmap(lambda g, v: fn(shared, g, v))(sub, values_row)
    return base.group_set(group, k, sub)


def _block_tile_groups(block, shared, values, assignments, C):
    """Build [C, cols] groups from a tile of rows via segment sums."""
    return jax.vmap(
        lambda v: block.module.from_values_grouped(shared, v, assignments, C),
        in_axes=1, out_axes=1)(values)


def _block_tile_stats(block, shared, values, assignments, C):
    """Additive tile statistics [C, cols] — safe to psum across devices
    before conversion to Group form (models whose Group is already additive
    use it directly; nich supplies raw moments)."""
    fn = getattr(block.module, 'tile_stats', block.module.from_values_grouped)
    return jax.vmap(
        lambda v: fn(shared, v, assignments, C),
        in_axes=1, out_axes=1)(values)


def _block_stats_to_group(block, shared, tile):
    to_group = getattr(block.module, 'tile_to_group', None)
    if to_group is None:
        return tile
    return to_group(shared, tile)


def _zero_slot(block, shared, group, k, do_zero):
    """Reset slot k's stats to zero where do_zero (group-death hygiene: a
    deactivated slot must be bitwise-empty for later reuse)."""
    zeros = base.group_take(
        block.module.group_init(shared, (1, group[0].shape[1])), 0)
    sub = base.group_take(group, k)
    sub = jax.tree_util.tree_map(
        lambda z, s: jnp.where(do_zero, z, s), zeros, sub)
    return base.group_set(group, k, sub)


# -- public single-row ops (reference Mixture API) --------------------------

def score_value(spec, cl_model, shareds, state, values_row):
    """scores[C]: clustering seating scores + feature predictive scores;
    dead slots = -inf (reference examples/mixture/main.py:97-101)."""
    scores = _clustering.score_value(
        cl_model, state.counts, state.alive, state.sample_size)
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values_row):
        scores = scores + jnp.where(
            state.alive,
            _block_score_row(block, shared, group, jnp.asarray(v)), 0.0)
    return scores


def add_value(spec, cl_model, shareds, state, groupid, values_row):
    """Assign a row to slot `groupid`; births a replacement empty slot when
    an empty slot is occupied (driver/slave lockstep of
    doc/overview.rst:185-204 collapsed into one function).

    MIGRATION NOTE: this is the eager compat path for single rows —
    correct, but it rebuilds per-slot group batches per call, so the
    reference's per-row python loop idiom (remove/score/sample/add per
    row) runs 100-1000x slower here than the batched sweeps.  Port hot
    loops to ops/gibbs.sweep_blocked (or lax.scan sweep_sequential for
    exact per-row semantics)."""
    was_empty = state.counts[groupid] == 0
    counts = state.counts.at[groupid].add(1)
    # activate the first dead slot if a reserved empty was just occupied
    dead = jnp.argmin(state.alive)
    do_activate = was_empty & ~state.alive[dead]
    alive = state.alive.at[dead].set(state.alive[dead] | do_activate)
    groups = tuple(
        _block_update_row(block, shared, group, groupid,
                          jnp.asarray(v), +1)
        for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values_row))
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size + 1,
                        groups=groups), was_empty


def remove_value(spec, cl_model, shareds, state, groupid, values_row):
    """Unassign a row; a slot that empties dies (deactivates + zeroes)."""
    counts = state.counts.at[groupid].add(-1)
    now_empty = counts[groupid] == 0
    alive = state.alive.at[groupid].set(state.alive[groupid] & ~now_empty)
    groups = []
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values_row):
        group = _block_update_row(block, shared, group, groupid,
                                  jnp.asarray(v), -1)
        group = _zero_slot(block, shared, group, groupid, now_empty)
        groups.append(group)
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size - 1,
                        groups=tuple(groups)), now_empty


def score_data(spec, cl_model, shareds, state):
    """Joint log prob of the partition + all feature data
    (reference mixture.hpp:227-254, clustering driver's score_data)."""
    total = _clustering.score_counts(cl_model, state.counts)
    for block, shared, group in zip(spec.blocks, shareds, state.groups):
        per = jax.vmap(
            lambda g: block.module.score_data(shared, g),
            in_axes=1, out_axes=0)(group)    # [cols, C]
        total = total + jnp.sum(per)
    return total


def score_batch(spec, cl_model, shareds, state, values):
    """[B, C] scores for a batch of rows against the current (frozen) state
    — the inner kernel of blocked Gibbs and of `synthesize_image`-style
    density evaluation."""
    scores = _clustering.score_value(
        cl_model, state.counts, state.alive, state.sample_size)[None, :]
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values):
        block_scores = _block_score_batch(
            block, shared, group, jnp.asarray(v))
        scores = scores + jnp.where(state.alive[None, :], block_scores, 0.0)
    return scores


# -- tile (blocked) updates -------------------------------------------------

def remove_tile(spec, cl_model, shareds, state, values, assignments):
    """Remove a whole tile of rows by segment-summed unmerge."""
    C = spec.capacity
    delta = _clustering.count_assignments(assignments, C)
    counts = state.counts - delta
    groups = []
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values):
        tile = _block_tile_groups(block, shared, jnp.asarray(v),
                                  assignments, C)
        merged = block.module.unmerge(shared, group, tile)
        # slots that fully emptied get re-zeroed (cancel float drift)
        empty_now = counts == 0
        merged = jax.tree_util.tree_map(
            lambda m: jnp.where(
                _expand(empty_now, m.ndim), jnp.zeros_like(m), m), merged)
        groups.append(merged)
    alive = _recompute_alive(counts, spec.empties)
    n = jnp.asarray(assignments).shape[0]
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size - n,
                        groups=tuple(groups))


def add_tile(spec, cl_model, shareds, state, values, assignments):
    """Add a whole tile of rows by segment-summed merge."""
    C = spec.capacity
    delta = _clustering.count_assignments(assignments, C)
    counts = state.counts + delta
    groups = []
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values):
        tile = _block_tile_groups(block, shared, jnp.asarray(v),
                                  assignments, C)
        groups.append(block.module.merge(shared, group, tile))
    alive = _recompute_alive(counts, spec.empties)
    n = jnp.asarray(assignments).shape[0]
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size + n,
                        groups=tuple(groups))


def _expand(mask, ndim):
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


# -- precomputed row-stat fast path -----------------------------------------
# Per-row statistic columns depend only on the data, so they are computed
# ONCE per dataset; each tile update is then a single [C, B] x [B, cols*S]
# one-hot contraction (a matrix product) instead of per-leaf segment
# scatters.

def supports_row_stats(spec):
    return all(hasattr(b.module, 'row_stat_columns') for b in spec.blocks)


def precompute_row_stats(spec, shareds, values):
    """Per-block [R, cols, S] statistic columns."""
    return tuple(
        block.module.row_stat_columns(shared, jnp.asarray(v))
        for block, shared, v in zip(spec.blocks, shareds, values))


def tile_deltas_fast(spec, shareds, row_stats, assignments):
    """(counts_delta[C], per-block additive stats [C, cols]) from ONE
    one-hot contraction of every block's stat columns plus a ones column
    (base.segment_sum: full-f32 accumulation, row-chunked when the [C, B]
    one-hot would be too large)."""
    C = spec.capacity
    B = assignments.shape[0]
    flats = [jnp.ones((B, 1), jnp.float32)]
    flats += [rs.reshape(B, -1) for rs in row_stats]
    acc = base.segment_sum(jnp.concatenate(flats, axis=1), assignments, C)
    counts_delta = jnp.round(acc[:, 0]).astype(jnp.int32)
    tiles = []
    off = 1
    for block, shared, rs, f in zip(spec.blocks, shareds, row_stats,
                                    flats[1:]):
        w = f.shape[1]
        sums = acc[:, off:off + w].reshape((C,) + rs.shape[1:])
        tiles.append(block.module.row_stats_to_tile(shared, sums))
        off += w
    return counts_delta, tuple(tiles)


def apply_stat_tiles(spec, shareds, state, counts_delta, tiles, sign, nrows):
    """Apply additive stat tiles (from tile_deltas_fast, possibly psum'd)."""
    counts = state.counts + sign * counts_delta
    groups = []
    for block, shared, group, tile in zip(
            spec.blocks, shareds, state.groups, tiles):
        tile_group = _block_stats_to_group(block, shared, tile)
        if sign > 0:
            merged = block.module.merge(shared, group, tile_group)
        else:
            merged = block.module.unmerge(shared, group, tile_group)
            empty_now = counts == 0
            merged = jax.tree_util.tree_map(
                lambda m: jnp.where(
                    _expand(empty_now, m.ndim), jnp.zeros_like(m), m),
                merged)
        groups.append(merged)
    alive = _recompute_alive(counts, spec.empties)
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size + sign * nrows,
                        groups=tuple(groups))


# -- delta-form tile ops (for cross-device psum in the sharded sweep) -------

def tile_deltas(spec, shareds, values, assignments):
    """(counts_delta[C], per-block additive tile stats) for a tile of rows.
    All leaves are additive, so a psum over a device axis yields the global
    tile delta."""
    C = spec.capacity
    counts_delta = _clustering.count_assignments(assignments, C)
    tiles = tuple(
        _block_tile_stats(block, shared, jnp.asarray(v), assignments, C)
        for block, shared, v in zip(spec.blocks, shareds, values))
    return counts_delta, tiles


def apply_tile_deltas(spec, shareds, state, counts_delta, tiles, sign,
                      nrows):
    """Apply (possibly psum'd) tile deltas to the state; sign=+1 adds,
    sign=-1 removes."""
    counts = state.counts + sign * counts_delta
    groups = []
    for block, shared, group, tile in zip(
            spec.blocks, shareds, state.groups, tiles):
        tile_group = _block_stats_to_group(block, shared, tile)
        if sign > 0:
            merged = block.module.merge(shared, group, tile_group)
        else:
            merged = block.module.unmerge(shared, group, tile_group)
            empty_now = counts == 0
            merged = jax.tree_util.tree_map(
                lambda m: jnp.where(
                    _expand(empty_now, m.ndim), jnp.zeros_like(m), m),
                merged)
        groups.append(merged)
    alive = _recompute_alive(counts, spec.empties)
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size + sign * nrows,
                        groups=tuple(groups))


def state_from_assignments(spec, cl_model, shareds, values, assignments):
    """Build a full mixture state from data + an assignment vector in one
    segment-sum pass (checkpoint-restore / init path)."""
    empty = init(spec, shareds)
    return add_tile(spec, cl_model, shareds, empty, values, assignments)


def grow_capacity(spec, state, new_capacity):
    """Host-side capacity growth: pad every [C]-leading leaf to
    `new_capacity` slots (the fixed-shape replacement for the reference's
    push_back-driven growth, mixture.hpp:84-121: instead of growing by one
    on every birth, re-allocate with headroom outside jit when nonempty
    slots approach capacity).  Returns (new_spec, new_state)."""
    C_old = spec.capacity
    C_new = int(new_capacity)
    assert C_new >= C_old
    new_spec = spec._replace(capacity=C_new)
    pad = C_new - C_old

    def pad_leaf(a):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths)

    counts = pad_leaf(state.counts)
    groups = tuple(
        jax.tree_util.tree_map(pad_leaf, g) for g in state.groups)
    return new_spec, MixtureState(
        counts=counts,
        alive=_recompute_alive(counts, new_spec.empties),
        sample_size=state.sample_size,
        groups=groups)


def needs_growth(spec, state, headroom=0.125, counts=None):
    """True when fewer than `headroom * capacity` slots remain free.

    counts: optional host copy of state.counts — callers that already
    hold one (the runner's step-sync read) avoid dispatching and
    waiting on the nonempty_group_count program."""
    if counts is not None:
        nonempty = int((np.asarray(counts) > 0).sum())
    else:
        nonempty = int(np.asarray(nonempty_group_count(state)))
    free = spec.capacity - nonempty
    return free < max(1, int(headroom * spec.capacity))


def log_predictive(spec, cl_model, shareds, state, values):
    """Collapsed posterior-predictive density of new rows:
    log p(x | data) = logsumexp_k [log p(z=k | partition) + log p(x | k)]
    — the serving-path density (the [B, C] matrix is score_batch; the
    seating scores from the clustering prior are already normalized over
    alive slots, so one logsumexp marginalizes the assignment).

    Identity (tested): equals logsumexp_k of score_data(state + x at k)
    - score_data(state), the reference's chain rule
    (tests/test_models.py:229-251 semantics)."""
    scores = score_batch(spec, cl_model, shareds, state, values)
    return jax.scipy.special.logsumexp(scores, axis=1)


def score_data_grid(spec, cl_model, shareds_grid, state):
    """Score the current groups under a grid of Shared hyperparameter
    settings (reference dd.hpp:259-287 / mixture.hpp:238-247's
    score_data_grid): pure vmap over the grid — the batched replacement for the
    reference's incremental between-grid-point updates.

    shareds_grid: tuple of per-block Shared pytrees whose leaves carry a
    leading grid axis [G].  Returns [G] total data scores (feature part
    only, clustering term excluded as in the reference)."""
    def score_with(shareds):
        total = jnp.float32(0.0)
        for block, shared, group in zip(spec.blocks, shareds, state.groups):
            per = jax.vmap(
                lambda g, s=shared, m=block.module: m.score_data(s, g),
                in_axes=1, out_axes=0)(group)
            total = total + jnp.sum(per)
        return total

    return jax.vmap(score_with)(shareds_grid)
