"""Collapsed-Gibbs sweep kernels over a mixture state.

The reference's hot loop (examples/mixture/main.py:236-244: per row,
remove_value -> score_value over all groups -> sample_from_scores ->
add_value, crossing python/Cython/C++ per call) becomes two device-resident
kernels:

- `sweep_sequential` — lax.scan over rows; exact collapsed-Gibbs semantics
  (row i is reassigned against suff stats reflecting rows 0..i-1 of this
  sweep).  Latency-bound but bitwise-faithful to the reference algorithm.

- `sweep_blocked` — rows in tiles of size B; scores for a whole tile are
  computed against tile-frozen suff stats, all B rows are reassigned at
  once (one [B, C] score + categorical draw that XLA fuses), then suff
  stats are updated by one-hot contractions.  This is blocked/"SAME"-style
  Gibbs (see PAPERS.md: Daniely et al. 1409.5402, Williamson et al.
  1211.7120); B=1 recovers the sequential algorithm.  Posterior correctness
  is validated statistically (tests/test_gibbs.py) rather than bitwise.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from distributions_tpu import mixture as mx
from distributions_tpu.random import sample_from_scores


@partial(jax.jit, static_argnums=(0,))
def sweep_sequential(spec, cl_model, shareds, state, values, assignments,
                     key):
    """One full pass of exact collapsed Gibbs over all rows.

    values: tuple of per-block [R, cols] arrays; assignments: [R] int32.
    Returns (state, assignments).
    """
    R = assignments.shape[0]
    keys = jax.random.split(key, R)

    def step(carry, inp):
        state, assignments = carry
        i, step_key = inp
        row = tuple(jnp.asarray(v)[i] for v in values)
        k_old = assignments[i]
        state, _ = mx.remove_value(spec, cl_model, shareds, state, k_old, row)
        scores = mx.score_value(spec, cl_model, shareds, state, row)
        k_new = sample_from_scores(step_key, scores)
        state, _ = mx.add_value(spec, cl_model, shareds, state, k_new, row)
        return (state, assignments.at[i].set(k_new.astype(jnp.int32))), None

    (state, assignments), _ = lax.scan(
        step, (state, assignments),
        (jnp.arange(R, dtype=jnp.int32), keys))
    return state, assignments


@partial(jax.jit, static_argnums=(0, 6))
def sweep_blocked(spec, cl_model, shareds, state, values, assignments, block,
                  key=None):
    """One full pass of blocked collapsed Gibbs with tile size `block`.

    R must be a multiple of `block` (pad rows to a multiple and carry a
    mask upstream if needed).

    Fast path: per-row statistic columns are precomputed once for the whole
    dataset; each tile's suff-stat update is then one [C, B] x [B, cols*S]
    one-hot contraction (a matrix product) instead of per-leaf scatters.
    """
    R = assignments.shape[0]
    assert R % block == 0, 'pad rows to a multiple of the block size'
    n_blocks = R // block
    keys = jax.random.split(key, n_blocks)

    # reshape rows into [n_blocks, block, ...]
    tiled_values = tuple(
        jnp.asarray(v).reshape((n_blocks, block) + jnp.asarray(v).shape[1:])
        for v in values)
    tiled_assign = assignments.reshape(n_blocks, block)
    fast = mx.supports_row_stats(spec)

    if fast:
        row_stats = mx.precompute_row_stats(spec, shareds, values)
        tiled_stats = tuple(
            rs.reshape((n_blocks, block) + rs.shape[1:]) for rs in row_stats)

        def step(state, inp):
            tile_vals, tile_stats, tile_assign, step_key = inp
            cd, tiles = mx.tile_deltas_fast(
                spec, shareds, tile_stats, tile_assign)
            state = mx.apply_stat_tiles(
                spec, shareds, state, cd, tiles, -1, block)
            scores = mx.score_batch(
                spec, cl_model, shareds, state, tile_vals)   # [B, C]
            new_assign = sample_from_scores(
                step_key, scores).astype(jnp.int32)
            cd, tiles = mx.tile_deltas_fast(
                spec, shareds, tile_stats, new_assign)
            state = mx.apply_stat_tiles(
                spec, shareds, state, cd, tiles, +1, block)
            return state, new_assign

        state, new_tiled = lax.scan(
            step, state, (tiled_values, tiled_stats, tiled_assign, keys))
        return state, new_tiled.reshape(R)

    def step(state, inp):
        tile_vals, tile_assign, step_key = inp
        state = mx.remove_tile(
            spec, cl_model, shareds, state, tile_vals, tile_assign)
        scores = mx.score_batch(
            spec, cl_model, shareds, state, tile_vals)      # [B, C]
        new_assign = sample_from_scores(step_key, scores).astype(jnp.int32)
        state = mx.add_tile(
            spec, cl_model, shareds, state, tile_vals, new_assign)
        return state, new_assign

    state, new_tiled = lax.scan(
        step, state, (tiled_values, tiled_assign, keys))
    return state, new_tiled.reshape(R)



@partial(jax.jit, static_argnums=(0,))
def sequential_init(spec, cl_model, shareds, state, values, key):
    """Sequential (greedy posterior-predictive) initialization: assign rows
    one at a time from the running predictive (reference
    examples/mixture/main.py:191-210 compress_sequential)."""
    R = jnp.asarray(values[0]).shape[0]
    keys = jax.random.split(key, R)

    def step(carry, inp):
        state, assignments = carry
        i, step_key = inp
        row = tuple(jnp.asarray(v)[i] for v in values)
        scores = mx.score_value(spec, cl_model, shareds, state, row)
        k = sample_from_scores(step_key, scores)
        state, _ = mx.add_value(spec, cl_model, shareds, state, k, row)
        return (state, assignments.at[i].set(k.astype(jnp.int32))), None

    assignments0 = jnp.zeros(R, jnp.int32)
    (state, assignments), _ = lax.scan(
        step, (state, assignments0),
        (jnp.arange(R, dtype=jnp.int32), keys))
    return state, assignments



def sweep_blocked_chains(spec, cl_model, shareds, states, values,
                         assignments, block, keys):
    """Chain parallelism: run one blocked sweep on N independent chains at
    once (states/assignments/keys carry a leading [N] chain axis; values are
    shared).  The analog of the reference's multiprocessing fan-out
    (examples/mixture/main.py:365-374), as a vmap."""
    return jax.vmap(
        lambda st, an, k: sweep_blocked(
            spec, cl_model, shareds, st, values, an, block, key=k)
    )(states, assignments, keys)


def init_chains(spec, cl_model, shareds, values, assignments_per_chain):
    """Build [N]-chain states from an [N, R] assignment matrix."""
    return jax.vmap(
        lambda an: mx.state_from_assignments(
            spec, cl_model, shareds, values, an))(assignments_per_chain)


@partial(jax.jit, static_argnums=(0,))
def prior_init(spec, cl_model, shareds, state, values, key):
    """Prior-predictive initialization: assign each row from the clustering
    prior only, ignoring likelihoods (reference compress_gibbs init,
    examples/mixture/main.py:227-233)."""
    R = jnp.asarray(values[0]).shape[0]
    keys = jax.random.split(key, R)

    from distributions_tpu import clustering as _cl

    def step(carry, inp):
        state, assignments = carry
        i, step_key = inp
        row = tuple(jnp.asarray(v)[i] for v in values)
        scores = _cl.score_value(
            cl_model, state.counts, state.alive, state.sample_size)
        k = sample_from_scores(step_key, scores)
        state, _ = mx.add_value(spec, cl_model, shareds, state, k, row)
        return (state, assignments.at[i].set(k.astype(jnp.int32))), None

    assignments0 = jnp.zeros(R, jnp.int32)
    (state, assignments), _ = lax.scan(
        step, (state, assignments0),
        (jnp.arange(R, dtype=jnp.int32), keys))
    return state, assignments
