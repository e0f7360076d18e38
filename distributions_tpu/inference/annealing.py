"""Subsample annealing: grow the assigned subset while Gibbs-resampling it
(reference examples/mixture/main.py:289-344 compress_annealing).

The reference interleaves single-row adds and removes on an
(add_rate=passes, remove_rate=passes-1) schedule so each datum is assigned,
resampled ~passes times, and the working set sweeps the dataset.  The
batched version works in row *tiles*: the same schedule at tile
granularity, with all adds/removes as segment-sum tile updates."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from distributions_tpu import mixture as mx
from distributions_tpu.random import sample_from_scores


def annealing_schedule(passes):
    """Infinite True(add)/False(remove) schedule (reference
    main.py:295-307)."""
    passes = float(passes)
    assert passes >= 1
    add_rate, remove_rate = passes, passes - 1
    state = add_rate
    while True:
        if state >= 0:
            state -= remove_rate
            yield True
        else:
            state += add_rate
            yield False


def anneal(spec, cl_model, shareds, values, key, passes=10, tile=64):
    """Run subsample annealing over the whole dataset.

    Returns (state, assignments).  Rows are processed in tiles of `tile`
    rows; to_add / to_remove cursors loop over the dataset as in the
    reference's json_loop_load (main.py:289-292).
    """
    R = int(np.asarray(values[0]).shape[0])
    n_tiles = R // tile
    assert R % tile == 0, 'pad rows to a multiple of tile'

    state = mx.init(spec, shareds)
    assignments = jnp.full(R, -1, jnp.int32)
    assigned = np.zeros(n_tiles, bool)

    add_cursor = 0
    remove_cursor = 0

    @partial(jax.jit, static_argnums=())
    def add_tile_fn(state, tile_vals, key):
        scores = mx.score_batch(spec, cl_model, shareds, state, tile_vals)
        keys = jax.random.split(key, tile)
        new_assign = jax.vmap(sample_from_scores)(keys, scores).astype(
            jnp.int32)
        state = mx.add_tile(spec, cl_model, shareds, state, tile_vals,
                            new_assign)
        return state, new_assign

    @partial(jax.jit, static_argnums=())
    def remove_tile_fn(state, tile_vals, tile_assign):
        return mx.remove_tile(spec, cl_model, shareds, state, tile_vals,
                              tile_assign)

    def tile_values(i):
        return tuple(jnp.asarray(v)[i * tile:(i + 1) * tile]
                     for v in values)

    for is_add in annealing_schedule(passes):
        if is_add:
            i = add_cursor % n_tiles
            if assigned[i]:
                break  # dataset fully assigned again: done
            key, sub = jax.random.split(key)
            state, new_assign = add_tile_fn(state, tile_values(i), sub)
            assignments = assignments.at[i * tile:(i + 1) * tile].set(
                new_assign)
            assigned[i] = True
            add_cursor += 1
        else:
            i = remove_cursor % n_tiles
            assert assigned[i], 'removing unassigned tile'
            state = remove_tile_fn(
                state, tile_values(i),
                assignments[i * tile:(i + 1) * tile])
            assigned[i] = False
            remove_cursor += 1

    return state, assignments
