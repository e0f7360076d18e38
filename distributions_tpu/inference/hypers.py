"""Hyperparameter inference: grid-based empirical Bayes over Shared
hyperparameters and the clustering prior.

The reference exposes the primitive (`score_data_grid`, dd.hpp:259-287,
mixture.hpp:238-247) but no driver; downstream systems grid-search each
feature's hyperparameters against the current groups every few sweeps.
This driver does that in batch: one vmap scores the whole grid, one
categorical draw (or argmax) picks the new setting.
"""

import jax
import jax.numpy as jnp

from distributions_tpu import mixture as mx, clustering as _cl
from distributions_tpu.random import sample_from_scores


def grid_step_feature(key, spec, block_idx, shareds, state, grid_shared,
                      sample=True):
    """Resample (or argmax) block `block_idx`'s Shared from a grid.

    grid_shared: Shared pytree with leading grid axis [G] for that block.
    Returns (new_shareds tuple, chosen index, grid scores [G]).
    """
    block = spec.blocks[block_idx]
    group = state.groups[block_idx]
    scores = jax.vmap(
        lambda s: jnp.sum(jax.vmap(
            lambda g: block.module.score_data(s, g),
            in_axes=1, out_axes=0)(group)))(grid_shared)
    if sample:
        idx = sample_from_scores(key, scores)
    else:
        idx = jnp.argmax(scores)
    chosen = jax.tree_util.tree_map(lambda a: a[idx], grid_shared)
    new_shareds = tuple(
        chosen if i == block_idx else s for i, s in enumerate(shareds))
    return new_shareds, idx, scores


def grid_step_clustering(key, cl_grid, state, sample=True):
    """Resample the clustering prior's hyperparameters from a grid of
    models (e.g., PitmanYor alphas x ds) against the current partition."""
    scores = jax.vmap(
        lambda m: _cl.score_counts(m, state.counts))(cl_grid)
    if sample:
        idx = sample_from_scores(key, scores)
    else:
        idx = jnp.argmax(scores)
    chosen = jax.tree_util.tree_map(lambda a: a[idx], cl_grid)
    return chosen, idx, scores


def make_py_grid(alphas, ds):
    """Cartesian PitmanYor grid as a vmappable model pytree."""
    alphas = jnp.asarray(alphas, jnp.float32)
    ds = jnp.asarray(ds, jnp.float32)
    A, D = jnp.meshgrid(alphas, ds, indexing='ij')
    return _cl.PitmanYor(alpha=A.ravel(), d=D.ravel())
