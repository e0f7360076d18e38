"""Sharded collapsed-Gibbs sweeps over a device mesh.

The reference is single-core (reference SURVEY §2.4: SIMD only, no
distribution of any kind); the scaling dimensions natural to this workload
are implemented here with `jax.sharding` + `shard_map`:

- **Row (data) sharding** — partition the R observations over the mesh's
  'rows' axis; each device scores and reassigns its rows against all C
  components.  Suff-stat deltas are additive (mixture.tile_deltas), so one
  `psum` per tile keeps the replicated state consistent — the collective
  rides the device interconnect.
- **Component sharding** — for very large C, score columns are computed on
  the component-sharded state; the categorical draw needs a row-wise argmax
  over all C, expressed as a gumbel-max: each shard draws local
  gumbel-perturbed maxima and a single `pmax`-style reduction picks the
  winner (layout-independent because keys are counter-based per (row, slot)).
- **Chain parallelism** — independent MCMC chains via vmap/pmap over keys;
  see inference/.

Reproducibility contract: all randomness derives from counter-based
`jax.random` keys folded with global row indices, so results are identical
under any sharding layout (replacing the reference's single sequential
global_rng, src/random.cc:33).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from distributions_tpu import mixture as mx
from distributions_tpu.models import base as model_base
from distributions_tpu import clustering as _clustering
from distributions_tpu.random import sample_from_scores

ROWS = 'rows'


def make_mesh(devices=None, axis_name=ROWS):
    """1-D mesh over all (or the given) devices, named 'rows'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def sharded_sweep_blocked(spec, cl_model, shareds, state, values,
                          assignments, key, mesh, block):
    """One blocked-Gibbs pass with rows sharded over `mesh`'s 'rows' axis.

    Per tile step, every device:
      1. removes its local tile (additive deltas psum'd over 'rows'),
      2. scores its [block, C] rows against the tile-frozen replicated
         state,
      3. draws new assignments with per-row counter-based keys,
      4. adds its local tile back (deltas psum'd).

    The effective global block size is block * n_devices.  State (counts +
    group stats, O(C) memory) is replicated; values/assignments are sharded.
    R must be divisible by n_devices * block.
    """
    n_dev = mesh.devices.size
    R = assignments.shape[0]
    assert R % (n_dev * block) == 0, (
        'pad rows to a multiple of devices*block')

    values = tuple(jnp.asarray(v) for v in values)
    in_specs = (
        tuple(P(ROWS) for _ in values),  # values sharded by rows
        P(ROWS),                          # assignments
        P(),                              # state (replicated)
    )
    out_specs = (P(), P(ROWS))

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
             check_vma=False)
    def run(values_shard, assign_shard, state):
        local_R = assign_shard.shape[0]
        n_tiles = local_R // block
        shard_idx = lax.axis_index(ROWS)

        tiled_values = tuple(
            v.reshape((n_tiles, block) + v.shape[1:])
            for v in values_shard)
        tiled_assign = assign_shard.reshape(n_tiles, block)
        # global row index of each local row: layout-independent keys
        global_rows = (shard_idx * local_R
                       + jnp.arange(local_R, dtype=jnp.uint32)).reshape(
                           n_tiles, block)

        def step(state, inp):
            tile_vals, tile_assign, tile_rows = inp
            # 1. remove local tiles everywhere (one psum per leaf)
            cd, tiles = mx.tile_deltas(spec, shareds, tile_vals, tile_assign)
            cd = lax.psum(cd, ROWS)
            tiles = lax.psum(tiles, ROWS)
            n_removed = block * lax.psum(1, ROWS)
            state = mx.apply_tile_deltas(
                spec, shareds, state, cd, tiles, -1, n_removed)

            # 2. score local rows against frozen state
            scores = mx.score_batch(
                spec, cl_model, shareds, state, tile_vals)  # [B, C]

            # 3. per-row counter-based keys -> layout-independent draws
            row_keys = jax.vmap(
                lambda r: jax.random.fold_in(key, r))(tile_rows)
            new_assign = jax.vmap(sample_from_scores)(
                row_keys, scores).astype(jnp.int32)

            # 4. add local tiles back
            cd, tiles = mx.tile_deltas(spec, shareds, tile_vals, new_assign)
            cd = lax.psum(cd, ROWS)
            tiles = lax.psum(tiles, ROWS)
            state = mx.apply_tile_deltas(
                spec, shareds, state, cd, tiles, +1, n_removed)
            return state, new_assign

        state, new_tiled = lax.scan(
            step, state, (tiled_values, tiled_assign, global_rows))
        return state, new_tiled.reshape(local_R)

    return run(values, assignments, state)


COMPONENTS = 'components'


def make_component_mesh(devices=None):
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (COMPONENTS,))


def sharded_sweep_components(spec, cl_model, shareds, state, values,
                             assignments, key, mesh, block,
                             sampling='gumbel'):
    """Blocked sweep with the COMPONENT axis sharded over the mesh (the
    tensor-parallel analog): each device owns a contiguous slot range
    [d*C_local, (d+1)*C_local), holding that range's counts and feature
    suff stats.  Per tile:

      1. every device builds stat deltas for its own slots (rows are
         replicated; the one-hot contraction masks to the local range),
      2. scores its [B, C_local] columns + local gumbel noise,
      3. the global argmax is one max-reduction over the axis: psum-style
         `pmax` of the local (max, argmax-global-id) pair — the score
         matrix itself is never gathered (only [B] floats cross devices).

    Clustering scores need the global nonempty/empty counts: two scalar
    psums.  spec.capacity must be divisible by the mesh size.

    sampling: 'gumbel' (default) or 'argmax' (deterministic; exists to pin
    cross-shard equality against the single-device sweep in CI).  Equality
    caveats vs the unsharded sweep: (a) `spec.empties` empty slots are
    reserved PER SHARD (in every shard that has an empty slot), so the
    clustering empty mass splits over up to n_dev * empties slots and a
    row that prefers an emptied slot by less than log(n_dev) can take
    another — checks.blocked_argmax_reference(n_slot_shards=n_dev)
    reserves empties the same way; (b) score ties, which reserved empty
    slots always are, resolve to the lowest slot id, as a single-device
    argmax does; (c) in 'gumbel' mode the noise stream is per-shard
    (fold_in), equal to the single-device sweep in distribution, not
    bitwise.
    """
    assert isinstance(cl_model, _clustering.PitmanYor), (
        'component-sharded sweeps support the PitmanYor prior')
    n_dev = mesh.devices.size
    C = spec.capacity
    assert C % n_dev == 0, 'capacity must divide over the component mesh'
    R = assignments.shape[0]
    assert R % block == 0

    values = tuple(jnp.asarray(v) for v in values)
    n_tiles = R // block

    state_specs = mx.MixtureState(
        counts=P(COMPONENTS), alive=P(COMPONENTS),
        sample_size=P(),
        groups=tuple(
            jax.tree_util.tree_map(lambda _: P(COMPONENTS), g)
            for g in state.groups))
    in_specs = (state_specs, tuple(P() for _ in values), P(), P())
    out_specs = (state_specs, P())

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
             check_vma=False)
    def run(state, values_rep, assignments_rep, key):
        shard = lax.axis_index(COMPONENTS)
        C_local = C // n_dev
        base = shard * C_local

        row_stats = mx.precompute_row_stats(spec, shareds, values_rep)
        tiled_stats = tuple(
            rs.reshape((n_tiles, block) + rs.shape[1:]) for rs in row_stats)
        tiled_assign = assignments_rep.reshape(n_tiles, block)
        tiled_values = tuple(
            v.reshape((n_tiles, block) + v.shape[1:]) for v in values_rep)
        keys = jax.random.split(key, n_tiles)

        def local_deltas(tile_stats, assign_global):
            local = assign_global - base  # out-of-range drops in the onehot
            onehot = (local[:, None] == jnp.arange(
                C_local, dtype=local.dtype)).astype(jnp.float32)
            cd = jnp.round(jnp.sum(onehot, axis=0)).astype(jnp.int32)
            tiles = []
            for b, shared, rs in zip(spec.blocks, shareds, tile_stats):
                flat = rs.reshape(rs.shape[0], -1)
                sums = model_base.exact_onehot_matmul(onehot.T, flat)
                sums = sums.reshape((C_local,) + rs.shape[1:])
                tiles.append(b.module.row_stats_to_tile(shared, sums))
            return cd, tuple(tiles)

        def apply(state, cd, tiles, sign, n):
            counts = state.counts + sign * cd
            groups = []
            for b, shared, group, tile in zip(
                    spec.blocks, shareds, state.groups, tiles):
                tg = mx._block_stats_to_group(b, shared, tile)
                if sign > 0:
                    g = b.module.merge(shared, group, tg)
                else:
                    g = b.module.unmerge(shared, group, tg)
                    empty_now = counts == 0
                    g = jax.tree_util.tree_map(
                        lambda m: jnp.where(
                            mx._expand(empty_now, m.ndim),
                            jnp.zeros_like(m), m), g)
                groups.append(g)
            # alive: local nonempty + globally-coordinated reserved empties
            # (keep it simple: every shard keeps its first `empties` empty
            # slots alive; the clustering score splits mass over the global
            # empty count)
            alive = mx._recompute_alive(counts, spec.empties)
            return mx.MixtureState(
                counts=counts, alive=alive,
                sample_size=state.sample_size + sign * n,
                groups=tuple(groups))

        def step(state, inp):
            tile_vals, tile_stats, tile_assign, step_key = inp
            cd, tiles = local_deltas(tile_stats, tile_assign)
            state = apply(state, cd, tiles, -1, block)

            # local slot scores with globally-correct normalization terms
            is_empty = state.alive & (state.counts == 0)
            g_empty = lax.psum(
                jnp.sum(is_empty.astype(jnp.int32)), COMPONENTS)
            g_nonempty = lax.psum(jnp.sum(
                (state.alive & (state.counts > 0)).astype(jnp.int32)),
                COMPONENTS)
            cl_scores = _clustering.py_score_value_sharded(
                cl_model, state.counts, state.alive, state.sample_size,
                g_empty, g_nonempty)

            scores = jnp.broadcast_to(cl_scores[None, :], (block, C_local))
            for b, shared, group, v in zip(
                    spec.blocks, shareds, state.groups, tile_vals):
                scores = scores + jnp.where(
                    state.alive[None, :],
                    mx._block_score_batch(b, shared, group, v), 0.0)

            # local (optionally gumbel-perturbed) max -> global argmax
            # via one pmax
            if sampling == 'argmax':
                total = scores
            else:
                gkey = jax.random.fold_in(step_key, shard)
                total = scores + jax.random.gumbel(gkey, scores.shape)
            local_best = jnp.max(total, axis=1)                  # [B]
            local_arg = base + jnp.argmax(total, axis=1)         # [B]
            global_best = lax.pmax(local_best, COMPONENTS)
            # tie-break to the LOWEST global slot id (matches a plain
            # argmax over the unsharded score row)
            winner = jnp.where(local_best == global_best, local_arg, C)
            new_assign = lax.pmin(winner, COMPONENTS).astype(jnp.int32)

            cd, tiles = local_deltas(tile_stats, new_assign)
            state = apply(state, cd, tiles, +1, block)
            return state, new_assign

        state, new_tiled = lax.scan(
            step, state,
            (tiled_values, tiled_stats, tiled_assign, keys))
        return state, new_tiled.reshape(R)

    return run(state, values, assignments, key)


def make_mesh_2d(n_rows, n_components, devices=None):
    """2-D mesh ('rows' x 'components') — the DPMM analog of a (data,
    tensor) parallel grid."""
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= n_rows * n_components
    grid = np.asarray(devices[:n_rows * n_components]).reshape(
        n_rows, n_components)
    return Mesh(grid, (ROWS, COMPONENTS))


def sharded_sweep_2d(spec, cl_model, shareds, state, values, assignments,
                     key, mesh, block, sampling='gumbel'):
    """Blocked sweep on a 2-D ('rows' x 'components') mesh: rows AND the
    component axis sharded simultaneously — the full production scaling
    story (data parallelism over observations composed with
    tensor-parallel partitioning of the mixture state).

    Per tile step, each device holds a [block, C_local] problem:
      1. local stat deltas for ITS rows x ITS slot range; psum over 'rows'
         completes each component shard's delta (O(C_local * S) floats on
         the interconnect — scores and rows never move);
      2. clustering normalization via two scalar psums over 'components';
      3. scores [block, C_local] + per-(row, local-slot) gumbel noise;
         the global categorical is one pmax pair-reduction over
         'components' of (local max, global slot id) — [block] floats;
      4. add-side deltas as in 1.

    The effective global block is block * n_row_shards.  State leaves are
    sharded over 'components' (each shard owns a contiguous slot range
    with its reserved empty slots, as in sharded_sweep_components);
    values/assignments are sharded over 'rows' and replicated over
    'components'.

    sampling='argmax' is the deterministic debug variant (exact-equality
    tests against the single-device blocked sweep).
    """
    assert isinstance(cl_model, _clustering.PitmanYor), (
        'component-sharded sweeps support the PitmanYor prior')
    n_row = mesh.shape[ROWS]
    n_comp = mesh.shape[COMPONENTS]
    C = spec.capacity
    assert C % n_comp == 0, 'capacity must divide over the component axis'
    R = assignments.shape[0]
    assert R % (n_row * block) == 0, (
        'pad rows to a multiple of row-shards*block')

    values = tuple(jnp.asarray(v) for v in values)

    state_specs = mx.MixtureState(
        counts=P(COMPONENTS), alive=P(COMPONENTS),
        sample_size=P(),
        groups=tuple(
            jax.tree_util.tree_map(lambda _: P(COMPONENTS), g)
            for g in state.groups))
    in_specs = (state_specs, tuple(P(ROWS) for _ in values), P(ROWS), P())
    out_specs = (state_specs, P(ROWS))

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
             check_vma=False)
    def run(state, values_shard, assign_shard, key):
        comp = lax.axis_index(COMPONENTS)
        row_shard = lax.axis_index(ROWS)
        C_local = C // n_comp
        base = comp * C_local
        local_R = assign_shard.shape[0]
        n_tiles = local_R // block
        n_removed = block * n_row
        gblock = block * n_row

        row_stats = mx.precompute_row_stats(spec, shareds, values_shard)
        tiled_stats = tuple(
            rs.reshape((n_tiles, block) + rs.shape[1:]) for rs in row_stats)
        tiled_assign = assign_shard.reshape(n_tiles, block)
        gtiles = jnp.arange(n_tiles, dtype=jnp.int32)

        def local_deltas(tile_stats, assign_global):
            """This device's rows x this device's slot range; psum over
            'rows' completes the component shard's tile delta."""
            local = assign_global - base
            onehot = (local[:, None] == jnp.arange(
                C_local, dtype=local.dtype)).astype(jnp.float32)
            cd = jnp.round(jnp.sum(onehot, axis=0)).astype(jnp.int32)
            tiles = []
            for b, shared, rs in zip(spec.blocks, shareds, tile_stats):
                flat = rs.reshape(rs.shape[0], -1)
                sums = model_base.exact_onehot_matmul(onehot.T, flat)
                sums = sums.reshape((C_local,) + rs.shape[1:])
                tiles.append(b.module.row_stats_to_tile(shared, sums))
            cd = lax.psum(cd, ROWS)
            tiles = lax.psum(tuple(tiles), ROWS)
            return cd, tiles

        def apply(state, cd, tiles, sign):
            counts = state.counts + sign * cd
            groups = []
            for b, shared, group, tile in zip(
                    spec.blocks, shareds, state.groups, tiles):
                tg = mx._block_stats_to_group(b, shared, tile)
                if sign > 0:
                    g = b.module.merge(shared, group, tg)
                else:
                    g = b.module.unmerge(shared, group, tg)
                    empty_now = counts == 0
                    g = jax.tree_util.tree_map(
                        lambda m: jnp.where(
                            mx._expand(empty_now, m.ndim),
                            jnp.zeros_like(m), m), g)
                groups.append(g)
            alive = mx._recompute_alive(counts, spec.empties)
            return mx.MixtureState(
                counts=counts, alive=alive,
                sample_size=state.sample_size + sign * n_removed,
                groups=tuple(groups))

        def step(state, inp):
            tile_vals, tile_stats, tile_assign, gtile = inp
            cd, tiles = local_deltas(tile_stats, tile_assign)
            state = apply(state, cd, tiles, -1)

            # clustering scores for the local slot range with global
            # normalization (two scalar psums over 'components')
            is_empty = state.alive & (state.counts == 0)
            g_empty = lax.psum(
                jnp.sum(is_empty.astype(jnp.int32)), COMPONENTS)
            g_nonempty = lax.psum(jnp.sum(
                (state.alive & (state.counts > 0)).astype(jnp.int32)),
                COMPONENTS)
            cl_scores = _clustering.py_score_value_sharded(
                cl_model, state.counts, state.alive, state.sample_size,
                g_empty, g_nonempty)

            scores = jnp.broadcast_to(cl_scores[None, :], (block, C_local))
            for b, shared, group, v in zip(
                    spec.blocks, shareds, state.groups, tile_vals):
                scores = scores + jnp.where(
                    state.alive[None, :],
                    mx._block_score_batch(b, shared, group, v), 0.0)

            if sampling == 'argmax':
                total = scores
            else:
                gkey = jax.random.fold_in(
                    jax.random.fold_in(
                        jax.random.fold_in(key, gtile), row_shard), comp)
                total = scores + jax.random.gumbel(gkey, scores.shape)
            local_best = jnp.max(total, axis=1)                  # [B]
            local_arg = base + jnp.argmax(total, axis=1)         # [B]
            global_best = lax.pmax(local_best, COMPONENTS)
            # tie-break to the LOWEST global slot id (matches a plain
            # argmax over the unsharded score row)
            winner = jnp.where(local_best == global_best, local_arg, C)
            new_assign = lax.pmin(winner, COMPONENTS).astype(jnp.int32)

            cd, tiles = local_deltas(tile_stats, new_assign)
            state = apply(state, cd, tiles, +1)
            return state, new_assign

        state, new_tiled = lax.scan(
            step, state,
            (tuple(v.reshape((n_tiles, block) + v.shape[1:])
                   for v in values_shard),
             tiled_stats, tiled_assign, gtiles))
        return state, new_tiled.reshape(local_R)

    return run(state, values, assignments, key)


def shard_state_components(state, mesh):
    """Place a replicated MixtureState onto the 2-D mesh's component axis
    (counts/alive/groups sharded; sample_size replicated)."""
    from jax.sharding import NamedSharding
    spec = mx.MixtureState(
        counts=P(COMPONENTS), alive=P(COMPONENTS), sample_size=P(),
        groups=tuple(
            jax.tree_util.tree_map(lambda _: P(COMPONENTS), g)
            for g in state.groups))
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        state, spec)


def sharded_score_data(spec, cl_model, shareds, state, mesh=None):
    """score_data on the replicated state (no collective needed — state is
    replicated; kept for API symmetry)."""
    return mx.score_data(spec, cl_model, shareds, state)


def sharded_state_from_assignments(spec, cl_model, shareds, values,
                                   assignments, mesh):
    """Build the replicated state from row-sharded (values, assignments)
    with one psum."""
    values = tuple(jnp.asarray(v) for v in values)
    in_specs = (tuple(P(ROWS) for _ in values), P(ROWS))

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=P(),
             check_vma=False)
    def run(values_shard, assign_shard):
        cd, tiles = mx.tile_deltas(spec, shareds, values_shard, assign_shard)
        cd = lax.psum(cd, ROWS)
        tiles = lax.psum(tiles, ROWS)
        n = assign_shard.shape[0] * lax.psum(1, ROWS)
        empty = mx.init(spec, shareds)
        return mx.apply_tile_deltas(spec, shareds, empty, cd, tiles, +1, n)

    return run(values, assignments)
