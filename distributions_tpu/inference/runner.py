"""Production Gibbs runner: long-running sweeps with periodic
checkpointing, automatic resume, invariant validation, and structured
sweep logging — the failure-recovery story the single-process reference
never needed (reference SURVEY §5: 'The new framework needs real
multi-host checkpoint-restart instead')."""

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from distributions_tpu import mixture as mx, debug, diagnostics
from distributions_tpu.ops import gibbs


def run_gibbs(spec, cl_model, shareds, values, key, passes,
              block=4096, checkpoint_path=None, checkpoint_every=10,
              resume=True, init='prior', grow_headroom=0.125, log=None,
              mesh=None, hyper_grids=None, cl_grid=None, hyper_every=10,
              hyper_sample=True, checkpoint_format='npz', hyper_slice=None,
              cl_slice=False, sweeps_per_step=1, initial_assignments=None):
    """Run `passes` blocked collapsed-Gibbs sweeps with checkpoint/resume.

    - resumes from `checkpoint_path` when it exists (bitwise-continuing the
      RNG stream),
    - checkpoints every `checkpoint_every` sweeps,
    - grows capacity outside jit when free slots drop below
      `grow_headroom * capacity`,
    - validates invariants at config.DEBUG_LEVEL >= 1,
    - row-shards over `mesh` when given (parallel/sharding
      .sharded_sweep_blocked); otherwise runs ops/gibbs.sweep_blocked.

    init: 'prior' (sequential CRP predictive) | 'sequential' (greedy
    posterior predictive) | 'random:K' (uniform over the first K slots —
    the scalable choice: both exact inits are R-step sequential scans,
    which compile and run slowly for R ~ 1e6).
    Alternatively pass `initial_assignments` (an [R] int32 vector) to
    warm-start from an existing labeling (e.g. a previous run's output
    or an external clustering); it overrides `init`.

    Hyperparameter resampling (the loom-style production loop the
    reference's downstream systems run on top of score_data_grid,
    reference dd.hpp:259-287): every `hyper_every` sweeps, each feature
    block listed in `hyper_grids` ({block_idx: grid Shared pytree with a
    leading [G] axis}) is resampled (or argmaxed, hyper_sample=False)
    from its grid via inference.hypers.grid_step_feature, and the
    clustering prior from `cl_grid` (a vmappable model pytree, e.g.
    hypers.make_py_grid(...)).  Resampled hyperparameters are saved in
    the checkpoint and restored on resume.

    Resume contract: the checkpoint carries the RNG key, sweep index,
    and logger rows, so a restart continues the *stream of sweep keys*
    bitwise, and with the same `block`, `mesh` and step settings (see
    below) the draws themselves are bitwise-identical to an
    uninterrupted run.

    sweeps_per_step: how many sweeps run between host synchronizations.
    Host-side work — sync, validation, sweep_stats, logging, hyper
    resampling, capacity-growth checks, checkpoints — happens at STEP
    boundaries only; steps are clamped so hyper_every / checkpoint_every
    / passes boundaries always land on a step edge (semantics are
    preserved, just coarser diagnostics granularity: one logger row per
    step covering `sweeps` sweeps).  Capacity growth is likewise only
    detected between steps — with large sweeps_per_step, size
    grow_headroom (or the initial capacity) accordingly.

    Returns (state, assignments, logger).  Hyper-grid runs read the final
    resampled hyperparameters from `logger.final_shareds` /
    `logger.final_cl_model` (also recoverable from the checkpoint via
    io.checkpoint.load_hypers).
    """
    logger = log or diagnostics.SweepLogger()
    start_pass = 0
    assert checkpoint_format in ('npz', 'orbax'), checkpoint_format

    if resume and checkpoint_path and checkpoint_format == 'orbax':
        from distributions_tpu.io import checkpoint_orbax
        resumed = checkpoint_orbax.recover(checkpoint_path)
    else:
        resumed = (resume and checkpoint_path is not None
                   and os.path.exists(checkpoint_path))
    if resumed and checkpoint_format == 'orbax':
        # per-host-parallel sharded restore (io/checkpoint_orbax.py);
        # recover() first heals a crash mid-overwrite-swap (a complete
        # checkpoint at a .tmp-orbax/.stale sibling is renamed back —
        # without this a mid-swap crash silently restarted from sweep
        # 0).  The extended load also restores persisted hypers
        # (resampling runs) and adopts the saved capacity (mid-run
        # grow_capacity).
        R = int(np.shape(np.asarray(values[0]) if mesh is None
                         else values[0])[0])
        loaded = checkpoint_orbax.load_sharded(
            checkpoint_path, spec, shareds, mesh=mesh, n_rows=R,
            extended=True)
        state, assignments = loaded.state, loaded.assignments
        start_pass, spec = loaded.sweep, loaded.spec
        if loaded.key is not None:
            key = loaded.key
        if loaded.logger_rows and not logger.rows:
            logger.rows = loaded.logger_rows
        if loaded.shareds is not None:
            shareds = loaded.shareds
        if loaded.cl_model is not None:
            cl_model = loaded.cl_model
    elif resumed:
        from distributions_tpu.io import checkpoint
        state, assignments, saved_key, start_pass, rows = \
            checkpoint.load_extended(checkpoint_path, spec, shareds)
        if saved_key is not None:
            key = saved_key
        if rows and not logger.rows:
            logger.rows = rows
        saved_shareds, saved_cl = checkpoint.load_hypers(
            checkpoint_path, spec)
        if saved_shareds is not None:
            shareds = saved_shareds
        if saved_cl is not None:
            cl_model = saved_cl
    elif initial_assignments is not None:
        assignments = jnp.asarray(initial_assignments, jnp.int32) \
            if not isinstance(initial_assignments, jax.Array) \
            else initial_assignments.astype(jnp.int32)
        state = mx.state_from_assignments(
            spec, cl_model, shareds, values, assignments)
    else:
        state = mx.init(spec, shareds)
        key, sub = jax.random.split(key)
        if init == 'prior':
            state, assignments = gibbs.prior_init(
                spec, cl_model, shareds, state, values, sub)
        elif init.startswith('random'):
            k0 = int(init.split(':')[1]) if ':' in init else 64
            R = int(jax.numpy.asarray(values[0]).shape[0])
            assignments = jax.random.randint(
                sub, (R,), 0, min(k0, spec.capacity), dtype=jax.numpy.int32)
            state = mx.state_from_assignments(
                spec, cl_model, shareds, values, assignments)
        else:
            state, assignments = gibbs.sequential_init(
                spec, cl_model, shareds, state, values, sub)

    hyper_active = bool(hyper_grids or hyper_slice or cl_grid is not None
                        or cl_slice)
    assert sweeps_per_step >= 1, sweeps_per_step

    # the current step's logger row is held PENDING until the next step
    # boundary: its joint score is dispatched as a device program here
    # and read one step later, when it has long finished — reading it at
    # once would stall the host until the device drains its queue, and
    # the next step could not be enqueued behind it
    pending = []

    def flush_pending():
        if not pending:
            return
        idx, row = pending.pop()
        score = row.pop('_score_dev', None)
        if score is not None:
            row['score_data'] = float(score)
        logger.log(idx, **row)

    counts_host = None
    sweep = start_pass
    while sweep < passes:
        # capacity growth needs host-addressable state; in multi-host runs
        # (global arrays) pre-size the capacity instead.  The check reuses
        # the step-sync host copy of counts (no extra device round trip).
        if getattr(state.counts, 'is_fully_addressable', True):
            if counts_host is None:
                counts_host = np.asarray(state.counts)
            if mx.needs_growth(spec, state, grow_headroom,
                               counts=counts_host):
                spec, state = mx.grow_capacity(
                    spec, state, 2 * spec.capacity)

        # clamp the step so every hyper/checkpoint/passes boundary lands
        # exactly on a step edge.  RNG-stream contract: per-sweep keys
        # are split(sub, k) for k>1 but `sub` itself for k=1, and the
        # clamps depend on checkpoint/hyper settings — so the draw
        # stream is a function of (sweeps_per_step, checkpoint_every,
        # hyper_every, passes).  Bitwise resume holds when the resumed
        # run uses the SAME settings (then the step grid re-aligns at
        # any checkpoint boundary); different settings give a different
        # — equally distributed — chain.
        k = min(sweeps_per_step, passes - sweep)
        if hyper_active and hyper_every:
            k = min(k, hyper_every - sweep % hyper_every)
        if checkpoint_path and checkpoint_every:
            k = min(k, checkpoint_every - sweep % checkpoint_every)

        key, sub = jax.random.split(key)
        t0 = time.time()
        for sk in (jax.random.split(sub, k) if k > 1 else [sub]):
            if mesh is None:
                state, assignments = gibbs.sweep_blocked(
                    spec, cl_model, shareds, state, values, assignments,
                    block, key=sk)
            else:
                from distributions_tpu.parallel import sharding
                state, assignments = sharding.sharded_sweep_blocked(
                    spec, cl_model, shareds, state, values, assignments,
                    sk, mesh, block)
        # sync on the SMALL [C] counts buffer: it is ready only when the
        # whole step has finished, and the read doubles as the
        # stats/growth-check host copy
        if getattr(state.counts, 'is_fully_addressable', True):
            counts_host = np.asarray(state.counts)
        else:
            jax.block_until_ready(state.counts)  # multi-host global array
            counts_host = None
        dt = time.time() - t0
        sweep += k

        debug.validate_state(spec, _host_view(state))
        if getattr(assignments, 'is_fully_addressable', True):
            debug.validate_assignments(spec, state, assignments)
        stats = diagnostics.sweep_stats(
            spec, cl_model, shareds, _host_view(state),
            counts=counts_host, defer_score=True)
        stats['seconds'] = round(dt, 4)
        if sweeps_per_step > 1:
            stats['sweeps'] = k
        flush_pending()   # previous step's row, its score long computed

        if hyper_active and sweep % hyper_every == 0:
            from distributions_tpu.inference import hypers as _hypers
            for block_idx, grid in (hyper_grids or {}).items():
                key, sub = jax.random.split(key)
                shareds, idx, _ = _hypers.grid_step_feature(
                    sub, spec, block_idx, shareds, state, grid,
                    sample=hyper_sample)
                stats['hyper_%d' % block_idx] = int(idx)
            # continuous alternatives (inference/slice.py): no grid design
            # needed — coordinate-wise slice sampling of the same
            # objectives.  hyper_slice: {block_idx: (param names tuple,
            # width)} or {block_idx: kwargs dict for slice_step_feature
            # minus the positional args, e.g. {'params': ('alphas',),
            # 'width': 1.5, 'bounds': {...}, 'priors': {...}}} —
            # concentration parameters NEED bounds or a prior (the
            # flat-in-log posterior has an improper ridge; see
            # slice_step_feature).  cl_slice: True or a kwargs dict for
            # slice_step_clustering.
            for block_idx, cfg in (hyper_slice or {}).items():
                from distributions_tpu.inference import slice as _slice
                key, sub = jax.random.split(key)
                if isinstance(cfg, dict):
                    kw = dict(cfg)
                    params = tuple(kw.pop('params'))
                else:
                    params, width = cfg
                    params, kw = tuple(params), {'width': width}
                shareds, sh = _slice.slice_step_feature(
                    sub, spec, block_idx, shareds, state, params, **kw)
                stats['hyper_slice_%d' % block_idx] = 1
            if cl_grid is not None:
                key, sub = jax.random.split(key)
                cl_model, idx, _ = _hypers.grid_step_clustering(
                    sub, cl_grid, state, sample=hyper_sample)
                stats['hyper_cl'] = int(idx)
            elif cl_slice:
                from distributions_tpu.inference import slice as _slice
                key, sub = jax.random.split(key)
                kw = cl_slice if isinstance(cl_slice, dict) else {}
                cl_model, _ = _slice.slice_step_clustering(
                    sub, cl_model, state, **kw)
                stats['hyper_cl_alpha'] = float(cl_model.alpha)
                stats['hyper_cl_d'] = float(cl_model.d)

        pending.append((sweep - 1, stats))

        if checkpoint_path and sweep % checkpoint_every == 0 \
                and sweep < passes:
            flush_pending()   # logger.rows must be complete in the save
            _save(checkpoint_path, state, assignments, key, sweep,
                  logger, spec=spec, shareds=shareds, cl_model=cl_model,
                  fmt=checkpoint_format)

    flush_pending()
    if checkpoint_path:
        _save(checkpoint_path, state, assignments, key, passes, logger,
              spec=spec, shareds=shareds, cl_model=cl_model,
              fmt=checkpoint_format)
    logger.final_shareds = shareds
    logger.final_cl_model = cl_model
    return state, assignments, logger


def _host_view(state):
    """Host-local view of a (replicated) mixture state — multi-host global
    arrays are not fully addressable, so validation/diagnostics read the
    local shard of each replicated leaf."""
    import jax as _jax

    def leaf(a):
        if getattr(a, 'is_fully_addressable', True):
            return a
        return _jax.device_get(a.addressable_shards[0].data)
    return _jax.tree_util.tree_map(leaf, state)


def _save(path, state, assignments, key, sweep, logger, spec=None,
          shareds=None, cl_model=None, fmt='npz'):
    """Checkpoint.  fmt='npz': rows are gathered and process 0 writes the
    protobuf/npz envelope (the state is replicated, so host 0's view is
    the state).  fmt='orbax': collective per-host-parallel sharded write
    — every process stores only its addressable shards, nothing is
    gathered (the multi-host-scale path; SURVEY §5 checkpoint row)."""
    if fmt == 'orbax':
        from distributions_tpu.io import checkpoint_orbax
        checkpoint_orbax.save_sharded(
            path, state, assignments=assignments, key=key, sweep=sweep,
            logger_rows=logger.rows, force=True, shareds=shareds,
            cl_model=cl_model, spec=spec)
        return
    from distributions_tpu.io import checkpoint
    from distributions_tpu.parallel import distributed
    an = distributed.gather_rows(assignments)
    if jax.process_index() == 0:
        checkpoint.save(path, _host_view(state), assignments=an, key=key,
                        sweep=sweep, logger_rows=logger.rows,
                        shareds=shareds, cl_model=cl_model, spec=spec)
