"""Production runner tests: checkpoint/resume continuation, validation,
capacity growth under load."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributions_tpu import clustering, mixture as mx, config, debug
from distributions_tpu.models import nich
from distributions_tpu.inference import runner


def _problem(R=64, seed=0):
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, 2)], capacity=16, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    centers = np.array([[-2., -2.], [2., 2.]])
    labels = rng.randint(0, 2, R)
    values = (jnp.asarray(
        centers[labels] + 0.3 * rng.randn(R, 2), jnp.float32),)
    return spec, shareds, values


def test_runner_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setattr(config, 'DEBUG_LEVEL', 2)
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    ckpt = str(tmp_path / 'run.ckpt')
    key = jax.random.PRNGKey(0)

    state, assignments, log = runner.run_gibbs(
        spec, cl, shareds, values, key, passes=6, block=16,
        checkpoint_path=ckpt, checkpoint_every=2)
    assert os.path.exists(ckpt)
    assert len(log.rows) == 6
    assert log.rows[-1]['sample_size'] == 64
    scores = [r['score_data'] for r in log.rows]
    assert scores[-1] > scores[0]  # mixing improves fit

    # resume continues from the checkpoint
    state2, assignments2, log2 = runner.run_gibbs(
        spec, cl, shareds, values, key, passes=2, block=16,
        checkpoint_path=ckpt, checkpoint_every=10)
    assert int(state2.sample_size) == 64


def test_runner_grows_capacity():
    # capacity 4 with alpha large -> growth triggers
    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, 1)], capacity=4, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}),)
    values = (jnp.asarray(rng.randn(64, 1) * 5, jnp.float32),)
    cl = clustering.PitmanYor.from_dict({'alpha': 20.0, 'd': 0.1})
    state, assignments, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(1), passes=5,
        block=16)
    assert np.asarray(state.counts).shape[0] >= 8  # grew beyond 4
    assert int(state.sample_size) == 64


def test_debug_validators():
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    assignments = jnp.zeros(64, jnp.int32)
    state = mx.state_from_assignments(spec, cl, shareds, values, assignments)
    old = config.DEBUG_LEVEL
    config.DEBUG_LEVEL = 2
    try:
        debug.validate_state(spec, state)
        debug.validate_assignments(spec, state, assignments)
        # corrupt: counts mismatch must raise
        bad = state._replace(counts=state.counts.at[0].add(1))
        with pytest.raises(AssertionError):
            debug.validate_state(spec, bad)
    finally:
        config.DEBUG_LEVEL = old


def test_runner_random_init():
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    state, assign, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(3), passes=3,
        block=32, init='random:8')
    a = np.asarray(assign)
    assert a.min() >= 0 and int(np.asarray(state.counts).sum()) == a.shape[0]


def test_resume_continues_exactly(tmp_path):
    """Kill-and-restart: run 2 sweeps + crash + resume to 5 must equal an
    uninterrupted 5-sweep run bitwise — same key stream, same sweep
    numbering, same logger history (VERDICT r2: resume previously
    restarted the sweep counter)."""
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    key = jax.random.PRNGKey(3)

    # uninterrupted reference
    st_a, an_a, log_a = runner.run_gibbs(
        spec, cl, shareds, values, key, passes=5, block=16, resume=False)

    # interrupted run: 2 sweeps, checkpoint, fresh process resumes
    ckpt = str(tmp_path / 'crash.ckpt')
    runner.run_gibbs(
        spec, cl, shareds, values, key, passes=2, block=16,
        checkpoint_path=ckpt, checkpoint_every=100, resume=False)
    st_b, an_b, log_b = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(999),  # ignored
        passes=5, block=16, checkpoint_path=ckpt, resume=True)

    np.testing.assert_array_equal(np.asarray(an_a), np.asarray(an_b))
    np.testing.assert_array_equal(np.asarray(st_a.counts),
                                  np.asarray(st_b.counts))
    # sweep numbering continuous across the restart, history preserved
    assert [r['sweep'] for r in log_b.rows] == [0, 1, 2, 3, 4]
    assert [r['sweep'] for r in log_a.rows] == [0, 1, 2, 3, 4]
    assert log_b.rows[-1]['score_data'] == log_a.rows[-1]['score_data']


def test_resume_noop_when_done(tmp_path):
    """Resuming a finished run does zero additional sweeps."""
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    ckpt = str(tmp_path / 'done.ckpt')
    _, an1, _ = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=3,
        block=16, checkpoint_path=ckpt, resume=False)
    _, an2, log2 = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(1), passes=3,
        block=16, checkpoint_path=ckpt, resume=True)
    np.testing.assert_array_equal(np.asarray(an1), np.asarray(an2))
    assert [r['sweep'] for r in log2.rows] == [0, 1, 2]


def test_checkpoint_scales_to_1m_rows(tmp_path):
    """1M-row assignment vectors ride the npz payload: checkpoint write +
    read round-trips exactly and takes well under a second of python-
    object work (previously repeated proto ints, multi-second at 1M)."""
    import time
    from distributions_tpu.io import checkpoint

    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    state = mx.init(spec, shareds)
    R = 1_000_000
    assignments = jnp.asarray(
        np.random.RandomState(0).randint(0, 16, R), jnp.int32)
    path = str(tmp_path / 'big.ckpt')

    t0 = time.time()
    checkpoint.save(path, state, assignments=assignments,
                    key=jax.random.PRNGKey(0), sweep=7,
                    logger_rows=[{'sweep': i} for i in range(7)])
    dt_save = time.time() - t0
    t0 = time.time()
    st2, an2, key2, sweep2, rows2 = checkpoint.load_extended(
        path, spec, shareds)
    dt_load = time.time() - t0

    np.testing.assert_array_equal(np.asarray(an2), np.asarray(assignments))
    assert sweep2 == 7 and len(rows2) == 7
    assert dt_save < 2.0 and dt_load < 2.0, (dt_save, dt_load)


def _mesh_problem(R, seed=0):
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, 2)], capacity=128, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    centers = np.array([[-2., -2.], [2., 2.]])
    labels = rng.randint(0, 2, R)
    values = (jnp.asarray(
        centers[labels] + 0.3 * rng.randn(R, 2), jnp.float32),)
    return spec, shareds, values, labels


def test_runner_mesh_path(monkeypatch):
    """With a mesh, every step goes through the row-sharded XLA sweep on
    the 8-device CPU mesh, and the chain finds the two clusters."""
    from distributions_tpu.parallel import sharding
    spec, shareds, values, labels = _mesh_problem(R=8192)
    mesh = sharding.make_mesh()
    cl = clustering.PitmanYor.from_dict({'alpha': 1., 'd': .1})

    calls = []
    orig = sharding.sharded_sweep_blocked

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(sharding, 'sharded_sweep_blocked', spy)

    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=6,
        block=512, init='random:8', mesh=mesh, grow_headroom=0.0)
    assert len(calls) == 6, 'sharded path must run every sweep'
    assert len(log.rows) == 6
    R = 8192
    assert int(np.asarray(state.counts).sum()) == R
    a = np.asarray(an)
    purity = sum(np.bincount(labels[a == g]).max()
                 for g in np.unique(a)) / R
    assert purity > 0.95, purity


def test_runner_mesh_xla_fallback():
    """A small block (many tiles per device) on the mesh still mixes."""
    from distributions_tpu.parallel import sharding
    spec, shareds, values, labels = _mesh_problem(R=1024)
    mesh = sharding.make_mesh()
    cl = clustering.PitmanYor.from_dict({'alpha': 1., 'd': .1})
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=8,
        block=32, init='random:8', mesh=mesh, grow_headroom=0.0)
    assert len(log.rows) == 8
    a = np.asarray(an)
    purity = sum(np.bincount(labels[a == g]).max()
                 for g in np.unique(a)) / 1024
    assert purity > 0.95, purity


def test_runner_hyper_grid_resampling(tmp_path):
    """Hyper-grid runs: (1) the grid step moves the feature Shared toward
    the data-supported setting, (2) resampled hypers round-trip through
    the checkpoint, (3) resume restores them (not the originals)."""
    from distributions_tpu.io import checkpoint as ckpt_mod
    from distributions_tpu.inference import hypers

    spec, shareds, values = _problem(R=128)
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    ckpt = str(tmp_path / 'hyper.ckpt')

    # grid over sigmasq: the data has within-cluster sigma ~ 0.3
    # (sigmasq ~ 0.1); a grid {0.01, 0.1, 10} should avoid 10
    grid = nich.Shared(
        mu=jnp.zeros(3), kappa=jnp.full(3, 0.1),
        sigmasq=jnp.asarray([0.01, 0.1, 10.0]), nu=jnp.ones(3))
    cl_grid = hypers.make_py_grid([0.5, 1.0, 2.0], [0.0, 0.1])

    state, assign, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=12,
        block=32, checkpoint_path=ckpt, checkpoint_every=6,
        hyper_grids={0: grid}, cl_grid=cl_grid, hyper_every=3,
        hyper_sample=False)

    new_shared = log.final_shareds[0]
    assert float(new_shared.sigmasq) != 10.0
    assert log.final_cl_model is not None
    hyper_rows = [r for r in log.rows if 'hyper_0' in r]
    assert len(hyper_rows) == 4  # sweeps 3, 6, 9, 12

    # checkpoint carries the resampled hypers
    saved_shareds, saved_cl = ckpt_mod.load_hypers(ckpt, spec)
    assert saved_shareds is not None
    np.testing.assert_allclose(float(saved_shareds[0].sigmasq),
                               float(new_shared.sigmasq), rtol=1e-6)
    assert isinstance(saved_cl, clustering.PitmanYor)

    # resume path restores the saved hypers: run 3 more passes from the
    # checkpoint passing the ORIGINAL shareds; the logged scores must be
    # computed under the resampled ones (smoke: it runs and continues
    # numbering), and load_hypers after still matches
    state2, assign2, log2 = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=15,
        block=32, checkpoint_path=ckpt, checkpoint_every=3,
        hyper_grids={0: grid}, cl_grid=cl_grid, hyper_every=100)
    assert [r['sweep'] for r in log2.rows][-1] == 14
    again_shareds, _ = ckpt_mod.load_hypers(ckpt, spec)
    np.testing.assert_allclose(float(again_shareds[0].sigmasq),
                               float(new_shared.sigmasq), rtol=1e-6)


def test_checkpoint_hypers_dpd_roundtrip(tmp_path):
    """dpd's value-keyed betas/counts dicts survive the json hypers blob
    (keys re-coerced to int on load so slot order is stable)."""
    from distributions_tpu.io import checkpoint as ckpt_mod
    from distributions_tpu.models import dpd

    spec = mx.make_spec([(dpd, 1)], capacity=16, empties=1)
    shared = dpd.shared_from_dict(
        {'gamma': 0.5, 'alpha': 0.5,
         'betas': {2: 0.25, 10: 0.5, 1: 0.25},
         'counts': {2: 1, 10: 2, 1: 4}}, cap=16)
    state = mx.init(spec, (shared,))
    path = str(tmp_path / 'dpd.ckpt')
    ckpt_mod.save(path, state, spec=spec, shareds=(shared,))
    loaded, _ = ckpt_mod.load_hypers(path, spec)
    assert dpd.shared_to_dict(loaded[0]) == dpd.shared_to_dict(shared)
    np.testing.assert_array_equal(np.asarray(loaded[0].values),
                                  np.asarray(shared.values))


def test_resume_orbax_format_continues_exactly(tmp_path):
    """checkpoint_format='orbax' (per-host sharded write, no gather):
    kill-and-restart resume must equal an uninterrupted run bitwise, the
    same contract test_resume_continues_exactly pins for the npz
    envelope."""
    pytest.importorskip('orbax.checkpoint')
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    key = jax.random.PRNGKey(3)

    st_a, an_a, log_a = runner.run_gibbs(
        spec, cl, shareds, values, key, passes=5, block=16, resume=False)

    ckpt = str(tmp_path / 'crash_orbax')
    runner.run_gibbs(
        spec, cl, shareds, values, key, passes=2, block=16,
        checkpoint_path=ckpt, checkpoint_every=100, resume=False,
        checkpoint_format='orbax')
    assert os.path.isdir(ckpt)
    st_b, an_b, log_b = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(999),  # ignored
        passes=5, block=16, checkpoint_path=ckpt, resume=True,
        checkpoint_format='orbax')

    np.testing.assert_array_equal(np.asarray(an_a), np.asarray(an_b))
    np.testing.assert_array_equal(np.asarray(st_a.counts),
                                  np.asarray(st_b.counts))
    assert [r['sweep'] for r in log_b.rows] == [0, 1, 2, 3, 4]
    assert log_b.rows[-1]['score_data'] == log_a.rows[-1]['score_data']

def test_runner_sweeps_per_step_boundaries():
    """sweeps_per_step batches sweeps per device program but clamps each
    step to hyper/checkpoint/passes boundaries: total sweeps and final
    state invariants match the per-sweep loop semantics."""
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=10,
        block=16, sweeps_per_step=4)
    # steps: 4, 4, 2 (passes boundary)
    assert [r['sweeps'] for r in log.rows] == [4, 4, 2]
    assert [r['sweep'] for r in log.rows] == [3, 7, 9]
    assert int(state.sample_size) == 64
    assert int(np.asarray(state.counts).sum()) == 64


def test_runner_sweeps_per_step_resume_bitwise(tmp_path):
    """A multi-sweep-step run interrupted at a checkpoint boundary and
    resumed equals the uninterrupted run bitwise (the per-step key grid
    re-aligns because steps clamp to checkpoint_every boundaries)."""
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    key = jax.random.PRNGKey(7)

    st_a, an_a, log_a = runner.run_gibbs(
        spec, cl, shareds, values, key, passes=6, block=16, resume=False,
        checkpoint_every=3, sweeps_per_step=3)

    ckpt = str(tmp_path / 'spstep.ckpt')
    runner.run_gibbs(
        spec, cl, shareds, values, key, passes=3, block=16,
        checkpoint_path=ckpt, checkpoint_every=3, resume=False,
        sweeps_per_step=3)
    st_b, an_b, log_b = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(999), passes=6,
        block=16, checkpoint_path=ckpt, resume=True, checkpoint_every=3,
        sweeps_per_step=3)

    np.testing.assert_array_equal(np.asarray(an_a), np.asarray(an_b))
    np.testing.assert_array_equal(np.asarray(st_a.counts),
                                  np.asarray(st_b.counts))
    assert [r['sweep'] for r in log_b.rows] == [2, 5]


def test_runner_sweeps_per_step_hyper_boundary(tmp_path):
    """Hyper resampling still happens exactly at hyper_every boundaries
    when steps batch multiple sweeps."""
    from distributions_tpu.inference import hypers

    spec, shareds, values = _problem(R=128)
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    grid = nich.Shared(
        mu=jnp.zeros(3), kappa=jnp.full(3, 0.1),
        sigmasq=jnp.asarray([0.01, 0.1, 10.0]), nu=jnp.ones(3))
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(2), passes=8,
        block=32, hyper_grids={0: grid}, hyper_every=3,
        sweeps_per_step=10)
    # steps clamp to 3, 3, 2; hyper rows at sweep indices 2 and 5
    hyper_rows = [r['sweep'] for r in log.rows if 'hyper_0' in r]
    assert hyper_rows == [2, 5]
    assert int(state.sample_size) == 128


def test_runner_mesh_sweeps_per_step():
    """The mesh path honors sweeps_per_step: one logger row per step."""
    from distributions_tpu.parallel import sharding
    spec, shareds, values, labels = _mesh_problem(R=8192)
    mesh = sharding.make_mesh()
    cl = clustering.PitmanYor.from_dict({'alpha': 1., 'd': .1})
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=6,
        block=512, init='random:8', mesh=mesh, grow_headroom=0.0,
        sweeps_per_step=3)
    assert [r['sweeps'] for r in log.rows] == [3, 3]
    R = 8192
    assert int(np.asarray(state.counts).sum()) == R
    a = np.asarray(an)
    purity = sum(np.bincount(labels[a == g]).max()
                 for g in np.unique(a)) / R
    assert purity > 0.95, purity


def test_runner_initial_assignments_warm_start():
    """Warm start from an explicit labeling (initial_assignments):
    overrides init, state matches state_from_assignments of the input."""
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    an0 = jnp.asarray(np.arange(64) % 3, jnp.int32)
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=2,
        block=16, initial_assignments=an0)
    assert int(state.sample_size) == 64
    assert int(np.asarray(state.counts).sum()) == 64
    # zero-pass run returns exactly the warm-start state
    st0, an_out, _ = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=0,
        block=16, initial_assignments=an0)
    np.testing.assert_array_equal(np.asarray(an_out), np.asarray(an0))
    np.testing.assert_array_equal(
        np.asarray(st0.counts),
        np.bincount(np.asarray(an0), minlength=spec.capacity))


def test_runner_logged_score_matches_final_state():
    """The deferred-score logging path (scores dispatched per step, read
    one step later) must log the same values a direct recompute gives:
    the LAST row's score_data equals mx.score_data of the returned
    state."""
    spec, shareds, values = _problem()
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(5), passes=4,
        block=16, sweeps_per_step=2)
    want = float(mx.score_data(spec, cl, shareds, state))
    assert log.rows[-1]['score_data'] == pytest.approx(want, rel=1e-6)
    # every row carries a realized score (no leaked device handles)
    assert all(isinstance(r['score_data'], float) for r in log.rows)
