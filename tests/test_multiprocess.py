"""Multi-host execution tests: launch REAL multi-process CPU groups
(jax.distributed + gloo collectives, 2 processes x 4 virtual devices) and
assert the row-sharded sweep over the 8-device global mesh equals the
single-process 8-device sweep under fixed keys.

This is the validation the reference never needed (single-process
library) and SURVEY §5 requires of the accelerator build: per-row keys fold in
GLOBAL row indices, so the draws are layout- AND process-count-
independent; suff-stat psums are integer or small-f32 sums whose
cross-process reduction matches single-process bitwise at these sizes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributions_tpu import clustering, mixture as mx
from distributions_tpu.models import nich
from distributions_tpu.parallel import sharding

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, 'multiprocess_worker.py')


def _problem(R=64, cols=2, C=32, seed=0):
    """Must match tests/multiprocess_worker.py::problem exactly."""
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    centers = rng.randn(3, cols) * 3
    labels = rng.randint(0, 3, R)
    X = (centers[labels] + 0.3 * rng.randn(R, cols)).astype(np.float32)
    return spec, shareds, X, labels.astype(np.int32)


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(nproc, devs, out_path, timeout=240):
    port = _free_port()
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)           # worker sets its own device count
    env['JAX_PLATFORMS'] = 'cpu'
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(p), str(nproc), str(port),
             str(devs), out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors='replace'))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, 'worker failed:\n%s' % out[-3000:]


def _single_process_reference():
    """The same sweep on this process's 8 virtual devices."""
    R = 64
    spec, shareds, X, labels = _problem(R=R)
    mesh = sharding.make_mesh()
    assert mesh.devices.size == 8
    values = (jnp.asarray(X),)
    assignments = jnp.asarray(labels)
    py = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    state = mx.state_from_assignments(spec, py, shareds, values, assignments)
    key = jax.random.PRNGKey(42)
    for _ in range(4):
        key, sub = jax.random.split(key)
        state, assignments = sharding.sharded_sweep_blocked(
            spec, py, shareds, state, values, assignments, sub, mesh,
            block=4)
    score = float(mx.score_data(spec, py, shareds, state))
    return np.asarray(assignments), np.asarray(state.counts), score


@pytest.mark.parametrize('nproc,devs', [(2, 4)])
def test_multiprocess_sweep_equals_single_process(nproc, devs, tmp_path):
    out_path = str(tmp_path / 'mp.npz')
    _run_group(nproc, devs, out_path)
    got = np.load(out_path)
    want_an, want_counts, want_score = _single_process_reference()
    np.testing.assert_array_equal(got['an'], want_an)
    np.testing.assert_array_equal(got['counts'], want_counts)
    np.testing.assert_allclose(float(got['score']), want_score,
                               rtol=1e-5, atol=1e-3)


def _run_group_mode(nproc, devs, out_path, mode, timeout=240):
    port = _free_port()
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)
    env['JAX_PLATFORMS'] = 'cpu'
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(p), str(nproc), str(port),
             str(devs), out_path, mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors='replace'))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, 'worker failed:\n%s' % out[-3000:]


def test_multiprocess_runner_with_checkpoint(tmp_path):
    """The production runner accepts a multi-host mesh: sweeps run over
    the 2-process global mesh, diagnostics/validation use the host-local
    view, and process 0 writes the checkpoint."""
    out_path = str(tmp_path / 'runner.npz')
    _run_group_mode(2, 4, out_path, 'runner')
    got = np.load(out_path)
    assert int(got['sweeps']) == 3
    assert got['an'].shape == (64,)
    assert got['counts'].sum() == 64
    assert os.path.exists(out_path + '.ckpt')


def test_multiprocess_2d_mesh_equals_single_process(tmp_path):
    """rows over hosts x components within each host: the 2-process 2x4 mesh argmax sweep equals the single-process
    2x4 mesh sweep exactly."""
    out_path = str(tmp_path / 'mp2d.npz')
    _run_group_mode(2, 4, out_path, '2d')
    got = np.load(out_path)

    # single-process reference on a local 2x4 mesh
    R = 64
    spec, shareds, X, labels = _problem(R=R)
    mesh = sharding.make_mesh_2d(2, 4)
    values = (jnp.asarray(X),)
    assignments = jnp.asarray(labels)
    py = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    state = mx.state_from_assignments(spec, py, shareds, values, assignments)
    state = sharding.shard_state_components(state, mesh)
    key = jax.random.PRNGKey(5)
    for _ in range(3):
        key, sub = jax.random.split(key)
        state, assignments = sharding.sharded_sweep_2d(
            spec, py, shareds, state, values, assignments, sub, mesh,
            block=8, sampling='argmax')
    np.testing.assert_array_equal(got['an'], np.asarray(assignments))
    np.testing.assert_array_equal(got['counts'], np.asarray(state.counts))


def test_multiprocess_orbax_roundtrip(tmp_path):
    """Multi-process orbax: each of the 2 processes writes its own
    addressable shards (the per-host-parallel-write path), restore lays
    the arrays back onto the same global mesh, and sweeps continued from
    the restored state equal sweeps continued from the live state
    bitwise (asserted inside the workers; SURVEY §5 checkpoint row)."""
    pytest.importorskip('orbax.checkpoint')
    out_path = str(tmp_path / 'orbax.npz')
    _run_group_mode(2, 4, out_path, 'orbax', timeout=360)
    got = np.load(out_path)
    assert got['an'].shape == (64,)
    assert got['counts'].sum() == 64
    assert os.path.isdir(out_path + '.orbax')
