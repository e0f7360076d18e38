"""Worker for tests/test_multiprocess.py: one process of a multi-host CPU
group.  Builds the SAME synthetic DPMM problem as the test, loads only its
own row shard (distributed.host_row_slice), joins the global mesh, runs
row-sharded sweeps, and (process 0) writes gathered results.

Run: python multiprocess_worker.py <pid> <nproc> <port> <devs> <out.npz> \
         [mode]

mode: 'sweep' (default) — direct row-sharded sweeps over the 1-D global
mesh; 'runner' — the production runner (inference.runner.run_gibbs) on
the global mesh with process-0 checkpointing; '2d' — rows over hosts
x components within hosts via make_global_mesh_2d +
sharded_sweep_2d.
"""

import os
import sys

pid, nproc, port, devs = map(int, sys.argv[1:5])
out_path = sys.argv[5]
mode = sys.argv[6] if len(sys.argv) > 6 else 'sweep'

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
os.environ['XLA_FLAGS'] = (
    flags + ' --xla_force_host_platform_device_count=%d' % devs).strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributions_tpu import clustering, mixture as mx  # noqa: E402
from distributions_tpu.models import nich  # noqa: E402
from distributions_tpu.parallel import distributed, sharding  # noqa: E402


def problem(R=64, cols=2, C=32, seed=0):
    """Must match tests/test_multiprocess.py::_problem exactly."""
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    centers = rng.randn(3, cols) * 3
    labels = rng.randint(0, 3, R)
    X = (centers[labels] + 0.3 * rng.randn(R, cols)).astype(np.float32)
    return spec, shareds, X, labels.astype(np.int32)


def _local(a):
    if getattr(a, 'is_fully_addressable', True):
        return np.asarray(a)
    return np.asarray(jax.device_get(a.addressable_shards[0].data))


def _setup(R=64):
    distributed.initialize('localhost:%d' % port, num_processes=nproc,
                           process_id=pid)
    assert jax.process_count() == nproc
    spec, shareds, X, labels = problem(R=R)
    mesh = distributed.make_global_mesh()
    # per-host data loading: this process materializes ONLY its row range
    start, stop = distributed.host_row_slice(R)
    values = distributed.global_rows_from_host_data(
        (X[start:stop],), R, mesh)
    (assignments,) = distributed.global_rows_from_host_data(
        (labels[start:stop],), R, mesh)
    py = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    return spec, shareds, values, assignments, py, mesh


def mode_sweep():
    R = 64
    spec, shareds, values, assignments, py, mesh = _setup(R)
    state = jax.jit(
        lambda v, a: mx.state_from_assignments(spec, py, shareds, v, a)
    )(values, assignments)

    key = jax.random.PRNGKey(42)
    for _ in range(4):
        key, sub = jax.random.split(key)
        state, assignments = sharding.sharded_sweep_blocked(
            spec, py, shareds, state, values, assignments, sub, mesh,
            block=4)
    distributed.sync((state, assignments))

    an = distributed.gather_rows(assignments)
    score = float(_local(jax.jit(
        lambda s: mx.score_data(spec, py, shareds, s))(state)))
    if pid == 0:
        np.savez(out_path, an=an, counts=_local(state.counts), score=score)


def mode_runner():
    """Production runner on the global mesh; process-0 checkpointing."""
    from distributions_tpu.inference import runner
    R = 64
    spec, shareds, values, assignments, py, mesh = _setup(R)
    ckpt = out_path + '.ckpt'
    state, an, logger = runner.run_gibbs(
        spec, py, shareds, values, jax.random.PRNGKey(7), passes=3,
        block=4, checkpoint_path=ckpt, checkpoint_every=2, resume=False,
        init='random:8', mesh=mesh)
    an = distributed.gather_rows(an)
    if pid == 0:
        assert os.path.exists(ckpt), 'process 0 must write the checkpoint'
        np.savez(out_path, an=an, counts=_local(state.counts),
                 sweeps=len(logger.rows))


def mode_2d():
    """rows over hosts x components within hosts."""
    R = 64
    spec, shareds, values, assignments, py, mesh1d = _setup(R)
    mesh = distributed.make_global_mesh_2d()
    assert mesh.shape['rows'] == nproc
    assert mesh.shape['components'] == devs
    state = jax.jit(
        lambda v, a: mx.state_from_assignments(spec, py, shareds, v, a)
    )(values, assignments)
    state = sharding.shard_state_components(state, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P
    values = tuple(
        jax.device_put(v, NamedSharding(mesh, P('rows')))
        for v in values)
    assignments = jax.device_put(
        assignments, NamedSharding(mesh, P('rows')))

    key = jax.random.PRNGKey(5)
    for _ in range(3):
        key, sub = jax.random.split(key)
        state, assignments = sharding.sharded_sweep_2d(
            spec, py, shareds, state, values, assignments, sub, mesh,
            block=8, sampling='argmax')
    distributed.sync((state, assignments))
    an = distributed.gather_rows(assignments)
    counts = distributed.gather_rows(state.counts)
    if pid == 0:
        np.savez(out_path, an=an, counts=counts)


def mode_orbax():
    """Multi-process orbax round trip: every process writes its own
    addressable shards (the per-host-parallel-write path orbax exists
    for), restore re-lays onto the same global mesh, and sweeps continued
    from the restored state must equal sweeps continued from the live
    state bitwise."""
    from distributions_tpu.io import checkpoint_orbax
    R = 64
    spec, shareds, values, assignments, py, mesh = _setup(R)
    state = jax.jit(
        lambda v, a: mx.state_from_assignments(spec, py, shareds, v, a)
    )(values, assignments)

    key = jax.random.PRNGKey(11)
    for _ in range(2):
        key, sub = jax.random.split(key)
        state, assignments = sharding.sharded_sweep_blocked(
            spec, py, shareds, state, values, assignments, sub, mesh,
            block=4)
    distributed.sync((state, assignments))

    import sys as _sys

    def _mark(msg):
        print('[worker %d] %s' % (jax.process_index(), msg), flush=True)

    ckpt = out_path + '.orbax'
    _mark('save start')
    checkpoint_orbax.save_sharded(ckpt, state, assignments=assignments,
                                  key=key, sweep=2,
                                  logger_rows=[[2, 0.0]])
    _mark('save done, load start')
    state_r, an_r, key_r, sweep_r, rows_r = checkpoint_orbax.load_sharded(
        ckpt, spec, shareds, mesh=mesh, n_rows=R)
    _mark('load done')
    assert sweep_r == 2 and rows_r == [[2, 0.0]]
    # restored arrays equal the live ones (each process checks its shards)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(state_r)):
        np.testing.assert_array_equal(_local(a), _local(b))
    np.testing.assert_array_equal(_local(assignments), _local(an_r))

    # continue 2 sweeps from live and from restored: bitwise equal
    def continue_sweeps(st, an, k):
        for _ in range(2):
            k, sub = jax.random.split(k)
            st, an = sharding.sharded_sweep_blocked(
                spec, py, shareds, st, values, an, sub, mesh, block=4)
        return st, an

    state_a, an_a = continue_sweeps(state, assignments, key)
    state_b, an_b = continue_sweeps(state_r, an_r, key_r)
    distributed.sync((state_a, an_a, state_b, an_b))
    np.testing.assert_array_equal(_local(an_a), _local(an_b))
    np.testing.assert_array_equal(_local(state_a.counts),
                                  _local(state_b.counts))

    an = distributed.gather_rows(an_b)
    if pid == 0:
        np.savez(out_path, an=an, counts=_local(state_b.counts))


if __name__ == '__main__':
    {'sweep': mode_sweep, 'runner': mode_runner, '2d': mode_2d,
     'orbax': mode_orbax}[mode]()
    jax.distributed.shutdown()
