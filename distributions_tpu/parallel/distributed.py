"""Multi-host execution: process groups, DCN-aware global meshes, and
per-host data loading.

The reference is a single-process library (reference SURVEY §2.4 — no
NCCL/MPI/anything); this module is the multi-host scaling layer it never
had: `jax.distributed.initialize` for the process group, a global mesh
whose 'rows' (data) axis spans hosts — so row-tile suff-stat psums ride
the fast links within a host and the network across hosts — and
`jax.make_array_from_process_local_data` for loading each host's row
shard without ever materializing the global dataset on one host.

Reproducibility: the sweeps' per-row keys fold in GLOBAL row indices
(parallel/sharding.py), so an N-device run produces the same draws
whether the N devices live in one process or many.  This is validated by
tests/test_multiprocess.py, which launches real multi-process CPU groups
(gloo collectives) and pins equality against the single-process sweep.
"""

import os
from functools import partial

import numpy as np
import jax

from distributions_tpu.parallel import sharding as _sharding

ROWS = _sharding.ROWS
COMPONENTS = 'components'


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Join (or create) the multi-host process group.

    Pass coordinator_address (`host:port`), num_processes and process_id
    explicitly (GPU hosts and CPU process groups alike); gloo cross-process collectives are selected
    automatically when the platform is CPU.
    """
    if jax.config.jax_platforms and 'cpu' in jax.config.jax_platforms:
        jax.config.update('jax_cpu_collectives_implementation', 'gloo')
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)


def process_count():
    return jax.process_count()


def process_index():
    return jax.process_index()


def is_multiprocess():
    return jax.process_count() > 1


def make_global_mesh(axis_name=ROWS):
    """1-D global mesh over every device of every process, 'rows'-named:
    the data-parallel axis. Device order is (process, local device), so
    each process owns a contiguous row range."""
    return _sharding.make_mesh(jax.devices(), axis_name)


def make_global_mesh_2d(components_per_host=None):
    """2-D ('rows' x 'components') global mesh: components sharded over
    the devices WITHIN each host (collectives on the component axis —
    score-max reductions per tile — stay on the host's own links), rows
    over hosts (the network carries only the per-tile suff-stat psums)."""
    n_local = jax.local_device_count()
    n_comp = components_per_host or n_local
    assert n_local % n_comp == 0, (n_local, n_comp)
    devices = np.asarray(jax.devices()).reshape(-1, n_comp)
    from jax.sharding import Mesh
    return Mesh(devices, (ROWS, COMPONENTS))


def host_row_slice(n_rows, mesh=None):
    """The contiguous [start, stop) global-row range this process owns
    under a 'rows'-sharded layout — what a per-host data loader should
    read.  n_rows must divide evenly over processes."""
    n_proc = jax.process_count()
    assert n_rows % n_proc == 0, (n_rows, n_proc)
    per = n_rows // n_proc
    start = jax.process_index() * per
    return start, start + per


def global_rows_from_host_data(local_values, n_rows, mesh, axis_name=ROWS):
    """Assemble global row-sharded arrays from each host's local row
    shard (loaded via host_row_slice) without gathering: every leaf
    becomes a jax.Array sharded P('rows') over `mesh`, whose addressable
    shards hold exactly this host's data.

    local_values: tuple of [local_R, ...] numpy/jax arrays.
    Returns a tuple of global [n_rows, ...] arrays.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    shard = NamedSharding(mesh, P(axis_name))
    out = []
    for v in local_values:
        v = np.asarray(v)
        global_shape = (n_rows,) + v.shape[1:]
        out.append(jax.make_array_from_process_local_data(
            shard, v, global_shape))
    return tuple(out)


def replicate(tree, mesh):
    """Replicate a host-local pytree (state, keys) onto every device of
    the global mesh — required before shard_map'd sweeps in multi-process
    mode, where committed global arrays must carry explicit shardings."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(
            rep, np.asarray(a), np.asarray(a).shape), tree)


def gather_rows(array):
    """Host-gather a 'rows'-sharded global array to a numpy array on every
    process (checkpointing, diagnostics).  No-op for fully-addressable
    arrays."""
    if getattr(array, 'is_fully_addressable', True):
        return np.asarray(array)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        array, tiled=True))


def sync(tree):
    """Barrier on computation results that works for global arrays
    (np.asarray requires full addressability)."""
    jax.block_until_ready(tree)
    return tree
