"""Common machinery for conjugate component models.

Model module contract (the JAX analog of the reference's feature-model
API, reference doc/overview.rst:37-157):

Every model module (bb, dd, dpd, gp, bnb, nich, niw) exports:

- ``NAME``     — reference model name
- ``EXAMPLES`` — self-describing fixtures consumed by the generic test
                 harness (reference doc/overview.rst:145-157)
- ``Value``    — python-level value type

- ``Shared``   — NamedTuple pytree of hyperparameters (and, for dynamic-
                 support models, shared sufficient statistics)
- ``Group``    — NamedTuple pytree of per-component sufficient statistics.
                 All Group fields carry an arbitrary (usually ``[K]``) batch
                 shape; every function below broadcasts over it.

- ``shared_from_dict / shared_to_dict`` — JSON-dict (de)serialization,
  schema-compatible with the reference's ``load``/``dump``
- ``group_from_dict / group_to_dict``
- ``group_init(shared, shape=()) -> Group`` — empty group(s)
- ``add_value(shared, group, value) -> Group``
- ``add_repeated_value(shared, group, value, count) -> Group``
- ``remove_value(shared, group, value) -> Group``
- ``merge(shared, destin, source) -> Group``
- ``score_value(shared, group, value) -> f32`` — posterior predictive
  log-density; broadcasts group [K] against scalar value to give [K]
- ``score_data(shared, group) -> f32`` — marginal likelihood of the group
- ``sample_value(key, shared, group) -> value``
- ``sample_group(key, shared, size) -> values`` — draw group params once,
  then iid values
- ``from_values_grouped(shared, values, assignments, num_groups) -> Group[K]``
  — batched suff-stat construction via segment_sum (the batched replacement
  for per-row add_value loops); with ``num_groups=1`` this subsumes
  ``Group.from_values``

Models with a conjugate posterior additionally export
``plus_group(shared, group) -> Shared`` (reference overview.rst:86).
"""

import jax
import jax.numpy as jnp


def group_take(group, idx):
    """Select the group at (batched) index `idx` from a [K]-batched Group."""
    return jax.tree_util.tree_map(lambda a: a[idx], group)


def group_set(group, idx, sub):
    """Write a single group's stats back into slot `idx`."""
    return jax.tree_util.tree_map(
        lambda a, s: a.at[idx].set(jnp.asarray(s, a.dtype)), group, sub)


def group_stack(groups):
    """Stack a python list of scalar Groups into a [K]-batched Group."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *groups)


def exact_onehot_matmul(onehot_t, flat):
    """onehot_t [K, B] (exact 0/1) @ flat [B, S] f32 -> [K, S] with f32
    round-to-nearest accumulation, on every backend.

    A default-precision f32 matmul may round its operands (TF32 keeps 10
    mantissa bits on the GPU), and a bf16 tensor-core product of a
    hi/mid/lo split of `flat`, exact per product, still lost ~2e-4 of the
    largest slot sums on the H100 (gp log-factorial sums of ~2,000 rows
    per slot; see PERF.md) where the CPU's f32 sums kept ~2e-7.  These
    sums are added and subtracted across tiles and sweeps, so the
    contraction asks for full f32 (Precision.HIGHEST).
    """
    return jnp.matmul(jnp.asarray(onehot_t, jnp.float32),
                      jnp.asarray(flat, jnp.float32),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


# Largest [K, B] one-hot materialized in one piece; beyond this the
# contraction runs as a scan over row chunks (a [8192, 1e6] one-hot is
# 8G as bf16 — whole-dataset segment sums at large capacity run out of
# device memory)
ONEHOT_CHUNK_LIMIT = 1 << 28


def segment_sum(data, segment_ids, num_segments):
    """Segment sum as a one-hot matmul.

    XLA lowers `jax.ops.segment_sum` to a scatter-add, whose float
    accumulation order is not fixed from run to run on the GPU (atomics),
    which would break bitwise resume; a [B, K] one-hot contraction is a
    deterministic matrix product, with full-f32 accumulation through
    `exact_onehot_matmul`.  Out-of-range segment ids drop,
    matching scatter's mode='drop'.  When the [K, B] one-hot would
    exceed ONEHOT_CHUNK_LIMIT elements the contraction scans over row
    chunks, so whole-dataset sums scale to large capacities without an
    HBM cliff.
    """
    data = jnp.asarray(data)
    segment_ids = jnp.asarray(segment_ids)
    out_dtype = data.dtype
    B = data.shape[0]
    flat = data.astype(jnp.float32).reshape(B, -1)

    def contract(ids, f):
        onehot_t = (jnp.arange(num_segments, dtype=ids.dtype)[:, None]
                    == ids[None, :])                         # [K, b]
        return exact_onehot_matmul(onehot_t, f)

    if B * num_segments <= ONEHOT_CHUNK_LIMIT:
        acc = contract(segment_ids, flat)
    else:
        # ceil-div chunking: chunk*K <= limit HOLDS for every B/K (a
        # halve-while-even scheme silently kept oversized chunks for
        # odd B — r5 self-review)
        chunk = max(1, ONEHOT_CHUNK_LIMIT // num_segments)
        n = B // chunk
        rem = B - n * chunk

        def body(carry, xs):
            ids_c, f_c = xs
            return carry + contract(ids_c, f_c), None

        acc, _ = jax.lax.scan(
            body,
            jnp.zeros((num_segments, flat.shape[1]), jnp.float32),
            (segment_ids[:n * chunk].reshape(n, chunk),
             flat[:n * chunk].reshape(n, chunk, -1)))
        if rem:   # tail when chunk does not divide B
            acc = acc + contract(segment_ids[n * chunk:],
                                 flat[n * chunk:])

    acc = acc.reshape((num_segments,) + data.shape[1:])
    if jnp.issubdtype(out_dtype, jnp.integer):
        acc = jnp.round(acc)
    return acc.astype(out_dtype)


def generic_sample_group(sampler_init, sampler_eval, key, shared, size):
    """Draw per-group parameters once, then `size` iid values (the
    `Model.sample_group` contract, e.g. reference dbg/models/gp.py:156-161)."""
    k1, k2 = jax.random.split(key)
    params = sampler_init(k1, shared)
    return sampler_eval(k2, shared, params, (size,))
