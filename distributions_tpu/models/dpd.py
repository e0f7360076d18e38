"""Dirichlet-Process-Discrete model: a stick-breaking DP over an open,
growing set of integer values.

Semantics match the reference (dbg/models/dpd.py:28-290,
include/distributions/models/dpd.hpp): Shared={gamma, alpha, beta0,
betas, counts} where the *Shared mutates during inference* — on first sight
of a value a new stick beta ~ beta0 * Beta(1, gamma) is broken off
(dpd.hpp:59-101); Group is a sparse counter.

Dense device layout
-------------------
The reference's sparse hash maps (SparseCounter, dpd.hpp:155-272) become a
fixed-capacity dense value table of static size V:

- ``Shared.values[V]`` — the raw integer ids present (padding = -1)
- ``Shared.betas[V]``, ``Shared.counts[V]`` — stick masses / shared counts
- ``Group.counts[..., V]`` — dense per-group counts (any [K] batch shape)

Raw values are looked up by equality-scan (one [V] vector compare — V is
small and the compare fuses into the score kernel).  The reference's
``OTHER = 0xFFFFFFFF`` sentinel for unseen values is ``OTHER = -1`` here
(the same bit pattern as int32).  Shared mutation is functional:
``shared_add_value`` takes and consumes a PRNG key and returns a new Shared.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from distributions_tpu.special import gammaln
from distributions_tpu.random import (
    sample_beta, sample_dirichlet, sample_discrete)
from distributions_tpu.models import base

NAME = 'DirichletProcessDiscrete'
OTHER = -1  # reference dbg/models/dpd.py:70 uses 0xFFFFFFFF == int32(-1)
DEFAULT_CAPACITY = 64
MIN_BETA0 = 1e-4      # reference dbg/models/dpd.py:157
REALIZE_MAX = 10000   # reference dbg/models/dpd.py:156

EXAMPLES = [
    {
        'shared': {
            'gamma': 0.5,
            'alpha': 0.5,
            'betas': {0: 0.25, 7: 0.5, 8: 0.25},
            'counts': {0: 1, 7: 2, 8: 4},
        },
        'values': [0, 7, 0, 8, 0, 7, 0],
    },
    {
        'shared': {
            'gamma': 2.0,
            'alpha': 2.0,
            'betas': {},
            'counts': {},
        },
        'values': [5, 4, 3, 2, 1, 0, 3, 2, 1],
    },
]
Value = int


class Shared(NamedTuple):
    gamma: jnp.ndarray
    alpha: jnp.ndarray
    beta0: jnp.ndarray
    values: jnp.ndarray  # [V] int32, padding -1
    betas: jnp.ndarray   # [V] float32
    counts: jnp.ndarray  # [V] int32


class Group(NamedTuple):
    counts: jnp.ndarray  # [..., V] int32
    total: jnp.ndarray   # [...] int32


def capacity(shared):
    return shared.values.shape[-1]


def active_mask(shared):
    return (shared.counts > 0) | (shared.betas > 0)


# -- serialization ----------------------------------------------------------

def shared_from_dict(raw, cap=DEFAULT_CAPACITY):
    betas = raw['betas']
    counts = raw.get('counts', {})
    assert len(betas) < cap, 'dpd capacity too small'
    vals = np.full(cap, -1, np.int32)
    bs = np.zeros(cap, np.float32)
    cs = np.zeros(cap, np.int32)
    for i, (v, b) in enumerate(sorted(betas.items())):
        vals[i] = int(v)
        bs[i] = float(b)
        cs[i] = int(counts.get(v, counts.get(str(v), 0)))
    beta0 = max(0.0, 1.0 - float(bs.sum()))
    if not beta0 <= 1.0:
        raise ValueError('beta0 out of bounds: {}'.format(beta0))
    if len(betas) and not (bs.min() >= 0.0 and bs.max() <= 1.0):
        raise ValueError('betas out of bounds')
    return Shared(gamma=jnp.float32(raw['gamma']),
                  alpha=jnp.float32(raw['alpha']),
                  beta0=jnp.float32(beta0),
                  values=jnp.asarray(vals), betas=jnp.asarray(bs),
                  counts=jnp.asarray(cs))


def shared_to_dict(shared):
    vals = np.asarray(shared.values)
    bs = np.asarray(shared.betas, np.float64)
    cs = np.asarray(shared.counts)
    act = np.asarray(active_mask(shared))
    return {
        'gamma': float(shared.gamma),
        'alpha': float(shared.alpha),
        'betas': {int(v): float(b) for v, b, a in zip(vals, bs, act) if a},
        'counts': {int(v): int(c) for v, c, a in zip(vals, cs, act) if a},
    }


def shared_to_state_dict(shared):
    """Slot-order-preserving serialization (checkpoint path): group count
    tables are slot-aligned [.., V] arrays, so the sorted/compacted
    `shared_to_dict` form is NOT safe to restore against saved groups —
    this form round-trips the dense table verbatim."""
    return {
        'gamma': float(shared.gamma),
        'alpha': float(shared.alpha),
        'beta0': float(shared.beta0),
        'slot_values': [int(v) for v in np.asarray(shared.values)],
        'slot_betas': [float(b) for b in np.asarray(shared.betas)],
        'slot_counts': [int(c) for c in np.asarray(shared.counts)],
    }


def shared_from_state_dict(raw):
    return Shared(
        gamma=jnp.float32(raw['gamma']),
        alpha=jnp.float32(raw['alpha']),
        beta0=jnp.float32(raw['beta0']),
        values=jnp.asarray(raw['slot_values'], jnp.int32),
        betas=jnp.asarray(raw['slot_betas'], jnp.float32),
        counts=jnp.asarray(raw['slot_counts'], jnp.int32))


def group_from_dict(raw, shared):
    counts = jnp.zeros(capacity(shared), jnp.int32)
    total = 0
    for v, c in raw['counts'].items():
        if c:
            slot = int(np.argmax(np.asarray(shared.values) == int(v)))
            assert int(shared.values[slot]) == int(v), 'unknown value'
            counts = counts.at[slot].set(int(c))
            total += int(c)
    return Group(counts=counts, total=jnp.int32(total))


def group_to_dict(group, shared):
    vals = np.asarray(shared.values)
    cs = np.asarray(group.counts)
    return {'counts': {int(v): int(c)
                       for v, c in zip(vals, cs) if c != 0}}


def group_init(shared, shape=()):
    return Group(counts=jnp.zeros(shape + (capacity(shared),), jnp.int32),
                 total=jnp.zeros(shape, jnp.int32))


# -- value lookup -----------------------------------------------------------

def value_to_slot(shared, value):
    """Map raw value(s) -> dense slot index; capacity V for unknown/OTHER
    (out-of-range indices drop in scatters and fill in gathers)."""
    value = jnp.asarray(value, jnp.int32)
    eq = shared.values == value[..., None]        # [..., V]
    found = jnp.any(eq, axis=-1) & (value != OTHER)
    slot = jnp.argmax(eq, axis=-1)
    return jnp.where(found, slot, capacity(shared))


# -- Shared mutation (functional; reference dbg/models/dpd.py:137-165) ------

def shared_add_value(key, shared, value):
    """Observe one instance of `value`: on first sight, break a new stick
    beta = beta0 * Beta(1, gamma) (consumes the key)."""
    value = jnp.asarray(value, jnp.int32)
    slot = value_to_slot(shared, value)
    found = slot < capacity(shared)
    free = jnp.argmin(active_mask(shared))  # first inactive slot
    target = jnp.where(found, slot, free)
    frac = sample_beta(key, 1.0, shared.gamma)
    new_beta = shared.beta0 * frac
    return Shared(
        gamma=shared.gamma, alpha=shared.alpha,
        beta0=jnp.where(found, shared.beta0,
                        jnp.maximum(0.0, shared.beta0 - new_beta)),
        values=shared.values.at[target].set(value),
        betas=shared.betas.at[target].set(
            jnp.where(found, shared.betas[target], new_beta)),
        counts=shared.counts.at[target].add(1))


def shared_remove_value(key, shared, value):
    """Un-observe one instance; when a value's shared count hits zero its
    stick mass returns to beta0 (reference dbg/models/dpd.py:146-153)."""
    value = jnp.asarray(value, jnp.int32)
    slot = value_to_slot(shared, value)
    count = shared.counts[slot] - 1
    dead = count == 0
    return Shared(
        gamma=shared.gamma, alpha=shared.alpha,
        beta0=jnp.where(dead, shared.beta0 + shared.betas[slot],
                        shared.beta0),
        values=shared.values.at[slot].set(
            jnp.where(dead, -1, shared.values[slot])),
        betas=shared.betas.at[slot].set(
            jnp.where(dead, 0.0, shared.betas[slot])),
        counts=shared.counts.at[slot].set(count))


def shared_realize(key, shared):
    """Materialize sticks until beta0 is exhausted or capacity is reached
    (reference dbg/models/dpd.py:155-165, dpd.hpp:83-101).  Host-side loop —
    realize is setup, not a hot path."""
    cap = capacity(shared)
    n_active = int(np.sum(np.asarray(active_mask(shared))))
    vals = np.asarray(shared.values)
    new_value = int(vals.max()) + 1 if n_active else 0
    while n_active < cap - 1 and float(shared.beta0) > MIN_BETA0:
        key, sub = jax.random.split(key)
        shared = shared_add_value(sub, shared, new_value)
        new_value += 1
        n_active += 1
    if float(shared.beta0) > 0 and n_active < cap:
        key, sub = jax.random.split(key)
        shared = shared_add_value(sub, shared, new_value)
        slot = int(np.argmax(np.asarray(shared.values) == new_value))
        shared = shared._replace(
            betas=shared.betas.at[slot].add(shared.beta0),
            beta0=jnp.float32(0.0))
    return shared


# -- Group ops --------------------------------------------------------------

def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    slot = value_to_slot(shared, value)
    count = jnp.asarray(count, jnp.int32)
    return Group(counts=group.counts.at[..., slot].add(count, mode='drop'),
                 total=group.total + count)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(counts=destin.counts + source.counts,
                 total=destin.total + source.total)


def unmerge(shared, destin, source):
    return Group(counts=destin.counts - source.counts,
                 total=destin.total - source.total)


def score_value(shared, group, value):
    """reference dbg/models/dpd.py:197-209: log((beta_v*alpha + n_v) / (alpha
    + total)); OTHER scores the unbroken mass beta0*alpha.  Unknown non-OTHER
    values score -inf."""
    value = jnp.asarray(value, jnp.int32)
    slot = value_to_slot(shared, value)
    beta = shared.betas.at[slot].get(mode='fill', fill_value=0.0)
    cnt = jnp.take_along_axis(
        group.counts,
        jnp.broadcast_to(slot, group.counts.shape[:-1])[..., None],
        axis=-1, mode='fill', fill_value=0)[..., 0].astype(jnp.float32)
    numer = jnp.where(value == OTHER,
                      shared.beta0 * shared.alpha,
                      beta * shared.alpha + cnt)
    denom = shared.alpha + group.total.astype(jnp.float32)
    return jnp.log(numer) - jnp.log(denom)


def score_value_batch(shared, group, values):
    """[K, V] groups x [B] raw values -> [B, K]."""
    values = jnp.asarray(values, jnp.int32)
    slots = value_to_slot(shared, values)                     # [B]
    beta = shared.betas.at[slots].get(
        mode='fill', fill_value=0.0)                          # [B]
    cnt = group.counts.at[..., slots].get(
        mode='fill', fill_value=0).astype(jnp.float32)        # [K, B]
    numer = jnp.where(values[None, :] == OTHER,
                      shared.beta0 * shared.alpha,
                      beta[None, :] * shared.alpha + cnt)     # [K, B]
    denom = shared.alpha + group.total.astype(jnp.float32)    # [K]
    return (jnp.log(numer) - jnp.log(denom)[:, None]).T


def score_data(shared, group):
    """doc/dpd.pdf Eq. (3) (reference dbg/models/dpd.py:211-222)."""
    prior = shared.betas * shared.alpha                        # [V]
    cnt = group.counts.astype(jnp.float32)                    # [..., V]
    terms = jnp.where(group.counts != 0,
                      gammaln(prior + cnt) - gammaln(prior), 0.0)
    return (jnp.sum(terms, axis=-1)
            + gammaln(shared.alpha)
            - gammaln(shared.alpha + group.total.astype(jnp.float32)))


# -- sampling ---------------------------------------------------------------

def sampler_init(key, shared, group=None):
    """Dirichlet over active slots + the OTHER remainder (reference
    dbg/models/dpd.py:266-278)."""
    act = active_mask(shared)
    cnt = (jnp.zeros(capacity(shared), jnp.float32) if group is None
           else group.counts.astype(jnp.float32))
    post = jnp.where(act, shared.betas * shared.alpha + cnt, 0.0)
    post = jnp.concatenate([post, (shared.beta0 * shared.alpha)[None]])
    return sample_dirichlet(key, post)


def sampler_eval(key, shared, probs, shape=()):
    idx = sample_discrete(key, probs, shape=shape if shape else None)
    vals = jnp.concatenate(
        [shared.values, jnp.asarray([OTHER], jnp.int32)])
    return vals[idx]


def sample_value(key, shared, group):
    k1, k2 = jax.random.split(key)
    probs = sampler_init(k1, shared, group)
    return sampler_eval(k2, shared, probs)


def sample_group(key, shared, size):
    return base.generic_sample_group(
        sampler_init, sampler_eval, key, shared, size)


def from_values_grouped(shared, values, assignments, num_groups):
    slots = value_to_slot(shared, values)                     # [B]
    cap = capacity(shared)
    onehot = (jnp.arange(cap, dtype=jnp.int32)[None, :]
              == slots[:, None]).astype(jnp.int32)            # [B, V]
    return Group(
        counts=base.segment_sum(onehot, assignments, num_groups),
        total=base.segment_sum(jnp.ones(slots.shape, jnp.int32),
                               assignments, num_groups))


# -- row-stat columns (single-matmul tile aggregation; see mixture.py) ------

def row_stat_dim(shared):
    return capacity(shared) + 1


def row_stat_columns(shared, values):
    slots = value_to_slot(shared, values)                 # [...]
    cap = capacity(shared)
    onehot = (jnp.arange(cap, dtype=jnp.int32)
              == slots[..., None]).astype(jnp.float32)
    ones = jnp.ones(slots.shape + (1,), jnp.float32)
    return jnp.concatenate([onehot, ones], axis=-1)


def row_stats_to_tile(shared, sums):
    return Group(counts=jnp.round(sums[..., :-1]).astype(jnp.int32),
                 total=jnp.round(sums[..., -1]).astype(jnp.int32))
