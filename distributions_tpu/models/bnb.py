"""Beta-Negative-Binomial conjugate model.

Semantics match the reference (dbg/models/bnb.py:28-177,
include/distributions/models/bnb.hpp): Value=int (# failures before the r-th
success), Shared={alpha, beta, r}, Group={count, sum}; the predictive follows
Cook, "Notes on the negative binomial distribution" (2009).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from distributions_tpu.special import gammaln
from distributions_tpu.random import sample_beta, sample_negative_binomial
from distributions_tpu.models import base

NAME = 'BetaNegativeBinomial'
EXAMPLES = [
    {
        'shared': {'alpha': 1., 'beta': 1., 'r': 1},
        'values': [0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 2, 3],
    },
]
Value = int


class Shared(NamedTuple):
    alpha: jnp.ndarray
    beta: jnp.ndarray
    r: jnp.ndarray  # int32


class Group(NamedTuple):
    count: jnp.ndarray  # int32
    sum: jnp.ndarray    # int32


def shared_from_dict(raw):
    return Shared(alpha=jnp.float32(raw['alpha']),
                  beta=jnp.float32(raw['beta']), r=jnp.int32(raw['r']))


def shared_to_dict(shared):
    return {'alpha': float(shared.alpha), 'beta': float(shared.beta),
            'r': int(shared.r)}


def group_from_dict(raw):
    return Group(count=jnp.int32(raw['count']), sum=jnp.int32(raw['sum']))


def group_to_dict(group):
    return {'count': int(group.count), 'sum': int(group.sum)}


def group_init(shared, shape=()):
    return Group(count=jnp.zeros(shape, jnp.int32),
                 sum=jnp.zeros(shape, jnp.int32))


def plus_group(shared, group):
    """reference dbg/models/bnb.py:65-70."""
    return Shared(alpha=shared.alpha + shared.r * group.count,
                  beta=shared.beta + group.sum, r=shared.r)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    value = jnp.asarray(value, jnp.int32)
    count = jnp.asarray(count, jnp.int32)
    return Group(count=group.count + count, sum=group.sum + count * value)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum)


def unmerge(shared, destin, source):
    return Group(count=destin.count - source.count,
                 sum=destin.sum - source.sum)


def score_value(shared, group, value):
    """reference dbg/models/bnb.py:121-129."""
    value = jnp.asarray(value, jnp.float32)
    post = plus_group(shared, group)
    pa = post.alpha.astype(jnp.float32)
    pb = post.beta.astype(jnp.float32)
    alpha = pa + shared.r
    beta = pb + value
    return (gammaln(pa + pb) - gammaln(alpha + beta)
            + gammaln(alpha) - gammaln(pa)
            + gammaln(beta) - gammaln(pb))


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K] (cached-coefficient layout of
    reference bnb.hpp:305-326):

        lgamma(a+b) + lgamma(a+r) - lgamma(a) - lgamma(b)
          + lgamma(b+v) - lgamma(a+b+r+v)
        = lgamma_ratio(a, r) + lgamma_ratio(b, v) - lgamma_ratio(a+b, r+v)

    for the posterior (a, b): each term stays O((r + v) log(a + b)), so no
    large-count cancellation remains."""
    from distributions_tpu.special import lgamma_ratio
    post = plus_group(shared, group)
    pa = post.alpha.astype(jnp.float32)  # [K]
    pb = post.beta.astype(jnp.float32)   # [K]
    r = jnp.asarray(shared.r, jnp.float32)
    const = lgamma_ratio(pa, r)                     # [K]
    v = jnp.asarray(values, jnp.float32)[:, None]   # [B, 1]
    return (const[None, :] + lgamma_ratio(pb[None, :], v)
            - lgamma_ratio((pa + pb)[None, :], r + v))


def score_data(shared, group):
    """reference dbg/models/bnb.py:131-137.

    Differences go through special.lgamma_ratio with the increments
    built from RAW group stats (r*count, sum) — reconstructing them as
    post - prior absorbs to 0 in f32 once the prior >> the increment,
    recreating the flat plateau the fix removes (r5 self-review)."""
    from distributions_tpu.special import lgamma_ratio
    a0 = jnp.asarray(shared.alpha, jnp.float32)
    b0 = jnp.asarray(shared.beta, jnp.float32)
    ya = jnp.asarray(shared.r, jnp.float32) \
        * jnp.asarray(group.count, jnp.float32)
    yb = jnp.asarray(group.sum, jnp.float32)
    return (lgamma_ratio(a0, ya) + lgamma_ratio(b0, yb)
            - lgamma_ratio(a0 + b0, ya + yb))


def sampler_init(key, shared, group=None):
    post = shared if group is None else plus_group(shared, group)
    return sample_beta(key, post.alpha.astype(jnp.float32),
                       post.beta.astype(jnp.float32))


def sampler_eval(key, shared, p, shape=()):
    return sample_negative_binomial(key, p, shared.r, shape)


def sample_value(key, shared, group):
    k1, k2 = jax.random.split(key)
    p = sampler_init(k1, shared, group)
    return sampler_eval(k2, shared, p)


def sample_group(key, shared, size):
    return base.generic_sample_group(
        sampler_init, sampler_eval, key, shared, size)


def from_values_grouped(shared, values, assignments, num_groups):
    v = jnp.asarray(values, jnp.int32)
    return Group(
        count=base.segment_sum(jnp.ones(v.shape, jnp.int32),
                               assignments, num_groups),
        sum=base.segment_sum(v, assignments, num_groups))


# -- row-stat columns (single-matmul tile aggregation; see mixture.py) ------

ROW_STAT_DIM = 2


def row_stat_columns(shared, values):
    v = jnp.asarray(values, jnp.float32)
    return jnp.stack([jnp.ones_like(v), v], axis=-1)


def row_stats_to_tile(shared, sums):
    return Group(count=jnp.round(sums[..., 0]).astype(jnp.int32),
                 sum=jnp.round(sums[..., 1]).astype(jnp.int32))


# -- uncollapsed parameter-space API (HMC/NUTS/VI backends) -----------------
# params = {'logit_p': [..]}; p ~ Beta(alpha, beta), NB(r, p) likelihood.

def param_init(key, shared, shape=()):
    mean = shared.alpha / (shared.alpha + shared.beta)
    return {'logit_p': jnp.log(mean / (1 - mean))
            + 0.1 * jax.random.normal(key, shape)}


def param_log_prior(shared, params):
    z = params['logit_p']
    log_p = jax.nn.log_sigmoid(z)
    log_1mp = jax.nn.log_sigmoid(-z)
    beta_norm = (gammaln(shared.alpha + shared.beta)
                 - gammaln(shared.alpha) - gammaln(shared.beta))
    return (beta_norm + (shared.alpha - 1.0) * log_p
            + (shared.beta - 1.0) * log_1mp + log_p + log_1mp)


def param_log_likelihood(shared, params, value):
    """log NB(x | r, p) with the reference's un-normalized density
    p^r (1-p)^x (reference dbg/models/bnb.py:28-41) plus the binomial
    coefficient for a proper pmf."""
    z = params['logit_p']
    v = jnp.asarray(value, jnp.float32)
    r = jnp.asarray(shared.r, jnp.float32)
    return (gammaln(v + r) - gammaln(r) - gammaln(v + 1.0)
            + r * jax.nn.log_sigmoid(z) + v * jax.nn.log_sigmoid(-z))


def param_constrain(shared, params):
    return {'p': jax.nn.sigmoid(params['logit_p'])}
