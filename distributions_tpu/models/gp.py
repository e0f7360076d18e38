"""Gamma-Poisson conjugate model.

Semantics match the reference (dbg/models/gp.py:33-161,
include/distributions/models/gp.hpp): Value=int, Shared={alpha, inv_beta},
Group={count, sum, log_prod} with log_prod = sum_i log(y_i!).

The reference's vectorized ValueScorer (src/models/gp.cc:32-68) caches
per-group {score, post_alpha, score_coeff}; here the batched formula is a
single fused XLA graph over the [K] axis.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from distributions_tpu.special import gammaln, log_factorial
from distributions_tpu.random import sample_gamma, sample_poisson
from distributions_tpu.models import base

NAME = 'GammaPoisson'
EXAMPLES = [
    {
        'shared': {'alpha': 1., 'inv_beta': 1.},
        'values': [0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 2, 3],
    },
]
Value = int


class Shared(NamedTuple):
    alpha: jnp.ndarray
    inv_beta: jnp.ndarray


class Group(NamedTuple):
    count: jnp.ndarray     # int32
    sum: jnp.ndarray       # int32
    log_prod: jnp.ndarray  # float32


def shared_from_dict(raw):
    return Shared(alpha=jnp.float32(raw['alpha']),
                  inv_beta=jnp.float32(raw['inv_beta']))


def shared_to_dict(shared):
    return {'alpha': float(shared.alpha), 'inv_beta': float(shared.inv_beta)}


def group_from_dict(raw):
    return Group(count=jnp.int32(raw['count']), sum=jnp.int32(raw['sum']),
                 log_prod=jnp.float32(raw['log_prod']))


def group_to_dict(group):
    return {'count': int(group.count), 'sum': int(group.sum),
            'log_prod': float(group.log_prod)}


def group_init(shared, shape=()):
    return Group(count=jnp.zeros(shape, jnp.int32),
                 sum=jnp.zeros(shape, jnp.int32),
                 log_prod=jnp.zeros(shape, jnp.float32))


def plus_group(shared, group):
    """Conjugate posterior update (reference dbg/models/gp.py:48-52)."""
    return Shared(alpha=shared.alpha + group.sum,
                  inv_beta=shared.inv_beta + group.count)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    value = jnp.asarray(value, jnp.int32)
    count = jnp.asarray(count, jnp.int32)
    return Group(
        count=group.count + count,
        sum=group.sum + count * value,
        log_prod=group.log_prod + count.astype(jnp.float32)
        * log_factorial(value))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum,
                 log_prod=destin.log_prod + source.log_prod)


def unmerge(shared, destin, source):
    return Group(count=destin.count - source.count,
                 sum=destin.sum - source.sum,
                 log_prod=destin.log_prod - source.log_prod)


def score_value(shared, group, value):
    """Negative-binomial posterior predictive (reference
    dbg/models/gp.py:105-110)."""
    value = jnp.asarray(value, jnp.float32)
    post = plus_group(shared, group)
    alpha = post.alpha.astype(jnp.float32)
    inv_beta = post.inv_beta.astype(jnp.float32)
    return (gammaln(alpha + value) - gammaln(alpha)
            + alpha * jnp.log(inv_beta)
            - (alpha + value) * jnp.log(1.0 + inv_beta)
            - log_factorial(value))


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K]; the cached-coefficient trick of
    reference src/models/gp.cc:32-68 expressed as broadcasting: score(y, k) =
    lgamma_ratio(alpha_k, y) + coeff_k * y + const_k - log y!.

    Both large-count cancellations are avoided: lgamma(alpha + y) -
    lgamma(alpha) goes through special.lgamma_ratio, and
    alpha * (log(b) - log1p(b)) is computed as -alpha * log1p(1/b)."""
    from distributions_tpu.special import lgamma_ratio
    post = plus_group(shared, group)
    alpha = post.alpha.astype(jnp.float32)          # [K]
    inv_beta = post.inv_beta.astype(jnp.float32)    # [K]
    const = -alpha * jnp.log1p(1.0 / inv_beta)      # [K]
    coeff = -jnp.log1p(inv_beta)                    # [K]
    y = jnp.asarray(values, jnp.float32)[:, None]   # [B, 1]
    return (lgamma_ratio(alpha[None, :], y) + coeff[None, :] * y
            + const[None, :] - log_factorial(y))


def score_data(shared, group):
    """Marginal likelihood (reference dbg/models/gp.py:112-117).

    gammaln(post) - gammaln(prior) goes through special.lgamma_ratio
    with the RAW group count sum as the increment — reconstructing it as
    post.alpha - shared.alpha would absorb to 0 in f32 once
    shared.alpha >> sum (ulp(1e9) = 64), recreating the flat plateau the
    cancellation fix exists to remove (r5 self-review)."""
    from distributions_tpu.special import lgamma_ratio
    a0 = jnp.asarray(shared.alpha, jnp.float32)
    ib0 = jnp.asarray(shared.inv_beta, jnp.float32)
    S = jnp.asarray(group.sum, jnp.float32)
    cnt = jnp.asarray(group.count, jnp.float32)
    # -(a0+S) log(ib0+cnt) + a0 log(ib0), differenced symbolically:
    # the direct form cancels two ~a0*log(ib) magnitudes
    return (lgamma_ratio(a0, S)
            - a0 * jnp.log1p(cnt / ib0)
            - S * jnp.log(ib0 + cnt)
            - group.log_prod)


def sampler_init(key, shared, group=None):
    post = shared if group is None else plus_group(shared, group)
    return sample_gamma(key, post.alpha.astype(jnp.float32),
                        1.0 / post.inv_beta.astype(jnp.float32))


def sampler_eval(key, shared, lam, shape=()):
    return sample_poisson(key, lam, shape)


def sample_value(key, shared, group):
    k1, k2 = jax.random.split(key)
    lam = sampler_init(k1, shared, group)
    return sampler_eval(k2, shared, lam)


def sample_group(key, shared, size):
    return base.generic_sample_group(
        sampler_init, sampler_eval, key, shared, size)


def from_values_grouped(shared, values, assignments, num_groups):
    v = jnp.asarray(values, jnp.int32)
    return Group(
        count=base.segment_sum(jnp.ones(v.shape, jnp.int32),
                               assignments, num_groups),
        sum=base.segment_sum(v, assignments, num_groups),
        log_prod=base.segment_sum(log_factorial(v), assignments, num_groups))


# -- uncollapsed parameter-space API (HMC/NUTS/VI backends) -----------------
# params = {'log_lambda': [..]}; lambda ~ Gamma(alpha, scale=1/inv_beta).

def param_init(key, shared, shape=()):
    mean = shared.alpha / shared.inv_beta
    return {'log_lambda': jnp.log(mean)
            + 0.1 * jax.random.normal(key, shape)}


def param_log_prior(shared, params):
    lam = jnp.exp(params['log_lambda'])
    log_p = (shared.alpha * jnp.log(shared.inv_beta)
             - gammaln(shared.alpha)
             + (shared.alpha - 1.0) * params['log_lambda']
             - shared.inv_beta * lam)
    return log_p + params['log_lambda']  # Jacobian of exp


def param_log_likelihood(shared, params, value):
    v = jnp.asarray(value, jnp.float32)
    return (v * params['log_lambda'] - jnp.exp(params['log_lambda'])
            - log_factorial(v))


def param_constrain(shared, params):
    return {'lambda': jnp.exp(params['log_lambda'])}


# -- row-stat columns (single-matmul tile aggregation; see mixture.py) ------

ROW_STAT_DIM = 3


def row_stat_columns(shared, values):
    v = jnp.asarray(values, jnp.float32)
    return jnp.stack([jnp.ones_like(v), v, log_factorial(v)], axis=-1)


def row_stats_to_tile(shared, sums):
    return Group(count=jnp.round(sums[..., 0]).astype(jnp.int32),
                 sum=jnp.round(sums[..., 1]).astype(jnp.int32),
                 log_prod=sums[..., 2])


def tile_stats(shared, values, assignments, num_groups):
    return from_values_grouped(shared, values, assignments, num_groups)


def tile_to_group(shared, tile):
    return tile
