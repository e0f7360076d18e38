"""Normal-Inverse-Chi-Squared conjugate model on univariate normal data.

Semantics match the reference (dbg/models/nich.py:28-241,
include/distributions/models/nich.hpp): Value=float,
Shared={mu, kappa, sigmasq, nu}, Group={count, mean, count_times_variance}
maintained by Welford-style online updates (incl. remove and merge —
reference nich.hpp:117-179).  Equations from Murphy, "Conjugate Bayesian
analysis of the Gaussian distribution" (2007).

The reference's hand-vectorized ValueScorer keeps 4 parallel VectorFloats
{score, log_coeff, precision, mean} (src/models/nich.cc:33-67); here the same
cached quantities appear as [K] intermediates in one fused XLA graph
(`score_value_batch`), which XLA fuses with the categorical draw of the
blocked sweep (see ops/).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from distributions_tpu.special import gammaln, lgamma_nu
from distributions_tpu.random import sample_chisq, sample_normal
from distributions_tpu.models import base

NAME = 'NormalInverseChiSq'
EXAMPLES = [
    {
        'shared': {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.},
        'values': [-4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0],
    },
]
Value = float

_LOG_PI = 1.1447298858494002


def score_student_t(x, nu, mu, sigmasq):
    """Scalar student-t log density, \\cite{murphy2007conjugate} Eq. 304
    (reference dbg/models/nich.py:45-54); broadcasts over all args."""
    score = lgamma_nu(nu)  # cancellation-safe lgamma((nu+1)/2)-lgamma(nu/2)
    score -= 0.5 * jnp.log(nu * jnp.pi * sigmasq)
    xt = x - mu
    s = xt * xt / sigmasq
    return score - (0.5 * (nu + 1.0)) * jnp.log1p(s / nu)


class Shared(NamedTuple):
    mu: jnp.ndarray
    kappa: jnp.ndarray
    sigmasq: jnp.ndarray
    nu: jnp.ndarray


class Group(NamedTuple):
    count: jnp.ndarray                 # int32
    mean: jnp.ndarray                  # float32
    count_times_variance: jnp.ndarray  # float32


def shared_from_dict(raw):
    return Shared(mu=jnp.float32(raw['mu']), kappa=jnp.float32(raw['kappa']),
                  sigmasq=jnp.float32(raw['sigmasq']),
                  nu=jnp.float32(raw['nu']))


def shared_to_dict(shared):
    return {'mu': float(shared.mu), 'kappa': float(shared.kappa),
            'sigmasq': float(shared.sigmasq), 'nu': float(shared.nu)}


def group_from_dict(raw):
    return Group(count=jnp.int32(raw['count']), mean=jnp.float32(raw['mean']),
                 count_times_variance=jnp.float32(
                     raw['count_times_variance']))


def group_to_dict(group):
    return {'count': int(group.count), 'mean': float(group.mean),
            'count_times_variance': float(group.count_times_variance)}


def group_init(shared, shape=()):
    return Group(count=jnp.zeros(shape, jnp.int32),
                 mean=jnp.zeros(shape, jnp.float32),
                 count_times_variance=jnp.zeros(shape, jnp.float32))


def plus_group(shared, group):
    """\\cite{murphy2007conjugate} Eqs. 141-144 (reference
    dbg/models/nich.py:74-93).  Batched over group's [K] axis."""
    count = group.count.astype(jnp.float32)
    total = group.mean * count
    mu_1 = shared.mu - group.mean
    kappa_n = shared.kappa + count
    mu_n = (shared.kappa * shared.mu + total) / kappa_n
    nu_n = shared.nu + count
    sigmasq_n = (shared.nu * shared.sigmasq
                 + group.count_times_variance
                 + (count * shared.kappa * mu_1 * mu_1) / kappa_n) / nu_n
    return Shared(mu=mu_n, kappa=kappa_n, sigmasq=sigmasq_n, nu=nu_n)


def add_value(shared, group, value):
    """Welford online update (reference dbg/models/nich.py:134-138)."""
    value = jnp.asarray(value, jnp.float32)
    count = group.count + 1
    delta = value - group.mean
    mean = group.mean + delta / count.astype(jnp.float32)
    ctv = group.count_times_variance + delta * (value - mean)
    return Group(count=count, mean=mean, count_times_variance=ctv)


def add_repeated_value(shared, group, value, count):
    """reference dbg/models/nich.py:140-144."""
    value = jnp.asarray(value, jnp.float32)
    count = jnp.asarray(count, jnp.int32)
    new_count = group.count + count
    delta = count.astype(jnp.float32) * value - group.mean
    mean = group.mean + delta / new_count.astype(jnp.float32)
    ctv = group.count_times_variance + delta * (value - mean)
    return Group(count=new_count, mean=mean, count_times_variance=ctv)


def remove_value(shared, group, value):
    """Welford downdate (reference dbg/models/nich.py:146-157) — the known
    cancellation hazard; mirrors reference branch structure exactly."""
    value = jnp.asarray(value, jnp.float32)
    total = group.mean * group.count.astype(jnp.float32)
    delta = value - group.mean
    count = group.count - 1
    countf = count.astype(jnp.float32)
    mean = jnp.where(count == 0, 0.0, (total - value) / jnp.maximum(countf, 1))
    ctv = jnp.where(
        count <= 1, 0.0,
        group.count_times_variance - delta * (value - mean))
    return Group(count=count, mean=mean, count_times_variance=ctv)


def merge(shared, destin, source):
    """reference dbg/models/nich.py:159-167."""
    count = destin.count + source.count
    countf = jnp.maximum(count.astype(jnp.float32), 1)
    delta = source.mean - destin.mean
    source_part = source.count.astype(jnp.float32) / countf
    cross_part = destin.count.astype(jnp.float32) * source_part
    mean = destin.mean + source_part * delta
    ctv = (destin.count_times_variance + source.count_times_variance
           + cross_part * delta * delta)
    return Group(count=count, mean=mean, count_times_variance=ctv)


def unmerge(shared, destin, source):
    """Inverse of merge: remove `source`'s contribution from `destin`."""
    count = destin.count - source.count
    countf = jnp.maximum(count.astype(jnp.float32), 1)
    destf = jnp.maximum(destin.count.astype(jnp.float32), 1)
    mean = jnp.where(
        count == 0, 0.0,
        (destin.mean * destin.count.astype(jnp.float32)
         - source.mean * source.count.astype(jnp.float32)) / countf)
    delta = source.mean - mean
    cross_part = countf * source.count.astype(jnp.float32) / destf
    ctv = jnp.where(
        count <= 1, 0.0,
        destin.count_times_variance - source.count_times_variance
        - cross_part * delta * delta)
    return Group(count=count, mean=mean, count_times_variance=ctv)


def score_value(shared, group, value):
    """Posterior predictive student-t, \\cite{murphy2007conjugate} Eq. 176
    (reference dbg/models/nich.py:169-178)."""
    post = plus_group(shared, group)
    return score_student_t(
        jnp.asarray(value, jnp.float32), post.nu, post.mu,
        ((1.0 + post.kappa) * post.sigmasq) / post.kappa)


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K] in the cached-coefficient form of
    reference src/models/nich.cc:33-67:
        score(v, k) = score_k + log_coeff_k * log(1 + prec_k (v - mean_k)^2)
    """
    post = plus_group(shared, group)
    lambda_ = ((1.0 + post.kappa) * post.sigmasq) / post.kappa     # [K]
    score = (lgamma_nu(post.nu)
             - 0.5 * jnp.log(post.nu * jnp.pi * lambda_))          # [K]
    log_coeff = -0.5 * (post.nu + 1.0)                             # [K]
    precision = 1.0 / (post.nu * lambda_)                          # [K]
    v = jnp.asarray(values, jnp.float32)[:, None]                  # [B, 1]
    t = v - post.mu[None, :]
    return (score[None, :]
            + log_coeff[None, :] * jnp.log1p(precision[None, :] * t * t))


def score_data(shared, group):
    """\\cite{murphy2007conjugate} Eq. 171 (reference
    dbg/models/nich.py:180-189)."""
    post = plus_group(shared, group)
    return (gammaln(0.5 * post.nu) - gammaln(0.5 * shared.nu)
            + 0.5 * jnp.log(shared.kappa / post.kappa)
            + (0.5 * shared.nu) * jnp.log(shared.nu * shared.sigmasq)
            - (0.5 * post.nu) * jnp.log(post.nu * post.sigmasq)
            - 0.5 * group.count.astype(jnp.float32) * _LOG_PI)


def sampler_init(key, shared, group=None):
    """Draw (mu, sigma) from the (posterior) NIX marginals
    (\\cite{murphy2007conjugate} Eqs. 156 & 167; reference
    dbg/models/nich.py:219-230)."""
    post = shared if group is None else plus_group(shared, group)
    k1, k2 = jax.random.split(key)
    sigmasq_star = post.nu * post.sigmasq / sample_chisq(k1, post.nu)
    mu = sample_normal(k2, post.mu, jnp.sqrt(sigmasq_star / post.kappa))
    return mu, jnp.sqrt(sigmasq_star)


def sampler_eval(key, shared, params, shape=()):
    mu, sigma = params
    return sample_normal(key, mu, sigma, shape)


def sample_value(key, shared, group):
    k1, k2 = jax.random.split(key)
    params = sampler_init(k1, shared, group)
    return sampler_eval(k2, shared, params)


def sample_group(key, shared, size):
    return base.generic_sample_group(
        sampler_init, sampler_eval, key, shared, size)


class TileStats(NamedTuple):
    """Additive raw-moment form (n, sum, sumsq) used for tile aggregation
    and cross-device psum — Group's (mean, M2) is not additive."""
    count: jnp.ndarray
    sum: jnp.ndarray
    sumsq: jnp.ndarray


def tile_stats(shared, values, assignments, num_groups):
    v = jnp.asarray(values, jnp.float32)
    return TileStats(
        count=base.segment_sum(jnp.ones(v.shape, jnp.int32),
                               assignments, num_groups),
        sum=base.segment_sum(v, assignments, num_groups),
        sumsq=base.segment_sum(v * v, assignments, num_groups))


def tile_to_group(shared, tile):
    n, s, ss = tile.count, tile.sum, tile.sumsq
    nf = jnp.maximum(n.astype(jnp.float32), 1)
    mean = jnp.where(n > 0, s / nf, 0.0)
    ctv = jnp.where(n > 1, ss - s * s / nf, 0.0)
    return Group(count=n, mean=mean, count_times_variance=jnp.maximum(ctv, 0))


def from_values_grouped(shared, values, assignments, num_groups):
    """Segment-summed suff stats: mean/M2 recovered from (n, sum, sumsq)."""
    return tile_to_group(
        shared, tile_stats(shared, values, assignments, num_groups))


# -- uncollapsed parameter-space API (HMC/NUTS/VI backends) -----------------
# params = {'mu': [..], 'log_sigmasq': [..]} in unconstrained space;
# log_prior includes the log-Jacobian of sigmasq = exp(log_sigmasq).

def param_init(key, shared, shape=()):
    k1, k2 = jax.random.split(key)
    return {
        'mu': shared.mu + 0.1 * jax.random.normal(k1, shape),
        'log_sigmasq': jnp.log(shared.sigmasq)
        + 0.1 * jax.random.normal(k2, shape),
    }


def param_log_prior(shared, params):
    """NIX prior: sigmasq ~ ScaledInvChiSq(nu, sigmasq0),
    mu | sigmasq ~ N(mu0, sigmasq/kappa); + Jacobian of the log transform."""
    sigmasq = jnp.exp(params['log_sigmasq'])
    half_nu = 0.5 * shared.nu
    log_p_sigmasq = (half_nu * jnp.log(half_nu * shared.sigmasq)
                     - gammaln(half_nu)
                     - (1.0 + half_nu) * jnp.log(sigmasq)
                     - half_nu * shared.sigmasq / sigmasq)
    var_mu = sigmasq / shared.kappa
    d = params['mu'] - shared.mu
    log_p_mu = -0.5 * (jnp.log(2 * jnp.pi * var_mu) + d * d / var_mu)
    jacobian = params['log_sigmasq']  # d sigmasq / d log_sigmasq = sigmasq
    return log_p_sigmasq + log_p_mu + jacobian


def param_log_likelihood(shared, params, value):
    """log N(value | mu, sigmasq); broadcasts params [K] x value [...]."""
    sigmasq = jnp.exp(params['log_sigmasq'])
    d = jnp.asarray(value, jnp.float32) - params['mu']
    return -0.5 * (jnp.log(2 * jnp.pi * sigmasq) + d * d / sigmasq)


def param_constrain(shared, params):
    return {'mu': params['mu'], 'sigmasq': jnp.exp(params['log_sigmasq'])}


# -- row-stat columns (single-matmul tile aggregation; see mixture.py) ------

ROW_STAT_DIM = 3


def row_stat_columns(shared, values):
    """[..., 3] = [1, v, v^2] per value; tile sums of these are TileStats."""
    v = jnp.asarray(values, jnp.float32)
    return jnp.stack([jnp.ones_like(v), v, v * v], axis=-1)


def row_stats_to_tile(shared, sums):
    """sums [..., 3] (onehot-matmul aggregated) -> additive TileStats."""
    return TileStats(count=jnp.round(sums[..., 0]).astype(jnp.int32),
                     sum=sums[..., 1], sumsq=sums[..., 2])
