"""Samplers and density functions (JAX analog of the reference's
include/distributions/random.hpp + distributions/dbg/random.py).

Entropy discipline
------------------
The reference threads one sequential `rng_t&` through every call (reference
doc/overview.rst:213-221, src/random.cc:33).  Here every sampler takes an
explicit `jax.random` key: counter-based, splittable, and layout-independent,
so results do not depend on how rows/components are sharded over the mesh.

Batching
--------
Every sampler accepts batched parameters and an optional `shape`; the Gibbs
inner primitive `sample_from_scores` (reference random.hpp:361-392) is the
batched categorical-from-log-scores draw over a [rows, K] matrix, lowered by
XLA to a fused gumbel + argmax.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from distributions_tpu.special import logsumexp

# ---------------------------------------------------------------------------
# basic scalar/batched samplers

def sample_unif01(key, shape=()):
    return jax.random.uniform(key, shape)


def sample_int(key, low, high, shape=()):
    """Uniform integer in [low, high) (reference random.hpp:42-47)."""
    return jax.random.randint(key, shape, low, high)


def sample_bernoulli(key, prob, shape=None):
    prob = jnp.asarray(prob)
    if shape is None:
        shape = prob.shape
    return jax.random.bernoulli(key, prob, shape)


def sample_normal(key, mu=0.0, sigma=1.0, shape=None):
    mu, sigma = jnp.asarray(mu, jnp.float32), jnp.asarray(sigma, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(mu.shape, sigma.shape)
    return mu + sigma * jax.random.normal(key, shape)


def sample_std_normal(key, shape=()):
    return jax.random.normal(key, shape)


def sample_chisq(key, nu, shape=None):
    nu = jnp.asarray(nu, jnp.float32)
    if shape is None:
        shape = nu.shape
    return 2.0 * jax.random.gamma(key, 0.5 * nu, shape)


def sample_gamma(key, alpha, beta=1.0, shape=None):
    """Gamma with shape `alpha` and SCALE `beta` (matches numpy.random.gamma
    used by reference dbg/random.py:37)."""
    alpha = jnp.asarray(alpha, jnp.float32)
    beta = jnp.asarray(beta, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(alpha.shape, beta.shape)
    return jax.random.gamma(key, jnp.broadcast_to(alpha, shape), shape) * beta


def sample_beta(key, alpha, beta, shape=None):
    alpha = jnp.asarray(alpha, jnp.float32)
    beta = jnp.asarray(beta, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(alpha.shape, beta.shape)
    return jax.random.beta(key, alpha, beta, shape)


def sample_beta_safe(key, alpha, beta, min_value=1e-6, shape=None):
    """Beta clipped away from {0,1} (reference random.hpp:109-119)."""
    p = sample_beta(key, alpha, beta, shape)
    return jnp.clip(p, min_value, 1.0 - min_value)


def sample_poisson(key, lam, shape=None):
    lam = jnp.asarray(lam, jnp.float32)
    if shape is None:
        shape = lam.shape
    return jax.random.poisson(key, lam, shape)


def sample_negative_binomial(key, p, r, shape=None):
    """# failures before the r-th success at success-prob p, i.e.
    P(x) ∝ p^r (1-p)^x (scipy nbinom convention; reference
    dbg/random.py:217-218).  Sampled as a gamma-Poisson mixture."""
    p = jnp.asarray(p, jnp.float32)
    r = jnp.asarray(r, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(p.shape, r.shape)
    k1, k2 = jax.random.split(key)
    lam = sample_gamma(k1, jnp.broadcast_to(r, shape), (1.0 - p) / p)
    return jax.random.poisson(k2, lam, shape)


def sample_dirichlet(key, alphas, shape=None):
    """Dirichlet over the last axis.  Zero alphas get zero mass (the
    reference's sample_dirichlet_safe handles alpha=0 explicitly;
    src/random.cc:35-72)."""
    alphas = jnp.asarray(alphas, jnp.float32)
    gammas = jax.random.gamma(key, jnp.maximum(alphas, 1e-30))
    gammas = jnp.where(alphas > 0, gammas, 0.0)
    return gammas / jnp.sum(gammas, axis=-1, keepdims=True)


def sample_dirichlet_safe(key, alphas, min_value=1e-6):
    alphas = jnp.asarray(alphas, jnp.float32)
    p = sample_dirichlet(key, alphas + min_value)
    return p


# ---------------------------------------------------------------------------
# categorical sampling from scores — the Gibbs inner primitive
# (reference random.hpp:288-392, src/random.cc:76-127)

def sample_discrete(key, probs, shape=None):
    """Draw from (possibly unnormalized) probabilities over the last axis
    (reference random.hpp:300-313's linear-scan CDF; here gumbel-argmax on
    log-probs so it vectorizes over any leading batch)."""
    probs = jnp.asarray(probs, jnp.float32)
    logits = jnp.log(jnp.maximum(probs, 1e-38))
    logits = jnp.where(probs > 0, logits, -jnp.inf)
    return jax.random.categorical(key, logits, shape=shape)


def sample_from_scores(key, scores, shape=None):
    """Categorical draw from log-scores over the last axis; batched over all
    leading axes.  Replaces sample_from_scores_overwrite (reference
    random.hpp:361-366)."""
    return jax.random.categorical(key, scores, shape=shape)


# alias matching dbg/random.py:63-66
def sample_discrete_log(key, scores, shape=None):
    return sample_from_scores(key, scores, shape=shape)


def sample_prob_from_scores(key, scores):
    """Draw a choice and return (choice, probability of that choice)
    (reference random.hpp:369-376)."""
    choice = sample_from_scores(key, scores)
    logp = scores - logsumexp(scores, axis=-1, keepdims=True)
    prob = jnp.exp(jnp.take_along_axis(
        logp, choice[..., None], axis=-1))[..., 0]
    return choice, prob


def score_from_scores(scores, choice):
    """Log-probability of `choice` under normalized `scores` (reference
    random.hpp:380-384; no entropy consumed — the reference's
    SYNCHRONIZE_ENTROPY_FOR_UNIT_TESTING hack is unnecessary with
    counter-based keys)."""
    logp = scores - logsumexp(scores, axis=-1, keepdims=True)
    return jnp.take_along_axis(
        jnp.asarray(logp), jnp.asarray(choice)[..., None], axis=-1)[..., 0]


def sample_pair_from_urn(key, n):
    """Draw an ordered pair of distinct indices from range(n) (reference
    random.hpp:261-285)."""
    k1, k2 = jax.random.split(key)
    i = jax.random.randint(k1, (), 0, n)
    j = jax.random.randint(k2, (), 0, n - 1)
    j = jnp.where(j >= i, j + 1, j)
    return i, j


# ---------------------------------------------------------------------------
# student-t

def score_student_t(x, nu, mu, sigma):
    """Multivariate student-t log density, \\cite{murphy2007conjugate} Eq. 313
    (reference dbg/random.py:113-131, random.hpp:160-185).

    `sigma` is a [d, d] scale matrix; batched over leading axes of `x`.
    """
    x = jnp.asarray(x, jnp.float32)
    mu = jnp.asarray(mu, jnp.float32)
    sigma = jnp.asarray(sigma, jnp.float32)
    p = mu.shape[-1]
    z = x - mu
    chol = jnp.linalg.cholesky(sigma)
    chol = jnp.broadcast_to(chol, z.shape[:-1] + chol.shape[-2:])
    sol = jax.scipy.linalg.solve_triangular(chol, z[..., None], lower=True)
    mahal = jnp.sum(jnp.square(sol[..., 0]), axis=-1)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)),
                           axis=-1)
    from distributions_tpu.special import lgamma_nu
    # lgamma((nu+p)/2) - lgamma(nu/2) = sum_i lgamma_nu(nu + i),
    # chained through the cancellation-safe helper
    nu = jnp.asarray(nu, jnp.float32)
    lg_ratio = sum(lgamma_nu(nu + i) for i in range(p))
    return (lg_ratio
            - 0.5 * (p * jnp.log(nu * jnp.pi) + logdet
                     + (nu + p) * jnp.log1p(mahal / nu)))


score_mv_student_t = score_student_t


def sample_student_t(key, dof, mu, sigma, shape=()):
    """Multivariate student-t sample: mu + z * sqrt(dof / chi2_dof)."""
    mu = jnp.asarray(mu, jnp.float32)
    k1, k2 = jax.random.split(key)
    p = mu.shape[-1]
    chol = jnp.linalg.cholesky(jnp.asarray(sigma, jnp.float32))
    z = jax.random.normal(k1, shape + mu.shape) @ chol.T
    x = sample_chisq(k2, jnp.asarray(dof, jnp.float32), shape + (1,))
    return mu + z * jnp.sqrt(dof / x)


# ---------------------------------------------------------------------------
# Wishart family (reference random.hpp:210-259, dbg/random.py:134-185)

def _bartlett(key, nu, d):
    """Lower-triangular Bartlett factor A with A A^T ~ W(nu, I)."""
    k1, k2 = jax.random.split(key)
    chis = jnp.sqrt(2.0 * jax.random.gamma(
        k1, 0.5 * (nu - jnp.arange(d, dtype=jnp.float32))))
    normals = jax.random.normal(k2, (d, d))
    a = jnp.tril(normals, -1) + jnp.diag(chis)
    return a


def sample_wishart(key, nu, Lambda):
    """Sample S ~ Wishart(nu, Lambda) via Bartlett decomposition."""
    Lambda = jnp.asarray(Lambda, jnp.float32)
    d = Lambda.shape[-1]
    ch = jnp.linalg.cholesky(Lambda)
    a = _bartlett(key, jnp.asarray(nu, jnp.float32), d)
    la = ch @ a
    return la @ la.T


def sample_inverse_wishart(key, nu, S):
    """Sample X ~ IW(nu, S): X = (W(nu, S^-1))^-1 (reference
    dbg/random.py:172-174, vendor/stats.py sample_invwishart)."""
    S = jnp.asarray(S, jnp.float32)
    d = S.shape[-1]
    chol_S = jnp.linalg.cholesky(S)
    a = _bartlett(key, jnp.asarray(nu, jnp.float32), d)
    # X^-1 = L_inv(S)^T A A^T L_inv(S) => X = chol_S A^-T A^-1 chol_S^T
    inv_a = jax.scipy.linalg.solve_triangular(
        a, jnp.eye(d, dtype=jnp.float32), lower=True)
    m = chol_S @ inv_a.T
    return m @ m.T


def sample_multivariate_normal(key, mu, cov, shape=()):
    """MVN via Cholesky (reference random.hpp:188-206)."""
    mu = jnp.asarray(mu, jnp.float32)
    chol = jnp.linalg.cholesky(jnp.asarray(cov, jnp.float32))
    z = jax.random.normal(key, shape + mu.shape)
    return mu + z @ chol.T


def sample_normal_inverse_wishart(key, mu0, kappa0, psi0, nu0):
    """(mu, Sigma) ~ NIW (reference dbg/random.py:177-184,
    random.hpp:249-259)."""
    k1, k2 = jax.random.split(key)
    cov = sample_inverse_wishart(k1, nu0, psi0)
    chol = jnp.linalg.cholesky(cov / kappa0)
    mu = jnp.asarray(mu0, jnp.float32) + chol @ jax.random.normal(
        k2, jnp.asarray(mu0).shape)
    return mu, cov


# ---------------------------------------------------------------------------
# stick breaking (reference dbg/random.py:204-214)

def sample_stick(key, gamma, capacity=64):
    """Truncated DP stick-breaking: returns normalized weights of length
    `capacity` (fixed-shape analog of dbg/random.py:204-214's tol loop)."""
    fracs = jax.random.beta(
        key, 1.0, jnp.full((capacity,), gamma, jnp.float32))
    log_rest = jnp.concatenate([
        jnp.zeros((1,), jnp.float32),
        jnp.cumsum(jnp.log1p(-fracs[:-1]))])
    betas = fracs * jnp.exp(log_rest)
    return betas / jnp.sum(betas)


def sample_partition_from_counts(key, items, counts):
    """Random partition of `items` into groups of the given sizes (reference
    dbg/random.py:187-201).  Host-side utility (python lists)."""
    assert sum(counts) == len(items), 'counts do not sum to item count'
    order = np.asarray(jax.random.permutation(key, len(items)))
    partition = []
    i = 0
    for c in counts:
        partition.append([items[order[j]] for j in range(i, i + c)])
        i += c
    return partition


__all__ = [
    'sample_unif01', 'sample_int', 'sample_bernoulli', 'sample_normal',
    'sample_std_normal', 'sample_chisq', 'sample_gamma', 'sample_beta',
    'sample_beta_safe', 'sample_poisson', 'sample_negative_binomial',
    'sample_dirichlet', 'sample_dirichlet_safe', 'sample_discrete',
    'sample_from_scores', 'sample_discrete_log', 'sample_prob_from_scores',
    'score_from_scores', 'sample_pair_from_urn', 'score_student_t',
    'score_mv_student_t', 'sample_student_t', 'sample_wishart',
    'sample_inverse_wishart', 'sample_normal_inverse_wishart',
    'sample_stick', 'sample_partition_from_counts',
]
