"""Special numerical functions (JAX analog of the reference's
include/distributions/special.hpp + distributions/dbg/special.py).

The reference ships hand-rolled fast approximations (`fast_log` ICSI table,
`fast_lgamma` per-octave 5th-order polynomials, `fast_log_factorial` table;
reference special.hpp:53-214) because 2014-era CPUs lacked fast vectorized
transcendentals.  XLA lowers `log`/`exp`/`lgamma` to fast vectorized
code and fuses them into surrounding elementwise graphs, so here each function
is a thin, vectorized jnp definition; the names `fast_*` are kept as aliases
for API parity.  Everything is batched: scalars, vectors, or [rows, K]
matrices all work.

Tolerances follow the reference tests: 1e-3 relative (reference
tests/util.py:100-151).
"""

import numpy as np

import jax.numpy as jnp
from jax import lax
from jax.scipy.special import gammaln as _gammaln

# -- scalar-ish elementwise wrappers ----------------------------------------

log = jnp.log
exp = jnp.exp
sqrt = jnp.sqrt
pi = float(np.pi)

# XLA's lgamma is already fast + vectorized; fast_* aliases keep parity with
# reference special.hpp:114-171.
lgamma = _gammaln
gammaln = _gammaln
fast_log = jnp.log
fast_exp = jnp.exp
fast_lgamma = _gammaln


def log_sum_exp(x, y):
    """Pairwise logsumexp (reference special.hpp:91-96)."""
    return jnp.logaddexp(x, y)


def logsumexp(scores, axis=-1, keepdims=False):
    """Max-subtracted vector logsumexp (reference src/random.cc:76-92)."""
    m = jnp.max(scores, axis=axis, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)  # all--inf rows stay -inf, not nan
    out = jnp.log(jnp.sum(jnp.exp(scores - m), axis=axis, keepdims=True)) + m
    return out if keepdims else jnp.squeeze(out, axis=axis)


def lgamma_diff(x, y):
    """lgamma(x + y) - lgamma(x), cancellation-safe for x >= 64.

    The naive difference loses up to ALL significant f32 bits when
    x >> y (both terms ~ x log x while the difference is ~ y log x —
    measured 2.0 relative error at x ~ 1e5, y < 1; see
    derivations/logbeta.py).  Stirling with the 1/(12z) and 1/(360z^3)
    corrections, differenced symbolically so every term is O(y log x):

        diff = y log x + (x + y - 1/2) log1p(y/x) - y
             + 1/12 (1/(x+y) - 1/x) - 1/360 (1/(x+y)^3 - 1/x^3)

    Remainder ~ 1/(1260 z^5) < 1e-11 at z >= 64.
    """
    r = y / x
    xy = x + y
    return (y * jnp.log(x) + (xy - 0.5) * jnp.log1p(r) - y
            + (1.0 / 12.0) * (1.0 / xy - 1.0 / x)
            - (1.0 / 360.0) * (1.0 / (xy * xy * xy)
                               - 1.0 / (x * x * x)))


def lgamma_ratio(x, y):
    """lgamma(x + y) - lgamma(x) — the log rising factorial
    log Γ(x+y)/Γ(x) — accurate for ALL x > 0, y >= 0.

    Routes to the symbolically-differenced Stirling form (`lgamma_diff`)
    at x >= 64 where the naive difference loses up to all f32
    significance (found by the r4 logbeta audit; the r5 trigger: slice-
    sampled dd alphas walked to alpha ~ 1e9 because the naive
    score_data difference cancelled to exactly 0 there, turning the
    posterior into a flat plateau).  Every conjugate score_data with a
    gammaln(hyper + n) - gammaln(hyper) term should use this."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    direct = _gammaln(x + y) - _gammaln(x)
    x_safe = jnp.maximum(x, 64.0)
    return jnp.where(x >= 64.0, lgamma_diff(x_safe, y), direct)


def log_beta(x, y):
    """log B(x, y) (reference special.hpp:173-182).

    The three-lgamma identity is used when max(x, y) < 64; above that the
    cancellation-safe `lgamma_diff` form keeps the f32 relative error
    ~1e-5 where the naive identity degrades to 1e-2..2.0 for x >> y
    (audited in derivations/logbeta.py)."""
    x = jnp.asarray(x)
    a = jnp.maximum(x, y)
    b = jnp.minimum(x, y)
    direct = _gammaln(x) + _gammaln(y) - _gammaln(x + y)
    # evaluate the safe branch at a clamped argument so the untaken side
    # stays finite (jnp.where evaluates both)
    a_safe = jnp.maximum(a, 64.0)
    safe = _gammaln(b) - lgamma_diff(a_safe, b)
    return jnp.where(a >= 64.0, safe, direct)


fast_log_beta = log_beta


def log_binom(n, k):
    """log C(n, k) (reference special.hpp:191-197), routed through the
    cancellation-safe log_beta: log C(n,k) = -log(n+1) - log B(k+1, n-k+1)
    (naive three-lgamma form audited at 1.4e-3 rel for n ~ 1e6;
    derivations/logbeta.py)."""
    return -jnp.log(n + 1.0) - log_beta(k + 1.0, n - k + 1.0)


fast_log_binom = log_binom


def log_factorial(n):
    """log n! = lgamma(n+1) (reference special.hpp:204-214 uses a 64-entry
    table then falls back to lgamma; XLA's lgamma makes the table moot)."""
    return _gammaln(jnp.asarray(n, jnp.float32) + 1.0)


fast_log_factorial = log_factorial


def factorial(n):
    return jnp.exp(log_factorial(n))


def lgamma_nu(nu):
    """lgamma(nu/2 + 1/2) - lgamma(nu/2), the student-t coefficient
    (reference special.hpp:239-273's `fast_lgamma_nu`).

    The naive difference cancels catastrophically in f32 for large nu (both
    terms ~nu log nu while the difference is ~0.5 log nu — the very reason
    the reference built a direct polynomial).  Above nu=64 the asymptotic
    lgamma(x+1/2)-lgamma(x) = 0.5 log x - 1/(8x) + 1/(192 x^3) + O(x^-5)
    (x = nu/2) is exact to <1e-7 relative."""
    nu = jnp.asarray(nu, jnp.float32)
    direct = _gammaln(0.5 * nu + 0.5) - _gammaln(0.5 * nu)
    x = jnp.maximum(0.5 * nu, 1e-30)
    asym = 0.5 * jnp.log(x) - 1.0 / (8.0 * x) + 1.0 / (192.0 * x ** 3)
    return jnp.where(nu < 64.0, direct, asym)


fast_lgamma_nu = lgamma_nu


def lmultigamma(d, a):
    """Log multivariate gamma function Γ_d(a) (reference special.hpp:278-286).

    `d` must be a static python int; `a` may be batched.
    """
    d = int(d)
    a = jnp.asarray(a, jnp.float32)[..., None]
    j = jnp.arange(1, d + 1, dtype=jnp.float32)
    log_pi = 1.1447298858494002
    term1 = 0.25 * d * (d - 1) * log_pi
    return term1 + jnp.sum(_gammaln(a + 0.5 * (1.0 - j)), axis=-1)


# -- Stirling numbers of the first kind -------------------------------------

_STIRLING1_EXACT_MAX = 32  # reference src/special.cc:136-142 threshold


def _log_stirling1_row_exact(n):
    """Exact unsigned Stirling-1 row via the log-space recurrence
    s(n,k) = (n-1) s(n-1,k) + s(n-1,k-1) (reference src/special.cc:58-85).

    n is static and small (< 32), so this runs in float64 numpy and
    constant-folds under jit.
    """
    row = np.full(n + 1, -np.inf)
    row[min(n, 0)] = -np.inf if n > 0 else 0.0
    prev = np.array([0.0])  # log s(0, 0) = 0
    for m in range(1, n + 1):
        cur = np.full(m + 1, -np.inf)
        cur[m] = 0.0
        if m > 1:
            log_m_minus_1 = np.log(m - 1)
            a = log_m_minus_1 + prev[1:m]
            b = prev[0:m - 1]
            cur[1:m] = np.logaddexp(a, b)
        prev = cur
    if n == 0:
        return jnp.asarray(np.array([0.0]), jnp.float32)
    return jnp.asarray(prev, jnp.float32)


def _log_stirling1_row_approx(n):
    """Softmin blend of DLMF 26.8.40 (small k) and Gruenberg's asymptotic
    (large k), as derived in the reference (src/special.cc:86-135)."""
    k = jnp.arange(n + 1, dtype=jnp.float32)
    nf = float(n)
    log_factorial_n_minus_1 = float(_gammaln(nf))  # log (n-1)!
    log_n_sq_over_two = float(np.log(nf * nf / 2.0))
    euler_gamma = 0.57721566490153286060
    log_stuff = float(np.log(euler_gamma + np.log(nf - 1.0)))
    softness = nf / 3.0

    approx1 = (log_factorial_n_minus_1
               - _gammaln(k)  # log (k-1)! at k>=1
               + (k - 1.0) * log_stuff)
    approx2 = (nf - k) * log_n_sq_over_two - _gammaln(nf - k + 1.0)
    row = -softness * jnp.logaddexp(-approx1 / softness, -approx2 / softness)
    row = row.at[0].set(-jnp.inf)
    row = row.at[n].set(0.0)
    return row.astype(jnp.float32)


def log_stirling1_row(n):
    """[log s(n,0), ..., log s(n,n)] — exact for n < 32, approximate above
    (reference special.hpp:295-302, src/special.cc:55-142).  `n` is static."""
    n = int(n)
    if n < _STIRLING1_EXACT_MAX:
        return _log_stirling1_row_exact(n)
    return _log_stirling1_row_approx(n)


# -- misc -------------------------------------------------------------------

def log1p_exp(x):
    """log(1 + exp(x)), stable."""
    return jnp.logaddexp(0.0, x)


def scores_to_likelihoods(scores, axis=-1):
    """Max-subtracted exp, returning (likelihoods, total); the in-place
    `scores_to_likelihoods` of reference src/random.cc:94-106."""
    m = jnp.max(scores, axis=axis, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    likes = jnp.exp(scores - m)
    return likes, jnp.sum(likes, axis=axis)


def stick(betas):
    """Normalize a log-space stick; helper for dpd."""
    return betas / jnp.sum(betas)


def clip_finite(x, minval=-3.4e38, maxval=3.4e38):
    return jnp.clip(x, minval, maxval)


def poly_eval(coeffs, x):
    """Horner evaluation of a fixed (static-length) polynomial, highest
    degree first — used by tests validating against reference tables."""
    acc = jnp.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def lax_cumlogsumexp(x, axis=0):
    """Cumulative logsumexp along an axis (used by stick-breaking realize)."""
    m = jnp.max(x, axis=axis, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    return jnp.log(jnp.cumsum(jnp.exp(x - m), axis=axis)) + m


# reference's fast_log_sum_exp (special.hpp:91-96); the XLA op is already
# the fast path here
fast_log_sum_exp = log_sum_exp

__all__ = [
    'log', 'exp', 'sqrt', 'pi', 'lgamma', 'gammaln',
    'fast_log', 'fast_exp', 'fast_lgamma',
    'log_sum_exp', 'fast_log_sum_exp', 'logsumexp', 'log_beta',
    'fast_log_beta',
    'log_binom', 'fast_log_binom', 'log_factorial', 'fast_log_factorial',
    'factorial', 'lgamma_nu', 'fast_lgamma_nu', 'lmultigamma',
    'log_stirling1_row', 'log1p_exp', 'scores_to_likelihoods',
]
