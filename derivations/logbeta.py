"""log-Beta accuracy audit (analog of reference derivations/logbeta.py,
which explored polynomial surrogates for betaln on top of its
second-order lgamma approximation).

Here there is nothing to fit — XLA ships fast vectorized lgamma, and
`special.log_beta` is the three-lgamma identity
    log B(x, y) = lgamma(x) + lgamma(y) - lgamma(x + y)
(reference include/distributions/special.hpp:173-182).  What this script
validates instead is the identity's ERROR ENVELOPE in float32:

 - the reference's flavor-agreement tolerance is 1e-3 relative
   (distributions/tests/util.py assert_close); the models (bb's beta
   marginal, bnb, dpd stick scores) call log_beta with arguments up to
   ~count scale, where the identity loses accuracy to cancellation when
   x >> y (log B(x, y) -> -y log x, small, while each lgamma term is
   large);
 - the audit quantifies that loss per decade so the safe argument range
   is documented rather than assumed.

Run: python derivations/logbeta.py
"""

import os
import sys

import numpy as np
import scipy.special

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def audit(n=20000, seed=0):
    import jax.numpy as jnp
    from distributions_tpu.special import log_beta, log_binom

    rng = np.random.RandomState(seed)
    worst = []
    # stratified by magnitude ratio: x ~ 10^a, y ~ 10^b
    for (alo, ahi) in ((-2, 0), (0, 2), (2, 4), (4, 6)):
        for (blo, bhi) in ((-2, 0), (0, 2), (2, 4)):
            x = 10.0 ** rng.uniform(alo, ahi, n)
            y = 10.0 ** rng.uniform(blo, bhi, n)
            ours = np.asarray(
                log_beta(jnp.asarray(x, jnp.float32),
                         jnp.asarray(y, jnp.float32)), np.float64)
            exact = scipy.special.betaln(x, y)
            rel = np.abs(ours - exact) / np.maximum(np.abs(exact), 1.0)
            worst.append((alo, ahi, blo, bhi, rel.max()))
            print('log_beta x in [1e{}, 1e{}), y in [1e{}, 1e{}): '
                  'max rel err {:.2e}'.format(alo, ahi, blo, bhi, rel.max()))
    return worst


def audit_log_binom(n=20000, seed=1):
    import jax.numpy as jnp
    from distributions_tpu.special import log_binom

    rng = np.random.RandomState(seed)
    worst = []
    for hi in (64, 4096, 1 << 20):
        N = rng.randint(1, hi, n).astype(np.float64)
        k = np.floor(rng.uniform(0, 1, n) * (N + 1))
        ours = np.asarray(
            log_binom(jnp.asarray(N, jnp.float32),
                      jnp.asarray(k, jnp.float32)), np.float64)
        exact = (scipy.special.gammaln(N + 1)
                 - scipy.special.gammaln(k + 1)
                 - scipy.special.gammaln(N - k + 1))
        rel = np.abs(ours - exact) / np.maximum(np.abs(exact), 1.0)
        worst.append((hi, rel.max()))
        print('log_binom n < {}: max rel err {:.2e}'.format(hi, rel.max()))
    return worst


def check(tol=2e-4):
    """True iff log_beta meets a 2e-4 envelope over the full audited grid
    (x, y up to 1e6).  The naive three-lgamma identity FAILS this — it
    degrades to 1e-2..2.0 relative when x >> y (cancellation); the
    audit pinned that, and special.log_beta now switches to the
    Stirling-differenced form above max(x, y) >= 64, which restores
    ~1e-5 everywhere.  This check keeps that fix honest."""
    rows = audit()
    ok = True
    for alo, ahi, blo, bhi, err in rows:
        if err > tol:
            print('FAIL x in [1e%d, 1e%d) y in [1e%d, 1e%d): %.2e > %g'
                  % (alo, ahi, blo, bhi, err, tol))
            ok = False
    for hi, err in audit_log_binom():
        if err > tol:
            print('FAIL log_binom n < %d: %.2e' % (hi, err))
            ok = False
    return ok


if __name__ == '__main__':
    # an audit of float64 reference values: keep it on the host
    import jax
    jax.config.update('jax_platforms', 'cpu')
    print('PASS' if check() else 'FAIL')
