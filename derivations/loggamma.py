"""Log-gamma accuracy audit (reference derivations/loggamma.py generated the
per-octave 5th-order polynomial tables for fast_lgamma; XLA ships fast
vectorized lgamma so no tables are generated here — instead this validates
that the hardware implementation meets the reference's tolerance envelope
of 1e-3 relative over the ranges the models use).

Run: python derivations/loggamma.py
"""

import numpy as np
import scipy.special


def audit(ranges=((1e-3, 0.0625), (0.0625, 2.5), (2.5, 64.0),
                  (64.0, 4096.0), (4096.0, 1e7)), n=20000):
    import jax
    import jax.numpy as jnp
    from distributions_tpu.special import lgamma, lgamma_nu

    worst = []
    for lo, hi in ranges:
        x = np.exp(np.random.RandomState(0).uniform(
            np.log(lo), np.log(hi), n))
        ours = np.asarray(lgamma(jnp.asarray(x, jnp.float32)), np.float64)
        exact = scipy.special.gammaln(x)
        denom = np.maximum(np.abs(exact), 1.0)
        rel = np.abs(ours - exact) / denom
        worst.append((lo, hi, rel.max()))
        print('lgamma    [{:.4g}, {:.4g}): max rel err {:.2e}'.format(
            lo, hi, rel.max()))
        assert rel.max() < 1e-3, (lo, hi, rel.max())

        ours_nu = np.asarray(lgamma_nu(jnp.asarray(x, jnp.float32)),
                             np.float64)
        exact_nu = (scipy.special.gammaln(x / 2 + 0.5)
                    - scipy.special.gammaln(x / 2))
        rel_nu = np.abs(ours_nu - exact_nu) / np.maximum(
            np.abs(exact_nu), 1e-2)
        print('lgamma_nu [{:.4g}, {:.4g}): max rel err {:.2e}'.format(
            lo, hi, rel_nu.max()))
        assert rel_nu.max() < 2e-3, (lo, hi, rel_nu.max())
    return worst


if __name__ == '__main__':
    audit()
    print('lgamma accuracy audit passed (reference tolerance 1e-3)')
