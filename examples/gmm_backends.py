"""One model, four inference backends.

Fits the same Pitman-Yor Gaussian mixture to synthetic data with collapsed
Gibbs, HMC, NUTS, ADVI, and SMC — all driven from the same Shared
hyperparameters and (for the gradient backends) the same log-prob graph —
and reports cluster purity + timing for each.

    PYTHONPATH=. python examples/gmm_backends.py [--rows 512] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--rows', type=int, default=512)
    parser.add_argument('--cpu', action='store_true')
    args = parser.parse_args()

    if args.cpu:
        os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    from distributions_tpu import runtime
    runtime.enable_compile_cache()
    import jax.numpy as jnp

    from distributions_tpu import clustering, mixture as mx
    from distributions_tpu.models import nich
    from distributions_tpu.ops import gibbs, mh
    from distributions_tpu.inference import hmc, vi, smc, logprob

    rng = np.random.RandomState(0)
    centers = np.array([[-2.5, -2.5], [2.5, 2.5], [-2.5, 2.5]])
    labels = rng.randint(0, 3, args.rows)
    X = (centers[labels] + 0.3 * rng.randn(args.rows, 2)).astype(np.float32)

    spec = mx.make_spec([(nich, 2)], capacity=16, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    values = (jnp.asarray(X),)
    key = jax.random.PRNGKey(0)

    def purity(assign):
        a = np.asarray(assign)
        return sum(np.bincount(labels[a == k]).max()
                   for k in np.unique(a)) / args.rows

    def report(name, t0, p):
        print('{:<18} {:6.2f}s  purity {:.3f}'.format(
            name, time.time() - t0, p))

    # collapsed Gibbs
    t0 = time.time()
    k1, key = jax.random.split(key)
    state, assign = gibbs.prior_init(
        spec, cl, shareds, mx.init(spec, shareds), values, k1)
    for _ in range(15):
        k1, key = jax.random.split(key)
        state, assign = gibbs.sweep_blocked(
            spec, cl, shareds, state, values, assign,
            args.rows // 4, key=k1)
    report('collapsed gibbs', t0, purity(assign))

    # MH sweep
    t0 = time.time()
    k1, key = jax.random.split(key)
    assign_mh = jnp.asarray(rng.randint(0, 8, args.rows), jnp.int32)
    state_mh = mx.state_from_assignments(spec, cl, shareds, values,
                                         assign_mh)
    for _ in range(40):
        k1, key = jax.random.split(key)
        state_mh, assign_mh = mh.sweep_mh(
            spec, cl, shareds, state_mh, values, assign_mh,
            args.rows // 4, mh_steps=8, key=k1, proposal_beta=4.0)
    report('mh sweep', t0, purity(assign_mh))

    # shared log-prob graph
    lp, init_fn = logprob.make_mixture_logprob(spec, cl, shareds, values,
                                               K=6)
    params0 = init_fn(jax.random.PRNGKey(5))

    t0 = time.time()
    k1, key = jax.random.split(key)
    samples, info = hmc.hmc(k1, lp, params0, num_samples=300,
                            num_warmup=500, num_leapfrog=24)
    last = jax.tree_util.tree_map(lambda a: a[-1], samples)
    resp = logprob.responsibilities(spec, cl, shareds, last, values)
    report('hmc', t0, purity(np.asarray(resp).argmax(1)))

    t0 = time.time()
    k1, key = jax.random.split(key)
    samples, info = hmc.nuts(k1, lp, params0, num_samples=200,
                             num_warmup=300, max_depth=6)
    last = jax.tree_util.tree_map(lambda a: a[-1], samples)
    resp = logprob.responsibilities(spec, cl, shareds, last, values)
    report('nuts', t0, purity(np.asarray(resp).argmax(1)))

    t0 = time.time()
    k1, key = jax.random.split(key)
    var_params, vinfo = vi.advi(k1, lp, params0, num_steps=1000)
    resp = logprob.responsibilities(spec, cl, shareds, var_params['mu'],
                                    values)
    report('advi', t0, purity(np.asarray(resp).argmax(1)))

    t0 = time.time()
    k1, key = jax.random.split(key)
    states, assigns, logw, log_ev = smc.smc_init(
        spec, cl, shareds, values, 8, 32, k1)
    st, an = smc.best_particle(states, assigns, logw)
    report('smc', t0, purity(an))
    print('smc log evidence: {:.1f}'.format(float(log_ev)))


if __name__ == '__main__':
    main()
