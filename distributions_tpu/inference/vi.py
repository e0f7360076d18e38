"""ADVI: mean-field variational inference over any log-prob pytree graph.

Shares the log-prob surface of hmc.py (inference.logprob) — the reference
has no VI backend; this is new capability from BASELINE.json's
north star (NUTS/HMC, VI, SMC over one log-prob graph)."""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

import optax


def advi(key, logprob_fn, init_params, num_steps=2000, num_mc=4,
         learning_rate=1e-2):
    """Mean-field normal ADVI with the reparameterization gradient.

    Returns (variational params {'mu': pytree, 'log_sigma': pytree},
    info dict with elbo trace).
    """
    mu0 = init_params
    log_sigma0 = jax.tree_util.tree_map(
        lambda x: jnp.full_like(x, -2.0), init_params)

    def elbo(var_params, key):
        mu, log_sigma = var_params['mu'], var_params['log_sigma']

        def one(sample_key):
            leaves, treedef = jax.tree_util.tree_flatten(mu)
            keys = jax.random.split(sample_key, len(leaves))
            keys = jax.tree_util.tree_unflatten(treedef, list(keys))
            eps = jax.tree_util.tree_map(
                lambda m, k: jax.random.normal(k, m.shape), mu, keys)
            z = jax.tree_util.tree_map(
                lambda m, ls, e: m + jnp.exp(ls) * e, mu, log_sigma, eps)
            return logprob_fn(z)

        keys = jax.random.split(key, num_mc)
        expected_logp = jnp.mean(jax.vmap(one)(keys))
        # entropy of the mean-field normal: sum log_sigma + const
        entropy = sum(jnp.sum(ls) for ls in
                      jax.tree_util.tree_leaves(var_params['log_sigma']))
        return expected_logp + entropy

    opt = optax.adam(learning_rate)
    var0 = {'mu': mu0, 'log_sigma': log_sigma0}
    opt_state0 = opt.init(var0)

    def step(carry, step_key):
        var_params, opt_state = carry
        loss, grads = jax.value_and_grad(
            lambda vp: -elbo(vp, step_key))(var_params)
        updates, opt_state = opt.update(grads, opt_state)
        var_params = optax.apply_updates(var_params, updates)
        return (var_params, opt_state), -loss

    keys = jax.random.split(key, num_steps)
    (var_params, _), elbos = lax.scan(step, (var0, opt_state0), keys)
    return var_params, {'elbo_trace': elbos}


def sample_posterior(key, var_params, num_samples=100):
    """Draw samples from the fitted mean-field posterior."""
    mu, log_sigma = var_params['mu'], var_params['log_sigma']

    def one(sample_key):
        leaves, treedef = jax.tree_util.tree_flatten(mu)
        keys = jax.random.split(sample_key, len(leaves))
        keys = jax.tree_util.tree_unflatten(treedef, list(keys))
        return jax.tree_util.tree_map(
            lambda m, ls, k: m + jnp.exp(ls)
            * jax.random.normal(k, m.shape), mu, log_sigma, keys)

    return jax.vmap(one)(jax.random.split(key, num_samples))
