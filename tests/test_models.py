"""Generic per-model test harness, driven by each model's EXAMPLES metadata
(the analog of reference distributions/tests/test_models.py:63-594).

Identities tested per model x example:
- dict load/dump round trips
- chain rule: score_data == sum of incremental score_value
- add/remove inverse with shuffling; data debt for bool/int models
- add_repeated == n x add
- merge associativity; unmerge inverse
- batched from_values_grouped == sequential add_value
- score_value_batch == scalar score_value
- seeded-sample determinism
- sampler-vs-scorer goodness of fit
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributions_tpu.models import MODULES, dpd as dpd_mod
from distributions_tpu import util
from tests.util import assert_close, py_value

DATA_COUNT = 20          # reference test_models.py:63
SAMPLE_COUNT = 1000      # reference test_models.py:64
MIN_GOODNESS_OF_FIT = 1e-3

CASES = [(name, i)
         for name, module in sorted(MODULES.items())
         for i in range(len(module.EXAMPLES))]


def case_id(case):
    return '{}-{}'.format(*case)


parametrize_cases = pytest.mark.parametrize(
    'name,example_idx', CASES, ids=map(case_id, CASES))


# -- harness helpers --------------------------------------------------------

def load_shared(module, example, key=None, observe=False, realize=False):
    """Build a Shared from an example; optionally observe the example values
    into it (dpd's mutating Shared; a no-op elsewhere) or realize it."""
    shared = module.shared_from_dict(example['shared'])
    if key is None:
        key = jax.random.PRNGKey(0)
    if observe and hasattr(module, 'shared_add_value'):
        for value in example['values']:
            key, sub = jax.random.split(key)
            shared = module.shared_add_value(sub, shared, value)
    if realize and hasattr(module, 'shared_realize'):
        key, sub = jax.random.split(key)
        shared = module.shared_realize(sub, shared)
    return shared


def group_from_values(module, shared, values):
    group = module.group_init(shared)
    for value in values:
        group = module.add_value(shared, group, value)
    return group


def group_to_dict(module, group, shared):
    try:
        return module.group_to_dict(group)
    except TypeError:
        return module.group_to_dict(group, shared)


def group_from_dict(module, raw, shared):
    try:
        return module.group_from_dict(raw)
    except TypeError:
        return module.group_from_dict(raw, shared)


def groups_close(module, g1, g2, shared, err_msg=''):
    assert_close(group_to_dict(module, g1, shared),
                 group_to_dict(module, g2, shared), err_msg=err_msg)


def sample_values(module, shared, group, key, n):
    keys = jax.random.split(key, n)
    return [module.sample_value(k, shared, group) for k in keys]


# -- tests ------------------------------------------------------------------

@parametrize_cases
def test_interface(name, example_idx):
    module = MODULES[name]
    for attr in ['NAME', 'EXAMPLES', 'Value', 'Shared', 'Group',
                 'shared_from_dict', 'shared_to_dict', 'group_init',
                 'add_value', 'add_repeated_value', 'remove_value', 'merge',
                 'score_value', 'score_data', 'sample_value', 'sample_group',
                 'from_values_grouped']:
        assert hasattr(module, attr), attr


@parametrize_cases
def test_shared_dict_roundtrip(name, example_idx):
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = module.shared_from_dict(example['shared'])
    dumped = module.shared_to_dict(shared)
    assert_close(dumped, example['shared'])
    # round trip again
    shared2 = module.shared_from_dict(dumped)
    assert_close(module.shared_to_dict(shared2), dumped)


@parametrize_cases
def test_group_dict_roundtrip(name, example_idx):
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True)
    group = group_from_values(module, shared, example['values'])
    dumped = group_to_dict(module, group, shared)
    group2 = group_from_dict(module, dumped, shared)
    assert_close(group_to_dict(module, group2, shared), dumped)


@parametrize_cases
def test_chain_rule(name, example_idx):
    # score_data == sum_i score_value(x_i | x_<i)
    # (reference test_models.py:229-251)
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True, realize=True)
    group = module.group_init(shared)
    assert_close(module.score_data(shared, group), 0.0,
                 err_msg='p(empty) != 1')
    score = 0.0
    for value in example['values']:
        score += float(module.score_value(shared, group, value))
        group = module.add_value(shared, group, value)
    assert_close(score, module.score_data(shared, group), tol=5e-3,
                 err_msg='p(x1..xn) != prod p(xi|x<i)')


@parametrize_cases
def test_add_remove(name, example_idx):
    # (reference test_models.py:253-270)
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True, realize=True)
    values = list(example['values'])
    group = group_from_values(module, shared, values)
    group_all = group_from_dict(
        module, group_to_dict(module, group, shared), shared)

    rng = np.random.RandomState(0)
    rng.shuffle(values)
    for value in values:
        group = module.remove_value(shared, group, value)
    groups_close(module, group, module.group_init(shared), shared,
                 'group + values - values != group')

    rng.shuffle(values)
    for value in values:
        group = module.add_value(shared, group, value)
    groups_close(module, group, group_all, shared,
                 'group - values + values != group')


@parametrize_cases
def test_add_repeated(name, example_idx):
    # (reference test_models.py:273-288)
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True, realize=True)
    for value in example['values'][:3]:
        group = module.group_init(shared)
        for _ in range(DATA_COUNT):
            group = module.add_value(shared, group, value)
        group_repeated = module.group_init(shared)
        group_repeated = module.add_repeated_value(
            shared, group_repeated, value, DATA_COUNT)
        groups_close(module, group, group_repeated, shared,
                     'n * add_value != add_repeated_value n')


@parametrize_cases
def test_add_merge(name, example_idx):
    # (reference test_models.py:291-308)
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True)
    values = list(example['values'])
    rng = np.random.RandomState(0)
    rng.shuffle(values)
    group = group_from_values(module, shared, values)
    for i in range(len(values) + 1):
        g1 = group_from_values(module, shared, values[:i])
        g2 = group_from_values(module, shared, values[i:])
        merged = module.merge(shared, g1, g2)
        groups_close(module, group, merged, shared)


@parametrize_cases
def test_unmerge(name, example_idx):
    module = MODULES[name]
    if not hasattr(module, 'unmerge'):
        pytest.skip('no unmerge')
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True)
    values = list(example['values'])
    i = len(values) // 2
    g1 = group_from_values(module, shared, values[:i])
    g2 = group_from_values(module, shared, values[i:])
    merged = module.merge(shared, g1, g2)
    back = module.unmerge(shared, merged, g2)
    groups_close(module, back, g1, shared, 'unmerge(merge(a,b),b) != a')


@parametrize_cases
def test_from_values_grouped(name, example_idx):
    # batched segment construction == sequential add_value
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True)
    values = example['values']
    rng = np.random.RandomState(0)
    assignments = rng.randint(0, 3, size=len(values))
    if module is dpd_mod or name == 'niw':
        varr = jnp.asarray(np.stack([np.asarray(v) for v in values])
                           if name == 'niw' else np.asarray(values))
    else:
        varr = jnp.asarray(np.asarray(values))
    batched = module.from_values_grouped(
        shared, varr, jnp.asarray(assignments), 3)
    for k in range(3):
        expected = group_from_values(
            module, shared,
            [v for v, a in zip(values, assignments) if a == k])
        got = jax.tree_util.tree_map(lambda x: x[k], batched)
        groups_close(module, got, expected, shared,
                     'segment group {} mismatch'.format(k))


@parametrize_cases
def test_score_value_batch(name, example_idx):
    # [K]-batched scoring == scalar score_value per group
    module = MODULES[name]
    if not hasattr(module, 'score_value_batch'):
        pytest.skip('no score_value_batch')
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True)
    values = example['values']
    K = 3
    rng = np.random.RandomState(1)
    assignments = rng.randint(0, K, size=len(values))
    groups = [group_from_values(
        module, shared,
        [v for v, a in zip(values, assignments) if a == k])
        for k in range(K)]
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *groups)
    if name == 'niw':
        varr = jnp.asarray(np.stack([np.asarray(v) for v in values]),
                           jnp.float32)
    else:
        varr = jnp.asarray(np.asarray(values))
    scores = module.score_value_batch(shared, batched, varr)
    assert scores.shape == (len(values), K)
    for b, value in enumerate(values):
        for k in range(K):
            expected = module.score_value(shared, groups[k], value)
            assert_close(scores[b, k], expected, tol=5e-3,
                         err_msg='b={} k={}'.format(b, k))


@parametrize_cases
def test_group_allows_debt(name, example_idx):
    # negative counts are legal intermediate states for bool/int models
    # (reference test_models.py:332-355)
    module = MODULES[name]
    if module.Value not in (bool, int):
        pytest.skip('debt only for discrete models')
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True, realize=True)
    values = list(example['values'])
    group1 = group_from_values(module, shared, values)

    group2 = module.group_init(shared)
    signed = [(v, +1) for v in values] * 3 + [(v, -1) for v in values] * 2
    rng = np.random.RandomState(0)
    rng.shuffle(signed)
    for value, sign in signed:
        if sign > 0:
            group2 = module.add_value(shared, group2, value)
        else:
            group2 = module.remove_value(shared, group2, value)
    groups_close(module, group1, group2, shared, 'debt accounting broke')


@parametrize_cases
def test_sample_seed(name, example_idx):
    # same key -> same samples (reference test_models.py:358-370)
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True)
    key = jax.random.PRNGKey(7)
    group = module.group_init(shared)
    v1 = sample_values(module, shared, group, key, 5)
    v2 = sample_values(module, shared, group, key, 5)
    for a, b in zip(v1, v2):
        assert_close(np.asarray(a), np.asarray(b), tol=0)


@parametrize_cases
def test_sample_value_gof(name, example_idx):
    # sampler matches scorer (reference test_models.py:373-397)
    module = MODULES[name]
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True, realize=True)
    key = jax.random.PRNGKey(1)
    for values in [[], example['values']]:
        group = group_from_values(module, shared, values)
        keys = jax.random.split(key, SAMPLE_COUNT)
        samples = jax.vmap(
            lambda k: module.sample_value(k, shared, group))(keys)
        samples_np = np.asarray(samples)
        if module.Value in (bool, int):
            uniq = sorted(set(py_value(s) for s in samples_np))
            probs_dict = {
                v: math.exp(float(module.score_value(shared, group, v)))
                for v in uniq
            }
            gof = util.discrete_goodness_of_fit(
                [py_value(s) for s in samples_np], probs_dict)
        elif module.Value is float:
            probs = np.exp(np.asarray(
                module.score_value(shared, group, samples)))
            gof = util.density_goodness_of_fit(samples_np, probs)
        else:
            # multivariate (niw): Mahalanobis GoF.  Under the MVT
            # predictive with dof nu_n - d + 1, location mu_n and shape
            # Sigma_n (the same parameters score_value uses),
            # (x - mu)' Sigma^{-1} (x - mu) / d ~ F(d, dof); the F-cdf
            # maps samples to uniforms (reference covers every model's
            # sampler this way, test_models.py:373-419 — niw was the gap).
            import scipy.stats
            post = module.plus_group(shared, group)
            d = samples_np.shape[-1]
            dof = float(np.asarray(post.nu).ravel()[0]) - d + 1.0
            kappa = float(np.asarray(post.kappa).ravel()[0])
            mu = np.asarray(post.mu, np.float64).reshape(d)
            sigma = (np.asarray(post.psi, np.float64).reshape(d, d)
                     * (kappa + 1.0) / (kappa * dof))
            diff = samples_np.astype(np.float64) - mu
            maha = np.einsum('nd,de,ne->n', diff, np.linalg.inv(sigma), diff)
            u = scipy.stats.f.cdf(maha / d, d, dof)
            gof = util.unif01_goodness_of_fit(u)
        assert gof > MIN_GOODNESS_OF_FIT, '{} gof = {:.3g}'.format(name, gof)


@parametrize_cases
def test_sample_group_gof(name, example_idx):
    # joint sampler matches score_data (reference test_models.py:400-420)
    module = MODULES[name]
    if module.Value not in (bool, int):
        pytest.skip('gof only for discrete models')
    example = module.EXAMPLES[example_idx]
    shared = load_shared(module, example, observe=True, realize=True)
    SIZE = 2
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, SAMPLE_COUNT)
    samples = []
    probs_dict = {}
    for k in keys:
        values = module.sample_group(k, shared, SIZE)
        values_list = [py_value(v) for v in np.asarray(values)]
        sample = tuple(values_list)
        samples.append(sample)
        if sample not in probs_dict:
            group = group_from_values(module, shared, values_list)
            probs_dict[sample] = math.exp(
                float(module.score_data(shared, group)))
    gof = util.discrete_goodness_of_fit(samples, probs_dict)
    assert gof > MIN_GOODNESS_OF_FIT, '{} gof = {:.3g}'.format(name, gof)


def test_nich_per_column_shareds():
    """Per-column hyperparameters within one nich block: leaves shaped
    [cols] broadcast through groups and scoring, equal to separate
    single-column blocks."""
    from distributions_tpu.models import nich

    sh = nich.Shared(mu=jnp.asarray([0.0, 5.0]),
                     kappa=jnp.asarray([1.0, 0.1]),
                     sigmasq=jnp.asarray([1.0, 4.0]),
                     nu=jnp.asarray([1.0, 1.0]))
    vals = jnp.asarray(np.random.RandomState(0).randn(10, 2), jnp.float32)
    g = nich.from_values_grouped(sh, vals, jnp.zeros(10, jnp.int32), 4)

    combined = np.asarray(nich.score_value(sh, g, vals[0])).sum(-1)
    parts = []
    for j, (mu, ka, sg) in enumerate([(0., 1., 1.), (5., .1, 4.)]):
        shj = nich.shared_from_dict(
            {'mu': mu, 'kappa': ka, 'sigmasq': sg, 'nu': 1.})
        gj = nich.from_values_grouped(
            shj, vals[:, j:j + 1], jnp.zeros(10, jnp.int32), 4)
        parts.append(np.asarray(
            nich.score_value(shj, gj, vals[0, j:j + 1])).sum(-1))
    np.testing.assert_allclose(combined, parts[0] + parts[1],
                               rtol=1e-5, atol=1e-5)
