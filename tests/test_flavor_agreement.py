"""Flavor agreement: the independent float64 numpy/scipy `hp` flavor must
agree with the JAX core on every model x example (the analog of
reference tests/test_model_flavors.py:40-136, which pushed the same data
through dbg/hp/lp and asserted suff stats, score_value, and score_data
agree).

Unlike tests/test_modes.py (eager-vs-jit of the SAME code), these tests
cross-check two implementations that share no code — a shared
transcription error in the core cannot pass here unless it was made twice
independently.  Also re-derives the core's LowEntropy partition table and
Stirling approximation from exact hp computations.
"""

import os
import sys

import numpy as np
import pytest

import jax

from distributions_tpu.models import MODULES as CORE
from distributions_tpu import clustering as core_cl
from distributions_tpu import special as core_special
from distributions_tpu.hp.models import MODULES as HP
from distributions_tpu.hp import clustering as hp_cl
from distributions_tpu.hp import special as hp_special
from tests.util import assert_close
from tests.test_models import load_shared, group_from_values, group_to_dict

# core is float32: agreement tolerance reflects its precision, not hp's
TOL = 1e-3

CASES = [(name, i)
         for name, module in sorted(CORE.items())
         for i in range(len(module.EXAMPLES))]
parametrize_cases = pytest.mark.parametrize(
    'name,example_idx', CASES, ids=['{}-{}'.format(*c) for c in CASES])


def test_hp_package_is_jax_free():
    """The hp flavor must not import jax anywhere (it is the independent
    oracle; importing the core would defeat the cross-check)."""
    import distributions_tpu.hp  # noqa: F401
    root = os.path.join(os.path.dirname(
        sys.modules['distributions_tpu'].__file__), 'hp')
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith('.py'):
                continue
            src = open(os.path.join(dirpath, fname)).read()
            for line in src.splitlines():
                line = line.strip()
                if not (line.startswith('import ')
                        or line.startswith('from ')):
                    continue  # prose mentions in docstrings are fine
                assert 'jax' not in line, (fname, line)
                assert 'distributions_tpu.models' not in line, (fname, line)
                assert not line.startswith(
                    'from distributions_tpu.special'), (fname, line)
                assert not line.startswith(
                    'from distributions_tpu import'), (fname, line)


def hp_shared_for(name, example, core_shared):
    """hp Shared matching the core's — via the shared dict schema, so
    dpd's randomly-broken sticks transfer exactly."""
    core_mod = CORE[name]
    return HP[name].shared_from_dict(core_mod.shared_to_dict(core_shared))


def hp_group_from_values(module, shared, values):
    group = module.group_init(shared)
    for value in values:
        group = module.add_value(shared, group, value)
    return group


@parametrize_cases
def test_suff_stats_agree(name, example_idx):
    core_mod, hp_mod = CORE[name], HP[name]
    example = core_mod.EXAMPLES[example_idx]
    core_shared = load_shared(core_mod, example, observe=True)
    hp_shared = hp_shared_for(name, example, core_shared)
    core_group = group_from_values(core_mod, core_shared, example['values'])
    hp_group = hp_group_from_values(hp_mod, hp_shared, example['values'])
    assert_close(group_to_dict(core_mod, core_group, core_shared),
                 group_to_dict(hp_mod, hp_group, hp_shared), tol=TOL)


@parametrize_cases
def test_score_value_agrees(name, example_idx):
    core_mod, hp_mod = CORE[name], HP[name]
    example = core_mod.EXAMPLES[example_idx]
    core_shared = load_shared(core_mod, example, observe=True)
    hp_shared = hp_shared_for(name, example, core_shared)
    core_group = group_from_values(core_mod, core_shared, example['values'])
    hp_group = hp_group_from_values(hp_mod, hp_shared, example['values'])
    for value in example['values']:
        core_score = float(core_mod.score_value(
            core_shared, core_group, value))
        hp_score = hp_mod.score_value(hp_shared, hp_group, value)
        assert_close(core_score, hp_score, tol=TOL,
                     err_msg='{} score_value({})'.format(name, value))


@parametrize_cases
def test_score_value_agrees_on_partial_groups(name, example_idx):
    """Score under every prefix of the data — exercises empty groups and
    small-count posteriors where cancellation bugs hide."""
    core_mod, hp_mod = CORE[name], HP[name]
    example = core_mod.EXAMPLES[example_idx]
    core_shared = load_shared(core_mod, example, observe=True)
    hp_shared = hp_shared_for(name, example, core_shared)
    core_group = core_mod.group_init(core_shared)
    hp_group = hp_mod.group_init(hp_shared)
    for value in example['values']:
        core_score = float(core_mod.score_value(
            core_shared, core_group, value))
        hp_score = hp_mod.score_value(hp_shared, hp_group, value)
        assert_close(core_score, hp_score, tol=TOL,
                     err_msg='{} prefix score_value({})'.format(name, value))
        core_group = core_mod.add_value(core_shared, core_group, value)
        hp_group = hp_mod.add_value(hp_shared, hp_group, value)


@parametrize_cases
def test_score_data_agrees(name, example_idx):
    core_mod, hp_mod = CORE[name], HP[name]
    example = core_mod.EXAMPLES[example_idx]
    core_shared = load_shared(core_mod, example, observe=True)
    hp_shared = hp_shared_for(name, example, core_shared)
    core_group = group_from_values(core_mod, core_shared, example['values'])
    hp_group = hp_group_from_values(hp_mod, hp_shared, example['values'])
    assert_close(float(core_mod.score_data(core_shared, core_group)),
                 hp_mod.score_data(hp_shared, hp_group), tol=TOL,
                 err_msg='{} score_data'.format(name))


@parametrize_cases
def test_plus_group_agrees(name, example_idx):
    core_mod, hp_mod = CORE[name], HP[name]
    if not hasattr(core_mod, 'plus_group') or not hasattr(hp_mod,
                                                          'plus_group'):
        pytest.skip('no conjugate plus_group for ' + name)
    example = core_mod.EXAMPLES[example_idx]
    core_shared = load_shared(core_mod, example, observe=True)
    hp_shared = hp_shared_for(name, example, core_shared)
    core_group = group_from_values(core_mod, core_shared, example['values'])
    hp_group = hp_group_from_values(hp_mod, hp_shared, example['values'])
    core_post = core_mod.plus_group(core_shared, core_group)
    hp_post = hp_mod.plus_group(hp_shared, hp_group)
    assert_close(core_mod.shared_to_dict(core_post),
                 hp_mod.shared_to_dict(hp_post), tol=TOL)


@parametrize_cases
def test_hp_chain_rule_exact(name, example_idx):
    """In float64 the chain-rule identity score_data == sum of incremental
    score_value holds to ~1e-9 — far tighter than the core's f32 test."""
    hp_mod = HP[name]
    example = hp_mod.EXAMPLES[example_idx]
    if name == 'dpd':
        rng = np.random.default_rng(0)
        shared = hp_mod.shared_from_dict(example['shared'])
        for value in example['values']:
            shared = hp_mod.shared_add_value(rng, shared, value)
    else:
        shared = hp_mod.shared_from_dict(example['shared'])
    group = hp_mod.group_init(shared)
    total = 0.0
    for value in example['values']:
        total += hp_mod.score_value(shared, group, value)
        group = hp_mod.add_value(shared, group, value)
    assert_close(total, hp_mod.score_data(shared, group), tol=1e-8,
                 err_msg='{} hp chain rule'.format(name))


# -- clustering priors -------------------------------------------------------

COUNT_VECTORS = [
    [1], [2], [1, 1], [5, 1, 1], [10, 3, 2, 1, 1],
    [2, 2, 2, 2], [100, 1], [17, 13, 7, 5, 3, 2, 1, 1, 1],
]


@pytest.mark.parametrize('example', core_cl.PitmanYor.EXAMPLES,
                         ids=lambda e: 'a{alpha}-d{d}'.format(**e))
def test_py_score_counts_agrees(example):
    core_model = core_cl.PitmanYor.from_dict(example)
    hp_model = hp_cl.PitmanYor.from_dict(example)
    for counts in COUNT_VECTORS:
        core_score = float(core_cl.py_score_counts(
            core_model, np.asarray(counts, np.float32)))
        hp_score = hp_model.score_counts(counts)
        assert_close(core_score, hp_score, tol=TOL,
                     err_msg='py score_counts {}'.format(counts))


@pytest.mark.parametrize('example', core_cl.PitmanYor.EXAMPLES,
                         ids=lambda e: 'a{alpha}-d{d}'.format(**e))
def test_py_score_add_remove_agree(example):
    core_model = core_cl.PitmanYor.from_dict(example)
    hp_model = hp_cl.PitmanYor.from_dict(example)
    for group_size, nonempty, n in [(0, 1, 1), (0, 3, 10), (1, 1, 1),
                                    (2, 3, 10), (7, 2, 50), (49, 5, 100)]:
        assert_close(
            float(core_cl.py_score_add_value(core_model, group_size,
                                             nonempty, n)),
            hp_model.score_add_value(group_size, nonempty, n), tol=TOL)
        if group_size > 0:
            assert_close(
                float(core_cl.py_score_remove_value(core_model, group_size,
                                                    nonempty, n)),
                hp_model.score_remove_value(group_size, nonempty, n),
                tol=TOL)


@pytest.mark.parametrize('example', core_cl.LowEntropy.EXAMPLES,
                         ids=lambda e: 'N{dataset_size}'.format(**e))
def test_le_score_counts_agrees(example):
    core_model = core_cl.LowEntropy.from_dict(example)
    hp_model = hp_cl.LowEntropy.from_dict(example)
    for counts in COUNT_VECTORS:
        core_score = float(core_cl.le_score_counts(
            core_model, np.asarray(counts, np.float32)))
        hp_score = hp_model.score_counts(counts)
        # full partitions of N=1000 hit the asymptotic branch with large
        # magnitudes (~7000); compare relatively there
        tol = TOL * max(1.0, abs(hp_score) * 1e-2)
        assert_close(core_score, hp_score, tol=tol,
                     err_msg='le score_counts {}'.format(counts))


def test_le_partition_table_rederived():
    """The core's _LOG_PARTITION_TABLE (transcribed from the reference) must
    equal the hp flavor's from-scratch exact DP at every tabulated n."""
    table = core_cl._LOG_PARTITION_TABLE
    for n in range(len(table)):
        exact = hp_cl.exact_log_partition_function(n)
        assert_close(float(table[n]), exact, tol=1e-5 * max(1.0, exact),
                     err_msg='partition table n={}'.format(n))


def test_le_asymptotic_matches_exact_at_boundary():
    """The asymptotic branch should be within ~1% of exact just past the
    table (the reference accepts the same error: src/clustering.cc:202)."""
    hp_model = hp_cl.LowEntropy(dataset_size=100)
    exact = hp_cl.exact_log_partition_function(47)
    n = 47.0
    approx = n * np.log(n) * (1.0 + hp_model.APPROX_COEFF * n ** -0.75)
    assert abs(approx - exact) / exact < 0.01


def test_stirling_row_core_vs_hp_exact():
    """hp computes log |s(n,k)| exactly at any n via bignum recurrence; the
    core is exact below 32 and asymptotic above."""
    for n in [1, 2, 5, 10, 31]:
        core_row = np.asarray(core_special.log_stirling1_row(n))
        hp_row = hp_special.log_stirling1_row(n)
        mask = np.isfinite(hp_row)
        np.testing.assert_allclose(core_row[mask], hp_row[mask],
                                   rtol=1e-4, atol=1e-4)
    for n in [35, 48, 64]:
        core_row = np.asarray(core_special.log_stirling1_row(n))
        hp_row = hp_special.log_stirling1_row(n)
        # the core's softmin-asymptotic rows degrade toward k -> n (the
        # reference's approximation has the same edge behavior, reference
        # src/special.cc:88-130): bound interior at 2%, edge at 4%;
        # k = n is exactly log 1 = 0 in both.  k = 0 is -inf in both and
        # is sliced out BEFORE differencing (inf - inf would be a NaN);
        # the compared range must be finite.
        assert np.isfinite(core_row[1:]).all() and \
            np.isfinite(hp_row[1:]).all(), n
        rel = (np.abs(core_row[1:n] - hp_row[1:n])
               / (np.abs(hp_row[1:n]) + 1.0))
        assert rel[2:n - 4].max() < 0.02, (n, rel[2:n - 4].max())
        assert rel.max() < 0.04, (n, rel.max())
        assert abs(core_row[n]) < 1e-4 and abs(hp_row[n]) < 1e-12


def test_lgamma_nu_agrees():
    nus = np.concatenate([np.linspace(0.1, 10, 40),
                          np.logspace(1, 6, 30)]).astype(np.float32)
    core_vals = np.asarray(core_special.lgamma_nu(nus))
    hp_vals = hp_special.lgamma_nu(nus)
    np.testing.assert_allclose(core_vals, hp_vals, rtol=2e-4, atol=2e-4)


def test_hp_sample_assignments_seeded_deterministic():
    for model in [hp_cl.PitmanYor(1.0, 0.1), hp_cl.LowEntropy(30)]:
        a1 = model.sample_assignments(np.random.default_rng(7), 30)
        a2 = model.sample_assignments(np.random.default_rng(7), 30)
        assert a1 == a2
        counts = hp_cl.count_assignments(a1)
        assert int(np.sum(counts)) == 30


def test_hp_py_sampler_matches_scorer_gof():
    """hp PitmanYor sample_assignments frequencies match exp(score_counts)
    on a small partition space (reference tests/test_clustering.py:139-164
    technique, applied to the hp flavor)."""
    from distributions_tpu.util import multinomial_goodness_of_fit
    model = hp_cl.PitmanYor(1.0, 0.2)
    size = 4
    rng = np.random.default_rng(0)
    # canonical form: sorted count multiset of the partition
    from collections import Counter
    freq = Counter()
    n_samples = 3000
    for _ in range(n_samples):
        a = model.sample_assignments(rng, size)
        freq[tuple(sorted(np.bincount(a), reverse=True))] += 1
    keys = sorted(freq)
    # probability of a counts-multiset = EPPF * #set-partitions with those
    # block sizes = exp(score_counts) * n! / (prod c! * prod mult!)
    from distributions_tpu.hp.special import gammaln as gln
    probs = []
    for k in keys:
        log_eppf = model.score_counts(list(k))
        log_count = float(gln(size + 1)) - sum(
            float(gln(c + 1)) for c in k)
        mult = Counter(k)
        log_count -= sum(float(gln(m + 1)) for m in mult.values())
        probs.append(np.exp(log_eppf + log_count))
    probs = np.asarray(probs)
    assert probs.sum() > 0.99  # size-4 partition space fully enumerated
    counts = np.asarray([freq[k] for k in keys], np.float64)
    gof = multinomial_goodness_of_fit(
        probs / probs.sum(), counts, n_samples)
    assert gof > 1e-3, gof


# -- mixture-level agreement --------------------------------------------------

def _hp_mixture_scores(cl_hp, hp_mods, hp_shareds, hp_groups, counts, alive,
                       empties_alive, rows):
    """Naive hp scorer for a full mixture state: clustering seating score
    per alive slot (empty mass split across alive empties) + sum of
    per-feature predictives; dead slots -inf.  This re-implements
    mixture.score_batch from scalar hp calls."""
    n = int(sum(counts))
    nonempty = int(sum(1 for c in counts if c > 0))
    C = len(counts)
    out = np.full((len(rows), C), -np.inf)
    for b, row in enumerate(rows):
        for k in range(C):
            if not alive[k]:
                continue
            s = cl_hp.score_add_value(int(counts[k]), nonempty, n,
                                      max(empties_alive, 1))
            for mod, shared, groups, v in zip(
                    hp_mods, hp_shareds, hp_groups, row):
                s += mod.score_value(shared, groups[k], v)
            out[b, k] = s
    return out


@pytest.mark.parametrize('prior', ['py', 'le'])
def test_mixture_score_batch_agrees_with_hp(prior):
    """Core mixture.score_batch (masked fixed-capacity arithmetic, batched
    feature blocks, empty-slot mass splitting) against a naive scalar hp
    reconstruction of the same state."""
    from distributions_tpu import mixture as mx
    from distributions_tpu.models import nich as core_nich, gp as core_gp
    from distributions_tpu.hp.models import nich as hp_nich, gp as hp_gp

    rng = np.random.RandomState(0)
    R, C = 12, 8
    x = rng.randn(R, 2).astype(np.float32)
    y = rng.poisson(3.0, (R, 1)).astype(np.int32)
    assignments = rng.randint(0, 4, R)

    spec = mx.make_spec([(core_nich, 2), (core_gp, 1)], capacity=C,
                        empties=2)
    core_shareds = (
        core_nich.shared_from_dict(
            {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.}),
        core_gp.shared_from_dict({'alpha': 1., 'inv_beta': 1.}),
    )
    if prior == 'py':
        cl_core = core_cl.PitmanYor.from_dict({'alpha': 1.5, 'd': 0.2})
        cl_hp = hp_cl.PitmanYor(1.5, 0.2)
    else:
        cl_core = core_cl.LowEntropy.from_dict({'dataset_size': 100})
        cl_hp = hp_cl.LowEntropy(100)
    state = mx.state_from_assignments(
        spec, cl_core, core_shareds, (x, y), assignments)
    core_scores = np.asarray(mx.score_batch(
        spec, cl_core, core_shareds, state, (x, y)))

    # hp reconstruction of the same state
    hp_shareds = (
        hp_nich.shared_from_dict(
            {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.}),
        hp_gp.shared_from_dict({'alpha': 1., 'inv_beta': 1.}),
    )
    counts = np.asarray(state.counts)
    alive = np.asarray(state.alive)
    # groups per (feature column, slot); a nich block with 2 cols is two
    # independent scalar features in hp terms
    feature_values = [x[:, 0], x[:, 1], y[:, 0]]
    hp_mods = [hp_nich, hp_nich, hp_gp]
    hp_col_shareds = [hp_shareds[0], hp_shareds[0], hp_shareds[1]]
    hp_groups = []
    for mod, shared, vals in zip(hp_mods, hp_col_shareds, feature_values):
        groups = [mod.group_init(shared) for _ in range(C)]
        for v, a in zip(vals, assignments):
            groups[a] = mod.add_value(shared, groups[a], v)
        hp_groups.append(groups)
    rows = [[x[b, 0], x[b, 1], int(y[b, 0])] for b in range(R)]
    empties_alive = int(np.sum(alive & (counts == 0)))
    hp_scores = _hp_mixture_scores(
        cl_hp, hp_mods, hp_col_shareds, hp_groups, counts, alive,
        empties_alive, rows)

    mask = np.isfinite(hp_scores)
    assert (np.isfinite(core_scores) == mask).all()
    np.testing.assert_allclose(core_scores[mask], hp_scores[mask],
                               rtol=2e-3, atol=2e-3)
