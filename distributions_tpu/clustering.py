"""Clustering priors: Pitman-Yor (CRP) and the Low-Entropy MDL prior.

Semantics match the reference (include/distributions/clustering.hpp:44-331,
src/clustering.cc:66-283, distributions/dbg/clustering.py:33-302).

Vectorized formulation
----------------------
The reference's `score_add_value(group_size, nonempty_group_count,
sample_size, empty_group_count)` is a scalar; here `score_add_value` accepts
a whole [K] (or [B, K]) counts vector at once and returns all K scores in one
fused graph — this subsumes the reference's `CachedMixture` whose
`shifted_scores_` cache (clustering.hpp:126-234) exists only to avoid scalar
recomputation on CPUs.

`sample_assignments` is a `lax.scan` over items with a fixed capacity K —
the sequential CRP semantics preserved exactly, on device.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from distributions_tpu.special import gammaln, logsumexp
from distributions_tpu.random import sample_from_scores


class PitmanYor(NamedTuple):
    """Pitman-Yor process {alpha, d}; d=0 gives the CRP
    (reference clustering.hpp:58-123)."""
    alpha: jnp.ndarray
    d: jnp.ndarray

    @classmethod
    def from_dict(cls, raw):
        return cls(alpha=jnp.float32(raw['alpha']), d=jnp.float32(raw['d']))

    def to_dict(self):
        return {'alpha': float(self.alpha), 'd': float(self.d)}


class LowEntropy(NamedTuple):
    """Parameter-free MDL clustering prior P(X) ∝ exp(-N H(X))
    (reference dbg/clustering.py:33-302)."""
    dataset_size: jnp.ndarray

    @classmethod
    def from_dict(cls, raw):
        return cls(dataset_size=jnp.int32(raw['dataset_size']))

    def to_dict(self):
        return {'dataset_size': int(self.dataset_size)}


PitmanYor.EXAMPLES = [
    {'alpha': 1., 'd': 0.},
    {'alpha': 1., 'd': 0.1},
    {'alpha': 1., 'd': 0.9},
    {'alpha': 10., 'd': 0.1},
    {'alpha': 0.1, 'd': 0.1},
]
LowEntropy.EXAMPLES = [
    {'dataset_size': 5},
    {'dataset_size': 1000},
]


# ===========================================================================
# Pitman-Yor

def py_score_add_value(model, group_size, nonempty_group_count, sample_size,
                       empty_group_count=1):
    """Log prob of seating a customer at a table with `group_size` occupants
    (reference clustering.hpp:81-104).  Fully batched over `group_size`."""
    group_size = jnp.asarray(group_size, jnp.float32)
    nonempty = jnp.asarray(nonempty_group_count, jnp.float32)
    n = jnp.asarray(sample_size, jnp.float32)
    e = jnp.asarray(empty_group_count, jnp.float32)
    new_score = jnp.log((model.alpha + model.d * nonempty) / ((n + model.alpha) * e))
    old_score = jnp.log((group_size - model.d) / (n + model.alpha))
    return jnp.where(group_size == 0, new_score, old_score)


def py_score_remove_value(model, group_size, nonempty_group_count,
                          sample_size, empty_group_count=1):
    """Reverse transition probability (reference clustering.hpp:106-123)."""
    group_size = jnp.asarray(group_size, jnp.float32) - 1
    nonempty = jnp.asarray(nonempty_group_count, jnp.float32)
    nonempty = jnp.where(group_size == 0, nonempty - 1, nonempty)
    return -py_score_add_value(
        model, group_size, nonempty,
        jnp.asarray(sample_size, jnp.float32) - 1, empty_group_count)


def py_score_counts(model, counts):
    """Log prob of a partition given its counts, via lgamma ratios
    (reference src/clustering.cc:152-183).  Vectorized: the reference's
    per-group sequential loop becomes closed-form sums.

    For counts [c_1..c_K] (zeros ignored) with n = sum c_k, K' nonempty:
      score = sum_k log(alpha + d*k')             (k' = 0..K'-1)
            + sum_k [lgamma(c_k - d) - lgamma(1 - d)]
            + lgamma(alpha) - lgamma(alpha + n)
    which matches the reference's incremental accumulation exactly.
    """
    counts = jnp.asarray(counts, jnp.float32)
    nonzero = counts > 0
    nonempty_count = jnp.sum(nonzero, axis=-1).astype(jnp.float32)
    n = jnp.sum(counts, axis=-1)
    K = counts.shape[-1]
    k_idx = jnp.arange(K, dtype=jnp.float32)
    # sum over nonempty groups of log(alpha + d * k), k = 0..K'-1
    new_table_terms = jnp.sum(
        jnp.where(k_idx < nonempty_count[..., None],
                  jnp.log(model.alpha + model.d * k_idx), 0.0), axis=-1)
    size_terms = jnp.sum(
        jnp.where(nonzero,
                  gammaln(jnp.maximum(counts, 1) - model.d)
                  - gammaln(1.0 - model.d), 0.0), axis=-1)
    denom = gammaln(model.alpha + n) - gammaln(model.alpha)
    return new_table_terms + size_terms - denom


def py_score_value(model, counts, alive, sample_size, scores_dtype=jnp.float32):
    """Vectorized per-slot seating scores over a fixed-capacity counts vector
    (replaces reference CachedMixture.score_value, clustering.hpp:195-208).

    counts: [K] int; alive: [K] bool mask of slots that are present (empty
    *or* nonempty); dead slots score -inf.  The empty-slot score is split
    across the number of alive empty slots, matching the reference's
    `_update_empty_groups` (clustering.hpp:221-230).
    """
    counts = jnp.asarray(counts, jnp.float32)
    alive = jnp.asarray(alive, bool)
    is_empty = alive & (counts == 0)
    empty_count = jnp.maximum(
        jnp.sum(is_empty, axis=-1).astype(jnp.float32), 1.0)
    nonempty_count = jnp.sum(alive & (counts > 0), axis=-1).astype(jnp.float32)
    n = jnp.asarray(sample_size, jnp.float32)
    shift = -jnp.log(n + model.alpha)
    empty_score = jnp.log(
        (model.alpha + model.d * nonempty_count) / empty_count) + shift
    occupied_score = jnp.log(jnp.maximum(counts - model.d, 1e-30)) + shift
    scores = jnp.where(is_empty, empty_score[..., None], occupied_score)
    return jnp.where(alive, scores, -jnp.inf).astype(scores_dtype)


def py_score_value_sharded(model, counts, alive, sample_size,
                           global_empty, global_nonempty):
    """py_score_value for a LOCAL slot range of a component-sharded state:
    identical math, but the empty/nonempty slot counts are the caller's
    global (psum'd over the component axis) values so the empty-slot mass
    split matches the unsharded scorer exactly."""
    counts = jnp.asarray(counts, jnp.float32)
    alive = jnp.asarray(alive, bool)
    is_empty = alive & (counts == 0)
    n = jnp.asarray(sample_size, jnp.float32)
    shift = -jnp.log(n + model.alpha)
    empty_score = jnp.log(
        (model.alpha + model.d * global_nonempty.astype(jnp.float32))
        / jnp.maximum(global_empty.astype(jnp.float32), 1.0)) + shift
    occupied_score = jnp.log(jnp.maximum(counts - model.d, 1e-30)) + shift
    scores = jnp.where(is_empty, empty_score, occupied_score)
    return jnp.where(alive, scores, -jnp.inf)


def py_sample_assignments(key, model, size, capacity=None):
    """Sequential CRP/PY assignment sampling via lax.scan (reference
    src/clustering.cc:69-142).  Capacity-padded: tables beyond `capacity`
    cannot be created (choose capacity >> expected table count
    ~ alpha log n for CRP)."""
    if capacity is None:
        capacity = int(max(64, 16 * (float(model.alpha) + 1.0)
                           * (np.log(size + 1.0) + 1.0)))

    def step(carry, step_key):
        counts, table_count, i = carry
        k_idx = jnp.arange(capacity, dtype=jnp.float32)
        occupied = counts > 0
        # likelihoods: occupied tables count - d; slot `table_count` is the
        # single new table with alpha + d * table_count; others 0.
        is_new = k_idx == table_count.astype(jnp.float32)
        logits = jnp.where(
            occupied, jnp.log(jnp.maximum(counts - model.d, 1e-30)),
            jnp.where(is_new,
                      jnp.log(model.alpha
                              + model.d * table_count.astype(jnp.float32)),
                      -jnp.inf))
        assign = sample_from_scores(step_key, logits)
        counts = counts.at[assign].add(1.0)
        table_count = table_count + (assign == table_count).astype(jnp.int32)
        return (counts, table_count, i + 1), assign

    counts0 = jnp.zeros(capacity, jnp.float32)
    keys = jax.random.split(key, size)
    (_, _, _), assignments = lax.scan(
        step, (counts0, jnp.int32(0), jnp.int32(0)), keys)
    return assignments


# ===========================================================================
# Low-Entropy

# this table matches the reference's generated table
# (reference src/clustering.cc:189-200, derivations/clustering.py)
_LOG_PARTITION_TABLE = np.array([
    0.00000000, 0.00000000, 1.60943791, 3.68887945, 6.07993320,
    8.70549682, 11.51947398, 14.49108422, 17.59827611, 20.82445752,
    24.15668300, 27.58456586, 31.09958507, 34.69462231, 38.36364086,
    42.10145572, 45.90356476, 49.76602176, 53.68533918, 57.65841234,
    61.68245958, 65.75497413, 69.87368527, 74.03652635, 78.24160846,
    82.48719834, 86.77169993, 91.09363859, 95.45164780, 99.84445762,
    104.27088480, 108.72982416, 113.22024112, 117.74116515, 122.29168392,
    126.87093829, 131.47811772, 136.11245629, 140.77322911, 145.45974907,
    150.17136399, 154.90745399, 159.66742919, 164.45072752, 169.25681285,
    174.08517319, 178.93531914, 183.80678238], np.float32)


def le_log_partition_function(model, sample_size):
    """Exact for n < 48, asymptotic above (reference
    src/clustering.cc:202-215)."""
    n = jnp.asarray(sample_size, jnp.float32)
    table = jnp.asarray(_LOG_PARTITION_TABLE)
    idx = jnp.clip(jnp.asarray(sample_size, jnp.int32), 0, 47)
    exact = table[idx]
    coeff = 0.28269584
    log_z_max = n * jnp.log(jnp.maximum(n, 1.0))
    approx = log_z_max * (1.0 + coeff * jnp.power(jnp.maximum(n, 1.0), -0.75))
    return jnp.where(n < 48, exact, approx)


def _le_postpred_correction(model, sample_size):
    """reference dbg/clustering.py:273-284.

    The reference's two flavors DISAGREE here: the C++ production flavor
    divides in float (clustering.hpp:319 takes sample_size as float, so
    :326 `scale = dataset_size / sample_size` is float division) while the
    py2 dbg flavor floors (dbg/clustering.py:283 int/int) — masked in the
    reference's own suite by the 0.5-loosened LowEntropy tolerance
    (reference tests/test_clustering.py:174-179).  This implementation
    follows the production C++ semantics; the golden fixtures
    (tests/golden/) pin that choice against the reference C++ itself."""
    n = jnp.asarray(sample_size, jnp.float32)
    N = jnp.asarray(model.dataset_size, jnp.float32)
    exponent = 0.45 - 0.1 / n - 0.1 / N
    return jnp.log(N / n) * exponent


def _le_dataprob_correction(model, sample_size):
    """reference dbg/clustering.py:286-294."""
    n = jnp.log(jnp.asarray(sample_size, jnp.float32))
    N = jnp.log(jnp.asarray(model.dataset_size, jnp.float32))
    return 0.061 * n * (n - N) * jnp.power(n + N, 0.75)


def le_score_counts(model, counts):
    """reference dbg/clustering.py:148-168."""
    counts = jnp.asarray(counts, jnp.float32)
    sample_size = jnp.sum(counts, axis=-1)
    score = jnp.sum(
        jnp.where(counts > 1,
                  counts * jnp.log(jnp.maximum(counts, 1.0)), 0.0), axis=-1)
    partial = sample_size != jnp.asarray(model.dataset_size, jnp.float32)
    num_groups = jnp.asarray(counts.shape[-1], jnp.float32)
    correction = (_le_postpred_correction(model, sample_size)
                  * (num_groups - 1.0)
                  + _le_dataprob_correction(model, sample_size))
    score = score + jnp.where(partial, correction, 0.0)
    return score - le_log_partition_function(model, sample_size)


def le_score_add_value(model, group_size, nonempty_group_count, sample_size,
                       empty_group_count=1):
    """reference dbg/clustering.py:170-210; batched over group_size."""
    group_size = jnp.asarray(group_size, jnp.float32)
    n = jnp.asarray(sample_size, jnp.float32)
    e = jnp.asarray(empty_group_count, jnp.float32)
    N = jnp.asarray(model.dataset_size, jnp.float32)

    empty_score = -jnp.log(e) + jnp.where(
        n + 1.0 < N, _le_postpred_correction(model, n + 1.0), 0.0)

    bigger = 1.0 + group_size
    very_large = 10000.0
    occupied_score = jnp.where(
        group_size > very_large,
        1.0 + jnp.log(bigger),
        jnp.log(bigger / jnp.maximum(group_size, 1.0)) * group_size
        + jnp.log(bigger))
    return jnp.where(group_size == 0, empty_score, occupied_score)


def le_score_remove_value(model, group_size, nonempty_group_count,
                          sample_size, empty_group_count=1):
    """reference dbg/clustering.py:212-233."""
    return -le_score_add_value(
        model, jnp.asarray(group_size, jnp.float32) - 1.0,
        nonempty_group_count, sample_size, empty_group_count)


def le_score_value(model, counts, alive, sample_size,
                   scores_dtype=jnp.float32):
    """Vectorized per-slot scores for the low-entropy prior (analog of
    py_score_value; the reference uses the generic MixtureDriver slow path,
    clustering.hpp:313)."""
    counts = jnp.asarray(counts, jnp.float32)
    alive = jnp.asarray(alive, bool)
    is_empty = alive & (counts == 0)
    empty_count = jnp.maximum(
        jnp.sum(is_empty, axis=-1).astype(jnp.float32), 1.0)
    scores = le_score_add_value(
        model, counts, 0.0, sample_size, empty_count[..., None])
    return jnp.where(alive, scores, -jnp.inf).astype(scores_dtype)


def le_sample_assignments(key, model, sample_size, capacity=64):
    """Sequential sampling (reference dbg/clustering.py:111-143) via
    lax.scan over a fixed-capacity counts vector."""
    def step(carry, step_key):
        counts, n = carry
        alive_empty_slot = jnp.argmin(counts > 0)  # one empty slot competes
        alive = (counts > 0) | (jnp.arange(capacity) == alive_empty_slot)
        scores = le_score_value(model, counts, alive, n)
        assign = sample_from_scores(step_key, scores)
        counts = counts.at[assign].add(1)
        return (counts, n + 1), assign

    keys = jax.random.split(key, sample_size)
    (_, _), assignments = lax.scan(
        step, (jnp.zeros(capacity, jnp.int32), jnp.int32(0)), keys)
    return assignments


# ===========================================================================
# dispatch helpers — one API over both priors (used by mixture.py)

def score_value(model, counts, alive, sample_size, scores_dtype=jnp.float32):
    if isinstance(model, PitmanYor):
        return py_score_value(model, counts, alive, sample_size, scores_dtype)
    return le_score_value(model, counts, alive, sample_size, scores_dtype)


def score_counts(model, counts):
    if isinstance(model, PitmanYor):
        return py_score_counts(model, counts)
    return le_score_counts(model, counts)


def score_add_value(model, group_size, nonempty_group_count, sample_size,
                    empty_group_count=1):
    if isinstance(model, PitmanYor):
        return py_score_add_value(model, group_size, nonempty_group_count,
                                  sample_size, empty_group_count)
    return le_score_add_value(model, group_size, nonempty_group_count,
                              sample_size, empty_group_count)


def score_remove_value(model, group_size, nonempty_group_count, sample_size,
                       empty_group_count=1):
    if isinstance(model, PitmanYor):
        return py_score_remove_value(model, group_size, nonempty_group_count,
                                     sample_size, empty_group_count)
    return le_score_remove_value(model, group_size, nonempty_group_count,
                                 sample_size, empty_group_count)


def py_sample_assignments_stick(key, model, size, capacity=1024):
    """Vectorized Pitman-Yor assignment sampling via stick-breaking.

    The sequential CRP scan (`py_sample_assignments`, reference
    src/clustering.cc:69-142) is an R-step data-dependent chain — a
    million-step scan at R ~ 1e6, slow to compile and to run.  The
    batched answer uses the Pitman-Yor stick-breaking (GEM)
    representation instead:

        V_k ~ Beta(1 - d, alpha + (k+1) d),   k = 0, 1, ...
        w_k = V_k prod_{j<k} (1 - V_j)
        assignments_i ~ iid Categorical(w)

    By exchangeability (de Finetti for the PY partition), the induced
    PARTITION distribution is exactly the CRP's — two batched draws (one
    [capacity] beta vector, one [size] categorical) replace R sequential
    steps.  Labels come out in stick (size-biased) order rather than
    table-creation order; any label-invariant statistic matches
    (validated distributionally in tests/test_clustering.py).

    Truncation: the final stick absorbs all remaining mass; the mass
    beyond capacity K has expectation prod_{k<K} (alpha + (k+1)d) /
    (alpha + 1 + k d) — e.g. < 1e-9 at alpha=100, d=0 for K=1024."""
    kv, ka = jax.random.split(key)
    k = jnp.arange(capacity, dtype=jnp.float32)
    a = jnp.maximum(1.0 - model.d, 1e-6)
    b = model.alpha + (k + 1.0) * model.d
    v = jax.random.beta(kv, a, b)
    v = jnp.clip(v, 1e-7, 1.0 - 1e-7).at[capacity - 1].set(1.0)
    logw = jnp.log(v) + jnp.concatenate(
        [jnp.zeros(1), jnp.cumsum(jnp.log1p(-v)[:-1])])
    # inverse-CDF draw: one [capacity] cumsum, then a vectorized
    # compare-all search ([size, capacity] cheap compares instead of
    # jax.random.categorical's gumbel matrix (~8 ops/cell) or
    # searchsorted's default binary-search scan)
    cdf = jnp.cumsum(jnp.exp(logw - logsumexp(logw)))
    cdf = cdf.at[capacity - 1].set(1.0 + 1e-6)
    u = jax.random.uniform(ka, (size,))
    return jnp.searchsorted(cdf, u, side='right',
                            method='compare_all').astype(jnp.int32)


def sample_assignments(key, model, size, capacity=None):
    if isinstance(model, PitmanYor):
        return py_sample_assignments(key, model, size, capacity)
    return le_sample_assignments(key, model, size, capacity or 64)


def count_assignments(assignments, capacity):
    """counts[k] = #{i : assignments[i] == k} (reference
    clustering.hpp:51-52)."""
    return jax.ops.segment_sum(
        jnp.ones_like(assignments, jnp.int32), jnp.asarray(assignments),
        num_segments=capacity)
