"""Class-based clustering facade: PitmanYor / LowEntropy with the
reference's scalar API and packed Mixture drivers
(reference lp/clustering.pyx:66-329, include/distributions/mixture.hpp:49-163).

The packed driver here is host-side (numpy): it exists for API
compatibility with reference-style per-row loops.  The device-resident path is
distributions_tpu.mixture + ops.gibbs.
"""

import numpy as np

from distributions_tpu import clustering as _core
from distributions_tpu.compat.rng import get_key


class _MixtureDriverBase(object):
    """Packed mixture driver with swap-compaction and >=1-empty-group
    invariant (reference mixture.hpp:49-163).  The clustering model is
    passed to each method, as in the reference (`mixture.init(model,
    counts)` — examples/mixture/main.py:85)."""

    def __init__(self):
        self.counts = []
        self.sample_size = 0

    def __len__(self):
        return len(self.counts)

    def init(self, model, counts=None):
        if counts is not None:
            self.counts = [int(c) for c in counts]
        self.sample_size = sum(self.counts)
        assert any(c == 0 for c in self.counts), 'missing empty groups'

    def add_value(self, model, groupid, count=1):
        add_group = self.counts[groupid] == 0
        self.counts[groupid] += count
        self.sample_size += count
        if add_group:
            self.counts.append(0)
        return add_group

    def remove_value(self, model, groupid, count=1):
        assert self.counts[groupid] >= count, 'cannot remove from empty group'
        self.counts[groupid] -= count
        self.sample_size -= count
        remove_group = self.counts[groupid] == 0
        if remove_group:
            self.counts[groupid] = self.counts[-1]
            self.counts.pop()
        return remove_group

    def score_value(self, model, scores):
        """Write per-slot seating scores into `scores` (numpy float32)."""
        counts = np.asarray(self.counts, np.float64)
        out = model._score_slots(counts, self.sample_size)
        scores[:len(out)] = out
        return scores

    def score_data(self, model):
        return model.score_counts(list(self.counts))


class PitmanYor(object):
    """Scalar Pitman-Yor API (reference lp/clustering.pyx:260-329)."""

    def __init__(self, alpha=1.0, d=0.0):
        self.alpha = float(alpha)
        self.d = float(d)

    EXAMPLES = _core.PitmanYor.EXAMPLES

    @classmethod
    def from_dict(cls, raw):
        return cls(alpha=raw['alpha'], d=raw['d'])

    def load(self, raw):
        self.alpha = float(raw['alpha'])
        self.d = float(raw['d'])

    def dump(self):
        return {'alpha': self.alpha, 'd': self.d}

    def _functional(self):
        return _core.PitmanYor.from_dict(self.dump())

    def score_add_value(self, group_size, nonempty_group_count, sample_size,
                        empty_group_count=1):
        if group_size == 0:
            return float(np.log(
                (self.alpha + self.d * nonempty_group_count)
                / ((sample_size + self.alpha) * empty_group_count)))
        return float(np.log(
            (group_size - self.d) / (sample_size + self.alpha)))

    def score_remove_value(self, group_size, nonempty_group_count,
                           sample_size, empty_group_count=1):
        group_size -= 1
        if group_size == 0:
            nonempty_group_count -= 1
        return -self.score_add_value(
            group_size, nonempty_group_count, sample_size - 1,
            empty_group_count)

    def score_counts(self, counts):
        return float(_core.py_score_counts(
            self._functional(), np.asarray(counts, np.float32)))

    def sample_assignments(self, size):
        return [int(a) for a in np.asarray(_core.py_sample_assignments(
            get_key(), self._functional(), size))]

    def _score_slots(self, counts, sample_size):
        nonempty = int((counts > 0).sum())
        empty = max(int((counts == 0).sum()), 1)
        shift = -np.log(sample_size + self.alpha)
        with np.errstate(divide='ignore'):
            occupied = np.log(np.maximum(counts - self.d, 1e-30)) + shift
        empty_score = np.log(
            (self.alpha + self.d * nonempty) / empty) + shift
        return np.where(counts == 0, empty_score, occupied).astype(np.float32)

    Mixture = _MixtureDriverBase  # PitmanYor.Mixture() as in main.py:74


class LowEntropy(object):
    """Scalar low-entropy API (reference dbg/clustering.py:33-302)."""

    def __init__(self, dataset_size=0):
        self.dataset_size = int(dataset_size)

    EXAMPLES = _core.LowEntropy.EXAMPLES

    @classmethod
    def from_dict(cls, raw):
        return cls(dataset_size=raw['dataset_size'])

    def load(self, raw):
        self.dataset_size = int(raw['dataset_size'])

    def dump(self):
        return {'dataset_size': self.dataset_size}

    def _functional(self):
        return _core.LowEntropy.from_dict(self.dump())

    def score_add_value(self, group_size, nonempty_group_count, sample_size,
                        empty_group_count=1):
        return float(_core.le_score_add_value(
            self._functional(), group_size, nonempty_group_count,
            sample_size, empty_group_count))

    def score_remove_value(self, group_size, nonempty_group_count,
                           sample_size, empty_group_count=1):
        return float(_core.le_score_remove_value(
            self._functional(), group_size, nonempty_group_count,
            sample_size, empty_group_count))

    def score_counts(self, counts):
        return float(_core.le_score_counts(
            self._functional(), np.asarray(counts, np.float32)))

    def sample_assignments(self, size):
        return [int(a) for a in np.asarray(_core.le_sample_assignments(
            get_key(), self._functional(), size))]

    def log_partition_function(self, sample_size):
        return float(_core.le_log_partition_function(
            self._functional(), sample_size))

    def _score_slots(self, counts, sample_size):
        empty = max(int((counts == 0).sum()), 1)
        model = self._functional()
        out = np.asarray(_core.le_score_add_value(
            model, np.asarray(counts, np.float32), 0.0,
            float(sample_size), float(empty)))
        return out.astype(np.float32)

    Mixture = _MixtureDriverBase


def count_assignments(assignments):
    """dict groupid->... -> dense counts (reference clustering.hpp:51-52,
    dbg flavor takes a dict of item->groupid)."""
    if isinstance(assignments, dict):
        values = list(assignments.values())
    else:
        values = list(assignments)
    if not values:
        return []
    out = [0] * (max(values) + 1)
    for v in values:
        out[v] += 1
    return out
