"""Golden-fixture generator: runs the REFERENCE's pure-python dbg flavor
(/root/reference/distributions/dbg — python 2 sources) under python 3 and
records score_value / score_data / sufficient statistics on pinned inputs
into dbg_golden.json.

This executes the reference's own code (no transcription) so the checked-in
numbers are an independent oracle for the JAX implementation: a sign or
exponent slip in any transcribed formula fails tests/test_golden.py even
though every internal consistency test would still pass.

Python-2 -> 3 handling is textual and minimal (xrange/iteritems/izip); the
ONE semantic difference that matters is preserved explicitly: py2 int/int
division floors, so `dataset_size / sample_size` in LowEntropy's postpred
correction is mapped to `//` (the C++ flavor floors there too,
reference include/distributions/clustering.hpp:326).

Usage: python tests/golden/gen_dbg_golden.py  (rewrites dbg_golden.json)
"""

import json
import os
import sys
import types

import numpy as np

REF = '/root/reference/distributions'
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'dbg_golden.json')

MODELS = ['bb', 'bnb', 'dd', 'dpd', 'gp', 'nich', 'niw']


def _fix_py2(src):
    src = src.replace('xrange(', 'range(')
    src = src.replace('.iteritems()', '.items()')
    src = src.replace('.itervalues()', '.values()')
    src = src.replace('.iterkeys()', '.keys()')
    src = src.replace('from itertools import izip', 'izip = zip')
    # numpy 1.20 removed the np.float/np.int builtin aliases
    for mod in ('numpy', 'np'):
        src = src.replace('dtype=%s.float)' % mod, 'dtype=float)')
        src = src.replace('dtype=%s.int)' % mod, 'dtype=int)')
    # py2 floors int/int; the only int/int site in the dbg scoring paths
    # (audited) is LowEntropy._approximate_postpred_correction's `scale`
    # (dbg/clustering.py:283).  There the reference's own flavors DISAGREE:
    # the C++ production flavor divides in float (clustering.hpp:319 takes
    # sample_size as float).  These fixtures adopt the production (float)
    # semantics, so running under py3 — where / is float division — is
    # exactly right and no rewrite is performed; the C++ oracle
    # (gen_cpp_golden.cc) cross-checks the same numbers independently.
    assert '\nprint ' not in src and ' print ' not in src.replace(
        "'print '", ''), 'unhandled py2 print statement'
    return src


def _exec_ref(relpath, modname):
    path = os.path.join(REF, relpath)
    with open(path) as f:
        src = _fix_py2(f.read())
    mod = types.ModuleType(modname)
    mod.__file__ = path
    sys.modules[modname] = mod
    exec(compile(src, path, 'exec'), mod.__dict__)
    return mod


def _install_shims():
    """Fake `distributions` package backed by the reference sources, with
    util/vendor shimmed (their full modules have py2-isms the dbg scoring
    paths never touch)."""
    pkg = types.ModuleType('distributions')
    pkg.__path__ = []
    sys.modules['distributions'] = pkg

    util = types.ModuleType('distributions.util')

    def scores_to_probs(scores):
        scores = np.array(scores, dtype=float)
        scores -= scores.max()
        probs = np.exp(scores)
        probs /= probs.sum()
        return probs

    util.scores_to_probs = scores_to_probs
    sys.modules['distributions.util'] = util

    vendor = types.ModuleType('distributions.vendor')
    vendor.__path__ = []
    sys.modules['distributions.vendor'] = vendor
    stats = types.ModuleType('distributions.vendor.stats')

    def sample_invwishart(*a, **k):  # sampling-only; scoring never calls it
        raise NotImplementedError
    stats.sample_invwishart = sample_invwishart
    sys.modules['distributions.vendor.stats'] = stats

    _exec_ref('mixins.py', 'distributions.mixins')
    dbg = types.ModuleType('distributions.dbg')
    dbg.__path__ = []
    sys.modules['distributions.dbg'] = dbg
    _exec_ref('dbg/special.py', 'distributions.dbg.special')
    _exec_ref('dbg/random.py', 'distributions.dbg.random')
    clustering = _exec_ref('dbg/clustering.py', 'distributions.dbg.clustering')
    models_pkg = types.ModuleType('distributions.dbg.models')
    models_pkg.__path__ = []
    sys.modules['distributions.dbg.models'] = models_pkg
    models = {
        name: _exec_ref('dbg/models/%s.py' % name,
                        'distributions.dbg.models.%s' % name)
        for name in MODELS
    }
    return clustering, models


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def _value_key(v):
    """json-stable representation of a model value."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.bool_, np.floating)):
        return v.item()
    return v


def model_golden(module):
    out = []
    for i, example in enumerate(module.EXAMPLES):
        shared = module.Shared.from_dict(example['shared'])
        values = example['values']
        # dpd's Shared mutates (stick-breaks on first sight of a value,
        # np.random-seeded above); for every other model add_value is a
        # no-op SharedMixin.  The post-add shared dump is recorded so the
        # consumer loads the *realized* shared rather than re-sampling.
        for v in values:
            shared.add_value(v)
        group = module.Group()
        group.init(shared)
        for v in values:
            group.add_value(shared, v)
        rec = {
            'example': i,
            'shared': _jsonable(shared.dump()),
            'values': [_value_key(v) for v in values],
            'group': _jsonable(group.dump()),
            'score_values': [float(group.score_value(shared, v))
                             for v in values],
            'score_data': float(group.score_data(shared)),
        }
        # chain-rule trace: score_value BEFORE each incremental add, from an
        # empty group (this is the exact per-row Gibbs quantity)
        g2 = module.Group()
        g2.init(shared)
        incr = []
        for v in values:
            incr.append(float(g2.score_value(shared, v)))
            g2.add_value(shared, v)
        rec['incremental_score_values'] = incr
        # remove back half, score again (tests remove_value downdates)
        for v in values[len(values) // 2:]:
            g2.remove_value(shared, v)
        rec['score_data_after_removes'] = float(g2.score_data(shared))
        out.append(rec)
    return out


def clustering_golden(clustering):
    out = []
    for example in clustering.LowEntropy.EXAMPLES:
        model = clustering.LowEntropy()
        model.load(example)
        N = model.dataset_size
        countsets = [c for c in
                     [[1], [2, 1], [3, 2], [5, 3, 1, 1], [10, 5, 2, 1, 1, 1],
                      [100, 200, 300, 400]]
                     if sum(c) <= N]
        rec = {
            'dataset_size': N,
            'score_counts': [
                {'counts': c, 'score': float(model.score_counts(c))}
                for c in countsets],
            'score_add': [],
        }
        for group_size in [0, 1, 2, 7, 100]:
            for sample_size in [1, 3, 18, 500]:
                if group_size > sample_size or sample_size >= N:
                    continue
                add = float(model.score_add_value(group_size, 3, sample_size))
                rem = (float(model.score_remove_value(
                    group_size + 1, 3, sample_size + 1)))
                rec['score_add'].append(
                    {'group_size': group_size, 'sample_size': sample_size,
                     'add': add, 'remove': rem})
        out.append(rec)
    return out


def main():
    clustering, models = _install_shims()
    np.random.seed(0)
    golden = {
        'models': {name: model_golden(mod) for name, mod in models.items()},
        'low_entropy': clustering_golden(clustering),
    }
    with open(OUT, 'w') as f:
        json.dump(golden, f, indent=1, sort_keys=True)
    n = sum(len(v) for v in golden['models'].values())
    print('wrote %s: %d model examples + %d LowEntropy configs'
          % (OUT, n, len(golden['low_entropy'])))


if __name__ == '__main__':
    main()
