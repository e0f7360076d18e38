"""Headline benchmark: collapsed-Gibbs cell-scoring throughput on a DPMM.

Workload (analog of reference benchmarks/mixture.cc:104-158): R rows x C
components, 2 NICH features, Pitman-Yor prior; one blocked collapsed-Gibbs
sweep (ops/gibbs.sweep_blocked) = per tile {remove tile, score [B, C]
against all components for both features, categorical reassign, add
tile}.

Metric: **cell-scores/sec** where a cell = one (row, component) posterior-
predictive evaluation for one feature (the reference's unit: remove ->
score-all-K -> add per row, benchmarks/mixture.cc:104-143).

Runs on the GPU only; BENCH_FORCE_CPU=1 is the one way to run it on the
CPU (for a smoke test of the script, not a measurement).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "cells/s", "vs_baseline": N,
   "device": {...}, "card": "..."}
vs_baseline divides by the measured single-core C++ reference rate
(BASELINE_MEASURED.json, recorded by running the reference's own
benchmarks/mixture on an x86 core — see BASELINE.md).
"""

import json
import os
import sys
import time

import numpy as np


def main():
    # sizes (env-overridable for smoke tests)
    R = int(os.environ.get('BENCH_ROWS', 1048576))
    C = int(os.environ.get('BENCH_COMPONENTS', 1024))
    BLOCK = int(os.environ.get('BENCH_BLOCK', 131072))
    FEATURES = int(os.environ.get('BENCH_FEATURES', 2))
    SWEEPS = int(os.environ.get('BENCH_SWEEPS', 20))

    import jax
    if os.environ.get('BENCH_FORCE_CPU') == '1':
        jax.config.update('jax_platforms', 'cpu')
    from distributions_tpu import runtime
    runtime.enable_compile_cache()
    if os.environ.get('BENCH_FORCE_CPU') != '1':
        runtime.require_gpu()
    import jax.numpy as jnp
    from distributions_tpu import clustering, mixture as mx
    from distributions_tpu.ops import gibbs
    from distributions_tpu.models import nich

    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, FEATURES)], capacity=C, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1})
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}),)

    centers = rng.randn(C - 8, FEATURES).astype(np.float32)
    labels = rng.randint(0, C - 8, R)
    X = centers[labels] + 0.1 * rng.randn(R, FEATURES).astype(np.float32)
    values = (jnp.asarray(X, jnp.float32),)
    assignments = jnp.asarray(labels, jnp.int32)

    state = mx.state_from_assignments(spec, cl, shareds, values, assignments)
    keys = jax.random.split(jax.random.PRNGKey(0), SWEEPS + 1)

    def sweep(state, assignments, key):
        return gibbs.sweep_blocked(spec, cl, shareds, state, values,
                                   assignments, BLOCK, key=key)

    t0 = time.perf_counter()
    jax.block_until_ready(sweep(state, assignments, keys[-1]))
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    carry = (state, assignments)
    for i in range(SWEEPS):
        carry = sweep(*carry, keys[i])
    jax.block_until_ready(carry)
    elapsed = (time.perf_counter() - t0) / SWEEPS

    cells_per_sec = float(R) * C * FEATURES / elapsed
    baseline = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'BASELINE_MEASURED.json')
    if os.path.exists(base_path):
        with open(base_path) as f:
            baseline = json.load(f).get('nich_cells_per_sec_K1000')

    card = runtime.card_line()
    print(json.dumps({
        'metric': 'gibbs_cell_scores_per_sec',
        'value': cells_per_sec,
        'unit': 'cells/s',
        'vs_baseline': cells_per_sec / baseline if baseline else None,
        'device': runtime.device_info(),
        'card': card,
    }))
    print('# R={} C={} block={} sweeps={} sweep={:.6f}s compile={:.1f}s '
          'card={}'.format(R, C, BLOCK, SWEEPS, elapsed, compile_time, card),
          file=sys.stderr)


if __name__ == '__main__':
    main()
