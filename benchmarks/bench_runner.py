"""Production-runner wall-clock benchmark.

bench.py times the blocked sweep alone; this measures
`inference.runner.run_gibbs` itself — init, per-step sync, validation,
sweep_stats, logging — at the flagship shape, the way the reference
benchmarks its production Mixture loop (reference
benchmarks/mixture.cc:104-158).  sweeps_per_step sets how many sweeps run
between host synchronizations.

Usage (one GPU, one process on it):
    python benchmarks/bench_runner.py                # flagship 1Mx1024x2
    RUNNER_SPS=1 python benchmarks/bench_runner.py   # sync every sweep
RUNNER_FORCE_CPU=1 runs it on the CPU (a smoke test, not a measurement).

Prints one JSON line:
  {"metric": "runner_gibbs_cells_per_sec", "value": ..., "unit": "cells/s",
   "ms_per_sweep": ..., "sweeps_per_step": k, "vs_baseline": ...,
   "device": {...}, "card": "..."}
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    R = int(os.environ.get('RUNNER_ROWS', 1048576))
    C = int(os.environ.get('RUNNER_COMPONENTS', 1024))
    BLOCK = int(os.environ.get('RUNNER_BLOCK', 131072))
    FEATURES = int(os.environ.get('RUNNER_FEATURES', 2))
    SPS = int(os.environ.get('RUNNER_SPS', 10))
    # 3 measured steps after a warmup run that compiles every program
    PASSES = int(os.environ.get('RUNNER_PASSES', 3 * SPS))

    MODEL = os.environ.get('RUNNER_MODEL', 'nich')  # nich | bb

    import jax
    if os.environ.get('RUNNER_FORCE_CPU') == '1':
        jax.config.update('jax_platforms', 'cpu')
    from distributions_tpu import runtime
    runtime.enable_compile_cache()
    if os.environ.get('RUNNER_FORCE_CPU') != '1':
        runtime.require_gpu()
    import jax.numpy as jnp
    from distributions_tpu import clustering, mixture as mx
    from distributions_tpu.models import nich, bb
    from distributions_tpu.inference import runner

    rng = np.random.RandomState(0)
    if MODEL == 'bb':
        FEATURES = 1
        spec = mx.make_spec([(bb, 1)], capacity=C, empties=1)
    else:
        spec = mx.make_spec([(nich, FEATURES)], capacity=C, empties=1)
    # alpha=1 + 7C/8 true clusters + a warm start from the generating
    # labels: occupancy stays ~87% and growth (which fires at free == 0
    # with grow_headroom=0) never triggers mid-benchmark.  bench.py's
    # alpha=100 config SATURATES the 1024 slots and makes run_gibbs
    # double capacity after the first step — every later step then
    # measures a 2x-capacity problem (found via
    # JAX_EXPLAIN_CACHE_MISSES; per-sweep cells are R*C*F either way).
    # Raising alpha/d or dropping the warm start reintroduces that risk;
    # the '# last row' stderr line prints the final capacity to check.
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    n_true = C // 8 * 7
    labels = rng.randint(0, n_true, R)
    if MODEL == 'bb':
        # d=0 (CRP): under d=0.1 the binary-data partition sustains
        # >1100 groups at 1M rows and growth correctly doubles capacity
        # mid-benchmark (measured — same trap as the nich random init)
        cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
        shareds = (bb.shared_from_dict({'alpha': 0.5, 'beta': 0.5}),)
        ps = rng.rand(n_true)
        X = (rng.rand(R) < ps[labels])[:, None]
        values = (jnp.asarray(X),)
    else:
        shareds = (nich.shared_from_dict(
            {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}),)
        centers = rng.randn(n_true, FEATURES).astype(np.float32)
        X = centers[labels] + 0.1 * rng.randn(R, FEATURES) \
            .astype(np.float32)
        values = (jnp.asarray(X, jnp.float32),)

    # warm-start from the generating labels (exactly bench.py's setup):
    # a random init transiently scatters rows across ALL slots during
    # the first sweeps, which (correctly) triggers capacity growth and
    # turns the rest of the benchmark into a 2x-capacity problem
    common = dict(
        block=BLOCK, initial_assignments=jnp.asarray(labels, jnp.int32),
        grow_headroom=0.0, sweeps_per_step=SPS)

    # warmup run: compiles init, the sweep and the per-step programs
    t0 = time.perf_counter()
    runner.run_gibbs(spec, cl, shareds, values, jax.random.PRNGKey(1),
                     passes=SPS, **common)
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, an, log = runner.run_gibbs(
        spec, cl, shareds, values, jax.random.PRNGKey(0), passes=PASSES,
        **common)
    jax.block_until_ready((state, an))
    total = time.perf_counter() - t0

    per_sweep = total / PASSES
    cells = float(R) * C * FEATURES
    cells_per_sec = cells / per_sweep

    baseline = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             '..', 'BASELINE_MEASURED.json')
    if os.path.exists(base_path):
        with open(base_path) as f:
            baseline = json.load(f).get('nich_cells_per_sec_K1000')

    step_secs = [r['seconds'] for r in log.rows]
    card = runtime.card_line()
    print('# last row: %s; final capacity %d'
          % ({k: v for k, v in log.rows[-1].items()
              if k != 'score_data'}, np.asarray(state.counts).shape[0]),
          file=sys.stderr)
    out = {
        'metric': 'runner_gibbs_cells_per_sec',
        'value': cells_per_sec,
        'unit': 'cells/s',
        'ms_per_sweep': per_sweep * 1e3,
        'sweeps_per_step': SPS,
        'vs_baseline': cells_per_sec / baseline if baseline else None,
        'device': runtime.device_info(),
        'card': card,
    }
    print(json.dumps(out))
    print('# R=%d C=%d block=%d passes=%d steps=%d compile=%.1fs '
          'step_seconds=%s card=%s'
          % (R, C, BLOCK, PASSES, len(log.rows), compile_time,
             step_secs, card), file=sys.stderr)


if __name__ == '__main__':
    main()
