"""Full benchmark suite: the analog of the reference's benchmarks/
executables (mixture.cc, sample_from_scores.cc, score_counts.cc,
sample_assignment_from_py.cc, special.cc).

Each benchmark prints one JSON line; run on one GPU (the default; the
script exits when it finds none) or with BENCH_PLATFORM=cpu for smoke
runs, which are not measurements.

  python benchmarks/suite.py            # all
  python benchmarks/suite.py mixture    # one section
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def _sync(x):
    import jax
    return jax.block_until_ready(x)


def timeit(fn, *args, iters=10, warmup=1):
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.time() - t0) / iters


def bench_mixture():
    """Gibbs cell-scoring rate per model x K (reference
    benchmarks/mixture.cc:104-158): one blocked remove/score/sample/add
    round per row, counting cells = rows x K."""
    import jax
    import jax.numpy as jnp
    from distributions_tpu import clustering, mixture as mx
    from distributions_tpu.ops import gibbs
    from distributions_tpu.models import bb, dd, gp, nich, bnb, dpd

    R = int(os.environ.get('BENCH_ROWS', 65536))
    BLOCK = int(os.environ.get('BENCH_BLOCK', 16384))
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1})
    rng = np.random.RandomState(0)

    cases = {
        'bb': (bb, {'alpha': 0.5, 'beta': 2.0},
               lambda: rng.randint(0, 2, (R, 1)).astype(bool)),
        'dd4': (dd, {'alphas': [0.5] * 4},
                lambda: rng.randint(0, 4, (R, 1))),
        'gp': (gp, {'alpha': 1.0, 'inv_beta': 1.0},
               lambda: rng.poisson(3.0, (R, 1))),
        'bnb': (bnb, {'alpha': 1., 'beta': 1., 'r': 1},
                lambda: rng.poisson(3.0, (R, 1))),
        'nich': (nich, {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.},
                 lambda: rng.randn(R, 1).astype(np.float32)),
        'dpd': (dpd, {'gamma': 1.0, 'alpha': 1.0,
                      'betas': {i: 1.0 / 8 for i in range(8)}},
                lambda: rng.randint(0, 8, (R, 1))),
    }

    only = os.environ.get('BENCH_MODELS')

    Ks = [int(k) for k in os.environ.get(
        'BENCH_K', '64,512,1024').split(',')]
    for K in Ks:
        for name, (module, shared_raw, gen) in cases.items():
            if only and name not in only.split(','):
                continue
            spec = mx.make_spec([(module, 1)], capacity=K, empties=1)
            shareds = (module.shared_from_dict(shared_raw),)
            X = jnp.asarray(gen())
            assignments = jnp.asarray(rng.randint(0, K - 8, R), jnp.int32)
            state = mx.state_from_assignments(
                spec, cl, shareds, (X,), assignments)
            key = jax.random.PRNGKey(0)

            def sweep(st, an):
                return gibbs.sweep_blocked(
                    spec, cl, shareds, st, (X,), an, BLOCK, key=key)

            dt = timeit(lambda: sweep(state, assignments), iters=5)
            cells = R * K
            print(json.dumps({
                'metric': 'mixture_cells_per_sec', 'model': name, 'K': K,
                'value': round(cells / dt, 1), 'unit': 'cells/s'}))


def bench_sample_from_scores():
    """Categorical-from-scores throughput vs vector size (reference
    benchmarks/sample_from_scores.cc:35-80).

    T iterations run inside one program via lax.scan (fresh fold_in key
    per iteration), so per-dispatch host overhead is amortized away.
    Two units are reported: draws/s (categorical samples) and elems/s
    (score elements consumed = draws x size — the unit the reference's
    'choices/us' actually counts:
    sample_from_scores.cc:60 divides size*iters by time)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from distributions_tpu.random import sample_from_scores

    rng = np.random.RandomState(0)
    B = 4096
    for size in [2 ** e for e in range(4, 15, 2)]:
        scores = jnp.asarray(rng.randn(B, size), jnp.float32)
        T = min(16384, max(64, (1 << 31) // (B * size)))

        @jax.jit
        def run(key, scores):
            def body(carry, i):
                draws = sample_from_scores(
                    jax.random.fold_in(key, i), scores)
                return carry + draws[0], ()
            c, _ = lax.scan(body, jnp.int32(0),
                            jnp.arange(T, dtype=jnp.int32))
            return c

        key = jax.random.PRNGKey(0)
        dt = timeit(run, key, scores, iters=3) / T
        print(json.dumps({
            'metric': 'sample_from_scores_choices_per_sec', 'size': size,
            'value': round(B / dt, 1), 'unit': 'draws/s',
            'elems_per_sec': round(B * size / dt, 1),
            'in_program_iters': T}))


def bench_score_counts():
    """PY score_counts rate vs dataset size (reference
    benchmarks/score_counts.cc:49-91).

    The reference scores the count vector of a PY PRIOR DRAW of n items
    — for PY(1, 0.2) that is only ~(alpha/d) n^d groups (e.g. ~80 at
    n=1e6), so its "scores/sec" is over an O(n^d)-length vector, not an
    O(n) one.  Counts here are drawn from the same measure via GEM
    stick-breaking + multinomial.  Two rates are reported:
      - sequential: lax.scan of dependent single scores in-program (the
        reference's harness shape; latency-bound), and
      - batched: vmap over 4096 count vectors at once (the batched
        serving shape — hyper-grid scoring and chain diagnostics score
        many partitions at once).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from distributions_tpu import clustering

    alpha, d = 1.0, 0.2
    model = clustering.PitmanYor.from_dict({'alpha': alpha, 'd': d})
    rng = np.random.RandomState(0)

    def py_counts(n):
        # GEM(alpha, d) stick-breaking, truncated when the remaining
        # mass cannot contain another expected item
        sticks = []
        log_rest = 0.0
        k = 0
        while log_rest > -np.log(4.0 * n) and k < 1 << 20:
            v = rng.beta(1 - d, alpha + (k + 1) * d)
            sticks.append(np.exp(log_rest) * v)
            log_rest += np.log1p(-v)
            k += 1
        w = np.asarray(sticks)
        w = w / w.sum()
        counts = rng.multinomial(n, w)
        return counts[counts > 0].astype(np.float32)

    B = 4096
    for size in [1000, 10000, 100000, 1000000, 10000000]:
        counts = jnp.asarray(py_counts(size))
        K = int(counts.shape[0])
        T = 4096

        @jax.jit
        def run_seq(c):
            def body(c, _):
                c = c.at[0].add(1.0)      # serial dependency, no hoisting
                return c, clustering.py_score_counts(model, c)
            _, scores = lax.scan(body, c, None, length=T)
            return scores

        dt = timeit(run_seq, counts, iters=3) / T
        batch = jnp.tile(counts[None, :], (B, 1)) + jnp.arange(
            B, dtype=jnp.float32)[:, None]

        @jax.jit
        def run_batch(cb):
            def body(cb, _):
                cb = cb.at[:, 0].add(1.0)
                return cb, jax.vmap(
                    lambda c: clustering.py_score_counts(model, c))(cb)
            _, scores = lax.scan(body, cb, None, length=8)
            return scores

        dtb = timeit(run_batch, batch, iters=3) / (8 * B)
        print(json.dumps({
            'metric': 'py_score_counts_per_sec', 'dataset_size': size,
            'n_groups': K,
            'value': round(1.0 / dt, 1), 'unit': 'scores/s',
            'batched_scores_per_sec': round(1.0 / dtb, 1),
            'in_program_iters': T}))


def bench_sample_assignments():
    """PY sample_assignments rate (reference
    benchmarks/sample_assignment_from_py.cc:49-90).

    Two implementations: the sequential CRP scan (reference-shaped; an
    R-step chain, slow to compile and run at R ~ 1e6 — benched at
    small R) and the batched stick-breaking sampler (same partition
    distribution, two batched draws; benched to R = 1e6)."""
    import jax
    from jax import lax
    import jax.numpy as jnp
    from distributions_tpu import clustering

    model = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.2})
    for size in [1000, 10000]:
        key = jax.random.PRNGKey(0)
        fn = jax.jit(lambda k: clustering.py_sample_assignments(
            k, model, size, capacity=256))
        dt = timeit(fn, key, iters=3)
        print(json.dumps({
            'metric': 'py_sample_assignments_per_sec', 'size': size,
            'value': round(size / dt, 1), 'unit': 'samples/s'}))

    for size in [10000, 1048576]:
        T = max(4, (1 << 24) // size)

        @jax.jit
        def run(key):
            def body(carry, i):
                a = clustering.py_sample_assignments_stick(
                    jax.random.fold_in(key, i), model, size,
                    capacity=1024)
                return carry + a[0], ()
            c, _ = lax.scan(body, jnp.int32(0),
                            jnp.arange(T, dtype=jnp.int32))
            return c

        dt = timeit(run, jax.random.PRNGKey(1), iters=3) / T
        print(json.dumps({
            'metric': 'py_sample_assignments_stick_per_sec',
            'size': size, 'value': round(size / dt, 1),
            'unit': 'samples/s', 'in_program_iters': T}))


def bench_special():
    """Special-function throughput (reference benchmarks/special.cc)."""
    import jax
    import jax.numpy as jnp
    from distributions_tpu import special

    from jax import lax
    rng = np.random.RandomState(0)
    x = jnp.asarray(np.abs(rng.randn(1 << 20)) * 10 + 0.1, jnp.float32)
    T = 64   # in-program loop; input perturbed per iteration (no hoisting)
    for name, fn in [('exp', jnp.exp), ('log', jnp.log),
                     ('lgamma', special.lgamma),
                     ('lgamma_nu', special.lgamma_nu)]:
        @jax.jit
        def run(v, f=fn):
            def body(acc, i):
                return acc + f(v + 1e-6 * i), ()
            acc, _ = lax.scan(body, jnp.zeros_like(v),
                              jnp.arange(T, dtype=jnp.float32))
            return acc[0]

        dt = timeit(run, x, iters=3) / T
        print(json.dumps({
            'metric': 'special_calls_per_sec', 'fn': name,
            'value': round(x.size / dt, 1), 'unit': 'calls/s',
            'in_program_iters': T}))


def bench_hyper_grid():
    """Hyper-grid scoring rate: one vmapped score_data over a [G] grid of
    Shareds x [C] groups (the runner's hyper_grids step; the reference
    exposes the primitive as dd.hpp:259-287 score_data_grid).  Metric:
    grid-cells (G x C group-marginals) per second."""
    import jax
    import jax.numpy as jnp
    from distributions_tpu import mixture as mx, clustering
    from distributions_tpu.models import nich
    from distributions_tpu.inference import hypers

    R = int(os.environ.get('BENCH_ROWS', 65536))
    C = int(os.environ.get('BENCH_CAP', 1024))
    G = int(os.environ.get('BENCH_GRID', 64))
    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, 2)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1})
    values = (jnp.asarray(rng.randn(R, 2), np.float32),)
    assignments = jnp.asarray(rng.randint(0, C - 8, R), jnp.int32)
    state = mx.state_from_assignments(spec, cl, shareds, values, assignments)
    grid = nich.Shared(
        mu=jnp.zeros(G), kappa=jnp.full(G, 0.1),
        sigmasq=jnp.asarray(np.logspace(-2, 2, G), jnp.float32),
        nu=jnp.ones(G))

    step = jax.jit(lambda k: hypers.grid_step_feature(
        k, spec, 0, shareds, state, grid)[1])
    keys = [jax.random.PRNGKey(i) for i in range(12)]
    step(keys[0])
    dt = timeit(lambda: step(keys[np.random.randint(12)]), iters=10)
    print(json.dumps({
        'metric': 'hyper_grid_cells_per_sec', 'G': G, 'C': C,
        'value': round(G * C / dt, 1), 'unit': 'grid-cells/s'}))


def bench_predictive():
    """Serving-path density rate: log_predictive of held-out rows against
    a fitted 1024-component state (collapsed posterior predictive — the
    production scoring/serving shape; no reference analog, its serving
    story is the same per-row loop as inference).  Metric: predictive
    cell evaluations (rows x components x features) per second, plus
    rows/s."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from distributions_tpu import clustering, mixture as mx
    from distributions_tpu.models import nich

    R = int(os.environ.get('BENCH_ROWS', 1048576))
    C = int(os.environ.get('BENCH_CAP', 1024))
    cols = 2
    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, cols)], capacity=C, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1})
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}),)
    centers = rng.randn(C - 8, cols).astype(np.float32)
    labels = rng.randint(0, C - 8, R)
    X = centers[labels] + 0.1 * rng.randn(R, cols).astype(np.float32)
    state = mx.state_from_assignments(
        spec, cl, shareds, (jnp.asarray(X),), jnp.asarray(labels))
    Xq = jnp.asarray(centers[rng.randint(0, C - 8, R)]
                     + 0.1 * rng.randn(R, cols), jnp.float32)

    T = 8

    @jax.jit
    def run(Xq):
        def body(carry, i):
            lp = mx.log_predictive(spec, cl, shareds, state,
                                   (Xq + 1e-6 * i,))
            return carry + lp[0], ()
        c, _ = lax.scan(body, jnp.float32(0),
                        jnp.arange(T, dtype=jnp.float32))
        return c

    dt = timeit(run, Xq, iters=3) / T
    print(json.dumps({
        'metric': 'log_predictive_cells_per_sec', 'rows': R, 'C': C,
        'features': cols,
        'value': round(R * C * cols / dt, 1), 'unit': 'cells/s',
        'rows_per_sec': round(R / dt, 1)}))


def bench_backends():
    """Alternative inference backends on the SAME mixture model (the
    'one log-prob graph, many backends' claim with device numbers —
    reference analog: the reference benchmarks every hot path it ships).

    - hmc: leapfrog gradient evaluations/s of the K-truncated mixture
      log-prob (inference/logprob.py graph) at a production shape; the
      gradient eval is the unit every HMC/NUTS step is built from.
    - smc: particle-filter rows/s (particles x rows per second) for
      smc_init with systematic resampling.  SMC is row-sequential by
      construction, so R stays modest; the particle axis is the batch
      axis the device parallelizes."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from distributions_tpu import clustering, mixture as mx
    from distributions_tpu.models import nich
    from distributions_tpu.inference import logprob as lp_mod, smc

    rng = np.random.RandomState(0)
    cl = clustering.PitmanYor.from_dict({'alpha': 5.0, 'd': 0.1})

    # --- HMC/NUTS unit: value+grad of the mixture log-prob
    R, K, cols = (int(os.environ.get('BENCH_HMC_ROWS', 262144)),
                  int(os.environ.get('BENCH_HMC_K', 64)), 2)
    spec = mx.make_spec([(nich, cols)], capacity=K, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.1, 'nu': 1.}),)
    X = rng.randn(R, cols).astype(np.float32)
    logprob_fn, init_fn = lp_mod.make_mixture_logprob(
        spec, cl, shareds, (jnp.asarray(X),), K)
    params0 = init_fn(jax.random.PRNGKey(0))
    vg = jax.value_and_grad(logprob_fn)
    T = 16

    @jax.jit
    def run(params):
        def body(carry, i):
            v, g = vg(jax.tree_util.tree_map(
                lambda a: a + 1e-6 * i, params))
            return carry + v, ()
        c, _ = lax.scan(body, jnp.float32(0),
                        jnp.arange(T, dtype=jnp.float32))
        return c

    dt = timeit(run, params0, iters=3) / T
    print(json.dumps({
        'metric': 'hmc_grad_evals_per_sec', 'rows': R, 'K': K,
        'value': round(1.0 / dt, 2), 'unit': 'grad evals/s',
        'cell_grads_per_sec': round(R * K * cols / dt, 1)}))

    # --- SMC: particles x rows per second
    Rs, P = (int(os.environ.get('BENCH_SMC_ROWS', 2048)),
             int(os.environ.get('BENCH_SMC_PARTICLES', 256)))
    spec_s = mx.make_spec([(nich, cols)], capacity=32, empties=1)
    Xs = jnp.asarray(rng.randn(Rs, cols), jnp.float32)

    fn = jax.jit(lambda k: smc.smc_init(
        spec_s, cl, shareds, (Xs,), P, 64, k)[3])
    dt = timeit(fn, jax.random.PRNGKey(1), iters=3)
    print(json.dumps({
        'metric': 'smc_particle_rows_per_sec', 'rows': Rs,
        'particles': P,
        'value': round(Rs * P / dt, 1), 'unit': 'particle-rows/s',
        'rows_per_sec': round(Rs / dt, 1)}))


SECTIONS = {
    'mixture': bench_mixture,
    'hyper_grid': bench_hyper_grid,
    'sample_from_scores': bench_sample_from_scores,
    'score_counts': bench_score_counts,
    'predictive': bench_predictive,
    'sample_assignments': bench_sample_assignments,
    'backends': bench_backends,
    'special': bench_special,
}


def main():
    import jax
    from distributions_tpu import runtime
    if os.environ.get('BENCH_PLATFORM') == 'cpu':
        jax.config.update('jax_platforms', 'cpu')
    runtime.enable_compile_cache()
    if os.environ.get('BENCH_PLATFORM') != 'cpu':
        runtime.require_gpu()
    print('# card: %s device: %s' % (runtime.card_line(),
                                     json.dumps(runtime.device_info())))
    names = sys.argv[1:] or list(SECTIONS)
    for name in names:
        SECTIONS[name]()


if __name__ == '__main__':
    main()

