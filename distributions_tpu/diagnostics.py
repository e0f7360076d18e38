"""Observability: sweep diagnostics, convergence statistics, profiling.

The reference has no structured observability (prints only; reference
SURVEY §5); this module is designed fresh for production use:

- `sweep_stats`: per-sweep summary of a mixture state
- `rhat` / `ess`: cross-chain convergence diagnostics (Gelman-Rubin
  split-R̂ and effective sample size) for chain-parallel runs
- `trace`: context manager around the jax profiler for xprof/tensorboard
  traces of sweep kernels
"""

import contextlib
import time

import numpy as np
import jax
import jax.numpy as jnp


def sweep_stats(spec, cl_model, shareds, state, counts=None,
                defer_score=False):
    """Summary dict of a mixture state (host-side scalars).

    counts: optional host copy of state.counts — the runner reuses its
    step-sync read so no extra device round-trip happens here.
    defer_score=True returns the joint score as a
    NOT-YET-READ device scalar under '_score_dev' instead of
    'score_data': the caller reads it later (the runner: one step
    later, when it is free), keeping logged values identical without
    stalling."""
    from distributions_tpu import mixture as mx
    if counts is None:
        counts = np.asarray(state.counts)
    row = {
        'sample_size': int(counts.sum()),
        'nonempty_groups': int((counts > 0).sum()),
        'alive_groups': int(np.asarray(state.alive).sum()),
        'largest_group': int(counts.max()),
    }
    score = mx.score_data(spec, cl_model, shareds, state)
    if defer_score:
        row['_score_dev'] = score
    else:
        row['score_data'] = float(score)
    return row


def rhat(chains):
    """Split-R̂ over a [n_chains, n_samples] scalar trace."""
    x = np.asarray(chains, np.float64)
    n_chains, n = x.shape
    half = n // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    m, n = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W)) if W > 0 else float('inf')


def ess(chain):
    """Effective sample size of a scalar [n_samples] trace via initial
    positive autocorrelation sums (Geyer)."""
    x = np.asarray(chain, np.float64)
    n = x.size
    x = x - x.mean()
    acov = np.correlate(x, x, mode='full')[n - 1:] / n
    if acov[0] == 0:
        return float(n)
    rho = acov / acov[0]
    total = 0.0
    for t in range(1, n - 2, 2):
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        total += pair
    return float(n / (1.0 + 2.0 * total))


@contextlib.contextmanager
def trace(logdir):
    """Capture a jax profiler trace of everything inside the context
    (view with tensorboard/xprof).  The analog of the reference's
    `make profile` microbenchmark harness (reference Makefile:120-129)."""
    jax.profiler.start_trace(logdir)
    t0 = time.time()
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print('trace written to {} ({:.2f}s)'.format(
            logdir, time.time() - t0))


class SweepLogger(object):
    """Minimal structured per-sweep logger: collects dict rows, dumps to
    json-stream files (io.stream) for offline analysis."""

    def __init__(self):
        self.rows = []

    def log(self, sweep, **fields):
        row = {'sweep': int(sweep), 'time': time.time()}
        row.update(fields)
        self.rows.append(row)
        return row

    def save(self, filename):
        from distributions_tpu.io.stream import json_stream_dump
        json_stream_dump(self.rows, filename)
