"""Smoke check of the collapsed-Gibbs main path on one NVIDIA GPU.

    python chip_smoke.py                # phases A-D on one card
    python chip_smoke.py --four-cards   # the 4-card mesh comparisons only

Phases (each through the public entry points, in this one process):
  A  flagship: inference.runner.run_gibbs at 1,048,576 rows x C=1024 x
     nich x2, PY(1, 0.1), warm start, block 131072, 10 sweeps; state
     invariants, finite joint score, capacity unchanged.
  B  all seven families in one spec through run_gibbs (R=262,144, C=256,
     init='random:16', 5 sweeps), then mixture.score_batch at C=1024 on
     4096 rows against the float64 hp flavor on the host.
  C  resume: 8 sweeps with an npz checkpoint every 4, resumed from sweep
     4, bitwise equal to the uninterrupted run (needs protobuf).
  D  device arithmetic at full width: the one-hot stat contraction
     against float64.
--four-cards: run_gibbs on a 4-card row mesh at 4,194,304 rows against a
1-card mesh with a 4x block, and one component-sharded and one 2-D (2x2)
argmax sweep each against a one-card reference.

Exits nonzero, printing no result line, when JAX finds no GPU or when any
phase fails.  The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


SIZES = dict(R_a=1 << 20, C_a=1024, block_a=131072, R_b=262144, C_b=256,
             block_b=32768, C_hp=1024, rows_hp=4096, R_4=1 << 22,
             block_4=131072, R_c=262144, C_c=1024, block_c=32768)


def phase_a(S=SIZES, card=None):
    import jax
    from distributions_tpu import checks
    from distributions_tpu.inference import runner
    spec, cl, sh, values, labels = checks.flagship_problem(
        S['R_a'], S['C_a'])
    kw = dict(block=S['block_a'], initial_assignments=labels,
              grow_headroom=0.0)
    t0 = time.perf_counter()
    jax.block_until_ready(runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(1), passes=1, **kw)[:2])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, an, log = runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(0), passes=10, **kw)
    jax.block_until_ready((state, an))
    ms = (time.perf_counter() - t0) / 10 * 1e3
    assert state.counts.shape[0] == S['C_a'], 'capacity grew'
    res = checks.check_state(spec, cl, sh, values, state, an)
    res.update(ms_per_sweep=ms, first_call_s=compile_s,
               capacity=int(state.counts.shape[0]),
               sweeps=len(log.rows), card=card)
    return res


def phase_b(S=SIZES, card=None):
    import jax
    import jax.numpy as jnp
    from distributions_tpu import checks, mixture as mx
    from distributions_tpu.inference import runner
    spec, cl, sh, values, _ = checks.mixed_problem(S['R_b'], S['C_b'])
    t0 = time.perf_counter()
    state, an, log = runner.run_gibbs(
        spec, cl, sh, values, jax.random.PRNGKey(0), passes=5,
        block=S['block_b'], init='random:16')
    jax.block_until_ready((state, an))
    run_s = time.perf_counter() - t0
    res = checks.check_state(spec, cl, sh, values, state, an)
    spec, cl, sh, values, labels = checks.mixed_problem(S['R_b'],
                                                        S['C_hp'])
    state = mx.state_from_assignments(spec, cl, sh, values,
                                      jnp.asarray(labels))
    rows = tuple(v[:S['rows_hp']] for v in values)
    res['hp_rel_err'] = checks.check_scores_vs_hp(spec, cl, sh, state,
                                                  rows)
    res['hp_rtol'] = checks.SCORE_RTOL
    res.update(run_s=run_s, card=card)
    return res


def phase_c(S=SIZES, card=None):
    try:
        import google.protobuf  # noqa: F401
    except ImportError:
        return {'skipped': 'protobuf is not installed'}
    import jax
    from distributions_tpu import checks
    spec, cl, sh, values, labels = checks.flagship_problem(
        S['R_a'], S['C_a'])
    res = checks.check_resume(
        spec, cl, sh, values, jax.random.PRNGKey(4), passes=8, every=4,
        block=S['block_a'], initial_assignments=labels, grow_headroom=0.0)
    res['card'] = card
    return res


def phase_d(S=SIZES, card=None):
    from distributions_tpu import checks
    res = checks.check_onehot_contraction(S['C_a'], S['block_a'])
    res['card'] = card
    return res


def phase_four(S=SIZES, card=None):
    import jax
    from distributions_tpu import checks
    devices = jax.devices()
    assert len(devices) >= 4, 'needs 4 devices, found %d' % len(devices)
    res, failed = {'card': card}, []
    for name, fn, args in (
            ('rows_mesh', checks.check_row_mesh,
             (S['R_4'], S['C_a'], S['block_4'])),
            ('components', checks.check_component_mesh,
             (S['R_c'], S['C_c'], S['block_c'])),
            ('mesh_2d', checks.check_2d_mesh,
             (S['R_c'], S['C_c'], S['block_c']))):
        try:
            res[name] = fn(devices[:4], *args)
        except AssertionError as e:
            res[name] = 'FAILED: %s' % e
            failed.append(name)
    print('phase four_cards results: %s' % json.dumps(res, default=str))
    assert not failed, 'failed: %s' % failed
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the 4-card mesh comparisons')
    args = ap.parse_args(argv)

    from distributions_tpu import runtime
    runtime.require_gpu()
    runtime.enable_compile_cache()
    card = runtime.card_line()
    phases = ([('four_cards', phase_four)] if args.four_cards else
              [('A', phase_a), ('B', phase_b), ('C', phase_c),
               ('D', phase_d)])
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(SIZES, card)
            status = 'ok'
        except Exception:   # report every phase, then fail the run
            traceback.print_exc()
            res, status, ok = {}, 'FAILED', False
        res['seconds'] = time.perf_counter() - t0
        print('phase %s: %s %s' % (name, status,
                                   json.dumps(res, default=str)))
        sys.stdout.flush()
    if not ok:
        return 1
    print(card)
    print(json.dumps({'ok': True, 'device': runtime.device_info()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
