"""CLI introspection commands (reference distributions/__main__.py:33-100).

Usage:
  python -m distributions_tpu modes_by_model
  python -m distributions_tpu model_apis
  python -m distributions_tpu model_api nich
  python -m distributions_tpu benchmarks
"""

import argparse
import json
import sys

from distributions_tpu.models import MODULES

# the reference's dbg/lp flavors map onto execution modes of the JAX core;
# hp is a separate independent float64 implementation (distributions_tpu.hp)
MODES = ['eager', 'jit', 'batched']


def modes_by_model():
    """Print which execution modes / flavors support each model (the analog
    of the reference's flavors_by_model)."""
    from distributions_tpu.hp.models import MODULES as HP
    for name in sorted(MODULES):
        module = MODULES[name]
        flavors = list(MODES) + (['hp'] if name in HP else [])
        print('{} ({}): {}'.format(module.NAME, name, ' '.join(flavors)))


def model_api(name):
    module = MODULES[name]
    fns = sorted(
        attr for attr in dir(module)
        if not attr.startswith('_') and callable(getattr(module, attr))
        and attr not in ('Shared', 'Group'))
    print('{} ({})'.format(module.NAME, name))
    print('  Shared fields: {}'.format(
        ', '.join(module.Shared._fields)))
    print('  Group fields:  {}'.format(
        ', '.join(module.Group._fields)))
    print('  functions:     {}'.format(', '.join(fns)))


def model_apis():
    for name in sorted(MODULES):
        model_api(name)
        print()


def examples():
    out = {name: MODULES[name].EXAMPLES for name in sorted(MODULES)}
    print(json.dumps(
        out, default=lambda o: getattr(o, 'tolist', lambda: str(o))(),
        indent=2))


def benchmarks():
    print('run: python bench.py            # headline Gibbs benchmark')
    print('     python benchmarks/suite.py # full benchmark suite')


COMMANDS = {
    'modes_by_model': modes_by_model,
    'model_apis': model_apis,
    'examples': examples,
    'benchmarks': benchmarks,
}


def main():
    parser = argparse.ArgumentParser(prog='distributions_tpu')
    parser.add_argument('command',
                        choices=sorted(COMMANDS) + ['model_api'])
    parser.add_argument('args', nargs='*')
    ns = parser.parse_args()
    from distributions_tpu import runtime
    runtime.enable_compile_cache()
    if ns.command == 'model_api':
        for name in ns.args or sorted(MODULES):
            model_api(name)
    else:
        COMMANDS[ns.command]()


if __name__ == '__main__':
    main()
