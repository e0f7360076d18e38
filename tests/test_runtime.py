"""Entry-point set-up: compile-cache placement, the card line, and the
refusal to measure without a GPU."""

import os

import pytest

from distributions_tpu import runtime


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_defaults_to_checkout(monkeypatch, config_updates):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    path = runtime.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, '.jax_cache')
    assert config_updates == [('jax_compilation_cache_dir', path)]


def test_compile_cache_honours_env(monkeypatch, config_updates):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/some/where')
    assert runtime.enable_compile_cache() == '/some/where'
    assert config_updates == []


def test_compile_cache_dir_is_gitignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, '.gitignore')) as f:
        assert '.jax_cache/' in f.read().split()


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(runtime.shutil, 'which', lambda name: None)
    assert runtime.card_line() is None


def test_card_line_parses_nvidia_smi(monkeypatch):
    import subprocess

    class Done:
        returncode = 0
        stdout = 'NVIDIA H100 80GB HBM3, 700.00 W\n\n'

    monkeypatch.setattr(runtime.shutil, 'which', lambda name: '/bin/smi')
    monkeypatch.setattr(subprocess, 'run', lambda *a, **k: Done())
    assert runtime.card_line() == 'NVIDIA H100 80GB HBM3, 700.00 W'


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match='needs an NVIDIA GPU'):
        runtime.require_gpu()


def test_device_info_names_the_platform():
    info = runtime.device_info()
    assert info['platform'] == 'cpu' and info['count'] >= 1


def test_run_gibbs_needs_no_protobuf_or_orbax():
    """Without checkpoints, run_gibbs imports neither protobuf nor orbax
    (machines with a card may lack them)."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = '''
import sys
for name in ('google.protobuf', 'orbax', 'orbax.checkpoint'):
    sys.modules[name] = None
import jax
from distributions_tpu import checks
from distributions_tpu.inference import runner
spec, cl, sh, values, labels = checks.flagship_problem(256, 16)
state, an, log = runner.run_gibbs(spec, cl, sh, values,
                                  jax.random.PRNGKey(0), passes=2, block=64,
                                  initial_assignments=labels)
assert len(log.rows) == 2
'''
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('XLA_FLAGS', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
