"""Process set-up shared by the entry points (bench.py, chip_smoke.py,
benchmarks/, examples/, `python -m distributions_tpu`): the persistent
compile cache and the identity of the accelerator.  Nothing here runs on
library import; each entry point calls what it needs once, at start-up.
"""

import os
import shutil
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(CHECKOUT, '.jax_cache')


def enable_compile_cache():
    """Keep compiled programs across processes; returns the directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache is `<checkout>/.jax_cache`:
    a fixed path, because the path is part of what a later process
    must find again."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', CACHE_DIR)
    return CACHE_DIR


def card_line():
    """The cards' name and power limit, one 'name, limit' entry per card
    joined by '; ', as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them (None when nvidia-smi is absent
    or fails)."""
    exe = shutil.which('nvidia-smi')
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, '--query-gpu=name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        return None
    return '; '.join(lines)


def require_gpu():
    """Exit with a nonzero status unless JAX's default device is a GPU:
    measurement paths never fall back to the CPU.  Returns
    jax.devices()."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise SystemExit('this entry point needs an NVIDIA GPU; JAX found '
                         'platform %r' % devices[0].platform)
    return devices


def device_info():
    """{'platform', 'kind', 'count'} of JAX's devices."""
    import jax
    devices = jax.devices()
    return {'platform': devices[0].platform,
            'kind': devices[0].device_kind, 'count': len(devices)}
