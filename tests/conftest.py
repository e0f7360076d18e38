"""Test configuration.

By default everything runs on the CPU with 8 virtual devices, so the
multi-device sharding logic is exercised without accelerators.  Tests
marked `gpu` need an NVIDIA GPU and skip elsewhere; run them on a machine
with a card by selecting the CUDA platform:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
if os.environ['JAX_PLATFORMS'] == 'cpu':
    flags = os.environ.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in flags:
        os.environ['XLA_FLAGS'] = (
            flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ.setdefault('JAX_ENABLE_X64', '0')

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs an NVIDIA GPU; skipped on other platforms')
    config.addinivalue_line('markers', 'slow: long-running test')


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU.
    Decided here, at run time, so every xdist worker collects the same
    tests."""
    if (request.node.get_closest_marker('gpu') is not None
            and jax.devices()[0].platform != 'gpu'):
        pytest.skip('needs an NVIDIA GPU (JAX_PLATFORMS=cuda python -m '
                    'pytest tests/ -m gpu)')


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
