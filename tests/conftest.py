# NOTE: no XLA_FLAGS here — smoke tests must see the real single CPU device.
# The multi-device dry-run integration test spawns a subprocess that sets
# --xla_force_host_platform_device_count itself (see test_dryrun_small.py).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:
    # the target container has no hypothesis and nothing may be installed;
    # _hypothesis_stub registers a deterministic sampling shim in its place
    import _hypothesis_stub  # noqa: F401  (self-installs into sys.modules)
    from hypothesis import HealthCheck, settings

settings.register_profile(
    "ci", max_examples=25, deadline=None,
    suppress_health_check=[HealthCheck.too_slow,
                           HealthCheck.data_too_large])
settings.load_profile("ci")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")
