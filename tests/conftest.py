"""Test configuration.

Runs the whole suite on the CPU backend with 8 virtual devices (mesh tests)
and x64 enabled (the reference's float64 parity test matrix). The env must be
set before jax is first imported, so this happens at conftest import time.
Tests marked ``gpu`` need the card: on it, run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (each such test checks
for a GPU in a fixture and skips elsewhere). chip_smoke.py is the card's
end-to-end check.
"""

import os

# 8 virtual CPU devices for mesh tests; must precede backend initialization.
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

# The config update (not only the env var) selects the platform even if a
# plugin registered itself before this file runs. CPU unless JAX_PLATFORMS
# names another (the gpu-marked tests on the card).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    # tests deliberately force engine="jax" on tiny problems to pin
    # numerics; the small-problem dispatch-latency warning is by design
    # (tested explicitly in test_api.py) and would otherwise spam the run
    config.addinivalue_line(
        "filterwarnings",
        "ignore:engine='jax' on a .* problem.*:RuntimeWarning")
