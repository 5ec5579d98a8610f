"""Test harness config.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
paths (mesh/pjit/shard_map/ppermute) are exercised without accelerators —
the pattern SURVEY.md §4 prescribes. `NMPC_GPU_TESTS=1` leaves the platform
alone, so the `gpu`-marked tests run on the card:

    NMPC_GPU_TESTS=1 python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if not os.environ.get("NMPC_GPU_TESTS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with NMPC_GPU_TESTS=1 -m gpu)")
