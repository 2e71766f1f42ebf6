"""Test configuration: run everything on an 8-device virtual CPU mesh.

Mirrors the reference's load-bearing test idea (SURVEY.md §4): GPU/device
kernel code is exercised on CPU. Here the same JAX code that runs on TPU
runs on host CPU, and multi-chip sharding is validated with
``--xla_force_host_platform_device_count=8``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Tiered suite: the default run is the fast tier; BIFROST_SLOW=1 adds the
# expensive opt-in tests (XLA-compile-heavy full-scene gradients, larger
# sharded-training shapes). BIFROST_GOLDEN=1 separately enables the
# full-res golden-image gates (tests/test_golden.py).
SLOW_ENABLED = os.environ.get("BIFROST_SLOW", "") == "1"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: expensive opt-in test (set BIFROST_SLOW=1 to run)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips where there is none)")


def pytest_collection_modifyitems(config, items):
    if SLOW_ENABLED:
        return
    skip = pytest.mark.skip(reason="slow tier: set BIFROST_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
