"""Test configuration: force an 8-device virtual CPU mesh.

Tests never assume real TPU hardware; multi-chip sharding is validated on a
virtual CPU mesh exactly like the driver's dryrun (see __graft_entry__.py).
force_cpu_backend must run before any jax device use; enable_compile_cache
makes the 10-60s curve/sigverify compiles persistent across test runs.
"""

from firedancer_tpu.utils import platform as fd_platform

fd_platform.force_cpu_backend(device_count=8)
fd_platform.enable_compile_cache()

import os

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0x5F3759DF)


# -- two-tier suite -----------------------------------------------------------
# Tier 1 (default): every host-logic test — target < 20 min on one core.
# Tier 2 (opt-in):  XLA-compile-heavy tests (fresh sigverify/curve
# compiles, process-topology children cold-compiling, multichip shards).
# Run them with `pytest --slow` or FDTPU_SLOW=1.  The reference's CI has
# the same split (quick unit tier vs the long fuzz/conformance tier).


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="run the XLA-compile-heavy tier too",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: XLA-compile-heavy; opt in with --slow")
    config.addinivalue_line(
        "markers", "cuda: needs an H100 (CUDA kernels); skips without a card")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow") or os.environ.get("FDTPU_SLOW"):
        return
    skip = pytest.mark.skip(
        reason="slow tier (run with --slow or FDTPU_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
