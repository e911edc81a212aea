"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

Multi-device sharding is exercised without GPUs by forcing the host
platform to expose 8 devices (SURVEY.md §4 test strategy). x64 is enabled so
CPU tests compare against float64 numpy/cv2/scipy oracles at tight tolerance;
the library itself is dtype-polymorphic.
"""
import os

# jax.config.update('jax_platforms', 'cpu') before any backend
# initialization keeps the tests on the CPU even on a GPU host.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles ~200 XLA:CPU programs in one process; around
    program ~190 XLA's backend_compile_and_load segfaults while compiling
    the 8-device shard_map solver (test_lm_chunked) — the same test
    passes in isolation, i.e. the crash is accumulated-state-dependent,
    not a bug in the program being compiled. Dropping the executable
    caches between modules keeps the live-program count bounded; each
    module recompiles only what it shares with the previous one (small —
    modules mostly compile their own programs).
    """
    yield
    jax.clear_caches()
