"""Compile-cache placement and the device peak table."""
import os
import subprocess

import jax
import pytest

from multicam_calibration_tpu.utils import compile_cache
from multicam_calibration_tpu.utils.flops import (
    device_peak_flops,
    device_peaks,
    lm_flops_detail,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}
    assert compile_cache.compile_cache_dir(env) == "/somewhere/cache"


def test_cache_dir_default_is_fixed_and_ignored_by_git():
    d = compile_cache.compile_cache_dir({})
    assert d == compile_cache.compile_cache_dir({})
    assert d == os.path.join(REPO, ".jax_cache")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", os.path.join(d, "x")], cwd=REPO
    )
    if ignored.returncode == 128:  # not a git checkout
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        assert ignored.returncode == 0


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_compile_cache(monkeypatch, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        if env_set:
            assert path == "/from/env"
            # JAX reads the variable itself; nothing else is set.
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == compile_cache.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_h100_peaks():
    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"f32_flops": 67e12, "f64_flops": 34e12,
                 "f64_tensor_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    assert device_peak_flops("NVIDIA H100 80GB HBM3") == (67e12, 67e12)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "unknown accelerator"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError):
        device_peaks(kind)
    with pytest.raises(KeyError):
        lm_flops_detail(6, 1000, 35, 10, 12, 0.1, kind)


def test_roofline_fraction_on_h100():
    d = lm_flops_detail(6, 1000, 35, 10, 12, 0.1, "NVIDIA H100 80GB HBM3",
                        n_obs=100_000, mixed_f32=False)
    assert 0 < d["roofline_fraction"] < 1
    assert d["f32_fraction"] > 0  # the f32 Jacobian
