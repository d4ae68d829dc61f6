"""Timing helpers: the peak table, the warm-window timer, and the
profiler-trace device time that refuses to fall back to host time."""

import jax
import jax.numpy as jnp
import pytest

from hcspmm_tpu.utils.profiling import (DEVICE_PEAKS, device_peaks,
                                        device_time, roofline, time_windows)


def test_device_peaks_known_and_unknown():
    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_gbps"] == 3350.0 and p["bf16_tflops"] == 989.0
    assert set(DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]) >= {
        "hbm_gbps", "bf16_tflops", "tf32_tflops", "fp32_tflops"}
    with pytest.raises(KeyError):
        device_peaks("cpu")


def test_roofline_bound_and_shares():
    p = device_peaks("NVIDIA H100 80GB HBM3")
    r = roofline(1e-3, bytes_moved=3350e9 * 0.5e-3, flops=1e9, peaks=p)
    assert r["bound"] == "memory"
    assert abs(r["hbm_share"] - 0.5) < 1e-9
    assert r["speed_of_light_s"] == pytest.approx(0.5e-3)


def test_time_windows_waits_for_results():
    f = jax.jit(lambda v: (v @ v.T).sum())
    x = jnp.ones((64, 64))
    t = time_windows(f, x, calls=3, windows=3)
    assert t > 0


def test_device_time_raises_without_device_events(tmp_path):
    # the CPU trace has no device plane: no silent fall-back to host time
    f = jax.jit(lambda v: v + 1)
    with pytest.raises(RuntimeError):
        device_time(f, jnp.ones(8), iters=2, log_dir=str(tmp_path))


def test_compile_cache_location(monkeypatch):
    """One helper for every entry point: JAX_COMPILATION_CACHE_DIR wins and
    nothing else is set; otherwise .jax_cache/ at the checkout root."""
    import os

    from hcspmm_tpu.ops.spmm import resolve_impl
    from hcspmm_tpu.train.cli import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/elsewhere")
    enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        root, ".jax_cache")
    # and the platform, not the user, decides 'auto'
    assert resolve_impl("auto") == "xla"
    with pytest.raises(ValueError):
        resolve_impl("pallas")
