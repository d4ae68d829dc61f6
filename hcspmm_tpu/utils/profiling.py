"""Timing + roofline helpers.

The reference measured with manual perf_counter spans and external
nvprof/Nsight (SURVEY.md §5).  Here: a `Timer` with device sync, a
window timer on host clocks that end in ``block_until_ready``, device time
from a ``jax.profiler`` trace, and a `roofline` calculator against the
published peaks of the device the numbers came from.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, Optional

import jax

# Published peaks per ``jax.Device.device_kind``: NVIDIA H100 data sheet,
# SXM part, dense rates without sparsity, at the full 700 W power limit.
# A card set below that limit cannot hold its top clock under load, so
# every roofline share is reported beside the card's power limit.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
    },
}


def device_peaks(kind: str) -> Dict[str, float]:
    """Peaks of ``kind``; a device not in the table is an error."""
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; add "
                       "them to utils.profiling.DEVICE_PEAKS with a source")
    return DEVICE_PEAKS[kind]


class Timer:
    """Wall-clock timing with device synchronization per stop."""

    def __init__(self):
        self.records: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        self.records[name] = self.records.get(name, 0.0) + time.perf_counter() - t0


def time_windows(fn, *args, calls: int = 20, windows: int = 5,
                 warmup: int = 2) -> float:
    """Median seconds per ``fn(*args)`` over ``windows`` warm windows of
    ``calls`` back-to-back calls, each window ending in
    ``block_until_ready`` (JAX returns before the device finishes, so a
    window without it would time the enqueue).  ``warmup`` calls compile
    and settle the shapes first."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    per_call = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t0) / calls)
    return statistics.median(per_call)


def device_time(fn, *args, iters: int = 20, log_dir: Optional[str] = None,
                name: str = "jit_") -> float:
    """Device seconds per call of a jitted ``fn``, from a profiler trace:
    the summed device durations of the events whose name starts with
    ``name``, over ``iters`` traced calls.  Raises when the trace holds no
    such event (no silent fall-back to host time)."""
    import shutil
    import tempfile

    jax.block_until_ready(fn(*args))
    tmp = log_dir or tempfile.mkdtemp(prefix="hcspmm_prof_")
    try:
        with jax.profiler.trace(tmp):
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
        total_ns = _trace_device_ns(tmp, name)
    finally:
        if log_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    if not total_ns:
        raise RuntimeError(f"profiler trace in {tmp} holds no device event "
                           f"named {name}*")
    return total_ns / iters / 1e9


def _trace_device_ns(log_dir: str, prefix: str) -> float:
    """Summed duration (ns) of device-plane events named ``prefix*`` in the
    newest ``.xplane.pb`` under ``log_dir``."""
    import glob

    paths = sorted(glob.glob(f"{log_dir}/plugins/profile/*/*.xplane.pb"))
    if not paths:
        return 0.0
    data = jax.profiler.ProfileData.from_file(paths[-1])
    total = 0.0
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name.startswith(prefix):
                    total += ev.duration_ns
    return total


def roofline(
    seconds: float,
    bytes_moved: float,
    flops: float,
    peaks: Dict[str, float],
    nnz: Optional[int] = None,
) -> Dict:
    """Achieved vs peak (``peaks`` from ``device_peaks``); ``bound`` names
    the limiting resource at 100% efficiency."""
    t_mem = bytes_moved / (peaks["hbm_gbps"] * 1e9)
    t_tc = flops / (peaks["bf16_tflops"] * 1e12)
    res = {
        "seconds": seconds,
        "gbytes_per_s": bytes_moved / seconds / 1e9,
        "hbm_share": t_mem / seconds if seconds else 0.0,
        "tflops": flops / seconds / 1e12,
        "tensor_core_share": t_tc / seconds if seconds else 0.0,
        "bound": "memory" if t_mem >= t_tc else "compute",
        "speed_of_light_s": max(t_mem, t_tc),
    }
    if nnz:
        res["gnnz_per_s"] = nnz / seconds / 1e9
    return res


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler trace of the enclosed block (jax.profiler)."""
    with jax.profiler.trace(log_dir):
        yield
