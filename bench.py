#!/usr/bin/env python
"""Headline benchmark: hybrid SpMM nnz/s on one GPU.

The single-kernel aggregation benchmark (reference SAG profile,
GNN_model.py:251-262 / paper Table XVI) on a DD-scale stand-in graph
(the bundled example dataset is a missing blob in the reference snapshot).
DD (334,925 nodes / 1,686,092 edges, report Table II) is a union of small
disjoint protein graphs, so the stand-in is a shuffled block-diagonal
community graph; layout reordering has to rediscover the locality, as the
reference's LOA does on the real download.

Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

vs_baseline: reference HC-SpMM on DD does 1,686,092 nnz / 121.57 us
= 13.87 Gnnz/s on an RTX 3090 (BASELINE.md Table XVI).

Timing: warm windows of back-to-back applications on the host clock, each
ending in ``block_until_ready``; the median window is reported
(utils.profiling.time_windows).  The benchmark refuses to run on anything
but a GPU: a CPU number is not a device metric.

Env knobs: HCSPMM_BENCH_NODES, HCSPMM_BENCH_DEGREE, HCSPMM_BENCH_DIM,
HCSPMM_BENCH_DTYPE (bfloat16|float32), HCSPMM_BENCH_MODE (loi mode),
HCSPMM_BENCH_IMPL (auto|xla|triton), HCSPMM_BENCH_GRAPH
(blocks|span|powerlaw|standin:<RD|TT|DD|AZ|ARXIV|PRODUCTS>[@scale]),
HCSPMM_BENCH_REORDER (rcm|loa|cluster|none), HCSPMM_BENCH_BAND
(auto|always|never), HCSPMM_BENCH_BLOCK (community size),
HCSPMM_BENCH_BAND_H, HCSPMM_BENCH_BAND_WIDTHS (comma list; "" = auto).
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    nodes = int(os.environ.get("HCSPMM_BENCH_NODES", 334_928))
    degree = float(os.environ.get("HCSPMM_BENCH_DEGREE", 5.03))
    # dim 32 = the reference's Table XVI shape (the SAG profile runs
    # forward_fixed32, GNN_model.py:251-262)
    dim = int(os.environ.get("HCSPMM_BENCH_DIM", 32))
    dtype = os.environ.get("HCSPMM_BENCH_DTYPE", "bfloat16")
    mode = os.environ.get("HCSPMM_BENCH_MODE", "intended")
    impl = os.environ.get("HCSPMM_BENCH_IMPL", "auto")
    graph = os.environ.get("HCSPMM_BENCH_GRAPH", "blocks")
    reorder_mode = os.environ.get("HCSPMM_BENCH_REORDER", "rcm")
    band = os.environ.get("HCSPMM_BENCH_BAND", "auto")
    block = int(os.environ.get("HCSPMM_BENCH_BLOCK", 300))
    band_h = int(os.environ.get("HCSPMM_BENCH_BAND_H", 256))
    band_widths = os.environ.get("HCSPMM_BENCH_BAND_WIDTHS", "")

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")

    from hcspmm_tpu.train.cli import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.ops.spmm import HybridSpMM
    from hcspmm_tpu.utils.profiling import device_peaks, time_windows

    # one-time Python import (jax.experimental.pallas, ~2 s) before the
    # prep timer: prep_s measures graph preprocessing, not the interpreter
    import hcspmm_tpu.kernels.band  # noqa: F401

    t0 = time.perf_counter()
    if graph == "blocks":
        src, dst, nn = io.synthetic_blocks(nodes, degree, block, seed=7)
    elif graph == "powerlaw":
        # the reference's headline regime: non-bandable Chung-Lu tail
        src, dst, nn = io.synthetic_powerlaw(nodes, degree, seed=7)
    elif graph.startswith("standin:"):
        # Table II-matched power-law stand-in, e.g. standin:TT or
        # standin:RD@0.25 (scale factor after @)
        key, _, sc = graph[len("standin:"):].partition("@")
        src, dst, nn, dim = io.reference_standin(
            key, seed=7, scale=float(sc) if sc else 1.0)
    else:
        src, dst, nn = io.synthetic_graph(nodes, degree, seed=7, span=512)
    rp, ci = io.to_csr(src, dst, nn)
    nnz = int(rp[-1])
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if reorder_mode != "none":
        from hcspmm_tpu.format import reorder as _ro

        fn = {"rcm": _ro.rcm_reorder, "loa": _ro.loa_reorder,
              "cluster": _ro.cluster_reorder}[reorder_mode]
        perm = fn(rp, ci, nn)
        rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    reorder_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    extra = {"band_h": band_h}
    if band_widths:
        extra["band_widths"] = tuple(int(v) for v in band_widths.split(","))
    cfg = PlanConfig(loi_mode=mode, compute_dtype=dtype, impl=impl,
                     band_mode=band, **extra)
    op = HybridSpMM(rp, ci, nn, cfg)
    prep_s = time.perf_counter() - t0
    print(f"impl: {op.impl}", file=sys.stderr)

    # inputs/outputs carried in compute dtype (training runs in bf16; the
    # reference's Table VII ran half at the same quality)
    x = jnp.asarray(
        np.random.RandomState(0).randn(nn, dim).astype(np.float32)
    ).astype(dtype)
    fn = jax.jit(lambda a, v: op.apply(a, v))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(op.arrays, x))
    compile_s = time.perf_counter() - t0
    dur = time_windows(fn, op.arrays, x)

    gnnz = nnz / dur / 1e9
    baseline_gnnz = 13.87  # RTX 3090, DD, BASELINE.md Table XVI
    plan = op.plan
    # bytes the plan moves: band and dense-bucket A blocks as uploaded for
    # this impl (bit-packed for the kernel, int8 for XLA), band X slices,
    # gathered rows (one X row per dense-bucket column / ELL slot /
    # residual / spill edge), output
    xbytes = 2 if dtype == "bfloat16" else 4
    f_arrays = op.arrays["f"]
    a_bytes = sum(
        f_arrays[f"band{s}_a"].nbytes for s in range(len(plan.band_widths))
    ) + sum(
        f_arrays[f"b{b}_a"].nbytes for b in range(len(plan.bucket_widths))
    )
    band_x_bytes = sum(
        len(plan.band_sw_ids[s]) * plan.band_widths[s] * dim * xbytes
        for s in range(len(plan.band_widths))
    )
    gather_rows = sum(
        len(plan.bucket_window_ids[b]) * plan.bucket_widths[b]
        for b in range(len(plan.bucket_widths))
    ) + sum(
        len(plan.ell_row_ids[e]) * plan.ell_widths[e]
        for e in range(len(plan.ell_widths))
    ) + plan.sparse_nnz + plan.spill_nnz
    total_bytes = (a_bytes + band_x_bytes + gather_rows * dim * xbytes
                   + nn * dim * xbytes)
    peaks = device_peaks(dev.device_kind)
    roofline_us = total_bytes / (peaks["hbm_gbps"] * 1e9) * 1e6
    # INTRINSIC bytes: the CSR-ideal traffic — ~8 B/nnz of A (int32 col +
    # amortized row pointer), each referenced X row read once, the output
    # written once.  moved/intrinsic is the plan's traffic inflation.
    uniq_cols = int(np.unique(ci).size)
    intrinsic_bytes = (nnz * 8 + uniq_cols * dim * xbytes
                       + nn * dim * xbytes)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({
        "spmm_us": dur * 1e6,
        "roofline_us": roofline_us,
        "roofline_share": roofline_us / (dur * 1e6),
        "moved_mb": total_bytes / 1e6,
        "intrinsic_mb": intrinsic_bytes / 1e6,
        "traffic_inflation": total_bytes / max(intrinsic_bytes, 1),
        "nnz": nnz, "nodes": nn, "dim": dim, "dtype": dtype, "mode": mode,
        "impl": op.impl, "graph": graph, "reorder": reorder_mode,
        "band_supers": plan.num_band_supers, "band_nnz": plan.band_nnz,
        "direct_write": plan.direct_bucket >= 0,
        "dense_windows": plan.num_dense_windows,
        "dense_nnz": plan.dense_nnz, "sparse_nnz": plan.sparse_nnz,
        "spill_nnz": plan.spill_nnz, "band_widths": list(plan.band_widths),
        "prep_s": prep_s, "reorder_s": reorder_s, "graphgen_s": gen_s,
        "compile_s": compile_s, "device": device,
    }), file=sys.stderr)
    print(json.dumps({
        "metric": "spmm_nnz_per_s",
        "value": gnnz,
        "unit": "Gnnz/s",
        # the denominator is the reference's number on the REAL DD dataset
        # on an RTX 3090 at dim 32; the numerator is this card on the
        # DD-matched stand-in
        "vs_baseline": gnnz / baseline_gnnz,
        "baseline_ref": ("DD@dim32 RTX3090 (Table XVI), stand-in graph"
                         + ("" if dim == 32 else f", ours at dim={dim}")),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
