#!/usr/bin/env python
"""A/B of the SpMM implementations on one GPU, in one process.

    python tools/ab_impl.py [--rounds 3]

Runs bench.py's default cell (bf16) at dim 32 and 96, and the reference
GCN (6 layers, hidden 32) and GIN (5 layers, hidden 64) topologies
through main.py's CLI on a 334,925-node synthetic graph (degree 5, RCM,
float32 compute, 20 timed epochs), with ``impl`` 'triton' and 'xla' in
turns: T,X then X,T then T,X ...  Each run prints one JSON line; the
last lines give the median per workload and impl.  Compare numbers only
within one run of this script: the card's power limit is printed first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = ["--synthetic-nodes", "334925", "--synthetic-degree", "5",
         "--reorder", "rcm", "--epochs", "20", "--dim", "96",
         "--classes", "22"]
MODELS = {
    "gcn_epoch_ms": ["--model", "gcn", "--num_layers", "6", "--hidden", "32"],
    "gin_epoch_ms": ["--model", "gin", "--num_layers", "5", "--hidden", "64"],
}


def _records(text):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            with contextlib.suppress(ValueError):
                out.append(json.loads(line))
    return out


def run_bench(dim, impl):
    import bench

    os.environ.update(HCSPMM_BENCH_DIM=str(dim), HCSPMM_BENCH_IMPL=impl)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main()
    if rc:
        raise RuntimeError(f"bench.py exited {rc}")
    detail = [r for r in _records(err.getvalue()) if "spmm_us" in r][-1]
    keep = ("spmm_us", "moved_mb", "roofline_share", "band_widths",
            "spill_nnz", "direct_write")
    return detail["spmm_us"], {k: detail[k] for k in keep}


def run_epoch(argv, impl):
    from hcspmm_tpu.train import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv + GRAPH + ["--impl", impl])
    if rc:
        raise RuntimeError(f"main.py exited {rc}")
    done = [r for r in _records(out.getvalue()) if r.get("event") == "done"]
    return done[-1]["epoch_ms"], {"final_loss": done[-1]["final_loss"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3,
                    help="runs of each impl per workload")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"ab_impl.py measures a GPU; JAX found {dev.platform}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)

    workloads = {
        "bench_d32_us": lambda impl: run_bench(32, impl),
        "bench_d96_us": lambda impl: run_bench(96, impl),
    }
    for name, model_argv in MODELS.items():
        workloads[name] = lambda impl, a=model_argv: run_epoch(a, impl)
    times = {}
    for name, fn in workloads.items():
        for r in range(args.rounds):
            for impl in (("triton", "xla") if r % 2 == 0 else ("xla", "triton")):
                value, extra = fn(impl)
                times.setdefault((name, impl), []).append(value)
                print(json.dumps({"workload": name, "impl": impl,
                                  "value": value, **extra}), flush=True)
    for (name, impl), vals in times.items():
        print(json.dumps({"workload": name, "impl": impl,
                          "median": statistics.median(vals), "runs": vals}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
