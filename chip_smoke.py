#!/usr/bin/env python
"""On-card smoke test: the system's main path on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the distributed path only

Phases (one process, so only this process opens the card):

1. device: platform, device kind and count; the card's name and power
   limit from ``nvidia-smi`` (a child process that stays off JAX).
2. calibrate: the routing constants of PlanConfig (a large copy, a random
   row gather at dim 32 bf16, the band path's time per A element and per
   spilled edge for each compute dtype, the spill chain alone).
3. spmm: every population of the hybrid SpMM, on both implementations
   (the Triton band kernel as compiled for the card, and plain XLA),
   against a scipy float64 CSR reference at DD@1.0 (band default, then
   band off with all-dense and all-sparse routing) and RD@1.0 (the
   power-law spill regime), dims 32 and 96, bf16 and float32; the VJP
   against A^T g; ``memory_analysis()`` of the band step.
4. entry points: the GCN and GIN trainers, ``bench.py`` and the SAG
   profile at DD size, as a user runs them.
5. tests: the ``gpu``-marked tests, through ``pytest.main``.

Any failure exits non-zero.  The last line of standard output is a JSON
object with ``ok`` and the device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io as _io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# relative Frobenius error limits: bf16 inputs with float32 accumulation,
# and float32 without TF32 (Precision.HIGHEST / IEEE dots)
TOL = {"bfloat16": 1e-2, "float32": 1e-5}


def log(*a):
    print(*a, flush=True)


class _Tee(_io.TextIOBase):
    """Copies writes to stdout into a buffer (entry points log there)."""

    def __init__(self, out):
        self.out, self.buf = out, _io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _records(text):
    recs = []
    for line in text.splitlines():
        if line.startswith("{"):
            with contextlib.suppress(ValueError):
                recs.append(json.loads(line))
    return recs


def _graph(key, scale=1.0, reorder=True):
    """Table II stand-in (graphs.io.reference_standin), RCM-reordered."""
    from hcspmm_tpu.format import reorder as ro
    from hcspmm_tpu.graphs import io

    src, dst, n, _ = io.reference_standin(key, seed=7, scale=scale)
    rp, ci = io.to_csr(src, dst, n)
    if reorder:
        rp, ci = ro.apply_permutation(rp, ci, n, ro.rcm_reorder(rp, ci, n))
    return rp, ci, n


def _bench_graph(scale=1.0):
    """bench.py's default cell: the DD-scale block graph, RCM-reordered."""
    from hcspmm_tpu.format import reorder as ro
    from hcspmm_tpu.graphs import io

    src, dst, n = io.synthetic_blocks(int(334928 * scale), 5.03, 300, seed=7)
    rp, ci = io.to_csr(src, dst, n)
    rp, ci = ro.apply_permutation(rp, ci, n, ro.rcm_reorder(rp, ci, n))
    return rp, ci, n


def _csr(rp, ci, n):
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    a.sum_duplicates()
    a.data[:] = 1.0  # binary adjacency: duplicate edges collapse
    return a


def _rel(z, ref):
    import numpy as np

    return float(np.linalg.norm(np.asarray(z, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


# --------------------------------------------------------------- phases


def phase_calibrate(scale=1.0):
    """Constants for PlanConfig's routing cost model, measured here."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.ops.spmm import HybridSpMM, _add_spill
    from hcspmm_tpu.utils.profiling import time_windows

    n = int((1 << 28) * scale)
    a = jnp.ones((n,), jnp.float32)
    t = time_windows(jax.jit(lambda v: v * 1.0001), a)
    log(f"calibrate: copy {2 * n * 4 / t / 1e9:.1f} GB/s "
        f"(read+write of {n * 4 / 1e9:.2f} GB) -> stream_gbps")
    del a
    rp, ci, nn = _bench_graph(scale)
    tbl = jnp.ones((nn, 32), jnp.bfloat16)
    m = 1 << 22
    idx = jnp.asarray(np.random.RandomState(1).randint(0, nn, m)
                      .astype(np.int32))
    t = time_windows(jax.jit(lambda t_, i: jnp.take(t_, i, axis=0)), tbl, idx)
    log(f"calibrate: random row gather dim 32 bf16 over {nn} rows: "
        f"{m * 64 / t / 1e9:.1f} GB/s ({t / m * 1e9:.4f} ns/row) "
        "-> take_gbps")
    # the band path's price per A element (W = 576: every superwindow
    # banded, no spill, direct write) and the price of each edge a
    # narrower band spills (W = 192), per compute dtype
    for dt in ("bfloat16", "float32"):
        meas = {}
        for w in (576, 192):
            op = HybridSpMM(rp, ci, nn, PlanConfig(
                compute_dtype=dt, band_mode="always", band_widths=(w,)))
            p = op.plan
            xd = jnp.ones((nn, 32), dt)
            t = time_windows(jax.jit(lambda ar, v, op=op: op.apply(ar, v)),
                             op.arrays, xd)
            a_elems = sum(len(s) * p.band_h * bw
                          for s, bw in zip(p.band_sw_ids, p.band_widths))
            meas[w] = (t, a_elems, p.spill_nnz)
            log(f"calibrate: {dt} d32 W={w} ({op.impl}, direct write "
                f"{p.direct_bucket >= 0}, spill {p.spill_nnz}): "
                f"{t * 1e6:.1f} us over {a_elems} A elements")
        t0, a0, _ = meas[576]
        t1, a1, e1 = meas[192]
        per_a = t0 / a0
        per_e = (t1 - per_a * a1) / max(e1, 1)
        log(f"calibrate: {dt}: {per_a * 1e12:.4f} ps per A element -> "
            f"a_elem_ps{' * A_ELEM_F32_SCALE' if dt == 'float32' else ''}; "
            f"{per_e * 1e9:.4f} ns per spilled edge (fixed cost included) "
            f"= {32 * 4 / per_e / 1e9:.0f} GB/s at 128 B/edge -> take_gbps")
    x = jnp.ones((nn, 32), jnp.bfloat16)
    # spill chain (take + segment-sum + scatter-add) over sorted random
    # rows: fixed cost and per-edge slope from two sizes
    rng = np.random.RandomState(0)
    base = jax.jit(lambda v: (v * 2).astype(jnp.float32))
    t_base = time_windows(base, x)
    pts = []
    for e in (1 << 17, 1 << 20):
        rows_e = np.sort(rng.randint(0, nn, e))
        flags = np.r_[True, rows_e[1:] != rows_e[:-1]]
        arr = {"spill_rows": jnp.asarray(rows_e[flags].astype(np.int32)),
               "spill_edge_col": jnp.asarray(rng.randint(0, nn, e)
                                             .astype(np.int32)),
               "spill_edge_seg": jnp.asarray((np.cumsum(flags) - 1)
                                             .astype(np.int32))}
        nrows = int(flags.sum())
        f = jax.jit(lambda v, ar, nrows=nrows: _add_spill(
            (v * 2).astype(jnp.float32), ar, v, nrows))
        pts.append((e, time_windows(f, x, arr) - t_base))
    (e0, t0), (e1, t1) = pts
    slope = (t1 - t0) / (e1 - e0)
    log(f"calibrate: spill chain {e0} edges {t0 * 1e6:.1f} us, {e1} edges "
        f"{t1 * 1e6:.1f} us: {t0 * 1e6 - slope * e0 * 1e6:.1f} us fixed + "
        f"{slope * 1e9:.4f} ns/edge -> spill_fixed_s")


def phase_spmm(results, graphs=(("DD", 1.0), ("RD", 1.0)), dims=(32, 96)):
    """Every population on both implementations vs scipy float64."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.ops.spmm import HybridSpMM

    for key, scale in graphs:
        t0 = time.perf_counter()
        rp, ci, nn = _graph(key, scale)
        a = _csr(rp, ci, nn)
        log(f"spmm: {key}@{scale} n={nn} nnz={len(ci)} "
            f"(graph + RCM {time.perf_counter() - t0:.1f} s)")
        modes = [dict()]
        if key == "DD":
            modes += [dict(band_mode="never", loi_mode="all_dense"),
                      dict(band_mode="never", loi_mode="all_sparse")]
        for mode in modes:
            for dt in ("bfloat16", "float32"):
                t0 = time.perf_counter()
                ops = {impl: HybridSpMM(rp, ci, nn, PlanConfig(
                    compute_dtype=dt, impl=impl, **mode))
                    for impl in ("triton", "xla")}
                p = ops["triton"].plan
                log(f"spmm: {key} {mode or 'default'} {dt}: plan "
                    f"{time.perf_counter() - t0:.1f} s, widths "
                    f"{p.band_widths}, direct={p.direct_bucket >= 0}, "
                    f"nnz band/spill/dense/sparse = {p.band_nnz}/"
                    f"{p.spill_nnz}/{p.dense_nnz}/{p.sparse_nnz}")
                for d in dims:
                    xh = np.random.RandomState(d).randn(nn, d).astype(
                        np.float32)
                    x = jnp.asarray(xh).astype(dt)
                    ref = a @ np.asarray(x.astype(jnp.float32), np.float64)
                    for impl, op in ops.items():
                        fn = jax.jit(lambda ar, v, op=op: op.apply(ar, v))
                        z = fn(op.arrays, x).astype(jnp.float32)
                        err = _rel(z, ref)
                        name = f"{key} {mode or 'default'} {dt} d{d} {impl}"
                        ok = err <= TOL[dt] and z.shape == (nn, d)
                        results.append((name, err, ok))
                        log(f"spmm: {name}: rel err {err:.3e} "
                            f"(limit {TOL[dt]:.0e}) {'ok' if ok else 'FAIL'}")
                        if dt == "float32" and d == dims[0]:
                            # VJP: the backward aggregation against A^T g
                            g = jnp.asarray(np.random.RandomState(1).randn(
                                nn, d).astype(np.float32))
                            _, vjp = jax.vjp(lambda v: op.apply(
                                op.arrays, v), x)
                            (gx,) = vjp(g)
                            verr = _rel(gx, a.T @ np.asarray(g, np.float64))
                            vok = verr <= TOL[dt]
                            results.append((name + " vjp", verr, vok))
                            log(f"spmm: {name} vjp vs A^T g: rel err "
                                f"{verr:.3e} {'ok' if vok else 'FAIL'}")
                if key == "DD" and not mode and dt == "bfloat16":
                    op = ops["triton"]
                    x = jnp.zeros((nn, dims[0]), jnp.bfloat16)
                    ma = jax.jit(lambda ar, v: op.apply(ar, v)).lower(
                        op.arrays, x).compile().memory_analysis()
                    log(f"spmm: band step memory_analysis (DD bf16 "
                        f"d{dims[0]}): {ma}")
                del ops


def _run_cli(argv):
    from hcspmm_tpu.train import cli

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    return rc, tee.buf.getvalue()


def phase_entry_points(results, nodes=334925):
    """The README's entry points at DD size, in this process."""
    g = ["--synthetic-nodes", str(nodes), "--synthetic-degree", "5",
         "--reorder", "rcm"]
    runs = {
        "gcn": ["--model", "gcn", "--dim", "96", "--num_layers", "6",
                "--hidden", "32", "--classes", "22", "--epochs", "5"] + g,
        "gin": ["--model", "gin", "--dim", "96", "--num_layers", "5",
                "--hidden", "64", "--classes", "22", "--epochs", "5"] + g,
    }
    for name, argv in runs.items():
        log(f"entry: python main.py {' '.join(argv)}")
        rc, out = _run_cli(argv)
        recs = _records(out)
        init = [r["loss"] for r in recs if r.get("event") == "init"]
        losses = [r["loss"] for r in recs if "epoch" in r and "loss" in r]
        import math

        # finite everywhere, and the trained loss below the initial one
        ok = (rc == 0 and "Prep. (ms):" in out and len(losses) == 5
              and len(init) == 1
              and all(math.isfinite(v) for v in init + losses)
              and losses[-1] < init[0])
        results.append((f"train {name}", losses[-1] if losses else None, ok))
        log(f"entry: {name} initial loss {init}, epoch losses {losses} "
            f"{'ok' if ok else 'FAIL'}")
    log("entry: python main.py --single_kernel " + " ".join(g))
    rc, out = _run_cli(["--single_kernel", "--dim", "32"] + g)
    sag = [r for r in _records(out) if r.get("event") == "sag"]
    ok = rc == 0 and "Prep. (ms):" in out and len(sag) == 1
    results.append(("sag", sag[0]["avg_ms"] if sag else None, ok))
    log(f"entry: SAG {'ok' if ok else 'FAIL'}")
    log("entry: python bench.py")
    import bench

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = bench.main()
    last = _records(tee.buf.getvalue())
    ok = rc == 0 and bool(last) and last[-1].get("value", 0) > 0
    results.append(("bench", last[-1].get("value") if last else None, ok))
    log(f"entry: bench {'ok' if ok else 'FAIL'}")


def phase_tests(results):
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    results.append(("gpu tests", int(rc), rc == 0))
    log(f"tests: gpu-marked tests exit {int(rc)} "
        f"{'ok' if rc == 0 else 'FAIL'}")


def phase_multi(results, scale=1.0, dim=96, impl="auto", interpret=False):
    """DistHybridSpMM on a 1-D mesh of four devices: forward and
    gradient against scipy, then one GCN and one GIN training step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.models.net import Net, init_net_params, net_forward
    from hcspmm_tpu.parallel.dist_spmm import DistHybridSpMM
    from hcspmm_tpu.train.loop import nll_loss

    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise RuntimeError(f"--multi needs 4 devices, JAX has {len(devs)}")
    mesh = Mesh(np.array(devs), ("x",))
    rp, ci, nn = _graph("DD", scale)
    a = _csr(rp, ci, nn)
    x = np.random.RandomState(0).randn(nn, dim).astype(np.float32)
    ref = a @ x.astype(np.float64)
    g = np.random.RandomState(1).randn(nn, dim).astype(np.float32)
    gref = a.T @ g.astype(np.float64)
    for mode in ("band_halo", "halo"):
        t0 = time.perf_counter()
        op = DistHybridSpMM(rp, ci, nn, mesh, mode=mode,
                            config=PlanConfig(impl=impl), interpret=interpret)
        log(f"multi: {mode} plan {time.perf_counter() - t0:.1f} s "
            f"(impl {op.sharded.impl}, halo {op.sharded.halo_pair}, "
            f"far {op.sharded.far_pair})")
        xs = jax.device_put(op.pad(x), op.sharding)
        fn = jax.jit(lambda ar, v: op.apply(ar, v))
        z = np.asarray(fn(op.arrays, xs))[:nn]
        err = _rel(z, ref)
        gs = jax.device_put(op.pad(g), op.sharding)
        _, vjp = jax.vjp(lambda v: op.apply(op.arrays, v), xs)
        gx = np.asarray(vjp(gs)[0])[:nn]
        gerr = _rel(gx, gref)
        ok = err <= TOL["float32"] and gerr <= TOL["float32"]
        results.append((f"multi {mode}", max(err, gerr), ok))
        log(f"multi: {mode} forward rel err {err:.3e}, vjp rel err "
            f"{gerr:.3e} {'ok' if ok else 'FAIL'}")
        ys = jax.device_put(np.concatenate(
            [np.ones(nn, np.int32), np.ones(op.n_padded - nn, np.int32)]),
            NamedSharding(mesh, P("x")))
        rep = NamedSharding(mesh, P())
        opt = optax.adam(0.01)
        for model in ("gcn", "gin"):
            net = Net(model=model, num_features=dim, hidden=32,
                      num_classes=22, num_layers=3)
            params = jax.device_put(init_net_params(
                net, jax.random.PRNGKey(0)), rep)
            state = jax.device_put(opt.init(params), rep)

            def loss_fn(prm, ar, v, y, net=net):
                return nll_loss(net_forward(
                    net, prm, lambda u: op.apply(ar, u), v, train=False), y)

            @jax.jit
            def step(prm, st, ar, v, y, loss_fn=loss_fn):
                loss, grads = jax.value_and_grad(loss_fn)(prm, ar, v, y)
                upd, st = opt.update(grads, st, prm)
                return optax.apply_updates(prm, upd), st, loss

            params, state, l0 = step(params, state, op.arrays, xs, ys)
            params, state, l1 = step(params, state, op.arrays, xs, ys)
            ok = bool(np.isfinite(float(l0)) and np.isfinite(float(l1)))
            results.append((f"multi {mode} {model} step", float(l1), ok))
            log(f"multi: {mode} {model} training steps loss "
                f"{float(l0):.4g} -> {float(l1):.4g} "
                f"{'ok' if ok else 'FAIL'}")


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the distributed path on 4 cards, nothing else")
    args = ap.parse_args(argv)

    try:
        import hcspmm_tpu
    except ImportError:
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not os.path.abspath(hcspmm_tpu.__file__).startswith(HERE + os.sep):
        print("hcspmm_tpu does not come from this checkout", file=sys.stderr)
        return 2

    import jax

    devs = jax.devices()
    dev = devs[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    if dev.platform != "gpu":
        print("no GPU: chip_smoke.py runs on the card only", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    # the card's name and power limit, exactly as nvidia-smi gives them
    for line in smi.stdout.strip().splitlines():
        log(line.strip())

    from hcspmm_tpu.train.cli import enable_compile_cache

    enable_compile_cache()
    sys.path.insert(0, HERE)  # bench.py is a module of the checkout

    results = []
    if args.multi:
        phases = [("multi", lambda: phase_multi(results))]
        want = 4
    else:
        phases = [("calibrate", phase_calibrate),
                  ("spmm", lambda: phase_spmm(results)),
                  ("entry points", lambda: phase_entry_points(results)),
                  ("tests", lambda: phase_tests(results))]
        want = 1
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"=== phase {name}")
        try:
            fn()
        except Exception:  # a phase that raises fails the run, others go on
            traceback.print_exc()
            failed.append(name)
        log(f"=== phase {name}: {time.perf_counter() - t0:.1f} s")
    failed += [r[0] for r in results if not r[2]]
    n_dev = len(jax.devices())
    log(f"total {time.perf_counter() - t_all:.1f} s; "
        f"{len(results)} checks, {len(failed)} failed")
    if failed or n_dev < want:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
