"""CLI — the experiment driver (reference: HC-SpMM_main.py:18-64).

Same flag surface: --dataset --dim --num_layers --hidden --classes
--epochs --model {gcn,gin} --single_kernel, plus extensions (--loi-mode,
--impl, --compute-dtype, --reorder, --checkpoint).

Dataset resolution: a path ending in .txt/.npz loads that file
("dst,src" 1-indexed text per dataset.py:52-53); the name 'example' (or
any unresolvable name) regenerates the deterministic synthetic stand-in
for the reference's missing Dataset.zip blob.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.graphs.dataset import GraphDataset
from hcspmm_tpu.models.net import Net
from hcspmm_tpu.models.sag import SAG
from hcspmm_tpu.ops.spmm import HybridSpMM
from hcspmm_tpu.train.loop import train
from hcspmm_tpu.utils.logging import stdout_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="hcspmm_tpu experiment driver")
    p.add_argument("--dataset", type=str, default="example", help="dataset")
    p.add_argument("--dim", type=int, default=96, help="input embedding dimension")
    p.add_argument("--num_layers", type=int, default=6, help="num layers")
    p.add_argument("--hidden", type=int, default=32, help="hidden dimension")
    p.add_argument("--classes", type=int, default=22, help="number of output classes")
    p.add_argument("--epochs", type=int, default=200, help="number of epoches")
    p.add_argument("--model", type=str, default="gcn", choices=["gcn", "gin", "sage"])
    p.add_argument("--single_kernel", action="store_true",
                   help="whether to profile a single SAG kernel")
    # extensions
    p.add_argument("--loi-mode", type=str, default="intended",
                   choices=["intended", "degenerate", "all_dense",
                            "all_sparse"])
    p.add_argument("--impl", type=str, default="auto",
                   choices=["auto", "xla", "triton"],
                   help="SpMM implementation (ops.spmm); 'auto' = the "
                        "Triton band kernel on a GPU, plain XLA elsewhere")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--bucket-widths", type=str, default="32,64,96,128,192,256",
                   help="comma-separated dense window width buckets")
    p.add_argument("--reorder", type=str, default="none",
                   choices=["none", "loa", "rcm", "cluster"],
                   help="graph layout reordering (LOA = reference LOI.cpp "
                        "greedy; rcm = bandwidth-minimizing; cluster = "
                        "community agglomeration + packing for the banded "
                        "path on mixed clustered graphs)")
    p.add_argument("--synthetic-nodes", type=int, default=65536)
    p.add_argument("--synthetic-degree", type=float, default=8.0)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save --checkpoint every N epochs during training "
                        "(enables elastic resume, train.elastic)")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint to load params from before training")
    p.add_argument("--fault-epoch", type=int, default=0,
                   help="fault injection: crash at this absolute epoch "
                        "(elastic-recovery testing, train.elastic)")
    p.add_argument("--normalize", action="store_true",
                   help="symmetric-normalized aggregation D^-1/2 A D^-1/2 "
                        "(the reference computes degrees but never applies "
                        "them; off = reference semantics)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="auto", choices=["auto", "cpu"],
                   help="cpu forces the host platform")
    return p


def load_dataset(args) -> GraphDataset:
    name = args.dataset
    if name.endswith(".txt") and os.path.exists(name):
        return GraphDataset.from_txt(name, args.dim, args.classes, args.seed)
    if os.path.exists(name) and name not in (".",):
        # real-dataset adapter (io.load_edges_any): reference npz, ogb
        # edge_index npz/npy, scipy CSR npz, ogb raw directory, csv
        return GraphDataset.from_file(name, args.dim, args.classes,
                                      args.seed)
    from hcspmm_tpu.graphs.real import REAL_GRAPHS

    if name.startswith("digits-knn") or name in REAL_GRAPHS:
        return GraphDataset.real(name, args.dim, args.classes, args.seed)
    candidate = os.path.join("Dataset", name + ".txt")
    if os.path.exists(candidate):
        return GraphDataset.from_txt(candidate, args.dim, args.classes, args.seed)
    return GraphDataset.synthetic(
        args.synthetic_nodes, args.synthetic_degree,
        args.dim, args.classes, seed=args.seed,
    )


def enable_compile_cache() -> None:
    """Persistent XLA compile cache, enabled by every entry point.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX uses it and nothing else is
    set; otherwise the cache lives in ``.jax_cache/`` at the root of the
    checkout (a fixed path: the path is part of the cache key)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    logger = stdout_logger(dataset=args.dataset, model=args.model)

    import jax

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    ds = load_dataset(args)
    cfg = PlanConfig(
        bucket_widths=tuple(int(v) for v in args.bucket_widths.split(",")),
        loi_mode=args.loi_mode,
        compute_dtype=args.compute_dtype,
        impl=args.impl,
    )

    start = time.perf_counter()
    if args.reorder != "none":
        from hcspmm_tpu.format import reorder as _reorder

        fn = {"loa": _reorder.loa_reorder, "rcm": _reorder.rcm_reorder,
              "cluster": _reorder.cluster_reorder}[args.reorder]
        perm = fn(ds.row_pointers, ds.column_index, ds.num_nodes)
        ds = ds.permuted(perm)
        reorder_ms = (time.perf_counter() - start) * 1e3
        logger.log(event="reorder", mode=args.reorder, reorder_ms=reorder_ms)
        start = time.perf_counter()
    op = HybridSpMM(ds.row_pointers, ds.column_index, ds.num_nodes, cfg,
                    normalize=args.normalize)
    prep_ms = (time.perf_counter() - start) * 1e3
    print("Prep. (ms):\t{:.3f}".format(prep_ms))
    print(f"impl: {op.impl}")
    logger.log(
        event="preprocess", prep_ms=prep_ms,
        num_nodes=ds.num_nodes, nnz=ds.nnz,
        dense_windows=op.plan.num_dense_windows,
        sparse_rows=op.plan.num_sparse_rows,
    )

    if args.single_kernel:
        sag = SAG(op)
        res = sag.profile(ds.x)
        logger.log(event="sag", avg_ms=res["avg_ms"],
                   gnnz_per_s=ds.nnz / (res["avg_ms"] * 1e-3) / 1e9)
        return 0

    net = Net(
        model=args.model,
        num_features=ds.num_features,
        hidden=args.hidden,
        num_classes=args.classes,
        num_layers=args.num_layers,
    )
    init_params = None
    start_epoch = 0
    if args.resume:
        from hcspmm_tpu.utils.checkpoint import load_pytree
        init_params, meta = load_pytree(args.resume)
        start_epoch = int(meta.get("epoch", 0))
        logger.log(event="resume", path=args.resume, **meta)
    res = train(net, op, ds.x, ds.y, epochs=args.epochs,
                seed=args.seed, logger=logger, init_params=init_params,
                checkpoint_path=args.checkpoint or None,
                checkpoint_every=args.checkpoint_every,
                start_epoch=start_epoch,
                fault_epoch=args.fault_epoch or None,
                # periodic checkpointing needs per-epoch (or small-chunk)
                # granularity; the default 10-epoch scan chunks would
                # quantize the save points
                scan_chunk=(1 if args.checkpoint_every else 10))
    logger.log(event="done", epoch_ms=res["epoch_ms"], final_loss=res["final_loss"])

    if args.checkpoint:
        from hcspmm_tpu.utils.checkpoint import save_pytree
        save_pytree(args.checkpoint, res["params"],
                    {"model": args.model,
                     # absolute epoch counter: what the elastic supervisor
                     # reads to decide whether the run is complete
                     "epoch": start_epoch + args.epochs,
                     "epochs": args.epochs})
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
