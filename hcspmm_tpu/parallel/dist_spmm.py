"""Distributed hybrid SpMM over a jax.sharding.Mesh (shard_map + collectives).

One shard_map program serves all devices: each device slices its shard's
plan arrays (leading shard axis, in_spec P(axis)), assembles its X view
(all_gather or ppermute halo rounds, which XLA hands to NCCL), runs the same local hybrid
SpMM as the single-chip path, and emits its row block (out_spec P(axis)).

Backward reuses the forward operator (the reference's symmetric-structure
assumption, GNN_model.py:49-57): with a symmetric global A, the row-block
partition of A^T equals the column-block partition of A, and reusing the
forward plan is exact — same contract as single-chip ``make_spmm``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hcspmm_tpu.ops.spmm import SpmmShape, _dtype, spmm_apply
from hcspmm_tpu.parallel.partition import ShardedPlan, pad_rows


def _local_spmm(arrs, x_view, sharded: ShardedPlan, compute_dtype,
                interpret: bool):
    """Shard-local hybrid SpMM through the same implementation as the
    single-device path.  One shard_map program serves every shard, so the
    trace may consult only the shard-uniform capacities (never per-shard
    real counts): the band population always takes the merge path."""
    shape = SpmmShape(
        num_rows=sharded.rows_per_shard,
        num_buckets=sharded.num_buckets,
        num_ell=sharded.num_ell,
        num_band=sharded.num_band,
        window_h=sharded.window_h,
        num_sparse_rows=sharded.num_sparse_rows,
        xp_rows=sharded.xp_rows,
        num_spill_rows=sharded.num_spill_rows,
    )
    return spmm_apply(arrs, x_view, shape, compute_dtype, sharded.impl,
                      interpret)


def make_dist_spmm(
    sharded: ShardedPlan,
    mesh: Mesh,
    axis: str = "x",
    compute_dtype: str = "float32",
    interpret: bool = False,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Returns differentiable ``spmm(x) -> A @ x`` for global padded
    ``x: [n_padded, D]`` sharded (or shardable) as P(axis).
    ``interpret=True`` runs the band kernel through the Pallas
    interpreter (tests on the CPU)."""
    cd = _dtype(compute_dtype)
    stacked = {k: jnp.asarray(v) for k, v in sharded.stacked.items()}
    s = sharded.num_shards

    if sharded.mode == "allgather":

        def body(arrs, x_local):
            arrs = jax.tree.map(lambda a: a[0], arrs)
            x_full = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)
            return _local_spmm(arrs, x_full, sharded, cd, interpret)

    elif sharded.mode == "band_halo":
        hb = sharded.halo_pair

        def _strips(x_local):
            # two fixed-size boundary-strip exchanges; the local view
            # [prev strip | own | next strip] stays contiguous so the
            # banded path runs unchanged on shards
            prev_strip = jax.lax.ppermute(
                x_local[-hb:], axis,
                [(j, (j + 1) % s) for j in range(s)],
            )
            next_strip = jax.lax.ppermute(
                x_local[:hb], axis,
                [(j, (j - 1) % s) for j in range(s)],
            )
            return [prev_strip, x_local, next_strip]

        if sharded.far_pair:
            # hybrid: out-of-strip references (hubs, inter-community
            # edges) arrive via index-gather ppermute rounds appended
            # after the strips; the plan routes their edges to the
            # band+spill population, so band kernels never see them
            def body(arrs, x_local, send_idx_l):
                arrs = jax.tree.map(lambda a: a[0], arrs)
                send_idx_l = send_idx_l[0]          # [S-1, H]
                parts = _strips(x_local)
                for r in range(s - 1):
                    buf = jnp.take(x_local, send_idx_l[r], axis=0)
                    perm = [(j, (j + r + 1) % s) for j in range(s)]
                    parts.append(jax.lax.ppermute(buf, axis, perm))
                # [prev | own | next | halo rounds]: strip-relative ids
                # stay valid, far columns index the appended region
                x_view = jnp.concatenate(parts, axis=0)
                return _local_spmm(arrs, x_view, sharded, cd, interpret)
        else:

            def body(arrs, x_local):
                arrs = jax.tree.map(lambda a: a[0], arrs)
                x_view = jnp.concatenate(_strips(x_local), axis=0)
                return _local_spmm(arrs, x_view, sharded, cd, interpret)

    elif sharded.mode == "halo":
        send_idx = jnp.asarray(sharded.send_idx)
        h = sharded.halo_pair

        def body(arrs, x_local, send_idx_l):
            arrs = jax.tree.map(lambda a: a[0], arrs)
            send_idx_l = send_idx_l[0]              # [S-1, H]
            parts = [x_local]
            for r in range(s - 1):
                # round r: shard j sends to (j + r + 1); the receiver is
                # (j - r - 1)'s target, i.e. we receive from (i - r - 1).
                buf = jnp.take(x_local, send_idx_l[r], axis=0)  # [H, D]
                perm = [(j, (j + r + 1) % s) for j in range(s)]
                parts.append(jax.lax.ppermute(buf, axis, perm))
            x_view = jnp.concatenate(parts, axis=0)  # [rows_per + (S-1)H, D]
            return _local_spmm(arrs, x_view, sharded, cd, interpret)

    else:
        raise ValueError(sharded.mode)

    if sharded.send_idx is None:
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P(axis), stacked), P(axis)),
            out_specs=P(axis),
            # pallas_call emits vma-less ShapeDtypeStructs; the varying-
            # across-mesh check cannot see through it.  The pure-XLA impl
            # keeps the check on.
            check_vma=(sharded.impl == "xla"),
        )

        def run(arrays, x):
            return mapped(arrays["stacked"], x)

        arrays = {"stacked": stacked}
    else:
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P(axis), stacked), P(axis), P(axis)),
            out_specs=P(axis),
            check_vma=(sharded.impl == "xla"),
        )

        def run(arrays, x):
            return mapped(arrays["stacked"], x, arrays["send"])

        arrays = {"stacked": stacked, "send": jnp.asarray(sharded.send_idx)}

    from hcspmm_tpu.ops.spmm import _float0_zeros

    # plan arrays as arguments, not closure constants (ops.spmm.make_spmm)
    @jax.custom_vjp
    def dist_spmm(arrays, x):
        return run(arrays, x)

    def fwd(arrays, x):
        return run(arrays, x), (arrays,)

    def bwd(res, g):
        (arrays,) = res
        return (_float0_zeros(arrays), run(arrays, g))

    dist_spmm.defvjp(fwd, bwd)
    return dist_spmm, arrays


class DistHybridSpMM:
    """Preprocess + operator bundle for multi-chip SpMM.

    ``__call__`` expects global padded x ``[n_padded, D]``; use
    ``self.pad`` to zero-pad features and ``self.sharding`` to place them.
    """

    def __init__(
        self,
        row_pointers,
        column_index,
        num_nodes: int,
        mesh: Mesh,
        axis: str = "x",
        config=None,
        mode: str = "allgather",
        interpret: bool = False,
    ):
        from hcspmm_tpu.config import PlanConfig
        from hcspmm_tpu.parallel.partition import build_sharded_plan

        config = config or PlanConfig()
        self.mesh = mesh
        self.axis = axis
        self.sharded = build_sharded_plan(
            row_pointers, column_index, num_nodes,
            num_shards=mesh.shape[axis], config=config, mode=mode,
        )
        self.sharding = NamedSharding(mesh, P(axis))
        self._fn, self.arrays = make_dist_spmm(
            self.sharded, mesh, axis, compute_dtype=config.compute_dtype,
            interpret=interpret,
        )

    @property
    def n_padded(self) -> int:
        return self.sharded.n_padded

    def pad(self, x: np.ndarray) -> np.ndarray:
        return pad_rows(np.asarray(x), self.sharded.n_padded)

    def apply(self, arrays, x: jnp.ndarray) -> jnp.ndarray:
        """Jit-friendly form: plan arrays threaded as traced arguments."""
        return self._fn(arrays, x)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._fn(self.arrays, x)
