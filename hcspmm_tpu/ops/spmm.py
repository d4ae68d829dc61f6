"""Differentiable hybrid SpMM: ``Z = A @ X`` for a binary adjacency A.

The counterpart of the reference kernel family
``spmm_forward_cuda_kernel_arbi_warps_hybrid_*`` (hybrid_all_kernel.cu:919-2770)
plus the autograd wiring of GNN_model.py:26-233:

- forward and backward aggregation are the *same* operator; the reference
  binds ``backward_*`` to the same launchers (hybrid_all.cpp:516-523) and
  reuses untransposed A in backward, which is exact only for symmetric
  graph structure (GNN_model.py:49-57).  ``make_spmm`` mirrors that by
  default and accepts an explicit transposed plan for the safe mode the
  reference lacks.
- aggregation is an unweighted neighbour sum (binary A; no value array
  anywhere in the reference kernels).

Implementations (``PlanConfig.impl``):
- ``'xla'``   : every population as plain XLA — gather + batched matmul +
  sorted segment-sums, merged by one output permutation.
- ``'triton'``: the band population through the Pallas/Triton kernel
  (kernels/band.py), which writes each superwindow's rows in place; the
  other populations stay in XLA.
- ``'auto'``  : ``'triton'`` on a GPU, ``'xla'`` on any other backend.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.format.plan import ExecutionPlan, build_plan, transpose_csr

IMPLS = ("xla", "triton")


def resolve_impl(impl: str) -> str:
    """Map ``'auto'`` to the implementation for the default JAX backend."""
    if impl == "auto":
        return "triton" if jax.default_backend() == "gpu" else "xla"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r} (expected auto|xla|triton)")
    return impl


def _dtype(name: str):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _precision(compute_dtype):
    # float32 compute must not silently drop to TF32 on the GPU's tensor
    # cores; bf16 inputs accumulate in float32 either way
    return (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)


@dataclasses.dataclass(frozen=True)
class SpmmShape:
    """Static description of one plan's array layout: everything an SpMM
    implementation may branch on while tracing.  Built from one plan
    (``of_plan``) or from the shard-uniform capacities of a sharded plan
    (parallel.partition)."""

    num_rows: int
    num_buckets: int
    num_ell: int
    num_band: int
    window_h: int
    num_sparse_rows: int
    xp_rows: int
    num_spill_rows: int = 0
    # band bucket that owns every superwindow (full cover, no capacity
    # padding): its kernel writes the output in place; -1 = merge path
    direct_bucket: int = -1
    num_superwindows: int = 0

    @classmethod
    def of_plan(cls, plan: ExecutionPlan) -> "SpmmShape":
        return cls(
            num_rows=plan.num_nodes,
            num_buckets=len(plan.bucket_widths),
            num_ell=len(plan.ell_widths),
            num_band=len(plan.band_widths),
            window_h=plan.window_h,
            num_sparse_rows=plan.num_sparse_rows,
            xp_rows=plan.xp_rows,
            num_spill_rows=plan.num_spill_rows if plan.has_spill else 0,
            direct_bucket=plan.direct_bucket,
            num_superwindows=plan.num_superwindows,
        )


def _band_path_xla(arrs, xp, num_band: int, compute_dtype):
    """Banded path: contiguous X slice per superwindow, one batched
    block-dense matmul per band-width bucket.  XLA expresses the slice as
    a structured gather and materialises it, plus A in the compute
    dtype; the Triton kernel (kernels/band.py) avoids both."""
    d = xp.shape[1]
    outs = []
    for s in range(num_band):
        starts = arrs[f"band{s}_start"]                    # [Sb]
        a = arrs[f"band{s}_a"].astype(compute_dtype)       # [Sb, bh, Bb]
        sb, bh, bb = a.shape
        idx = starts[:, None].astype(jnp.int32) + jnp.arange(bb, dtype=jnp.int32)
        xg = jnp.take(xp, idx, axis=0)                     # [Sb, Bb, D]
        part = jax.lax.dot_general(
            a,
            xg.astype(compute_dtype),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=_precision(compute_dtype),
        )                                                  # [Sb, bh, D]
        outs.append(part.reshape(sb * bh, d))
    return outs


def _band_path_triton(arrs, xc, num_band: int, interpret: bool):
    """Band buckets through the Triton kernel, in band order (entry i's
    rows at i*bh) for the merge permutation."""
    from hcspmm_tpu.kernels.band import band_spmm

    outs = []
    for s in range(num_band):
        a = arrs[f"band{s}_a"]
        sb = a.shape[0]
        if sb == 0:
            outs.append(jnp.zeros((0, xc.shape[1]), jnp.float32))
            continue
        outs.append(band_spmm(arrs[f"band{s}_start"],
                              jnp.arange(sb, dtype=jnp.int32), a, xc, sb,
                              jnp.float32, interpret=interpret))
    return outs


def _dense_path_xla(arrs, xp, num_buckets: int, window_h: int, compute_dtype):
    """Width-bucketed block-dense path: per-bucket gather + one batched
    matmul, no scatter (reduction over column blocks folds into the dot).

    Equivalent of the WMMA path (.cu:1385-1472): ``b*_a`` plays
    ``sparse_A`` (fused across the MAX_BLK loop), ``b*_cols`` plays
    ``sparse_AToX_index``."""
    d = xp.shape[1]
    outs = []
    for b in range(num_buckets):
        cols = arrs[f"b{b}_cols"]                          # [Wb, Kb]
        a = arrs[f"b{b}_a"].astype(compute_dtype)          # [Wb, wh, Kb]
        wb = cols.shape[0]
        xg = jnp.take(xp, cols, axis=0)                    # [Wb, Kb, D] gather
        part = jax.lax.dot_general(
            a,
            xg.astype(compute_dtype),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=_precision(compute_dtype),
        )                                                  # [Wb, wh, D] fp32
        outs.append(part.reshape(wb * window_h, d))
    return outs


def _sparse_path_xla(arrs, xp, num_ell: int, num_sparse_rows: int):
    """Scatter-free ELL path + residual segment-sum: the CUDA-core
    warp-per-row equivalent (.cu:964-1036).  Each degree bucket is one
    gather + one axis-sum, which XLA fuses; only rows wider than every
    ELL bucket go through a sorted segment-sum."""
    outs = []
    for e in range(num_ell):
        xe = jnp.take(xp, arrs[f"e{e}_cols"], axis=0)      # [Rb, De, D]
        outs.append(xe.astype(jnp.float32).sum(axis=1))    # [Rb, D]
    xe = jnp.take(xp, arrs["sparse_edge_col"], axis=0)     # [Es, D]
    outs.append(
        jax.ops.segment_sum(
            xe.astype(jnp.float32),
            arrs["sparse_edge_seg"],
            num_segments=num_sparse_rows + 1,
            indices_are_sorted=True,
        )[:num_sparse_rows]
    )
    return outs


def _add_spill(out, arrs, xsrc, num_spill_rows: int):
    """Band+spill additive residual (format.plan band_spill='auto'):
    segment-sum the spilled edges' X rows and scatter-add them onto the
    output.  Row padding is INT32_MAX, so ``mode='drop'`` discards it;
    column padding carries the dropped segment sentinel, so whatever it
    gathers (clipped, never NaN-filled) never lands."""
    if not num_spill_rows or "spill_rows" not in arrs:
        return out
    xe = jnp.take(xsrc, arrs["spill_edge_col"], axis=0, mode="clip")
    seg = jax.ops.segment_sum(
        xe.astype(jnp.float32), arrs["spill_edge_seg"],
        num_segments=num_spill_rows + 1, indices_are_sorted=True,
    )[:num_spill_rows]
    return out.at[arrs["spill_rows"]].add(seg.astype(out.dtype), mode="drop")


def spmm_apply(arrs, x, shape: SpmmShape, compute_dtype, impl: str = "xla",
               interpret: bool = False):
    """``A @ x`` for the plan described by ``shape``.  ``x`` spans the
    plan's column space; the result has ``shape.num_rows`` rows and
    ``x.dtype``."""
    d = x.shape[1]
    n = shape.num_rows
    xc = x.astype(compute_dtype)
    if impl == "triton" and shape.direct_bucket >= 0:
        # full cover by one bucket: the kernel writes every superwindow's
        # rows in place — no concat, no merge permutation
        from hcspmm_tpu.kernels.band import band_spmm

        s = shape.direct_bucket
        out_dtype = jnp.float32 if shape.num_spill_rows else x.dtype
        out = band_spmm(arrs[f"band{s}_start"], arrs[f"band{s}_sw"],
                        arrs[f"band{s}_a"], xc, shape.num_superwindows,
                        out_dtype, interpret=interpret)[:n]
        return _add_spill(out, arrs, xc, shape.num_spill_rows
                          ).astype(x.dtype)
    # dummy zero row at num_cols; extra zero rows up to xp_rows so band
    # slices near the top of the column space stay in bounds
    pad = max(shape.xp_rows - x.shape[0], 1)
    xp = jnp.concatenate([xc, jnp.zeros((pad, d), xc.dtype)])
    if impl == "triton":
        band = _band_path_triton(arrs, xc, shape.num_band, interpret)
    elif impl == "xla":
        band = _band_path_xla(arrs, xp, shape.num_band, compute_dtype)
    else:
        raise ValueError(f"unknown impl: {impl!r}")
    dense = _dense_path_xla(arrs, xp, shape.num_buckets, shape.window_h,
                            compute_dtype)
    sparse = _sparse_path_xla(arrs, xp, shape.num_ell, shape.num_sparse_rows)
    allrows = jnp.concatenate(
        band + dense + sparse + [jnp.zeros((1, d), jnp.float32)])
    out = jnp.take(allrows, arrs["out_perm"], axis=0)
    return _add_spill(out, arrs, xp, shape.num_spill_rows).astype(x.dtype)


@functools.partial(jax.jit, static_argnums=1)
def _expand_row_bits(packed: jnp.ndarray, rows: int) -> jnp.ndarray:
    """[S, rows/8, W] uint8 (bit i = row 8k+i, little order) -> int8
    [S, rows, W] — device-side unpack of bit-packed binary A blocks."""
    rep = jnp.repeat(packed, 8, axis=1)
    shifts = (jnp.arange(rows, dtype=jnp.uint8) % 8)[None, :, None]
    return ((rep >> shifts) & 1).astype(jnp.int8)


def _float0_zeros(tree):
    """float0 cotangents for integer-dtype plan arrays."""
    import jax.dtypes

    return jax.tree.map(
        lambda t: np.zeros(t.shape, jax.dtypes.float0), tree
    )


def make_spmm(
    plan: ExecutionPlan,
    plan_bwd: Optional[ExecutionPlan] = None,
    compute_dtype: str = "float32",
    impl: str = "xla",
    interpret: bool = False,
) -> Callable:
    """Build a differentiable ``spmm(arrs_f, arrs_b, X) -> A @ X`` for one
    graph.  The plan arrays are *arguments*, not closure constants: a
    closed-over 170 MB array costs minutes of XLA compile (it is serialized
    into the module and constant-folded); as arguments the same program
    compiles in under a second.  Callers thread ``HybridSpMM.arrays``
    through their jit boundaries.

    ``plan_bwd=None`` reuses the forward plan in the VJP (the reference's
    symmetric-structure assumption); pass a plan built on A^T for exactness
    on directed graphs.  ``interpret=True`` runs the Triton kernel through
    the Pallas interpreter (tests on the CPU).
    """
    cd = _dtype(compute_dtype)
    impl = resolve_impl(impl)
    shape_f = SpmmShape.of_plan(plan)
    shape_b = shape_f if plan_bwd is None else SpmmShape.of_plan(plan_bwd)

    def fwd_impl(arrs, x):
        return spmm_apply(arrs, x, shape_f, cd, impl, interpret)

    def bwd_impl(arrs, g):
        return spmm_apply(arrs, g, shape_b, cd, impl, interpret)

    @jax.custom_vjp
    def spmm(arrs_f, arrs_b, x):
        return fwd_impl(arrs_f, x)

    def spmm_fwd(arrs_f, arrs_b, x):
        return fwd_impl(arrs_f, x), (arrs_f, arrs_b)

    def spmm_bwd(res, g):
        arrs_f, arrs_b = res
        return (
            _float0_zeros(arrs_f),
            _float0_zeros(arrs_b),
            bwd_impl(arrs_b, g),
        )

    spmm.defvjp(spmm_fwd, spmm_bwd)
    return spmm


class HybridSpMM:
    """Convenience wrapper: CSR graph -> plan(s) -> differentiable operator.

    The analog of the reference flow ``HYGNN.preprocess(...)`` +
    ``HCSPMM.forward*`` (HC-SpMM_main.py:52, GNN_model.py), collapsed into
    one object: construction runs preprocessing, ``__call__`` aggregates.
    ``self.impl`` is the resolved implementation ('xla' or 'triton').
    """

    def __init__(
        self,
        row_pointers: np.ndarray,
        column_index: np.ndarray,
        num_nodes: int,
        config: PlanConfig = PlanConfig(),
        symmetric: bool = True,
        normalize: bool = False,
        interpret: bool = False,
    ):
        """``normalize=True`` computes D^-1/2 A D^-1/2 X (symmetric GCN
        normalization).  The reference computes sqrt-degrees and never
        applies them (dataset.py:106-107; its kernels sum unweighted), so
        False reproduces reference semantics (SURVEY.md §7 checklist)."""
        self.config = config
        self.normalize = normalize
        self.impl = resolve_impl(config.impl)
        self.plan = build_plan(row_pointers, column_index, num_nodes, config)
        if symmetric:
            self.plan_bwd = None
        else:
            rp_t, ci_t = transpose_csr(row_pointers, column_index, num_nodes)
            self.plan_bwd = build_plan(rp_t, ci_t, num_nodes, config)
        self._fn = make_spmm(
            self.plan, self.plan_bwd,
            compute_dtype=config.compute_dtype, impl=self.impl,
            interpret=interpret,
        )

        def to_device(plan):
            # Binary band blocks upload BIT-PACKED along the row axis (8x
            # fewer bytes over the host->device link).  The Triton kernel
            # reads them packed; the XLA path expands them once on device
            # with a jitted shift-and-mask.
            out = {}
            for k, v in plan.device_arrays().items():
                if (k.startswith("band") and k.endswith("_a")
                        and v.ndim == 3 and v.shape[1] % 8 == 0):
                    # 0/1 int8 blocks reinterpret as uint8 zero-copy
                    packed = jnp.asarray(np.packbits(
                        v.view(np.uint8), axis=1, bitorder="little"))
                    out[k] = (packed if self.impl == "triton"
                              else _expand_row_bits(packed, v.shape[1]))
                else:
                    out[k] = jnp.asarray(v)
            return out

        arrs_f = to_device(self.plan)
        if self.plan_bwd is None:
            arrs_b = arrs_f
        else:
            arrs_b = to_device(self.plan_bwd)
        #: pytree of plan arrays — thread this through YOUR jit boundary
        #: (see make_spmm docstring) and call ``apply(arrays, x)``
        self.arrays = {"f": arrs_f, "b": arrs_b}
        deg = np.maximum(np.diff(np.asarray(row_pointers)), 1)
        #: 1/deg — mean aggregation (GraphSAGE mean_N = D^-1 A X)
        self.arrays["inv_deg"] = jnp.asarray(
            1.0 / deg.astype(np.float32)
        )
        if normalize:
            self.arrays["inv_sqrt_deg"] = jnp.asarray(
                1.0 / np.sqrt(deg.astype(np.float32))
            )

    def mean_apply(self, arrays, x: jnp.ndarray) -> jnp.ndarray:
        """Mean aggregation ``D^-1 A X`` (GraphSAGE's mean_N).  Uses the
        raw aggregate regardless of ``normalize`` (SAGE's own scaling)."""
        agg = self._fn(arrays["f"], arrays["b"], x)
        return (agg * arrays["inv_deg"][:, None]).astype(x.dtype)

    def mean(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.mean_apply(self.arrays, x)

    def apply(self, arrays, x: jnp.ndarray) -> jnp.ndarray:
        """Jit-friendly form: plan arrays as traced arguments."""
        if "inv_sqrt_deg" in arrays:
            inv = arrays["inv_sqrt_deg"][:, None]
            xs = (x * inv).astype(x.dtype)
            return (self._fn(arrays["f"], arrays["b"], xs) * inv).astype(x.dtype)
        return self._fn(arrays["f"], arrays["b"], x)

    def gcn_apply(self, arrays, x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
        """GCN layer core ``A (x w)``.  XLA composes the dense update with
        the SpMM; autodiff through the SpMM's VJP yields the reference's
        backward dataflow (GNN_model.py:94-103)."""
        return self.apply(arrays, jnp.dot(
            x, w, preferred_element_type=jnp.float32).astype(x.dtype))

    def gin_apply(self, arrays, x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
        """GIN layer core ``(A x) w``; the aggregate is the saved residual
        for dW (GNN_model.py:166-184)."""
        agg = self.apply(arrays, x)
        return jnp.dot(agg, w, preferred_element_type=jnp.float32
                       ).astype(x.dtype)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        # Convenience form.  Inside a caller's jit, ``self.arrays`` become
        # module constants — fine for small graphs and tests; for large
        # graphs use ``apply`` with ``arrays`` threaded as a jit argument.
        return self.apply(self.arrays, x)


def spmm_reference_dense(row_pointers, column_index, num_nodes, x):
    """NumPy dense oracle ``A @ X`` for tests (binary, unweighted sum)."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    rp = np.asarray(row_pointers)
    ci = np.asarray(column_index)
    for r in range(num_nodes):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    return a @ np.asarray(x, dtype=np.float64)
