"""Global configuration for hcspmm_tpu.

The reference hard-codes its tiling in hybrid_kernel/config.h:4-6
(BLK_H=16, BLK_W=8, WARP_SIZE=32) and mirrors it in config.py:1-3, plus
kernel-tuning macros (WPB=3, MAX_BLK=3, S_SIZE=62) in
hybrid_all_kernel.cu:21-26.  Here everything lives in one dataclass; the
reference values are the defaults where they are semantic (window height,
column-block width); the population knobs (width buckets, band
superwindows, dtype policy) and the routing cost constants are this
design's own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Semantic constants shared with the reference format (config.h:4-6).
BLK_H = 16  # row-window height (rows per window)
BLK_W = 8   # column-block width used for block_partition counting

# Largest block of the band kernel (kernels/band.py) along the band
# width: auto-resolved band widths are rounded to a multiple of it, so
# every A chunk the kernel loads is a full tile.
BAND_BLOCK = 64

# float32 band products run in IEEE float32 on the CUDA cores, bf16 ones
# on the tensor cores: for float32 inputs the band path's price per A
# element is PlanConfig.a_elem_ps times this (2.8 ps against the 0.9 ps
# bf16 price; width sweep on an H100 80GB HBM3 at 400 W, see PERF.md).
A_ELEM_F32_SCALE = 2.8 / 0.9


@dataclasses.dataclass(frozen=True)
class LOICoefficients:
    """Logistic selector coefficients.

    The reference's *intended* model (commented-out line,
    hybrid_all_kernel.cu:261; report §IV-C):

        sparse if  size > max_cols
               or  w_cols*size + w_density*density + bias > 0

    where ``size`` is the number of unique neighbour columns in the window
    (the reference's deduplicated count) and ``density`` is
    nnz / (num_blocks * BLK_H * BLK_W), i.e. occupancy of the allocated
    column blocks.  Positive score => memory-bound => sparse (gather) path;
    otherwise the dense (tensor-core block) path.

    The defaults are the reference's fit on an RTX 3090;
    `format.loi.calibrate` refits them from measured timings (report §IV-C
    procedure).
    """

    w_cols: float = 0.19854024
    w_density: float = -6.578043
    bias: float = -3.14922857
    max_cols: int = 32


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Configuration of the execution plan (format.plan)."""

    window_h: int = BLK_H
    # Unique-column width buckets for dense (tensor-core) windows.  A dense
    # window with U unique neighbour columns is padded to the smallest
    # bucket width >= U and becomes one binary [window_h, Kb] block-row —
    # the analog of the reference's MAX_BLK 8-wide WMMA blocks
    # (hybrid_all_kernel.cu:258-260) fused across the block loop.  Windows
    # wider than the last bucket go to the sparse path (the reference
    # similarly caps at MAX_BLK*8 columns).
    bucket_widths: Sequence[int] = (32, 64, 96, 128, 192, 256)
    # Degree buckets for the sparse (gather + row-sum) path: a sparse-window
    # row of degree d is padded to the smallest ELL width >= d and computed
    # as a scatter-free gather + axis-sum (the warp-per-row CSR loop of
    # hybrid_all_kernel.cu:964-1036, vectorized).  Rows wider than the last
    # width fall back to a residual sorted segment-sum.
    ell_widths: Sequence[int] = (4, 8, 16, 32, 64, 128, 256)
    # ---- banded (block-band) path: the third population ----
    # Rows are grouped into superwindows of band_h consecutive rows; a
    # superwindow whose neighbour-column extent fits a band width bucket
    # reads one CONTIGUOUS X slice and computes
    # out = A_band[band_h, Bb] @ X[start:start+Bb] as one block product.
    # After LOA/RCM reordering most superwindows have small extent, so the
    # path replaces every per-row gather by a streamed slice — the
    # explicit form of the L2 reuse the reference gets from cached X rows.
    band_h: int = 256
    # 'auto' resolves the width bucket(s) from the measured per-superwindow
    # extent distribution at plan build (one bucket when tight — keeps the
    # direct-write shape; two on long tails).  An explicit tuple pins the
    # ladder (required for shard-uniform distributed plans).
    band_widths: "Sequence[int] | str" = "auto"
    # 'auto' uses the cost model below; 'always' takes every superwindow
    # whose extent fits a bucket; 'never' disables the banded path.
    band_mode: str = "auto"
    # ---- band+spill: robust band windows on non-bandable graphs ----
    # 'auto': a superwindow whose full column extent exceeds the band
    # width gets the width-window *placed* where it covers the most
    # edges; the uncovered edges SPILL to a segment-sum gather population
    # added onto the band output.  This is what makes the band path carry
    # power-law / community graphs (hub and inter-community edges spill,
    # the local mass streams) instead of all-or-nothing extent selection.
    # 'never' restores strict full-extent selection.
    band_spill: str = "auto"
    # ---- routing cost model (format.plan) ----
    # Measured on an NVIDIA H100 80GB HBM3 by chip_smoke.py's calibration
    # phase and the width sweeps recorded in PERF.md (PR 1).
    # Band-block compute wall: seconds per A ELEMENT of the whole band
    # path (bit-packed A unpacked in registers, block product, direct
    # write), for bf16 inputs on the tensor cores: 0.72 ps at dim 32 and
    # 1.10 ps at dim 96 (400 W) — priced at the plan's nominal width.
    # float32 inputs pay A_ELEM_F32_SCALE times this.
    a_elem_ps: float = 0.9
    # Fixed cost (seconds) of HAVING a spill population at all: the
    # float32 output, take + segment-sum + scatter-add chain and cast
    # back cost 25 us at dim 32 and about 120 us at dim 96 over the
    # zero-spill direct write (400 W), so near-zero-spill plans collapse
    # to the zero-spill shape.
    spill_fixed_s: float = 60e-6
    # Target edge-coverage quantile when resolving band widths from the
    # per-superwindow *robust* extent (minimal window covering this
    # fraction of the super's edges) instead of the full extent.
    band_coverage: float = 0.95
    # Gathered rows (ELL slots / spill edges) go through the random
    # row-gather path whose measured effective bandwidth is take_gbps, so
    # per-row cost = row bytes / take_gbps.  Streamed band/A bytes run at
    # stream_gbps.  gather_ns_per_row=None derives the per-row cost from
    # take_gbps and the compute dtype; a number pins it (ablations).
    gather_ns_per_row: Optional[float] = None
    # per spilled edge beyond the band, fitted from SpMM times across band
    # widths: 0.24 ns at dim 32 bf16 = 128 B / 0.24 ns (a bare random row
    # gather of 64 B rows reads 1138 GB/s; the chain's segment-sum and
    # scatter-add cost the rest)
    take_gbps: float = 530.0
    stream_gbps: float = 2900.0  # large copy, read + write: 2917 GB/s
    # Breaking full band cover (dropping a super / dense-routing a window)
    # forfeits the direct-write shape: the output is then assembled by a
    # concat + row permutation, charged as this many extra [M, d]
    # streaming passes, paid COLLECTIVELY by the cover-breaking routing
    # decisions.  0 restores pure marginal-cost routing (tests/ablations).
    glue_passes: float = 2.0
    # LOI mode: 'intended' | 'degenerate' | 'all_dense' | 'all_sparse'.
    # 'degenerate' reproduces the reference's live line
    # (hybrid_all_kernel.cu:262, missing `> 0`) for bit-parity experiments.
    loi_mode: str = "intended"
    # None = the reference's coefficients; an explicit LOICoefficients(...)
    # is honored verbatim (format.windows.analyze_windows).
    loi: Optional[LOICoefficients] = None
    # Compute dtype for gathered features / block matmuls.  fp32 matches the
    # reference's CUDA-core path; bf16 halves gather bandwidth at
    # TF32-class tolerance (report Table VII ran half/bf16).
    compute_dtype: str = "float32"
    # SpMM implementation (ops.spmm): 'xla' (gather + batched dot +
    # segment-sums, all plain XLA), 'triton' (the band population through
    # the Pallas/Triton kernel in kernels/band.py, the rest in XLA), or
    # 'auto' = 'triton' on a GPU backend, 'xla' elsewhere.
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference CLI flag surface (HC-SpMM_main.py:18-27)."""

    dataset: str = "example"
    dim: int = 96
    num_layers: int = 6
    hidden: int = 32
    classes: int = 22
    epochs: int = 200
    model: str = "gcn"  # 'gcn' | 'gin'
    single_kernel: bool = False
    lr: float = 0.01
    seed: int = 0
    dropout: float = 0.5
    # Reference aggregation is an unweighted neighbour sum (binary adjacency,
    # degrees computed then dropped — dataset.py:106-107).  normalize=True is
    # the extension flag for symmetric-normalized GCN aggregation.
    normalize: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Multi-chip layout (net-new vs the single-GPU reference)."""

    axis_name: str = "x"
    num_shards: int = 1
    # 'allgather' replicates X per step; 'halo' exchanges only the remote
    # rows each shard's windows actually reference.
    halo_mode: str = "allgather"


@dataclasses.dataclass(frozen=True)
class HCSpMMConfig:
    plan: PlanConfig = dataclasses.field(default_factory=PlanConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def degree_clamp(x: int) -> int:
    """Reference config.py:5-9 `func`: clamp degree to >= 1."""
    return x if x > 0 else 1
