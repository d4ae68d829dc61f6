"""Execution plan for hybrid SpMM.

The reference dispatches both populations inside one CUDA kernel with a
per-block branch on ``hybrid_type[bid]`` (hybrid_all_kernel.cu:960).  Here
the window space is partitioned at preprocessing time into statically
shaped populations, each one batched operation (SURVEY.md §7 "hard
parts" #1/#2):

- **Dense (tensor-core) path, width-bucketed.**  A dense window's unique
  neighbour columns (at most ``bucket_widths[-1]``) are padded to the
  smallest bucket width Kb; the window becomes one binary block-row
  ``A_w [window_h, Kb]`` (int8; the analog of the reference's 16x8 WMMA
  ``sparse_A`` blocks, .cu:1053-1079, fused across its MAX_BLK loop) plus
  the column ids (the analog of ``sparse_AToX_index``).  At run time each
  bucket is one gather + batched matmul — no scatter anywhere; the
  reduction over column blocks folds into the dot's contraction.

- **Banded (block-band) path** — a population with no reference
  equivalent: superwindows of ``band_h`` consecutive rows whose column
  extent fits a band-width bucket Bb become one dense int8 block
  ``A_band [band_h, Bb]`` against a *contiguous* X slice
  ``[start, start+Bb)``.  One streamed slice replaces every per-row
  gather; this is the explicit form of the L2 locality the reference gets
  from cached X rows.  Selected by a cost model (config.gather_ns_per_row
  / stream_gbps) against the gather paths.

- **Sparse (CUDA-core) path** — windows that are empty, LOI-classified
  memory-bound, or wider than the largest bucket keep CSR semantics:
  gather one X row per edge and a sorted segment-sum into output rows
  (the equivalent of the warp-per-row CUDA-core loop, .cu:964-1036).

- **Merge** — one row-gather assembles ``[N, D]`` output from
  ``concat(bucket outputs..., sparse rows, zero row)`` via a precomputed
  permutation; empty windows map to the zero row.  A plan whose
  superwindows all sit in one band bucket (``direct_bucket``) lets the
  band kernel write the output in place instead.

All arrays are static-shaped per graph, so downstream jits compile once
per (graph, dim).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hcspmm_tpu.config import A_ELEM_F32_SCALE, BAND_BLOCK, PlanConfig
from hcspmm_tpu.format.windows import WindowAnalysis, analyze_windows


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if len(x) >= size:
        return x
    pad = np.full((size - len(x),) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """Vectorized ``concat([arange(l) for l in lens])``."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def _ragged_gather(values: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized ``concat([values[s:s+l] for s, l in zip(starts, lens)])``."""
    lens = np.asarray(lens, dtype=np.int64)
    idx = np.repeat(np.asarray(starts, dtype=np.int64), lens) + _ragged_arange(lens)
    return values[idx]


@dataclasses.dataclass(frozen=True)
class PlanCaps:
    """Minimum array extents, so per-shard plans of one graph stack into a
    single uniform-shaped ``shard_map`` program (see parallel.partition)."""

    bucket_windows: Tuple[int, ...] = ()   # per-bucket min window counts
    ell_rows: Tuple[int, ...] = ()         # per-ELL-bucket min row counts
    band_supers: Tuple[int, ...] = ()      # per-band-bucket min superwindows
    num_sparse_rows: int = 0
    num_sparse_edges: int = 0
    num_spill_rows: int = 0                # band+spill population (>=0 forces
    num_spill_edges: int = 0               # the arrays to exist when 0 spill)


@dataclasses.dataclass
class ExecutionPlan:
    """Static device-side description of one hybrid SpMM.

    Column index convention: ``num_cols`` is a valid *dummy* index — SpMM
    implementations append one zero row to X, so padded gathers read zeros.
    """

    num_nodes: int              # rows of this operand (= global N when square)
    num_cols: int               # column space; num_cols is the dummy index
    window_h: int

    # ---- dense (tensor-core) path: one entry per width bucket ----
    bucket_widths: Tuple[int, ...]       # Kb per bucket (ascending)
    bucket_cols: List[np.ndarray]        # int32 [Wb, Kb], padded with num_cols
    bucket_a: List[np.ndarray]           # int8  [Wb, window_h, Kb], binary
    bucket_window_ids: List[np.ndarray]  # int64 [Wb_real] global window ids

    # ---- sparse (CUDA-core) path: degree-bucketed ELL rows ----
    ell_widths: Tuple[int, ...]          # De per bucket (ascending)
    ell_cols: List[np.ndarray]           # int32 [Rb, De], padded with num_cols
    ell_row_ids: List[np.ndarray]        # int64 [Rb_real] global row ids

    # ---- residual scatter path (rows wider than ell_widths[-1]) ----
    num_sparse_rows: int         # Rs (>= 1; padded)
    num_sparse_edges: int        # Es (>= 1; padded)
    sparse_edge_col: np.ndarray  # int32 [Es], padded with num_cols
    sparse_edge_seg: np.ndarray  # int32 [Es] -> sparse-row position (padding -> Rs)
    sparse_rows: np.ndarray      # int32 [Rs] global row ids

    # ---- merge ----
    out_perm: np.ndarray         # int32 [N] -> row in concat(buckets..., sparse, zero)

    # ---- band+spill population (config.band_spill='auto') ----
    # Edges of band-selected superwindows that fall OUTSIDE the placed
    # band window: aggregated by a sorted segment-sum over spill rows and
    # scatter-ADDED onto the (band) output — the additive residual that
    # lets the band path carry power-law/community graphs (hub and
    # inter-community edges spill; the local mass streams).  Row padding
    # uses INT32_MAX so `.at[rows].add(..., mode='drop')` discards it.
    num_spill_rows: int = 0      # Rp capacity (0 = population absent)
    num_spill_edges: int = 0     # Ep capacity
    spill_rows: Optional[np.ndarray] = None      # int32 [Rp] global row ids
    spill_edge_col: Optional[np.ndarray] = None  # int32 [Ep], pad num_cols
    spill_edge_seg: Optional[np.ndarray] = None  # int32 [Ep] -> pos (pad Rp)
    # ---- banded (block-band) path: one entry per band-width bucket ----
    band_h: int = 16                          # superwindow height (rows)
    band_widths: Tuple[int, ...] = ()         # Bb per bucket (ascending)
    band_starts: List[np.ndarray] = dataclasses.field(default_factory=list)
    #   int32 [Sb] X row offsets of each superwindow band
    band_edges: List[np.ndarray] = dataclasses.field(default_factory=list)
    #   int32 [E_s, 3] (super pos, row in super, band-local col) — the
    #   compact form; dense A blocks are built from it on demand
    band_sw_ids: List[np.ndarray] = dataclasses.field(default_factory=list)
    #   int64 [Sb_real] global superwindow ids
    band_missing_sw: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    #   int32 [miss] supers in NO band bucket (partial cover)
    band_full_cover: bool = False  # every superwindow band-assigned
    xp_rows: int = 0            # SpMM impls pad X to >= this many rows
    band_num_sw: int = 0        # superwindow grid size (ceil(n/band_h))

    # ---- stats (host-only; for roofline/logging) ----
    nnz: int = 0
    dense_nnz: int = 0
    sparse_nnz: int = 0
    band_nnz: int = 0
    spill_nnz: int = 0
    dense_gather_rows: int = 0   # sum Wb * Kb (inc. padding)
    unique_gather_rows: int = 0  # sum unique cols over dense windows

    @property
    def has_spill(self) -> bool:
        """True when the additive spill population exists (impls must add
        it onto the band/merge output; fused one-launch kernels bail)."""
        return self.num_spill_edges > 0

    @property
    def num_dense_windows(self) -> int:
        return sum(len(w) for w in self.bucket_window_ids)

    @property
    def num_band_supers(self) -> int:
        return sum(len(s) for s in self.band_sw_ids)

    def band_a_dense(self, s: int) -> np.ndarray:
        """Dense int8 band blocks [Sb, band_h, Bb] for bucket ``s``."""
        sb = self.band_starts[s].shape[0]
        bb = int(self.band_widths[s])
        a = np.zeros((sb, self.band_h, bb), dtype=np.int8)
        e = self.band_edges[s]
        if len(e):
            a[e[:, 0], e[:, 1], e[:, 2]] = 1
        return a

    @property
    def band_capacities(self) -> Tuple[int, ...]:
        return tuple(s.shape[0] for s in self.band_starts)

    @property
    def bucket_capacities(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.bucket_cols)

    @property
    def ell_capacities(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.ell_cols)

    @property
    def num_superwindows(self) -> int:
        return self.band_num_sw

    @property
    def direct_bucket(self) -> int:
        """The band bucket that holds every superwindow exactly once (full
        cover, no capacity padding), or -1.  With one, a band kernel can
        write each superwindow's output rows in place — no merge pass."""
        if not self.band_full_cover:
            return -1
        for s, ids in enumerate(self.band_sw_ids):
            if (len(ids) == self.band_num_sw
                    and self.band_starts[s].shape[0] == len(ids)):
                return s
        return -1

    def device_arrays(self):
        """The pytree of arrays an SpMM implementation needs on device."""
        d = {
            "sparse_edge_col": self.sparse_edge_col,
            "sparse_edge_seg": self.sparse_edge_seg,
            "out_perm": self.out_perm,
        }
        if self.has_spill:
            d["spill_rows"] = self.spill_rows
            d["spill_edge_col"] = self.spill_edge_col
            d["spill_edge_seg"] = self.spill_edge_seg
        for b in range(len(self.bucket_widths)):
            d[f"b{b}_cols"] = self.bucket_cols[b]
            d[f"b{b}_a"] = self.bucket_a[b]
        for e in range(len(self.ell_widths)):
            d[f"e{e}_cols"] = self.ell_cols[e]
        for s in range(len(self.band_widths)):
            d[f"band{s}_start"] = self.band_starts[s]
            d[f"band{s}_a"] = self.band_a_dense(s)
            # superwindow id per entry, padded to capacity (uniform shard
            # stacking) with the out-of-range id band_num_sw
            d[f"band{s}_sw"] = _pad_to(
                self.band_sw_ids[s].astype(np.int32),
                self.band_starts[s].shape[0], self.band_num_sw,
            )
        return d


# Key base for per-superwindow sorted column keys (sw * _BIG + col):
# larger than any column id, so windows [start, start+w) never cross a
# superwindow boundary in searchsorted space.  Divisible by 16 so the
# 16-aligned group quantization (keys >> 4) below stays exact.
_BIG = np.int64(1) << 33


def _seg_of_positions(boundaries, total):
    """``seg_of[p]`` = index of the segment (given sorted start positions
    ``boundaries``, boundaries[0] == 0) containing position ``p``.

    Boundary-mark bincount+cumsum, NOT searchsorted: per-element binary
    search over 5.5M positions measured ~6 s on this rig vs ~40 ms for
    the cumsum form (see windows.analyze_windows note)."""
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    marks = np.bincount(boundaries[1:], minlength=total)[:total]
    return np.cumsum(marks)


def _robust_widths(keys, e_start, e_end, ne, qs):
    """Per-nonempty-superwindow minimal window width covering ceil(q*E_s)
    edges, for each coverage quantile q in ``qs``.

    ``keys``: int64 sorted ``sw*_BIG + col`` edge keys (grouped by super,
    columns ascending within).  Returns int64 [len(qs), n_ne]."""
    total = len(keys)
    cols = keys % _BIG
    ar = np.arange(total, dtype=np.int64)
    starts_ne = e_start[ne]
    ends_ne = e_end[ne]
    cnt_s = ends_ne - starts_ne
    seg_of = _seg_of_positions(starts_ne, total)
    out = np.empty((len(qs), len(starts_ne)), dtype=np.int64)
    for qi, q in enumerate(qs):
        k = np.maximum(np.ceil(q * cnt_s).astype(np.int64), 1)
        idx2 = ar + k[seg_of] - 1
        valid = idx2 < ends_ne[seg_of]
        w = np.where(
            valid,
            cols[np.minimum(idx2, total - 1)] - cols + 1,
            np.int64(1) << 40,
        )
        out[qi] = np.minimum.reduceat(w, starts_ne)
    return out


def _place_band_windows(keys, starts_ne, w, align=16):
    """Best ``align``-aligned window of width ``w`` per nonempty superwindow:
    the placement that covers the most edges (candidates = the aligned
    start at-or-below each edge column).  Returns (covered edge count
    [n_ne], chosen start column [n_ne]).

    Works on (sw, col//16) GROUPS rather than edges: keys are sorted, 16
    divides _BIG, so ``keys >> 4`` is sorted and group-constant; every
    candidate window start is a group's aligned column, its covered-edge
    count a difference of group-prefix sums.  One searchsorted over [G]
    groups replaces two over [E] edges (~100x fewer probes at TT scale).
    """
    total = len(keys)
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    sh = int(align).bit_length() - 1     # log2(align); align | _BIG
    qk = keys >> sh                      # sw*(_BIG//align) + col//align
    flags = np.empty(total, dtype=bool)
    flags[0] = True
    np.not_equal(qk[1:], qk[:-1], out=flags[1:])
    gstart = np.flatnonzero(flags)       # [G] edge position of group start
    qku = qk[gstart]                     # [G] sorted group keys
    g = len(gstart)
    cum = np.append(gstart, total)       # [G+1] prefix edge counts
    hi_g = np.searchsorted(qku, qku + (w >> sh))
    cnt_g = cum[hi_g] - gstart           # edges covered from this group on
    # super boundaries in group space (supers = high bits of qku)
    sup_g = qku >> (33 - sh)             # _BIG >> sh == 1 << (33 - sh)
    sflags = np.empty(g, dtype=bool)
    sflags[0] = True
    np.not_equal(sup_g[1:], sup_g[:-1], out=sflags[1:])
    gb = np.flatnonzero(sflags)          # [n_ne] group index of super start
    cov = np.maximum.reduceat(cnt_g, gb)
    seg_of_g = np.cumsum(sflags) - 1
    best = np.where(cnt_g == cov[seg_of_g], np.arange(g), g)
    bi = np.minimum.reduceat(best, gb)
    start = (qku[bi] & ((np.int64(1) << (33 - sh)) - 1)) << sh
    return cov, start


def build_plan(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    config: PlanConfig = PlanConfig(),
    analysis: Optional[WindowAnalysis] = None,
    num_cols: Optional[int] = None,
    caps: PlanCaps = PlanCaps(),
) -> ExecutionPlan:
    """``num_nodes`` counts rows; ``num_cols`` (default: square) sets the
    column space for a rectangular row-block shard of the adjacency."""
    num_cols = num_nodes if num_cols is None else num_cols
    wa = analysis or analyze_windows(
        row_pointers,
        column_index,
        num_nodes,
        window_h=config.window_h,
        loi_mode=config.loi_mode,
        loi_coeffs=config.loi,
        num_cols=num_cols,
    )
    wh = config.window_h
    widths = tuple(config.bucket_widths)
    n, c = num_nodes, num_cols
    # keep ci int32: every consumer either upcasts through an int64
    # partner (key math, window-start subtraction) or wants int32 anyway
    # (native passes, plan arrays) — the int64 detour copied 8 B/edge
    # three extra times at DD scale
    column_index = np.ascontiguousarray(column_index)
    if column_index.dtype != np.int32:
        column_index = column_index.astype(np.int32)
    nnz = int(len(wa.edge_to_row))

    rp64 = np.asarray(row_pointers, dtype=np.int64)
    degrees = np.diff(rp64)

    # -------------------- banded superwindows --------------------
    # Decide, per band_h-row superwindow, whether its whole column extent
    # streams as one contiguous block (see module docstring).  Selected
    # superwindows own all their windows/rows; the remaining populations
    # are carved from what is left.
    auto_width = (
        config.band_mode != "never" and isinstance(config.band_widths, str)
    )
    if config.band_mode == "never":
        band_widths = ()
    elif auto_width:
        band_widths = (256,)  # placeholder; resolved from extents below
    else:
        band_widths = tuple(config.band_widths)
    bh = config.band_h
    if band_widths and bh % wh != 0:
        raise ValueError("band_h must be a multiple of window_h")
    if any(int(w) % 16 for w in band_widths):
        # the band kernel tiles the width in blocks of 16 or more
        raise ValueError("band widths must be multiples of 16")
    al = 16  # band-start alignment in original columns
    num_sw = (n + bh - 1) // bh if band_widths else 0
    band_starts: List[np.ndarray] = []
    band_edges: List[np.ndarray] = []
    band_sw_ids: List[np.ndarray] = []
    band_window_mask = np.zeros(wa.num_windows, dtype=bool)
    xp_rows = c + 1
    band_nnz = 0
    spill_fields: dict = {}
    spill_mode = False  # set inside the band block when band_spill='auto'
    band_missing = np.zeros(0, dtype=np.int32)
    dense_routed_w = None  # set by spill-mode three-way routing
    caps_s = caps.band_supers or (0,) * len(band_widths)
    if len(caps_s) != len(band_widths):
        raise ValueError("caps.band_supers length must match band_widths")
    if band_widths:
        # even zero-real (capacity-padded) buckets read a dummy band from
        # row 0, so X must always cover the widest bucket (auto mode
        # defers this until widths resolve from extents — the 256
        # placeholder would inflate xp_rows on tiny graphs)
        if not auto_width:
            xp_rows = max(xp_rows, int(band_widths[-1]))
        sw_row0 = np.minimum(np.arange(num_sw, dtype=np.int64) * bh, n)
        sw_row1 = np.minimum(sw_row0 + bh, n)
        e_start = rp64[sw_row0]
        e_end = rp64[sw_row1]
        nonempty = e_end > e_start
        min_col = np.full(num_sw, 0, dtype=np.int64)
        max_col = np.full(num_sw, -1, dtype=np.int64)
        ne = np.where(nonempty)[0]
        if len(ne):
            min_col[ne] = np.minimum.reduceat(column_index, e_start[ne])
            max_col[ne] = np.maximum.reduceat(column_index, e_start[ne])
        start = (min_col // al) * al  # aligned band start
        extent = max_col - start + 1
        # edge -> superwindow via boundary marks (integer division over E
        # elements measured seconds on this rig; see _seg_of_positions)
        nnz_e = len(wa.edge_to_row)
        sw_of_edge = _seg_of_positions(
            rp64[np.minimum(
                np.arange(num_sw, dtype=np.int64) * bh, n)], nnz_e)
        E_sw = e_end - e_start

        # gather-path cost per superwindow (one padded ELL slot per edge
        # on the XLA take path) — shared by both selection modes below
        ell_w = np.asarray(config.ell_widths, dtype=np.int64)
        slot = np.where(
            degrees > 0,
            ell_w[np.minimum(np.searchsorted(ell_w, degrees), len(ell_w) - 1)],
            0,
        )
        slot = np.where(degrees > ell_w[-1], degrees, slot)
        slots_sw = np.add.reduceat(
            np.concatenate([slot, [0]]), sw_row0
        ) * (sw_row1 > sw_row0)
        # nominal feature width at which the byte model prices X rows
        # (the models run dims 32-96; the plan is built before the width
        # is known)
        dnom = 64.0
        xbytes = 2.0 if config.compute_dtype == "bfloat16" else 4.0
        # per-gathered-row cost: row bytes over the measured random-gather
        # bandwidth (XLA take path).  A fixed per-row constant made a
        # 2048-wide band block "cheaper" than gathering 100 edges, so
        # power-law plans claimed every superwindow at ~1% coverage and
        # streamed GBs of A for nothing.
        if config.gather_ns_per_row is not None:
            g_ns = config.gather_ns_per_row * 1e-9
        else:
            g_ns = dnom * xbytes / (config.take_gbps * 1e9)
        sparse_cost = slots_sw * g_ns
        bw_s = config.stream_gbps * 1e9
        r_up = lambda v: max(BAND_BLOCK, -(-int(v) // BAND_BLOCK) * BAND_BLOCK)

        spill_mode = config.band_spill == "auto" and len(ne) > 0
        if spill_mode:
            # ---- robust selection (band+spill): per superwindow, PLACE a
            # bucket-width window where it covers the most edges; edges
            # outside the window spill to the additive segment-sum
            # population.  This is what lets the streamed band path carry
            # power-law / community graphs (hub and inter-community edges
            # spill, the local mass streams) instead of the all-or-nothing
            # full-extent selection of band_spill='never'.
            # Native fast path: the per-edge quantile/placement passes
            # run in OpenMP C++ (native/preprocess.cpp hcspmm_band_*);
            # the keys-sort NumPy path stays as the portable fallback
            # and the test oracle (tests/test_format.py).
            from hcspmm_tpu.format import windows as _w
            _nat = _w._native_lib() is not None
            keys_unsorted = keys = None
            if not _nat:
                keys_unsorted = sw_of_edge * _BIG + column_index
                keys = np.sort(keys_unsorted)
            starts_ne = e_start[ne]
            E_ne = E_sw[ne]
            if auto_width:
                if caps.band_supers:
                    raise ValueError(
                        "band_widths='auto' cannot satisfy PlanCaps "
                        "(shard-uniform plans need explicit widths)")
                # Width cap: see the band_spill='never' branch below; also
                # no wider than the superwindow grid's row space.
                W_CAP = min(2048, max(BAND_BLOCK, (num_sw * bh)
                                      // BAND_BLOCK * BAND_BLOCK))
                qs = tuple(sorted({0.5, 0.75, 0.9,
                                   float(config.band_coverage), 1.0}))
                if _nat:
                    rw = _w.native_band_robust(
                        rp64, column_index, n, bh, qs)[3][:, ne]
                else:
                    rw = _robust_widths(keys, e_start, e_end, ne, qs)
                qcov = rw[qs.index(float(config.band_coverage))]
                cands = set()
                for row in (qcov, rw[-1]):
                    for pct in (50, 60, 70, 80, 90, 95, 99, 100):
                        v = r_up(np.percentile(row, pct))
                        if v <= W_CAP:
                            cands.add(v)
                # hub-heavy graphs have extent distributions whose every
                # percentile exceeds W_CAP, leaving only the widest
                # candidate — but the placed-window coverage curve is
                # concave, so NARROW windows + spill often win there
                # (RD resolves 2048 from percentiles alone while a width
                # sweep favoured 512).  Always consider a fixed ladder
                # too.
                for v in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048):
                    if v <= W_CAP and v == r_up(v):
                        cands.add(v)
                if not cands:
                    cands.add(r_up(min(int(np.median(qcov)), W_CAP)))
                # total modeled cost per candidate width; coverage comes
                # from the quantile table (step interpolation — exact
                # placement runs once for the winner, below)
                qs_arr = np.asarray(qs)
                cand_list = sorted(cands)
                cost_w = {}
                unc_w_tot = {}
                # band-block compute wall: the int8 -> compute-dtype
                # convert + block product cost per A ELEMENT
                # (config.a_elem_ps) — wide low-occupancy bands hit this
                # before the byte stream
                a_elem_s = config.a_elem_ps * 1e-12 * (
                    A_ELEM_F32_SCALE if config.compute_dtype == "float32"
                    else 1.0)
                for wc in cand_list:
                    nq = (rw <= wc).sum(axis=0)
                    lo = np.maximum(nq - 1, 0)
                    frac = np.where(nq > 0, qs_arr[lo], 0.0)
                    # linear interpolation toward the next quantile step:
                    # the step function is a coverage LOWER bound, which
                    # over-charged narrow candidates with phantom spill
                    hi = np.minimum(nq, len(qs_arr) - 1)
                    w_lo = np.where(nq > 0,
                                    rw[lo, np.arange(rw.shape[1])], 0.0)
                    w_hi = rw[hi, np.arange(rw.shape[1])]
                    t = np.clip((wc - w_lo) / np.maximum(w_hi - w_lo, 1.0),
                                0.0, 1.0)
                    frac = frac + (qs_arr[hi] - np.where(nq > 0, qs_arr[lo],
                                                         0.0)) * t
                    frac = np.minimum(frac, 1.0)
                    cov = frac * E_ne
                    band_s = np.maximum(
                        (bh * wc + wc * dnom * xbytes) / bw_s,
                        bh * wc * a_elem_s)
                    cost_w[wc] = band_s + (E_ne - cov) * g_ns
                    unc_w_tot[wc] = float((E_ne - cov).sum())
                # A nonzero spill population costs a FIXED launch tax on
                # top of the per-edge model: the take + segment-sum +
                # scatter-add chain's own launches.  Charging it here
                # collapses near-zero-spill plans to the zero-spill
                # direct-write shape (the 100th-percentile candidate).
                spill_fixed = float(config.spill_fixed_s)

                def _tot_single(wc):
                    per = np.minimum(cost_w[wc], sparse_cost[ne])
                    # dropped supers (gather cheaper than the band block)
                    # also ride the spill population in spill mode
                    has_spill = (unc_w_tot[wc] > 0
                                 or bool((cost_w[wc]
                                          > sparse_cost[ne]).any()))
                    return float(per.sum()) + (spill_fixed if has_spill
                                               else 0.0)

                best = None
                for wc in cand_list:
                    tot = _tot_single(wc)
                    if best is None or tot < best[0]:
                        best = (tot, (wc,))
                # 2-width ladders: a narrow bucket can band the loose-
                # extent supers a single wide bucket would drop to the
                # gather path (e.g. RD stand-in: 1482/4746 supers dropped
                # at the single 2048).  A second bucket costs a second
                # launch and the merge pass (no direct write) that the
                # byte model does not see, so the pair must beat the best
                # single by a wide margin (15%) plus a launch floor.
                split_penalty_s = float(config.spill_fixed_s)
                best_single = best[0]
                for i, w_lo in enumerate(cand_list):
                    for w_hi in cand_list[i + 1:]:
                        pair = np.minimum(cost_w[w_lo], cost_w[w_hi])
                        has_spill = (
                            min(unc_w_tot[w_lo], unc_w_tot[w_hi]) > 0
                            or bool((pair > sparse_cost[ne]).any()))
                        tot = (float(np.minimum(pair, sparse_cost[ne]).sum())
                               + split_penalty_s
                               + (spill_fixed if has_spill else 0.0))
                        if tot < min(best[0], 0.85 * best_single):
                            best = (tot, (w_lo, w_hi))
                band_widths = best[1]
                if len(band_widths) == 1:
                    # EXACT-placement refinement (round 4): the quantile
                    # coverage interpolation is a width-resolution
                    # heuristic (cluster-reordered DD resolved a width
                    # with 180k real spill edges where one step wider
                    # places zero spill).  Re-price the top candidates
                    # (and the +128 neighbor of the best) with exact
                    # placements — one native multi-width pass,
                    # O(E * ncand).
                    ranked = sorted(cand_list, key=_tot_single)[:4]
                    w0 = int(band_widths[0])
                    exact_c = tuple(sorted({
                        *(int(v) for v in ranked), w0,
                        *( (w0 + 128,) if w0 + 128 <= W_CAP else () ),
                    }))
                    if _nat:
                        cov_x = _w.native_band_place(
                            rp64, column_index, n, bh, al, exact_c
                        )[0][:, ne]
                    else:
                        cov_x = np.zeros((len(exact_c), len(ne)),
                                         dtype=np.int64)
                        for b2, wb2 in enumerate(exact_c):
                            cov_x[b2], _ = _place_band_windows(
                                keys, starts_ne, int(wb2), align=al)
                    tots = []
                    for b2, wb2 in enumerate(exact_c):
                        unc_v = E_ne - cov_x[b2]
                        unc2 = float(unc_v.sum())
                        band_s2 = max(
                            (bh * wb2 + wb2 * dnom * xbytes) / bw_s,
                            bh * wb2 * a_elem_s)
                        per2 = np.minimum(band_s2 + unc_v * g_ns,
                                          sparse_cost[ne])
                        dropped2 = bool((band_s2 + unc_v * g_ns
                                         > sparse_cost[ne]).any())
                        tots.append(float(per2.sum())
                                    + (spill_fixed if (unc2 > 0 or dropped2)
                                       else 0.0))
                    band_widths = (exact_c[int(np.argmin(tots))],)
                caps_s = (0,) * len(band_widths)
                xp_rows = max(xp_rows, int(band_widths[-1]))
            # exact placement per ladder width; per-super bucket choice
            # minimizes modeled cost (band bytes + spill gather)
            nb = len(band_widths)
            if _nat:
                covf, stf, _ = _w.native_band_place(
                    rp64, column_index, n, bh, al, band_widths)
                cov_b, st_b = covf[:, ne], stf[:, ne]
            else:
                cov_b = np.zeros((nb, len(ne)), dtype=np.int64)
                st_b = np.zeros((nb, len(ne)), dtype=np.int64)
                for b, wb in enumerate(band_widths):
                    cov_b[b], st_b[b] = _place_band_windows(
                        keys, starts_ne, int(wb), align=al)
            widths_arr = np.asarray(band_widths, dtype=np.float64)
            band_cost_b = (
                (bh * widths_arr[:, None]
                 + widths_arr[:, None] * dnom * xbytes) / bw_s
                + (E_ne[None, :] - cov_b) * g_ns
            )
            best_b = np.argmin(band_cost_b, axis=0)
            ar_ne = np.arange(len(ne))

            # ---- population routing: the LOI selector generalized to this
            # population set (reference: the two-way CUDA/TC dispatch,
            # hybrid_all_kernel.cu:261-262 + .cu:960).  Two passes with
            # costs in seconds from the measured constants (streamed
            # bytes at stream_gbps, gathered rows at take_gbps):
            #
            # 1. per WINDOW: a TC-suitable window routes to the
            #    tensor-core dense-bucket population iff its bucket cost (gather
            #    K_pad unique rows + stream the A block) beats leaving
            #    its *uncovered* edges (w.r.t. the super's placed band
            #    window) to the spill gather.  Windows already inside
            #    the band window stay banded for free.
            # 2. per SUPERWINDOW: with bucket windows carved out, the
            #    band window is RE-PLACED on the remaining edges and
            #    kept iff streaming it beats gathering those edges.
            w_of_w = (np.arange(wa.num_windows, dtype=np.int64) * wh) // bh
            kmax_r = widths[-1]
            tc_w = (
                (wa.hybrid_type == 1)
                & (wa.edge_counts > 0)
                & (wa.unique_counts <= kmax_r)
            )
            kpad_w = np.asarray(widths + (kmax_r,))[
                np.minimum(np.searchsorted(np.asarray(widths),
                                           wa.unique_counts), len(widths))
            ]
            win_bucket_cost = wh * kpad_w / bw_s + kpad_w * g_ns
            # per-window uncovered-edge count under the all-edges placed
            # window of its super
            st_all = np.zeros(num_sw, dtype=np.int64)
            st_all[ne] = st_b[best_b, ar_ne]
            bbw_all = np.asarray(band_widths)[best_b]
            bbw_sw = np.zeros(num_sw, dtype=np.int64)
            bbw_sw[ne] = bbw_all
            lc_all = column_index - st_all[sw_of_edge]
            out_win_e = (lc_all < 0) | (lc_all >= bbw_sw[sw_of_edge])
            uncov_w = np.bincount(
                wa.edge_to_window[out_win_e], minlength=wa.num_windows)
            dense_routed_w = tc_w & (win_bucket_cost < uncov_w * g_ns)
            if config.band_mode == "always":
                dense_routed_w &= False
            # Layout-aware routing: ANY dense-routed window (or dropped
            # super, below) breaks full band cover, which forfeits the
            # direct-write shape — the output is then assembled by a
            # concat + permutation, ~2 extra [M, d] passes.  Full-
            # cover-breaking routing must beat that fixed cost COLLECTIVELY,
            # not just its own marginal gather cost.
            glue_s = (getattr(config, "glue_passes", 2.0)
                      * (num_sw * bh) * dnom * xbytes / bw_s)
            if dense_routed_w.any():
                save_dense = float(
                    (uncov_w[dense_routed_w] * g_ns
                     - win_bucket_cost[dense_routed_w]).sum())
                if save_dense < glue_s:
                    dense_routed_w &= False

            # pass 2: re-place band on non-bucket edges, per-super on/off
            tc_e = dense_routed_w[wa.edge_to_window]
            cov_rest = np.zeros(num_sw, dtype=np.int64)
            st_rest = np.zeros(num_sw, dtype=np.int64)
            best_rest = np.zeros(num_sw, dtype=np.int64)
            if not tc_e.any():
                # nothing dense-routed: the rest set IS the full edge set
                # — reuse pass 1's placement instead of recomputing
                rest_cnt = E_sw.copy()
                ne_rest = ne
                covr_b, str_b = cov_b, st_b
            elif _nat:
                covr_f, str_f, rest_cnt = _w.native_band_place(
                    rp64, column_index, n, bh, al, band_widths,
                    mask=~tc_e, num_sw=num_sw)
                ne_rest = np.where(rest_cnt > 0)[0]
                covr_b = covr_f[:, ne_rest]
                str_b = str_f[:, ne_rest]
            else:
                rest_cnt = np.bincount(
                    sw_of_edge[~tc_e], minlength=num_sw).astype(np.int64)
                keys_rest = np.sort(keys_unsorted[~tc_e])
                rest_pos = np.zeros(num_sw + 1, dtype=np.int64)
                np.cumsum(rest_cnt, out=rest_pos[1:])
                ne_rest = np.where(rest_cnt > 0)[0]
                covr_b = np.zeros((nb, len(ne_rest)), dtype=np.int64)
                str_b = np.zeros((nb, len(ne_rest)), dtype=np.int64)
                for b, wb in enumerate(band_widths):
                    covr_b[b], str_b[b] = _place_band_windows(
                        keys_rest, rest_pos[:-1][ne_rest], int(wb),
                        align=al)
            if len(ne_rest):
                band_cost_rb = (
                    (bh * widths_arr[:, None]
                     + widths_arr[:, None] * dnom * xbytes) / bw_s
                    + (rest_cnt[ne_rest][None, :] - covr_b) * g_ns
                )
                br = np.argmin(band_cost_rb, axis=0)
                arr_r = np.arange(len(ne_rest))
                cov_rest[ne_rest] = covr_b[br, arr_r]
                st_rest[ne_rest] = str_b[br, arr_r]
                best_rest[ne_rest] = br

            S_rest = (bh * widths_arr[best_rest]
                      + widths_arr[best_rest] * dnom * xbytes) / bw_s
            if config.band_mode == "always":
                band_on = np.zeros(num_sw, dtype=bool)
                band_on[ne] = cov_b[best_b, ar_ne] > 0
            else:
                # band on iff streaming the block beats raw-gathering the
                # edges it covers (a dropped super's edges ride the spill
                # population — one sorted take per edge — and its output
                # rows come from the merge; no glue term here, unlike
                # dense routing above)
                band_on = (rest_cnt > 0) & (S_rest < cov_rest * g_ns)
            band_sel = band_on
            bucket_sw = best_rest
            start = st_rest
            if config.band_mode == "always":
                bucket_sw = np.zeros(num_sw, dtype=np.int64)
                bucket_sw[ne] = best_b
                start = st_all
        elif auto_width:
            # Resolve band width from the measured extent distribution:
            # a single bucket at the rounded max extent keeps the
            # direct-write shape whenever the distribution is tight;
            # a long tail gets a p95 bucket + max bucket instead of
            # padding every superwindow to the outlier width.
            if caps.band_supers:
                raise ValueError(
                    "band_widths='auto' cannot satisfy PlanCaps "
                    "(shard-uniform plans need explicit widths)")
            ne_ext = extent[nonempty]
            if len(ne_ext):
                # Width cap: past ~2048 a dense A block streams far more
                # bytes than gathering its superwindow's edges (a long-
                # tail graph once resolved W=19200).  Wider superwindows
                # don't fit a bucket and route to the gather paths.
                W_CAP = 2048
                ne_ext = ne_ext[ne_ext <= W_CAP]
                if not len(ne_ext):
                    ne_ext = np.array([W_CAP], dtype=np.int64)
                w_max = r_up(ne_ext.max())
                # Two-bucket split only when it cuts band bytes >=25%
                # (A + X band both scale with width): a second bucket
                # forfeits the direct write and adds a second launch.
                # Candidate lower widths from extent percentiles.
                best = (len(ne_ext) * w_max, (w_max,))
                for pct in (50, 60, 70, 80, 90, 95):
                    w_lo = r_up(np.percentile(ne_ext, pct))
                    if w_lo >= w_max:
                        continue
                    n_lo = int((ne_ext <= w_lo).sum())
                    bytes_2 = n_lo * w_lo + (len(ne_ext) - n_lo) * w_max
                    if bytes_2 < best[0]:
                        best = (bytes_2, tuple(sorted({w_lo, w_max})))
                single_bytes = len(ne_ext) * w_max
                band_widths = (
                    best[1] if best[0] <= 0.75 * single_bytes else (w_max,)
                )
            caps_s = (0,) * len(band_widths)
            xp_rows = max(xp_rows, int(band_widths[-1]))
        if not spill_mode:
            bucket_sw = np.searchsorted(np.asarray(band_widths), extent)
            fits = nonempty & (bucket_sw < len(band_widths))

            if config.band_mode == "always":
                band_sel = fits
            else:
                # measured cost model: band streams H*Bb int8 of A plus
                # one Bb-row band of X; the alternative
                # gathers one padded ELL slot per edge (XLA take path).
                bb_arr = np.asarray(band_widths + (band_widths[-1],))[
                    np.minimum(bucket_sw, len(band_widths))
                ]
                band_cost = (bh * bb_arr + bb_arr * dnom * xbytes) / bw_s
                band_sel = fits & (band_cost < sparse_cost)

        # Full coverage: when every nonempty superwindow is band-selected,
        # sweep the empty ones into the smallest bucket (zero A blocks) so
        # the whole output can be written in place by the band kernel and
        # the merge permutation pass disappears (ops.spmm).  Dense-
        # routed windows inside banded supers break direct write (their
        # rows' outputs come from the bucket region via out_perm).
        no_dense_routed = dense_routed_w is None or not dense_routed_w.any()
        if (bool(band_sel[nonempty].all()) and bool(nonempty.any())
                and no_dense_routed):
            band_sel = band_sel | ~nonempty
        band_full_cover = (bool(band_sel.all()) and len(band_sel) > 0
                           and no_dense_routed)

        # Collapse a *configured* ladder to a single width bucket when the
        # extra A padding is cheap (auto widths already chose the optimal
        # split from the extent distribution — never collapse those).
        # One bucket keeps the direct-write shape; two need the merge.
        if band_full_cover and not auto_width and not spill_mode:
            sel = np.where(band_sel)[0]
            used = np.unique(bucket_sw[sel])
            if len(used) > 1:
                bmax = int(used.max())
                widths_arr = np.asarray(band_widths)
                bytes_multi = int(
                    (widths_arr[bucket_sw[sel]] * bh).sum()
                )
                bytes_single = int(widths_arr[bmax]) * bh * len(sel)
                if bytes_single <= 1.5 * bytes_multi:
                    bucket_sw[sel] = bmax

        # Clamp band starts so every band slice stays inside the row space
        # M = num_sw*band_h, which bounds X's zero padding (xp_rows) by M.
        # Validity: a start may sit anywhere in [max_col+1-Bb, min_col]
        # (16-aligned); since max_col < n <= M, M-Bb is always a valid
        # lower position whenever M >= Bb.
        # (square plans only: a rectangular row-block shard's columns span
        # the *global* space, where max_col may exceed the local M)
        m_rows = num_sw * bh
        bbw_of = np.asarray(band_widths + (band_widths[-1],))[
            np.minimum(bucket_sw, len(band_widths))
        ]
        can_clamp = band_sel & (m_rows >= bbw_of) & (n == c)
        clamp_bound = (m_rows - bbw_of) // al * al
        start = np.where(can_clamp, np.minimum(start, clamp_bound), start)

        # in-window mask: spill mode carves each banded super's A block
        # from the placed window only; everything else spills (computed
        # AFTER clamping so the clamp never invalidates an A entry).
        # Edges of dense-routed (bucket) windows belong to the bucket
        # population: never in band A, never spilled.
        if spill_mode:
            lc_e = column_index - start[sw_of_edge]
            in_win_e = (lc_e >= 0) & (lc_e < bbw_of[sw_of_edge])
            bandwin_e = (band_sel[sw_of_edge]
                         & ~dense_routed_w[wa.edge_to_window])
            in_win_e &= bandwin_e
            # NON-banded supers' edges also ride the spill population:
            # one sorted segment-sum + scatter-add instead of the ELL /
            # residual paths (their merged rows are zero, the spill adds).
            nonband_e = (~band_sel[sw_of_edge]
                         & ~dense_routed_w[wa.edge_to_window])
            spill_mask_e = (bandwin_e & ~in_win_e) | nonband_e
        else:
            in_win_e = np.ones(len(column_index), dtype=bool)
            spill_mask_e = np.zeros(len(column_index), dtype=bool)

        sw_pos = np.full(num_sw, -1, dtype=np.int64)
        for s, bbw in enumerate(band_widths):
            sws = np.where(band_sel & (bucket_sw == s))[0].astype(np.int64)
            # zero-capacity when empty (impls skip the kernel launch);
            # caps force a min capacity for uniform shard stacking
            # (capacity-padded entries carry the out-of-range sw id, see
            # device_arrays)
            sb = max(len(sws), caps_s[s])
            starts_arr = np.zeros(sb, dtype=np.int32)
            edges = np.zeros((0, 3), dtype=np.int32)
            if len(sws):
                sw_pos[sws] = np.arange(len(sws))
                starts_arr[: len(sws)] = start[sws].astype(np.int32)
                xp_rows = max(xp_rows, int((start[sws] + bbw).max()))
                # compact A: (super pos, local row, band-local col) per edge
                sel_e = (band_sel[sw_of_edge]
                         & (bucket_sw[sw_of_edge] == s) & in_win_e)
                e_sw = sw_of_edge[sel_e]
                # preallocated column writes: np.stack measured 0.88 s
                # for the same 1.7M x 3 result
                edges = np.empty((len(e_sw), 3), dtype=np.int32)
                edges[:, 0] = sw_pos[e_sw]
                edges[:, 1] = wa.edge_to_row[sel_e].astype(np.int64) % bh
                edges[:, 2] = column_index[sel_e] - start[e_sw]
                band_nnz += int(sel_e.sum())
            band_starts.append(starts_arr)
            band_edges.append(edges)
            band_sw_ids.append(sws)
        # supers in no bucket (partial cover): the padded SpMM zeroes
        # their blocks (their edges are in the spill population)
        band_missing = np.where(~band_sel)[0].astype(np.int32)
        w_of = (np.arange(wa.num_windows, dtype=np.int64) * wh) // bh
        band_window_mask = band_sel[w_of]
        if dense_routed_w is not None:
            band_window_mask &= ~dense_routed_w

        # ---- spill population (sorted by row: CSR edge order) ----
        spill_nnz = int(spill_mask_e.sum())
        if spill_nnz or caps.num_spill_rows or caps.num_spill_edges:
            sp_rows_e = wa.edge_to_row[spill_mask_e].astype(np.int64)
            sp_cols_e = column_index[spill_mask_e].astype(np.int32)
            if len(sp_rows_e):
                flags = np.empty(len(sp_rows_e), dtype=bool)
                flags[0] = True
                np.not_equal(sp_rows_e[1:], sp_rows_e[:-1], out=flags[1:])
                sp_rows_u = sp_rows_e[flags]
                sp_seg = (np.cumsum(flags) - 1).astype(np.int32)
            else:
                sp_rows_u = np.zeros(0, dtype=np.int64)
                sp_seg = np.zeros(0, dtype=np.int32)
            rp_cap = max(len(sp_rows_u), caps.num_spill_rows, 1)
            ep_cap = max(len(sp_cols_e), caps.num_spill_edges, 1)
            spill_fields = dict(
                num_spill_rows=rp_cap,
                num_spill_edges=ep_cap,
                spill_nnz=spill_nnz,
                # INT32_MAX row padding: always out of bounds, so the
                # scatter-add's mode='drop' discards it
                spill_rows=_pad_to(sp_rows_u.astype(np.int32), rp_cap,
                                   np.iinfo(np.int32).max),
                spill_edge_col=_pad_to(sp_cols_e, ep_cap, c),
                spill_edge_seg=_pad_to(sp_seg, ep_cap, rp_cap),
            )

    kmax = widths[-1]
    if dense_routed_w is not None:
        # spill-mode three-way routing already decided per window
        dense_mask_w = dense_routed_w
    else:
        dense_mask_w = (
            (wa.hybrid_type == 1)
            & (wa.edge_counts > 0)
            & (wa.unique_counts <= kmax)
            & ~band_window_mask
        )
    sparse_mask_w = ~dense_mask_w & (wa.edge_counts > 0) & ~band_window_mask
    if spill_mode:
        # spill-mode routing is total: banded supers' out-of-window edges
        # and ALL non-banded supers' (non-dense) edges are already in the
        # spill population — nothing remains for the ELL/residual paths
        sparse_mask_w &= False

    # -------------------- dense buckets --------------------
    # bucket index per dense window: smallest Kb >= unique_count
    bucket_of = np.searchsorted(np.asarray(widths), wa.unique_counts)
    bucket_cols: List[np.ndarray] = []
    bucket_a: List[np.ndarray] = []
    bucket_window_ids: List[np.ndarray] = []
    bucket_pos_of_window = np.full(wa.num_windows, -1, dtype=np.int64)
    bucket_idx_of_window = np.full(wa.num_windows, -1, dtype=np.int64)
    caps_b = caps.bucket_windows or (0,) * len(widths)
    if len(caps_b) != len(widths):
        raise ValueError("caps.bucket_windows length must match bucket_widths")

    dense_gather_rows = 0
    unique_gather_rows = 0
    for b, kb in enumerate(widths):
        wids = np.where(dense_mask_w & (bucket_of == b))[0].astype(np.int64)
        wb = max(len(wids), caps_b[b])
        cols = np.full((wb, kb), c, dtype=np.int32)
        a = np.zeros((wb, wh, kb), dtype=np.int8)
        if len(wids):
            bucket_idx_of_window[wids] = b
            bucket_pos_of_window[wids] = np.arange(len(wids))
            # scatter each window's sorted unique cols into its row
            u_start = wa.unique_ptr[wids]
            u_cnt = wa.unique_counts[wids].astype(np.int64)
            flat_rows = np.repeat(np.arange(len(wids)), u_cnt)
            flat_off = _ragged_arange(u_cnt)
            flat_vals = _ragged_gather(wa.unique_cols, u_start, u_cnt)
            cols[flat_rows, flat_off] = flat_vals
            # fill A from edges of this bucket's windows
            sel = dense_mask_w[wa.edge_to_window] & (bucket_of[wa.edge_to_window] == b)
            e_w = wa.edge_to_window[sel].astype(np.int64)
            a.reshape(-1)[
                bucket_pos_of_window[e_w] * (wh * kb)
                + (wa.edge_to_row[sel].astype(np.int64) % wh) * kb
                + wa.edge_to_column[sel].astype(np.int64)
            ] = 1
            unique_gather_rows += int(u_cnt.sum())
        bucket_cols.append(cols)
        bucket_a.append(a)
        bucket_window_ids.append(wids)
        dense_gather_rows += wb * kb

    # -------------------- sparse path: ELL degree buckets --------------------
    # Rows of sparse windows with degree > 0, bucketed by degree; rows wider
    # than the last ELL width go to the residual scatter path.
    ell_widths = tuple(config.ell_widths)
    sparse_row_mask = np.zeros(n, dtype=bool)
    sparse_window_ids = np.where(sparse_mask_w)[0].astype(np.int64)
    if len(sparse_window_ids):
        rows_all = (
            sparse_window_ids[:, None] * wh + np.arange(wh)[None, :]
        ).reshape(-1)
        rows_all = rows_all[rows_all < n]
        sparse_row_mask[rows_all] = True
    sparse_row_mask &= degrees > 0

    ell_bucket_of = np.searchsorted(np.asarray(ell_widths), degrees)
    caps_e = caps.ell_rows or (0,) * len(ell_widths)
    if len(caps_e) != len(ell_widths):
        raise ValueError("caps.ell_rows length must match ell_widths")

    ell_cols: List[np.ndarray] = []
    ell_row_ids: List[np.ndarray] = []
    for e, de in enumerate(ell_widths):
        rows_e = np.where(sparse_row_mask & (ell_bucket_of == e))[0].astype(np.int64)
        rb = max(len(rows_e), caps_e[e])
        cols = np.full((rb, de), c, dtype=np.int32)
        if len(rows_e):
            degs = degrees[rows_e]
            flat_r = np.repeat(np.arange(len(rows_e)), degs)
            flat_o = _ragged_arange(degs)
            flat_v = _ragged_gather(column_index, rp64[rows_e], degs).astype(np.int32)
            cols[flat_r, flat_o] = flat_v
        ell_cols.append(cols)
        ell_row_ids.append(rows_e)
        dense_gather_rows += rb * de

    # -------------------- residual scatter path --------------------
    resid_mask = sparse_row_mask & (ell_bucket_of >= len(ell_widths))
    srows = np.where(resid_mask)[0].astype(np.int64)
    rs_real = len(srows)
    rpos = np.full(n + 1, -1, dtype=np.int64)
    if rs_real:
        rpos[srows] = np.arange(rs_real)

    for_resid = resid_mask[wa.edge_to_row]
    s_cols = column_index[for_resid].astype(np.int32)
    s_segs = rpos[wa.edge_to_row[for_resid].astype(np.int64)].astype(np.int32)

    rs = max(rs_real, 1, caps.num_sparse_rows)
    es = max(len(s_cols), 1, caps.num_sparse_edges)
    sparse_rows = _pad_to(srows.astype(np.int32), rs, 0)
    sparse_edge_col = _pad_to(s_cols, es, c)
    sparse_edge_seg = _pad_to(s_segs, es, rs)

    # -------------------- merge permutation --------------------
    # concat layout: [band buckets Sb*band_h rows each][dense buckets
    # Wb*wh rows each][ELL buckets Rb rows each][residual Rs rows][1 zero
    # row]
    off = 0
    band_row_offsets = []
    for s in range(len(band_widths)):
        band_row_offsets.append(off)
        off += band_starts[s].shape[0] * bh
    bucket_row_offsets = []
    for b in range(len(widths)):
        bucket_row_offsets.append(off)
        off += bucket_cols[b].shape[0] * wh
    ell_row_offsets = []
    for e in range(len(ell_widths)):
        ell_row_offsets.append(off)
        off += ell_cols[e].shape[0]
    sparse_off = off
    zero_at = sparse_off + rs
    out_perm = np.full(n, zero_at, dtype=np.int64)
    for s in range(len(band_widths)):
        sws = band_sw_ids[s]
        if not len(sws):
            continue
        real = (sws[:, None] * bh + np.arange(bh)[None, :]).reshape(-1)
        dpos = band_row_offsets[s] + np.arange(len(sws) * bh)
        in_range = real < n
        out_perm[real[in_range]] = dpos[in_range]
    for b in range(len(widths)):
        wids = bucket_window_ids[b]
        if not len(wids):
            continue
        real = (wids[:, None] * wh + np.arange(wh)[None, :]).reshape(-1)
        dpos = bucket_row_offsets[b] + np.arange(len(wids) * wh)
        in_range = real < n
        out_perm[real[in_range]] = dpos[in_range]
    for e in range(len(ell_widths)):
        rows_e = ell_row_ids[e]
        if len(rows_e):
            out_perm[rows_e] = ell_row_offsets[e] + np.arange(len(rows_e))
    if rs_real:
        out_perm[srows] = sparse_off + np.arange(rs_real)

    dense_nnz = int(wa.edge_counts[dense_mask_w].sum())
    plan = ExecutionPlan(
        num_nodes=n,
        num_cols=c,
        window_h=wh,
        band_h=bh,
        band_widths=band_widths,
        band_starts=band_starts,
        band_edges=band_edges,
        band_sw_ids=band_sw_ids,
        band_missing_sw=band_missing,
        band_full_cover=band_full_cover if band_widths else False,
        band_num_sw=num_sw if band_widths else 0,
        xp_rows=xp_rows,
        **spill_fields,
        band_nnz=band_nnz,
        bucket_widths=widths,
        bucket_cols=bucket_cols,
        bucket_a=bucket_a,
        bucket_window_ids=bucket_window_ids,
        ell_widths=ell_widths,
        ell_cols=ell_cols,
        ell_row_ids=ell_row_ids,
        num_sparse_rows=rs,
        num_sparse_edges=es,
        sparse_edge_col=sparse_edge_col,
        sparse_edge_seg=sparse_edge_seg,
        sparse_rows=sparse_rows,
        out_perm=out_perm.astype(np.int32),
        nnz=nnz,
        dense_nnz=dense_nnz,
        sparse_nnz=(nnz - dense_nnz - band_nnz
                    - spill_fields.get("spill_nnz", 0)),
        dense_gather_rows=dense_gather_rows,
        unique_gather_rows=unique_gather_rows,
    )
    return plan


def transpose_csr(
    row_pointers: np.ndarray, column_index: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of A^T, for the safe (non-symmetric) backward mode the reference
    lacks (it always reuses untransposed A, GNN_model.py:49-57)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(
        (np.ones(len(column_index), dtype=np.int8), column_index, row_pointers),
        shape=(num_nodes, num_nodes),
    )
    at = a.T.tocsr()
    at.sum_duplicates()
    return at.indptr.astype(np.int32), at.indices.astype(np.int32)
