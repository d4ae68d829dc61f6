"""Window analyzer vs a brute-force scipy/NumPy oracle (SURVEY.md §4.1)."""

import numpy as np
import pytest

from hcspmm_tpu.config import BLK_H, BLK_W
from hcspmm_tpu.format.windows import analyze_windows
from hcspmm_tpu.format.plan import build_plan, transpose_csr
from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.graphs import io

from conftest import small_graph


def brute_force_windows(rp, ci, n, wh=BLK_H):
    """Oracle: per-window unique cols via python sets."""
    num_w = (n + wh - 1) // wh
    uniq, counts = [], []
    for w in range(num_w):
        lo, hi = w * wh, min(w * wh + wh, n)
        cols = sorted(set(int(c) for r in range(lo, hi)
                          for c in ci[rp[r]: rp[r + 1]]))
        uniq.append(cols)
        counts.append(int(rp[hi] - rp[lo]))
    return uniq, counts


@pytest.mark.parametrize("n,deg,span", [(100, 6, 16), (37, 3, 8), (16, 1, 4),
                                        (130, 20, 2048), (257, 5, 64)])
def test_analysis_matches_oracle(n, deg, span):
    rp, ci, nn = small_graph(n, deg, span=span)
    wa = analyze_windows(rp, ci, nn)
    uniq, counts = brute_force_windows(rp, ci, nn)

    assert wa.num_windows == (nn + BLK_H - 1) // BLK_H
    for w in range(wa.num_windows):
        got = wa.unique_cols[wa.unique_ptr[w]: wa.unique_ptr[w + 1]].tolist()
        assert got == uniq[w], f"window {w}"
        assert wa.unique_counts[w] == len(uniq[w])
        assert wa.edge_counts[w] == counts[w]
        expected_blocks = (len(uniq[w]) + BLK_W - 1) // BLK_W
        assert wa.block_partition[w] == expected_blocks

    # edge_to_column: the compressed index must map back to the same column.
    for eid in range(len(ci)):
        w = wa.edge_to_window[eid]
        local = wa.edge_to_column[eid]
        assert uniq[w][local] == ci[eid]

    # edge_to_row round-trip against CSR.
    deg_arr = np.diff(rp)
    assert np.array_equal(wa.edge_to_row, np.repeat(np.arange(nn), deg_arr))


def test_empty_windows_and_partial_tail():
    # Node 0 -> 40 only: windows 1 is empty, window 2 partial (n=41).
    src = np.array([0], dtype=np.int32)
    dst = np.array([40], dtype=np.int32)
    rp, ci = io.to_csr(src, dst, 41)
    wa = analyze_windows(rp, ci, 41)
    assert wa.num_windows == 3
    assert wa.edge_counts.tolist() == [1, 0, 0]
    assert wa.unique_counts.tolist() == [1, 0, 0]
    assert wa.hybrid_type[1] == 0  # empty -> sparse encoding 0


def test_plan_shapes_and_padding():
    rp, ci, nn = small_graph(100, 6)
    cfg = PlanConfig(loi_mode="all_dense", bucket_widths=(8, 16, 32, 512),
                     band_mode="never")
    plan = build_plan(rp, ci, nn, cfg)
    for b, kb in enumerate(plan.bucket_widths):
        assert plan.bucket_cols[b].shape[1] == kb
        assert plan.bucket_a[b].shape[1:] == (16, kb)
        if plan.bucket_cols[b].shape[0] == 0:  # empty buckets have no arrays
            continue
        # every real column id is <= num_nodes (== is the dummy)
        assert plan.bucket_cols[b].max() <= nn
        # unique counts of windows in this bucket fit the width
        for w, wid in enumerate(plan.bucket_window_ids[b]):
            row_cols = plan.bucket_cols[b][w]
            assert (row_cols < nn).sum() <= kb
    # A nnz across buckets matches graph nnz on the all-dense path
    total_a = sum(int(a.sum()) for a in plan.bucket_a)
    assert total_a == plan.dense_nnz == len(ci)


def test_plan_merge_covers_all_rows():
    rp, ci, nn = small_graph(77, 4)
    plan = build_plan(rp, ci, nn, PlanConfig(loi_mode="intended"))
    assert plan.out_perm.shape == (nn,)
    limit = (sum(plan.band_capacities) * plan.band_h
             + sum(plan.bucket_capacities) * plan.window_h
             + sum(plan.ell_capacities) + plan.num_sparse_rows + 1)
    assert plan.out_perm.max() < limit
    # rows of nonempty windows map to unique slots
    nonzero = plan.out_perm[plan.out_perm != limit - 1]
    assert len(np.unique(nonzero)) == len(nonzero)


def test_transpose_csr():
    rp, ci, nn = small_graph(50, 5, symmetric=False)
    rpt, cit = transpose_csr(rp, ci, nn)
    a = np.zeros((nn, nn))
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1
    at = np.zeros((nn, nn))
    for r in range(nn):
        at[r, cit[rpt[r]: rpt[r + 1]]] = 1
    assert np.array_equal(a.T, at)


def test_native_analyzer_matches_numpy():
    """native/preprocess.cpp vs the NumPy oracle, including a ragged tail
    window and duplicate-heavy columns."""
    import pytest

    from hcspmm_tpu.format.windows import _native_lib, analyze_windows

    if _native_lib() is None:
        pytest.skip("native analyzer unavailable")
    rng = np.random.RandomState(0)
    n = 203
    deg = rng.randint(0, 9, n)
    rp = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=rp[1:])
    ci = rng.randint(0, n, int(rp[-1])).astype(np.int32)
    # CSR rows must be sorted for reduceat-style consumers; analyzer
    # itself doesn't require it, but match production inputs
    for r in range(n):
        ci[rp[r]: rp[r + 1]] = np.sort(ci[rp[r]: rp[r + 1]])
    a = analyze_windows(rp, ci, n, backend="native")
    b = analyze_windows(rp, ci, n, backend="numpy")
    np.testing.assert_array_equal(a.unique_cols, b.unique_cols)
    np.testing.assert_array_equal(a.unique_ptr, b.unique_ptr)
    np.testing.assert_array_equal(a.unique_counts, b.unique_counts)
    np.testing.assert_array_equal(a.edge_to_column, b.edge_to_column)
    np.testing.assert_array_equal(a.hybrid_type, b.hybrid_type)


def test_auto_band_width_vmem_cap():
    """Long-tail extent distributions must not resolve giant band widths
    (regression: a 20k-node graph with global edges resolved W=19200),
    and auto widths are multiples of the band kernel's block."""
    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.format.plan import build_plan
    from hcspmm_tpu.graphs import io

    src, dst, nn = io.synthetic_graph(20000, 8.0, seed=0, span=16,
                                      locality=0.7)
    rp, ci = io.to_csr(src, dst, nn)
    plan = build_plan(rp, ci, nn, PlanConfig(band_h=256))
    assert all(w <= 2048 for w in plan.band_widths), plan.band_widths
    from hcspmm_tpu.config import BAND_BLOCK

    assert all(w % BAND_BLOCK == 0 for w in plan.band_widths)


def test_native_band_robust_and_place_match_numpy():
    """native hcspmm_band_robust / hcspmm_band_place vs the NumPy oracle
    (_robust_widths / _place_band_windows), masked and unmasked."""
    import pytest

    from hcspmm_tpu.format.plan import (
        _BIG, _place_band_windows, _robust_widths, _seg_of_positions)
    from hcspmm_tpu.format.windows import (
        _native_lib, native_band_place, native_band_robust)

    if _native_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.RandomState(1)
    n, bh = 500, 64
    deg = rng.randint(0, 12, n)
    rp = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=rp[1:])
    ci = rng.randint(0, n, int(rp[-1])).astype(np.int32)
    for r in range(n):
        ci[rp[r]: rp[r + 1]] = np.sort(ci[rp[r]: rp[r + 1]])
    num_sw = (n + bh - 1) // bh
    rp64 = np.asarray(rp, np.int64)
    ci64 = np.asarray(ci, np.int64)
    e_start = rp64[np.minimum(np.arange(num_sw, dtype=np.int64) * bh, n)]
    e_end = np.append(e_start[1:], len(ci64))
    ne = np.where(e_end > e_start)[0]
    sw_of_edge = _seg_of_positions(e_start, len(ci64))
    keys = np.sort(sw_of_edge * _BIG + ci64)

    qs = (0.5, 0.9, 1.0)
    rw_np = _robust_widths(keys, e_start, e_end, ne, qs)
    cnt, mn, mx, rw_nat = native_band_robust(rp, ci, n, bh, qs)
    np.testing.assert_array_equal(rw_np, rw_nat[:, ne])
    np.testing.assert_array_equal(cnt, e_end - e_start)

    widths = (64, 128)
    for align in (16, 64):
        cov_np = np.zeros((2, len(ne)), np.int64)
        st_np = np.zeros((2, len(ne)), np.int64)
        for b, wb in enumerate(widths):
            cov_np[b], st_np[b] = _place_band_windows(
                keys, e_start[ne], int(wb), align=align)
        covf, stf, cntp = native_band_place(rp, ci, n, bh, align, widths)
        np.testing.assert_array_equal(cov_np, covf[:, ne])
        np.testing.assert_array_equal(st_np, stf[:, ne])

    # masked placement
    m = rng.rand(len(ci)) > 0.4
    rc = np.bincount(sw_of_edge[m], minlength=num_sw).astype(np.int64)
    pos = np.zeros(num_sw + 1, np.int64)
    np.cumsum(rc, out=pos[1:])
    nem = np.where(rc > 0)[0]
    keys_m = np.sort((sw_of_edge * _BIG + ci64)[m])
    cm = np.zeros((2, len(nem)), np.int64)
    sm = np.zeros((2, len(nem)), np.int64)
    for b, wb in enumerate(widths):
        cm[b], sm[b] = _place_band_windows(
            keys_m, pos[:-1][nem], int(wb), align=16)
    covm, stm, cntm = native_band_place(rp, ci, n, bh, 16, widths, mask=m)
    np.testing.assert_array_equal(cm, covm[:, nem])
    np.testing.assert_array_equal(sm, stm[:, nem])
    np.testing.assert_array_equal(cntm, rc)
