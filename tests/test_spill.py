"""Band+spill (PlanConfig.band_spill='auto') vs dense oracle.

The reference's headline graphs are power-law (report §V-B: only 15-22%
of row windows are TC-suitable); the robust band-window placement keeps
the streamed band path on the local mass and spills hub/long-range edges
to an additive segment-sum population.  These tests pin correctness of
that split on genuinely non-bandable graphs across both impls (the
Triton kernel through the Pallas interpreter), the direct write, and the
layer/differentiated forms; the spill merge itself (take + sorted
segment-sum + scatter-add, ops.spmm._add_spill) against a NumPy
scatter-add; partial band cover (superwindows dropped from the band);
and edge conservation across the populations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.format.plan import PlanCaps, build_plan
from hcspmm_tpu.graphs import io
from hcspmm_tpu.ops.spmm import HybridSpMM, _add_spill, spmm_reference_dense

from conftest import small_graph

INT32_MAX = np.iinfo(np.int32).max


def powerlaw_graph(n=700, deg=5.0, seed=0):
    src, dst, nn = io.synthetic_powerlaw(n, deg, seed=seed)
    rp, ci = io.to_csr(src, dst, nn)
    return rp, ci, nn


def check(rp, ci, nn, dim, cfg, tol=1e-5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(nn, dim).astype(np.float32)
    op = HybridSpMM(rp, ci, nn, cfg, interpret=cfg.impl == "triton")
    z = np.asarray(jax.jit(op)(x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    scale = np.abs(zref).max() + 1e-9
    err = np.abs(z - zref).max() / scale
    assert err < tol, f"rel err {err}"
    return op


@pytest.mark.parametrize("impl", ["xla", "triton"])
@pytest.mark.parametrize("dim", [24, 96])
def test_powerlaw_spill_matches_oracle(impl, dim):
    rp, ci, nn = powerlaw_graph()
    cfg = PlanConfig(impl=impl, band_mode="always", band_h=64,
                     band_widths=(128,), band_spill="auto")
    op = check(rp, ci, nn, dim, cfg)
    # a 128-wide band cannot cover a Chung-Lu graph; edges must spill
    assert op.plan.has_spill and op.plan.spill_nnz > 0
    assert op.plan.band_nnz > 0
    assert op.plan.nnz == (op.plan.band_nnz + op.plan.spill_nnz
                           + op.plan.dense_nnz + op.plan.sparse_nnz)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_powerlaw_auto_width_spill(impl):
    """band_widths='auto' in spill mode resolves a width from the robust
    coverage quantiles and still matches the oracle."""
    rp, ci, nn = powerlaw_graph(600, 4.0, seed=2)
    cfg = PlanConfig(impl=impl, band_mode="auto", band_h=64,
                     band_widths="auto", band_spill="auto")
    check(rp, ci, nn, 17, cfg)


def test_spill_never_restores_strict_selection():
    """band_spill='never' must reproduce the all-or-nothing extent
    selection: no spill population on any graph."""
    rp, ci, nn = powerlaw_graph(500, 4.0, seed=1)
    cfg = PlanConfig(band_mode="auto", band_h=64, band_widths=(128, 256),
                     band_spill="never")
    op = check(rp, ci, nn, 8, cfg)
    assert not op.plan.has_spill


def test_spill_gradient_matches_dense():
    rp, ci, nn = powerlaw_graph(400, 4.0, seed=3)
    cfg = PlanConfig(impl="triton", band_mode="always", band_h=64,
                     band_widths=(128,), band_spill="auto")
    op = HybridSpMM(rp, ci, nn, cfg, interpret=True)
    assert op.plan.has_spill
    x = jnp.asarray(np.random.RandomState(1).randn(nn, 16).astype(np.float32))
    g = np.asarray(jax.grad(lambda v: (op(v) ** 2).sum())(x))
    a = np.zeros((nn, nn), np.float64)
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    z = a @ np.asarray(x, np.float64)
    gref = 2.0 * (a.T @ z)
    scale = np.abs(gref).max() + 1e-9
    assert np.abs(g - gref).max() / scale < 1e-5


def test_spill_direct_write_chained():
    """Direct write + spill, chained: the kernel writes every row in
    place, the spill adds onto it, and the output feeds the next SpMM
    (A @ (A @ X))."""
    rp, ci, nn = powerlaw_graph(640, 5.0, seed=4)
    cfg = PlanConfig(impl="triton", band_mode="always", band_h=64,
                     band_widths=(128,), band_spill="auto")
    op = HybridSpMM(rp, ci, nn, cfg, interpret=True)
    assert op.plan.has_spill and op.plan.direct_bucket == 0
    rng = np.random.RandomState(0)
    x = rng.randn(nn, 24).astype(np.float32)
    out = jax.jit(lambda a, v: op.apply(a, op.apply(a, v)))(
        op.arrays, jnp.asarray(x))
    assert out.shape == (nn, 24)
    zref = spmm_reference_dense(rp, ci, nn,
                                spmm_reference_dense(rp, ci, nn, x))
    scale = np.abs(zref).max() + 1e-9
    assert np.abs(np.asarray(out) - zref).max() / scale < 1e-5


@pytest.mark.parametrize("layer", ["gcn", "gin"])
def test_spill_layer_cores_match_dense(layer):
    """Layer cores under spill on the kernel path: values and both
    gradients equal the dense composition."""
    rp, ci, nn = powerlaw_graph(512, 4.0, seed=5)
    cfg = PlanConfig(impl="triton", band_mode="always", band_h=64,
                     band_widths=(128,), band_spill="auto")
    op = HybridSpMM(rp, ci, nn, cfg, interpret=True)
    assert op.plan.has_spill
    rng = np.random.RandomState(2)
    d, h = 16, 12
    x = jnp.asarray(rng.randn(nn, d).astype(np.float32))
    w = jnp.asarray(rng.randn(d, h).astype(np.float32))
    a = np.zeros((nn, nn), np.float64)
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    if layer == "gcn":
        out = op.gcn_apply(op.arrays, x, w)
        ref = a @ (np.asarray(x, np.float64) @ np.asarray(w, np.float64))
    else:
        out = op.gin_apply(op.arrays, x, w)
        ref = (a @ np.asarray(x, np.float64)) @ np.asarray(w, np.float64)
    scale = np.abs(ref).max() + 1e-9
    assert np.abs(np.asarray(out) - ref).max() / scale < 1e-4

    # backward through the spill population vs dense grads
    def loss(xw):
        xx, ww = xw
        f = op.gcn_apply if layer == "gcn" else op.gin_apply
        return (f(op.arrays, xx, ww) ** 2).sum()

    gx, gw = jax.grad(loss)((x, w))
    zref = ref
    gz = 2.0 * zref
    if layer == "gcn":
        gx_ref = (a.T @ gz) @ np.asarray(w, np.float64).T
        gw_ref = np.asarray(x, np.float64).T @ (a.T @ gz)
    else:
        gx_ref = a.T @ (gz @ np.asarray(w, np.float64).T)
        gw_ref = (a @ np.asarray(x, np.float64)).T @ gz
    for got, ref_ in ((gx, gx_ref), (gw, gw_ref)):
        scale = np.abs(ref_).max() + 1e-9
        assert np.abs(np.asarray(got) - ref_).max() / scale < 1e-4


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_bucket_windows_inside_banded_supers(impl):
    """Per-window routing (format.plan pass 1): TC-suitable windows whose
    columns sit far outside the placed band window route to the dense
    buckets while sibling windows stay banded, and the merged output
    matches the dense oracle exactly (choice exercised: band + bucket +
    spill in one plan)."""
    rng = np.random.RandomState(0)
    n = 2048
    src, dst = [], []
    for s in range(0, n, 256):
        base = (s * 2897) % (n - 128)
        far = np.arange(base, base + 24)
        for w in range(0, 128, 16):
            for r in range(s + w, s + w + 16):
                cols = rng.choice(far, size=12, replace=False)
                src.extend([r] * 12)
                dst.extend(cols)
        for r in range(s + 128, min(s + 256, n)):
            cols = s + 128 + rng.randint(0, 128, size=6)
            src.extend([r] * 6)
            dst.extend(cols)
    rp, ci = io.to_csr(np.array(src), np.array(dst), n)
    # glue_passes=0: pure marginal-cost routing — at this tiny scale the
    # layout-aware collective threshold (config.glue_passes) would keep
    # everything banded, and this test exists to exercise the merged
    # band+bucket+spill plan
    cfg = PlanConfig(loi_mode="all_dense", impl=impl, band_mode="auto",
                     band_h=256, band_widths=(256,), glue_passes=0.0)
    op = HybridSpMM(rp, ci, n, cfg, interpret=impl == "triton")
    p = op.plan
    assert p.band_nnz > 0 and p.dense_nnz > 0, (p.band_nnz, p.dense_nnz)
    x = jnp.asarray(rng.randn(n, 32).astype(np.float32))
    ref = spmm_reference_dense(rp, ci, n, np.asarray(x))
    out = np.asarray(op.apply(op.arrays, x))
    scale = np.abs(ref).max() + 1e-9
    assert np.abs(out - ref).max() / scale < 1e-5


def test_partial_cover_merge_path_value_and_grad():
    """A dropped superwindow (band unprofitable): its edges ride the
    spill population, its merged rows are zero before the spill adds,
    and values and gradient match the oracle on the kernel path."""
    rng = np.random.RandomState(1)
    n = 2048
    src, dst = [], []
    # supers 0..6: tight local bands (clearly profitable)
    for s in range(0, 1792, 256):
        for r in range(s, s + 256):
            cols = s + rng.randint(0, 128, size=6)
            src.extend([r] * 6)
            dst.extend(cols)
    # super 7: two scattered edges (band unprofitable on margin)
    for r in range(1792, 2048, 128):
        src.append(r)
        dst.append(int(rng.randint(0, n)))
    # symmetrize (dedup): the default backward reuses untransposed A
    pairs = np.unique(np.stack(
        [np.concatenate([src, dst]), np.concatenate([dst, src])], 1), axis=0)
    rp, ci = io.to_csr(pairs[:, 0], pairs[:, 1], n)
    # pinned cost constants: two scattered edges are cheaper to gather
    # than a 256x512 band block
    op = HybridSpMM(rp, ci, n, PlanConfig(
        loi_mode="intended", impl="triton", band_mode="auto",
        band_h=256, band_widths=(512,), gather_ns_per_row=0.2,
        stream_gbps=2500.0, a_elem_ps=1.0), interpret=True)
    p = op.plan
    assert not p.band_full_cover, "super 7 should drop to spill"
    assert set(int(v) for v in p.band_missing_sw) == {7}
    assert p.sparse_nnz == 0, "spill-mode routing is total"
    assert p.direct_bucket == -1, "partial cover takes the merge path"
    x = rng.randn(n, 24).astype(np.float32)
    z = np.asarray(op.apply(op.arrays, jnp.asarray(x)))
    zref = spmm_reference_dense(rp, ci, n, x)
    scale = np.abs(zref).max() + 1e-9
    assert np.abs(z - zref).max() / scale < 1e-5
    # gradient through the partial-cover op
    g = np.asarray(jax.grad(
        lambda v: (op.apply(op.arrays, v) ** 2).sum())(jnp.asarray(x)))
    a = np.zeros((n, n), np.float64)
    for r in range(n):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    zd = a @ np.asarray(x, np.float64)
    gref = 2.0 * (a.T @ zd)
    scale = np.abs(gref).max() + 1e-9
    assert np.abs(g - gref).max() / scale < 1e-5


# ----------------------------------------------------- the spill merge


def _spill_arrays(rows_e, cols_e, num_cols, cap_rows=0, cap_edges=0):
    """Spill arrays in the plan's layout from (row, col) edges sorted by
    row: unique rows (pad INT32_MAX), per-edge segment ids (pad = number
    of rows), columns (pad num_cols)."""
    rows_e = np.asarray(rows_e, np.int64)
    if len(rows_e):
        flags = np.r_[True, rows_e[1:] != rows_e[:-1]]
        rows_u = rows_e[flags]
        seg = np.cumsum(flags) - 1
    else:
        rows_u = np.zeros(0, np.int64)
        seg = np.zeros(0, np.int64)
    rp = max(len(rows_u), cap_rows, 1)
    ep = max(len(rows_e), cap_edges, 1)
    rows = np.full(rp, INT32_MAX, np.int32)
    rows[:len(rows_u)] = rows_u
    col = np.full(ep, num_cols, np.int32)
    col[:len(cols_e)] = cols_e
    sg = np.full(ep, rp, np.int32)
    sg[:len(seg)] = seg
    return rp, {"spill_rows": jnp.asarray(rows),
                "spill_edge_col": jnp.asarray(col),
                "spill_edge_seg": jnp.asarray(sg)}


def _scatter_ref(out, rows_e, cols_e, x):
    ref = np.asarray(out, np.float64).copy()
    np.add.at(ref, np.asarray(rows_e, np.int64),
              np.asarray(x, np.float64)[np.asarray(cols_e, np.int64)])
    return ref


def test_spill_plan_layout():
    """Plan spill arrays: sorted unique rows, segment ids per edge, and
    the padding conventions the merge relies on."""
    rp, ci, nn = small_graph(500, 8, span=400)
    p = build_plan(rp, ci, nn, PlanConfig(band_widths=(128,),
                                          band_mode="auto", band_h=128))
    assert p.has_spill and p.spill_nnz > 0
    rows, seg, col = p.spill_rows, p.spill_edge_seg, p.spill_edge_col
    real_rows = rows[rows != INT32_MAX]
    assert (np.diff(real_rows) > 0).all(), "rows sorted and unique"
    assert (np.diff(seg[:p.spill_nnz]) >= 0).all(), "segments sorted"
    assert seg[:p.spill_nnz].max() == len(real_rows) - 1
    assert (seg[p.spill_nnz:] == p.num_spill_rows).all()
    assert (col[p.spill_nnz:] == nn).all()
    # every spilled edge is a real edge of its row
    for e in range(0, p.spill_nnz, max(p.spill_nnz // 50, 1)):
        r = real_rows[seg[e]]
        assert col[e] in ci[rp[r]:rp[r + 1]]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("e", [3, 700, 5000])
def test_add_spill_matches_scatter_add(dtype, e):
    rng = np.random.RandomState(e)
    n, d = 900, 24
    rows_e = np.sort(rng.randint(0, n, e))
    cols_e = rng.randint(0, n, e)
    rp_cap, arrs = _spill_arrays(rows_e, cols_e, n, cap_edges=e + 5)
    x = jnp.asarray(rng.randn(n, d).astype(np.float32)).astype(dtype)
    out = jnp.asarray(rng.randn(n, d).astype(np.float32))
    got = np.asarray(jax.jit(lambda o, a, v: _add_spill(o, a, v, rp_cap))(
        out, arrs, x))
    ref = _scatter_ref(out, rows_e, cols_e, np.asarray(x.astype(jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


_REPEATED = np.random.RandomState(5)
_REPEATED_ROWS = np.sort(np.repeat(_REPEATED.choice(300, 40, replace=False),
                                   25))


@pytest.mark.parametrize("rows_e,cols_e,n,cap_rows,cap_edges", [
    # row padding (INT32_MAX) far above the real row count is dropped
    pytest.param([2, 2, 9, 63], [0, 5, 63, 1], 64, 50, 40, id="row_padding"),
    # many edges per row, columns repeated across rows
    pytest.param(_REPEATED_ROWS, _REPEATED.choice(20, len(_REPEATED_ROWS)),
                 300, 0, 0, id="repeated_columns"),
    # rows at the very end of the output (last row, last column)
    pytest.param([48, 49, 49], [49, 0, 49], 50, 4, 0, id="tail_rows"),
    # one edge over a large row space with heavy padding
    pytest.param([4000], [7], 4096, 64, 256, id="one_edge_heavy_padding"),
])
def test_add_spill_edge_cases(rows_e, cols_e, n, cap_rows, cap_edges):
    """Integer-valued features, so the float32 merge must be exact."""
    rng = np.random.RandomState(n)
    rp_cap, arrs = _spill_arrays(rows_e, cols_e, n, cap_rows=cap_rows,
                                 cap_edges=cap_edges)
    x = rng.randint(-8, 8, (n, 6)).astype(np.float32)
    out = rng.randint(-8, 8, (n, 6)).astype(np.float32)
    got = np.asarray(_add_spill(jnp.asarray(out), arrs, jnp.asarray(x),
                                rp_cap))
    np.testing.assert_array_equal(got, _scatter_ref(out, rows_e, cols_e, x))


def test_add_spill_pad_columns_clip():
    """Pad columns equal num_cols (one past X): the gather clips instead
    of reading NaN fill, and the dump segment never lands."""
    n, d = 16, 4
    rows_e, cols_e = np.array([1, 4]), np.array([3, 15])
    rp_cap, arrs = _spill_arrays(rows_e, cols_e, n, cap_edges=6)
    # rows 3 and 15 hold ones; a stray pad gather would add sevens
    x = jnp.asarray(np.where(np.isin(np.arange(n), [3, 15])[:, None],
                             1.0, 7.0).astype(np.float32))
    out = jnp.zeros((n, d), jnp.float32)
    got = np.asarray(_add_spill(out, arrs, x, rp_cap))
    ref = np.zeros((n, d))
    ref[1] = 1.0
    ref[4] = 1.0
    np.testing.assert_array_equal(got, ref)


def test_add_spill_bf16_output():
    """bf16 output: the merge accumulates in float32 and casts once."""
    rng = np.random.RandomState(6)
    n, d = 200, 8
    rows_e = np.sort(rng.randint(0, n, 900))
    cols_e = rng.randint(0, n, 900)
    rp_cap, arrs = _spill_arrays(rows_e, cols_e, n)
    x = jnp.asarray(rng.randn(n, d).astype(np.float32)).astype(jnp.bfloat16)
    out = jnp.zeros((n, d), jnp.bfloat16)
    got = np.asarray(_add_spill(out, arrs, x, rp_cap).astype(jnp.float32))
    ref = _scatter_ref(np.zeros((n, d)), rows_e, cols_e,
                       np.asarray(x.astype(jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=5e-2)


def test_add_spill_empty():
    """Capacity-forced arrays with no real edge (shard-uniform stacking)
    leave the output untouched; no spill rows means no spill pass."""
    n, d = 32, 4
    rp_cap, arrs = _spill_arrays([], [], n, cap_rows=3, cap_edges=5)
    out = jnp.asarray(np.random.RandomState(0).randn(n, d).astype(np.float32))
    x = jnp.ones((n, d), jnp.float32)
    np.testing.assert_array_equal(np.asarray(_add_spill(out, arrs, x, rp_cap)),
                                  np.asarray(out))
    assert _add_spill(out, {}, x, 0) is out


# ------------------------------------------------- spill plans end to end


def test_spill_plan_value_and_grad():
    """Spill plan through the kernel path: values and input gradient
    match the dense oracle."""
    rp, ci, nn = small_graph(500, 8, span=400)
    op = HybridSpMM(rp, ci, nn, PlanConfig(
        impl="triton", band_widths=(128,), band_mode="auto", band_h=128),
        interpret=True)
    assert op.plan.spill_nnz > 0
    x = np.random.RandomState(1).randn(nn, 32).astype(np.float32)
    z = np.asarray(jax.jit(op)(jnp.asarray(x)))
    zref = spmm_reference_dense(rp, ci, nn, x)
    np.testing.assert_allclose(z, zref, rtol=1e-5, atol=1e-4)
    g = jax.grad(lambda v: (op(v) ** 2).sum())(jnp.asarray(x))
    a = (spmm_reference_dense(rp, ci, nn, np.eye(nn)))
    np.testing.assert_allclose(np.asarray(g), 2 * a.T @ zref,
                               rtol=1e-3, atol=1e-3)


def test_spill_capacity_padded_shard_plan():
    """Capacity-padded (shard-uniform) plan with spill on a rectangular
    row block: forced capacities still give the exact result."""
    from hcspmm_tpu.ops.spmm import make_spmm

    rp, ci, nn = small_graph(400, 8, span=300)
    cfg = PlanConfig(impl="xla", band_widths=(128,), band_mode="auto",
                     band_h=64)
    p0 = build_plan(rp, ci, nn, cfg)
    caps = PlanCaps(band_supers=(p0.band_capacities[0] + 2,),
                    num_spill_rows=p0.num_spill_rows + 7,
                    num_spill_edges=p0.num_spill_edges + 11)
    p = build_plan(rp, ci, nn, cfg, caps=caps)
    assert p.num_spill_rows == p0.num_spill_rows + 7
    assert p.direct_bucket == -1, "capacity padding forbids the direct write"
    fn = make_spmm(p, p, compute_dtype="float32", impl="xla")
    arrs = {k: jnp.asarray(v) for k, v in p.device_arrays().items()}
    x = np.random.RandomState(2).randn(nn, 12).astype(np.float32)
    z = np.asarray(jax.jit(fn)(arrs, arrs, jnp.asarray(x)))
    np.testing.assert_allclose(z, spmm_reference_dense(rp, ci, nn, x),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl,seed", [("xla", 3), ("triton", 5)])
def test_powerlaw_auto_routing_spill(impl, seed):
    """Power-law plan under cost-model routing (hubs spill)."""
    rp, ci, nn = powerlaw_graph(1500, 6, seed=seed)
    op = HybridSpMM(rp, ci, nn, PlanConfig(impl=impl, band_widths=(128,),
                                           band_mode="auto", band_h=64),
                    interpret=impl == "triton")
    assert op.plan.spill_nnz > 0
    x = np.random.RandomState(seed).randn(nn, 20).astype(np.float32)
    z = np.asarray(jax.jit(op)(jnp.asarray(x)))
    np.testing.assert_allclose(z, spmm_reference_dense(rp, ci, nn, x),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_spill_bf16_matches_oracle(impl):
    """bf16 compute with a spill population agrees with the oracle at
    bf16 input rounding."""
    rp, ci, nn = small_graph(800, 8, span=700)
    x = np.random.RandomState(8).randn(nn, 16).astype(np.float32)
    zref = spmm_reference_dense(rp, ci, nn, x)
    op = HybridSpMM(rp, ci, nn, PlanConfig(
        impl=impl, band_widths=(128,), band_mode="auto", band_h=128,
        compute_dtype="bfloat16"), interpret=impl == "triton")
    assert op.plan.spill_nnz > 0
    z = np.asarray(jax.jit(op)(jnp.asarray(x)))
    assert np.linalg.norm(z - zref) / np.linalg.norm(zref) < 1e-2


# ------------------------------------------------------ partial cover


def _two_regime_graph(n=1024, seed=0):
    """Rows [0, n/2) local (bandable), rows [n/2, n) wired to far columns
    so their superwindows drop out of the band population."""
    rng = np.random.RandomState(seed)
    src, dst = [], []
    for r in range(n // 2):
        for c in rng.randint(max(r - 8, 0), min(r + 8, n), 4):
            src.append(r)
            dst.append(c)
    for r in range(n // 2, n):
        for c in rng.randint(0, n, 4):
            src.append(r)
            dst.append(c)
    rp, ci = io.to_csr(np.asarray(src), np.asarray(dst), n)
    return rp, ci, n


def _pinned_op(impl, rp, ci, nn, symmetric=True, **cfg):
    # pinned cost constants (float32 plans: a_elem_ps * A_ELEM_F32_SCALE
    # per A element): a far superwindow (few covered edges) drops out of
    # the band, a local one stays
    base = dict(impl=impl, band_widths=(128,), band_mode="auto", band_h=64,
                gather_ns_per_row=0.2, stream_gbps=2500.0, a_elem_ps=1.0)
    base.update(cfg)
    return HybridSpMM(rp, ci, nn, PlanConfig(**base), symmetric=symmetric,
                      interpret=impl == "triton")


def test_empty_superwindows_are_zero():
    """Superwindows with no edges at all produce exact zeros."""
    rp = np.zeros(257, np.int32)
    rp[1:65] = np.arange(1, 65)
    rp[65:] = 64
    ci = (np.arange(64) % 40).astype(np.int32)
    op = _pinned_op("triton", rp, ci, 256, band_mode="always", band_h=32,
                    band_widths=(64,))
    x = np.random.RandomState(0).randn(256, 8).astype(np.float32)
    z = np.asarray(jax.jit(op)(jnp.asarray(x)))
    assert (z[64:] == 0).all()
    np.testing.assert_allclose(z, spmm_reference_dense(rp, ci, 256, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_dropped_superwindows_merge_to_zero(impl):
    """A contiguous run of dropped superwindows: merged rows are zero,
    then the spill adds their edges."""
    rp, ci, nn = _two_regime_graph()
    op = _pinned_op(impl, rp, ci, nn)
    p = op.plan
    assert not p.band_full_cover and len(p.band_missing_sw) > 0
    missing = set(int(v) for v in p.band_missing_sw)
    assert all(s in missing for s in range(nn // 2 // 64 + 1, nn // 64))
    x = np.random.RandomState(1).randn(nn, 16).astype(np.float32)
    z = np.asarray(jax.jit(op)(jnp.asarray(x)))
    np.testing.assert_allclose(z, spmm_reference_dense(rp, ci, nn, x),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl,seed", [("xla", 2), ("triton", 3)])
def test_partial_cover_transposed_backward(impl, seed):
    """Partial cover + spill on an asymmetric graph: the input gradient
    runs the transposed backward plan."""
    rp, ci, nn = _two_regime_graph(seed=seed)
    op = _pinned_op(impl, rp, ci, nn, symmetric=False)
    x = np.random.RandomState(seed).randn(nn, 8).astype(np.float32)
    a = spmm_reference_dense(rp, ci, nn, np.eye(nn))
    g = jax.grad(lambda v: (op(v) ** 2).sum())(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g), 2 * a.T @ (a @ x),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cfg", [
    PlanConfig(),
    PlanConfig(band_mode="never"),
    PlanConfig(band_spill="never", band_widths=(128, 256)),
    PlanConfig(loi_mode="all_dense", band_mode="never"),
    PlanConfig(band_widths=(64,), band_h=64),
], ids=["default", "band_never", "spill_never", "all_dense", "narrow_band"])
def test_plan_conserves_edges(cfg):
    """Every edge lands in exactly one population."""
    rp, ci, nn = small_graph(700, 9, span=500)
    p = build_plan(rp, ci, nn, cfg)
    assert (p.band_nnz + p.spill_nnz + p.dense_nnz + p.sparse_nnz
            == int(rp[-1]))
    assert sum(len(e) for e in p.band_edges) == p.band_nnz
