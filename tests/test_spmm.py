"""Hybrid SpMM vs dense oracle — adversarial shapes per SURVEY.md §4.1:
empty windows, windows with many unique cols (> tile_k), N not divisible
by 16, dims not in {32, 64}, asymmetric graphs with transposed backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.graphs import io
from hcspmm_tpu.ops.spmm import HybridSpMM, spmm_reference_dense

from conftest import small_graph


def check(rp, ci, nn, dim, cfg=PlanConfig(), tol=1e-5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(nn, dim).astype(np.float32)
    # the kernel path runs through the Pallas interpreter here
    op = HybridSpMM(rp, ci, nn, cfg, interpret=cfg.impl == "triton")
    z = np.asarray(jax.jit(op)(x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    scale = np.abs(zref).max() + 1e-9
    err = np.abs(z - zref).max() / scale
    assert err < tol, f"rel err {err}"
    return op


@pytest.mark.parametrize("mode", ["intended", "all_dense", "all_sparse", "degenerate"])
@pytest.mark.parametrize("dim", [7, 32, 96])
def test_spmm_modes_dims(mode, dim):
    rp, ci, nn = small_graph(100, 6)
    check(rp, ci, nn, dim, PlanConfig(loi_mode=mode))


def test_unaligned_num_nodes():
    rp, ci, nn = small_graph(37, 3, span=8)   # N % 16 != 0
    check(rp, ci, nn, 5)


def test_wide_window_exceeds_bucket_cap():
    """A hub row with degree beyond the last bucket width must fall back to
    the sparse path — the case that silently overflows the reference's
    MAX_BLK=3/S_SIZE=62 smem caps."""
    n = 48
    src = np.concatenate([np.zeros(40, np.int32), np.array([17], np.int32)])
    dst = np.concatenate([np.arange(1, 41, dtype=np.int32), np.array([3], np.int32)])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    rp, ci = io.to_csr(src, dst, n)
    op = check(rp, ci, n, 9, PlanConfig(loi_mode="all_dense", bucket_widths=(8, 16),
                                        band_mode="never"))
    # window 0 has ~41 unique cols > 16 -> routed sparse despite all_dense
    assert op.plan.sparse_nnz > 0
    assert op.plan.num_dense_windows < 3


def test_empty_graph_rows():
    # many isolated nodes
    src = np.array([0, 5], dtype=np.int32)
    dst = np.array([5, 0], dtype=np.int32)
    rp, ci = io.to_csr(src, dst, 100)
    check(rp, ci, 100, 4)


def test_self_loops_and_duplicates():
    src = np.array([0, 0, 1, 1, 1], dtype=np.int32)
    dst = np.array([0, 1, 0, 0, 2], dtype=np.int32)  # duplicate (1,0)
    rp, ci = io.to_csr(src, dst, 20)
    check(rp, ci, 20, 3)  # duplicates merged => binary A


def test_bf16_tolerance():
    rp, ci, nn = small_graph(128, 8)
    check(rp, ci, nn, 32, PlanConfig(compute_dtype="bfloat16"), tol=2e-2)


def test_asymmetric_backward_transposed():
    """Safe mode: on a directed graph, grad must flow through A^T."""
    rp, ci, nn = small_graph(60, 4, symmetric=False)
    rng = np.random.RandomState(0)
    x = rng.randn(nn, 6).astype(np.float32)

    op = HybridSpMM(rp, ci, nn, symmetric=False)
    g = jax.grad(lambda x: (op(x) ** 2).sum())(x)

    a = np.zeros((nn, nn))
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1
    gref = 2 * a.T @ (a @ x)
    err = np.abs(np.asarray(g) - gref).max() / (np.abs(gref).max() + 1e-9)
    assert err < 1e-5, err


def test_symmetric_backward_matches_reference_semantics():
    """Default mode reuses untransposed A (GNN_model.py:49-57)."""
    rp, ci, nn = small_graph(60, 4, symmetric=True)
    rng = np.random.RandomState(0)
    x = rng.randn(nn, 6).astype(np.float32)
    op = HybridSpMM(rp, ci, nn)
    g = jax.grad(lambda x: (op(x) ** 2).sum())(x)
    a = np.zeros((nn, nn))
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1
    gref = 2 * a @ (a @ x)  # symmetric: A == A^T
    err = np.abs(np.asarray(g) - gref).max() / (np.abs(gref).max() + 1e-9)
    assert err < 1e-5, err


def test_jit_recompile_free_across_calls():
    rp, ci, nn = small_graph(64, 4)
    op = HybridSpMM(rp, ci, nn)
    f = jax.jit(op)
    x = np.random.RandomState(0).randn(nn, 8).astype(np.float32)
    z1 = f(x)
    z2 = f(x + 1)
    assert z1.shape == z2.shape == (nn, 8)


def test_band_path_modes():
    """Banded superwindows: always/auto/never all match the oracle, and
    'always' actually routes locality-friendly rows to the band path."""
    rp, ci, nn = small_graph(300, 6, span=16)
    for bm in ("always", "auto", "never"):
        op = check(rp, ci, nn, 24,
                   PlanConfig(band_mode=bm, band_h=64, band_widths=(128, 256)))
        if bm == "always":
            assert op.plan.num_band_supers > 0
            assert op.plan.band_nnz > 0
        if bm == "never":
            assert op.plan.num_band_supers == 0


def test_band_on_block_graph_with_rcm():
    """Shuffled block-diagonal graph + RCM reordering: the band path should
    capture most nnz (the DD-style locality rediscovery)."""
    from hcspmm_tpu.format import reorder as _ro
    from hcspmm_tpu.graphs import io as _io

    src, dst, nn = _io.synthetic_blocks(1024, 6, block_size=100, seed=3)
    rp, ci = _io.to_csr(src, dst, nn)
    perm = _ro.rcm_reorder(rp, ci, nn)
    rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    op = check(rp, ci, nn, 32,
               PlanConfig(band_mode="always", band_h=128,
                          band_widths=(128, 256, 512)))
    assert op.plan.band_nnz > 0.5 * op.plan.nnz, (
        op.plan.band_nnz, op.plan.nnz)


def test_band_gradient():
    import jax.numpy as jnp

    rp, ci, nn = small_graph(200, 5, span=16)
    cfg = PlanConfig(band_mode="always", band_h=64, band_widths=(64, 128))
    op = HybridSpMM(rp, ci, nn, cfg)
    x = jnp.asarray(np.random.RandomState(1).randn(nn, 16).astype(np.float32))
    g = jax.grad(lambda v: (op(v) ** 2).sum())(x)
    # backward = A^T(2Az) = 2 A A z for symmetric A
    a = np.zeros((nn, nn), np.float64)
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    gref = 2 * a.T @ (a @ np.asarray(x, np.float64))
    np.testing.assert_allclose(np.asarray(g), gref, rtol=1e-3, atol=1e-3)


def test_multi_bucket_band_scatter_merge():
    """Mixed component sizes that defeat the single-bucket collapse rule:
    the full-coverage output assembles through the merge permutation."""
    rng = np.random.RandomState(0)
    sizes = [40] * 60 + [400] * 2
    src_p, dst_p, lo = [], [], 0
    for s_ in sizes:
        cnt = s_ * 4
        src_p.append(rng.randint(lo, lo + s_, cnt))
        dst_p.append(rng.randint(lo, lo + s_, cnt))
        lo += s_
    src = np.concatenate(src_p); dst = np.concatenate(dst_p)
    k = src != dst
    src, dst = src[k], dst[k]
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    rp, ci = io.to_csr(src, dst, lo)
    from hcspmm_tpu.format import reorder as _ro

    perm = _ro.rcm_reorder(rp, ci, lo)
    rp, ci = _ro.apply_permutation(rp, ci, lo, perm)
    op = check(rp, ci, lo, 48,
               PlanConfig(impl="triton", band_mode="always", band_h=64,
                          band_widths=(128, 512)), tol=1e-4)
    used = [len(s) for s in op.plan.band_sw_ids if len(s) > 0]
    assert len(used) >= 2, used          # genuinely multi-bucket
    assert op.plan.band_full_cover


def test_expand_row_bits_roundtrip():
    from hcspmm_tpu.ops.spmm import _expand_row_bits

    rng = np.random.RandomState(0)
    a = (rng.rand(3, 32, 24) < 0.3).astype(np.int8)
    packed = np.packbits(a.astype(np.uint8), axis=1, bitorder="little")
    out = np.asarray(_expand_row_bits(jnp.asarray(packed), 32))
    np.testing.assert_array_equal(out, a)


def test_band_arrays_packed_for_kernel():
    """The kernel path keeps band A bit-packed on device (uint8,
    band_h/8 rows); the XLA path expands it to int8 once."""
    from conftest import small_graph

    rp, ci, nn = small_graph(64, 4)
    cfg = dict(band_mode="always", band_h=32, band_widths=(64,))
    op_t = HybridSpMM(rp, ci, nn, PlanConfig(impl="triton", **cfg),
                      interpret=True)
    op_x = HybridSpMM(rp, ci, nn, PlanConfig(impl="xla", **cfg))
    at, ax = op_t.arrays["f"]["band0_a"], op_x.arrays["f"]["band0_a"]
    assert at.dtype == jnp.uint8 and at.shape[1] == 32 // 8
    assert ax.dtype == jnp.int8 and ax.shape[1] == 32
    from hcspmm_tpu.ops.spmm import _expand_row_bits

    np.testing.assert_array_equal(np.asarray(_expand_row_bits(at, 32)),
                                  np.asarray(ax))
    x = np.random.RandomState(0).randn(nn, 8).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jax.jit(op_t)(x)),
                               np.asarray(jax.jit(op_x)(x)),
                               rtol=1e-5, atol=1e-5)
