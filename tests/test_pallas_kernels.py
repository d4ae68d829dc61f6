"""Triton band kernel path (impl='triton') vs dense oracle.

Mirrors the adversarial-shape matrix of test_spmm for the kernel path
(SURVEY.md §4.1).  On the CPU the kernel runs through the Pallas
interpreter (``interpret=True``), which also catches out-of-bounds
indexing (SURVEY.md §5 race-detection plan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.graphs import io
from hcspmm_tpu.kernels.band import _block, band_spmm
from hcspmm_tpu.ops.spmm import HybridSpMM, spmm_reference_dense

from conftest import small_graph


def kop(rp, ci, nn, cfg, **kw):
    """HybridSpMM on the kernel path, through the Pallas interpreter."""
    return HybridSpMM(rp, ci, nn, cfg, interpret=True, **kw)


def check(rp, ci, nn, dim, cfg, tol=1e-5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(nn, dim).astype(np.float32)
    op = kop(rp, ci, nn, cfg)
    z = np.asarray(jax.jit(op)(x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    scale = np.abs(zref).max() + 1e-9
    err = np.abs(z - zref).max() / scale
    assert err < tol, f"rel err {err}"
    return op


@pytest.mark.parametrize("mode", ["intended", "all_dense", "all_sparse"])
@pytest.mark.parametrize("dim", [7, 32, 96])
def test_pallas_modes_dims(mode, dim):
    rp, ci, nn = small_graph(100, 6)
    check(rp, ci, nn, dim, PlanConfig(loi_mode=mode, impl="triton"))


def test_pallas_unaligned_nodes_and_wide_windows():
    rp, ci, nn = small_graph(101, 12, span=64)
    check(rp, ci, nn, 33,
          PlanConfig(loi_mode="all_dense", bucket_widths=(8, 16),
                     impl="triton"))


def test_pallas_bf16_tolerance():
    rp, ci, nn = small_graph(100, 6)
    check(rp, ci, nn, 32,
          PlanConfig(compute_dtype="bfloat16", impl="triton"), tol=2e-2)


def test_pallas_gradient_matches_xla():
    rp, ci, nn = small_graph(80, 5)
    x = np.random.RandomState(3).randn(nn, 16).astype(np.float32)
    op_p = kop(rp, ci, nn, PlanConfig(impl="triton"))
    op_x = HybridSpMM(rp, ci, nn, PlanConfig(impl="xla"))

    def loss(op, x):
        return jnp.sum(op(jnp.asarray(x)) ** 2)

    gp = jax.grad(lambda v: loss(op_p, v))(jnp.asarray(x))
    gx = jax.grad(lambda v: loss(op_x, v))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,deg,dim", [
    (17, 2, 1),        # tiny graph, dim 1
    (100, 3, 130),     # dim just over a power of two
    (100, 3, 257),     # dim over two powers of two
    (3, 1, 8),         # n smaller than every block size
])
def test_pallas_adversarial_shapes(n, deg, dim):
    rp, ci, nn = small_graph(n, deg, span=max(4, n // 4))
    check(rp, ci, nn, dim, PlanConfig(impl="triton"), tol=1e-4)


def test_pallas_single_node_self_loop():
    rp = np.array([0, 1], np.int32)
    ci = np.array([0], np.int32)
    check(rp, ci, 1, 5, PlanConfig(impl="triton"), tol=1e-5)


def test_pallas_empty_graph():
    rp = np.zeros(33, np.int32)
    ci = np.zeros(0, np.int32)
    x = np.random.RandomState(0).randn(32, 9).astype(np.float32)
    op = kop(rp, ci, 32, PlanConfig(impl="triton"))
    z = np.asarray(jax.jit(op)(x))
    assert (z == 0).all()


def test_pallas_band_smaller_than_graph_pad():
    # graph smaller than the largest band bucket: X reads past the last
    # row must come back as zeros (kernel masks; XLA pads to xp_rows)
    rp, ci, nn = small_graph(40, 4, span=8)
    check(rp, ci, nn, 16,
          PlanConfig(impl="triton", band_mode="always",
                     band_h=32, band_widths=(64, 2048)), tol=1e-5)


def _block_graph(n=256, deg=4, seed=3, block=32):
    src, dst, nn = io.synthetic_blocks(n, deg, block, seed=seed)
    rp, ci = io.to_csr(src, dst, nn)
    from hcspmm_tpu.format import reorder as _ro
    perm = _ro.rcm_reorder(rp, ci, nn)
    rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    return rp, ci, nn


class TestDirectWrite:
    """Full single-bucket cover: the kernel writes every superwindow's
    output rows in place (no concat, no merge permutation)."""

    def _op(self, dim=24, **cfg):
        rp, ci, nn = _block_graph()
        base = dict(impl="triton", band_mode="always", band_h=32,
                    band_widths=(128,))
        base.update(cfg)
        op = kop(rp, ci, nn, PlanConfig(**base))
        x = np.random.RandomState(1).randn(nn, dim).astype(np.float32)
        return op, rp, ci, nn, x

    def test_direct_matches_oracle(self):
        op, rp, ci, nn, x = self._op()
        assert op.plan.direct_bucket == 0, "plan should take the direct write"
        out = jax.jit(lambda a, v: op.apply(a, v))(op.arrays, jnp.asarray(x))
        zref = spmm_reference_dense(rp, ci, nn, x)
        scale = np.abs(zref).max() + 1e-9
        assert out.shape == (nn, x.shape[1])
        assert np.abs(np.asarray(out) - zref).max() / scale < 1e-5

    def test_direct_chain_matches_double_apply(self):
        op, rp, ci, nn, x = self._op()
        out2 = jax.jit(lambda a, v: op.apply(a, op.apply(a, v)))(
            op.arrays, jnp.asarray(x))
        zref = spmm_reference_dense(
            rp, ci, nn, spmm_reference_dense(rp, ci, nn, x))
        scale = np.abs(zref).max() + 1e-9
        assert np.abs(np.asarray(out2) - zref).max() / scale < 1e-5

    def test_direct_gradient_matches_xla(self):
        op, rp, ci, nn, x = self._op()
        op_x = HybridSpMM(rp, ci, nn, op.config.__class__(
            **{**op.config.__dict__, "impl": "xla"}))

        def grad(o):
            return jax.jit(jax.grad(
                lambda a, v: jnp.sum(o.apply(a, v) ** 2), argnums=1))(
                o.arrays, jnp.asarray(x))

        np.testing.assert_allclose(np.asarray(grad(op)),
                                   np.asarray(grad(op_x)),
                                   rtol=1e-5, atol=1e-5)

    def test_merge_path_when_not_full_cover(self):
        # band off: no direct bucket, the merge path assembles the rows
        op, rp, ci, nn, x = self._op(band_mode="never")
        assert op.plan.direct_bucket == -1
        z = np.asarray(jax.jit(op)(jnp.asarray(x)))
        zref = spmm_reference_dense(rp, ci, nn, x)
        scale = np.abs(zref).max() + 1e-9
        assert np.abs(z - zref).max() / scale < 1e-4

    def test_direct_normalized(self):
        op, rp, ci, nn, x = self._op()
        opn = kop(rp, ci, nn, op.config, normalize=True)
        z = np.asarray(jax.jit(lambda a, v: opn.apply(a, v))(
            opn.arrays, jnp.asarray(x)))
        deg = np.maximum(np.diff(rp), 1).astype(np.float64)
        inv = 1.0 / np.sqrt(deg)
        zref = inv[:, None] * spmm_reference_dense(rp, ci, nn,
                                                   x * inv[:, None])
        np.testing.assert_allclose(z, zref, rtol=1e-5, atol=1e-5)


def _band_numpy(starts, sw, a, x, num_blocks):
    sb, bh, w = a.shape
    xp = np.concatenate([np.asarray(x, np.float64),
                         np.zeros((w, x.shape[1]))])
    out = np.zeros((num_blocks * bh, x.shape[1]))
    for i in range(sb):
        out[sw[i] * bh:(sw[i] + 1) * bh] = (
            a[i].astype(np.float64) @ xp[starts[i]:starts[i] + w])
    return out


class TestBandKernel:
    """The kernel alone against a NumPy loop: shapes, block choice,
    row masking, column masking, bit-packed A."""

    @pytest.mark.parametrize("bh,w,d,packed", [
        (64, 128, 32, False), (32, 192, 96, False),
        (128, 64, 20, True), (16, 16, 1, False),
    ])
    def test_band_kernel_matches_numpy(self, bh, w, d, packed):
        rng = np.random.RandomState(bh + w + d)
        sb, r = 4, 300
        a = (rng.rand(sb, bh, w) < 0.1).astype(np.int8)
        starts = rng.randint(0, r, sb).astype(np.int32)
        sw = rng.permutation(sb).astype(np.int32)
        x = rng.randn(r, d).astype(np.float32)
        av = (np.packbits(a.view(np.uint8), axis=1, bitorder="little")
              if packed else a)
        out = band_spmm(jnp.asarray(starts), jnp.asarray(sw),
                        jnp.asarray(av), jnp.asarray(x), sb, jnp.float32,
                        interpret=True)
        np.testing.assert_allclose(np.asarray(out),
                                   _band_numpy(starts, sw, a, x, sb),
                                   rtol=1e-5, atol=1e-5)

    def test_band_kernel_rows_past_x_read_zero(self):
        rng = np.random.RandomState(0)
        a = np.ones((1, 16, 64), np.int8)
        x = rng.randn(40, 8).astype(np.float32)
        out = band_spmm(jnp.asarray([30], jnp.int32),
                        jnp.asarray([0], jnp.int32), jnp.asarray(a),
                        jnp.asarray(x), 1, jnp.float32, interpret=True)
        np.testing.assert_allclose(np.asarray(out)[0], x[30:].sum(0),
                                   rtol=1e-5)

    def test_band_kernel_writes_named_blocks_only(self):
        # sw = arange(Sb) writes entry i's rows at i*bh (merge layout)
        rng = np.random.RandomState(1)
        a = (rng.rand(3, 32, 32) < 0.3).astype(np.int8)
        starts = np.array([0, 5, 9], np.int32)
        x = rng.randn(64, 16).astype(np.float32)
        sw = np.arange(3, dtype=np.int32)
        out = band_spmm(jnp.asarray(starts), jnp.asarray(sw), jnp.asarray(a),
                        jnp.asarray(x).astype(jnp.bfloat16), 3, jnp.float32,
                        interpret=True)
        xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                        .astype(jnp.float32))
        np.testing.assert_allclose(np.asarray(out),
                                   _band_numpy(starts, sw, a, xb, 3),
                                   rtol=1e-5, atol=1e-5)

    def test_band_block_choice(self):
        assert _block(576) == 64 and _block(256) == 64
        assert _block(96) == 32 and _block(48) == 16
        with pytest.raises(ValueError):
            _block(24)


def test_rectangular_band_full_cover_shard_plan():
    """Row-block shard operand (num_cols > num_nodes) through the kernel's
    full-cover band path: row counts must come from the plan, not from
    the column-space X operand."""
    from hcspmm_tpu.format.plan import build_plan
    from hcspmm_tpu.ops.spmm import make_spmm

    rng = np.random.RandomState(2)
    n_rows, n_cols, d = 64, 256, 9
    # every row's neighbours inside a narrow window -> bands fit
    rp = np.arange(0, 4 * (n_rows + 1), 4, dtype=np.int32)
    base = (np.arange(n_rows) * 3).astype(np.int32)
    ci = np.sort(
        (base[:, None] + rng.randint(0, 24, (n_rows, 4))) % n_cols, axis=1
    ).astype(np.int32).reshape(-1)
    cfg = PlanConfig(impl="triton", band_mode="always", band_h=32,
                     band_widths=(256,))
    plan = build_plan(rp, ci, n_rows, cfg, num_cols=n_cols)
    assert plan.band_full_cover and plan.num_cols != plan.num_nodes
    fn = make_spmm(plan, plan, compute_dtype="float32", impl="triton",
                   interpret=True)
    arrs = {k: jnp.asarray(v) for k, v in plan.device_arrays().items()}
    x = rng.randn(n_cols, d).astype(np.float32)
    z = np.asarray(jax.jit(fn)(arrs, arrs, jnp.asarray(x)))
    assert z.shape == (n_rows, d)
    a = np.zeros((n_rows, n_cols))
    for r in range(n_rows):
        a[r, ci[rp[r]: rp[r + 1]]] = 1  # binary adjacency: dups collapse
    np.testing.assert_allclose(z, a @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim", [130, 257])
def test_wide_dim_past_power_of_two(dim):
    """Feature widths past a power of two: the kernel loads a masked
    power-of-two column block and stores only the true width."""
    rp, ci, nn = _block_graph()
    op = kop(rp, ci, nn, PlanConfig(impl="triton", band_mode="always",
                                    band_h=32, band_widths=(256,)))
    x = np.random.RandomState(1).randn(nn, dim).astype(np.float32)
    z = np.asarray(jax.jit(op)(jnp.asarray(x)))
    zref = spmm_reference_dense(rp, ci, nn, x)
    scale = np.abs(zref).max() + 1e-9
    assert z.shape == (nn, dim)
    assert np.abs(z - zref).max() / scale < 1e-5


def test_multi_bucket_merge_chain():
    """Two-bucket full-cover plan: each bucket's kernel output goes
    through the merge permutation."""
    rng = np.random.RandomState(0)
    # mixed component sizes -> mixed extents -> two width buckets
    sizes = [24] * 12 + [120] * 2
    src_p, dst_p, lo = [], [], 0
    for s_ in sizes:
        cnt = s_ * 3
        src_p.append(rng.randint(lo, lo + s_, cnt))
        dst_p.append(rng.randint(lo, lo + s_, cnt))
        lo += s_
    src = np.concatenate(src_p + dst_p)
    dst = np.concatenate(dst_p + src_p)
    k = src != dst
    nn = lo
    rp, ci = io.to_csr(src[k], dst[k], nn)
    op = kop(rp, ci, nn, PlanConfig(impl="triton", band_mode="always",
                                    band_h=32, band_widths=(64, 256)))
    plan = op.plan
    assert sum(len(s) > 0 for s in plan.band_sw_ids) == 2
    assert plan.direct_bucket == -1
    x = rng.randn(nn, 12).astype(np.float32)
    out = jax.jit(lambda a, v: op.apply(a, op.apply(a, v)))(
        op.arrays, jnp.asarray(x))
    zref = spmm_reference_dense(
        rp, ci, nn, spmm_reference_dense(rp, ci, nn, x))
    scale = np.abs(zref).max() + 1e-9
    assert np.abs(np.asarray(out) - zref).max() / scale < 1e-5
