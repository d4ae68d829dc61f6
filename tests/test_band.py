"""Band population through the Triton kernel, end to end.

Oracle tests of the band path as the models use it: band shapes, spill,
multi-bucket and partial cover, the direct write, gradients, normalised
and mean aggregation, layer cores and training steps.  The kernel runs
through the Pallas interpreter on the CPU (``interpret=True``) and every
result is compared with a dense NumPy oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.ops.spmm import (HybridSpMM, SpmmShape, spmm_apply,
                                 spmm_reference_dense)

from conftest import small_graph


def _cfg(**kw):
    kw.setdefault("impl", "triton")
    kw.setdefault("band_mode", "always")
    kw.setdefault("band_h", 128)
    return PlanConfig(**kw)


def _op(rp, ci, nn, cfg, **kw):
    return HybridSpMM(rp, ci, nn, cfg, interpret=True, **kw)


def _dense_a(rp, ci, nn):
    a = np.zeros((nn, nn), dtype=np.float32)
    for r in range(nn):
        a[r, ci[rp[r]:rp[r + 1]]] = 1.0
    return a


def _err(z, zref):
    return np.abs(np.asarray(z) - zref).max() / (np.abs(zref).max() + 1e-9)


@pytest.mark.parametrize("band_h", [32, 64, 128])
@pytest.mark.parametrize("dim", [32, 20, 7, 96])
def test_band_kernel_path_matches_oracle(band_h, dim):
    rp, ci, nn = small_graph(300, 6)
    op = _op(rp, ci, nn, _cfg(band_h=band_h))
    assert op.impl == "triton"
    for s in range(len(op.plan.band_widths)):
        assert (op.plan.band_starts[s] % 16 == 0).all()
    x = np.random.RandomState(0).randn(nn, dim).astype(np.float32)
    z = jax.jit(op)(jnp.asarray(x))
    assert _err(z, spmm_reference_dense(rp, ci, nn, x)) < 1e-5


def test_band_spill_matches_oracle():
    # long-range edges overflow the placed window -> spill population
    rp, ci, nn = small_graph(500, 8, span=400)
    op = _op(rp, ci, nn, _cfg(band_widths=(128,), band_mode="auto"))
    assert op.plan.spill_nnz > 0, "test graph must exercise spill"
    x = np.random.RandomState(1).randn(nn, 16).astype(np.float32)
    z = jax.jit(op)(jnp.asarray(x))
    assert _err(z, spmm_reference_dense(rp, ci, nn, x)) < 1e-5


def test_band_direct_write_with_spill():
    """Full single-bucket cover AND a spill population: the kernel writes
    the rows in place, then the spill segment-sum adds onto them."""
    rp, ci, nn = small_graph(600, 8, span=300)
    op = _op(rp, ci, nn, _cfg(band_widths=(128,), band_mode="always"))
    assert op.plan.direct_bucket == 0 and op.plan.spill_nnz > 0
    x = np.random.RandomState(3).randn(nn, 16).astype(np.float32)
    z = jax.jit(op)(jnp.asarray(x))
    assert _err(z, spmm_reference_dense(rp, ci, nn, x)) < 1e-5


def test_band_spill_bf16_hub_graph():
    """Power-law graph (hub columns spill) in bf16 compute: float32
    accumulation keeps the error at bf16 input rounding."""
    from hcspmm_tpu.graphs import io

    src, dst, nn = io.synthetic_powerlaw(1200, 6, seed=4)
    rp, ci = io.to_csr(src, dst, nn)
    op = _op(rp, ci, nn, _cfg(band_widths=(128,), band_mode="auto",
                              compute_dtype="bfloat16"))
    assert op.plan.spill_nnz > 0
    x = np.random.RandomState(4).randn(nn, 16).astype(np.float32)
    z = jax.jit(op)(jnp.asarray(x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    rel = np.linalg.norm(np.asarray(z) - zref) / np.linalg.norm(zref)
    assert rel < 1e-2


def test_band_multi_bucket_and_missing_supers():
    # two-width ladder + partial cover (dropped supers ride the spill)
    rp, ci, nn = small_graph(700, 10, span=500)
    op = _op(rp, ci, nn, _cfg(band_widths=(128, 256), band_mode="auto"))
    x = np.random.RandomState(2).randn(nn, 24).astype(np.float32)
    z = jax.jit(op)(jnp.asarray(x))
    assert _err(z, spmm_reference_dense(rp, ci, nn, x)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_chained_apply(dtype):
    """Chained application (output feeds the next SpMM) == A @ (A @ X)."""
    rp, ci, nn = small_graph(300, 6)
    op = _op(rp, ci, nn, _cfg(compute_dtype=dtype))
    d = 32
    x = np.random.RandomState(3).randn(nn, d).astype(np.float32)

    @jax.jit
    def two(arrs, v):
        return op.apply(arrs, op.apply(arrs, v))

    out = np.asarray(two(op.arrays, jnp.asarray(x)))
    a = _dense_a(rp, ci, nn)
    zref = a @ (a @ x)
    rel = np.linalg.norm(out - zref) / np.linalg.norm(zref)
    assert rel < (1e-5 if dtype == "float32" else 1e-2), rel


def test_band_layer_core_grads():
    """Layer cores (gcn_apply / gin_apply): values AND weight grads match
    the dense oracle."""
    rp, ci, nn = small_graph(300, 6)
    op = _op(rp, ci, nn, _cfg())
    d, h = 24, 12
    rs = np.random.RandomState(4)
    x = jnp.asarray(rs.randn(nn, d).astype(np.float32))
    w = jnp.asarray(rs.randn(d, h).astype(np.float32) * 0.1)
    a = jnp.asarray(_dense_a(rp, ci, nn))

    def gcn_loss(wm):
        return (op.gcn_apply(op.arrays, x, wm) ** 2).sum()

    def gcn_ref(wm):
        return jnp.sum((a @ (x @ wm)) ** 2)

    v, g = jax.value_and_grad(gcn_loss)(w)
    vr, gr = jax.value_and_grad(gcn_ref)(w)
    assert np.allclose(float(v), float(vr), rtol=1e-4)
    assert np.allclose(np.asarray(g), np.asarray(gr), rtol=1e-3, atol=1e-2)

    def gin_loss(wm):
        return (op.gin_apply(op.arrays, x, wm) ** 2).sum()

    def gin_ref(wm):
        return jnp.sum(((a @ x) @ wm) ** 2)

    v, g = jax.value_and_grad(gin_loss)(w)
    vr, gr = jax.value_and_grad(gin_ref)(w)
    assert np.allclose(float(v), float(vr), rtol=1e-4)
    assert np.allclose(np.asarray(g), np.asarray(gr), rtol=1e-3, atol=1e-2)


def test_band_input_grad():
    """d/dX through the kernel op (custom_vjp, symmetric plan)."""
    rp, ci, nn = small_graph(200, 5)
    op = _op(rp, ci, nn, _cfg())
    d = 16
    x = np.random.RandomState(5).randn(nn, d).astype(np.float32)
    a = _dense_a(rp, ci, nn)

    def loss(xv):
        return (op.apply(op.arrays, xv) ** 2).sum()

    def ref(xv):
        return jnp.sum((jnp.asarray(a) @ xv) ** 2)

    g = jax.grad(loss)(jnp.asarray(x))
    gr = jax.grad(ref)(jnp.asarray(x))
    assert np.allclose(np.asarray(g), np.asarray(gr), rtol=1e-3, atol=1e-2)


def test_band_normalized_and_mean():
    rp, ci, nn = small_graph(200, 5)
    op = _op(rp, ci, nn, _cfg(), normalize=True)
    d = 8
    x = np.random.RandomState(6).randn(nn, d).astype(np.float32)
    a = _dense_a(rp, ci, nn)
    deg = np.maximum(a.sum(1), 1.0)
    out = np.asarray(op.apply(op.arrays, jnp.asarray(x)))
    zref = (a @ (x / np.sqrt(deg)[:, None])) / np.sqrt(deg)[:, None]
    assert np.allclose(out, zref, rtol=1e-4, atol=1e-4)
    outm = np.asarray(op.mean_apply(op.arrays, jnp.asarray(x)))
    zm = (a @ x) / deg[:, None]
    assert np.allclose(outm, zm, rtol=1e-4, atol=1e-4)


def test_band_training_step_runs():
    """2-layer GCN + GIN train a few epochs through the kernel path."""
    from hcspmm_tpu.models.net import Net
    from hcspmm_tpu.train.loop import train

    rp, ci, nn = small_graph(300, 6)
    op = _op(rp, ci, nn, _cfg())
    x = np.random.RandomState(7).randn(nn, 16).astype(np.float32)
    y = np.ones(nn, dtype=np.int32)
    for model in ("gcn", "gin"):
        net = Net(model=model, num_features=16, hidden=8, num_classes=4,
                  num_layers=2)
        res = train(net, op, x, y, epochs=3, warmup_epochs=1, scan_chunk=1)
        assert np.isfinite(res["final_loss"]), (model, res["final_loss"])


def test_band_rejects_bad_configs():
    rp, ci, nn = small_graph(100, 5)
    with pytest.raises(ValueError):
        _op(rp, ci, nn, _cfg(impl="pallas"))
    with pytest.raises(ValueError):
        _op(rp, ci, nn, _cfg(band_h=72))        # not a window_h multiple
    with pytest.raises(ValueError):
        _op(rp, ci, nn, _cfg(band_widths=(72,)))  # not a 16 multiple


def test_band_spill_routing_is_total():
    """Spill-mode routing is total: every edge lands in exactly one
    population (band, spill, dense bucket, or sparse) — none is dropped
    and none is counted twice."""
    rp, ci, nn = small_graph(600, 10, span=500)
    op = _op(rp, ci, nn, _cfg(band_widths=(128,), band_mode="auto"))
    p = op.plan
    assert p.sparse_nnz == 0, "spill mode leaves nothing to the ELL paths"
    assert p.band_nnz + p.spill_nnz + p.dense_nnz == int(rp[-1])
    x = np.random.RandomState(3).randn(nn, 32).astype(np.float32)
    z = jax.jit(op)(jnp.asarray(x))
    assert _err(z, spmm_reference_dense(rp, ci, nn, x)) < 1e-5


def test_direct_write_matches_merge_path():
    """The direct write and the merge path give the same rows on one
    plan: forcing the merge path (no direct bucket) changes nothing."""
    rp, ci, nn = small_graph(300, 6)
    op = _op(rp, ci, nn, _cfg())
    assert op.plan.direct_bucket >= 0
    x = jnp.asarray(np.random.RandomState(5).randn(nn, 16).astype(np.float32))
    shape = SpmmShape.of_plan(op.plan)
    merge = dataclasses.replace(shape, direct_bucket=-1)
    cd = jnp.float32
    run = jax.jit(lambda a, v, sh: spmm_apply(a, v, sh, cd, "triton", True),
                  static_argnums=2)
    zd = np.asarray(run(op.arrays["f"], x, shape))
    zm = np.asarray(run(op.arrays["f"], x, merge))
    np.testing.assert_allclose(zd, zm, rtol=1e-6, atol=1e-6)
    assert _err(zd, spmm_reference_dense(rp, ci, nn, np.asarray(x))) < 1e-5
