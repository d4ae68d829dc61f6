"""Distributed SpMM on a virtual 8-device CPU mesh (SURVEY.md §4.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.ops.spmm import spmm_reference_dense
from hcspmm_tpu.parallel.dist_spmm import DistHybridSpMM
from hcspmm_tpu.parallel.partition import build_sharded_plan

from conftest import small_graph


def make_mesh(n):
    devs = jax.devices()[:n]
    return Mesh(np.array(devs), ("x",))


@pytest.mark.parametrize("mode", ["allgather", "halo"])
@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_dist_matches_oracle(mode, nshards):
    rp, ci, nn = small_graph(200, 6, span=32)
    mesh = make_mesh(nshards)
    op = DistHybridSpMM(rp, ci, nn, mesh, mode=mode)
    rng = np.random.RandomState(0)
    x = rng.randn(nn, 12).astype(np.float32)
    xp = jax.device_put(op.pad(x), op.sharding)
    z = np.asarray(jax.jit(op)(xp))[:nn]
    zref = spmm_reference_dense(rp, ci, nn, x)
    err = np.abs(z - zref).max() / (np.abs(zref).max() + 1e-9)
    assert err < 1e-5, f"{mode}/{nshards}: rel err {err}"


@pytest.mark.parametrize("mode", ["allgather", "halo"])
def test_dist_grad(mode):
    rp, ci, nn = small_graph(100, 5, span=16)
    mesh = make_mesh(4)
    op = DistHybridSpMM(rp, ci, nn, mesh, mode=mode)
    rng = np.random.RandomState(1)
    x = rng.randn(nn, 8).astype(np.float32)
    xp = jax.device_put(op.pad(x), op.sharding)
    g = np.asarray(jax.grad(lambda x: (op(x) ** 2).sum())(xp))[:nn]

    a = np.zeros((nn, nn))
    for r in range(nn):
        a[r, ci[rp[r]: rp[r + 1]]] = 1
    gref = 2 * a @ (a @ x)  # symmetric graph
    err = np.abs(g - gref).max() / (np.abs(gref).max() + 1e-9)
    assert err < 1e-5, err


def test_sharded_plan_shapes_uniform():
    rp, ci, nn = small_graph(150, 6)
    sp = build_sharded_plan(rp, ci, nn, 4, PlanConfig(), mode="halo")
    for k, v in sp.stacked.items():
        assert v.shape[0] == 4, k
    assert sp.n_padded % (4 * 16) == 0
    assert sp.send_idx.shape == (4, 3, sp.halo_pair)
    # send indices are valid local rows
    assert sp.send_idx.max() < sp.rows_per_shard


def test_dist_in_training_step():
    """dist spmm composes with a jitted GCN step under GSPMD."""
    from hcspmm_tpu.models.net import Net, init_net_params, net_forward
    from hcspmm_tpu.train.loop import nll_loss

    rp, ci, nn = small_graph(100, 5, span=16)
    mesh = make_mesh(4)
    op = DistHybridSpMM(rp, ci, nn, mesh, mode="halo")
    net = Net(model="gcn", num_features=8, hidden=8, num_classes=3, num_layers=2)
    params = init_net_params(net, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    x = jax.device_put(op.pad(rng.randn(nn, 8).astype(np.float32)), op.sharding)
    y = jax.device_put(
        np.ones(op.n_padded, dtype=np.int32),
        NamedSharding(mesh, P("x")),
    )

    @jax.jit
    def loss_fn(params, x, y):
        logp = net_forward(net, params, op, x, train=False)
        return nll_loss(logp, y)

    g = jax.jit(jax.grad(loss_fn))(params, x, y)
    assert all(np.isfinite(np.asarray(l)).all() for l in jax.tree.leaves(g))


def test_allgather_band_path_matches_oracle():
    """Banded superwindows stay enabled under allgather sharding (the
    gathered X is the global column space); halo mode carves them out."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.format import reorder as _ro
    from hcspmm_tpu.ops.spmm import spmm_reference_dense
    from hcspmm_tpu.parallel.dist_spmm import DistHybridSpMM

    src, dst, nn = io.synthetic_blocks(1024, 6, block_size=100, seed=5)
    rp, ci = io.to_csr(src, dst, nn)
    perm = _ro.rcm_reorder(rp, ci, nn)
    rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    x = np.random.RandomState(0).randn(nn, 16).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    cfg = PlanConfig(band_mode="always", band_h=64, band_widths=(128, 256))
    op = DistHybridSpMM(rp, ci, nn, mesh, config=cfg, mode="allgather")
    assert any(len(p.band_sw_ids[s]) > 0
               for p in op.sharded.plans
               for s in range(len(p.band_widths)))
    z = np.asarray(op(jax.device_put(op.pad(x), op.sharding)))[:nn]
    ref = spmm_reference_dense(rp, ci, nn, x)
    np.testing.assert_allclose(z, ref, rtol=1e-4, atol=1e-4)


def test_band_halo_matches_oracle():
    """Fixed-size boundary-strip halo: bands run unchanged on shards; the
    exchange is two ppermutes of the largest band width per direction."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.format import reorder as _ro
    from hcspmm_tpu.ops.spmm import spmm_reference_dense
    from hcspmm_tpu.parallel.dist_spmm import DistHybridSpMM

    src, dst, nn = io.synthetic_blocks(2048, 6, block_size=64, seed=5)
    rp, ci = io.to_csr(src, dst, nn)
    perm = _ro.rcm_reorder(rp, ci, nn)
    rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    x = np.random.RandomState(0).randn(nn, 16).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    cfg = PlanConfig(band_mode="always", band_h=64, band_widths=(128, 256))
    op = DistHybridSpMM(rp, ci, nn, mesh, config=cfg, mode="band_halo")
    assert op.sharded.halo_pair == 256
    assert any(len(p.band_sw_ids[s]) > 0
               for p in op.sharded.plans
               for s in range(len(p.band_widths)))
    z = np.asarray(op(jax.device_put(op.pad(x), op.sharding)))[:nn]
    ref = spmm_reference_dense(rp, ci, nn, x)
    np.testing.assert_allclose(z, ref, rtol=1e-4, atol=1e-4)

    # gradient flows through the ppermutes
    import jax.numpy as jnp
    xs = jax.device_put(op.pad(x), op.sharding)
    g = jax.grad(lambda v: (op.apply(op.arrays, v) ** 2).sum())(jnp.asarray(xs))
    assert np.isfinite(np.asarray(g)).all()


def test_band_halo_strict_rejects_out_of_window_columns():
    """band_spill='never' keeps the strict boundary-strip contract."""
    import pytest

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.parallel.partition import build_sharded_plan

    # wide-span graph: shard rows reference far-away columns
    src, dst, nn = io.synthetic_graph(2048, 6, seed=0, span=2000)
    rp, ci = io.to_csr(src, dst, nn)
    with pytest.raises(ValueError, match="halo window"):
        build_sharded_plan(rp, ci, nn, 4,
                           PlanConfig(band_widths=(128,), band_h=64,
                                      band_spill="never"),
                           mode="band_halo")


def test_band_halo_far_edges_degrade_to_index_halo():
    """Out-of-strip edges (hubs / inter-community) no longer kill the
    band_halo mode: they ride an index-gather ppermute round into the
    spill population (degrade, don't raise)."""
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.format import reorder as _ro

    rng = np.random.RandomState(3)
    src, dst, nn = io.synthetic_blocks(2048, 6, block_size=64, seed=5)
    # sprinkle long-range edges crossing all shard boundaries
    far_s = rng.randint(0, nn, 64)
    far_d = (far_s + nn // 2) % nn
    src = np.concatenate([src, far_s, far_d])
    dst = np.concatenate([dst, far_d, far_s])
    rp, ci = io.to_csr(src, dst, nn)
    x = rng.randn(nn, 16).astype(np.float32)

    mesh = make_mesh(4)
    cfg = PlanConfig(band_mode="always", band_h=64,
                     band_widths=(128, 256), impl="triton")
    op = DistHybridSpMM(rp, ci, nn, mesh, config=cfg, mode="band_halo",
                        interpret=True)
    assert op.sharded.far_pair > 0
    assert op.sharded.num_spill_rows > 0
    z = np.asarray(op(jax.device_put(op.pad(x), op.sharding)))[:nn]
    ref = spmm_reference_dense(rp, ci, nn, x)
    np.testing.assert_allclose(z, ref, rtol=1e-4, atol=1e-4)

    # gradient flows through strips + gather rounds
    xs = jnp.asarray(jax.device_put(op.pad(x), op.sharding))
    g = jax.grad(lambda v: (op.apply(op.arrays, v) ** 2).sum())(xs)
    assert np.isfinite(np.asarray(g)).all()


import pytest


@pytest.mark.parametrize("mode", ["allgather", "band_halo", "halo"])
def test_dist_kernel_local_compute_matches_oracle(mode):
    """Shard-local compute through the Triton band kernel
    (impl='triton', interpreted here): the same shard_map program with
    pallas_call bodies per shard."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.format import reorder as _ro
    from hcspmm_tpu.ops.spmm import spmm_reference_dense
    from hcspmm_tpu.parallel.dist_spmm import DistHybridSpMM

    src, dst, nn = io.synthetic_blocks(1024, 6, block_size=100, seed=5)
    rp, ci = io.to_csr(src, dst, nn)
    perm = _ro.rcm_reorder(rp, ci, nn)
    rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    x = np.random.RandomState(0).randn(nn, 16).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    cfg = PlanConfig(band_mode="always", band_h=64,
                     band_widths=(128, 256), impl="triton")
    op = DistHybridSpMM(rp, ci, nn, mesh, config=cfg, mode=mode,
                        interpret=True)
    assert op.sharded.impl == "triton"
    z = np.asarray(op(jax.device_put(op.pad(x), op.sharding)))[:nn]
    ref = spmm_reference_dense(rp, ci, nn, x)
    np.testing.assert_allclose(z, ref, rtol=1e-4, atol=1e-4)


def test_dist_shard_uniform_fast_path_single_bucket():
    """All shards band-full-cover with one bucket: the shard_map trace
    consults only shard-uniform capacity shapes and merges the kernel's
    rows per shard."""
    from hcspmm_tpu.graphs import io
    from hcspmm_tpu.format import reorder as _ro

    src, dst, nn = io.synthetic_blocks(2048, 6, block_size=64, seed=5)
    rp, ci = io.to_csr(src, dst, nn)
    perm = _ro.rcm_reorder(rp, ci, nn)
    rp, ci = _ro.apply_permutation(rp, ci, nn, perm)
    x = np.random.RandomState(0).randn(nn, 16).astype(np.float32)

    mesh = make_mesh(4)
    cfg = PlanConfig(band_mode="always", band_h=64,
                     band_widths=(128, 256), impl="triton")
    op = DistHybridSpMM(rp, ci, nn, mesh, config=cfg, mode="band_halo",
                        interpret=True)
    assert all(p.band_full_cover for p in op.sharded.plans)
    z = np.asarray(op(jax.device_put(op.pad(x), op.sharding)))[:nn]
    ref = spmm_reference_dense(rp, ci, nn, x)
    np.testing.assert_allclose(z, ref, rtol=1e-4, atol=1e-4)


def test_dist_shard_uniform_fast_path_uneven_buckets_and_spill():
    """The hard shard-uniform case: shards resolve DIFFERENT band-width
    buckets ([8,0] vs [0,8] real counts under equal capacities), so every
    shard carries capacity-padded dummy supers in one bucket, plus a
    band+spill population.  Must still match the oracle through the
    multi-bucket merge path."""
    from hcspmm_tpu.graphs import io

    rng = np.random.RandomState(0)
    n = 2048
    parts = []
    for lo in range(0, 1024, 64):       # tight blocks -> 128-wide bucket
        m = 64
        parts.append((rng.randint(lo, lo + m, 6 * m),
                      rng.randint(lo, lo + m, 6 * m)))
    for lo in range(1024, 2048, 200):   # wide blocks -> 256-wide bucket
        m = min(200, 2048 - lo)
        parts.append((rng.randint(lo, lo + m, 6 * m),
                      rng.randint(lo, lo + m, 6 * m)))
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts])
    rp, ci = io.to_csr(rows, cols, n)
    x = rng.randn(n, 16).astype(np.float32)

    mesh = make_mesh(4)
    cfg = PlanConfig(band_mode="always", band_h=64,
                     band_widths=(128, 256), impl="triton")
    op = DistHybridSpMM(rp, ci, n, mesh, config=cfg, mode="allgather",
                        interpret=True)
    assert all(p.band_full_cover for p in op.sharded.plans)
    counts = [[len(s) for s in p.band_sw_ids] for p in op.sharded.plans]
    assert len({tuple(c) for c in counts}) > 1, (
        "fixture regressed: shards no longer resolve different buckets")
    z = np.asarray(op(jax.device_put(op.pad(x), op.sharding)))[:n]
    ref = spmm_reference_dense(rp, ci, n, x)
    np.testing.assert_allclose(z, ref, rtol=1e-4, atol=1e-4)
