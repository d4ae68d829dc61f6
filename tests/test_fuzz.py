"""Config/graph fuzz: random graphs x random plan configs vs the dense
oracle (the band kernel through the Pallas interpreter).  Catches population-routing edge cases the
hand-written shape tests miss."""

import jax
import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.graphs import io
from hcspmm_tpu.ops.spmm import HybridSpMM, spmm_reference_dense


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_random_config_matches_oracle(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(20, 400))
    deg = float(rng.uniform(0.5, 12))
    style = rng.choice(["blocks", "span"])
    if style == "blocks":
        src, dst, nn = io.synthetic_blocks(
            n, deg, int(rng.randint(8, 64)), seed=seed)
    else:
        src, dst, nn = io.synthetic_graph(
            n, deg, seed=seed, span=int(rng.randint(4, 128)))
    rp, ci = io.to_csr(src, dst, nn)
    if rng.rand() < 0.5:
        from hcspmm_tpu.format import reorder as _ro

        perm = _ro.rcm_reorder(rp, ci, nn)
        rp, ci = _ro.apply_permutation(rp, ci, nn, perm)

    wh = 16
    bh = wh * int(rng.randint(1, 5))
    widths_pool = [(128,), (128, 256), (256,), "auto"]
    cfg = PlanConfig(
        impl=rng.choice(["triton", "xla"]),
        loi_mode=rng.choice(["intended", "degenerate", "all_dense",
                             "all_sparse"]),
        band_mode=rng.choice(["auto", "always", "never"]),
        band_h=bh,
        band_widths=widths_pool[rng.randint(len(widths_pool))],
        band_spill=rng.choice(["auto", "never"]),
        bucket_widths=(8, 32, 128),
        ell_widths=(4, 16, 64),
        compute_dtype="float32",
    )
    dim = int(rng.randint(1, 70))
    x = rng.randn(nn, dim).astype(np.float32)
    op = HybridSpMM(rp, ci, nn, cfg, interpret=cfg.impl == "triton")
    z = np.asarray(jax.jit(op)(x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    scale = np.abs(zref).max() + 1e-9
    err = np.abs(z - zref).max() / scale
    assert err < 5e-4, (err, cfg)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_band_spill_kernel_path(seed):
    """Spill fuzz: random long-span graphs under a narrow band so much
    of the mass spills, random dims and dtypes, kernel path vs the dense
    oracle."""
    rng = np.random.RandomState(100 + seed)
    n = int(rng.randint(600, 1800))
    src, dst, nn = io.synthetic_graph(
        n, float(rng.uniform(4, 10)), seed=seed,
        span=int(rng.randint(300, max(301, n))))
    rp, ci = io.to_csr(src, dst, nn)
    dtype = str(rng.choice(["float32", "bfloat16"]))
    cfg = PlanConfig(
        impl="triton", band_mode=str(rng.choice(["auto", "always"])),
        band_h=int(rng.choice([64, 128])),
        band_widths=(int(rng.choice([64, 128, 192])),),
        compute_dtype=dtype,
    )
    dim = int(rng.randint(3, 40))
    x = rng.randn(nn, dim).astype(np.float32)
    op = HybridSpMM(rp, ci, nn, cfg, interpret=True)
    assert op.plan.spill_nnz > 0
    z = np.asarray(jax.jit(op)(x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    err = np.linalg.norm(z - zref) / np.linalg.norm(zref)
    assert err < (1e-5 if dtype == "float32" else 1e-2), (err, cfg)
