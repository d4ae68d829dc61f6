"""Tests that need the card: the band kernel as compiled for the GPU (no
interpreter) against NumPy, and the default implementation choice.

Marked ``gpu``; they skip elsewhere (the ``gpu`` fixture decides at run
time).  ``python chip_smoke.py`` runs them in its own process on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig
from hcspmm_tpu.kernels.band import band_spmm
from hcspmm_tpu.ops.spmm import HybridSpMM, spmm_reference_dense

from conftest import small_graph

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [7, 32, 96, 130])
def test_band_kernel_compiled_matches_numpy(gpu, dtype, packed, d):
    rng = np.random.RandomState(d)
    sb, bh, w, r = 6, 256, 320, 900
    a = (rng.rand(sb, bh, w) < 0.05).astype(np.int8)
    av = (np.packbits(a.view(np.uint8), axis=1, bitorder="little")
          if packed else a)
    starts = rng.randint(0, r, sb).astype(np.int32)
    sw = rng.permutation(sb).astype(np.int32)
    x = jnp.asarray(rng.randn(r, d).astype(np.float32)).astype(dtype)
    out = jax.jit(lambda s_, w_, a_, x_: band_spmm(
        s_, w_, a_, x_, sb, jnp.float32))(
        jnp.asarray(starts), jnp.asarray(sw), jnp.asarray(av), x)
    xs = np.concatenate([np.asarray(x.astype(jnp.float32), np.float64),
                         np.zeros((w, d))])
    ref = np.zeros((sb * bh, d))
    for i in range(sb):
        ref[sw[i] * bh:(sw[i] + 1) * bh] = a[i] @ xs[starts[i]:starts[i] + w]
    rel = np.linalg.norm(np.asarray(out) - ref) / np.linalg.norm(ref)
    # bf16 inputs are exact in ref (x rounded first); the sum is float32
    assert rel < 1e-5, rel


def test_auto_impl_is_kernel_on_gpu(gpu):
    rp, ci, nn = small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, PlanConfig())
    assert op.impl == "triton"
    x = np.random.RandomState(0).randn(nn, 24).astype(np.float32)
    z = np.asarray(jax.jit(lambda a, v: op.apply(a, v))(op.arrays, x))
    zref = spmm_reference_dense(rp, ci, nn, x)
    assert np.linalg.norm(z - zref) / np.linalg.norm(zref) < 1e-5
