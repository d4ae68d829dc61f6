"""Band SpMM kernel for NVIDIA GPUs: Pallas through Triton.

The band population (format.plan) holds, per superwindow of ``band_h``
consecutive rows, one binary block ``A[band_h, W]`` against the
contiguous X slice ``X[start : start + W]``.  The plain version
(ops.spmm._band_path_xla) materialises three arrays per application: A
converted to the compute dtype, the gathered ``[Sb, W, D]`` X slab, and a
full-size output permutation.  This kernel avoids all three, in the
manner of the reference's tensor-core path (hybrid_all_kernel.cu:1385-1472,
one window per block, each window writing its own output rows):

- A arrives bit-packed along its rows (uint8 ``[Sb, band_h/8, W]``, bit i
  of byte r = row 8r+i), 8x fewer bytes than int8 — at DD scale the A
  stream is most of what the band path reads; int8 ``[Sb, band_h, W]`` is
  taken as well;
- grid over (band entry, ``bm``-row block of its superwindow);
- a loop over the band width in ``bk``-column chunks: the A chunk is
  unpacked and converted in registers, the X chunk is read at
  ``start + k``, and ``pl.dot`` accumulates in float32 on the tensor
  cores (bf16) or in IEEE float32 (no TF32) for float32 inputs;
- the result is stored straight into the superwindow's own output rows
  (``sw[i] * band_h``), so a full-cover plan needs no merge pass.

Feature widths that are not a power of two are handled by loading a
power-of-two column block with a mask, so X is never copied to pad it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hcspmm_tpu.config import BAND_BLOCK


def _pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def _block(extent: int, cap: int = BAND_BLOCK) -> int:
    """Largest power of two <= ``cap`` dividing ``extent``: every A chunk
    is then a full tile.  The tensor cores need 16."""
    b = cap
    while b > 16 and extent % b:
        b //= 2
    if extent % b:
        raise ValueError(f"band block extent {extent} is not a multiple of 16")
    return b


def _tuning(d: int, dtype):
    """(row block cap, column block cap, warps, pipeline stages), from a
    sweep at DD scale (band_h 256, width 576, bit-packed A) on an H100
    80GB HBM3 whose power limit that run did not record; see PERF.md.
    float32 products run on the CUDA cores
    (no TF32), where small tiles keep the accumulator in registers."""
    if dtype == jnp.float32:
        return 32, 32, 4, 2
    if d <= 64:
        return 64, 64, 4, 4
    return 128, 64, 8, 3


def _kernel(starts_ref, sw_ref, a_ref, x_ref, o_ref, *, band_h, width, bm,
            bk, num_rows, d, precision, packed):
    i = pl.program_id(0)
    j = pl.program_id(1)
    start = starts_ref[i]
    dp = o_ref.shape[1]
    col_ok = (jnp.arange(dp) < d)[None, :]
    r0 = j * bm

    def body(k, acc):
        if packed:
            # bit i of byte (r, c) is A[8r + i, c]: expand in registers
            ab = a_ref[0, pl.ds(r0 // 8, bm // 8), pl.ds(k * bk, bk)]
            sh = jnp.arange(8, dtype=jnp.uint8)[None, :, None]
            a = ((ab[:, None, :] >> sh) & 1).reshape(bm, bk)
        else:
            a = a_ref[0, pl.ds(r0, bm), pl.ds(k * bk, bk)]
        rows = start + k * bk + jnp.arange(bk)
        x = plgpu.load(x_ref.at[pl.ds(start + k * bk, bk), :],
                       mask=(rows < num_rows)[:, None] & col_ok, other=0)
        return acc + pl.dot(a.astype(x.dtype), x, precision=precision)

    acc = jax.lax.fori_loop(0, width // bk, body,
                            jnp.zeros((bm, dp), jnp.float32))
    row = sw_ref[i] * band_h + r0
    plgpu.store(o_ref.at[pl.ds(row, bm), :], acc.astype(o_ref.dtype),
                mask=jnp.broadcast_to(col_ok, (bm, dp)))


def band_spmm(starts, sw, a, x, num_blocks: int, out_dtype, *,
              interpret: bool = False):
    """``out[sw[i]*bh : (sw[i]+1)*bh] = a[i] @ x[starts[i] : starts[i]+W]``.

    starts, sw: int32 [Sb]; a: binary int8 [Sb, bh, W], or uint8
    [Sb, bh/8, W] bit-packed along rows; x: [R, d] in the compute dtype
    (rows past R read as zero).  Returns
    ``[num_blocks * bh, d]`` in ``out_dtype``; blocks that no entry names
    are left unwritten, so callers either own every block (full cover) or
    pass ``sw = arange(Sb)``.
    """
    packed = a.dtype == jnp.uint8
    sb, bh, width = a.shape
    if packed:
        bh *= 8
    r, d = x.shape
    bm_cap, bk_cap, num_warps, num_stages = _tuning(d, x.dtype)
    bm, bk = _block(bh, bm_cap), _block(width, bk_cap)
    dp = max(16, _pow2(d))
    precision = (jax.lax.Precision.HIGHEST if x.dtype == jnp.float32
                 else jax.lax.Precision.DEFAULT)
    kernel = functools.partial(_kernel, band_h=bh, width=width, bm=bm, bk=bk,
                               num_rows=r, d=d, precision=precision,
                               packed=packed)
    return pl.pallas_call(
        kernel,
        grid=(sb, bh // bm),
        in_specs=[
            pl.BlockSpec((sb,), lambda i, j: (0,)),
            pl.BlockSpec((sb,), lambda i, j: (0,)),
            pl.BlockSpec((1,) + a.shape[1:], lambda i, j: (i, 0, 0)),
            pl.BlockSpec((r, dp), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((num_blocks * bh, dp), lambda i, j: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((num_blocks * bh, d), out_dtype),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="band_spmm",
    )(starts, sw, a, x)
