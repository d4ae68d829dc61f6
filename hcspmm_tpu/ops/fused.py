"""Layer-strategy ops mirroring the reference's eight autograd functions
(GNN_model.py:26-233).

On GPU the reference ships separate *fused* kernels (aggregate kept in
shared memory, the update GEMM applied before writeback —
hybrid_all_kernel.cu:1639-2770) because unfused launches round-trip HBM.
Under XLA the same fusion falls out of jit: both ops below trace the
aggregate and the update into one compiled program and XLA fuses the
element-wise glue, while the custom VJP of ``spmm`` reproduces the exact
gradient dataflow of the reference:

- ``update_then_aggregate`` (GCN order, HCSPMMFunction{First,Fixed32,Final}):
    fwd:  Z = A @ (X W)
    bwd:  dXW = A @ dZ (untransposed A, symmetric assumption);
          dX = dXW W^T;  dW = X^T dXW          (GNN_model.py:94-103,116-127)
- ``aggregate_then_update`` (GIN order, HCSPMMFunction_GIN*):
    fwd:  Z = (A @ X) W, aggregate saved as the residual
          (the fused kernels return it as ``output2``, .cu:833-837)
    bwd:  dAX = dZ W^T; dW = (A X)^T dZ; dX = A @ dAX

The three-way per-layer strategy (``fixed`` in {0: hidden, 1: first,
2: final}, GNN_model.py:275-282) is kept as an API surface in
``models.layers``; numerically all three reduce to these two orders.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp


def aggregate(spmm: Callable, x: jnp.ndarray) -> jnp.ndarray:
    """Pure aggregation Z = A @ X (the SAG op, GNN_model.py:26-57)."""
    return spmm(x)


def update_then_aggregate(spmm: Callable, x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """GCN layer core: A @ (X W).  Autodiff through the SpMM's custom VJP
    yields the reference's backward dataflow as separate ops (a fused
    aggregation + update kernel, reference Table VI, is not written for
    this card yet)."""
    return spmm(jnp.dot(x, w, preferred_element_type=jnp.float32).astype(x.dtype))


def aggregate_then_update(spmm: Callable, x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """GIN layer core: (A @ X) W with the aggregate as the saved residual,
    matching HCSPMMFunction_GINFixed32 (GNN_model.py:166-184): the weight
    gradient is formed against A@X, and dX flows through one aggregation.
    """
    ax = spmm(x)
    return jnp.dot(ax, w, preferred_element_type=jnp.float32).astype(x.dtype)


def fused_aggregate_update(
    spmm: Callable, x: jnp.ndarray, w: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns ((A X) W, A X) — the reference fused-kernel contract
    (``output``, ``output2``), e.g. forward_fixed32_fused
    (hybrid_all.cpp:281-335; .cu:1639-1848)."""
    ax = spmm(x)
    return jnp.dot(ax, w, preferred_element_type=jnp.float32).astype(x.dtype), ax
