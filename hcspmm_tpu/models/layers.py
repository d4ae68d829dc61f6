"""GCN / GIN convolution layers (reference: GNN_model.py:264-302).

Parity notes:
- weights are raw standard-normal parameters; the reference defines
  ``reset_parameters`` (uniform +-1/sqrt(fan_out)) but never calls it
  (GNN_model.py:267-268), so ``init='randn'`` is the default and
  ``init='glorot'`` is the sane extension;
- each layer carries a ``fixed`` strategy in {0: hidden, 1: first,
  2: final} selecting the kernel combo (GNN_model.py:277-282).  Here the
  strategies map to the same two op orders (ops.fused); the surface is
  kept so models and benchmarks mirror the reference layer-for-layer.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

from hcspmm_tpu.ops import fused

FIXED_HIDDEN, FIXED_FIRST, FIXED_FINAL = 0, 1, 2


def init_conv_params(
    rng: jax.Array, input_dim: int, output_dim: int, init: str = "randn"
) -> Dict[str, jnp.ndarray]:
    if init == "randn":
        w = jax.random.normal(rng, (input_dim, output_dim), dtype=jnp.float32)
    elif init == "glorot":
        scale = jnp.sqrt(2.0 / (input_dim + output_dim))
        w = scale * jax.random.normal(rng, (input_dim, output_dim), dtype=jnp.float32)
    else:
        raise ValueError(f"unknown init: {init}")
    return {"weights": w}


class GCNConv:
    """Update-then-aggregate: Z = A (X W) for every ``fixed`` strategy
    (the strategies differ only in which fused kernel the reference picks,
    GNN_model.py:82-162)."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: jnp.ndarray) -> jnp.ndarray:
        return fused.update_then_aggregate(spmm, x, params["weights"])


class GINConv:
    """Aggregate-then-update: Z = (A X) W (GNN_model.py:166-233)."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: jnp.ndarray) -> jnp.ndarray:
        return fused.aggregate_then_update(spmm, x, params["weights"])


def init_sage_params(
    rng: jax.Array, input_dim: int, output_dim: int, init: str = "randn"
) -> dict:
    k1, k2 = jax.random.split(rng)
    return {
        "w_self": init_conv_params(k1, input_dim, output_dim, init)["weights"],
        "w_neigh": init_conv_params(k2, input_dim, output_dim, init)["weights"],
    }


class SAGEConv:
    """GraphSAGE-mean layer (extension; no reference equivalent):
    ``Z = X W_self + mean_N(X) W_neigh`` with ``mean_N = D^-1 A X``
    through the same hybrid SpMM kernels.  When the bound operator
    exposes no degree information (plain callables in oracle tests),
    falls back to the unweighted sum the reference's kernels compute."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: jnp.ndarray) -> jnp.ndarray:
        if hasattr(spmm, "mean"):
            agg = spmm.mean(x)
        else:
            agg = spmm(x)
        hs = jnp.dot(x, params["w_self"].astype(x.dtype),
                     preferred_element_type=jnp.float32)
        hn = jnp.dot(agg, params["w_neigh"].astype(x.dtype),
                     preferred_element_type=jnp.float32)
        return (hs + hn).astype(x.dtype)
