"""GCN / GIN networks (reference: the ``Net`` classes in
HC-SpMM_main.py:66-110).

Topology parity: first layer (fixed=1) -> ReLU -> dropout ->
(num_layers - 2) hidden layers (fixed=0) each followed by ReLU ->
final layer (fixed=2) -> log_softmax.  Dropout uses the torch default
p=0.5 (F.dropout, HC-SpMM_main.py:82).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

from hcspmm_tpu.models.layers import (
    FIXED_FINAL,
    FIXED_FIRST,
    FIXED_HIDDEN,
    GCNConv,
    GINConv,
    SAGEConv,
    init_conv_params,
    init_sage_params,
)


@dataclasses.dataclass
class Net:
    """Static network description; parameters live in a separate pytree."""

    model: str          # 'gcn' | 'gin' | 'sage'
    num_features: int
    hidden: int
    num_classes: int
    num_layers: int
    dropout: float = 0.5

    def layer_dims(self) -> List:
        dims = [(self.num_features, self.hidden, FIXED_FIRST)]
        for _ in range(self.num_layers - 2):
            dims.append((self.hidden, self.hidden, FIXED_HIDDEN))
        dims.append((self.hidden, self.num_classes, FIXED_FINAL))
        return dims

    def conv(self, fixed: int):
        if self.model == "gcn":
            return GCNConv(fixed)
        if self.model == "sage":
            return SAGEConv(fixed)
        return GINConv(fixed)


def init_net_params(net: Net, rng: jax.Array, init: str = "randn") -> List[Dict]:
    keys = jax.random.split(rng, len(net.layer_dims()))
    make = init_sage_params if net.model == "sage" else init_conv_params
    return [
        make(k, din, dout, init)
        for k, (din, dout, _) in zip(keys, net.layer_dims())
    ]


def net_forward(
    net: Net,
    params: List[Dict],
    spmm: Callable,
    x: jnp.ndarray,
    dropout_rng: Optional[jax.Array] = None,
    train: bool = False,
) -> jnp.ndarray:
    """Returns log-probabilities [N, classes] (F.log_softmax, main.py:87)."""
    dims = net.layer_dims()
    h = x
    for i, (_, _, fixed) in enumerate(dims):
        conv = net.conv(fixed)
        h = conv(params[i], spmm, h)
        if fixed != FIXED_FINAL:
            h = jax.nn.relu(h)
        if fixed == FIXED_FIRST and train and net.dropout > 0:
            if dropout_rng is None:
                raise ValueError("train=True requires dropout_rng")
            keep = 1.0 - net.dropout
            mask = jax.random.bernoulli(dropout_rng, keep, h.shape)
            h = jnp.where(mask, h / keep, 0.0)
    return jax.nn.log_softmax(h, axis=-1)
