"""Training loop (reference: HC-SpMM_main.py:113-166).

Parity: Adam lr=0.01 (main.py:115), loss = NLL of log-softmax output
against the all-ones labels over every node (main.py:125 — train mask is
100% of nodes), 9 warm-up epochs then the timed epoch loop
(main.py:157-166); the reference never evaluates accuracy.

Differences: the whole step (forward, loss, backward, Adam) is
one jitted function, parameters are a pytree, dropout randomness is an
explicit key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from hcspmm_tpu.models.net import Net, init_net_params, net_forward
from hcspmm_tpu.utils.logging import MetricLogger


def nll_loss(log_probs: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """F.nll_loss equivalent: mean negative log-probability of the label."""
    return -jnp.take_along_axis(log_probs, labels[:, None], axis=1).mean()


@dataclasses.dataclass
class TrainState:
    params: List[Dict]
    opt_state: optax.OptState
    step: int = 0


def make_train_step(
    net: Net,
    spmm,
    optimizer: optax.GradientTransformation,
):
    """``spmm`` is a HybridSpMM-like op (has ``.arrays`` + ``.apply``) or a
    plain callable.  Plan arrays are threaded through the jit as arguments —
    closed-over device arrays would be serialized into the module as
    constants and cost minutes of compile at large-graph scale (see
    ops.spmm.make_spmm).
    """
    arrays = getattr(spmm, "arrays", None)

    class _Bound:
        """spmm closure carrying the threaded plan arrays."""

        def __init__(self, arrs):
            self._arrs = arrs

        def __call__(self, x):
            return spmm.apply(self._arrs, x)

        def mean(self, x):
            if hasattr(spmm, "mean_apply"):
                return spmm.mean_apply(self._arrs, x)
            return self(x)  # sum fallback for degree-less operators

    def make_bound(arrs):
        if arrays is None:
            return spmm  # plain callable
        return _Bound(arrs)

    def loss_fn(params, arrs, x, y, rng):
        logp = net_forward(net, params, make_bound(arrs), x,
                           dropout_rng=rng, train=True)
        return nll_loss(logp, y)

    @jax.jit
    def _step(params, opt_state, arrs, x, y, rng):
        loss, grads = jax.value_and_grad(loss_fn)(params, arrs, x, y, rng)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def train_step(params, opt_state, x, y, rng):
        return _step(params, opt_state, arrays, x, y, rng)

    train_step.step_with_arrays = _step
    train_step.loss_with_arrays = loss_fn  # forward-only (epoch fwd timing)
    train_step.arrays = arrays
    return train_step


def train(
    net: Net,
    spmm: Callable,
    x,
    y,
    epochs: int = 200,
    lr: float = 0.01,
    seed: int = 0,
    warmup_epochs: int = 9,
    logger: Optional[MetricLogger] = None,
    init_params: Optional[List[Dict]] = None,
    scan_chunk: int = 10,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    start_epoch: int = 0,
    fault_epoch: Optional[int] = None,
) -> Dict:
    """Runs warm-up + timed epochs; returns params and timing stats.
    ``init_params`` resumes from a checkpoint instead of fresh init.

    ``checkpoint_path`` + ``checkpoint_every > 0`` save the params every
    that many epochs (metadata carries the absolute epoch counter
    ``start_epoch + done``) — the persistence half of the elastic
    supervisor (train.elastic); each save syncs the device, so leave it
    off for timing runs.

    ``fault_epoch`` is the fault-injection hook (SURVEY.md §5): the loop
    raises RuntimeError once the absolute epoch counter passes it (after
    any due checkpoint save), simulating a worker crash so the elastic
    supervisor's detection + resume path can be exercised deterministically.

    ``scan_chunk > 1`` runs epochs in lax.scan chains of that length (one
    dispatch per chunk), so per-epoch host dispatch never sits between
    epochs on the device.  ``scan_chunk=1`` restores the
    reference's literal epoch-per-call loop (HC-SpMM_main.py:157-166)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    params = init_params if init_params is not None else init_net_params(net, init_rng)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)
    step = make_train_step(net, spmm, optimizer)
    arrays = step.arrays
    inner = step.step_with_arrays
    if logger is not None:
        # the starting point of the loss curve, before any update
        loss0 = jax.jit(step.loss_with_arrays)(params, arrays, x, y, rng)
        logger.log(event="init", loss=float(loss0))

    import functools

    @functools.partial(jax.jit, static_argnums=(0,))
    def run_chunk(n, params, opt_state, arrs, x, y, rng):
        def body(carry, _):
            params, opt_state, rng = carry
            rng, sub = jax.random.split(rng)
            params, opt_state, loss = inner(params, opt_state, arrs, x, y, sub)
            return (params, opt_state, rng), loss

        (params, opt_state, rng), losses = jax.lax.scan(
            body, (params, opt_state, rng), None, length=n
        )
        return params, opt_state, rng, losses

    scan_chunk = max(1, min(scan_chunk, max(epochs, 1)))

    # Exactly two compiled programs regardless of epoch counts (every
    # distinct scan length is a separate XLA program): full chunks of ``scan_chunk`` via
    # run_chunk, everything else (warm-up epochs, the tail) through the
    # per-epoch step.
    def run_epochs(n, params, opt_state, rng, collect=None):
        done = 0
        while done < n:
            if scan_chunk > 1 and n - done >= scan_chunk:
                params, opt_state, rng, losses_c = run_chunk(
                    scan_chunk, params, opt_state, arrays, x, y, rng
                )
                last, c = losses_c[-1], scan_chunk
            else:
                rng, sub = jax.random.split(rng)
                params, opt_state, last = step(params, opt_state, x, y, sub)
                losses_c, c = [last], 1
            done += c
            if collect is not None:
                collect.append(last)
                if logger is not None:
                    # every epoch's loss (one host transfer per chunk)
                    for i, v in enumerate(np.asarray(losses_c)):
                        logger.log(epoch=done - c + i, loss=float(v))
                if (checkpoint_path and checkpoint_every > 0
                        and (done // checkpoint_every
                             > (done - c) // checkpoint_every)):
                    from hcspmm_tpu.utils.checkpoint import save_pytree

                    save_pytree(checkpoint_path, params, {
                        "epoch": start_epoch + done,
                        "loss": float(last),
                    })
                if fault_epoch is not None and start_epoch + done >= fault_epoch:
                    raise RuntimeError(
                        f"injected fault at epoch {start_epoch + done}")
        return params, opt_state, rng

    # Dry-run epochs (main.py:157-159) double as jit warm-up; one extra
    # chunk warms the scan program so no compile lands in the timed loop.
    params, opt_state, rng = run_epochs(warmup_epochs, params, opt_state, rng)
    if scan_chunk > 1 and epochs >= scan_chunk:
        params, opt_state, rng, _ = run_chunk(
            scan_chunk, params, opt_state, arrays, x, y, rng
        )
    jax.block_until_ready(params)

    start = time.perf_counter()
    losses: List = []
    params, opt_state, rng = run_epochs(epochs, params, opt_state, rng,
                                        collect=losses)
    jax.block_until_ready(params)
    total = time.perf_counter() - start

    return {
        "params": params,
        "final_loss": float(losses[-1]) if losses else float("nan"),
        "epoch_ms": total * 1e3 / max(epochs, 1),
        "total_s": total,
    }
