"""SAG — the standalone aggregation profiler (GNN_model.py:236-262).

The reference runs 200 rounds of the dim-32 fixed kernel through a
throwaway autograd function and prints the average milliseconds; this is
the harness behind the paper's single-kernel numbers (Fig. 10/Table XVI).
Here the rounds are timed in warm windows on the host clock, each window
ending in ``block_until_ready`` (the stand-in for
``torch.cuda.synchronize``), and the median window is reported.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

from hcspmm_tpu.utils.profiling import time_windows


class SAG:
    def __init__(self, spmm: Callable):
        self.spmm = spmm

    def profile(self, x: jnp.ndarray, num_rounds: int = 200,
                windows: int = 5) -> Dict:
        """Median milliseconds per aggregation over ``windows`` windows of
        ``num_rounds // windows`` calls."""
        x = jnp.asarray(x)
        arrays = getattr(self.spmm, "arrays", None)
        if arrays is not None:
            # plan arrays as jit ARGUMENTS: jitting __call__ would bake
            # them in as closure constants (minutes of compile at scale —
            # ops.spmm.make_spmm)
            fn = jax.jit(lambda a, v: self.spmm.apply(a, v))
            args = (arrays, x)
        else:
            fn = jax.jit(self.spmm)
            args = (x,)
        avg_ms = time_windows(fn, *args, calls=max(num_rounds // windows, 1),
                              windows=windows) * 1e3
        out = fn(*args)
        print("=> SAG profiling avg (ms): {:.3f}".format(avg_ms))
        return {"avg_ms": avg_ms, "rounds": num_rounds, "out": out}
