"""hcspmm_tpu — a hybrid sparse-matrix-matrix-multiplication (SpMM)
framework for GNN aggregation on NVIDIA GPUs, with the capabilities of
HC-SpMM (ZJU-DAILY/HC-SpMM, arXiv 2412.08902).  The package name records
that it was first built for a TPU.

Architecture:

- ``graphs``   : graph loading (txt/npz/synthetic), CSR building, datasets.
- ``format``   : host-side window analysis (the equivalent of the reference's
                 GPU ``preprocess``, hybrid_all_kernel.cu:213-408), the LOI
                 row-window selector, layout reordering, and the execution
                 plan (band blocks, dense width buckets, ELL rows, spill).
- ``ops``      : differentiable hybrid SpMM (``jax.custom_vjp``) and the
                 layer strategies mirroring the reference's eight autograd
                 functions (GNN_model.py:26-233).
- ``kernels``  : the Pallas/Triton band kernel for the hot path.
- ``models``   : GCN / GIN layers and networks (HC-SpMM_main.py:66-110).
- ``train``    : training loop + CLI with the reference's flag surface.
- ``parallel`` : multi-device row-partitioned SpMM with halo exchange over a
                 ``jax.sharding.Mesh`` (net-new; the reference is single-GPU).
- ``native``   : C++ preprocessing and LOA reordering (LOI.cpp equivalent).
- ``utils``    : logging, profiling/roofline, checkpointing.
"""

__version__ = "0.1.0"

from hcspmm_tpu.utils import arena as _arena

_arena.tune()  # keep the host arena warm (lazy-paged VM; see utils/arena.py)

from hcspmm_tpu.config import BLK_H, BLK_W, HCSpMMConfig  # noqa: F401
