"""Hand-written kernels for the hybrid SpMM hot path (Pallas through
Triton, for NVIDIA GPUs)."""
