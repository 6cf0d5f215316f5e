"""PyTorch and CUDA port of the notary's committee audit.

The JAX package `gethsharding_tpu` stays the reference; this package runs
the same committee audit (100 shards × 135 votes per period) on an NVIDIA
H100 through hand-written CUDA kernels in `csrc/`. It imports torch and
numpy, never jax, and nothing of `gethsharding_tpu`.
"""
