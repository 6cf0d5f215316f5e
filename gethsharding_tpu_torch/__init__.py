"""PyTorch and CUDA port of the sharding system's device paths.

The JAX package `gethsharding_tpu` stays the reference; this package runs
the same work on an NVIDIA H100 through hand-written CUDA kernels in
`csrc/`: the notary's committee audit (100 shards × 135 votes per
period), its vote phase and DAS checks, the collation replay and the
fused period step of the stress configuration. It imports torch and
numpy, never jax, and nothing of `gethsharding_tpu`.
"""
