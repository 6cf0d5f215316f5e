"""Limb arithmetic, bn256 tables and the audit's kernels with their plain
PyTorch versions."""
