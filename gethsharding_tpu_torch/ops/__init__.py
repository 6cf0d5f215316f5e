"""Limb arithmetic, the bn256 tower, and the kernels with their plain
PyTorch versions: the audit's (`megakernels.py`) and the tower's
(`conv.py`, `norm.py`), routed by `route.py`, built by `_build.py`."""
