"""Which version of a kernel runs: the route follows the tensor's device.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
its plain PyTorch version, any other device raises. Inside
`plain_versions()` every kernel's plain version runs on any device: that
is the reference route `chip_smoke.py` and the card tests hold the
kernels against. There is no fallback: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_FORCE_PLAIN = contextvars.ContextVar("force_plain", default=False)


def use_kernel(t: torch.Tensor) -> bool:
    """True where `t` goes through a kernel: a CUDA tensor outside
    `plain_versions()`."""
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"unsupported device {t.device}")
    return not _FORCE_PLAIN.get()


@contextlib.contextmanager
def plain_versions():
    """Run the plain versions of every kernel inside the block."""
    token = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(token)
