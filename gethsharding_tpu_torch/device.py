"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card, and raises where there is none; the
    CPU (the plain versions of the kernels) only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                               "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)
