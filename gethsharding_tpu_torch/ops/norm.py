"""`ModArith.normalize` as a CUDA kernel, with its plain PyTorch version.

The port's counterpart of the JAX package's `ops/pallas_norm.py`, in the
wide form: three relaxed carry rounds into W + 3 limbs, the fold of limbs
>= 22 through the (33, 22) rows 2^(12(22+k)) mod p, + lift, and one exact
carry into 25 canonical limbs. `normalize` is the route
(`ops/route.py`): `csrc/norm.cu` for a CUDA tensor, `normalize_plain` for
a CPU tensor. Its device code (`csrc/norm.cuh`) also runs inside the
tower kernel (`ops/tower.py`), for every normalize of a tower product. Both give the same limbs, so the reference's own
`ModArith.normalize` is the oracle of either.

The TPU kernel's exact 22-limb branch (`pallas_norm.py:83-91`) belongs to
the exact limb form, which the port does not have yet.
"""

from __future__ import annotations

import torch

from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.limb import (FOLD_BASE, FOLD_ROWS, NLIMBS,
                                             _relax, carry, const, pad_last)

# the widest accumulator one fold absorbs: the relaxed rounds add 3 limbs
MAX_WIDTH = FOLD_BASE + FOLD_ROWS - 3

KERNEL = _build.Kernel("norm", "gs_norm",
                       "gethsharding_tpu_torch/csrc/norm.cu",
                       "gethsharding_tpu/ops/pallas_norm.py:104")


def normalize_plain(arith, z: torch.Tensor) -> torch.Tensor:
    """Reduce an accumulator (..., W), |limb| < 2^30.7 and value >= 0,
    to 25 canonical limbs, value < 2^273, same residue mod `arith.p`."""
    z = _relax(_relax(_relax(z)))
    hi = z[..., FOLD_BASE:]
    fold = const(arith.fold_j, z.device)[: hi.shape[-1]]
    folded = (hi.unsqueeze(-1) * fold).sum(dim=-2, dtype=torch.int32)
    z = z[..., :FOLD_BASE] + folded + const(arith.lift, z.device)
    return carry(pad_last(z, NLIMBS))[1]


def normalize_kernel(arith, z: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/norm.cu` on z (n, W) int32, W <= 52; returns (n, 25),
    equal to `normalize_plain` limb for limb."""
    n, w = z.shape
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"accumulator width {w} outside 1..{MAX_WIDTH}")
    _build.check_tensor(z, (n, w), "z")
    out = torch.empty((n, NLIMBS), dtype=torch.int32, device=z.device)
    if n == 0:
        return out
    KERNEL.launch(_build.ptr(z), n, w,
                  _build.ptr(const(arith.fold_j, z.device)),
                  _build.ptr(const(arith.lift, z.device)), _build.ptr(out))
    return out


def normalize(arith, z: torch.Tensor) -> torch.Tensor:
    """`ModArith.normalize` on (..., W): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if z.shape[-1] > MAX_WIDTH:
        raise ValueError(f"accumulator too wide: {z.shape[-1]} limbs")
    if not route.use_kernel(z):
        return normalize_plain(arith, z)
    lead = z.shape[:-1]
    flat = z.reshape(-1, z.shape[-1]).to(torch.int32).contiguous()
    return normalize_kernel(arith, flat).reshape(lead + (NLIMBS,))
