"""`ModArith.normalize` as a CUDA kernel, with its plain PyTorch version.

The port's counterpart of the JAX package's `ops/pallas_norm.py`, in both
of its lazy forms (`limb.LIMB_FORM`):

- wide: three relaxed carry rounds into W + 3 limbs, the fold of limbs
  >= 22 through the (33, 22) rows 2^(12(22+k)) mod p, + lift, and one
  exact carry into 25 canonical limbs;
- exact (the TPU kernel's branch at `pallas_norm.py:83-91`, equal to the
  reference's XLA ladder at `limb.py:525-533`): three relaxed rounds into
  W + 3 limbs and a fold; three relaxed rounds on 3 more zero limbs and a
  fold; an exact carry into 24 limbs and a fold; an exact carry into 23
  limbs and a fold; an exact carry into the 22 output limbs. No lift: a
  relaxed round can leave a limb at -1, and the arithmetic shifts carry
  it as a borrow, as they do there.

`normalize` is the route (`ops/route.py`): `csrc/norm.cu` for a CUDA
tensor, `normalize_plain` for a CPU tensor, both in the form the module
was imported with. Its device code (`csrc/norm.cuh`) also runs inside the
tower kernel (`ops/tower.py`), in the wide form, for every normalize of a
tower product. Both give the same limbs, so the reference's own
`ModArith.normalize` is the oracle of either.
"""

from __future__ import annotations

import torch

from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.limb import (FOLD_BASE, FOLD_ROWS, LIMB_FORM,
                                             NLIMBS, _relax, carry, const,
                                             pad_last)

# the widest accumulator one fold absorbs: the relaxed rounds add 3 limbs
MAX_WIDTH = FOLD_BASE + FOLD_ROWS - 3
# output limbs and the kernel's form argument (csrc/norm.cuh NormForm)
OUT_LIMBS = {"wide": 25, "exact": 22}
_FORM_ARG = {"wide": 0, "exact": 1}

if LIMB_FORM == "exact":
    KERNEL = _build.Kernel("norm_exact", "gs_norm",
                           "gethsharding_tpu_torch/csrc/norm.cu",
                           "gethsharding_tpu/ops/pallas_norm.py:83")
else:
    KERNEL = _build.Kernel("norm", "gs_norm",
                           "gethsharding_tpu_torch/csrc/norm.cu",
                           "gethsharding_tpu/ops/pallas_norm.py:104")


def _fold(arith, z: torch.Tensor) -> torch.Tensor:
    """Limbs >= 22 folded through the 2^(12(22+k)) mod p rows onto the 22
    below; a row with no such limbs stays as it is."""
    hi = z[..., FOLD_BASE:]
    if hi.shape[-1] == 0:
        return z
    fold = const(arith.fold_j, z.device)[: hi.shape[-1]]
    return z[..., :FOLD_BASE] + (hi.unsqueeze(-1) * fold).sum(
        dim=-2, dtype=torch.int32)


def _relax3(z: torch.Tensor) -> torch.Tensor:
    return _relax(_relax(_relax(z)))


def normalize_plain(arith, z: torch.Tensor,
                    form: str = LIMB_FORM) -> torch.Tensor:
    """Reduce an accumulator (..., W), |limb| < 2^30.7 and value >= 0,
    to the lazy form `form`: 25 canonical limbs and value < 2^273 (wide),
    22 and value < 2^264 (exact), same residue mod `arith.p`."""
    if form == "wide":
        z = _fold(arith, _relax3(z)) + const(arith.lift, z.device)
        return carry(pad_last(z, 25))[1]
    z = _fold(arith, _relax3(z))
    z = _fold(arith, _relax3(z))
    z = _fold(arith, carry(pad_last(z, FOLD_BASE + 2))[1])
    z = _fold(arith, carry(pad_last(z, FOLD_BASE + 1))[1])
    return carry(pad_last(z, 22))[1]


def normalize_kernel(arith, z: torch.Tensor,
                     form: str = LIMB_FORM) -> torch.Tensor:
    """Launch `csrc/norm.cu` on z (n, W) int32, W <= 52, in the lazy form
    `form`; returns (n, 25) or (n, 22), equal to `normalize_plain` limb
    for limb."""
    n, w = z.shape
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"accumulator width {w} outside 1..{MAX_WIDTH}")
    _build.check_tensor(z, (n, w), "z")
    out = torch.empty((n, OUT_LIMBS[form]), dtype=torch.int32,
                      device=z.device)
    if n == 0:
        return out
    KERNEL.launch(_build.ptr(z), n, w, _FORM_ARG[form],
                  _build.ptr(const(arith.fold_j, z.device)),
                  _build.ptr(const(arith.lift, z.device)), _build.ptr(out))
    return out


def normalize(arith, z: torch.Tensor) -> torch.Tensor:
    """`ModArith.normalize` on (..., W) into NLIMBS limbs: the kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if z.shape[-1] > MAX_WIDTH:
        raise ValueError(f"accumulator too wide: {z.shape[-1]} limbs")
    if not route.use_kernel(z):
        return normalize_plain(arith, z)
    lead = z.shape[:-1]
    flat = z.reshape(-1, z.shape[-1]).to(torch.int32).contiguous()
    return normalize_kernel(arith, flat).reshape(lead + (NLIMBS,))
