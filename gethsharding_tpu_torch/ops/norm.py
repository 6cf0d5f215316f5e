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
tower kernel (`ops/tower.py`), in either form, for every normalize of a
tower product. Both give the same limbs, so the reference's own
`ModArith.normalize` is the oracle of either.

The exact form's three carries run in the kernel by another method than
the plain version's (`csrc/norm.cuh`); `carry_probe` runs one of them as
the ladder's tail does and `tail_probe` the whole tail (three carries,
two folds) alone on the card, against `carry_plain` and `tail_plain`, on
rows such as `carry_edge_rows` (the tests and `chip_smoke.py`).
"""

from __future__ import annotations

import numpy as np
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
    return tail_plain(arith, _fold(arith, _relax3(z)))


def tail_plain(arith, z: torch.Tensor) -> torch.Tensor:
    """The exact ladder's tail on (..., 22) limbs: exact carries into 24,
    23 and 22 limbs, the first two each followed by a fold."""
    z = _fold(arith, carry(pad_last(z, FOLD_BASE + 2))[1])
    z = _fold(arith, carry(pad_last(z, FOLD_BASE + 1))[1])
    return carry(pad_last(z, FOLD_BASE))[1]


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


# the exact ladder's carries: into 24, 23 and 22 limbs
CARRY_WIDTHS = (FOLD_BASE + 2, FOLD_BASE + 1, FOLD_BASE)


def carry_plain(acc: torch.Tensor, nout: int) -> torch.Tensor:
    """The exact carry of (..., 22) limbs into `nout` canonical limbs, the
    carry off the top dropped: the value mod 2^(12·nout)."""
    return carry(pad_last(acc, nout))[1]


def carry_probe(acc: torch.Tensor, nout: int) -> torch.Tensor:
    """One of the exact ladder's carries on the card, run by the device
    code of `norm_exact`'s tail (`gs_norm_carry`: into 24 or 23 limbs,
    `carry_top`, whose top limbs feed the next fold and whose low words
    stay uncarried, made canonical here by the tail's last carry; into
    22, that last carry), on acc (n, 22) int32, |limb| < 2^31, into
    `nout` in CARRY_WIDTHS limbs; equal to `carry_plain`. A probe for
    the tests: not a launch of the path, so not counted."""
    n, w = acc.shape
    if w != FOLD_BASE or nout not in CARRY_WIDTHS:
        raise ValueError(f"carry of {w} limbs into {nout}")
    _build.check_tensor(acc, (n, w), "acc")
    out = torch.empty((n, nout), dtype=torch.int32, device=acc.device)
    if n == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(acc.device.index)
    err = _build.library().gs_norm_carry(_build.ptr(acc), n, nout,
                                         _build.ptr(out), stream)
    if err:
        raise RuntimeError(f"gs_norm_carry: {_build.error_string(err)}")
    return out


def tail_probe(arith, acc: torch.Tensor) -> torch.Tensor:
    """The exact ladder's tail alone on the card (`gs_norm_tail`, the
    device code of `norm_exact`'s last phase), on acc (n, 22) int32,
    |limb| < 2^31; equal to `tail_plain`. A probe for the tests: not a launch of the path, so not
    counted."""
    n, w = acc.shape
    if w != FOLD_BASE:
        raise ValueError(f"tail of {w} limbs")
    _build.check_tensor(acc, (n, w), "acc")
    out = torch.empty((n, FOLD_BASE), dtype=torch.int32, device=acc.device)
    if n == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(acc.device.index)
    err = _build.library().gs_norm_tail(
        _build.ptr(acc), n, _build.ptr(const(arith.fold_j, acc.device)),
        _build.ptr(out), stream)
    if err:
        raise RuntimeError(f"gs_norm_tail: {_build.error_string(err)}")
    return out


def carry_edge_rows(seed: int = 0, random_rows: int = 8) -> torch.Tensor:
    """(n, 22) int32 accumulators on which an exact carry runs its longest
    chains: a +1 through the whole width (4095 limbs, 4096 at limb 0); a
    borrow through the whole width (0 limbs, -1 at limb 0: the value -1);
    alternating 0/4095 limbs with a carry or a borrow into limb 0; a
    +1 chain that a -1 limb stops halfway; negative values; carries off
    limb 21 into limbs 22-23 and past 24 (dropped); post-fold magnitudes
    near ±2^28 and the int32 edge ±(2^31 - 1); then `random_rows` seeded
    rows within ±2^26, the ladder's own range."""
    lim = FOLD_BASE
    full = lambda v: np.full(lim, v, dtype=np.int64)
    alt = np.where(np.arange(lim) % 2 == 0, 0, 4095)
    big, small = (1 << 28) - 1, -(1 << 28)
    cases = [(full(4095), {0: 4096}),       # +1 through the whole width
             (full(0), {0: -1}),            # a borrow through it: -1
             (alt, {0: 4096}), (alt, {0: -1}),
             (4095 - alt, {0: 4096}), (4095 - alt, {0: -1}),
             (full(4095), {0: 4096, 11: -1}),
             (full(0), {0: -1, lim - 1: 4096})]
    cases += [(full(0), {lim - 1: top})      # carries off limb 21
              for top in (4096, 1 << 28, -1, -(1 << 28))]
    cases += [(full(v), {}) for v in (big, small, (1 << 31) - 1,
                                      -((1 << 31) - 1))]
    cases.append((np.where(np.arange(lim) % 2 == 0, big, small), {}))
    rows = []
    for base, at in cases:
        row = base.copy()
        for j, v in at.items():
            row[j] = v
        rows.append(row)
    rng = np.random.default_rng(seed)
    rows += list(rng.integers(-(1 << 26), 1 << 26, (random_rows, lim)))
    return torch.as_tensor(np.stack(rows).astype(np.int32))
