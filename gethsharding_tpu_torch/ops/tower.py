"""One kernel launch per tower product: `csrc/tower.cu`, with its plans.

Each product of the tower (`ModArith.mul`, `fp2_mul`/`fp2_sqr`,
`fp12_mul`/`fp12_sqr`, `fp12_mul_line`) runs on a CUDA tensor as one
launch of the tower kernel, which does the product's conv, pads,
normalizes and merges in the order its plain route runs them, so it gives
the plain route's limbs. The plain route is the function's own body in
`ops/bn256.py` / `ops/limb.py` (conv, then normalize, through
`ops/conv.py` and `ops/norm.py`), which runs for a CPU tensor and inside
`route.plain_versions()`.

A `Plan` is one product: its kind, its combine tensor, pads and
operand-selection tables (the port's own constants, passed in from the
caller, never re-derived in C), and the `ModArith` whose fold and lift
its normalizes use. It packs them once per device into the int32 layout
`csrc/tower.cu` reads (`TowerPack`).

The kernel runs in the limb form of `limb.LIMB_FORM`, with that form's
widths (`ACC_W`, `XI_W`): the wide form's 25-limb operands, or the exact
form's 22 (`GETHSHARDING_TORCH_LIMB_FORM=exact`), whose pads are wider
than its conv (planes of 45 columns over 43) and whose xi pad is wider
than an operand (23 limbs over 22). Its normalizes run the form's branch of
`csrc/norm.cuh`. In the exact form the kernel is counted as
`tower_exact`.
"""

from __future__ import annotations


import numpy as np
import torch

from gethsharding_tpu_torch.ops import _build, conv
from gethsharding_tpu_torch.ops.limb import LIMB_FORM, NLIMBS, const

KERNEL = _build.Kernel("tower_exact" if LIMB_FORM == "exact" else "tower",
                       "gs_tower", "gethsharding_tpu_torch/csrc/tower.cu",
                       "gethsharding_tpu/ops/pallas_conv.py:113")

# per limb form (csrc/tower.cu `TowerForm`): the widest plane accumulator
# (the pads' stride in the pack) and the xi·y accumulator
ACC_W, XI_W = {"wide": (49, 25), "exact": (45, 23)}[LIMB_FORM]
_FORM_ARG = {"wide": 0, "exact": 1}[LIMB_FORM]   # csrc/norm.cuh NormForm

# kinds of csrc/tower.cu `TowerKind`: (G, A, B, C, Gr, K) of `TowerShape`
FP, FP2, FP12, LINE = 0, 1, 2, 3
SHAPES = {FP: (1, 1, 1, 1, 1, 1), FP2: (1, 2, 2, 2, 1, 1),
          FP12: (6, 2, 2, 2, 3, 6), LINE: (3, 2, 2, 2, 2, 6)}


class Plan:
    """One tower product: `kind`, its combine (G, A, B, C, Gr), its plane
    pads (C, Gr, W) added to the columns before the first normalize (W,
    between the conv's 2·NLIMBS - 1 columns and ACC_W, is the width every
    plane is normalized at), for the Fp12 kinds the cyclic selection
    (sel, idx), each (6, G): output k takes operand idx[k][i] of v, or of
    xi·v where sel[k][i] is 1, and the pad (<= XI_W limbs) of xi's real
    part; `arith` the modulus's `ModArith`. `plain(u, v)` is the
    product's routing function on the kernel's operand form."""

    def __init__(self, kind, arith, comb, pad, plain, sel=None, idx=None,
                 xi_pad=None):
        G, A, B, C, Gr, K = SHAPES[kind]
        if comb.shape != (G, A, B, C, Gr) or pad.shape[:2] != (C, Gr):
            raise ValueError(f"plan shapes {comb.shape}, {pad.shape} do not "
                             f"fit tower kind {kind}")
        self.acc_w = pad.shape[-1]
        if not conv.NCOLS <= self.acc_w <= ACC_W:
            raise ValueError(f"plan pad {pad.shape} is not {conv.NCOLS} to "
                             f"{ACC_W} columns wide")
        if sel is None:     # one output: operand i of v for term i
            sel = np.zeros((1, G), np.int32)
            idx = np.arange(G, dtype=np.int32)[None]
        self.kind, self.comb, self.plain = kind, comb, plain
        plan = conv.plane_plan(comb)
        self.nterms = conv.plan_terms(plan, C * Gr).shape[0]
        xi = np.zeros(XI_W, np.int32)
        if xi_pad is not None:
            if xi_pad.shape[0] > XI_W:
                raise ValueError(f"xi pad of {xi_pad.shape[0]} limbs; the "
                                 f"kernel takes {XI_W}")
            xi[: xi_pad.shape[0]] = xi_pad
        pads = np.zeros((C, Gr, ACC_W), np.int32)
        pads[..., : self.acc_w] = pad
        self.pack = np.concatenate([
            [self.acc_w], arith.fold_j.ravel(), arith.lift, xi,
            pads.ravel(), np.ravel(sel), np.ravel(idx), plan]).astype(np.int32)
        self.u_block = (G, A, NLIMBS)
        self.v_block = (6, 2, NLIMBS) if K > 1 else (G, B, NLIMBS)
        self.out_block = {FP: (NLIMBS,), FP2: (C, NLIMBS)}.get(
            kind, (K, C, NLIMBS))
        self._ptrs: dict = {}

    def pack_ptr(self, device) -> int:
        """The pack's address on `device`, made once per device."""
        hit = self._ptrs.get(device)
        if hit is None:
            hit = self._ptrs[device] = const(self.pack, device).data_ptr()
        return hit


def launch_args(plan: Plan, u: torch.Tensor, v: torch.Tensor):
    """(u, v, n, ndim, desc, out) of a launch: the operands with their
    rows read in place through their strides over the common lead, and
    the output (lead + out_block), allocated on u's device."""
    u, v, lead, n, ndim, desc = conv.broadcast_rows(u, v)
    return u, v, n, ndim, desc, u.new_empty(lead + plan.out_block)


def tower_kernel(plan: Plan, u: torch.Tensor, v: torch.Tensor):
    """Launch `csrc/tower.cu` for `plan` on u (..., *plan.u_block) and v
    (..., *plan.v_block), int32 CUDA tensors of the ambient limb form
    whose leading dims broadcast; returns (lead, *plan.out_block), equal
    to `plan.plain(u, v)` limb for limb. Each operand is read once, in
    place."""
    conv.check_limbs(u, v, "tower kernel")
    conv.check_operand(u, plan.u_block, "u")
    conv.check_operand(v, plan.v_block, "v")
    u, v, n, ndim, desc, out = launch_args(plan, u, v)
    if n:
        KERNEL.launch(plan.kind, _FORM_ARG, u.data_ptr(), v.data_ptr(), n,
                      ndim, desc, plan.pack_ptr(u.device), plan.nterms,
                      out.data_ptr())
    return out
