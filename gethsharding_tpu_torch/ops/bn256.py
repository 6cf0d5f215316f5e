"""bn256 limb tables, host converters and the committee audit composition.

The port's counterpart of the parts of the JAX package's
`ops/bn256_jax.py` that the committee audit needs:

- the static tables of the pairing program, re-derived here with the same
  formulas: the optimal-ate schedule and its generator lines
  (`_OPT_OPS`, `_GEN_LINES`), the twist-Frobenius constants (`_TWF*`),
  the final exponentiation's hard-part program (`_HARD_PROGRAM`) and the
  NAF digits of u (`_U_NAF`), and 3·b' of the twist (`_B3_G2_LIMBS`);
- the few limb ops around the kernels: `fp12_conj`, `fp12_eq`,
  `fp2_is_zero`;
- the host converters from curve points to limb planes;
- `bls_aggregate_verify_committee_batch`, which chains the three kernel
  functions of `ops/megakernels.py` (G1 and G2 committee sums, the Miller
  product, the final exponentiation) exactly as the JAX package does with
  its four-launch audit dispatch.

Fp2 is (..., 2, 25) int32 (real, imaginary); Fp12 is the flat w-basis
(..., 6, 2, 25) with w^6 = xi = 9 + i.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as ref
from gethsharding_tpu_torch.ops.limb import (NLIMBS, ModArith, int_to_limbs,
                                             ints_to_limbs)

P = ref.P
FP = ModArith(P)


def _const_fp2(value_a: int, value_b: int) -> np.ndarray:
    return np.stack([int_to_limbs(value_a % P), int_to_limbs(value_b % P)])


# == the final exponentiation's hard part ==================================
# Devegili-Scott-Dahab chain as (op, src_a, src_b, dst) over 14 fp12
# registers: 0 mul, 1 sqr, 2 conj (cyclotomic inverse), 3/4/5 frobenius
# 1/2/3. Registers 1..3 hold f^u, f^u^2, f^u^3 before the chain runs.
_HARD_PROGRAM = np.array([
    (3, 0, 0, 4), (4, 0, 0, 5), (5, 0, 0, 6), (0, 4, 5, 4), (0, 4, 6, 4),
    (2, 0, 0, 5), (4, 2, 0, 6), (3, 1, 0, 7), (2, 7, 0, 7), (3, 2, 0, 8),
    (0, 1, 8, 8), (2, 8, 0, 8), (2, 2, 0, 9), (3, 3, 0, 10), (0, 3, 10, 10),
    (2, 10, 0, 10), (1, 10, 0, 11), (0, 11, 8, 11), (0, 11, 9, 11),
    (0, 7, 9, 12), (0, 12, 11, 12), (0, 11, 6, 11), (1, 12, 0, 12),
    (0, 12, 11, 12), (1, 12, 0, 12), (0, 12, 5, 13), (0, 12, 4, 12),
    (1, 13, 0, 13), (0, 13, 12, 13),
], np.int32)

_U_NAF = np.asarray(ref._naf(ref.U), np.int32)  # little-endian digits of u

# == the optimal-ate schedule with precomputed generator lines =============


def _host_jac_dbl(X, Y, Z):
    """Jacobian doubling on ref.Fp2 with its line coefficients, in the
    same formulas and scales as the kernels' doubling step."""
    A = X * X
    B = Y * Y
    C = B * B
    t = (X + B) * (X + B)
    D = (t - A - C).scalar(2)
    E = A.scalar(3)
    F = E * E
    X3 = F - D.scalar(2)
    Y3 = E * (D - X3) - C.scalar(8)
    ZZ = Z * Z
    Z3 = (Y * Z).scalar(2)
    line = (Z3 * ZZ, (E * ZZ).neg(), E * X - B.scalar(2))
    return line, X3, Y3, Z3


def _host_jac_madd(X1, Y1, Z1, x2, y2):
    """Jacobian + affine addition on ref.Fp2 with its chord line."""
    Z1Z1 = Z1 * Z1
    U2 = x2 * Z1Z1
    S2 = y2 * Z1 * Z1Z1
    H = U2 - X1
    R = S2 - Y1
    HH = H * H
    V = X1 * HH
    HHH = H * HH
    X3 = R * R - HHH - V.scalar(2)
    Y3 = R * (V - X3) - Y1 * HHH
    Z3 = Z1 * H
    line = (Z3, R.neg(), R * x2 - Z3 * y2)
    return line, X3, Y3, Z3


def _build_opt_program():
    """(ops, gen_lines): ops (L,) int32 with 0 = DBL, 1 = ADD(+Q),
    2 = ADD(-Q), 3 = ADD(pi Q), 4 = ADD(-pi^2 Q); gen_lines (L, 3, 2, 25)
    the G2-generator line coefficients (c_py, c_px, c_const) per step."""
    ops = []
    for d in reversed(ref.OPT_ATE_NAF[:-1]):
        ops.append(0)
        if d == 1:
            ops.append(1)
        elif d == -1:
            ops.append(2)
    ops += [3, 4]

    q = ref.G2_GEN
    cands = [q, ref.g2_neg(q), ref.g2_frobenius(q),
             ref.g2_neg(ref.g2_frobenius2(q))]
    (X, Y), Z = q, ref.Fp2.one()
    lines = []
    for op in ops:
        if op == 0:
            line, X, Y, Z = _host_jac_dbl(X, Y, Z)
        else:
            x2, y2 = cands[op - 1]
            line, X, Y, Z = _host_jac_madd(X, Y, Z, x2, y2)
        lines.append(np.stack([_const_fp2(c.a, c.b) for c in line]))
    return np.asarray(ops, np.int32), np.stack(lines)


_OPT_OPS, _GEN_LINES = _build_opt_program()
_TWF_X = _const_fp2(ref.TWIST_FROB_X.a, ref.TWIST_FROB_X.b)
_TWF_Y = _const_fp2(ref.TWIST_FROB_Y.a, ref.TWIST_FROB_Y.b)
_TWF2_X = _const_fp2(ref.TWIST_FROB2_X.a, ref.TWIST_FROB2_X.b)
_TWF2_Y = _const_fp2(ref.TWIST_FROB2_Y.a, ref.TWIST_FROB2_Y.b)

_B3_G2 = ref.B2.scalar(3)  # 3·b' = 9/xi on the D-twist y^2 = x^3 + 3/xi
_B3_G2_LIMBS = _const_fp2(_B3_G2.a, _B3_G2.b)

# == limb ops around the kernels ===========================================


def fp2_is_zero(x: torch.Tensor) -> torch.Tensor:
    return FP.is_zero(x[..., 0, :]) & FP.is_zero(x[..., 1, :])


def fp12_conj(x: torch.Tensor) -> torch.Tensor:
    """f^(p^6): negate the odd-w coefficients (w^(p^6) = -w)."""
    odd = torch.arange(6, device=x.device).reshape(6, 1, 1) % 2 == 1
    return torch.where(odd, FP.neg(x), FP.normalize(x))


def fp12_eq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (FP.canon(x) == FP.canon(y)).flatten(-3).all(dim=-1)


# == host converters =======================================================


def g1_to_limbs(points: Sequence[ref.G1Point]):
    """[(x, y) | None]* -> (xs, ys, valid): (B, 25) int32 ×2 + (B,) bool.
    Infinity encodes as (0, 0) with valid False."""
    xs, ys, ok = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(0), ok.append(False)
        else:
            xs.append(pt[0] % P), ys.append(pt[1] % P), ok.append(True)
    return ints_to_limbs(xs), ints_to_limbs(ys), np.asarray(ok, bool)


def g1_committee_to_limbs(rows: Sequence[Sequence[ref.G1Point]], width: int):
    """B rows of <= width G1 points (None = empty slot) -> (B, width, 25)
    ×2 + mask (B, width), through one bulk bit-plane conversion."""
    B = len(rows)
    flat_x, flat_y = [], []
    mask = np.zeros((B, width), bool)
    for b, row in enumerate(rows):
        if len(row) > width:
            raise ValueError(f"committee of {len(row)} exceeds width {width}")
        for c in range(width):
            pt = row[c] if c < len(row) else None
            if pt is None:
                flat_x.append(0)
                flat_y.append(0)
            else:
                flat_x.append(pt[0] % P)
                flat_y.append(pt[1] % P)
                mask[b, c] = True
    both = ints_to_limbs(flat_x + flat_y)
    xs = both[:B * width].reshape(B, width, NLIMBS)
    ys = both[B * width:].reshape(B, width, NLIMBS)
    return xs, ys, mask


def g2_committee_to_limbs(rows: Sequence[Sequence[ref.G2Point]], width: int):
    """B rows of <= width G2 points -> (B, width, 2, 25) ×2 + mask."""
    B = len(rows)
    flat_x, flat_y = [], []
    mask = np.zeros((B, width), bool)
    for b, row in enumerate(rows):
        if len(row) > width:
            raise ValueError(f"committee of {len(row)} exceeds width {width}")
        for c in range(width):
            pt = row[c] if c < len(row) else None
            if pt is None:
                flat_x.extend((0, 0))
                flat_y.extend((0, 0))
            else:
                x, y = pt
                flat_x.extend((x.a % P, x.b % P))
                flat_y.extend((y.a % P, y.b % P))
                mask[b, c] = True
    both = ints_to_limbs(flat_x + flat_y)
    half = B * width * 2
    xs = both[:half].reshape(B, width, 2, NLIMBS)
    ys = both[half:].reshape(B, width, 2, NLIMBS)
    return xs, ys, mask


# == the committee audit ===================================================


def bls_aggregate_verify_committee_batch(hx, hy, sigx, sigy, sig_mask,
                                         pkx, pky, pk_mask, valid, *,
                                         plain: bool = False):
    """Aggregate and verify each row's committee votes.

    Per row: the masked sums of the vote signatures (G1) and the voter
    pubkeys (G2), then e(aggsig, G2)·e(-H, aggpk) == 1 on the projective
    aggregates. hx/hy (B, 25); sigx/sigy (B, C, 25) with sig_mask (B, C);
    pkx/pky (B, C, 2, 25) with pk_mask (B, C); valid (B,) bool. Identity
    aggregates (empty or cancelling committees) are rejections. Returns
    (B,) bool on the inputs' device.

    On CUDA tensors this is four kernel launches (G1 sum, G2 sum, Miller,
    final exponentiation); `plain=True` runs the plain PyTorch versions
    of the same functions instead, on any device."""
    from gethsharding_tpu_torch.ops import megakernels as mk

    sX, sY, sZ = mk.aggregate_proj(sigx, sigy, sig_mask, fp2=False,
                                   plain=plain)
    pX, pY, pZ = mk.aggregate_proj(pkx, pky, pk_mask, fp2=True, plain=plain)
    inf = FP.is_zero(sZ) | fp2_is_zero(pZ)
    f = mk.miller_f((sX, sY, sZ), hx, hy, (pX, pY, pZ), plain=plain)
    return mk.finalexp_is_one(f, plain=plain) & valid & ~inf
