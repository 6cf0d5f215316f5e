"""bn256 limb tables, the Fp2/Fp12 tower, host converters and the two
committee audits.

The port's counterpart of the parts of the JAX package's
`ops/bn256_jax.py` that the committee audit needs:

- the static tables of the pairing program, re-derived here with the same
  formulas: the optimal-ate schedule and its generator lines
  (`_OPT_OPS`, `_GEN_LINES`), the twist-Frobenius constants (`_TWF*`),
  the final exponentiation's hard-part program (`_HARD_PROGRAM`) and the
  NAF digits of u (`_U_NAF`), and 3·b' of the twist (`_B3_G2_LIMBS`);
- the tower: Fp2 and Fp12 products with the reference's combine tensors,
  pads and normalize sequence, so each function gives the reference's
  limbs. On a CUDA tensor every product (`FP.mul`, `fp2_mul`/`fp2_sqr`,
  `fp12_mul`/`fp12_sqr`, `fp12_mul_line`) is one launch of the tower
  kernel (`ops/tower.py`), and every other reduction goes through
  `ops/norm.py`; each product's body below is its plain route (conv
  through `ops/conv.py`, reductions through `ops/norm.py`), which runs
  for a CPU tensor and inside `route.plain_versions()` and gives the
  same limbs. One formulation differs: `fp2_sqr` is the reference's
  kernel form (one fused plane with coefficient 2), which equals its
  default XLA form only mod p;
- the host converters from curve points to limb planes;
- `bls_aggregate_verify_committee_batch`, which chains the three kernel
  functions of `ops/megakernels.py` (G1 and G2 committee sums, the Miller
  product, the final exponentiation) exactly as the JAX package does with
  its four-launch audit dispatch (the recompute path);
- the fixed-base precomputation (the notary's default path): one
  `precompute_g2_lines` per committee turns its aggregate pubkey into an
  (88, 3, 2, 25) line table, and `miller_loop_precomp` runs the Miller
  loop from it with no G2 point arithmetic;
- `bls_verify_aggregate_batch`, one pairing check per row of affine
  aggregates (the vote already summed on the host): the Miller kernel
  and the final exponentiation, one launch each.

Fp2 is (..., 2, 25) int32 (real, imaginary); Fp12 is the flat w-basis
(..., 6, 2, 25) with w^6 = xi = 9 + i. The limb counts here are the wide
form's; in the exact form (`limb.LIMB_FORM`) every table, converter and
function works at 22 limbs (line tables (88, 3, 2, 22)), on the card as
on the CPU: the tower kernel and the normalize run in that form.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as ref
from gethsharding_tpu_torch.ops import conv, route, tower
from gethsharding_tpu_torch.ops.limb import (LAZY_BITS, NLIMBS, ModArith,
                                             const, int_to_limbs,
                                             ints_to_limbs, pad_last)

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

# == the tower ==============================================================
# Column-space bounds (the reference's): a 25-limb product column is
# < 25·4095² ≈ 2^28.64, so an int32 accumulator holds four products plus a
# canonical pad. A product of two lazy values is < 2^546, so a sum of two
# subtracted products needs a multiple of p >= 2^547.
_PAD530 = FP.pad_mult(2 * LAZY_BITS + 1)   # >= two subtracted products
_PAD266 = FP.pad_mult(LAZY_BITS)           # >= one lazy element


def _pad_to(cols: torch.Tensor, width: int) -> torch.Tensor:
    return pad_last(cols, width)


def fp2_add(x, y):
    return FP.add(x, y)


def fp2_sub(x, y):
    return FP.sub(x, y)


def fp2_neg(x):
    return FP.neg(x)


# combine tensors of the (a+bi)(c+di) product planes: re = ac - bd,
# im = ad + bc; the square folds im into one plane with coefficient 2
_COMB_FP2 = np.zeros((1, 2, 2, 2, 1), np.int32)
_COMB_FP2[0, 0, 0, 0, 0] = 1
_COMB_FP2[0, 1, 1, 0, 0] = -1
_COMB_FP2[0, 0, 1, 1, 0] = 1
_COMB_FP2[0, 1, 0, 1, 0] = 1
_COMB_FP2_SQR = np.zeros((1, 2, 2, 2, 1), np.int32)
_COMB_FP2_SQR[0, 0, 0, 0, 0] = 1
_COMB_FP2_SQR[0, 1, 1, 0, 0] = -1
_COMB_FP2_SQR[0, 0, 1, 1, 0] = 2

_FP2_W = max(2 * NLIMBS - 1, _PAD530.shape[0])
_FP2_PAD = np.zeros((2, _FP2_W), np.int32)  # pad only the subtracting re
_FP2_PAD[0, : _PAD530.shape[0]] = _PAD530


def _fp2_product(x, y, plan):
    if route.use_kernel(x):
        return tower.tower_kernel(plan, x[..., None, :, :],
                                  y[..., None, :, :])
    acc = conv.pair_conv_combine(x[..., None, :, :], y[..., None, :, :],
                                 plan.comb)[..., 0, :]        # (..., 2, 49)
    return FP.normalize(_pad_to(acc, _FP2_W) + const(_FP2_PAD, acc.device))


def fp2_mul(x, y):
    """(a+bi)(c+di) = (ac - bd) + (ad + bc)i, one normalize."""
    return _fp2_product(x, y, _FP2_MUL)


def fp2_sqr(x):
    """The reference's kernel form: re and the doubled im from three
    planes, one normalize (equal to its XLA form mod p)."""
    return _fp2_product(x, x, _FP2_SQR)


_FP2_MUL = tower.Plan(tower.FP2, FP, _COMB_FP2, _FP2_PAD[:, None],
                      plain=lambda u, v: fp2_mul(u[..., 0, :, :],
                                                 v[..., 0, :, :]))
_FP2_SQR = tower.Plan(tower.FP2, FP, _COMB_FP2_SQR, _FP2_PAD[:, None],
                      plain=lambda u, v: fp2_sqr(u[..., 0, :, :]))


def fp2_scalar(x, k: int):
    """Multiply both components by a small non-negative int."""
    return FP.mul_small(x, k)


def fp2_mul_fp(x, s):
    """Fp2 x (..., 2, 25) times Fp s (..., 25): both components in one
    product launch, each its own normalize row."""
    return FP.mul(x, s[..., None, :])


def fp2_mul_xi(x):
    """×xi = ×(9+i): (9a - b) + (a + 9b)i; both components reduced in one
    normalize (a zero-padded row normalizes to the same limbs)."""
    a, b = x[..., 0, :], x[..., 1, :]
    width = max(a.shape[-1], _PAD266.shape[0])
    rr = _pad_to(a * 9 - b, width) + _pad_to(const(_PAD266, x.device), width)
    return FP.normalize(torch.stack([rr, _pad_to(a + b * 9, width)], dim=-2))


def fp2_conj(x):
    """(normalize(a), neg(b)) in one normalize."""
    a, b = x[..., 0, :], x[..., 1, :]
    width = max(a.shape[-1], FP.sub_pad.shape[0])
    neg_b = _pad_to(-b, width) + _pad_to(const(FP.sub_pad, x.device), width)
    return FP.normalize(torch.stack([_pad_to(a, width), neg_b], dim=-2))


def fp2_is_zero(x: torch.Tensor) -> torch.Tensor:
    return FP.is_zero(x[..., 0, :]) & FP.is_zero(x[..., 1, :])


FP12_ONE = np.zeros((6, 2, NLIMBS), np.int32)
FP12_ONE[0, 0, 0] = 1

# cyclic convolution of the w-basis product: output k takes, for each i,
# operand j = (k - i) mod 6 from y when i + j == k, from xi·y on wrap
_CONV_J = np.array([[(k - i) % 6 for i in range(6)] for k in range(6)])
_CONV_SEL = np.array([[0 if i + (k - i) % 6 == k else 1 for i in range(6)]
                      for k in range(6)])

# combine per output k: the 24 planes (i, a, b) onto component c and
# accumulation group g = i // 2 (each group holds <= 4 products)
_COMB = np.zeros((6, 2, 2, 2, 3), np.int32)   # (i, a, b, c, g)
for _i in range(6):
    _g = _i // 2
    _COMB[_i, 0, 0, 0, _g] = 1
    _COMB[_i, 1, 1, 0, _g] = -1
    _COMB[_i, 0, 1, 1, _g] = 1
    _COMB[_i, 1, 0, 1, _g] = 1

# per-group pad: real groups subtract <= 2 products; imaginary groups are
# all-positive. Accumulator width = max(product columns, pad limbs).
_ACC_W = max(2 * NLIMBS - 1, _PAD530.shape[0])


def _group_pad(n_groups: int) -> np.ndarray:
    pad = np.zeros((2, n_groups, _ACC_W), np.int32)
    pad[0, :, : _PAD530.shape[0]] = _PAD530
    return pad


_GROUP_PAD = {n: _group_pad(n) for n in (2, 3)}


def fp12_mul(x, y):
    """w-basis product: cyclic convolution with xi on wrap-around. The six
    outputs k share one conv launch (their columns are independent); one
    normalize reduces every (k, c, g), and two lazy adds merge the
    groups. One tower-kernel launch on a CUDA tensor."""
    if route.use_kernel(x):
        return tower.tower_kernel(_FP12_MUL, x, y)
    xiy = fp2_mul_xi(y)
    w = torch.stack([y, xiy], dim=-4)                      # (..., 2, 6, 2, 25)
    op = w[..., _CONV_SEL, _CONV_J, :, :]                  # (..., 6k, 6i, 2, 25)
    acc = conv.pair_conv_combine(x[..., None, :, :, :], op, _COMB)
    acc = _pad_to(acc, _ACC_W) + const(_GROUP_PAD[3], acc.device)
    parts = FP.normalize(acc)                              # (..., 6, 2, 3, 25)
    merged = FP.normalize(parts[..., 0, :] + parts[..., 1, :])
    return FP.normalize(merged + parts[..., 2, :])


_FP12_MUL = tower.Plan(tower.FP12, FP, _COMB, _GROUP_PAD[3],
                       plain=lambda u, v: fp12_mul(u, v), sel=_CONV_SEL,
                       idx=_CONV_J, xi_pad=_PAD266)


def fp12_sqr(x):
    return fp12_mul(x, x)


def fp12_conj(x: torch.Tensor) -> torch.Tensor:
    """f^(p^6): negate the odd-w coefficients (w^(p^6) = -w)."""
    odd = torch.arange(6, device=x.device).reshape(6, 1, 1) % 2 == 1
    return torch.where(odd, FP.neg(x), FP.normalize(x))


def fp12_eq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (FP.canon(x) == FP.canon(y)).flatten(-3).all(dim=-1)


def _gamma_table(n: int) -> np.ndarray:
    """(6, 2, 25) limbs of gamma_{n,k} = xi^(k(p^n-1)/6), k = 0..5."""
    return np.stack([_const_fp2(g.a, g.b) for g in (
        ref._fp2_pow(ref.XI, k * (P ** n - 1) // 6) for k in range(6))])


_GAMMA = {n: _gamma_table(n) for n in (1, 2, 3)}


def fp12_frobenius(x, n: int):
    """f^(p^n) for n in {1, 2, 3}: every w-coefficient at once."""
    coeff = fp2_conj(x) if n % 2 == 1 else FP.normalize(x)
    return fp2_mul(coeff, const(_GAMMA[n], x.device))


# sparse line product: the line A + B·w + C·w^3; output k takes A·f_k,
# B·f_{k-1} (xi·f_{k+5} on wrap), C·f_{k-3} (xi·f_{k+3} on wrap)
_LINE_POS = np.array([0, 1, 3])
_LINE_J = np.array([[(k - d) % 6 for d in _LINE_POS] for k in range(6)])
_LINE_SEL = np.array([[0 if k - d >= 0 else 1 for d in _LINE_POS]
                      for k in range(6)])
# combine (t, a, b, c, g): group 0 holds terms A and B, group 1 term C
_LCOMB = np.zeros((3, 2, 2, 2, 2), np.int32)
for _t in range(3):
    _g = 0 if _t < 2 else 1
    _LCOMB[_t, 0, 0, 0, _g] = 1
    _LCOMB[_t, 1, 1, 0, _g] = -1
    _LCOMB[_t, 0, 1, 1, _g] = 1
    _LCOMB[_t, 1, 0, 1, _g] = 1


def fp12_mul_line(f, line):
    """f · (A + B·w + C·w^3), sparse; line (..., 3, 2, 25) stacks A, B, C
    and broadcasts against f. The six outputs in one conv launch; one
    tower-kernel launch on a CUDA tensor."""
    if route.use_kernel(f):
        return tower.tower_kernel(_LINE_MUL, line, f)
    xif = fp2_mul_xi(f)
    w = torch.stack([f, xif], dim=-4)                      # (..., 2, 6, 2, 25)
    op = w[..., _LINE_SEL, _LINE_J, :, :]                  # (..., 6k, 3, 2, 25)
    acc = conv.pair_conv_combine(line[..., None, :, :, :], op, _LCOMB)
    acc = _pad_to(acc, _ACC_W) + const(_GROUP_PAD[2], acc.device)
    parts = FP.normalize(acc)                              # (..., 6, 2, 2, 25)
    return FP.normalize(parts[..., 0, :] + parts[..., 1, :])


_LINE_MUL = tower.Plan(tower.LINE, FP, _LCOMB, _GROUP_PAD[2],
                       plain=lambda u, v: fp12_mul_line(v, u), sel=_LINE_SEL,
                       idx=_LINE_J, xi_pad=_PAD266)


# == G2 Jacobian steps in coefficient form =================================
# Twist point T = (X, Y, Z) Jacobian, each Fp2. The line through the step
# is l = c_py·y + c_px·x + c_const, left unevaluated: the precomputation
# stores the three coefficients, the Miller loop evaluates them at -H.


def _dbl_coeffs(X, Y, Z):
    """Tangent step: ((c_py, c_px, c_const), X3, Y3, Z3)."""
    A = fp2_sqr(X)
    B = fp2_sqr(Y)
    C = fp2_sqr(B)
    t = fp2_sqr(fp2_add(X, B))
    D = fp2_scalar(fp2_sub(fp2_sub(t, A), C), 2)   # 4XY^2
    E = fp2_scalar(A, 3)
    F = fp2_sqr(E)
    X3 = fp2_sub(F, fp2_scalar(D, 2))
    Y3 = fp2_sub(fp2_mul(E, fp2_sub(D, X3)), fp2_scalar(C, 8))
    ZZ = fp2_sqr(Z)
    Z3 = fp2_scalar(fp2_mul(Y, Z), 2)
    c_py = fp2_mul(Z3, ZZ)                          # 2YZ^3
    c_px = fp2_neg(fp2_mul(E, ZZ))                  # -3X^2Z^2
    c_const = fp2_sub(fp2_mul(E, X), fp2_scalar(B, 2))  # 3X^3 - 2Y^2
    return (c_py, c_px, c_const), X3, Y3, Z3


def _jadd_coeffs(X1, Y1, Z1, cand):
    """Jacobian + Jacobian chord step against candidate Q2 = cand (its
    X2, Y2, Z2, Z2^2, Z2^3): ((Z3, -R, c_const), X3, Y3, Z3)."""
    x2, y2, z2, zz2, zzz2 = cand
    Z1Z1 = fp2_sqr(Z1)
    U1 = fp2_mul(X1, zz2)
    U2 = fp2_mul(x2, Z1Z1)
    S1 = fp2_mul(Y1, zzz2)
    S2 = fp2_mul(y2, fp2_mul(Z1, Z1Z1))
    H = fp2_sub(U2, U1)
    R = fp2_sub(S2, S1)
    HH = fp2_sqr(H)
    V = fp2_mul(U1, HH)
    HHH = fp2_mul(H, HH)
    X3 = fp2_sub(fp2_sub(fp2_sqr(R), HHH), fp2_scalar(V, 2))
    Y3 = fp2_sub(fp2_mul(R, fp2_sub(V, X3)), fp2_mul(S1, HHH))
    Z3 = fp2_mul(fp2_mul(Z1, z2), H)
    c_const = fp2_sub(fp2_mul(fp2_mul(X1, y2), Z1),
                      fp2_mul(fp2_mul(x2, Y1), z2))
    return (Z3, fp2_neg(R), c_const), X3, Y3, Z3


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


def g2_to_limbs(points: Sequence[ref.G2Point]):
    """[(x, y) | None]* G2 affine points -> (xs, ys, valid): (B, 2, NL)
    int32 ×2 + (B,) bool. Infinity encodes as zero limbs with valid
    False."""
    flat_x, flat_y, ok = [], [], []
    for pt in points:
        if pt is None:
            flat_x.extend((0, 0)), flat_y.extend((0, 0)), ok.append(False)
        else:
            x, y = pt
            flat_x.extend((x.a % P, x.b % P))
            flat_y.extend((y.a % P, y.b % P))
            ok.append(True)
    both = ints_to_limbs(flat_x + flat_y)
    half = 2 * len(points)
    return (both[:half].reshape(-1, 2, NLIMBS),
            both[half:].reshape(-1, 2, NLIMBS), np.asarray(ok, bool))


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
                                         pkx, pky, pk_mask, valid):
    """Aggregate and verify each row's committee votes.

    Per row: the masked sums of the vote signatures (G1) and the voter
    pubkeys (G2), then e(aggsig, G2)·e(-H, aggpk) == 1 on the projective
    aggregates. hx/hy (B, 25); sigx/sigy (B, C, 25) with sig_mask (B, C);
    pkx/pky (B, C, 2, 25) with pk_mask (B, C); valid (B,) bool. Identity
    aggregates (empty or cancelling committees) are rejections. Returns
    (B,) bool on the inputs' device.

    On CUDA tensors this is four audit-kernel launches (G1 sum, G2 sum,
    Miller, final exponentiation) and a few normalize launches between
    them."""
    from gethsharding_tpu_torch.ops import megakernels as mk

    sX, sY, sZ = mk.aggregate_proj(sigx, sigy, sig_mask, fp2=False)
    pX, pY, pZ = mk.aggregate_proj(pkx, pky, pk_mask, fp2=True)
    inf = FP.is_zero(sZ) | fp2_is_zero(pZ)
    f = mk.miller_f((sX, sY, sZ), hx, hy, (pX, pY, pZ))
    return mk.finalexp_is_one(f) & valid & ~inf


_FP_ONE = int_to_limbs(1)
_FP2_ONE = _const_fp2(1, 0)


def bls_verify_aggregate_batch(hx, hy, sx, sy, pkx, pky, valid):
    """One aggregate vote per row: e(sig, G2)·e(-H, pk) == 1.

    hx/hy, sx/sy (B, NL): the message hash and the aggregate signature,
    affine G1; pkx/pky (B, 2, NL): the aggregate pubkey, affine G2; valid
    (B,) bool, False where the host found a point at infinity. Returns
    (B,) bool on the inputs' device.

    The affine points enter the projective Miller product with Z = 1,
    then the final exponentiation: on CUDA tensors one Miller-kernel
    launch and one final-exponentiation launch. (The JAX package
    specializes its affine Miller loop to mixed additions and constant
    generator-line terms; that gives another f with the same final
    exponentiation, so the same verdicts.)"""
    from gethsharding_tpu_torch.ops import megakernels as mk

    dev = sx.device
    sz = const(_FP_ONE, dev).expand(sx.shape)
    pkz = const(_FP2_ONE, dev).expand(pkx.shape)
    f = mk.miller_f((sx, sy, sz), hx, hy, (pkx, pky, pkz))
    return mk.finalexp_is_one(f) & valid


# == fixed-base precomputation (the notary's default path) =================
# The committee's aggregate pubkey is fixed across audits (stable per
# `pk_row_key`), yet the recompute path walks its doubling/addition
# schedule on every call. `precompute_lines` walks it once and stores
# each step's unevaluated line coefficients; `miller_loop_precomp`
# evaluates them at each audit's message hash. The stored coefficients
# are the arrays the walk evaluates, in the same order.

LINE_TABLE_SHAPE = (len(_OPT_OPS), 3, 2, NLIMBS)


def generator_line_table() -> np.ndarray:
    """The G2 generator's (88, 3, 2, 25) line table (host copy)."""
    return np.array(_GEN_LINES)


def generator_lines_on(device) -> torch.Tensor:
    """The G2 generator's line table on `device`, made once per device
    (the table `miller_loop_precomp` takes by default)."""
    return const(_GEN_LINES, device)


def precompute_lines(pkx, pky, pkz):
    """Walk the optimal-ate schedule once for a fixed projective G2 point
    (..., 2, 25) each and return its line table (..., 88, 3, 2, 25): per
    step the (c_py, c_px, c_const) coefficients of `_dbl_coeffs` /
    `_jadd_coeffs`, unevaluated."""
    dev = pkx.device
    q1x = fp2_mul(fp2_conj(pkx), const(_TWF_X, dev))
    q1y = fp2_mul(fp2_conj(pky), const(_TWF_Y, dev))
    q2x = fp2_mul(pkx, const(_TWF2_X, dev))
    q2ny = FP.neg(fp2_mul(pky, const(_TWF2_Y, dev)))
    zconj = fp2_conj(pkz)
    cand = []   # ADD(+Q), ADD(-Q), ADD(pi Q), ADD(-pi^2 Q), Jacobian lifts
    for cx, cy, cz in ((pkx, pky, pkz), (pkx, FP.neg(pky), pkz),
                       (q1x, q1y, zconj), (q2x, q2ny, pkz)):
        zz = fp2_sqr(cz)
        cand.append((fp2_mul(cx, cz), fp2_mul(cy, zz), cz, zz,
                     fp2_mul(cz, zz)))
    X = fp2_mul(pkx, pkz)
    Y = fp2_mul(pky, fp2_sqr(pkz))
    Z = FP.normalize(pkz)
    lines = []
    for op in _OPT_OPS.tolist():
        if op == 0:
            coeffs, X, Y, Z = _dbl_coeffs(X, Y, Z)
        else:
            coeffs, X, Y, Z = _jadd_coeffs(X, Y, Z, cand[op - 1])
        lines.append(torch.stack(coeffs, dim=-3))
    return torch.stack(lines, dim=-4)


def precompute_g2_lines(pkx, pky, pk_mask):
    """Sum each committee's pubkeys (..., C, 2, 25) under pk_mask (..., C)
    and precompute the sum's line table. Returns (table (..., 88, 3, 2,
    25), pk_inf (...,) bool): pk_inf marks identity sums (an empty or
    cancelling committee), whose rows the audit rejects; their tables
    are defined but never decide a verdict."""
    from gethsharding_tpu_torch.ops import megakernels as mk

    pX, pY, pZ = mk.aggregate_proj(pkx, pky, pk_mask, fp2=True)
    return precompute_lines(pX, pY, pZ), fp2_is_zero(pZ)


def miller_loop_precomp(sig, hx, hy, table, gen_lines=None):
    """The shared-accumulator optimal-ate Miller product e(sig, G2)·e(-H,
    pk) from line tables: sig = (sx, sy, sz) projective G1 (..., 25),
    hx/hy (..., 25), table (..., 88, 3, 2, 25) from `precompute_lines`,
    gen_lines the generator's table (default `_GEN_LINES`). Per step: a
    square on doublings, then the generator line and the pubkey line.

    The line evaluations depend on the inputs only, not on f, so all 88
    steps' are made up front, one product launch for each of the two
    tables: the same products as the reference's per-step evaluation,
    so the same limbs."""
    sx, sy, sz = sig
    dev = sx.device
    gen = generator_lines_on(dev) if gen_lines is None else gen_lines
    gen = torch.cat([gen[:, :2], FP.normalize(gen[:, 2:])], dim=1)
    at_sig = torch.stack([sy, sx, sz], dim=-2)[..., None, :, None, :]
    gen_ev = FP.mul(gen, at_sig)                           # (..., 88, 3, 2, 25)
    at_h = torch.stack([FP.neg(hy), hx], dim=-2)[..., None, :, None, :]
    pk_ev = torch.cat([FP.mul(table[..., :2, :, :], at_h),
                       table[..., 2:, :, :]], dim=-3)      # (..., 88, 3, 2, 25)
    f = FP.normalize(const(FP12_ONE, dev).expand(sx.shape[:-1]
                                                 + FP12_ONE.shape))
    steps = zip(_OPT_OPS.tolist(), gen_ev.unbind(-4), pk_ev.unbind(-4))
    for op, gen_line, pk_line in steps:
        if op == 0:
            f = fp12_sqr(f)
        f = fp12_mul_line(f, gen_line)
        f = fp12_mul_line(f, pk_line)
    return f


def bls_committee_precomp_miller(hx, hy, sigx, sigy, sig_mask, table,
                                 pk_inf, valid, gen_lines=None):
    """Miller stage of the precomp committee audit: the G1 vote sums,
    then the table-fed Miller loop. Returns (f (B, 6, 2, 25), ok (B,)),
    ok False for invalid rows and identity sums."""
    from gethsharding_tpu_torch.ops import megakernels as mk

    sX, sY, sZ = mk.aggregate_proj(sigx, sigy, sig_mask, fp2=False)
    ok = valid & ~(FP.is_zero(sZ) | pk_inf)
    return miller_loop_precomp((sX, sY, sZ), hx, hy, table, gen_lines), ok


def bls_committee_precomp_finalexp(f, ok):
    """Final-exponentiation stage of the precomp committee audit."""
    from gethsharding_tpu_torch.ops import megakernels as mk

    return mk.finalexp_is_one(f) & ok


def bls_verify_committee_precomp_batch(hx, hy, sigx, sigy, sig_mask, table,
                                       pk_inf, valid, gen_lines=None):
    """The precomp twin of `bls_aggregate_verify_committee_batch`: the G2
    sums and the pubkey walk were paid once in `precompute_g2_lines`;
    this consumes their tables. Returns (B,) bool on the inputs' device."""
    f, ok = bls_committee_precomp_miller(hx, hy, sigx, sigy, sig_mask,
                                         table, pk_inf, valid, gen_lines)
    return bls_committee_precomp_finalexp(f, ok)
