"""The committee audit's three kernels: committee sums, Miller product and
final exponentiation, each as a CUDA kernel with its plain PyTorch twin.

The port's counterpart of the JAX package's `ops/pallas_finalexp.py`. The
arithmetic is the same self-contained wide relaxed form: field elements
are 25 little-endian 12-bit limbs in int32, normalized by value-preserving
carry rounds to quasi-canonical limbs in [-1, 2^12 + 64], with the same
fold, lift and pad constants, so the bound proofs carry over unchanged.

Layout at the public functions is the JAX package's: batch first, limbs
last, Fp (..., NL), Fp2 (..., 2, NL), Fp12 (..., 6, 2, NL), NL the
ambient form's limbs (`limb.NLIMBS`: 25 wide, 22 exact). As there, the
kernels and their plain versions work at 25 limbs in both forms: an exact
form's 22-limb operand widens losslessly with zero limbs on the way in,
and `FP.normalize` (the exact-branch kernel on the card) brings every
result back to the ambient form. The plain helpers below work on the
limbs-last layout too (the JAX helpers put the batch on the minor axis;
the values are the same limb for limb).

Each public function (`aggregate_proj`, `miller_f`, `finalexp_is_one`)
takes its route from the device of its inputs (`ops/route.py`): a CUDA
tensor goes through the hand-written kernel in `csrc/` (built by
`ops/_build.py`), a CPU tensor through the plain version; inside
`route.plain_versions()` the plain versions run on any device, and
`chip_smoke.py` holds every kernel against them on the card. The kernels follow the plain versions
operation for operation, so both give the same limbs, not only the same
values mod p.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as ref
from gethsharding_tpu_torch.ops import route
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops._build import Kernel, check_tensor, ptr
from gethsharding_tpu_torch.ops.limb import (LIMB_BITS, LIMB_MASK, NLIMBS,
                                             const, int_to_limbs, pad_last)

P = ref.P
KNL = 25                      # kernel limb count (wide form)
KFOLD_BASE = 22
KFOLD_ROWS = 33
KNCOLS = 2 * KNL - 1          # schoolbook product columns (49)

# == constant tables (same formulas and shapes as the JAX package's) =======

_FOLD_J = np.stack(
    [int_to_limbs(pow(1 << (LIMB_BITS * (KFOLD_BASE + k)), 1, P), KFOLD_BASE)
     for k in range(KFOLD_ROWS)]).astype(np.int32)          # (33, 22)

# lift added after the fold: a multiple of p covering the worst-case
# negative fold and low terms of quasi-canonical inputs
_DEFICIT = KFOLD_ROWS * 113 * P + (113 << 253)
_LIFT_RELAXED = int_to_limbs(-(-_DEFICIT // P) * P, KNL)


def _widen(arr: np.ndarray) -> np.ndarray:
    """A limb table of the ambient form at the kernels' 25 limbs."""
    extra = KNL - arr.shape[-1]
    return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, extra)])


def _pad_mult(bits: int) -> np.ndarray:
    value = -(-(1 << bits) // P) * P
    nlimbs = -(-value.bit_length() // LIMB_BITS)
    return int_to_limbs(value, nlimbs)


_PAD547 = _pad_mult(547)      # >= two subtracted lazy products (46 limbs)
_PAD274 = _pad_mult(274)      # >= one lazy element (value < 2^273)


def _rows(vec: np.ndarray, width: int) -> np.ndarray:
    out = np.zeros((width, 1), np.int32)
    out[: vec.shape[0], 0] = vec
    return out


# accumulator pads: the real component subtracts <= 2 products per group
_MUL_PAD = np.zeros((2, 1, KNCOLS, 1), np.int32)   # fp12 product (c, g, cols)
_MUL_PAD[0, 0] = _rows(_PAD547, KNCOLS)
_FP2_PAD = np.zeros((2, KNCOLS, 1), np.int32)      # fp2 product
_FP2_PAD[0] = _rows(_PAD547, KNCOLS)
_NEG_PAD = _rows(_PAD274, KNL)                     # negation and differences


# Frobenius constants gamma_{n,k} = xi^(k(p^n-1)/6)
_GAMMA = _widen(np.stack([bn._GAMMA[n] for n in (1, 2, 3)]))  # (3, 6, 2, 25)
_B3_G2 = _widen(bn._B3_G2_LIMBS)                    # 3·b' of the twist

# cyclic convolution of the w-basis product: output k takes operand
# j = (k - i) mod 6 of y when i <= k, of xi·y on wrap-around
_CONV_J = np.array([[(k - i) % 6 for i in range(6)] for k in range(6)])
_CONV_SEL = np.array([[0 if i + (k - i) % 6 == k else 1 for i in range(6)]
                      for k in range(6)])

# sparse line product: the line A + B·w + C·w^3 has w-degrees 0, 1, 3
_KLINE_POS = np.array([0, 1, 3])
_KLINE_J = np.array([[(k - d) % 6 for d in _KLINE_POS] for k in range(6)])
_KLINE_SEL = np.array([[0 if k - d >= 0 else 1 for d in _KLINE_POS]
                       for k in range(6)])
# group 0 accumulates terms A and B, group 1 term C; the real rows pad
_LINE_PAD = np.zeros((2, 2, KNCOLS, 1), np.int32)  # (c, g, cols, 1)
_LINE_PAD[0, 0] = _rows(_PAD547, KNCOLS)
_LINE_PAD[0, 1] = _rows(_PAD547, KNCOLS)

_ONE12 = np.zeros((6, 2, KNL, 1), np.int32)
_ONE12[0, 0, 0, 0] = 1


class Consts(NamedTuple):
    """The plain helpers' numeric constants as tensors on one device, in
    the limbs-last layout."""

    fold: Any     # (33, 22)  row k: 2^(12(22+k)) mod p
    lift: Any     # (25,)     relaxed lift (multiple of p)
    mulpad: Any   # (2, 1, 49) fp12-product group pad (real rows only)
    fp2pad: Any   # (2, 49)   fp2-product pad
    negpad: Any   # (25,)     negation pad (multiple of p >= 2^274)
    gamma: Any    # (3, 6, 2, 25) Frobenius gamma_{n,k}
    linepad: Any  # (2, 2, 49) sparse line-product group pad
    one12: Any    # (6, 2, 25) the fp12 identity


_NP_CONSTS = Consts(
    fold=_FOLD_J, lift=_LIFT_RELAXED, mulpad=_MUL_PAD[..., 0],
    fp2pad=_FP2_PAD[..., 0], negpad=_NEG_PAD[..., 0], gamma=_GAMMA,
    linepad=_LINE_PAD[..., 0], one12=_ONE12[..., 0])


def consts(device) -> Consts:
    return Consts(*(const(c, device) for c in _NP_CONSTS))


# == plain helpers: (..., W) limbs-last ====================================


def _round(z):
    """One width-preserving relaxed carry round; the top limb keeps its
    own carry, so the value is preserved exactly."""
    lo = z & LIMB_MASK
    c = z >> LIMB_BITS           # arithmetic shift: negative carries borrow
    out = lo + torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)
    out[..., -1] += c[..., -1] * (1 << LIMB_BITS)
    return out


def _normalize(z, C: Consts):
    """Relaxed normalize: (..., W) accumulator (|limb| < 2^30.7, value
    >= 0) -> (..., 25) quasi-canonical limbs in [-1, 2^12+64], value
    preserved mod p: 2 rounds, fold, lift, 3 rounds."""
    w = z.shape[-1]
    if w > KFOLD_BASE + KFOLD_ROWS - 2:
        raise ValueError(f"accumulator too wide: {w}")
    z = _round(_round(pad_last(z, w + 2)))
    hi = z[..., KFOLD_BASE:]
    fold = (hi.unsqueeze(-1) * C.fold[: hi.shape[-1]]).sum(
        dim=-2, dtype=torch.int32)
    acc = pad_last(z[..., :KFOLD_BASE] + fold, KNL) + C.lift
    return _round(_round(_round(acc)))


def _conv(u, v):
    """Schoolbook columns: (..., 25) x (..., 25) -> (..., 49), leading
    dims broadcast. Row l of the product, padded to 50 and re-viewed at
    width 49, puts element (l, m) at column l + m."""
    prod = u.unsqueeze(-1) * v.unsqueeze(-2)               # (..., 25, 25)
    lead = prod.shape[:-2]
    flat = pad_last(prod, 2 * KNL).reshape(lead + (KNL * 2 * KNL,))
    cols = flat[..., : KNL * KNCOLS].reshape(lead + (KNL, KNCOLS))
    return cols.sum(dim=-2, dtype=torch.int32)


def _mul_xi(y, C: Consts):
    """xi-multiple of every Fp2 coefficient: y (..., 6, 2, 25)."""
    a = y[..., 0, :]
    b = y[..., 1, :]
    rr = a * 9 - b + C.negpad
    ii = a + b * 9
    return _normalize(torch.stack([rr, ii], dim=-2), C)


def _fp12_mul(x, y, C: Consts):
    """w-basis fp12 product, componentwise over leading dims: cyclic
    convolution with xi wrap, (component, group) accumulators, one
    normalize, two-level group merge. x, y (..., 6, 2, 25)."""
    xiy = _mul_xi(y, C)
    w = torch.stack([y, xiy], dim=-4)                      # (..., 2, 6, 2, 25)
    sel = torch.as_tensor(_CONV_SEL, device=x.device)
    j = torch.as_tensor(_CONV_J, device=x.device)
    op = w[..., sel, j, :, :]                              # (..., 6k, 6i, 2, 25)
    xe = x[..., None, :, :, None, :]                       # (..., 1, 6i, 2a, 1, 25)
    ve = op[..., :, :, None, :, :]                         # (..., 6k, 6i, 1, 2b, 25)
    cols = _conv(xe, ve)                                   # (..., 6, 6, 2, 2, 49)
    re = cols[..., 0, 0, :] - cols[..., 1, 1, :]           # (..., 6, 6, 49)
    im = cols[..., 0, 1, :] + cols[..., 1, 0, :]
    re_g = re[..., 0::2, :] + re[..., 1::2, :]             # (..., 6, 3, 49)
    im_g = im[..., 0::2, :] + im[..., 1::2, :]
    acc = torch.stack([re_g, im_g], dim=-3) + C.mulpad     # (..., 6, 2, 3, 49)
    parts = _normalize(acc, C)
    merged = _normalize(parts[..., 0, :] + parts[..., 1, :], C)
    return _normalize(merged + parts[..., 2, :], C)


def _frob(x, n: int, C: Consts):
    """f^(p^n), n in {1, 2, 3}: conjugate (n odd), then multiply each
    w-coefficient by gamma_{n,k}. x (..., 6, 2, 25)."""
    a = x[..., 0, :]
    b = x[..., 1, :]
    b_in = C.negpad - b if n % 2 == 1 else b
    coeff = _normalize(torch.stack([a, b_in], dim=-2), C)
    g = C.gamma[n - 1]                                     # (6, 2, 25)
    ga, gb = g[..., 0, :], g[..., 1, :]
    ca, cb = coeff[..., 0, :], coeff[..., 1, :]
    rr = _conv(ca, ga) - _conv(cb, gb)
    ii = _conv(ca, gb) + _conv(cb, ga)
    return _normalize(torch.stack([rr, ii], dim=-2) + C.fp2pad, C)


def _swap(x):
    """Fraction inverse: exchange numerator and denominator, the axis
    before the fp12 value: x (..., 2, 6, 2, 25)."""
    return x.flip(-4)


def _fp2_add(x, y, C: Consts):
    return _normalize(x + y, C)


def _fp2_sub(x, y, C: Consts):
    return _normalize(x - y + C.negpad, C)


def _fp2_neg(x, C: Consts):
    return _normalize(C.negpad - x, C)


def _fp2_scalar(x, k: int, C: Consts):
    return _normalize(x * k, C)


def _fp2_mul(x, y, C: Consts):
    """(a+bi)(c+di) = (ac - bd) + (ad + bc)i: x, y (..., 2, 25)."""
    a, b = x[..., 0, :], x[..., 1, :]
    c, d = y[..., 0, :], y[..., 1, :]
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    cols = _conv(torch.stack([a, b, a, b], dim=-2),
                 torch.stack([c, d, d, c], dim=-2))        # (..., 4, 49)
    rr = cols[..., 0, :] - cols[..., 1, :] + C.fp2pad[0]
    ii = cols[..., 2, :] + cols[..., 3, :]
    return _normalize(torch.stack([rr, ii], dim=-2), C)


def _fp2_sqr(x, C: Consts):
    return _fp2_mul(x, x, C)


def _fp2_mul_fp(x, s, C: Consts):
    """Fp2 x (..., 2, 25) times Fp s (..., 25)."""
    return _normalize(_conv(x, s[..., None, :]), C)


def _fp2_conj_rows(x, C: Consts):
    return _normalize(torch.stack([x[..., 0, :], C.negpad - x[..., 1, :]],
                                  dim=-2), C)


def _fp12_mul_line(f, A, B, Cc, C: Consts):
    """f · (A + B·w + C·w^3), sparse: 72 plane pairs instead of 144.
    f (..., 6, 2, 25); A, B, Cc (..., 2, 25) line terms."""
    xif = _mul_xi(f, C)
    w = torch.stack([f, xif], dim=-4)                      # (..., 2, 6, 2, 25)
    sel = torch.as_tensor(_KLINE_SEL, device=f.device)
    j = torch.as_tensor(_KLINE_J, device=f.device)
    op = w[..., sel, j, :, :]                              # (..., 6k, 3t, 2, 25)
    lstack = torch.stack(torch.broadcast_tensors(A, B, Cc), dim=-3)
    le = lstack[..., None, :, :, None, :]                  # (..., 1, 3, 2a, 1, 25)
    ve = op[..., :, :, None, :, :]                         # (..., 6, 3, 1, 2b, 25)
    cols = _conv(le, ve)                                   # (..., 6, 3, 2, 2, 49)
    re = cols[..., 0, 0, :] - cols[..., 1, 1, :]           # (..., 6, 3, 49)
    im = cols[..., 0, 1, :] + cols[..., 1, 0, :]
    re_g = torch.stack([re[..., 0, :] + re[..., 1, :], re[..., 2, :]], dim=-2)
    im_g = torch.stack([im[..., 0, :] + im[..., 1, :], im[..., 2, :]], dim=-2)
    acc = torch.stack([re_g, im_g], dim=-3) + C.linepad    # (..., 6, 2c, 2g, 49)
    parts = _normalize(acc, C)
    return _normalize(parts[..., 0, :] + parts[..., 1, :], C)


def _kernel_dbl_step(X, Y, Z, px, py, C: Consts):
    """Tangent step on the twist in Jacobian coordinates, with its line
    coefficients evaluated at (px, py)."""
    A = _fp2_sqr(X, C)
    Bq = _fp2_sqr(Y, C)
    Cq = _fp2_sqr(Bq, C)
    t = _fp2_sqr(_fp2_add(X, Bq, C), C)
    D = _fp2_scalar(_fp2_sub(_fp2_sub(t, A, C), Cq, C), 2, C)
    E = _fp2_scalar(A, 3, C)
    F = _fp2_sqr(E, C)
    X3 = _fp2_sub(F, _fp2_scalar(D, 2, C), C)
    Y3 = _fp2_sub(_fp2_mul(E, _fp2_sub(D, X3, C), C),
                  _fp2_scalar(Cq, 8, C), C)
    ZZ = _fp2_sqr(Z, C)
    Z3 = _fp2_scalar(_fp2_mul(Y, Z, C), 2, C)
    c_py = _fp2_mul(Z3, ZZ, C)
    c_px = _fp2_neg(_fp2_mul(E, ZZ, C), C)
    c_const = _fp2_sub(_fp2_mul(E, X, C), _fp2_scalar(Bq, 2, C), C)
    line = (_fp2_mul_fp(c_py, py, C), _fp2_mul_fp(c_px, px, C), c_const)
    return line, X3, Y3, Z3


def _kernel_jadd_step(X1, Y1, Z1, cand, px, py, C: Consts):
    """Full Jacobian chord step; cand = (x2, y2, z2, zz2, zzz2)."""
    x2, y2, z2, zz2, zzz2 = cand
    Z1Z1 = _fp2_sqr(Z1, C)
    U1 = _fp2_mul(X1, zz2, C)
    U2 = _fp2_mul(x2, Z1Z1, C)
    S1 = _fp2_mul(Y1, zzz2, C)
    S2 = _fp2_mul(y2, _fp2_mul(Z1, Z1Z1, C), C)
    H = _fp2_sub(U2, U1, C)
    R = _fp2_sub(S2, S1, C)
    HH = _fp2_sqr(H, C)
    V = _fp2_mul(U1, HH, C)
    HHH = _fp2_mul(H, HH, C)
    X3 = _fp2_sub(_fp2_sub(_fp2_sqr(R, C), HHH, C),
                  _fp2_scalar(V, 2, C), C)
    Y3 = _fp2_sub(_fp2_mul(R, _fp2_sub(V, X3, C), C),
                  _fp2_mul(S1, HHH, C), C)
    Z3 = _fp2_mul(_fp2_mul(Z1, z2, C), H, C)
    c_const = _fp2_sub(_fp2_mul(_fp2_mul(X1, y2, C), Z1, C),
                       _fp2_mul(_fp2_mul(x2, Y1, C), z2, C), C)
    line = (_fp2_mul_fp(Z3, py, C), _fp2_mul_fp(_fp2_neg(R, C), px, C),
            c_const)
    return line, X3, Y3, Z3


def _miller_candidates(pkx, pky, pkz, twf, C: Consts):
    """The four Jacobian add candidates [+Q, -Q, pi Q, -pi^2 Q] with their
    z-power precomputes: (x·z, y·z^2, z, z^2, z^3) each. +Q, -Q and
    -pi^2 Q share z, so their z-powers (and x·z of ±Q) are computed once,
    as the kernel's preamble does."""
    q1x = _fp2_mul(_fp2_conj_rows(pkx, C), twf[0], C)
    q1y = _fp2_mul(_fp2_conj_rows(pky, C), twf[1], C)
    q2x = _fp2_mul(pkx, twf[2], C)
    q2ny = _fp2_neg(_fp2_mul(pky, twf[3], C), C)
    zconj = _fp2_conj_rows(pkz, C)
    z0, zc = _normalize(pkz, C), _normalize(zconj, C)
    zz0, zzc = _fp2_sqr(pkz, C), _fp2_sqr(zconj, C)
    zzz0 = _fp2_mul(pkz, zz0, C)
    c0x = _fp2_mul(pkx, pkz, C)
    return [
        (c0x, _fp2_mul(pky, zz0, C), z0, zz0, zzz0),
        (c0x, _fp2_mul(_fp2_neg(pky, C), zz0, C), z0, zz0, zzz0),
        (_fp2_mul(q1x, zconj, C), _fp2_mul(q1y, zzc, C), zc, zzc,
         _fp2_mul(zconj, zzc, C)),
        (_fp2_mul(q2x, pkz, C), _fp2_mul(q2ny, zz0, C), z0, zz0, zzz0),
    ]


def _agg_tree(px, py, pz, C: Consts, *, fp2: bool, b3):
    """(2^k, ...) point stacks -> their projective sum by RCB16 complete
    additions (a = 0), halving per level. b3: 9 for G1, Fp2 limbs for G2."""
    if fp2:
        mul = lambda a, b: _fp2_mul(a, b, C)
        mul_b3 = lambda v: _fp2_mul(v, b3, C)
    else:
        mul = lambda a, b: _normalize(_conv(a, b), C)
        mul_b3 = lambda v: _normalize(v * b3, C)
    add = lambda a, b: _normalize(a + b, C)
    sub = lambda a, b: _normalize(a - b + C.negpad, C)

    def proj_add(p1, p2):
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        t0 = mul(x1, x2)
        t1 = mul(y1, y2)
        t2 = mul(z1, z2)
        t3 = sub(mul(add(x1, y1), add(x2, y2)), add(t0, t1))
        t4 = sub(mul(add(y1, z1), add(y2, z2)), add(t1, t2))
        t5 = sub(mul(add(x1, z1), add(x2, z2)), add(t0, t2))
        t0 = add(add(t0, t0), t0)
        t2 = mul_b3(t2)
        zs = add(t1, t2)
        t1 = sub(t1, t2)
        yb = mul_b3(t5)
        return (sub(mul(t3, t1), mul(t4, yb)),
                add(mul(t1, zs), mul(t0, yb)),
                add(mul(zs, t4), mul(t0, t3)))

    while px.shape[0] > 1:
        half = px.shape[0] // 2
        px, py, pz = proj_add((px[:half], py[:half], pz[:half]),
                              (px[half:], py[half:], pz[half:]))
    return px[0], py[0], pz[0]


# == program tables ========================================================
# final exponentiation ops: 0 = mul(ra, rb) -> rd; 1 = swap(ra) -> rd;
# 2 = frob_b(ra) -> rd (n in the b field); 3 = copy(ra) -> rd. Registers:
# 14 fraction-stacked fp12 values; r0 holds the easy-part input, r1..r3
# the x^u ladder results, r4.. the hard-part temps, r13 the result.

_N_REGS = 14
_RESULT_REG = 13


def _build_program() -> np.ndarray:
    prog = [
        (2, 0, 2, 4),   # r4 = frob2(nd)
        (0, 4, 0, 0),   # nd = frob2(nd) * nd   (easy part, p^2+1)
    ]
    digits = list(reversed(bn._U_NAF[:-1].tolist()))
    for s, d in ((0, 1), (1, 2), (2, 3)):   # fu, fu2, fu3
        prog.append((1, s, 0, 4))           # r4 = swap(x): x^-1 for NAF
        prog.append((3, s, 0, d))           # acc = x  (top NAF digit = 1)
        for dig in digits:
            prog.append((0, d, d, d))       # acc = acc^2
            if dig == 1:
                prog.append((0, d, s, d))
            elif dig == -1:
                prog.append((0, d, 4, d))
    for op, a, b, dst in bn._HARD_PROGRAM.tolist():
        if op == 0:
            prog.append((0, a, b, dst))
        elif op == 1:
            prog.append((0, a, a, dst))     # sqr = mul(a, a)
        elif op == 2:
            prog.append((1, a, 0, dst))     # cyclotomic inverse = swap
        else:
            prog.append((2, a, op - 2, dst))
    return np.asarray(prog, np.int32)


def _miller_tables():
    """(ops, gen_lines, twf): the optimal-ate schedule (88,), its
    generator-line constants (88, 3, 2, 25) and the twist-Frobenius
    constants (4, 2, 25)."""
    ops = np.asarray(bn._OPT_OPS, np.int32)
    lines = _widen(np.asarray(bn._GEN_LINES, np.int32))
    twf = _widen(np.stack([bn._TWF_X, bn._TWF_Y, bn._TWF2_X,
                           bn._TWF2_Y]).astype(np.int32))
    return ops, lines, twf


_PROGRAM = _build_program()
_MILLER_OPS, _MILLER_LINES, _MILLER_TWF = _miller_tables()

# == plain versions of the three kernels ===================================


def _apply_op(regs, op, a, b, d, C: Consts):
    ra = regs[a]
    if op == 0:
        out = _fp12_mul(ra, regs[b], C)
    elif op == 1:
        out = _swap(ra)
    elif op == 2:
        out = _frob(ra, b, C)
    else:
        out = ra
    regs[d] = out


def _program(prog) -> np.ndarray:
    """`prog` as (steps, 4) int32 rows (op, a, b, d) over the 14 registers,
    checked (0 = mul, 1 = swap, 2 = frob_b with b in 1..3, 3 = copy); the
    audit's program where None."""
    if prog is None:
        return _PROGRAM
    p = np.asarray(prog, np.int32).reshape(-1, 4)
    op, regs = p[:, 0], p[:, 1:]
    frob_n = p[op == 2, 2]
    if ((op < 0) | (op > 3)).any() or ((regs < 0) | (regs >= _N_REGS)).any() \
            or ((frob_n < 1) | (frob_n > 3)).any():
        raise ValueError("program rows are (op 0-3, a, b, d) over "
                         f"{_N_REGS} registers, b in 1-3 for op 2")
    return p


def run_program_plain(nd, prog=None):
    """The whole final-exponentiation program (or `prog`, rows (op, a, b,
    d)) on nd (n, 2, 6, 2, 25): the fraction-stacked easy-part input
    conj(f)/f. Returns the result register, same layout, quasi-canonical
    limbs."""
    C = consts(nd.device)
    regs = [nd] + [torch.zeros_like(nd) for _ in range(_N_REGS - 1)]
    for op, a, b, d in _program(prog).tolist():
        _apply_op(regs, op, a, b, d, C)
    return regs[_RESULT_REG]


def _miller_body(state, op, line_c, ctx, C: Consts):
    f, X, Y, Z = state
    sx, sy, sz, hx, hy_neg, cand = ctx
    gen = (_fp2_mul_fp(line_c[0], sy, C),
           _fp2_mul_fp(line_c[1], sx, C),
           _fp2_mul_fp(line_c[2], sz, C))
    if op == 0:
        line1, X, Y, Z = _kernel_dbl_step(X, Y, Z, hx, hy_neg, C)
        f = _fp12_mul(f, f, C)
    else:
        line1, X, Y, Z = _kernel_jadd_step(X, Y, Z, cand[op - 1], hx,
                                           hy_neg, C)
    f = _fp12_mul_line(f, *gen, C)
    f = _fp12_mul_line(f, *line1, C)
    return f, X, Y, Z


def run_miller_plain(sig, h, pk):
    """The Miller program: sig = (sx, sy, sz) each (n, 25); h = (hx, hy)
    each (n, 25); pk = (pkx, pky, pkz) each (n, 2, 25). Returns f
    (n, 6, 2, 25), quasi-canonical limbs."""
    sx, sy, sz = sig
    hx, hy = h
    pkx, pky, pkz = pk
    C = consts(sx.device)
    lines = const(_MILLER_LINES, sx.device)
    twf = const(_MILLER_TWF, sx.device)
    hy_neg = _normalize(C.negpad - hy, C)
    cand = _miller_candidates(pkx, pky, pkz, twf, C)
    f = C.one12.expand(sx.shape[:-1] + C.one12.shape).clone()
    ctx = (sx, sy, sz, hx, hy_neg, cand)
    state = (f,) + cand[0][:3]          # the walk starts at +Q: (x·z, y·z^2, z)
    for i, op in enumerate(_MILLER_OPS.tolist()):
        state = _miller_body(state, op, lines[i], ctx, C)
    return state[0]


def run_agg_plain(xs, ys, mask, *, fp2: bool):
    """Masked committee sum: xs/ys (n, C, 25) or (n, C, 2, 25), mask
    (n, C) bool. The committee pads with identity slots to a power of
    two. Returns projective (X, Y, Z), quasi-canonical limbs."""
    C = consts(xs.device)
    n, cdim = xs.shape[:2]
    point = xs.shape[2:]
    extra = _committee_pad(cdim) - cdim
    if extra:   # pad slots are masked off: they become the identity
        xs = torch.cat([xs, xs.new_zeros((n, extra) + point)], dim=1)
        ys = torch.cat([ys, ys.new_zeros((n, extra) + point)], dim=1)
        mask = torch.cat([mask, mask.new_zeros((n, extra))], dim=1)
    m = mask.reshape(mask.shape + (1,) * len(point))
    one = torch.zeros(point, dtype=torch.int32, device=xs.device)
    one.view(-1)[0] = 1
    px = torch.where(m, xs, 0).movedim(1, 0)               # (cp, n, ...)
    py = torch.where(m, ys, one).movedim(1, 0)
    pz = torch.where(m, one, 0).movedim(1, 0)
    b3 = const(_B3_G2, xs.device) if fp2 else 9
    return _agg_tree(px, py, pz, C, fp2=fp2, b3=b3)


def _committee_pad(cdim: int) -> int:
    return 1 << max(1, (cdim - 1).bit_length())


# == the kernels ===========================================================


# the four kernels of the committee audit (`_build.KERNELS` lists every
# kernel of the port)
KERNELS = {
    "agg_g1": Kernel("agg_g1", "gs_agg_g1", "gethsharding_tpu_torch/csrc/agg.cu",
                     "gethsharding_tpu/ops/pallas_finalexp.py:1062"),
    "agg_g2": Kernel("agg_g2", "gs_agg_g2", "gethsharding_tpu_torch/csrc/agg.cu",
                     "gethsharding_tpu/ops/pallas_finalexp.py:1062"),
    "miller": Kernel("miller", "gs_miller",
                     "gethsharding_tpu_torch/csrc/miller.cu",
                     "gethsharding_tpu/ops/pallas_finalexp.py:873"),
    "finalexp": Kernel("finalexp", "gs_finalexp",
                       "gethsharding_tpu_torch/csrc/finalexp.cu",
                       "gethsharding_tpu/ops/pallas_finalexp.py:488"),
}


def _kernel_consts(device) -> torch.Tensor:
    """The constant pack every kernel copies into shared memory (layout
    fixed by `csrc/field.cuh`): fold, lift, pad547, negpad, gamma, 3·b'."""
    return const(_CONST_PACK, device)


_CONST_PACK = np.concatenate([
    _FOLD_J.ravel(), _LIFT_RELAXED, _rows(_PAD547, KNCOLS)[:, 0],
    _NEG_PAD[:, 0], _GAMMA.ravel(), _B3_G2.ravel()]).astype(np.int32)
if _CONST_PACK.shape != (1775,):   # C_TOTAL of csrc/field.cuh
    raise RuntimeError(f"constant pack has {_CONST_PACK.shape[0]} ints")


def agg_kernel(xs, ys, mask, *, fp2: bool):
    """Launch the committee-sum kernel: xs/ys (n, C, [2,] 25) int32,
    mask (n, C) int32. Returns (X, Y, Z) each (n, [2,] 25), quasi-
    canonical limbs, equal to `run_agg_plain` limb for limb."""
    n, cdim = xs.shape[:2]
    point = (2, KNL) if fp2 else (KNL,)
    check_tensor(xs, (n, cdim) + point, "xs")
    check_tensor(ys, (n, cdim) + point, "ys")
    check_tensor(mask, (n, cdim), "mask")
    cp = _committee_pad(cdim)
    scratch = torch.empty((n, cp, 3) + point, dtype=torch.int32,
                          device=xs.device)
    out = [torch.empty((n,) + point, dtype=torch.int32, device=xs.device)
           for _ in range(3)]
    if n == 0:
        return tuple(out)
    KERNELS["agg_g2" if fp2 else "agg_g1"].launch(
        ptr(xs), ptr(ys), ptr(mask), n, cdim, cp,
        ptr(_kernel_consts(xs.device)), ptr(scratch), *map(ptr, out))
    return tuple(out)


def miller_kernel(sig, h, pk):
    """Launch the Miller kernel on (n, 25) / (n, 2, 25) int32 planes;
    returns f (n, 6, 2, 25), equal to `run_miller_plain` limb for limb."""
    n = sig[0].shape[0]
    for i, v in enumerate(sig + h):
        check_tensor(v, (n, KNL), f"fp plane {i}")
    for i, v in enumerate(pk):
        check_tensor(v, (n, 2, KNL), f"fp2 plane {i}")
    dev = sig[0].device
    out = torch.empty((n, 6, 2, KNL), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    KERNELS["miller"].launch(
        *map(ptr, sig + h + pk), ptr(const(_MILLER_OPS, dev)),
        len(_MILLER_OPS), ptr(const(_MILLER_LINES, dev)),
        ptr(const(_MILLER_TWF, dev)), ptr(_kernel_consts(dev)), n,
        ptr(out))
    return out


@functools.lru_cache(maxsize=16)
def _program_on(rows: bytes, device: str) -> torch.Tensor:
    """A checked program's rows on `device`, made once per program."""
    return torch.as_tensor(np.frombuffer(rows, np.int32).reshape(-1, 4).copy(),
                           device=device)


def finalexp_kernel(nd, prog=None):
    """Launch the final-exponentiation kernel on nd (n, 2, 6, 2, 25)
    int32 (row-major per batch row) over the audit's program, or `prog`
    as in `run_program_plain`; returns the result register in the same
    layout, equal to `run_program_plain(nd, prog)` limb for limb."""
    n = nd.shape[0]
    check_tensor(nd, (n, 2, 6, 2, KNL), "nd")
    rows = _program(prog)
    dev = nd.device
    out = torch.empty_like(nd)
    if n == 0:
        return out
    p = const(_PROGRAM, dev) if prog is None \
        else _program_on(rows.tobytes(), str(dev))
    KERNELS["finalexp"].launch(ptr(nd), ptr(p), len(rows),
                               ptr(_kernel_consts(dev)), n, ptr(out))
    return out


# == public functions ======================================================


def _i32(t) -> torch.Tensor:
    """An ambient-form operand as the kernels take it: int32, 25 limbs
    (an exact form's 22 widen with zero limbs), contiguous."""
    return pad_last(t.to(torch.int32), KNL).contiguous()


def aggregate_proj(xs, ys, mask, *, fp2: bool):
    """Masked committee sum (JAX package's `aggregate_proj`).

    xs/ys: (..., C, NL) G1 or (..., C, 2, NL) G2 affine limbs; mask
    (..., C) bool. Returns projective (X, Y, Z) in the lazy form of
    `ops/limb.py`."""
    point_rank = 3 if fp2 else 2
    lead = xs.shape[:-point_rank]
    cdim = xs.shape[len(lead)]
    point = xs.shape[len(lead) + 1:]
    xs2 = _i32(xs.reshape((-1, cdim) + point))
    ys2 = _i32(ys.reshape((-1, cdim) + point))
    m2 = mask.reshape(-1, cdim)
    if route.use_kernel(xs2):
        out = agg_kernel(xs2, ys2, m2.to(torch.int32).contiguous(), fp2=fp2)
    else:
        out = run_agg_plain(xs2, ys2, m2.to(torch.bool), fp2=fp2)
    out = bn.FP.normalize(torch.stack(out))
    return tuple(v.reshape(lead + point[:-1] + (NLIMBS,)) for v in out)


def miller_f(sig, hx, hy, pk):
    """Projective shared-accumulator Miller product e(sig, G2)·e(-H, pk)
    before the final exponentiation (JAX package's `miller_f`): sig =
    (sx, sy, sz) (..., NL), hx/hy (..., NL), pk = (pkx, pky, pkz)
    (..., 2, NL). Returns f (..., 6, 2, NL) in the lazy form."""
    lead = sig[0].shape[:-1]
    flat = lambda v: _i32(v.reshape((-1,) + v.shape[len(lead):]))
    s = tuple(map(flat, sig))
    h = (flat(hx), flat(hy))
    q = tuple(map(flat, pk))
    if route.use_kernel(s[0]):
        f = miller_kernel(s, h, q)
    else:
        f = run_miller_plain(s, h, q)
    return bn.FP.normalize(f).reshape(lead + (6, 2, NLIMBS))


def finalexp_is_one(f):
    """Fraction-stacked final exponentiation == 1? (JAX package's
    `finalexp_is_one`): f (..., 6, 2, NL) lazy limbs -> bool (...)."""
    lead = f.shape[:-3]
    f = f.reshape((-1, 6, 2, NLIMBS)).to(torch.int32)
    nd = _i32(torch.stack([bn.fp12_conj(f), bn.FP.normalize(f)], dim=1))
    if route.use_kernel(f):
        out = finalexp_kernel(nd)
    else:
        out = run_program_plain(nd)
    out = bn.FP.normalize(out)
    return bn.fp12_eq(out[:, 0], out[:, 1]).reshape(lead)
