"""Batched secp256k1 public-key recovery: `csrc/secp256k1.cu` and its plain
PyTorch version.

The port's counterpart of the JAX package's `ops/secp256k1_jax.py`
(`ecrecover_batch`, an XLA computation there, no Pallas kernel). Given
(e, r, s, recid) with R = lift_x(r, recid), the recovered key is
Q = r⁻¹·(s·R - e·G), computed as the joint ladder u1·G + u2·R with
u1 = -e·r⁻¹ mod n and u2 = s·r⁻¹ mod n.

- `ecrecover_plain` is the reference's math on the port's `ModArith`
  (12-bit limbs, `ops/limb.py`): the 256-step branchless Shamir ladder as
  a Python loop, Jacobian points with the same complete-ized `_pt_add`
  (P = Q doubles, P = -Q is infinity, infinity operands pass through),
  and the same `ok` rule. Its limbs equal the reference's; it computes
  the doubling inside `_pt_add` only where some row selects it.
- `ecrecover_kernel` launches the hand-written kernel: a group of 8 lanes
  per row, each lane making one product of a ladder phase in registers
  (8 × 32-bit words, p's special form), CIOS Montgomery products mod n.
  It returns the same canonical (qx, qy) and `ok`: the same formulas up
  to polynomial identities and the same cases, and the outputs are
  canonical.
- `ecrecover_batch` is the route (`ops/route.py`): the kernel for a CUDA
  tensor, the plain version for a CPU tensor and inside
  `route.plain_versions()`.

The host converters keep the reference's limb planes at this boundary:
e, r, s (..., NLIMBS) int32, recid (...,) int32, valid (...,) bool.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import secp256k1 as ref
from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.limb import (NLIMBS, ModArith, const,
                                             int_to_limbs, ints_to_limbs,
                                             limbs_to_int, lt_raw)

P = ref.P
N = ref.N
FQ = ModArith(P)   # base field
FN = ModArith(N)   # scalar field

_GX = int_to_limbs(ref.GX)
_GY = int_to_limbs(ref.GY)
_B7 = int_to_limbs(7)
_N_LIMBS = int_to_limbs(N)

KERNEL = _build.Kernel("ecrecover", "gs_ecrecover",
                       "gethsharding_tpu_torch/csrc/secp256k1.cu",
                       "gethsharding_tpu/ops/secp256k1_jax.py:136")


# == the plain version: Jacobian points on the limb engine =================
# A point is (X, Y, Z) limb tensors; infinity is Z = 0 (canonical (1, 1, 0)).


def _pt_double(X, Y, Z):
    """dbl-2009-l for a = 0. Infinity (Z = 0) stays infinity."""
    A = FQ.mul(X, X)
    Bv = FQ.mul(Y, Y)
    C = FQ.mul(Bv, Bv)
    t = FQ.mul(FQ.add(X, Bv), FQ.add(X, Bv))
    D = FQ.mul_small(FQ.sub(FQ.sub(t, A), C), 2)   # 4XY²
    E = FQ.mul_small(A, 3)
    F = FQ.mul(E, E)
    X3 = FQ.sub(F, FQ.mul_small(D, 2))
    Y3 = FQ.sub(FQ.mul(E, FQ.sub(D, X3)), FQ.mul_small(C, 8))
    Z3 = FQ.mul_small(FQ.mul(Y, Z), 2)
    return X3, Y3, Z3


def _pt_add(X1, Y1, Z1, X2, Y2, Z2):
    """Complete-ized Jacobian addition via selects: P2 = inf gives P1,
    P1 = inf gives P2, P1 = P2 doubles, P1 = -P2 is infinity, the generic
    chord otherwise."""
    Z1Z1 = FQ.mul(Z1, Z1)
    Z2Z2 = FQ.mul(Z2, Z2)
    U1 = FQ.mul(X1, Z2Z2)
    U2 = FQ.mul(X2, Z1Z1)
    S1 = FQ.mul(Y1, FQ.mul(Z2, Z2Z2))
    S2 = FQ.mul(Y2, FQ.mul(Z1, Z1Z1))
    H = FQ.sub(U2, U1)
    R = FQ.sub(S2, S1)

    HH = FQ.mul(H, H)
    HHH = FQ.mul(H, HH)
    V = FQ.mul(U1, HH)
    X3 = FQ.sub(FQ.sub(FQ.mul(R, R), HHH), FQ.mul_small(V, 2))
    Y3 = FQ.sub(FQ.mul(R, FQ.sub(V, X3)), FQ.mul(S1, HHH))
    Z3 = FQ.mul(FQ.mul(Z1, Z2), H)

    inf1 = FQ.is_zero(Z1)
    inf2 = FQ.is_zero(Z2)
    h_zero = FQ.is_zero(H)
    r_zero = FQ.is_zero(R)
    same_point = h_zero & r_zero & ~inf1 & ~inf2      # -> double
    opposite = h_zero & ~r_zero & ~inf1 & ~inf2       # -> infinity

    if same_point.any():    # the select keeps the chord where no row doubles
        dX, dY, dZ = _pt_double(X1, Y1, Z1)
        X3 = FQ.select(same_point, dX, X3)
        Y3 = FQ.select(same_point, dY, Y3)
        Z3 = FQ.select(same_point, dZ, Z3)
    Z3 = FQ.select(opposite, torch.zeros_like(Z3), Z3)
    X3 = FQ.select(inf1, X2, FQ.select(inf2, X1, X3))
    Y3 = FQ.select(inf1, Y2, FQ.select(inf2, Y1, Y3))
    Z3 = FQ.select(inf1, Z2, FQ.select(inf2, Z1, Z3))
    return X3, Y3, Z3


def _to_affine(X, Y, Z):
    zinv = FQ.inv(Z)
    zinv2 = FQ.mul(zinv, zinv)
    return FQ.mul(X, zinv2), FQ.mul(Y, FQ.mul(zinv, zinv2))


def _scalar_bits(k):
    """(..., NLIMBS) canonical limbs -> (..., 256) bits, LSB first."""
    shifts = torch.arange(12, dtype=torch.int32, device=k.device)
    bits = (k[..., :, None] >> shifts) & 1
    return bits.reshape(bits.shape[:-2] + (NLIMBS * 12,))[..., :256]


def ecrecover_plain(e, r, s, recid, valid):
    """`ecrecover_batch`'s math in plain PyTorch: e, r, s (..., NLIMBS)
    int32 limbs (digest, signature r, s), recid (...,) int32, valid (...,)
    bool. Returns (qx, qy, ok): the affine key's canonical limbs and the
    per-row success (False for r or s outside [1, n-1], an r with no curve
    point, a recid outside {0, 1}, an infinite result, or `valid` False).
    """
    dev = r.device
    # R = lift_x(r): y = (r³ + 7)^((p+1)/4), as p ≡ 3 mod 4
    rx = FQ.normalize(r)
    y_sq = FQ.add(FQ.mul(FQ.mul(rx, rx), rx), const(_B7, dev))
    ry = FQ.pow_static(y_sq, (P + 1) // 4)
    on_curve = FQ.eq(FQ.mul(ry, ry), y_sq)
    parity = FQ.canon(ry)[..., 0] & 1
    ry = FQ.select(parity == (recid.to(torch.int32) & 1), ry, FQ.neg(ry))

    # scalars: u1 = -e·r⁻¹ mod n, u2 = s·r⁻¹ mod n
    rn = FN.normalize(r)
    rinv = FN.inv(rn)
    u1 = FN.mul(FN.neg(FN.normalize(e)), rinv)
    u2 = FN.mul(FN.normalize(s), rinv)
    b1 = _scalar_bits(FN.canon(u1))
    b2 = _scalar_bits(FN.canon(u2))

    shape = r.shape
    gx = const(_GX, dev).expand(shape)
    gy = const(_GY, dev).expand(shape)
    one = const(FQ.one, dev).expand(shape)
    grx, gry, grz = _pt_add(gx, gy, one, rx, ry, one)

    # the ladder, MSB to LSB: acc = 2·acc + {0, G, R, G+R}
    X, Y, Z = one, one, torch.zeros_like(rx)
    for i in reversed(range(256)):
        X, Y, Z = _pt_double(X, Y, Z)
        t1, t2 = b1[..., i] == 1, b2[..., i] == 1
        both = t1 & t2
        aX = FQ.select(both, grx, FQ.select(t1, gx, rx))
        aY = FQ.select(both, gry, FQ.select(t1, gy, ry))
        aZ = FQ.select(both, grz, one)
        Xn, Yn, Zn = _pt_add(X, Y, Z, aX, aY, aZ)
        any_add = t1 | t2
        X = FQ.select(any_add, Xn, X)
        Y = FQ.select(any_add, Yn, Y)
        Z = FQ.select(any_add, Zn, Z)
    qx, qy = _to_affine(X, Y, Z)

    r_ok = ~FN.is_zero(rn) & lt_raw(r, _N_LIMBS)
    s_ok = ~FN.is_zero(FN.normalize(s)) & lt_raw(s, _N_LIMBS)
    ok = (valid & on_curve & r_ok & s_ok & (recid >= 0) & (recid < 2)
          & ~FQ.is_zero(Z))
    return FQ.canon(qx), FQ.canon(qy), ok


# == the kernel ============================================================


def ecrecover_kernel(e, r, s, recid, valid):
    """Launch `csrc/secp256k1.cu` on e, r, s (B, NLIMBS) int32 CUDA
    tensors of canonical limbs, recid (B,) int32 and valid (B,) bool;
    returns (qx, qy, ok) as `ecrecover_plain` gives them: (B, NLIMBS)
    canonical limbs and (B,) bool."""
    n = r.shape[0]
    for name, t in (("e", e), ("r", r), ("s", s)):
        _build.check_tensor(t, (n, NLIMBS), name)
    _build.check_tensor(recid, (n,), "recid")
    _build.check_tensor(valid, (n,), "valid", torch.bool)
    qx = torch.empty_like(r)
    qy = torch.empty_like(r)
    ok = torch.empty_like(valid)
    if n:
        KERNEL.launch(*map(_build.ptr, (e, r, s, recid, valid)), n, NLIMBS,
                      *map(_build.ptr, (qx, qy, ok)))
    return qx, qy, ok


def ecrecover_batch(e, r, s, recid, valid):
    """Batched recovery (the reference's `ecrecover_batch`): the kernel
    for CUDA tensors, the plain version for CPU tensors. Leading dims are
    the batch."""
    if not route.use_kernel(r):
        return ecrecover_plain(e, r, s, recid, valid)
    lead = r.shape[:-1]
    flat = lambda t, tail, dtype: t.reshape((-1,) + tail).to(
        dtype).contiguous()
    qx, qy, ok = ecrecover_kernel(
        flat(e, (NLIMBS,), torch.int32), flat(r, (NLIMBS,), torch.int32),
        flat(s, (NLIMBS,), torch.int32), flat(recid, (), torch.int32),
        flat(valid, (), torch.bool))
    return (qx.reshape(lead + (NLIMBS,)), qy.reshape(lead + (NLIMBS,)),
            ok.reshape(lead))


# == the kernel's work, for its bound =======================================

# Two counts of a row's work, as (squares, other products), since a square
# needs fewer multiply-adds. Both share the ladder: from the step after
# the top set bit (before it the accumulator is infinity: no doubling, and
# its first addition is a copy) a doubling per step and an addition per
# step with a bit set. A row whose accumulator meets its own addend or its
# negation (R = ±G) makes one more doubling there, or none after it
# returns to infinity; the counts leave those out.
DBL_PRODUCTS = (5, 2)                   # dbl-2009-l
ADD_PRODUCTS = {1: (3, 8), 2: (4, 12)}  # addend G or R (Z = 1), G + R


def _ladder_products(u1: int, u2: int) -> tuple[int, int]:
    top = max(u1.bit_length(), u2.bit_length())
    sq = pr = 0
    for i in range(top - 2, -1, -1):
        set_bits = ((u1 >> i) & 1) + ((u2 >> i) & 1)
        add = ADD_PRODUCTS.get(set_bits, (0, 0))
        sq += DBL_PRODUCTS[0] + add[0]
        pr += DBL_PRODUCTS[1] + add[1]
    return sq, pr


# The yardstick: the joint ladder on CIOS Montgomery products (the first
# port of csrc/secp256k1.cu). It stays fixed whatever the kernel runs, so
# that its shares read the same work across designs; it over-counts the
# function's work (see the least work below). The fixed part: the
# conversions in (r mod p, r, e and s mod n, two products each) and out
# (ry's parity, u1, u2, qx, qy), r³ (a square and a product), the curve
# check (a square), u1 and u2, G + R (R has Z = 1), the affine map's
# square and three products, and the three fixed-exponent powers
# (square-and-multiply from the top bit).
_POW = lambda e: (e.bit_length() - 1, bin(e).count("1") - 1)
_POWS = [_POW((P + 1) // 4), _POW(N - 2), _POW(P - 2)]
FIXED_PRODUCTS = (1 + 1 + 3 + 1 + sum(sq for sq, _ in _POWS),
                  8 + 5 + 1 + 2 + 8 + 3 + sum(pr for _, pr in _POWS))
# 32 x 32 -> 64-bit multiply-adds of one CIOS product: 64 for a·b and 64
# for the reduction's q·m (the eight q = t0·m' are left out). A square
# needs 36 for a·a (the 28 cross products once, doubled by a shift, and
# the 8 squares) and the same reduction.
PRODUCT_MULTIPLY_ADDS = 128
SQUARE_MULTIPLY_ADDS = 36 + 64


def kernel_products(u1: int, u2: int) -> tuple[int, int]:
    """(squares, other products) of the yardstick for one row with ladder
    scalars u1, u2."""
    sq, pr = _ladder_products(u1, u2)
    return FIXED_PRODUCTS[0] + sq, FIXED_PRODUCTS[1] + pr


def kernel_multiply_adds(u1: int, u2: int) -> int:
    """32 x 32 -> 64-bit multiply-adds of the yardstick's products for one
    row."""
    sq, pr = kernel_products(u1, u2)
    return sq * SQUARE_MULTIPLY_ADDS + pr * PRODUCT_MULTIPLY_ADDS


def _chain(e: int, tail) -> tuple[int, int]:
    """(squares, products) of x^e by an addition chain: the shared head
    x^(2^223 - 1) (222 squares and 11 products through x^3, x^7, ...,
    x^(2^220 - 1)), then per (k, m) of `tail` k squares and a product by
    x^m (none for m = 0)."""
    exp, squares, products = (1 << 223) - 1, 222, 11
    for k, m in tail:
        exp = (exp << k) + m
        squares += k
        products += m != 0
    assert exp == e, (hex(exp), hex(e))
    return squares, products


# The least work the function needs, for the kernel's bound: products mod
# p reduced by p's special form (2^256 = 2^32 + 977 mod p: the high half's
# 8 words times 977, the 2^32 term a shift, then the two-word carry times
# 977 once more), squares with their cross products once; the square root
# (p + 1)/4 by its addition chain; both inverses, r^-1 mod n and Z^-1 mod
# p, by the binary extended Euclid (shifts and subtractions, no products);
# u1 and u2 as two CIOS products mod n; no conversions in or out.
SQRT_CHAIN = _chain((P + 1) // 4, [(23, (1 << 22) - 1), (6, 3), (2, 0)])
LEAST_FIXED_PRODUCTS = (  # r³, the root, the curve check, G + R, affine
    1 + SQRT_CHAIN[0] + 1 + 3 + 1, 1 + SQRT_CHAIN[1] + 8 + 3)
LEAST_N_PRODUCTS = 2
REDUCE_P_MULTIPLY_ADDS = 8 + 2
LEAST_PRODUCT_MULTIPLY_ADDS = 64 + REDUCE_P_MULTIPLY_ADDS
LEAST_SQUARE_MULTIPLY_ADDS = 36 + REDUCE_P_MULTIPLY_ADDS


def least_products(u1: int, u2: int) -> tuple[int, int]:
    """(squares, other products) mod p of the least work for one row with
    ladder scalars u1, u2; the LEAST_N_PRODUCTS products mod n apart."""
    sq, pr = _ladder_products(u1, u2)
    return LEAST_FIXED_PRODUCTS[0] + sq, LEAST_FIXED_PRODUCTS[1] + pr


def least_multiply_adds(u1: int, u2: int) -> int:
    """32 x 32 -> 64-bit multiply-adds of the least work for one row."""
    sq, pr = least_products(u1, u2)
    return (sq * LEAST_SQUARE_MULTIPLY_ADDS
            + pr * LEAST_PRODUCT_MULTIPLY_ADDS
            + LEAST_N_PRODUCTS * PRODUCT_MULTIPLY_ADDS)


def ladder_scalars(e: int, r: int, s: int):
    """(u1, u2) of the ladder for one row of digest e and signature
    (r, s), as the kernel derives them (r⁻¹ of r = 0 mod n is 0)."""
    rinv = pow(r % N, N - 2, N)
    return -e * rinv % N, s * rinv % N


# == host converters =======================================================


def hashes_to_limbs(hashes: Sequence[bytes]) -> np.ndarray:
    return ints_to_limbs([int.from_bytes(h, "big") for h in hashes])


def sigs_to_limbs(sigs: Sequence[ref.Signature]):
    """[Signature] -> (r, s, recid) arrays."""
    r = ints_to_limbs([sig.r for sig in sigs])
    s = ints_to_limbs([sig.s for sig in sigs])
    v = np.asarray([sig.v for sig in sigs], np.int32)
    return r, s, v


def limbs_to_pubkeys(qx, qy, ok):
    """Recovery outputs (canonical limbs, as both routes give them) ->
    [(x, y) | None] host points."""
    xs = limbs_to_int(torch.as_tensor(qx))
    ys = limbs_to_int(torch.as_tensor(qy))
    oks = torch.as_tensor(ok).cpu().tolist()
    return [(int(x), int(y)) if good else None
            for x, y, good in zip(xs, ys, oks)]
