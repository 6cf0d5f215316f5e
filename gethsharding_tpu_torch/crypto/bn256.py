"""bn256 (alt_bn128) host scalar arithmetic: the port's own copy of the
JAX package's scalar curve module (it imports nothing of that package).

- The tower Fp2 = Fp[i]/(i²+1), Fp6 = Fp2[v]/(v³-ξ) with ξ = 9+i, and
  Fp12 = Fp6[w]/(w²-v).
- G1/G2 add, neg and multiply (`*_mul_raw` leaves the scalar unreduced,
  as the order checks need), the curve and subgroup checks, the G2
  Frobenius maps and their twist constants, the optimal-ate NAF.
- The scalar pairings: the ate Miller loop (T = 6u², lines only), the
  optimal-ate loop (6u + 2 and two Frobenius-twisted lines), the final
  exponentiation and `pairing_check`, which raises `ValueError` on a G1
  point off the curve or a G2 point outside the order-n subgroup. Both
  loops give the same PairingCheck predicate.
- `hash_to_g1` and the BLS face layered on the pairing: keys, signing,
  verification, aggregation and the proof of possession.

The static kernel tables of `ops/bn256.py` and `ops/megakernels.py` are
derived from these; the host marshal hashes each audited message with
`hash_to_g1`; the DAS multiproofs (`das/pcs.py`) run their MSMs and,
for rows with a point at infinity, their pairing check here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from gethsharding_tpu_torch.crypto.keccak import keccak256

# Field modulus and group order (EIP-196/197 parameters)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
N = 21888242871839275222246405745257275088548364400416034343698204186575808495617
U = 4965661367192848881  # BN parameter
ATE_LOOP_COUNT = 6 * U * U  # trace - 1


def _inv(a: int, m: int = P) -> int:
    return pow(a, -1, m)


# -- Fp2 -------------------------------------------------------------------


@dataclass(frozen=True)
class Fp2:
    """a + b·i with i² = -1."""

    a: int  # real
    b: int  # i coefficient

    @staticmethod
    def zero() -> "Fp2":
        return Fp2(0, 0)

    @staticmethod
    def one() -> "Fp2":
        return Fp2(1, 0)

    def __add__(self, o: "Fp2") -> "Fp2":
        return Fp2((self.a + o.a) % P, (self.b + o.b) % P)

    def __sub__(self, o: "Fp2") -> "Fp2":
        return Fp2((self.a - o.a) % P, (self.b - o.b) % P)

    def __mul__(self, o: "Fp2") -> "Fp2":
        a = (self.a * o.a - self.b * o.b) % P
        b = (self.a * o.b + self.b * o.a) % P
        return Fp2(a, b)

    def scalar(self, k: int) -> "Fp2":
        return Fp2(self.a * k % P, self.b * k % P)

    def neg(self) -> "Fp2":
        return Fp2(-self.a % P, -self.b % P)

    def inv(self) -> "Fp2":
        norm = (self.a * self.a + self.b * self.b) % P
        ninv = _inv(norm)
        return Fp2(self.a * ninv % P, -self.b * ninv % P)

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0


XI = Fp2(9, 1)  # ξ = 9 + i, the sextic twist shift


# -- Fp6 = Fp2[v]/(v³ - ξ) -------------------------------------------------


@dataclass(frozen=True)
class Fp6:
    c0: Fp2
    c1: Fp2
    c2: Fp2

    @staticmethod
    def zero() -> "Fp6":
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one() -> "Fp6":
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def __add__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __mul__(self, o: "Fp6") -> "Fp6":
        # schoolbook with v³ = ξ reduction
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a0 * b1 + a1 * b0
        t2 = a0 * b2 + a1 * b1 + a2 * b0
        t3 = a1 * b2 + a2 * b1  # v³ -> ξ
        t4 = a2 * b2  # v⁴ -> ξ·v
        return Fp6(t0 + t3 * XI, t1 + t4 * XI, t2)

    def mul_fp2(self, k: Fp2) -> "Fp6":
        return Fp6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self) -> "Fp6":
        """Multiply by v: (c0, c1, c2) -> (ξ·c2, c0, c1)."""
        return Fp6(self.c2 * XI, self.c0, self.c1)

    def neg(self) -> "Fp6":
        return Fp6(self.c0.neg(), self.c1.neg(), self.c2.neg())

    def inv(self) -> "Fp6":
        # standard cubic-extension inversion via the adjoint matrix
        a, b, c = self.c0, self.c1, self.c2
        t0 = a * a - (b * c) * XI
        t1 = (c * c) * XI - a * b
        t2 = b * b - a * c
        denom = a * t0 + ((c * t1) + (b * t2)) * XI
        dinv = denom.inv()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


# -- Fp12 = Fp6[w]/(w² - v) ------------------------------------------------


@dataclass(frozen=True)
class Fp12:
    c0: Fp6
    c1: Fp6

    @staticmethod
    def one() -> "Fp12":
        return Fp12(Fp6.one(), Fp6.zero())

    def __add__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fp12") -> "Fp12":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        return Fp12(
            t0 + t1.mul_by_v(),
            self.c0 * o.c1 + self.c1 * o.c0,
        )

    def square(self) -> "Fp12":
        return self * self

    def neg(self) -> "Fp12":
        return Fp12(self.c0.neg(), self.c1.neg())

    def inv(self) -> "Fp12":
        denom = self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()
        dinv = denom.inv()
        return Fp12(self.c0 * dinv, self.c1.neg() * dinv)

    def pow(self, e: int) -> "Fp12":
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_one(self) -> bool:
        return self == Fp12.one()


# -- G1: E(Fp): y² = x³ + 3 ------------------------------------------------

G1Point = Optional[Tuple[int, int]]  # affine; None = infinity
B1 = 3


def g1_is_on_curve(point: G1Point) -> bool:
    if point is None:
        return True
    x, y = point
    return (y * y - (x * x * x + B1)) % P == 0


def g1_add(p1: G1Point, p2: G1Point) -> G1Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(point: G1Point) -> G1Point:
    if point is None:
        return None
    return (point[0], -point[1] % P)


def g1_mul_raw(k: int, point: G1Point) -> G1Point:
    """Scalar multiplication WITHOUT reduction mod N (for order checks)."""
    result: G1Point = None
    addend = point
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def g1_mul(k: int, point: G1Point) -> G1Point:
    return g1_mul_raw(k % N, point)


G1_GEN: G1Point = (1, 2)


# -- G2: E'(Fp2): y² = x³ + 3/ξ (sextic D-twist) --------------------------

G2Point = Optional[Tuple[Fp2, Fp2]]
B2 = Fp2(3, 0) * XI.inv()


def g2_is_on_curve(point: G2Point) -> bool:
    if point is None:
        return True
    x, y = point
    return (y * y - (x * x * x + B2)).is_zero()


def g2_add(p1: G2Point, p2: G2Point) -> G2Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1 * x1).scalar(3) * (y1 + y1).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def g2_neg(point: G2Point) -> G2Point:
    if point is None:
        return None
    return (point[0], point[1].neg())


def g2_mul_raw(k: int, point: G2Point) -> G2Point:
    """Scalar multiplication WITHOUT reduction mod N — needed for subgroup
    membership checks, where reducing the scalar would make the check
    vacuous (k=N would become 0)."""
    result: G2Point = None
    addend = point
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


def g2_mul(k: int, point: G2Point) -> G2Point:
    return g2_mul_raw(k % N, point)


def g2_in_subgroup(point: G2Point) -> bool:
    """Order-n subgroup membership (the twist has order n·(2p-n))."""
    if point is None:
        return True
    return g2_is_on_curve(point) and g2_mul_raw(N, point) is None


# canonical alt_bn128 G2 generator (EIP-197 ordering: imaginary limb listed
# first in the encoding; here x = a + b·i)
G2_GEN: G2Point = (
    Fp2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fp2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


# -- pairing ---------------------------------------------------------------


def _embed_fp(x: int) -> Fp12:
    return Fp12(Fp6(Fp2(x % P, 0), Fp2.zero(), Fp2.zero()), Fp6.zero())


def _embed_w2(x: Fp2) -> Fp12:
    """x·w² = x·v as an Fp12 element (c0 = (0, x, 0))."""
    return Fp12(Fp6(Fp2.zero(), x, Fp2.zero()), Fp6.zero())


def _embed_w3(y: Fp2) -> Fp12:
    """y·w³ = y·v·w (c1 = (0, y, 0))."""
    return Fp12(Fp6.zero(), Fp6(Fp2.zero(), y, Fp2.zero()))


@dataclass(frozen=True)
class _Ept:
    """Point on E(Fp12) in affine coordinates."""

    x: Fp12
    y: Fp12


def _untwist(q: G2Point) -> _Ept:
    assert q is not None
    return _Ept(_embed_w2(q[0]), _embed_w3(q[1]))


def _step(a: _Ept, b: _Ept, px: Fp12, py: Fp12) -> Tuple[Fp12, _Ept]:
    """One shared-slope chord/tangent step: returns (line value at (px,py),
    a+b). Verticals never occur in the Miller loop below (loop count < group
    order), and would die in the final exponentiation anyway."""
    if a.x == b.x and a.y == b.y:
        slope = (a.x * a.x) * _embed_fp(3) * (a.y + a.y).inv()
    else:
        slope = (b.y - a.y) * (b.x - a.x).inv()
    line = (py - a.y) - slope * (px - a.x)
    x3 = slope * slope - a.x - b.x
    y3 = slope * (a.x - x3) - a.y
    return line, _Ept(x3, y3)


def miller_loop(q: G2Point, p: G1Point) -> Fp12:
    """f_{T, untwist(q)}(p) with T = 6u² (ate pairing), lines only."""
    if q is None or p is None:
        return Fp12.one()
    qe = _untwist(q)
    px = _embed_fp(p[0])
    py = _embed_fp(p[1])
    f = Fp12.one()
    r = qe
    for bit in bin(ATE_LOOP_COUNT)[3:]:  # MSB already consumed by r = qe
        line, r = _step(r, r, px, py)
        f = f.square() * line
        if bit == "1":
            line, r = _step(r, qe, px, py)
            f = f * line
    return f


FINAL_EXP = (P**12 - 1) // N


def final_exponentiation(f: Fp12) -> Fp12:
    return f.pow(FINAL_EXP)


# -- optimal ate -----------------------------------------------------------
# Loop count 6u+2 (~65 bits, vs 6u² ≈ 127 for plain ate) plus two
# Frobenius-twisted adjustment lines. Both pairings induce the same
# PairingCheck predicate (each is a fixed power of the Tate pairing with
# exponent coprime to n); this shorter variant is the scalar twin of the
# batched Miller kernel (`ops/bn256.py::bls_verify_aggregate_batch`),
# the optimal-ate loop of go-ethereum's
# `crypto/bn256/cloudflare/optate.go`.

OPT_ATE_LOOP = 6 * U + 2


def _naf(e: int) -> List[int]:
    """Non-adjacent form, little-endian digits in {-1, 0, 1}."""
    digits = []
    while e:
        if e & 1:
            d = 2 - (e % 4)
            e -= d
        else:
            d = 0
        digits.append(d)
        e >>= 1
    return digits


OPT_ATE_NAF = _naf(OPT_ATE_LOOP)  # len 66, weight 22, top digit 1


def _fp2_pow(base: Fp2, e: int) -> Fp2:
    result, b = Fp2.one(), base
    while e:
        if e & 1:
            result = result * b
        b = b * b
        e >>= 1
    return result


# Twist-Frobenius coefficients: untwist ∘ frobenius ∘ twist maps
# (x, y) -> (conj(x)·ξ^((p-1)/3), conj(y)·ξ^((p-1)/2)) on E'(Fp2).
TWIST_FROB_X = _fp2_pow(XI, (P - 1) // 3)
TWIST_FROB_Y = _fp2_pow(XI, (P - 1) // 2)
TWIST_FROB2_X = _fp2_pow(XI, (P * P - 1) // 3)
TWIST_FROB2_Y = _fp2_pow(XI, (P * P - 1) // 2)


def g2_frobenius(q: G2Point) -> G2Point:
    if q is None:
        return None
    x, y = q
    return (Fp2(x.a, -x.b % P) * TWIST_FROB_X,
            Fp2(y.a, -y.b % P) * TWIST_FROB_Y)


def g2_frobenius2(q: G2Point) -> G2Point:
    if q is None:
        return None
    x, y = q
    return (x * TWIST_FROB2_X, y * TWIST_FROB2_Y)


def miller_loop_optimal(q: G2Point, p: G1Point) -> Fp12:
    """f_{6u+2, untwist(q)}(p) · adjustment lines (optimal ate)."""
    if q is None or p is None:
        return Fp12.one()
    px = _embed_fp(p[0])
    py = _embed_fp(p[1])
    qe = _untwist(q)
    qe_neg = _untwist(g2_neg(q))
    f = Fp12.one()
    r = qe
    for d in reversed(OPT_ATE_NAF[:-1]):  # top digit consumed by r = qe
        line, r = _step(r, r, px, py)
        f = f.square() * line
        if d == 1:
            line, r = _step(r, qe, px, py)
            f = f * line
        elif d == -1:
            line, r = _step(r, qe_neg, px, py)
            f = f * line
    line, r = _step(r, _untwist(g2_frobenius(q)), px, py)
    f = f * line
    line, r = _step(r, _untwist(g2_neg(g2_frobenius2(q))), px, py)
    f = f * line
    return f


def pairing_check_optimal(pairs: Sequence[Tuple[G1Point, G2Point]]) -> bool:
    """PairingCheck via the optimal-ate Miller loop (same predicate as
    `pairing_check`; differential twin for the batched kernel)."""
    acc = Fp12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        if not g1_is_on_curve(p):
            raise ValueError("pairing input not on curve")
        if not g2_in_subgroup(q):
            raise ValueError(
                "G2 point not on curve or not in the order-n subgroup")
        acc = acc * miller_loop_optimal(q, p)
    return final_exponentiation(acc).is_one()


def pairing(p: G1Point, q: G2Point) -> Fp12:
    """e(P, Q) for P ∈ G1, Q ∈ G2."""
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs: Sequence[Tuple[G1Point, G2Point]]) -> bool:
    """∏ e(Pᵢ, Qᵢ) == 1 — parity with `bn256.PairingCheck`
    (`crypto/bn256/cloudflare/bn256.go:313`): one product of Miller loops,
    a single final exponentiation, infinity pairs contribute identity."""
    acc = Fp12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        if not g1_is_on_curve(p):
            raise ValueError("pairing input not on curve")
        if not g2_in_subgroup(q):
            # the twist has composite order n·(2p-n); points outside the
            # order-n subgroup break ate-pairing bilinearity. Parity with
            # twistPoint.IsOnCurve's order check (cloudflare twist.go) and
            # the EIP-197 mandate.
            raise ValueError("G2 point not on curve or not in the order-n subgroup")
        acc = acc * miller_loop(q, p)
    return final_exponentiation(acc).is_one()


# -- BLS-style aggregatable committee signatures ---------------------------
# The framework's batch-verifiable notary vote scheme: sig = sk·H(m) ∈ G1,
# pk = sk·G2; verify e(sig, G2) == e(H(m), pk); n votes on one header
# aggregate into a single pair check. This is what the audit kernels
# batch-verify at scale.


@functools.lru_cache(maxsize=8192)
def hash_to_g1(message: bytes) -> G1Point:
    """Try-and-increment keccak hash onto E(Fp) (deterministic).

    Memoized: pure function, and the same vote digest is hashed by the
    signing path, the audit and the pipelines within one period — the
    keccak + sqrt-exponentiation cost is ~0.3 ms per fresh message on
    the audit's host critical path."""
    counter = 0
    while True:
        candidate = keccak256(message + counter.to_bytes(4, "big"))
        x = int.from_bytes(candidate, "big") % P
        y_sq = (pow(x, 3, P) + B1) % P
        y = pow(y_sq, (P + 1) // 4, P)
        if y * y % P == y_sq:
            # canonical y parity from one more hash bit for determinism
            parity = keccak256(candidate)[0] & 1
            if y & 1 != parity:
                y = P - y
            return (x, y)
        counter += 1


def bls_keygen(seed: bytes) -> Tuple[int, G2Point]:
    sk = int.from_bytes(keccak256(b"bls-sk" + seed), "big") % N
    if sk == 0:
        sk = 1
    return sk, g2_mul(sk, G2_GEN)


def bls_sign(message: bytes, sk: int) -> G1Point:
    return g1_mul(sk, hash_to_g1(message))


def bls_verify(message: bytes, sig: G1Point, pk: G2Point) -> bool:
    # e(sig, G2)·e(-H(m), pk) == 1  <=>  e(sig, G2) == e(H(m), pk)
    if sig is None or pk is None:
        # infinity signature/key would vacuously satisfy the pair check
        # (universal forgery); reject outright
        return False
    try:
        return pairing_check([(sig, G2_GEN), (g1_neg(hash_to_g1(message)), pk)])
    except ValueError:
        # malformed network-supplied points are a rejection, not a crash
        return False


def bls_aggregate_sigs(sigs: Sequence[G1Point]) -> G1Point:
    acc: G1Point = None
    for sig in sigs:
        acc = g1_add(acc, sig)
    return acc


def bls_aggregate_pks(pks: Sequence[G2Point]) -> G2Point:
    acc: G2Point = None
    for pk in pks:
        acc = g2_add(acc, pk)
    return acc


def bls_verify_aggregate(message: bytes, agg_sig: G1Point,
                         pks: Sequence[G2Point]) -> bool:
    """All signers signed the same message (the collation header hash).

    SECURITY: same-message aggregation is sound only against rogue-key
    attacks when every pk has a verified proof of possession
    (`bls_verify_possession`) at registration time — an attacker who can
    register pk' = sk'·G2 - pk_honest without proving knowledge of its
    secret key can forge the aggregate. The notary registration path
    enforces PoP; callers using this directly must do the same.
    """
    if len(pks) == 0:
        return False  # an empty committee proves nothing
    return bls_verify(message, agg_sig, bls_aggregate_pks(pks))


# -- proof of possession (rogue-key defense) -------------------------------

_POP_DOMAIN = b"gethsharding-tpu/bls-pop-v1/"


def _pk_bytes(pk: G2Point) -> bytes:
    assert pk is not None
    x, y = pk
    return b"".join(
        c.to_bytes(32, "big") for c in (x.a, x.b, y.a, y.b)
    )


def bls_prove_possession(sk: int, pk: G2Point) -> G1Point:
    """PoP = sk·H(domain ‖ pk): binds the key to knowledge of its secret."""
    return g1_mul(sk, hash_to_g1(_POP_DOMAIN + _pk_bytes(pk)))


def bls_verify_possession(pk: G2Point, pop: G1Point) -> bool:
    if pk is None or pop is None:
        return False
    try:
        return pairing_check([
            (pop, G2_GEN),
            (g1_neg(hash_to_g1(_POP_DOMAIN + _pk_bytes(pk))), pk),
        ])
    except ValueError:
        return False
