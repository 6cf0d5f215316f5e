"""bn256 (alt_bn128) host scalar arithmetic: the subset the port needs.

The port's own copy of the JAX package's scalar curve code (it imports
nothing of that package): Fp2, G1/G2 add/neg/mul, the G2 Frobenius maps
and their twist constants, the optimal-ate NAF, and `hash_to_g1`. The
static kernel tables of `ops/bn256.py` and `ops/megakernels.py` are
derived from these, and the host marshalling path hashes each audited
message with `hash_to_g1`. No scalar pairing lives here: the tests use
the JAX package's own scalar verifier as the oracle.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

from gethsharding_tpu_torch.crypto.keccak import keccak256

# Field modulus and group order (EIP-196/197 parameters)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
N = 21888242871839275222246405745257275088548364400416034343698204186575808495617
U = 4965661367192848881  # BN parameter


def _inv(a: int, m: int = P) -> int:
    return pow(a, -1, m)


@dataclass(frozen=True)
class Fp2:
    """a + b·i with i² = -1."""

    a: int
    b: int

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
        return Fp2((self.a * o.a - self.b * o.b) % P,
                   (self.a * o.b + self.b * o.a) % P)

    def scalar(self, k: int) -> "Fp2":
        return Fp2(self.a * k % P, self.b * k % P)

    def neg(self) -> "Fp2":
        return Fp2(-self.a % P, -self.b % P)

    def inv(self) -> "Fp2":
        ninv = _inv((self.a * self.a + self.b * self.b) % P)
        return Fp2(self.a * ninv % P, -self.b * ninv % P)

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0


XI = Fp2(9, 1)  # ξ = 9 + i, the sextic twist shift

# -- G1: E(Fp): y² = x³ + 3 ------------------------------------------------

G1Point = Optional[Tuple[int, int]]  # affine; None = infinity
B1 = 3
G1_GEN: G1Point = (1, 2)


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


def g1_mul(k: int, point: G1Point) -> G1Point:
    k %= N
    result: G1Point = None
    addend = point
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


# -- G2: E'(Fp2): y² = x³ + 3/ξ (sextic D-twist) --------------------------

G2Point = Optional[Tuple[Fp2, Fp2]]
B2 = Fp2(3, 0) * XI.inv()

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


def g2_mul(k: int, point: G2Point) -> G2Point:
    k %= N
    result: G2Point = None
    addend = point
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


# -- optimal-ate schedule and Frobenius constants -------------------------

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


# untwist ∘ frobenius ∘ twist on E'(Fp2):
# (x, y) -> (conj(x)·ξ^((p-1)/3), conj(y)·ξ^((p-1)/2))
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


@functools.lru_cache(maxsize=8192)
def hash_to_g1(message: bytes) -> G1Point:
    """Try-and-increment keccak hash onto E(Fp) (deterministic); the
    same map as the JAX package's, so both sides hash a message to the
    same point."""
    counter = 0
    while True:
        candidate = keccak256(message + counter.to_bytes(4, "big"))
        x = int.from_bytes(candidate, "big") % P
        y_sq = (pow(x, 3, P) + B1) % P
        y = pow(y_sq, (P + 1) // 4, P)
        if y * y % P == y_sq:
            parity = keccak256(candidate)[0] & 1
            if y & 1 != parity:
                y = P - y
            return (x, y)
        counter += 1
