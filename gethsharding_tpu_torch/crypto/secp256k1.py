"""secp256k1 ECDSA host scalar code: the subset the port needs.

The port's own copy of the JAX package's `crypto/secp256k1.py` (it imports
nothing of that package): the curve constants, point arithmetic,
`Signature` with its 65-byte [R || S || V] wire form, RFC 6979 signing
(the tests and `chip_smoke.py` make their signatures with it), `recover`
and keccak-derived addresses. Addresses are plain 20-byte `bytes`; they
compare equal to the reference's `Address20` (a `bytes` subclass).

`TorchSigBackend.ecrecover_addresses` recovers on the card
(`ops/secp256k1.py`) and uses this module for the rare recovery ids 2 and
3 (r + n overflow), which the batched recovery leaves to the host.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass
from typing import Optional, Tuple

from gethsharding_tpu_torch.crypto.keccak import keccak256

# Curve: y^2 = x^3 + 7 over F_P
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

Point = Optional[Tuple[int, int]]  # None = point at infinity (affine)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def point_add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_mul_raw(k: int, point: Point) -> Point:
    """Scalar multiplication WITHOUT reduction mod N (for order checks)."""
    result: Point = None
    addend = point
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_add(addend, addend)
        k >>= 1
    return result


def point_mul(k: int, point: Point) -> Point:
    return point_mul_raw(k % N, point)


G: Point = (GX, GY)


def is_on_curve(point: Point) -> bool:
    if point is None:
        return True
    x, y = point
    return (y * y - (x * x * x + B)) % P == 0


# -- key handling ----------------------------------------------------------


def pubkey_from_priv(priv: int) -> Tuple[int, int]:
    if not 1 <= priv < N:
        raise ValueError("private key out of range")
    pub = point_mul(priv, G)
    assert pub is not None
    return pub


def pubkey_to_bytes(pub: Tuple[int, int]) -> bytes:
    """Uncompressed SEC1: 0x04 || X || Y (65 bytes)."""
    return b"\x04" + pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")


def pubkey_to_address(pub: Tuple[int, int]) -> bytes:
    """keccak256(X||Y)[12:] — `crypto.PubkeyToAddress`."""
    return keccak256(pubkey_to_bytes(pub)[1:])[12:]


def priv_to_address(priv: int) -> bytes:
    return pubkey_to_address(pubkey_from_priv(priv))


# -- RFC 6979 deterministic nonce -----------------------------------------


def _rfc6979_k(msg_hash: bytes, priv: int) -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256), as libsecp256k1 uses."""
    holder = b"\x01" * 32
    key = b"\x00" * 32
    priv_bytes = priv.to_bytes(32, "big")
    key = hmac.new(key, holder + b"\x00" + priv_bytes + msg_hash,
                   hashlib.sha256).digest()
    holder = hmac.new(key, holder, hashlib.sha256).digest()
    key = hmac.new(key, holder + b"\x01" + priv_bytes + msg_hash,
                   hashlib.sha256).digest()
    holder = hmac.new(key, holder, hashlib.sha256).digest()
    while True:
        holder = hmac.new(key, holder, hashlib.sha256).digest()
        candidate = int.from_bytes(holder, "big")
        if 1 <= candidate < N:
            return candidate
        key = hmac.new(key, holder + b"\x00", hashlib.sha256).digest()
        holder = hmac.new(key, holder, hashlib.sha256).digest()


# -- ECDSA -----------------------------------------------------------------


@dataclass(frozen=True)
class Signature:
    r: int
    s: int
    v: int  # recovery id, 0 or 1

    def to_bytes65(self) -> bytes:
        """[R || S || V] — `crypto/secp256k1` wire format."""
        return (self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big")
                + bytes([self.v]))

    @classmethod
    def from_bytes65(cls, data: bytes) -> "Signature":
        if len(data) != 65:
            raise ValueError("signature must be 65 bytes [R||S||V]")
        return cls(
            r=int.from_bytes(data[:32], "big"),
            s=int.from_bytes(data[32:64], "big"),
            v=data[64],
        )


def sign(msg_hash: bytes, priv: int) -> Signature:
    """Deterministic low-S ECDSA over a 32-byte digest."""
    if len(msg_hash) != 32:
        raise ValueError("message hash must be 32 bytes")
    z = int.from_bytes(msg_hash, "big")
    while True:
        k = _rfc6979_k(msg_hash, priv)
        R = point_mul(k, G)
        assert R is not None
        r = R[0] % N
        if r == 0:
            msg_hash = keccak256(msg_hash)  # extremely unlikely; re-derive
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            msg_hash = keccak256(msg_hash)
            continue
        v = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > N // 2:  # low-S normalization flips parity
            s = N - s
            v ^= 1
        return Signature(r=r, s=s, v=v)


def verify(msg_hash: bytes, sig: Signature, pub: Tuple[int, int]) -> bool:
    """Classic ECDSA verify (ignores the recovery id).

    Parity with `secp256k1.VerifySignature` (which rejects high-S
    malleable signatures, see `crypto/signature_cgo.go:70-77`).
    """
    r, s = sig.r, sig.s
    if not (1 <= r < N and 1 <= s <= N // 2):
        return False
    if not is_on_curve(pub):
        return False
    z = int.from_bytes(msg_hash, "big")
    w = _inv(s, N)
    u1 = z * w % N
    u2 = r * w % N
    point = point_add(point_mul(u1, G), point_mul(u2, pub))
    if point is None:
        return False
    return point[0] % N == r


def recover(msg_hash: bytes, sig: Signature) -> Tuple[int, int]:
    """Recover the public key — `secp256k1.RecoverPubkey` / ecrecover."""
    r, s, v = sig.r, sig.s, sig.v
    if not (1 <= r < N and 1 <= s < N):
        raise ValueError("invalid signature scalars")
    if v not in (0, 1, 2, 3):
        raise ValueError("invalid recovery id")
    x = r + (N if v >= 2 else 0)
    if x >= P:
        raise ValueError("invalid r for this recovery id")
    # lift x: y^2 = x^3 + 7, P ≡ 3 (mod 4) so sqrt = pow(., (P+1)/4)
    y_sq = (pow(x, 3, P) + B) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        raise ValueError("r does not correspond to a curve point")
    if y & 1 != v & 1:
        y = P - y
    R = (x, y)
    z = int.from_bytes(msg_hash, "big")
    r_inv = _inv(r, N)
    # Q = r^-1 (s R - z G)
    point = point_add(
        point_mul(s * r_inv % N, R),
        point_mul((-z * r_inv) % N, G),
    )
    if point is None or not is_on_curve(point):
        raise ValueError("recovery produced invalid point")
    return point


def ecrecover_address(msg_hash: bytes, sig: Signature) -> bytes:
    return pubkey_to_address(recover(msg_hash, sig))
