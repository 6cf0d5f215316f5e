"""Systematic Reed–Solomon erasure extension of collation bodies (the
port's copy of the JAX package's `das/erasure.py`: the GF(2^8) tables, the
code, and the body-level extension and recovery).

A body split into k data chunks and extended with m parity chunks is
reconstructible from ANY k of the n = k+m chunks, so a withholding
proposer has to suppress at least m+1 chunks to make the body
unrecoverable, and a sampler that hits any suppressed chunk detects it
(`sampler.py` does the probability accounting).

The code is byte-wise systematic RS over GF(2^8) (primitive polynomial
0x11d): the generator is a Vandermonde matrix over n distinct field points
re-based so its top k×k block is the identity — data chunks pass through
verbatim and every k×k submatrix stays invertible. Encoding and decoding
are table-lookup numpy over whole 4096-byte chunk rows, on the host.

DAS chunks are exactly the storage tier's `CHUNK_SIZE`, so a parity chunk
is an ordinary content-addressed netstore chunk, and the DAS commitment
(`proofs.py`) merklizes the same `chunk_key` derivation the store uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from gethsharding_tpu_torch.storage.chunker import CHUNK_SIZE

DAS_CHUNK_SIZE = CHUNK_SIZE  # 4096: DAS chunks ARE storage chunks
# GF(2^8) Vandermonde needs n distinct field points: n <= 256. One short
# of that keeps every point's log defined (we use points 0..n-1 and the
# re-based generator, so 256 would be fine too — 255 is just a clean
# safety margin that also bounds commitment trees to depth 8).
MAX_TOTAL_CHUNKS = 255

_GF_POLY = 0x11D


class ErasureError(Exception):
    pass


# -- GF(2^8) tables ---------------------------------------------------------

_GF_EXP = np.zeros(512, dtype=np.uint8)
_GF_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _GF_POLY
_GF_EXP[255:510] = _GF_EXP[:255]  # doubled: exp[log a + log b] needs no mod
del _x, _i


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[int(_GF_LOG[a]) + int(_GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("no inverse of 0 in GF(2^8)")
    return int(_GF_EXP[255 - int(_GF_LOG[a])])


def _mul_row(coeff: int, row: np.ndarray) -> np.ndarray:
    """coeff * row over GF(2^8), vectorized over a whole chunk row."""
    if coeff == 0:
        return np.zeros_like(row)
    if coeff == 1:
        return row.copy()
    log_c = int(_GF_LOG[coeff])
    out = _GF_EXP[_GF_LOG[row] + log_c]
    out[row == 0] = 0  # log(0) is undefined; 0 * x = 0
    return out


def _matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF matrix product of small uint8 matrices (host setup cost)."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            coeff = int(a[i, j])
            if coeff:
                out[i] ^= _mul_row(coeff, b[j])
    return out


def _mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss–Jordan inverse over GF(2^8); raises on singular input."""
    k = m.shape[0]
    aug = np.concatenate([m.astype(np.uint8),
                          np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        pivot = next((r for r in range(col, k) if aug[r, col]), None)
        if pivot is None:
            raise ErasureError("singular decode matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = _mul_row(gf_inv(int(aug[col, col])), aug[col])
        for r in range(k):
            if r != col and aug[r, col]:
                aug[r] ^= _mul_row(int(aug[r, col]), aug[col])
    return aug[:, k:]


def _generator(k: int, n: int) -> np.ndarray:
    """The systematic n×k generator: Vandermonde over points 0..n-1,
    re-based by inv(top k rows) so rows 0..k-1 are the identity. Any k
    rows of the result are invertible (Vandermonde submatrix product),
    which is exactly the decode-from-any-k guarantee."""
    if not 1 <= k <= n <= MAX_TOTAL_CHUNKS:
        raise ErasureError(f"bad RS shape k={k} n={n} "
                           f"(need 1 <= k <= n <= {MAX_TOTAL_CHUNKS})")
    vand = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        acc = 1
        for j in range(k):
            vand[i, j] = acc
            acc = gf_mul(acc, i)
    return _matmul(vand, _mat_inv(vand[:k]))


_GEN_CACHE: Dict[tuple, np.ndarray] = {}


def _gen(k: int, n: int) -> np.ndarray:
    key = (k, n)
    if key not in _GEN_CACHE:
        _GEN_CACHE[key] = _generator(k, n)
    return _GEN_CACHE[key]


# -- encode / decode --------------------------------------------------------


def rs_encode(data_chunks: Sequence[bytes], parity: int) -> List[bytes]:
    """Extend k equal-length data chunks with `parity` parity chunks;
    returns all n = k + parity chunks (data first — systematic)."""
    k = len(data_chunks)
    if k == 0:
        raise ErasureError("need at least one data chunk")
    size = len(data_chunks[0])
    if any(len(c) != size for c in data_chunks):
        raise ErasureError("data chunks must be equal-length")
    n = k + parity
    gen = _gen(k, n)
    data = np.frombuffer(b"".join(data_chunks),
                         dtype=np.uint8).reshape(k, size)
    out = list(data_chunks)
    for p in range(k, n):
        row = np.zeros(size, dtype=np.uint8)
        for j in range(k):
            coeff = int(gen[p, j])
            if coeff:
                row ^= _mul_row(coeff, data[j])
        out.append(row.tobytes())
    return [bytes(c) for c in out]


def rs_decode(shares: Dict[int, bytes], k: int, n: int) -> List[bytes]:
    """Reconstruct the k data chunks from ANY k of the n extended
    chunks. `shares` maps chunk index (0..n-1) -> chunk bytes; extra
    shares beyond k are ignored (the first k by index are used)."""
    if k < 1 or n < k:
        raise ErasureError(f"bad RS shape k={k} n={n}")
    have = sorted(idx for idx in shares if 0 <= idx < n)
    if len(have) < k:
        raise ErasureError(
            f"unrecoverable: {len(have)} of {n} chunks, need {k}")
    rows = have[:k]
    size = len(shares[rows[0]])
    if any(len(shares[idx]) != size for idx in rows):
        raise ErasureError("shares must be equal-length")
    if rows == list(range(k)):
        return [bytes(shares[i]) for i in rows]  # all data present
    gen = _gen(k, n)
    inv = _mat_inv(gen[rows])
    stacked = np.stack([np.frombuffer(shares[idx], dtype=np.uint8)
                        for idx in rows])
    out = []
    for j in range(k):
        row = np.zeros(size, dtype=np.uint8)
        for i in range(k):
            coeff = int(inv[j, i])
            if coeff:
                row ^= _mul_row(coeff, stacked[i])
        out.append(row.tobytes())
    return out


# -- body-level extension ---------------------------------------------------


@dataclass(frozen=True)
class ExtendedBody:
    """One collation body, erasure-extended to n chunk-aligned chunks.

    ``chunks[:k]`` is the zero-padded body (the systematic half);
    ``chunks[k:]`` are parity. ``body_len`` is the exact original
    length — padding is a storage artifact, never protocol data."""

    chunks: tuple  # tuple[bytes, ...], each exactly DAS_CHUNK_SIZE
    k: int
    n: int
    body_len: int


def extend_body(body: bytes, parity_ratio: float = 0.5) -> ExtendedBody:
    """Pad `body` to k full chunks and extend with ceil(k·ratio) >= 1
    parity chunks. The erasure code runs over FULL storage chunks so
    every extended chunk is an ordinary netstore chunk."""
    import math

    if parity_ratio <= 0:
        raise ErasureError("parity_ratio must be positive")
    body_len = len(body)
    k = max(1, -(-body_len // DAS_CHUNK_SIZE))
    parity = max(1, math.ceil(k * parity_ratio))
    n = k + parity
    if n > MAX_TOTAL_CHUNKS:
        raise ErasureError(
            f"body of {body_len} bytes needs {n} extended chunks; the "
            f"GF(2^8) code caps at {MAX_TOTAL_CHUNKS}")
    padded = body + b"\x00" * (k * DAS_CHUNK_SIZE - body_len)
    data_chunks = [padded[i * DAS_CHUNK_SIZE:(i + 1) * DAS_CHUNK_SIZE]
                   for i in range(k)]
    chunks = rs_encode(data_chunks, parity)
    return ExtendedBody(chunks=tuple(chunks), k=k, n=n, body_len=body_len)


def recover_body(shares: Dict[int, bytes], k: int, n: int,
                 body_len: int) -> bytes:
    """The inverse of `extend_body`: any k of the n chunks -> the exact
    original body (padding stripped by `body_len`)."""
    data = rs_decode(shares, k, n)
    joined = b"".join(data)
    if body_len > len(joined):
        raise ErasureError(
            f"body_len {body_len} exceeds recovered {len(joined)} bytes")
    return joined[:body_len]
