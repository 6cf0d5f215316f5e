"""Keccak-256 (legacy pre-NIST padding, as used by Ethereum).

Reference parity: `crypto/sha3/keccakf.go` (generic permutation) and
`crypto/sha3/keccakf_amd64.s` in the reference tree. `keccak256` runs
the port's own copy of the JAX package's C keccak (`csrc/keccak.c`),
built with the host C compiler (`$CC`, else `cc`) on first use into
`_build/` and bound with ctypes; `keccak256_py`, the pure-Python sponge
(the port's own copy of the JAX package's scalar keccak), is its twin in
the tests and the host's path only where the build or the load fails,
which is logged once. Its callers are `hash_to_g1`, the secp256k1
addresses and the DAS proofs on the host.

Note Ethereum's keccak256 uses the ORIGINAL Keccak multi-rate padding
(domain byte 0x01), not the NIST SHA3 padding (0x06) — hashlib.sha3_256
produces different digests and cannot be used.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path
from typing import List

from gethsharding_tpu_torch.crypto import hostlib

log = logging.getLogger(__name__)

MASK64 = (1 << 64) - 1

# Round constants for keccak-f[1600] (iota step), 24 rounds.
ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] for the rho step, indexed [x + 5*y].
ROTATION_OFFSETS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl64(value: int, shift: int) -> int:
    if shift == 0:
        return value
    return ((value << shift) | (value >> (64 - shift))) & MASK64


def keccak_f1600(state: List[int]) -> List[int]:
    """One keccak-f[1600] permutation over 25 uint64 lanes (x + 5*y order)."""
    lanes = list(state)
    for rc in ROUND_CONSTANTS:
        # theta
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x + 5 * y] ^= d[x]
        # rho + pi: B[y, 2x+3y] = rotl(A[x, y], r[x, y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    lanes[x + 5 * y], ROTATION_OFFSETS[x + 5 * y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y] & MASK64) & b[(x + 2) % 5 + 5 * y]
                )
        # iota
        lanes[0] ^= rc
    return lanes


RATE_BYTES = 136  # 1088-bit rate for 256-bit output


def keccak256(data: bytes) -> bytes:
    """keccak256 digest (Ethereum flavour: 0x01 domain padding), through
    the compiled `csrc/keccak.c` where it loaded."""
    fn = _native()
    if fn is None:
        return keccak256_py(data)
    out = ctypes.create_string_buffer(32)
    fn(data, len(data), out)
    return out.raw


def keccak256_py(data: bytes) -> bytes:
    """Pure-Python keccak256: the twin of the compiled path."""
    return _sponge(data, RATE_BYTES, 32, 0x01)


_SOURCE = hostlib.SRC_DIR / "keccak.c"
_LIB = hostlib.BUILD_DIR / "libkeccak.so"
_lock = threading.Lock()
_fn = None
_tried = False


def native_available() -> bool:
    """True where `keccak256` runs the compiled C keccak."""
    return _native() is not None


def _native():
    """`gs_keccak256` of the compiled library, built on first use (and
    again when the source changes: its hash is kept beside the library);
    None, logged once, where no C compiler or no load succeeds."""
    global _fn, _tried
    if _tried:
        return _fn
    with _lock:
        if _tried:
            return _fn
        try:
            lib = ctypes.CDLL(str(_build()))
            fn = lib.gs_keccak256
            fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
            fn.restype = None
            _fn = fn
        except (OSError, subprocess.SubprocessError) as exc:
            log.warning("native keccak unavailable, hashing in Python: %s",
                        exc)
        _tried = True
    return _fn


def _build() -> Path:
    return hostlib.build(_SOURCE, _LIB)


def _sponge(data: bytes, rate: int, out_len: int, domain: int) -> bytes:
    """The Keccak sponge over keccak_f1600: absorb `data` at `rate`
    bytes per block with `domain` padding, squeeze `out_len` bytes."""
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += bytes([domain]) + b"\x00" * (pad_len - 1)
    padded[-1] |= 0x80

    state = [0] * 25
    for block_start in range(0, len(padded), rate):
        block = padded[block_start: block_start + rate]
        for lane_idx in range(rate // 8):
            state[lane_idx] ^= int.from_bytes(
                block[lane_idx * 8: lane_idx * 8 + 8], "little"
            )
        state = keccak_f1600(state)

    out = bytearray()
    while len(out) < out_len:
        for lane_idx in range(rate // 8):
            out += state[lane_idx].to_bytes(8, "little")
            if len(out) >= out_len:
                break
        else:
            state = keccak_f1600(state)
    return bytes(out[:out_len])

