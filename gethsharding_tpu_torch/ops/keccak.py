"""Batched keccak-256 in plain PyTorch: keccak-f[1600] over int64 lanes.

The port's counterpart of the JAX package's `ops/keccak_jax.py`. There a
state is (..., 25, 2) uint32 lane halves; PyTorch's CPU build has no
uint32 shifts, so here a state is (..., 25) int64, lane i = x + 5·y, one
64-bit lane per element with the same bits. int64 `>>` is arithmetic, so
a rotation masks off the sign bits it shifts in. Every step (theta, rho
and pi as one static gather, chi, iota) is a vectorized op over the 25
lanes of every message at once, so a batch of B messages runs as B
sponges.

The public layout is the reference's: (..., L) uint8 messages in, (...,
32) uint8 digests out, Ethereum's keccak (0x01 domain byte, not NIST
SHA3). `keccak256_fixed` is the plain version of `csrc/das.cu`'s sponges
(`das/proofs.py`) and of `csrc/keccak_fixed.cu`, and is held against the
reference and the host keccak (`crypto/keccak.py`) by the tests. It never
launches a kernel, so it stays the yardstick the sample kernel is held
against. `keccak256` is the route: `csrc/keccak_fixed.cu`
(`keccak_fixed_kernel`, one launch, a thread a message) for a CUDA
tensor, `keccak256_fixed` for a CPU tensor and inside
`route.plain_versions()`; the replay and the vote batch hash through it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gethsharding_tpu_torch.crypto.keccak import (RATE_BYTES,
                                                  ROTATION_OFFSETS,
                                                  ROUND_CONSTANTS)
from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.limb import const

KERNEL = _build.Kernel("keccak_fixed", "gs_keccak_fixed",
                       "gethsharding_tpu_torch/csrc/keccak_fixed.cu",
                       "gethsharding_tpu/ops/keccak_jax.py:123")

RATE_LANES = RATE_BYTES // 8  # 17

# the round constants as int64 (the same 64 bits)
_RC = np.array([rc - (1 << 64) if rc >> 63 else rc
                for rc in ROUND_CONSTANTS], np.int64)

# rho + pi as one static gather: dest lane d = y + 5·((2x + 3y) % 5) takes
# source lane s = x + 5·y rotated by ROTATION_OFFSETS[s]
_PI_SRC = np.zeros(25, np.int64)
_PI_ROT = np.zeros(25, np.int64)
for _x in range(5):
    for _y in range(5):
        _s = _x + 5 * _y
        _d = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_d] = _s
        _PI_ROT[_d] = ROTATION_OFFSETS[_s]
# the low bits a rotation by s brings round: (1 << s) - 1
_PI_MASK = (np.int64(1) << _PI_ROT) - 1

# chi: lane (x, y) combines lanes ((x+1) % 5, y) and ((x+2) % 5, y)
_CHI_1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)])
_CHI_2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)])
# theta: D[x] = C[x - 1] ^ rotl(C[x + 1], 1)
_THETA_SRC = np.array([(x - 1) % 5 for x in range(5)])
_THETA_ROT = np.array([(x + 1) % 5 for x in range(5)])


def _rotl(v: torch.Tensor, shift, mask) -> torch.Tensor:
    """64-bit rotate-left of int64 lanes by `shift` in [0, 63] (int or
    per-lane tensor); `mask` = (1 << shift) - 1. `(v >> 1) >> (63 - s)`
    keeps every shift below 64, so s = 0 is defined."""
    return (v << shift) | (((v >> 1) >> (63 - shift)) & mask)


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """Batched keccak-f[1600]: (..., 25) int64 -> the same shape."""
    dev = state.device
    pi_src, pi_rot, pi_mask = (const(t, dev) for t in
                               (_PI_SRC, _PI_ROT, _PI_MASK))
    chi_1, chi_2 = const(_CHI_1, dev), const(_CHI_2, dev)
    th_src, th_rot = const(_THETA_SRC, dev), const(_THETA_ROT, dev)
    rc = const(_RC, dev)
    a = state
    for rnd in range(24):
        c = a[..., 0:5] ^ a[..., 5:10] ^ a[..., 10:15] ^ a[..., 15:20] \
            ^ a[..., 20:25]
        d = c[..., th_src] ^ _rotl(c[..., th_rot], 1, 1)
        a = a ^ d.repeat((1,) * (d.dim() - 1) + (5,))
        b = _rotl(a[..., pi_src], pi_rot, pi_mask)
        a = b ^ (~b[..., chi_1] & b[..., chi_2])
        a = torch.cat([a[..., :1] ^ rc[rnd], a[..., 1:]], dim=-1)
    return a


def pad_message(length: int) -> int:
    """Padded length (a multiple of the 136-byte rate) of a message."""
    return length + (RATE_BYTES - length % RATE_BYTES)


@functools.lru_cache(maxsize=None)
def _padding(length: int) -> np.ndarray:
    """The bytes after a message of `length`: 0x01, zeros, 0x80 (made once
    per length, so `const` keeps one tensor of it per device)."""
    pad = np.zeros(pad_message(length) - length, np.uint8)
    pad[0] = 0x01
    pad[-1] |= 0x80
    return pad


def keccak256_fixed(data: torch.Tensor) -> torch.Tensor:
    """Batched keccak-256 over fixed-length messages: data (..., L) uint8
    -> (..., 32) uint8."""
    length = data.shape[-1]
    lead = data.shape[:-1]
    padded_len = pad_message(length)
    pad = _padding(length)
    padded = torch.cat([data, const(pad, data.device).expand(
        lead + pad.shape)], dim=-1)
    state = torch.zeros(lead + (25,), dtype=torch.int64, device=data.device)
    for i in range(padded_len // RATE_BYTES):
        block = padded[..., i * RATE_BYTES:(i + 1) * RATE_BYTES].contiguous()
        lanes = block.view(torch.int64)              # little-endian lanes
        state = torch.cat([state[..., :RATE_LANES] ^ lanes,
                           state[..., RATE_LANES:]], dim=-1)
        state = keccak_f1600(state)
    return state[..., :4].contiguous().view(torch.uint8)


def keccak_fixed_kernel(data: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/keccak_fixed.cu` on data (N, L) uint8, a contiguous
    CUDA tensor; returns (N, 32) uint8, equal to `keccak256_fixed`."""
    if data.dim() != 2:
        raise ValueError(f"data: expected (N, L), got {tuple(data.shape)}")
    n, length = data.shape
    _build.check_tensor(data, (n, length), "data", torch.uint8)
    out = torch.empty((n, 32), dtype=torch.uint8, device=data.device)
    if n:
        KERNEL.launch(_build.ptr(data), n, length, _build.ptr(out))
    return out


def keccak256(data: torch.Tensor) -> torch.Tensor:
    """Batched keccak-256 over fixed-length messages, (..., L) uint8 ->
    (..., 32) uint8: the kernel for a CUDA tensor (one launch), the plain
    version for a CPU tensor."""
    if not route.use_kernel(data):
        return keccak256_fixed(data)
    lead, length = data.shape[:-1], data.shape[-1]
    flat = data.reshape(math.prod(lead), length).to(torch.uint8).contiguous()
    return keccak_fixed_kernel(flat).reshape(lead + (32,))


# -- the kernel's work, for its bound ----------------------------------------


def permutations(n: int, length: int) -> int:
    """keccak-f permutations of n messages of `length` bytes: one a
    136-byte block, the padding's included."""
    return n * (length // RATE_BYTES + 1)
