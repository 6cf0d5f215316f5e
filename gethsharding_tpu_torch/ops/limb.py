"""Batched 256-bit modular arithmetic in PyTorch: 12-bit limbs in int32.

The port's counterpart of the JAX package's `ops/limb.py`, in one of its
two lazy forms, chosen by `$GETHSHARDING_TORCH_LIMB_FORM` at import (the
port reads only its own knobs):

- "wide" (default): a field element is 25 little-endian 12-bit limbs in
  int32, shape ``(..., 25)``, value in [0, 2^273), congruent mod p;
- "exact": 22 limbs, value in [0, 2^264).

The leading axes are the batch. Products of limbs are 24 bits and callers
never sum more than four 25-term schoolbook columns, so every column
stays below 2^30.7.

`ModArith.normalize` follows the reference's normalize of the chosen
form step for step (wide: three relaxed carry rounds, one fold through
the 2^(12(22+k)) mod p rows, a lift, one exact carry; exact: the ladder
of two relaxed folds and three exact carries), so its limbs equal the
reference's limb for limb; it is the route of `ops/norm.py`: its CUDA
kernel for a CUDA tensor, its plain version for a CPU tensor. Only the
exact carry of the plain version differs in how it is computed: the
reference ripples limb by limb, this one ripples over int64 words of
three limbs, which gives the same canonical limbs in a third of the
steps. `canon` reaches the unique representative below p through a
float64 quotient estimate and one corrected subtraction instead of the
reference's descent; the result is the same unique value.

`ModArith.mul` on a CUDA tensor is one launch of the tower kernel
(`ops/tower.py`): the conv with the identity combine of one plane, then
the normalize, in one pass. Its plain route, `mul_cols` then `normalize`,
gives the same limbs; `mul_cols` on a CUDA tensor goes through the conv
kernel of `ops/conv.py`, which gives the same integer columns as
`conv_cols`. The JAX package computes its `mul_cols` outside any Pallas
kernel; this routing is the port's own choice, so that every product on
the card runs in a hand-written kernel. Both kernels run in the form the
module was imported with.

`ModArith` takes any prime below 2^256: bn256's p (the audit) and
secp256k1's p and n (`ops/secp256k1.py`). `pow_static`, `inv`, `select`
and `lt_raw` (the raw-value comparison of the recovery's range checks)
are the reference's, built on the same normalize.
The relaxed normalize option is not part of this module yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1
LIMB_FORM = os.environ.get("GETHSHARDING_TORCH_LIMB_FORM", "wide")
if LIMB_FORM == "wide":
    NLIMBS = 25    # operand width: 300 bits of capacity
    LAZY_BITS = 273  # lazy-form value bound
elif LIMB_FORM == "exact":
    NLIMBS = 22
    LAZY_BITS = 264
else:
    raise ValueError("GETHSHARDING_TORCH_LIMB_FORM must be 'wide' or "
                     f"'exact', got {LIMB_FORM!r}")
FOLD_BASE = 22     # limbs >= FOLD_BASE fold back under the modulus
FOLD_ROWS = 33     # max high limbs a single fold can absorb


def int_to_limbs(value: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Little-endian 12-bit limb decomposition of a non-negative int."""
    if value < 0:
        raise ValueError("negative value")
    limbs = np.zeros(nlimbs, dtype=np.int32)
    for i in range(nlimbs):
        limbs[i] = value & LIMB_MASK
        value >>= LIMB_BITS
    if value:
        raise ValueError("value does not fit in limbs")
    return limbs


def limbs_to_int(limbs):
    """Inverse of int_to_limbs: a python int for one limb vector, an
    object array of ints for a batch (accepts numpy or torch)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs)
    if arr.ndim == 1:
        return sum(int(arr[i]) << (LIMB_BITS * i)
                   for i in range(arr.shape[-1]))
    out = np.zeros(arr.shape[:-1], dtype=object)
    for i in range(arr.shape[-1]):
        out = out + (arr[..., i].astype(object) << (LIMB_BITS * i))
    return out


def ints_to_limbs(values: Sequence[int], nlimbs: int = NLIMBS,
                  out_dtype=np.int32) -> np.ndarray:
    """Batch conversion: (batch,) python ints -> (batch, nlimbs) limbs,
    through one to_bytes per int and a numpy bit-plane extraction."""
    n = len(values)
    if n == 0:
        return np.zeros((0, nlimbs), out_dtype)
    nbytes = -(-nlimbs * LIMB_BITS // 8)
    try:
        raw = b"".join(v.to_bytes(nbytes, "little") for v in values)
    except OverflowError as exc:
        raise ValueError(f"value out of range for {nlimbs} limbs") from exc
    arr = np.frombuffer(raw, np.uint8).reshape(n, nbytes)
    spare_bits = nbytes * 8 - nlimbs * LIMB_BITS
    if spare_bits and (arr[:, -1] >> (8 - spare_bits)).any():
        raise ValueError("value does not fit in limbs")
    pairs = nlimbs // 2
    out = np.empty((n, nlimbs), out_dtype)
    if pairs:
        main = arr[:, :pairs * 3].reshape(n, pairs, 3).astype(np.uint16)
        out[:, 0:2 * pairs:2] = main[..., 0] | ((main[..., 1] & 0x0F) << 8)
        out[:, 1:2 * pairs:2] = (main[..., 1] >> 4) | (main[..., 2] << 4)
    if nlimbs % 2:
        b0 = pairs * 3
        tail = arr[:, b0].astype(np.int32)
        if b0 + 1 < nbytes:
            tail |= (arr[:, b0 + 1].astype(np.int32) & 0x0F) << 8
        out[:, -1] = tail
    return out


_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy constant as a tensor on `device`, made once per device
    (keyed by the array's identity: callers pass module-level tables)."""
    key = (id(arr), str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        hit = torch.as_tensor(np.ascontiguousarray(arr), device=device)
        _CONSTS[key] = hit
    return hit


def pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-extend the limb axis to `width`."""
    extra = width - x.shape[-1]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (extra,))], dim=-1)


def _relax(z: torch.Tensor) -> torch.Tensor:
    """One growing relaxed carry round: width + 1, value preserved."""
    z = pad_last(z, z.shape[-1] + 1)
    lo = z & LIMB_MASK
    c = z >> LIMB_BITS  # arithmetic shift: negative carries are borrows
    return lo + torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c[..., :-1]],
                          dim=-1)


def conv_cols(prod: torch.Tensor) -> torch.Tensor:
    """Anti-diagonal column sums (..., L, M) -> (..., L+M-1), out[n] =
    sum over l of prod[l, n-l]: each row padded by L zeros and re-viewed
    at width M+L-1 puts element (l, m) at column l+m (the reference's
    "shift" form)."""
    L, M = prod.shape[-2:]
    batch = prod.shape[:-2]
    flat = pad_last(prod, M + L).reshape(batch + (L * (M + L),))
    cols = flat[..., : L * (M + L - 1)].reshape(batch + (L, M + L - 1))
    return cols.sum(dim=-2, dtype=torch.int32)


_WORD = 3 * LIMB_BITS
_WORD_MASK = (1 << _WORD) - 1


def carry(z: torch.Tensor):
    """Exact carry propagation along the limb axis of an int32 tensor
    whose limbs have magnitude < 2^31. Returns (carry_out, limbs): the
    signed carry off the top (int64) and canonical int32 limbs, so that
    value(z) = value(limbs) + carry_out · 2^(12·L)."""
    n = z.shape[-1]
    pad = (-n) % 3
    z64 = pad_last(z, n + pad).to(torch.int64)
    z64 = z64.reshape(z64.shape[:-1] + ((n + pad) // 3, 3))
    w = z64[..., 0] + (z64[..., 1] << LIMB_BITS) + (z64[..., 2] << 2 * LIMB_BITS)
    c = torch.zeros_like(w[..., 0])
    words = []
    for k in range(w.shape[-1]):
        t = w[..., k] + c
        c = t >> _WORD
        words.append(t & _WORD_MASK)
    w = torch.stack(words, dim=-1)
    limbs = torch.stack([(w >> (LIMB_BITS * j)) & LIMB_MASK for j in range(3)],
                        dim=-1).reshape(z64.shape[:-2] + (n + pad,))
    top = c << (LIMB_BITS * pad)
    for j in range(pad):
        top = top + (limbs[..., n + j] << (LIMB_BITS * j))
    return top, limbs[..., :n].to(torch.int32)


# canon's working width: a value below 2^300 and the four limbs of its
# quotient's product with p
_CANON_W = FOLD_BASE + 4


class ModArith:
    """Batched arithmetic mod a fixed prime p < 2^256 in the lazy form of
    `LIMB_FORM`; every method takes and returns int32 tensors (..., L) on
    any device."""

    def __init__(self, p: int):
        if p.bit_length() > 256:
            raise ValueError("modulus too large for the lazy limb form")
        self.p = p
        self.one = int_to_limbs(1)
        self.fold_j = np.stack(
            [int_to_limbs(pow(1 << (LIMB_BITS * (FOLD_BASE + k)), 1, p),
                          FOLD_BASE)
             for k in range(FOLD_ROWS)])                  # (33, 22)
        cover_bits = LIMB_BITS * NLIMBS
        self.sub_pad = int_to_limbs(-(-(1 << cover_bits) // p) * p,
                                    -(-(cover_bits + 1) // LIMB_BITS))
        self.lift = int_to_limbs(-(-(1 << 261) // p) * p, FOLD_BASE)
        self.p_limbs = int_to_limbs(p, _CANON_W)
        self._pad_cache: dict = {}
        self.mul_plan = tower.Plan(
            tower.FP, self, _IDENTITY, np.zeros((1, 1, 2 * NLIMBS - 1),
                                                np.int32),
            plain=lambda u, v: self.mul(u[..., 0, 0, :], v[..., 0, 0, :]))

    def normalize(self, z: torch.Tensor) -> torch.Tensor:
        """Reduce any accumulator (..., L) with |limb| < 2^30.7 and value
        >= 0 to lazy form: NLIMBS canonical limbs, value < 2^LAZY_BITS,
        same residue mod p."""
        return norm.normalize(self, z)

    def add(self, x, y):
        return self.normalize(x + y)

    def mul_small(self, x, c: int):
        """Multiply by a small non-negative int (c < 2^16)."""
        return self.normalize(x * c)

    def mul_cols(self, x, y):
        """Raw schoolbook product columns (..., 2·NLIMBS - 1), each
        < 25·2^24; leading dims broadcast."""
        cols = conv.pair_conv_combine(x[..., None, None, :],
                                      y[..., None, None, :], _IDENTITY)
        return cols[..., 0, 0, :]

    def mul(self, x, y):
        """x·y in lazy form; leading dims broadcast. One tower-kernel
        launch on a CUDA tensor."""
        if route.use_kernel(x):
            return tower.tower_kernel(self.mul_plan, x[..., None, None, :],
                                      y[..., None, None, :])
        return self.normalize(self.mul_cols(x, y))

    def pad_mult(self, bits: int) -> np.ndarray:
        """Limb form of the smallest multiple of p >= 2^bits (cached):
        added to an accumulator before subtracting values below 2^bits."""
        cached = self._pad_cache.get(bits)
        if cached is None:
            value = -(-(1 << bits) // self.p) * self.p
            cached = int_to_limbs(value, -(-value.bit_length() // LIMB_BITS))
            self._pad_cache[bits] = cached
        return cached

    def sub(self, x, y):
        w = max(x.shape[-1], self.sub_pad.shape[0])
        diff = pad_last(x - y, w)
        return self.normalize(diff + pad_last(
            const(self.sub_pad, x.device), w))

    def neg(self, x):
        return self.sub(torch.zeros_like(x), x)

    def canon(self, x: torch.Tensor) -> torch.Tensor:
        """The unique representative < p of a non-negative limb vector
        (value < 2^300), as NLIMBS canonical limbs."""
        _, z = carry(pad_last(x, _CANON_W))                 # (..., 26)
        v = torch.zeros(z.shape[:-1], dtype=torch.float64, device=z.device)
        for i in reversed(range(z.shape[-1])):
            v = v * float(1 << LIMB_BITS) + z[..., i].to(torch.float64)
        q = torch.floor(v / float(self.p)).clamp_(min=0).to(torch.int64)
        # q < 2^47: four limbs; q·p as schoolbook columns (< 2^26 each)
        ql = torch.stack([(q >> (LIMB_BITS * j)) & LIMB_MASK
                          for j in range(4)], dim=-1).to(torch.int32)
        pl = const(self.p_limbs, z.device)[:FOLD_BASE]
        cols = z.new_zeros(z.shape)
        for j in range(4):
            cols[..., j:j + FOLD_BASE] += ql[..., j:j + 1] * pl
        d = z - cols                    # value in [-p, 2p) by the estimate
        p26 = const(self.p_limbs, z.device)
        c_mid, r_mid = carry(d)
        c_lo, r_lo = carry(d - p26)
        _, r_hi = carry(d + p26)
        out = torch.where((c_mid < 0).unsqueeze(-1), r_hi,
                          torch.where((c_lo >= 0).unsqueeze(-1), r_lo, r_mid))
        return out[..., :NLIMBS]

    def is_zero(self, x: torch.Tensor) -> torch.Tensor:
        return (self.canon(x) == 0).all(dim=-1)

    def eq(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (self.canon(x) == self.canon(y)).all(dim=-1)

    def select(self, cond: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        """Limbs of x where cond (...,) holds, else of y."""
        return torch.where(cond[..., None], x, y)

    def pow_static(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x^e for a fixed exponent: the reference's right-to-left
        square-and-multiply, with the product taken only at the bits that
        are set (where its select keeps it) and no square after the top
        bit (which nothing reads), so the limbs are the reference's."""
        acc = const(self.one, x.device).expand(x.shape)
        if e == 0:
            return acc.clone()
        base = x
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                acc = self.mul(acc, base)
            if i + 1 < e.bit_length():
                base = self.mul(base, base)
        return acc

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Modular inverse by Fermat (p prime); inv(0) = 0."""
        return self.pow_static(x, self.p - 2)


def lt_raw(x: torch.Tensor, bound: np.ndarray) -> torch.Tensor:
    """Is the raw value of the limbs x below that of `bound` (limbs of
    the same width)? Not a residue comparison: the sign of the exact
    carry's borrow out of x - bound."""
    borrow, _ = carry(x - const(bound, x.device))
    return borrow < 0


# the identity combine of one product plane (`ModArith.mul_cols`)
_IDENTITY = np.ones((1, 1, 1, 1, 1), np.int32)

# imported last: they build on this module's helpers
from gethsharding_tpu_torch.ops import conv, norm, route, tower  # noqa: E402
