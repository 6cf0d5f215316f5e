"""The tower's fused product columns and combine, as a CUDA kernel with its
plain PyTorch version.

The port's counterpart of the JAX package's `ops/pallas_conv.py`:

    cols[..., i, a, b, n] = sum_{l+m=n} x[..., i, a, l] · y[..., i, b, m]
    out[..., c, g, n]     = sum_{i,a,b} comb[i, a, b, c, g] · cols[..., i, a, b, n]

for x (..., G, A, 25), y (..., G, B, 25) and a static combine tensor
(G, A, B, C, Gr), giving (..., C, Gr, 49) raw column accumulators. One
operand may have fewer leading dims (a constant against the batch), and
either may have size-1 dims; both broadcast to the common lead, which the
kernel walks through each operand's own strides, without copying a
broadcast operand out to every row. `pair_conv_combine` is the route
(`ops/route.py`): `csrc/conv.cu` for a CUDA tensor,
`pair_conv_combine_plain` (the XLA form of the JAX package,
`bn256_jax.py:154-156`) for a CPU tensor. The columns are exact integers,
so both give the same limbs.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.limb import NLIMBS, const, conv_cols

NCOLS = 2 * NLIMBS - 1
_SMEM_BYTES = 48 * 1024     # static shared-memory limit of one launch
_ROWS_PER_BLOCK = 8         # csrc/conv.cu CONV_ROWS
_ROW_OFF_BYTES = 2 * _ROWS_PER_BLOCK * 8   # csrc/conv.cu row_off
_MAX_DIMS = 6               # csrc/conv.cu CONV_MAX_DIMS

KERNEL = _build.Kernel("conv", "gs_conv",
                       "gethsharding_tpu_torch/csrc/conv.cu",
                       "gethsharding_tpu/ops/pallas_conv.py:113")


def comb_terms(comb: np.ndarray) -> tuple:
    """Static (i, a, b) -> [(c, g, coef), ...] plan of a combine tensor
    (G, A, B, C, Gr): its nonzero entries, in the reference's order."""
    G, A, B, C, Gr = comb.shape
    terms = []
    for i in range(G):
        for a in range(A):
            for b in range(B):
                targets = tuple(
                    (c, g, int(comb[i, a, b, c, g]))
                    for c in range(C) for g in range(Gr)
                    if comb[i, a, b, c, g] != 0)
                if targets:
                    terms.append(((i, a, b), targets))
    return tuple(terms)


_TERM_TABLES: dict = {}


def term_table(comb: np.ndarray) -> np.ndarray:
    """The kernel's form of `comb_terms`: (nterms, 6) int32 rows (i, a, b,
    c, g, coef), made once per combine tensor (keyed by its identity:
    callers pass module-level tensors)."""
    table = _TERM_TABLES.get(id(comb))
    if table is None:
        table = np.asarray(
            [(i, a, b, c, g, coef)
             for (i, a, b), targets in comb_terms(comb)
             for c, g, coef in targets], np.int32).reshape(-1, 6)
        _TERM_TABLES[id(comb)] = table
    return table


def pair_conv_combine_plain(x: torch.Tensor, y: torch.Tensor,
                            comb: np.ndarray) -> torch.Tensor:
    prod = x[..., :, :, None, :, None] * y[..., :, None, :, None, :]
    cols = conv_cols(prod)                                 # (..., G, A, B, 49)
    weights = const(comb, x.device)[..., None]            # (G, A, B, C, Gr, 1)
    return (cols[..., None, None, :] * weights).sum(
        dim=(-6, -5, -4), dtype=torch.int32)


def _operand(t: torch.Tensor, lead: tuple):
    """`t` as int32 with a contiguous (G, A|B, 25) block per row (copied
    only where it is not), and its element strides over the common
    `lead`: 0 on the dims it is broadcast along, so it is read in place."""
    t = t.to(torch.int32)
    block = t.shape[-3:]
    want = (block[1] * block[2], block[2], 1)
    if any(size > 1 and stride != w for size, stride, w in
           zip(block, t.stride()[-3:], want)):
        t = t.contiguous()
    return t, t.expand(lead + block).stride()[:len(lead)]


def _lead_desc(lead: tuple, x_strides: tuple, y_strides: tuple) -> list:
    """(size, x stride, y stride) per leading dim, outermost first, with
    size-1 dims dropped and neighbours merged where both operands walk
    them as one dim."""
    dims = []
    for size, sx, sy in zip(lead, x_strides, y_strides):
        if size == 1:
            continue
        if dims and dims[-1][1] == sx * size and dims[-1][2] == sy * size:
            dims[-1] = (dims[-1][0] * size, sx, sy)
        else:
            dims.append((size, sx, sy))
    return dims


def conv_kernel(x: torch.Tensor, y: torch.Tensor,
                comb: np.ndarray) -> torch.Tensor:
    """Launch `csrc/conv.cu` on x (..., G, A, 25), y (..., G, B, 25) int32
    CUDA tensors whose leading dims broadcast; returns (..., C, Gr, 49),
    equal to `pair_conv_combine_plain`. Each operand is read once, in
    place, whatever it is broadcast along."""
    G, A, B, C, Gr = comb.shape
    for t, name, width in ((x, "x", A), (y, "y", B)):
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() < 3 or tuple(t.shape[-3:]) != (G, width, NLIMBS):
            raise ValueError(f"{name}: expected shape (..., {G}, {width}, "
                             f"{NLIMBS}), got {tuple(t.shape)}")
    lead = tuple(torch.broadcast_shapes(x.shape[:-3], y.shape[:-3]))
    x, x_strides = _operand(x, lead)
    y, y_strides = _operand(y, lead)
    dims = _lead_desc(lead, x_strides, y_strides)
    if len(dims) > _MAX_DIMS:
        raise ValueError(f"{len(dims)} leading dims after merging; the "
                         f"kernel takes {_MAX_DIMS}")
    table = const(term_table(comb), x.device)
    xw, yw = G * A * NLIMBS, G * B * NLIMBS
    smem = 4 * (_ROWS_PER_BLOCK * (xw + yw) + table.numel())
    if smem + _ROW_OFF_BYTES > _SMEM_BYTES:
        raise ValueError(f"operands too wide for one block: {smem} B of "
                         f"shared memory")
    n = math.prod(lead)
    out = torch.empty(lead + (C, Gr, NCOLS), dtype=torch.int32,
                      device=x.device)
    if n == 0:
        return out
    desc = (ctypes.c_longlong * max(1, 3 * len(dims)))(
        *(v for dim in dims for v in dim))
    KERNEL.launch(_build.ptr(x), _build.ptr(y), n, xw, yw, A, B, Gr,
                  _build.ptr(table), table.shape[0], C * Gr, len(dims), desc,
                  _build.ptr(out))
    return out


def pair_conv_combine(x: torch.Tensor, y: torch.Tensor,
                      comb: np.ndarray) -> torch.Tensor:
    """x (..., G, A, 25), y (..., G, B, 25) -> (..., C, Gr, 49): the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not route.use_kernel(x):
        return pair_conv_combine_plain(x, y, comb)
    return conv_kernel(x, y, comb)
