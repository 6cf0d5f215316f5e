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
so both give the same limbs. The tower kernel (`ops/tower.py`) runs the
same device code (`csrc/conv.cuh`) inside each tower product, and takes
its term plan (`plane_plan`) and row walk (`broadcast_rows`) from here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.limb import NLIMBS, const, conv_cols

NCOLS = 2 * NLIMBS - 1
_SMEM_BYTES = 48 * 1024     # shared-memory limit of one launch
_THREADS = 128              # csrc/conv.cu CONV_THREADS
_ITEMS = 5                  # csrc/conv.cu CONV_ITEMS: work items per plane
_MAX_ROWS = 8               # csrc/conv.cu CONV_MAX_ROWS
_ROW_OFF_BYTES = 2 * _MAX_ROWS * 8   # csrc/conv.cu row_off
_MAX_DIMS = 6               # csrc/conv.cuh CONV_MAX_DIMS
_SMS = 132                  # streaming multiprocessors of an H100

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


_PLANS: dict = {}


def plane_plan(comb: np.ndarray) -> np.ndarray:
    """The kernels' form of `comb_terms`, grouped by output plane p =
    c·Gr + g: one int32 array of C·Gr + 1 offsets (plane p's terms are
    rows off[p]..off[p+1]) followed by the (nterms, 4) rows (i, a, b,
    coef), each plane's in the reference's order. Made once per combine
    tensor (keyed by its identity: callers pass module-level tensors)."""
    plan = _PLANS.get(id(comb))
    if plan is None:
        C, Gr = comb.shape[3:]
        planes = [[] for _ in range(C * Gr)]
        for (i, a, b), targets in comb_terms(comb):
            for c, g, coef in targets:
                planes[c * Gr + g].append((i, a, b, coef))
        offsets = np.cumsum([0] + [len(p) for p in planes])
        terms = [t for p in planes for t in p]
        plan = np.concatenate([offsets, np.ravel(terms)]).astype(np.int32)
        _PLANS[id(comb)] = plan
    return plan


def plan_terms(plan: np.ndarray, planes: int) -> np.ndarray:
    """The (nterms, 4) term rows of a `plane_plan`."""
    return plan[planes + 1:].reshape(-1, 4)


def pair_conv_combine_plain(x: torch.Tensor, y: torch.Tensor,
                            comb: np.ndarray) -> torch.Tensor:
    prod = x[..., :, :, None, :, None] * y[..., :, None, :, None, :]
    cols = conv_cols(prod)                                 # (..., G, A, B, 49)
    weights = const(comb, x.device)[..., None]            # (G, A, B, C, Gr, 1)
    return (cols[..., None, None, :] * weights).sum(
        dim=(-6, -5, -4), dtype=torch.int32)


def _lead_strides(shape: tuple, stride: tuple, lead: tuple):
    """An operand's element strides over the common `lead` (0 on the dims
    it is broadcast along, so it is read in place), and whether it must
    be copied first to make its (G, A|B, 25) block contiguous."""
    block = shape[-3:]
    want = (block[1] * block[2], block[2], 1)
    copy = any(size > 1 and st != w
               for size, st, w in zip(block, stride[-3:], want))
    if copy:    # the strides of its contiguous copy
        stride, step = [], 1
        for size in reversed(shape):
            stride.insert(0, step)
            step *= size
    skip = len(lead) - (len(shape) - 3)
    return tuple(0 if d < skip or shape[d - skip] == 1 else stride[d - skip]
                 for d in range(len(lead))), copy


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


@functools.lru_cache(maxsize=1024)
def broadcast_plan(x_shape: tuple, x_stride: tuple, y_shape: tuple,
                   y_stride: tuple):
    """The batch rows of two operands (..., G, A|B, 25) of these shapes
    and strides, whose leading dims broadcast: (lead, rows, ndim, desc,
    x_copy, y_copy). `desc` holds the kernels' `ConvLead` triples as a
    ctypes array; an operand is copied (x_copy, y_copy) only where its
    block per row is not contiguous. Made once per shape and strides."""
    lead = tuple(torch.broadcast_shapes(x_shape[:-3], y_shape[:-3]))
    xs, x_copy = _lead_strides(x_shape, x_stride, lead)
    ys, y_copy = _lead_strides(y_shape, y_stride, lead)
    dims = _lead_desc(lead, xs, ys)
    if len(dims) > _MAX_DIMS:
        raise ValueError(f"{len(dims)} leading dims after merging; the "
                         f"kernels take {_MAX_DIMS}")
    if math.prod(lead) >= 1 << 31:   # the kernels index rows in 32 bits
        raise ValueError(f"{math.prod(lead)} rows: the kernels take fewer "
                         f"than 2^31")
    desc = (ctypes.c_longlong * max(1, 3 * len(dims)))(
        *(v for dim in dims for v in dim))
    return lead, math.prod(lead), len(dims), desc, x_copy, y_copy


def check_operand(t: torch.Tensor, block: tuple, name: str) -> None:
    """What the conv and tower kernels take: an int32 CUDA tensor (...,
    *block)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() < len(block) or t.shape[-len(block):] != block:
        raise ValueError(f"{name}: expected shape (..., "
                         f"{', '.join(map(str, block))}), got "
                         f"{tuple(t.shape)}")


def broadcast_rows(x: torch.Tensor, y: torch.Tensor):
    """`broadcast_plan` of two operands: (x, y, lead, rows, ndim, desc),
    each operand with a contiguous block per row, read in place through
    its own strides over the common lead."""
    lead, n, ndim, desc, x_copy, y_copy = broadcast_plan(
        x.shape, x.stride(), y.shape, y.stride())
    if x_copy:
        x = x.contiguous()
    if y_copy:
        y = y.contiguous()
    return x, y, lead, n, ndim, desc


def rows_per_block(n: int, planes: int) -> int:
    """Rows per block of a conv launch: as many as keep one work item per
    thread, but no more than leave at least two blocks per SM."""
    fit = max(1, _THREADS // (planes * _ITEMS))
    return max(1, min(fit, _MAX_ROWS, -(-n // (2 * _SMS))))


def conv_kernel(x: torch.Tensor, y: torch.Tensor,
                comb: np.ndarray) -> torch.Tensor:
    """Launch `csrc/conv.cu` on x (..., G, A, 25), y (..., G, B, 25) int32
    CUDA tensors whose leading dims broadcast; returns (..., C, Gr, 49),
    equal to `pair_conv_combine_plain`. Each operand is read once, in
    place, whatever it is broadcast along."""
    G, A, B, C, Gr = comb.shape
    check_operand(x, (G, A, NLIMBS), "x")
    check_operand(y, (G, B, NLIMBS), "y")
    x, y, lead, n, ndim, desc = broadcast_rows(x, y)
    plan = const(plane_plan(comb), x.device)
    xw, yw = G * A * NLIMBS, G * B * NLIMBS
    rpb = rows_per_block(n, C * Gr)
    smem = 4 * ((rpb * xw + 3) // 4 * 4 + (rpb * yw + 3) // 4 * 4
                + plan.numel() + rpb * C * Gr * NCOLS)
    if smem + _ROW_OFF_BYTES > _SMEM_BYTES:
        raise ValueError(f"operands too wide for one block: {smem} B of "
                         f"shared memory")
    out = torch.empty(lead + (C, Gr, NCOLS), dtype=torch.int32,
                      device=x.device)
    if n == 0:
        return out
    nterms = plan_terms(plane_plan(comb), C * Gr).shape[0]
    KERNEL.launch(_build.ptr(x), _build.ptr(y), n, xw, yw, A, B,
                  _build.ptr(plan), C * Gr, nterms, rpb, ndim, desc,
                  _build.ptr(out))
    return out


def pair_conv_combine(x: torch.Tensor, y: torch.Tensor,
                      comb: np.ndarray) -> torch.Tensor:
    """x (..., G, A, 25), y (..., G, B, 25) -> (..., C, Gr, 49): the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not route.use_kernel(x):
        return pair_conv_combine_plain(x, y, comb)
    return conv_kernel(x, y, comb)
