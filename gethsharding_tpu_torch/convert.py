"""Carry the JAX package's state across to the port.

`to_port` turns the reference's numpy limb planes (any integer dtype,
22-limb exact or 25-limb wide form) into port tensors: int32, 25 limbs,
on the port's device. `reference_tables` reads the reference's constant
tables and kernel programs from its modules, which the caller passes in
(nothing of the JAX package is imported here), so they can be held byte
for byte against the port's own re-derived tables (`port_tables`).
"""

from __future__ import annotations

import numpy as np
import torch

from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk

# constant tables of the megakernel module, by name in both packages
KERNEL_TABLES = ("_FOLD_J", "_LIFT_RELAXED", "_MUL_PAD", "_FP2_PAD",
                 "_NEG_PAD", "_GAMMA", "_LINE_PAD", "_ONE12")
# tables of the bn256 module, by name in both packages
BN_TABLES = ("_OPT_OPS", "_GEN_LINES", "_TWF_X", "_TWF_Y", "_TWF2_X",
             "_TWF2_Y", "_HARD_PROGRAM", "_U_NAF", "_B3_G2_LIMBS")


def to_port(plane, device=None) -> torch.Tensor:
    """A limb plane (..., 22 | 25) -> int32 (..., 25) tensor; the exact
    22-limb form widens losslessly with zero limbs."""
    arr = np.asarray(plane)
    if arr.shape[-1] not in (22, mk.KNL):
        raise ValueError(f"not a limb plane: last axis {arr.shape[-1]}")
    if arr.shape[-1] < mk.KNL:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (mk.KNL - arr.shape[-1],),
                           arr.dtype)], axis=-1)
    return torch.as_tensor(arr.astype(np.int32),
                           device=resolve_device(device))


def reference_tables(pallas_finalexp, bn256_jax) -> dict:
    """The reference's tables and programs as numpy arrays, from its
    `ops/pallas_finalexp.py` and `ops/bn256_jax.py` modules."""
    out = {name: np.asarray(getattr(pallas_finalexp, name))
           for name in KERNEL_TABLES}
    out.update({name: np.asarray(getattr(bn256_jax, name))
                for name in BN_TABLES})
    out["program"] = np.asarray(pallas_finalexp._build_program())
    for name, arr in zip(("miller_ops", "miller_lines", "miller_twf"),
                         pallas_finalexp._miller_tables()):
        out[name] = np.asarray(arr)
    return out


def port_tables() -> dict:
    """The port's own tables, under the same names as `reference_tables`."""
    out = {name: getattr(mk, name) for name in KERNEL_TABLES}
    out.update({name: getattr(bn, name) for name in BN_TABLES})
    out["program"] = mk._PROGRAM
    out["miller_ops"] = mk._MILLER_OPS
    out["miller_lines"] = mk._MILLER_LINES
    out["miller_twf"] = mk._MILLER_TWF
    return out


def mismatched_tables(reference: dict, port: dict) -> list:
    """Names whose dtype, shape or bytes differ between the two sides."""
    return sorted(name for name in reference
                  if name not in port
                  or reference[name].dtype != port[name].dtype
                  or reference[name].shape != port[name].shape
                  or reference[name].tobytes() != port[name].tobytes())
