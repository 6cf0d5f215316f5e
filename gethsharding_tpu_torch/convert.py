"""Carry the JAX package's state across to the port.

`to_port` turns the reference's numpy limb planes (any integer dtype,
22-limb exact or 25-limb wide form) into port tensors: int32, 25 limbs,
on the port's device. `line_tables_from_reference` carries the state of
the precomp path across: a resident line table and its infinity flags.
`srs_from_reference` carries the DAS multiproofs' structured reference
string across: the same powers of τ as the port's `pcs.SRS`.
`replay_inputs_from_reference`, `vote_state_from_reference`,
`vote_attempts_from_reference` and `stress_inputs_from_reference` carry
the replay, vote-batch and stress planes across (the reference's
NamedTuples of arrays, read as numpy), limb planes in the port's limb
form. `reference_tables` reads the reference's constant
tables and kernel programs from its modules, which the caller passes in
(nothing of the JAX package is imported here), so they can be held byte
for byte against the port's own re-derived tables (`port_tables`).
"""

from __future__ import annotations

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.das import pcs
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.ops.limb import NLIMBS

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


def limbs_to_port_form(plane, device=None) -> torch.Tensor:
    """A 12-bit limb plane (..., 22 | 25) -> int32 (..., NLIMBS) at the
    port's limb form: zero limbs added, or dropped where they are zero
    (a canonical value below 2^264 fits either form)."""
    arr = np.asarray(plane)
    width = arr.shape[-1]
    if width not in (22, mk.KNL):
        raise ValueError(f"not a limb plane: last axis {width}")
    if width > NLIMBS:
        if arr[..., NLIMBS:].any():
            raise ValueError(f"limbs beyond the port's {NLIMBS} are not zero")
        arr = arr[..., :NLIMBS]
    elif width < NLIMBS:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (NLIMBS - width,), arr.dtype)],
            axis=-1)
    return torch.as_tensor(arr.astype(np.int32),
                           device=resolve_device(device))


def _planes(ref, names, limbs, dtypes, device):
    """The named fields of a reference NamedTuple as port tensors: limb
    planes in the port's form, the rest in their dtype."""
    dev = resolve_device(device)
    out = {}
    for name in names:
        arr = np.asarray(getattr(ref, name))
        if name in limbs:
            out[name] = limbs_to_port_form(arr, dev)
        else:
            out[name] = torch.as_tensor(arr.astype(dtypes[arr.dtype.kind]),
                                        device=dev)
    return out


# the dtype of a plane by its numpy kind: bool, uint8 bytes, int32
_KINDS = {"b": np.bool_, "u": np.uint8, "i": np.int32}
_REPLAY_LIMBS = ("tx_e", "tx_r", "tx_s")
_BLS_LIMBS = ("hx", "hy", "sigx", "sigy", "pkx", "pky")


def replay_inputs_from_reference(inp, device=None):
    """A reference `replay_jax.ReplayInputs` -> the port's
    `ops/replay.py::ReplayInputs` on `device`."""
    from gethsharding_tpu_torch.ops import replay

    return replay.ReplayInputs(**_planes(
        inp, replay.ReplayInputs._fields, _REPLAY_LIMBS, _KINDS, device))


def vote_state_from_reference(state, device=None):
    """A reference `smc_jax.VoteState` -> the port's
    `ops/smc.py::VoteState`."""
    from gethsharding_tpu_torch.ops import smc

    return smc.VoteState(**_planes(state, smc.VoteState._fields, (), _KINDS,
                                   device))


def vote_attempts_from_reference(att, device=None):
    """A reference `smc_jax.VoteAttempts` -> the port's
    `ops/smc.py::VoteAttempts`."""
    from gethsharding_tpu_torch.ops import smc

    return smc.VoteAttempts(**_planes(att, smc.VoteAttempts._fields, (),
                                      _KINDS, device))


def stress_inputs_from_reference(inp, device=None):
    """A reference `parallel/stress.py::StressInputs` -> the port's
    `parallel/stress.py::StressInputs`."""
    from gethsharding_tpu_torch.parallel import stress

    return stress.StressInputs(**_planes(
        inp, stress.StressInputs._fields, _REPLAY_LIMBS + _BLS_LIMBS,
        _KINDS, device))


def line_tables_from_reference(tab, inf, device=None):
    """A reference line table (..., 88, 3, 2, 22 | 25) and its infinity
    flags (...,) -> the port's (int32 (..., 88, 3, 2, 25), bool (...))
    tensors, ready for `LineTableCache.insert` or the precomp audit."""
    tab = np.asarray(tab)
    if tab.shape[-4:-1] != bn.LINE_TABLE_SHAPE[:3]:
        raise ValueError(f"not a line table: shape {tab.shape}")
    inf = np.asarray(inf, dtype=bool)
    if inf.shape != tab.shape[:-4]:
        raise ValueError(f"infinity flags {inf.shape} do not match the "
                         f"tables {tab.shape[:-4]}")
    return (to_port(tab, device),
            torch.as_tensor(inf, device=resolve_device(device)))


def srs_from_reference(srs) -> pcs.SRS:
    """A reference `das/pcs.py` SRS (G1 powers as (x, y) int pairs, G2
    powers as pairs of the reference's `Fp2`, None for infinity) -> the
    port's `pcs.SRS` with the same seed, τ and powers."""
    fp2 = lambda v: bls.Fp2(int(v.a), int(v.b))
    g1 = lambda pt: None if pt is None else (int(pt[0]), int(pt[1]))
    g2 = lambda pt: None if pt is None else (fp2(pt[0]), fp2(pt[1]))
    return pcs.SRS(seed=str(srs.seed), tau=int(srs.tau),
                   g1_powers=tuple(map(g1, srs.g1_powers)),
                   g2_powers=tuple(map(g2, srs.g2_powers)))


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
