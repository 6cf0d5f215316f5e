"""Batched DAS multiproof verification: the scalar verdicts and the
fixed-shape planes of `das_verify_multiproofs`; the port's own copy of
the JAX package's `das/poly_proofs.py`.

One ROW is one sampled collation in a period: a 64-byte G1 commitment,
the sampled index set, the claimed chunk-value evaluations, ONE 64-byte
G1 multiproof, and the collation's domain size n. The verdict is
`pcs.verify_multi`: does e(C − [r(τ)]₁, H)·e(−π, [z_S(τ)]₂) == 1.

`verify_multiproofs` is the scalar batch face. `marshal_multiproofs`
folds each row's interpolation and vanishing MSMs on the host into three
group points per row, A = C − [r(τ)]₁ (G1), π (G1) and Z = [z_S(τ)]₂
(G2): the (sig, H, pk) slots of `ops/bn256.py::bls_verify_aggregate_batch`,
which computes e(sig, G2_GEN)·e(−H, pk) == 1 on the Miller and
final-exponentiation kernels. No new kernel.

The verdicts equal the scalar ones by construction: every scalar
rejection (bad shapes, undecodable or off-curve wire points) becomes
`valid=False` at marshal time, and the rare rows the pairing kernels
cannot represent (A, π or Z at infinity: a constant polynomial's zero
quotient, or a set that opens every index) are settled on the host by
the scalar verifier itself, which ships a trivially true pairing row
where its verdict is True.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from gethsharding_tpu_torch.crypto.bn256 import (G1_GEN, G2_GEN, g1_add,
                                                 g1_neg)
from gethsharding_tpu_torch.das import pcs
from gethsharding_tpu_torch.ops.bn256 import g1_to_limbs, g2_to_limbs

# re-exported caps: samplers size their index sets by these
MAX_MULTIPROOF_INDICES = pcs.MAX_MULTIPROOF_INDICES
PROOF_BYTES = pcs.PROOF_BYTES
# the planes of `marshal_multiproofs` in the argument order of
# `bls_verify_aggregate_batch`: π in the hash slot, A in the signature
# slot, Z in the pubkey slot
PLANES = ("px", "py", "ax", "ay", "zx", "zy", "valid")


def verify_multiproof(commitment: bytes, indices: Sequence[int],
                      evals: Sequence[int], proof: bytes, n: int,
                      srs: Optional[pcs.SRS] = None) -> bool:
    """One row's verdict from wire-form (64-byte) G1 points: undecodable
    points are False, never raise."""
    srs = srs or pcs.dev_srs()
    try:
        c_point = pcs.g1_from_bytes(commitment)
        p_point = pcs.g1_from_bytes(proof)
    except (TypeError, ValueError):
        return False
    return pcs.verify_multi(c_point, indices, evals, p_point, n, srs)


def verify_multiproofs(commitments: Sequence[bytes],
                       index_rows: Sequence[Sequence[int]],
                       eval_rows: Sequence[Sequence[int]],
                       proofs: Sequence[bytes],
                       ns: Sequence[int]) -> List[bool]:
    """The scalar batch face: `verify_multiproof` row by row."""
    srs = pcs.dev_srs()
    return [verify_multiproof(c, idx, ev, pf, n, srs)
            for c, idx, ev, pf, n
            in zip(commitments, index_rows, eval_rows, proofs, ns)]


def marshal_multiproofs(commitments: Sequence[bytes],
                        index_rows: Sequence[Sequence[int]],
                        eval_rows: Sequence[Sequence[int]],
                        proofs: Sequence[bytes],
                        ns: Sequence[int], bucket: int) -> dict:
    """Rows -> the pairing kernels' fixed (bucket, ...) limb planes, in
    the port's limb form.

    Host side per row: decode the two wire points, run the row's
    interpolation MSM [r(τ)]₁ and vanishing MSM [z_S(τ)]₂ over the SRS
    power tables, and fold A = C − [r(τ)]₁. The device then checks
    e(A, G2_GEN)·e(−π, Z) == 1 for the whole bucket in one call.

    Planes: px/py = π limbs (the kernel's H slot, negated on device),
    ax/ay = A limbs (sig slot), zx/zy = Z limbs (pk slot), valid, rows.
    """
    srs = pcs.dev_srs()
    rows = len(commitments)
    a_points = [None] * bucket
    p_points = [None] * bucket
    z_points = [None] * bucket
    valid = [False] * bucket
    for b in range(rows):
        indices = index_rows[b]
        evals = eval_rows[b]
        if not pcs.check_shape(indices, evals, ns[b], srs):
            continue
        try:
            c_point = pcs.g1_from_bytes(commitments[b])
            p_point = pcs.g1_from_bytes(proofs[b])
        except (TypeError, ValueError):
            continue
        xs = [int(i) for i in indices]
        es = [int(e) for e in evals]
        r_point = pcs.g1_msm(pcs.lagrange_coeffs(xs, es), srs.g1_powers)
        z_point = pcs.g2_msm(pcs.vanishing_coeffs(xs), srs.g2_powers)
        a_point = g1_add(c_point, g1_neg(r_point))
        if a_point is None or p_point is None or z_point is None:
            # a point at infinity has no affine limb form; the scalar
            # pairing skips such pairs, so settle the row on the host
            # and ship either a trivially true pairing or valid=False
            if pcs.verify_multi(c_point, xs, es, p_point, ns[b], srs):
                a_point, p_point, z_point = G1_GEN, G1_GEN, G2_GEN
            else:
                continue
        a_points[b] = a_point
        p_points[b] = p_point
        z_points[b] = z_point
        valid[b] = True
    ax, ay, aok = g1_to_limbs(a_points)
    px, py, pok = g1_to_limbs(p_points)
    zx, zy, zok = g2_to_limbs(z_points)
    return {"px": px, "py": py, "ax": ax, "ay": ay, "zx": zx, "zy": zy,
            "valid": aok & pok & zok & valid, "rows": rows}
