"""DAS multiproof rows with known verdicts, for the tests of
`das_verify_multiproofs` on the CPU, in the exact form and on the card.
Imports nothing of JAX: the rows are made in wire form with the port's
own `das/pcs.py`, the values from a seeded numpy generator.

Every row fits a dev SRS of 16 powers (n <= 8, at most 3 indices), so a
test may shrink the SRS with `GETHSHARDING_DAS_SRS_SIZE`: τ depends only
on the seed, so the rows and their verdicts stay the same."""

import functools

import numpy as np

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.das import pcs

SMALL_SRS_SIZE = "16"


def chunk_values(rng, n: int) -> list:
    """n field elements as the proposer makes them: chunk values of seeded
    random chunks."""
    return [pcs.chunk_value(rng.bytes(64)) for _ in range(n)]


def opened(values, indices) -> tuple:
    """An honest row: (commitment, indices, evals, proof, n)."""
    proof, evals = pcs.open_multi(values, indices)
    return (pcs.g1_to_bytes(pcs.commit(values)), list(indices), evals,
            pcs.g1_to_bytes(proof), len(values))


@functools.lru_cache(maxsize=None)
def hostile_rows():
    """(names, rows, want): two honest rows; a tampered eval, proof and
    commitment; an off-curve commitment; a short proof; a commitment
    coordinate >= p; duplicate indices; an empty set; an index outside
    the domain; an all-zero (infinity) proof on a non-constant
    polynomial; and two rows that are True through the infinity path: a
    constant polynomial (π at infinity) and a set that opens every index
    of its domain (A and π at infinity)."""
    rng = np.random.default_rng(37)
    good = opened(chunk_values(rng, 8), [1, 3, 6])
    c, idx, ev, pf, n = good
    c_pt, p_pt = pcs.g1_from_bytes(c), pcs.g1_from_bytes(pf)
    x = int.from_bytes(c[:32], "big")
    table = [
        ("honest", good, True),
        ("honest one index", opened(chunk_values(rng, 5), [2]), True),
        ("tampered eval",
         (c, idx, [ev[0], (ev[1] + 1) % pcs.N, ev[2]], pf, n), False),
        ("tampered proof",
         (c, idx, ev, pcs.g1_to_bytes(bls.g1_add(p_pt, bls.G1_GEN)), n),
         False),
        ("tampered commitment",
         (pcs.g1_to_bytes(bls.g1_add(c_pt, bls.G1_GEN)), idx, ev, pf, n),
         False),
        ("off-curve commitment", (b"\x07" * 64, idx, ev, pf, n), False),
        ("short proof", (c, idx, ev, pf[:32], n), False),
        ("coordinate >= p",
         ((x + bls.P).to_bytes(32, "big") + c[32:], idx, ev, pf, n), False),
        ("duplicate indices", (c, [1, 1, 6], ev, pf, n), False),
        ("empty set", (c, [], [], pf, n), False),
        ("out-of-domain index", (c, [1, 3, n], ev, pf, n), False),
        ("zero proof", (c, idx, ev, b"\x00" * 64, n), False),
        ("constant polynomial", opened([42] * 4, [0, 2]), True),
        ("every index", opened(chunk_values(rng, 3), [0, 1, 2]), True),
    ]
    names = tuple(name for name, _, _ in table)
    rows = tuple(row for _, row, _ in table)
    want = tuple(ok for _, _, ok in table)
    return names, rows, want


def columns(rows) -> list:
    """Rows -> the five argument lists of `das_verify_multiproofs`."""
    return [list(col) for col in zip(*rows)]
