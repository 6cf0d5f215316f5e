"""KZG-style polynomial commitments over bn256 for DAS multiproofs: the
port's own copy of the JAX package's `das/pcs.py` (it imports nothing of
that package).

**The scheme.** A collation's extended chunks become field elements
``v_i = keccak256(chunk_i) mod N``: evaluations of a degree-<n
polynomial p over the domain x_i = i. The commitment is C = [p(τ)]₁
under a structured reference string of powers of a secret τ. A
multiproof for an index set S is π = [q(τ)]₁ where
``q(x) = (p(x) − r(x)) / z_S(x)``, r interpolating the claimed evals
over S and z_S(x) = ∏_{i∈S}(x − x_i) the vanishing polynomial. The
verifier checks

    e(C − [r(τ)]₁, H) · e(−π, [z_S(τ)]₂) == 1

with [r(τ)]₁ / [z_S(τ)]₂ computed by honest MSMs over the SRS: one G1
proof whatever the number of indices. `verify_multi` here is the scalar
verdict; `das/poly_proofs.py` marshals batches of rows onto the
aggregate-vote pairing kernels, equal to it by construction.

**Trust model (dev SRS).** τ is derived from a keccak chain over a seed
(``GETHSHARDING_DAS_SRS_SEED``), so every node of a devnet derives the
SAME SRS, the JAX package's nodes included: the seed and the size
(``GETHSHARDING_DAS_SRS_SIZE``) are protocol parameters and keep the
JAX package's names. τ is public, which is fine for a development curve
model but means a malicious prover could forge openings. A production
deployment substitutes a ceremony SRS; the verifier code below never
uses τ (honest MSMs only), so only `dev_srs` and the prover shortcut
would change. The prover shortcut (evaluate at the known τ, one scalar
multiplication) gives the same group elements as the honest MSM, since
group elements are canonical.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from gethsharding_tpu_torch.crypto import bn256
from gethsharding_tpu_torch.crypto.bn256 import (G1_GEN, G2_GEN, N, G1Point,
                                                 G2Point, g1_add,
                                                 g1_is_on_curve, g1_mul,
                                                 g1_neg, g2_add, g2_mul,
                                                 pairing_check)
from gethsharding_tpu_torch.crypto.keccak import keccak256

# one uncompressed G1 point: 32-byte x || 32-byte y (all-zero = infinity).
# THE constant the proof-size comparison vs merkle paths is about.
G1_BYTES = 64
PROOF_BYTES = G1_BYTES

# SRS shape defaults: G1 powers cover every polynomial a ≤255-chunk
# erasure extension commits to (degree ≤ 254); G2 powers cover the
# vanishing polynomial of the largest index set one multiproof may
# open (the sampler's cap MAX_SAMPLE_INDICES = 64 → degree ≤ 64).
MAX_SRS_DEGREE = 255
MAX_MULTIPROOF_INDICES = 64

DEFAULT_SRS_SEED = "gethsharding-dev-srs"
_SRS_DOMAIN = b"gethsharding-das-srs:"


def chunk_value(chunk: bytes) -> int:
    """A chunk's field element: keccak of the full chunk bytes reduced
    into the bn256 scalar field. The polynomial's evaluation at the
    chunk's own index — so a multiproof over fetched chunks proves the
    DATA, not just proposer-known scalars."""
    return int.from_bytes(keccak256(bytes(chunk)), "big") % N


# -- the structured reference string ----------------------------------------


@dataclass(frozen=True)
class SRS:
    """Powers of τ: g1_powers[i] = [τ^i]₁, g2_powers[j] = [τ^j]₂.

    `tau` is carried ONLY for the dev-setup prover shortcut; the
    verifier path touches the power tables exclusively."""

    seed: str
    tau: int
    g1_powers: Tuple[G1Point, ...]
    g2_powers: Tuple[G2Point, ...]

    @property
    def max_degree(self) -> int:
        return len(self.g1_powers) - 1

    @property
    def max_set(self) -> int:
        return len(self.g2_powers) - 1


@functools.lru_cache(maxsize=4)
def _dev_srs(seed: str, degree: int, max_set: int) -> SRS:
    tau = int.from_bytes(
        keccak256(_SRS_DOMAIN + seed.encode("utf-8")), "big") % N
    if tau == 0:  # pragma: no cover - a keccak output of exactly kN
        tau = 1
    g1_powers: List[G1Point] = []
    g2_powers: List[G2Point] = []
    acc = 1
    for i in range(degree + 1):
        g1_powers.append(g1_mul(acc, G1_GEN))
        if i <= max_set:
            g2_powers.append(g2_mul(acc, G2_GEN))
        acc = (acc * tau) % N
    return SRS(seed=seed, tau=tau, g1_powers=tuple(g1_powers),
               g2_powers=tuple(g2_powers))


def dev_srs() -> SRS:
    """The process-wide deterministic dev SRS.

    ``GETHSHARDING_DAS_SRS_SEED`` pins the τ derivation seed (every
    node of a devnet must agree or no proof verifies across nodes);
    ``GETHSHARDING_DAS_SRS_SIZE`` overrides the G1 power count for
    experiments with larger domains. Cached per (seed, shape)."""
    seed = os.environ.get("GETHSHARDING_DAS_SRS_SEED", DEFAULT_SRS_SEED)
    degree = int(os.environ.get("GETHSHARDING_DAS_SRS_SIZE",
                                str(MAX_SRS_DEGREE)))
    return _dev_srs(seed, degree, MAX_MULTIPROOF_INDICES)


# -- scalar-field polynomial helpers (mod N) --------------------------------


def _inv(a: int) -> int:
    return pow(a % N, N - 2, N)


def eval_poly(coeffs: Sequence[int], x: int) -> int:
    """Horner evaluation of a coefficient-form polynomial mod N."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % N
    return acc


def vanishing_coeffs(xs: Sequence[int]) -> List[int]:
    """Coefficients of z_S(x) = ∏ (x − x_i), low-order first."""
    coeffs = [1]
    for x in xs:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i + 1] = (nxt[i + 1] + c) % N
            nxt[i] = (nxt[i] - c * x) % N
        coeffs = nxt
    return coeffs


def lagrange_coeffs(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Coefficient form of the unique degree-<m interpolation of
    (x_i, y_i), low-order first. O(m²) — m ≤ MAX_MULTIPROOF_INDICES."""
    m = len(xs)
    coeffs = [0] * m
    for i in range(m):
        # numerator ∏_{j≠i}(x − x_j) built by synthetic division of the
        # full vanishing polynomial is numerically touchy mod N only if
        # done with floats; exact integer division of polynomials works
        # but the direct product is just as cheap at m ≤ 64
        basis = [1]
        denom = 1
        for j in range(m):
            if j == i:
                continue
            nxt = [0] * (len(basis) + 1)
            for k, c in enumerate(basis):
                nxt[k + 1] = (nxt[k + 1] + c) % N
                nxt[k] = (nxt[k] - c * xs[j]) % N
            basis = nxt
            denom = (denom * (xs[i] - xs[j])) % N
        scale = (ys[i] * _inv(denom)) % N
        for k, c in enumerate(basis):
            coeffs[k] = (coeffs[k] + c * scale) % N
    return coeffs


def eval_from_values(values: Sequence[int], x: int) -> int:
    """p(x) for the polynomial defined BY ITS EVALUATIONS values[i] at
    domain points i = 0..n−1 (the chunk-row representation): full-
    domain Lagrange with factorial denominators, O(n)."""
    n = len(values)
    if n == 0:
        return 0
    # prefix[i] = ∏_{j<i}(x−j), suffix[i] = ∏_{j>i}(x−j)
    prefix = [1] * (n + 1)
    for j in range(n):
        prefix[j + 1] = (prefix[j] * (x - j)) % N
    suffix = [1] * (n + 1)
    for j in range(n - 1, -1, -1):
        suffix[j] = (suffix[j + 1] * (x - j)) % N
    fact = [1] * n
    for i in range(1, n):
        fact[i] = (fact[i - 1] * i) % N
    acc = 0
    for i in range(n):
        num = (prefix[i] * suffix[i + 1]) % N
        denom = (fact[i] * fact[n - 1 - i]) % N
        if (n - 1 - i) & 1:
            denom = (-denom) % N
        acc = (acc + values[i] * num % N * _inv(denom)) % N
    return acc


# -- group helpers ----------------------------------------------------------


def g1_msm(scalars: Sequence[int], points: Sequence[G1Point]) -> G1Point:
    """Σ scalars[i]·points[i] — the honest-verifier MSM over SRS
    powers (no τ). Plain double-and-add per term: m ≤ 65 terms."""
    acc: G1Point = None
    for s, p in zip(scalars, points):
        acc = g1_add(acc, g1_mul(s % N, p))
    return acc


def g2_msm(scalars: Sequence[int], points: Sequence[G2Point]) -> G2Point:
    acc: G2Point = None
    for s, p in zip(scalars, points):
        acc = g2_add(acc, g2_mul(s % N, p))
    return acc


def g1_to_bytes(p: G1Point) -> bytes:
    """Uncompressed wire form: x‖y big-endian, all-zero = infinity."""
    if p is None:
        return b"\x00" * G1_BYTES
    return int(p[0]).to_bytes(32, "big") + int(p[1]).to_bytes(32, "big")


def g1_from_bytes(raw: bytes) -> G1Point:
    """Decode `g1_to_bytes`; raises ValueError on wrong length,
    out-of-range coordinates, or an off-curve point (infinity OK)."""
    raw = bytes(raw)
    if len(raw) != G1_BYTES:
        raise ValueError(f"G1 wire point must be {G1_BYTES} bytes")
    x = int.from_bytes(raw[:32], "big")
    y = int.from_bytes(raw[32:], "big")
    if x == 0 and y == 0:
        return None
    if x >= bn256.P or y >= bn256.P:
        raise ValueError("G1 coordinate out of field range")
    point = (x, y)
    if not g1_is_on_curve(point):
        raise ValueError("G1 wire point not on curve")
    return point


# -- commit / open / verify -------------------------------------------------


def commit(values: Sequence[int], srs: Optional[SRS] = None) -> G1Point:
    """C = [p(τ)]₁ for the polynomial with evaluations `values` over
    0..n−1. Dev-setup shortcut: evaluate at the known τ and do ONE
    scalar mult — bit-identical to the honest coefficient MSM because
    group elements are canonical."""
    srs = srs or dev_srs()
    if len(values) > srs.max_degree + 1:
        raise ValueError(f"{len(values)} evaluations exceed SRS degree "
                         f"{srs.max_degree}")
    return g1_mul(eval_from_values([v % N for v in values], srs.tau), G1_GEN)


def open_multi(values: Sequence[int], indices: Sequence[int],
               srs: Optional[SRS] = None) -> Tuple[G1Point, List[int]]:
    """The multiproof for index set `indices`: (π, evals). π is ONE G1
    point whatever len(indices) is. Dev shortcut: q(τ) computed from
    the known τ (q is a polynomial, so q(τ) = (p(τ)−r(τ))/z_S(τ) —
    the division is exact in the field because z_S | p−r)."""
    srs = srs or dev_srs()
    xs = [int(i) for i in indices]
    if len(set(xs)) != len(xs):
        raise ValueError("duplicate indices in multiproof set")
    if any(not 0 <= x < len(values) for x in xs):
        raise ValueError("multiproof index outside the evaluation domain")
    if len(xs) > srs.max_set:
        raise ValueError(f"{len(xs)} indices exceed SRS multiproof cap "
                         f"{srs.max_set}")
    vals = [v % N for v in values]
    evals = [vals[x] for x in xs]
    if not xs:
        return None, []
    p_tau = eval_from_values(vals, srs.tau)
    r_tau = eval_poly(lagrange_coeffs(xs, evals), srs.tau)
    z_tau = 1
    for x in xs:
        z_tau = (z_tau * (srs.tau - x)) % N
    q_tau = ((p_tau - r_tau) * _inv(z_tau)) % N
    return g1_mul(q_tau, G1_GEN), evals


def check_shape(indices: Sequence[int], evals: Sequence[int],
                n: int, srs: SRS) -> bool:
    """The multiproof row's domain preconditions — shared verbatim by
    the scalar reference and the batch marshal so rejection is
    bit-identical by construction. False for: empty set (proves
    nothing, like an empty committee), ragged evals, duplicate or
    out-of-domain indices, evals outside the field, sets beyond the
    SRS cap, domains beyond the SRS degree."""
    try:
        xs = [int(i) for i in indices]
        es = [int(e) for e in evals]
        n = int(n)
    except (TypeError, ValueError):
        return False
    if not xs or len(xs) != len(es):
        return False
    if len(xs) > srs.max_set or len(set(xs)) != len(xs):
        return False
    if not 1 <= n <= srs.max_degree + 1:
        return False
    if any(not 0 <= x < n for x in xs):
        return False
    if any(not 0 <= e < N for e in es):
        return False
    return True


def verify_multi(commitment: G1Point, indices: Sequence[int],
                 evals: Sequence[int], proof: G1Point, n: int,
                 srs: Optional[SRS] = None) -> bool:
    """The scalar verdict: does `proof` open
    `commitment` to `evals` at `indices` over a degree-<n domain?

    Honest verifier — τ never consulted: [r(τ)]₁ and [z_S(τ)]₂ are
    MSMs over the SRS power tables, then one two-pair check
    e(C − R, H)·e(−π, Z) == 1. Malformed inputs (bad shapes, off-curve
    points) are False, never an exception — a hostile proof must cost
    a verdict, not a batch."""
    srs = srs or dev_srs()
    if not check_shape(indices, evals, n, srs):
        return False
    xs = [int(i) for i in indices]
    es = [int(e) for e in evals]
    try:
        r_point = g1_msm(lagrange_coeffs(xs, es), srs.g1_powers)
        z_point = g2_msm(vanishing_coeffs(xs), srs.g2_powers)
        a_point = g1_add(commitment, g1_neg(r_point))
        return pairing_check([(a_point, G2_GEN), (g1_neg(proof), z_point)])
    except (ValueError, TypeError):
        # off-curve / out-of-subgroup inputs raise inside the pairing;
        # the row is hostile, the verdict is False
        return False
