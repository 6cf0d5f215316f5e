"""Deterministic sample selection + the soundness accounting behind k (the
port's copy of the JAX package's `das/sampler.py`, on the port's host
keccak).

**Selection.** A notary's sample indices for one (shard, period) are a
pure function of (its account, the shard, the period, the DAS root):
keccak-chained draws without replacement. Deterministic on purpose —
a vote can be audited by replaying the exact indices the notary was
obliged to check, a crashed notary resumes the same check, and tests
are seedable. The classic objection (a withholding proposer could
precompute a known notary's indices and serve exactly those) is
accounted for in the soundness model below rather than hidden:
per-checker unpredictability is the LIGHT-client posture (the JAX
package's `actors/light.py` draws a fresh random seed per check); committee
soundness rests on the adversary having to satisfy EVERY sampled
committee member at once, and the committee itself is sampled by the
SMC from the mainchain blockhash AFTER the header lands — the
proposer commits to the blob before it learns who will check it.

**Soundness.** The erasure code (`erasure.py`) forces an adversary who
wants the body unrecoverable to withhold at least n-k_data+1 of the n
extended chunks (fewer and any k_data survivors reconstruct). The
best such adversary withholds exactly that minimum, leaving
a = k_data-1 available chunks. One checker sampling s distinct uniform
indices misses every withheld chunk with probability
C(a, s)/C(n, s) = prod_{i<s} (a-i)/(n-i); q independent checkers all
miss with that to the q-th power. `detection_probability` computes the
complement; `soundness_table` renders the README table that justifies
the default k.
"""

from __future__ import annotations

from typing import List, Sequence

from gethsharding_tpu_torch.crypto.keccak import keccak256

_DOMAIN = b"gethsharding-das-sample:"


def sample_seed(account: bytes, shard_id: int, period: int,
                das_root: bytes) -> bytes:
    """The per-(notary, shard, period, blob) selection seed."""
    return keccak256(_DOMAIN + bytes(account)
                     + int(shard_id).to_bytes(8, "big")
                     + int(period).to_bytes(8, "big") + bytes(das_root))


def sample_indices(seed: bytes, k: int, n: int) -> List[int]:
    """k distinct indices in [0, n), drawn by keccak chain from `seed`.

    Returns them sorted (the fetch order; verification is per-row and
    order-independent). k >= n degenerates to checking every chunk."""
    if n <= 0:
        return []
    if k >= n:
        return list(range(n))
    picked: set = set()
    digest = seed
    counter = 0
    while len(picked) < k:
        digest = keccak256(digest + counter.to_bytes(4, "big"))
        # 8 independent 4-byte draws per squeeze; modulo bias over a
        # u32 range is < 2^-24 for n <= 255 — irrelevant next to the
        # soundness bounds this feeds
        for off in range(0, 32, 4):
            picked.add(int.from_bytes(digest[off:off + 4], "big") % n)
            if len(picked) >= k:
                break
        counter += 1
    return sorted(picked)


def detection_probability(samples: int, n: int, k_data: int,
                          checkers: int = 1) -> float:
    """P(withholding detected): the minimal unrecoverability adversary
    withholds n-k_data+1 chunks; `checkers` independent samplers each
    check `samples` distinct chunks."""
    if n <= 0 or k_data <= 0 or k_data > n:
        raise ValueError(f"bad shape n={n} k_data={k_data}")
    available = k_data - 1
    samples = min(samples, n)
    miss_one = 1.0
    for i in range(samples):
        if available - i <= 0:
            miss_one = 0.0
            break
        miss_one *= (available - i) / (n - i)
    return 1.0 - miss_one ** max(1, checkers)


def proof_bytes(samples: int, mode: str = "merkle") -> int:
    """Proof bytes ONE checker pulls for `samples` sampled chunks
    (chunk payload excluded — both modes carry the same chunk bytes).
    Merkle: a sibling path per sample (<= MAX_PROOF_DEPTH 32-byte
    hashes). Poly (`--da-proofs=poly`, das/pcs.py): ONE 64-byte
    multiproof point covering the whole index set — constant in the
    sample count, which is the entire point of the scheme."""
    from gethsharding_tpu_torch.das.pcs import PROOF_BYTES
    from gethsharding_tpu_torch.das.proofs import MAX_PROOF_DEPTH

    if mode == "merkle":
        return int(samples) * MAX_PROOF_DEPTH * 32
    if mode == "poly":
        return PROOF_BYTES if samples > 0 else 0
    raise ValueError(f"unknown proof mode {mode!r}")


def soundness_table(n: int, k_data: int,
                    ks: Sequence[int] = (4, 8, 16, 32),
                    checkers: int = 1) -> List[dict]:
    """Rows for the README soundness table: k vs detection probability
    (per checker and, when `checkers` > 1, for the committee), plus
    the (samples, proof-bytes, detection) trade-off per proof mode —
    the table that shows poly mode buys more samples per wire byte."""
    rows = []
    for k in ks:
        row = {"k": k,
               "p_detect": detection_probability(k, n, k_data),
               "merkle_proof_bytes": proof_bytes(k, "merkle"),
               "poly_proof_bytes": proof_bytes(k, "poly")}
        if checkers > 1:
            row["p_detect_committee"] = detection_probability(
                k, n, k_data, checkers=checkers)
        rows.append(row)
    return rows
