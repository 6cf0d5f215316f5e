"""Light client: SMC-anchored on-demand chunk retrieval with proofs (the
port's copy of the JAX package's `actors/light.py`).

The `les/` + `light/` role (ODR — on-demand retrieval, `les/odr.go`,
`light/odr.go`) mapped to the sharding domain: a light client holds NO
shard data. Its root of trust is the SMC (exactly as geth's light
client trusts the header chain): it reads the canonical
(shard, period) chunk root from the contract, then samples body bytes
from peers over shardp2p — each response carries a merkle proof that is
verified locally against the anchored root (`trie/proof.go
VerifyProof`), so a lying peer cannot forge content and a peer that
cannot prove availability of sampled indices fails the check.

This is also the data-availability-sampling intent behind the 32-byte
chunk design: `availability_check` samples K
pseudorandom indices; all proofs verifying == the body is available at
those points without downloading it.

A light client verifies on the host and launches no kernel: its proofs
are a few keccaks each (`core/trie.py::verify_proof`), and its DAS check
runs the scalar sample verifier (`das/proofs.py::verify_sample`) or the
scalar multiproof check at admission (`das/service.py`). Its node resolves
no device (`node/backend.py`).
"""

from __future__ import annotations

import secrets
import time
from typing import Dict, Optional, Sequence

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.core.derive_sha import verify_chunk
from gethsharding_tpu_torch.core.trie import EMPTY_ROOT
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.das.proofs import verify_sample
from gethsharding_tpu_torch.das.sampler import sample_indices
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.p2p.messages import (ChunkProofRequest,
                                                 ChunkProofResponse)
from gethsharding_tpu_torch.p2p.service import P2PServer
from gethsharding_tpu_torch.utils.hexbytes import Hash32


class LightClient(Service):
    """Proof-verified byte sampling against SMC-anchored chunk roots."""

    name = "light"
    supervisable = True

    def __init__(self, client: SMCClient, p2p: P2PServer, das=None):
        super().__init__()
        self.client = client
        self.p2p = p2p
        # the DAS face (das/): with a DASService attached, `das_check`
        # samples whole erasure-extended chunks against the proposer's
        # commitment, the chunk-granular, parity-aware successor of the
        # per-byte `availability_check`
        self.das = das
        self.samples_verified = 0
        self.proofs_rejected = 0
        self._sub = None
        self.m_sample_latency = metrics.timer("light/sample_latency")

    def on_start(self) -> None:
        self._sub = self.p2p.subscribe(ChunkProofResponse)

    def on_stop(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()

    # -- anchoring ---------------------------------------------------------

    def canonical_chunk_root(self, shard_id: int,
                             period: int) -> Optional[Hash32]:
        """The root of trust: the SMC's collation record for the pair."""
        record = self.client.collation_record(shard_id, period)
        return None if record is None else record.chunk_root

    # -- sampling ----------------------------------------------------------

    def sample(self, shard_id: int, period: int, indices: Sequence[int],
               timeout: float = 5.0) -> Dict[int, Optional[int]]:
        """Retrieve + verify body bytes at `indices` from peers.

        Broadcasts one ChunkProofRequest per index, collects responses,
        and verifies every proof against the SMC-anchored chunk root.
        Returns an entry per RESOLVED index: the proven byte value, or
        None for a PROVEN absence (index outside the body). Missing
        entries = no peer answered in time. A response with an invalid
        proof is counted, logged and discarded — never returned."""
        root = self.canonical_chunk_root(shard_id, period)
        if root is None:
            raise ValueError(
                f"no canonical collation for shard {shard_id} "
                f"period {period}")
        if self._sub is None:
            raise RuntimeError("light client is not started")
        out, _ = self._sample(root, shard_id, period, indices, timeout)
        return out

    def _sample(self, root: Hash32, shard_id: int, period: int,
                indices: Sequence[int], timeout: float):
        """Request + verify against an already-resolved root; returns
        (resolved dict, last verified responder's body-length claim)."""
        pending = set(indices)
        for index in sorted(pending):
            self.p2p.broadcast(ChunkProofRequest(
                chunk_root=root, shard_id=shard_id, period=period,
                index=index))
        out: Dict[int, Optional[int]] = {}
        len_claim: Optional[int] = None
        deadline = time.monotonic() + timeout
        with self.m_sample_latency.time():
            while pending and time.monotonic() < deadline:
                msg = self._sub.try_get()
                if msg is None:
                    if self.wait(0.01):
                        break
                    continue
                response: ChunkProofResponse = msg.data
                if (bytes(response.chunk_root) != bytes(root)
                        or response.index not in pending):
                    continue
                try:
                    value = verify_chunk(bytes(root), response.index,
                                         response.proof)
                except ValueError as exc:
                    self.proofs_rejected += 1
                    self.record_error(
                        f"peer {msg.peer.peer_id} sent an invalid proof "
                        f"for index {response.index}: {exc}")
                    continue
                out[response.index] = value
                len_claim = response.body_len
                pending.discard(response.index)
                self.samples_verified += 1
        return out, len_claim

    def proven_length(self, shard_id: int, period: int,
                      timeout: float = 5.0) -> Optional[int]:
        """PROVE the body length: take a peer's length claim L, then
        verify a presence proof at L-1 and an absence proof at L. A
        lying claim fails one of the two. None = could not prove
        (no peers, or dishonest claims)."""
        root = self.canonical_chunk_root(shard_id, period)
        if root is None:
            return None
        return self._proven_length(root, shard_id, period, timeout)

    def _proven_length(self, root: Hash32, shard_id: int, period: int,
                       timeout: float) -> Optional[int]:
        if bytes(root) == EMPTY_ROOT:
            return 0  # the empty body's DeriveSha root
        first, claim = self._sample(root, shard_id, period, [0], timeout)
        if first.get(0) is None:  # unanswered, or 'absent' for index 0
            return None
        if not claim or claim <= 0:
            return None
        boundary, _ = self._sample(root, shard_id, period,
                                   [claim - 1, claim], timeout)
        if (boundary.get(claim - 1) is not None and claim in boundary
                and boundary[claim] is None):
            return claim
        return None

    def availability_check(self, shard_id: int, period: int, k: int = 16,
                           timeout: float = 5.0,
                           seed: Optional[bytes] = None) -> bool:
        """Data-availability sampling (the intent of the 32-byte chunk
        design): prove the body length, then sample K pseudorandom
        in-range indices. `seed` defaults to a FRESH random value — a
        withholding peer must not be able to precompute which indices
        every checker will ask for (DAS soundness); pass an explicit
        seed only for auditable replay of a specific check. True iff
        the length is proven and EVERY sampled index verifies."""
        root = self.canonical_chunk_root(shard_id, period)
        if root is None:
            return False
        length = self._proven_length(root, shard_id, period, timeout)
        if length is None:
            return False
        if length == 0:
            return True  # empty body: trivially available
        if seed is None:
            seed = secrets.token_bytes(32)
        digest = keccak256(bytes(root) + seed)
        indices, counter = set(), 0
        while len(indices) < min(k, length) and counter < 8 * k:
            digest = keccak256(digest + counter.to_bytes(4, "big"))
            indices.add(int.from_bytes(digest[:4], "big") % length)
            counter += 1
        got, _ = self._sample(root, shard_id, period, sorted(indices),
                              timeout)
        return all(got.get(i) is not None for i in indices)

    # -- erasure-coded DAS (das/) -----------------------------------------

    def das_check(self, shard_id: int, period: int,
                  k: Optional[int] = None,
                  seed: Optional[bytes] = None) -> bool:
        """Chunk-granular data-availability sampling against the
        proposer's erasure-extension commitment.

        Fetches the signed commitment (validated against the
        SMC-anchored record: chunk_root binding + proposer signature),
        draws k indices from a FRESH random seed (a light client's
        selection must not be precomputable — `das/sampler.py`
        documents the soundness split), pulls chunk+proof samples over
        shardp2p and verifies them with the scalar reference (a light
        client has no device). True iff every sampled chunk proves.

        Under ``--da-proofs=poly`` the k samples arrive under ONE
        constant-size polynomial multiproof instead of k sibling paths
        (das/pcs.py) — `fetch_multiproof` verifies it against the
        signed poly commitment before admission, so delivery IS the
        verdict and the wire cost per check drops from k paths to one
        64-byte point."""
        if self.das is None:
            raise RuntimeError("light client has no DAS service attached")
        record = self.client.collation_record(shard_id, period)
        if record is None:
            return False
        with self.m_sample_latency.time():
            commitment = self.das.fetch_commitment(
                shard_id, period, record.chunk_root, record.proposer)
            if commitment is None:
                return False
            if seed is None:
                seed = secrets.token_bytes(32)
            k = self.das.samples if k is None else k
            indices = sample_indices(
                keccak256(seed + bytes(commitment.das_root)), k,
                commitment.n)
            if self.das.proof_mode == "poly":
                got = self.das.fetch_multiproof(commitment, indices)
                verdicts = [got is not None] * len(indices)
            else:
                fetched = self.das.fetch_samples(commitment, indices)
                verdicts = []
                for index in indices:
                    chunk, proof = fetched.get(index, (b"", ()))
                    verdicts.append(verify_sample(commitment.das_root,
                                                  index, chunk, proof))
            self.samples_verified += sum(verdicts)
            self.proofs_rejected += len(verdicts) - sum(verdicts)
            self.das.note_verdicts(verdicts)
        return bool(verdicts) and all(verdicts)
