"""Syncer: serves collation bodies and chunk proofs over shardp2p (the
port's copy of the JAX package's `actors/syncer.py`; its chunk-proof
handler is the light client's server side, `actors/light.py`).

Parity: `sharding/syncer/service.go` (handleCollationBodyRequests :73) and
`handlers.go` (RespondCollationBody :19, RequestCollationBody :49):
subscribe to CollationBodyRequest messages, reconstruct + sign the header
from the request tuple, fetch the collation from the shardDB, and reply to
the requesting peer with a CollationBodyResponse. Where the reference's
final `p2p.Send` is a no-op stub, this syncer actually delivers — and on
the receiving side stores the body + availability bit.
"""

from __future__ import annotations

from typing import Optional

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.core.derive_sha import chunk_proof
from gethsharding_tpu_torch.core.shard import Shard, ShardError
from gethsharding_tpu_torch.core.types import CollationHeader
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.p2p.messages import (
    ChunkProofRequest, ChunkProofResponse, CollationBodyRequest,
    CollationBodyResponse)
from gethsharding_tpu_torch.p2p.service import Message, P2PServer


def request_collation_body(caller, shard_id: int,
                           period: int) -> Optional[CollationBodyRequest]:
    """Build a body request from the SMC record (handlers.go:49)."""
    record = caller.collation_record(shard_id, period)
    if record is None or bytes(record.chunk_root) == b"\x00" * 32:
        return None
    return CollationBodyRequest(
        chunk_root=record.chunk_root,
        shard_id=shard_id,
        period=period,
        proposer=record.proposer,
    )


class Syncer(Service):
    name = "syncer"
    supervisable = True

    # chunk proofs are served from a per-body trie built in Python; an
    # untrusted request stream cycling distinct large roots could pin the
    # proof thread rebuilding O(body) tries (an LRU thrash), so proof
    # serving is capped: a light client needing a bigger body takes the
    # whole-body CollationBodyRequest path instead
    PROOF_BODY_CAP = 1 << 16

    def __init__(self, client: SMCClient, shard: Shard, p2p: P2PServer,
                 poll_interval: float = 0.05):
        super().__init__()
        self.client = client
        self.shard = shard
        self.p2p = p2p
        self.poll_interval = poll_interval
        self.responses_sent = 0
        self.bodies_stored = 0
        self.proofs_served = 0
        self._req_sub = None
        self._resp_sub = None
        self._proof_sub = None

    def on_start(self) -> None:
        self._req_sub = self.p2p.subscribe(CollationBodyRequest)
        self._resp_sub = self.p2p.subscribe(CollationBodyResponse)
        self._proof_sub = self.p2p.subscribe(ChunkProofRequest)
        self.spawn(self._handle_requests, name="syncer-requests")
        self.spawn(self._handle_responses, name="syncer-responses")
        self.spawn(self._handle_proof_requests, name="syncer-proofs")

    def on_stop(self) -> None:
        for sub in (self._req_sub, self._resp_sub, self._proof_sub):
            if sub is not None:
                sub.unsubscribe()

    # -- request side ------------------------------------------------------

    def _handle_requests(self) -> None:
        while not self.stopped():
            msg = self._req_sub.try_get()
            if msg is None:
                if self.wait(self.poll_interval):
                    return
                continue
            try:
                self.respond_collation_body(msg)
            except Exception as exc:
                self.record_error(f"could not construct response: {exc}")

    def respond_collation_body(self, msg: Message) -> None:
        """RespondCollationBody (handlers.go:19)."""
        request: CollationBodyRequest = msg.data
        header = CollationHeader(
            shard_id=request.shard_id,
            chunk_root=request.chunk_root,
            period=request.period,
            proposer_address=request.proposer,
        )
        signature = self.client.sign(bytes(header.hash()))
        header.add_sig(signature)
        try:
            collation = self.shard.collation_by_header_hash(header.hash())
        except ShardError:
            # try by chunk root alone: votes reconstruct unsigned headers
            try:
                body = self.shard.body_by_chunk_root(request.chunk_root)
            except ShardError:
                return  # we don't have it either
            response = CollationBodyResponse(
                header_hash=header.hash(), body=body
            )
            self.p2p.send(response, msg.peer)
            self.responses_sent += 1
            return
        response = CollationBodyResponse(
            header_hash=collation.header.hash(), body=collation.body
        )
        self.p2p.send(response, msg.peer)
        self.responses_sent += 1

    # -- on-demand chunk proofs (the les/light ODR serving side) -----------

    def _handle_proof_requests(self) -> None:
        while not self.stopped():
            msg = self._proof_sub.try_get()
            if msg is None:
                if self.wait(self.poll_interval):
                    return
                continue
            try:
                self.respond_chunk_proof(msg)
            except Exception as exc:
                self.record_error(f"could not construct proof: {exc}")

    def respond_chunk_proof(self, msg: Message) -> None:
        """Serve a merkle proof of one body byte under its chunk root, as
        an les/light server's ODR handler does for trie nodes
        (`les/odr_requests.go`). The per-body proof trie is kept in
        `derive_sha`'s LRU, so a light client sampling many indices of one
        root builds it once."""
        request: ChunkProofRequest = msg.data
        try:
            body = self.shard.body_by_chunk_root(request.chunk_root)
        except ShardError:
            return  # we don't have the body; another peer may
        if request.index < 0 or len(body) > self.PROOF_BODY_CAP:
            return
        self.p2p.send(ChunkProofResponse(
            chunk_root=request.chunk_root, index=request.index,
            proof=tuple(chunk_proof(body, request.index)),
            body_len=len(body)), msg.peer)
        self.proofs_served += 1

    # -- response side -----------------------------------------------------

    def _handle_responses(self) -> None:
        while not self.stopped():
            msg = self._resp_sub.try_get()
            if msg is None:
                if self.wait(self.poll_interval):
                    return
                continue
            response: CollationBodyResponse = msg.data
            try:
                self.shard.save_body(response.body)
                self.bodies_stored += 1
            except ShardError as exc:
                self.record_error(f"could not store synced body: {exc}")
