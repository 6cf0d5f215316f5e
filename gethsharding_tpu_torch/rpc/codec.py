"""Wire encoding for the mainchain RPC surface (the port's copy of the JAX
package's `rpc/codec.py`, without its span-batch codec and the whisper
envelope, whose modules the port has not ported).

JSON-RPC 2.0 payload values: addresses/hashes/byte strings as 0x-hex,
bn256 curve points as hex-int coordinate arrays (G1 = [x, y], G2 =
[[xa, xb], [ya, yb]], null = infinity/absent), registry entries and
collation records as plain objects. Deliberately schema-first and
version-tagged so a non-Python peer can implement the same surface.
"""

from __future__ import annotations

from typing import Optional

from gethsharding_tpu_torch.crypto import bn256
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32


def enc_bytes(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def dec_bytes(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def enc_g1(p: Optional[bn256.G1Point]) -> Optional[list]:
    return None if p is None else [hex(p[0]), hex(p[1])]


def dec_g1(v) -> Optional[bn256.G1Point]:
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def enc_g2(p: Optional[bn256.G2Point]) -> Optional[list]:
    if p is None:
        return None
    x, y = p
    return [[hex(x.a), hex(x.b)], [hex(y.a), hex(y.b)]]


def dec_g2(v) -> Optional[bn256.G2Point]:
    if v is None:
        return None
    (xa, xb), (ya, yb) = v
    return (bn256.Fp2(int(xa, 16), int(xb, 16)),
            bn256.Fp2(int(ya, 16), int(yb, 16)))


def enc_registry(entry) -> Optional[dict]:
    if entry is None:
        return None
    return {
        "deregisteredPeriod": entry.deregistered_period,
        "poolIndex": entry.pool_index,
        "balance": entry.balance,
        "deposited": entry.deposited,
        "blsPubkey": enc_g2(entry.bls_pubkey),
        "blsPop": enc_g1(entry.bls_pop),
    }


def dec_registry(obj: Optional[dict]):
    if obj is None:
        return None
    from gethsharding_tpu_torch.smc.state_machine import Notary

    return Notary(
        deregistered_period=obj["deregisteredPeriod"],
        pool_index=obj["poolIndex"],
        balance=obj["balance"],
        deposited=obj["deposited"],
        bls_pubkey=dec_g2(obj["blsPubkey"]),
        bls_pop=dec_g1(obj["blsPop"]),
    )


def enc_record(record) -> Optional[dict]:
    if record is None:
        return None
    return {
        "chunkRoot": enc_bytes(record.chunk_root),
        "proposer": enc_bytes(record.proposer),
        "isElected": record.is_elected,
        "signature": enc_bytes(record.signature),
        "voteSigs": {str(i): [enc_g1(v.sig), enc_bytes(v.signer)]
                     for i, v in record.vote_sigs.items()},
        "voteCount": record.vote_count,
    }


def dec_record(obj: Optional[dict]):
    if obj is None:
        return None
    from gethsharding_tpu_torch.smc.state_machine import (CollationRecord,
                                                          VoteSig)

    return CollationRecord(
        chunk_root=Hash32(dec_bytes(obj["chunkRoot"])),
        proposer=Address20(dec_bytes(obj["proposer"])),
        is_elected=obj["isElected"],
        signature=dec_bytes(obj["signature"]),
        vote_sigs={int(i): VoteSig(sig=dec_g1(v[0]),
                                   signer=Address20(dec_bytes(v[1])))
                   for i, v in obj["voteSigs"].items()},
        vote_count=obj["voteCount"],
    )


# -- verification plane codecs (the serving RPC surface) -------------------
# The committee and DAS planes ship RAGGED batches: per-row committee
# signature/pubkey point lists and per-row merkle sibling paths. The
# wire forms are plain nested JSON of the scalar codecs above, so a
# frontend router can balance EVERY SigBackend op cross-process with
# the same schema-first contract as the rest of the surface.


def enc_g1_rows(rows) -> list:
    """Per-row G1 point lists (committee vote signatures)."""
    return [[enc_g1(p) for p in row] for row in rows]


def dec_g1_rows(rows) -> list:
    return [[dec_g1(p) for p in row] for row in rows]


def enc_g2_rows(rows) -> list:
    """Per-row G2 point lists (committee member pubkeys)."""
    return [[enc_g2(p) for p in row] for row in rows]


def dec_g2_rows(rows) -> list:
    return [[dec_g2(p) for p in row] for row in rows]


def enc_pk_row_keys(keys) -> Optional[list]:
    """Optional per-row pk-plane cache keys. Keys are arbitrary
    hashables caller-side (the notary uses int tuples); the wire form
    is their `repr` — injective for the int/str/tuple keys in use, so
    the remote backend's cache key still uniquely determines the row's
    points, and stable across processes (unlike `hash`, repr does not
    depend on PYTHONHASHSEED)."""
    if keys is None:
        return None
    return [None if k is None else repr(k) for k in keys]


def enc_das_call(chunks, indices, proofs, roots) -> list:
    """The das_verify_samples argument plane: (chunks, indices,
    sibling-path rows, roots) — positional, matching the backend op."""
    return [
        [enc_bytes(c) for c in chunks],
        [int(i) for i in indices],
        [[enc_bytes(node) for node in path] for path in proofs],
        [enc_bytes(r) for r in roots],
    ]


def dec_das_call(chunks, indices, proofs, roots) -> tuple:
    return (
        [dec_bytes(c) for c in chunks],
        [int(i) for i in indices],
        [[dec_bytes(node) for node in path] for path in proofs],
        [dec_bytes(r) for r in roots],
    )


def enc_das_poly_call(commitments, index_rows, eval_rows, proofs,
                      ns) -> list:
    """The das_verify_multiproofs argument plane: (64-byte G1
    commitments, per-row sampled index sets, per-row claimed
    evaluations as hex field elements, 64-byte G1 multiproofs, domain
    sizes) — positional, matching the backend op."""
    return [
        [enc_bytes(c) for c in commitments],
        [[int(i) for i in row] for row in index_rows],
        [[hex(int(e)) for e in row] for row in eval_rows],
        [enc_bytes(p) for p in proofs],
        [int(n) for n in ns],
    ]


def dec_das_poly_call(commitments, index_rows, eval_rows, proofs,
                      ns) -> tuple:
    return (
        [dec_bytes(c) for c in commitments],
        [[int(i) for i in row] for row in index_rows],
        [[int(e, 16) for e in row] for row in eval_rows],
        [dec_bytes(p) for p in proofs],
        [int(n) for n in ns],
    )


# The trace plane's methods: the client attaches no trace envelope to them,
# and the server opens no handler span for them (the reference's span-batch
# codec for `shard_traceExport` waits for the port's `tracing/export.py`).
TRACE_PLANE_METHODS = frozenset({
    "shard_traceExport", "shard_traceHandshake",
    "shard_traceAttribution", "shard_traceExemplars"})


# -- shardp2p message codecs (type-tagged, for the cross-process relay) ----


def enc_p2p(data) -> tuple:
    """Message object -> (type tag, JSON payload)."""
    from gethsharding_tpu_torch.p2p import messages as m

    if isinstance(data, m.CollationBodyRequest):
        return "CollationBodyRequest", {
            "chunkRoot": None if data.chunk_root is None
            else enc_bytes(data.chunk_root),
            "shardId": data.shard_id,
            "period": data.period,
            "proposer": None if data.proposer is None
            else enc_bytes(data.proposer),
            "signature": enc_bytes(data.signature),
        }
    if isinstance(data, m.CollationBodyResponse):
        return "CollationBodyResponse", {
            "headerHash": enc_bytes(data.header_hash),
            "body": enc_bytes(data.body),
        }
    if isinstance(data, m.ChunkProofRequest):
        return "ChunkProofRequest", {
            "chunkRoot": enc_bytes(data.chunk_root),
            "shardId": data.shard_id,
            "period": data.period,
            "index": data.index,
        }
    if isinstance(data, m.ChunkProofResponse):
        return "ChunkProofResponse", {
            "chunkRoot": enc_bytes(data.chunk_root),
            "index": data.index,
            "proof": [enc_bytes(node) for node in data.proof],
            "bodyLen": data.body_len,
        }
    if isinstance(data, m.DASCommitmentRequest):
        return "DASCommitmentRequest", {
            "shardId": data.shard_id,
            "period": data.period,
        }
    if isinstance(data, m.DASCommitmentResponse):
        return "DASCommitmentResponse", {
            "shardId": data.shard_id,
            "period": data.period,
            "chunkRoot": enc_bytes(data.chunk_root),
            "dasRoot": enc_bytes(data.das_root),
            "k": data.k,
            "n": data.n,
            "bodyLen": data.body_len,
            "polyCommitment": enc_bytes(data.poly_commitment),
            "signature": enc_bytes(data.signature),
        }
    if isinstance(data, m.DASampleRequest):
        return "DASampleRequest", {
            "dasRoot": enc_bytes(data.das_root),
            "indices": list(data.indices),
        }
    if isinstance(data, m.DASampleResponse):
        return "DASampleResponse", {
            "dasRoot": enc_bytes(data.das_root),
            "index": data.index,
            "chunk": enc_bytes(data.chunk),
            "proof": [enc_bytes(node) for node in data.proof],
        }
    if isinstance(data, m.DASMultiproofRequest):
        return "DASMultiproofRequest", {
            "dasRoot": enc_bytes(data.das_root),
            "indices": list(data.indices),
        }
    if isinstance(data, m.DASMultiproofResponse):
        return "DASMultiproofResponse", {
            "dasRoot": enc_bytes(data.das_root),
            "indices": list(data.indices),
            "chunks": [enc_bytes(c) for c in data.chunks],
            "proof": enc_bytes(data.proof),
        }
    from gethsharding_tpu_torch.p2p import discovery as disc

    if isinstance(data, disc.PeerTableRequest):
        return "PeerTableRequest", {}
    if isinstance(data, disc.PeerTableResponse):
        return "PeerTableResponse", {
            "announces": [_enc_announce(a) for a in data.announces],
        }
    from gethsharding_tpu_torch.storage import netstore as ns

    if isinstance(data, ns.ChunkRequest):
        return "ChunkRequest", {"key": enc_bytes(data.key)}
    if isinstance(data, ns.ChunkDelivery):
        return "ChunkDelivery", {"key": enc_bytes(data.key),
                                 "span": data.span,
                                 "payload": enc_bytes(data.payload)}
    raise TypeError(f"no p2p wire codec for {type(data).__name__}")


def _enc_announce(ann) -> dict:
    return {"peerId": ann.peer_id, "account": ann.account,
            "host": ann.host, "port": ann.port, "seq": ann.seq,
            "sig": enc_bytes(ann.sig)}


def _dec_announce(obj: dict):
    from gethsharding_tpu_torch.p2p import discovery as disc

    return disc.PeerAnnounce(
        peer_id=int(obj["peerId"]), account=str(obj["account"]),
        host=str(obj["host"]), port=int(obj["port"]), seq=int(obj["seq"]),
        sig=dec_bytes(obj["sig"]))


def dec_p2p(kind: str, payload: dict):
    from gethsharding_tpu_torch.p2p import messages as m

    if kind == "CollationBodyRequest":
        return m.CollationBodyRequest(
            chunk_root=None if payload["chunkRoot"] is None
            else Hash32(dec_bytes(payload["chunkRoot"])),
            shard_id=payload["shardId"],
            period=payload["period"],
            proposer=None if payload["proposer"] is None
            else Address20(dec_bytes(payload["proposer"])),
            signature=dec_bytes(payload["signature"]),
        )
    if kind == "CollationBodyResponse":
        return m.CollationBodyResponse(
            header_hash=Hash32(dec_bytes(payload["headerHash"])),
            body=dec_bytes(payload["body"]),
        )
    if kind == "ChunkProofRequest":
        return m.ChunkProofRequest(
            chunk_root=Hash32(dec_bytes(payload["chunkRoot"])),
            shard_id=payload["shardId"],
            period=payload["period"],
            index=payload["index"],
        )
    if kind == "ChunkProofResponse":
        return m.ChunkProofResponse(
            chunk_root=Hash32(dec_bytes(payload["chunkRoot"])),
            index=payload["index"],
            proof=tuple(dec_bytes(node) for node in payload["proof"]),
            body_len=payload.get("bodyLen", 0),
        )
    if kind == "DASCommitmentRequest":
        return m.DASCommitmentRequest(
            shard_id=int(payload["shardId"]),
            period=int(payload["period"]),
        )
    if kind == "DASCommitmentResponse":
        return m.DASCommitmentResponse(
            shard_id=int(payload["shardId"]),
            period=int(payload["period"]),
            chunk_root=Hash32(dec_bytes(payload["chunkRoot"])),
            das_root=dec_bytes(payload["dasRoot"]),
            k=int(payload["k"]),
            n=int(payload["n"]),
            body_len=int(payload["bodyLen"]),
            poly_commitment=dec_bytes(payload.get("polyCommitment", "")),
            signature=dec_bytes(payload["signature"]),
        )
    if kind == "DASampleRequest":
        return m.DASampleRequest(
            das_root=dec_bytes(payload["dasRoot"]),
            indices=tuple(int(i) for i in payload["indices"]),
        )
    if kind == "DASampleResponse":
        return m.DASampleResponse(
            das_root=dec_bytes(payload["dasRoot"]),
            index=int(payload["index"]),
            chunk=dec_bytes(payload["chunk"]),
            proof=tuple(dec_bytes(node) for node in payload["proof"]),
        )
    if kind == "DASMultiproofRequest":
        return m.DASMultiproofRequest(
            das_root=dec_bytes(payload["dasRoot"]),
            indices=tuple(int(i) for i in payload["indices"]),
        )
    if kind == "DASMultiproofResponse":
        return m.DASMultiproofResponse(
            das_root=dec_bytes(payload["dasRoot"]),
            indices=tuple(int(i) for i in payload["indices"]),
            chunks=tuple(dec_bytes(c) for c in payload["chunks"]),
            proof=dec_bytes(payload["proof"]),
        )
    if kind == "ChunkRequest":
        from gethsharding_tpu_torch.storage import netstore as ns

        return ns.ChunkRequest(key=dec_bytes(payload["key"]))
    if kind == "ChunkDelivery":
        from gethsharding_tpu_torch.storage import netstore as ns

        return ns.ChunkDelivery(key=dec_bytes(payload["key"]),
                                span=int(payload["span"]),
                                payload=dec_bytes(payload["payload"]))
    if kind == "PeerTableRequest":
        from gethsharding_tpu_torch.p2p import discovery as disc

        return disc.PeerTableRequest()
    if kind == "PeerTableResponse":
        from gethsharding_tpu_torch.p2p import discovery as disc

        return disc.PeerTableResponse(
            announces=tuple(_dec_announce(a)
                            for a in payload.get("announces", [])))
    if kind == "WhisperEnvelope":
        raise ValueError("WhisperEnvelope: the port has no p2p/whisper.py "
                         "yet (ROADMAP.md, queue A item 8)")
    raise ValueError(f"unknown p2p message type {kind!r}")


def enc_block(block) -> dict:
    return {"number": block.number, "hash": enc_bytes(block.hash),
            "parentHash": enc_bytes(block.parent_hash),
            "extra": enc_bytes(getattr(block, "extra", b"") or b"")}


def dec_block(obj: dict):
    from gethsharding_tpu_torch.smc.chain import Block

    return Block(number=int(obj["number"]),
                 hash=Hash32(dec_bytes(obj["hash"])),
                 parent_hash=Hash32(dec_bytes(obj["parentHash"])),
                 extra=dec_bytes(obj.get("extra", "")))


def enc_receipt(receipt) -> dict:
    return {"txHash": enc_bytes(receipt.tx_hash), "status": receipt.status,
            "blockNumber": receipt.block_number}
