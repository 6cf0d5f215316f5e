"""A period audit's rows, read in bulk (the port's copy of
`assemble_audit_data` from the JAX package's `mainchain/mirror.py`; the
`StateMirror` service and its snapshot wait for ROADMAP.md queue A item 8).
"""

from __future__ import annotations

from typing import Dict


def assemble_audit_data(source, period: int) -> dict:
    """Bulk audit pull: for every shard with a collation record in
    `period`, the record's vote signatures and the voters' registered BLS
    pubkeys (resolved by vote-time attribution; None for a released
    voter), as raw point tuples, the chunk root as raw bytes, and
    `raw: True`. The hex wire form of a remote chain waits for the port's
    `rpc/codec.py`."""
    shards: Dict[int, dict] = {}
    for shard_id in range(source.shard_count()):
        record = source.collation_record(shard_id, period)
        if record is None or not record.vote_sigs:
            continue
        votes = []
        for index, vote in record.vote_sigs.items():
            entry = source.notary_registry(vote.signer)
            votes.append({"index": index, "signer": vote.signer,
                          "sig": vote.sig,
                          "pubkey": None if entry is None
                          else entry.bls_pubkey})
        shards[shard_id] = {
            "chunk_root": bytes(record.chunk_root),
            "vote_count": record.vote_count,
            "is_elected": bool(record.is_elected),
            "votes": votes,
        }
    return {"period": period, "shards": shards, "raw": True}
