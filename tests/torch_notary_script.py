"""One scripted notary life on a small chain, written once for either
package (the JAX reference `gethsharding_tpu` or the port
`gethsharding_tpu_torch`, whose notary, chain, client, accounts and shard
DB have the same API). Imports neither package itself, so the port's side
runs in a process where `jax` and `gethsharding_tpu` are blocked.

The chain: 4 shards, committee 8, quorum 2, period 5, no notary lockup; a
pool of 5 members registered in period 0 with BLS keys and proofs of
possession. Committee sampling depends only on block numbers and pool
indices (the dev chain's block hashes are fixed), so every run samples the
same voters: in period 1 members 0-4 all on shard 0, member 1 on shard 1,
member 3 on shards 0 and 2; in period 2 member 0 on shards 1 and 2,
member 3 on shards 2 and 3, member 4 on shard 3 (`LAYOUT`, checked by the
script). The notary under test is member 3, its shard DB's own shard 0.
Heads are driven synchronously (`notarize_collations(head=...)` right
after each period's first block); no sleep, no wall-clock deadline.

- period 1: signed headers on every shard; shard 2's signature recovers
  to another address (the notary rejects it). The other members vote
  first, so the notary's vote on shard 0 finds it elected and sets its
  canonical header;
- period 2: unsigned headers; shard 3's body is absent from the notary's
  shard DB (it refuses to vote). After the votes member 2 deregisters
  (pool churn: period 2's vote-log replay check is None). After the period
  closes, shard 2's stored vote signature is forged and shard 1's
  accepted-vote count drifts to the quorum;
- period 3: member 2 releases its deposit; no headers, nothing to audit.

The head audits give period 1 True and period 2 False (the forged row and
the drift); period 3 None. After the release, `audit_periods([1, 2, 3])`
skips the released voter's row (period 1, shard 0).
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

SHARDS = 4
POOL = 5
NOTARY = 3          # the notary under test: pool member 3
OWN_SHARD = 0       # its shard DB's own shard
RELEASED = 2        # the member that deregisters in period 2, releases in 3
BAD_SIG = (1, 2)    # (period, shard): signed by another key
NO_BODY = (2, 3)    # (period, shard): body absent from the notary's DB
FORGED = (2, 2)     # (period, shard): a stored vote signature forged
DRIFT = (2, 1)      # (period, shard): accepted-vote count altered
# pool member -> the shards the SMC samples it for, by period
LAYOUT = {1: {0: [0], 1: [0, 1], 2: [0], 3: [0, 2], 4: [0]},
          2: {0: [1, 2], 1: [], 2: [], 3: [2, 3], 4: [3]}}
# the summary's JSON-able part (what a subprocess run reports)
JSON_KEYS = ("heads", "head_counters", "audit_periods", "counters",
             "replay", "errors", "shard_db", "words", "blocks")
# the known answers
HEAD_AUDITS = {0: None, 1: True, 2: False, 3: None}
AUDIT_PERIODS = {1: True, 2: False, 3: None}
REPLAY = {1: True, 2: None, 3: None}


def modules(root: str) -> SimpleNamespace:
    """The classes and functions the script uses, from package `root`."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    types = mod("core.types")
    return SimpleNamespace(
        Config=mod("params").Config,
        SimulatedMainchain=mod("smc.chain").SimulatedMainchain,
        SMCClient=mod("mainchain.client").SMCClient,
        AccountManager=mod("mainchain.accounts").AccountManager,
        Notary=mod("actors.notary").Notary,
        Shard=mod("core.shard").Shard,
        MemoryKV=mod("db.kv").MemoryKV,
        CollationHeader=types.CollationHeader,
        Collation=types.Collation,
        Transaction=types.Transaction,
        serialize_txs_to_blob=types.serialize_txs_to_blob,
        vote_digest=mod("smc.state_machine").vote_digest,
        bn256=mod("crypto.bn256"),
        secp256k1=mod("crypto.secp256k1"),
    )


def config(m):
    return m.Config(shard_count=SHARDS, committee_size=8, quorum_size=2,
                    period_length=5, notary_lockup_length=0)


def accounts(m):
    """(manager, members, proposer, impostor): seeded keys."""
    am = m.AccountManager()
    members = [am.new_account(seed=b"torch-notary-member-%d" % i)
               for i in range(POOL)]
    proposer = am.new_account(seed=b"torch-notary-proposer")
    impostor = am.new_account(seed=b"torch-notary-impostor")
    return am, members, proposer, impostor


def _g1(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def _g2(pt):
    return None if pt is None else (int(pt[0].a), int(pt[0].b),
                                    int(pt[1].a), int(pt[1].b))


def _plain(value):
    """Events' and records' values as plain bytes/ints/points."""
    if isinstance(value, bytes):
        return bytes(value)
    return value


def audit_data_plain(data: dict) -> dict:
    return {s: {"chunk_root": bytes(r["chunk_root"]),
                "vote_count": r["vote_count"],
                "is_elected": r["is_elected"],
                "votes": [(v["index"], bytes(v["signer"]), _g1(v["sig"]),
                           _g2(v["pubkey"])) for v in r["votes"]]}
            for s, r in data["shards"].items()}


def receipts_plain(chain) -> list:
    return [(bytes(r.tx_hash).hex(), r.status, r.block_number,
             [(e.name, {k: _plain(v) for k, v in e.args.items()})
              for e in r.events])
            for r in chain._receipts.values()]


def notary_counters(notary) -> dict:
    return {k: getattr(notary, k) for k in (
        "votes_submitted", "signatures_rejected", "canonical_set",
        "audits_run", "audit_mismatches", "aggregate_sigs_verified")}


def _eligible(client, chain, shards) -> list:
    me = client.account()
    return [s for s in shards
            if chain.get_notary_in_committee(me, s) == me]


def _header(m, shard, period, root, signer, proposer):
    header = m.CollationHeader(shard_id=shard, chunk_root=root,
                               period=period,
                               proposer_address=proposer.address)
    if signer is not None:
        header.add_sig(m.secp256k1.sign(bytes(header.hash()),
                                        signer.priv).to_bytes65())
    return header


def run(m, backend, verify_kw: dict, counts=None) -> dict:
    """The scripted life. `backend` is the notary's sig backend;
    `verify_kw` the keyword arguments of `verify_period_batch` (the port's
    device); `counts`, where given, returns kernel launch counts by name,
    read around each notary head. Returns the objects (`chain`, `notary`,
    `kv`) and a `summary` of plain values."""
    cfg = config(m)
    am, members, proposer, impostor = accounts(m)
    chain = m.SimulatedMainchain(cfg)
    clients = []
    for acct in members:
        chain.fund(acct.address)
        clients.append(m.SMCClient(backend=chain, accounts=am, account=acct,
                                   config=cfg))
    for client in clients:
        client.register_notary()
    kv = m.MemoryKV()
    notary = m.Notary(client=clients[NOTARY], shard=m.Shard(OWN_SHARD, kv),
                      config=cfg, sig_backend=backend)
    heads, head_launches, contexts = {}, {}, []

    def head(period):
        """Seal the period's first block; the other members vote where
        sampled, then the notary's head: the previous period's audit and
        this period's votes."""
        while chain.block_number < period * cfg.period_length:
            chain.commit()
        contexts.append(chain.committee_context())
        layout = {i: _eligible(c, chain, range(SHARDS))
                  for i, c in enumerate(clients)}
        if period in LAYOUT and layout != LAYOUT[period]:
            raise AssertionError(f"period {period} samples {layout}")
        for i, client in enumerate(clients):
            if i == NOTARY or i == RELEASED and period > 2:
                continue
            for shard in layout[i]:
                rec = chain.collation_record(shard, period)
                if rec is None:
                    continue
                digest = m.vote_digest(shard, period, rec.chunk_root)
                client.submit_vote(shard, period,
                                   client.notary_registry().pool_index,
                                   rec.chunk_root,
                                   bls_sig=client.bls_sign(digest))
        before = notary.audit_mismatches
        runs = notary.audits_run
        launched = counts() if counts is not None else {}
        notary.notarize_collations(head=chain.block_number)
        if counts is not None:
            head_launches[period] = {
                k: c - launched.get(k, 0) for k, c in counts().items()
                if c != launched.get(k, 0)}
        heads[period - 1] = (None if notary.audits_run == runs else
                             notary.audit_mismatches == before)

    def propose(period, signed):
        for shard in range(SHARDS):
            tx = m.Transaction(nonce=shard, gas_limit=21000, value=period,
                               payload=b"collation %d/%d" % (period, shard))
            body = m.serialize_txs_to_blob([tx])
            collation = m.Collation(header=m.CollationHeader(), body=body)
            root = collation.calculate_chunk_root()
            signer = (impostor if (period, shard) == BAD_SIG else proposer)
            header = _header(m, shard, period, root,
                             signer if signed else None, proposer)
            chain.add_header(proposer.address, shard, period, root,
                             header.proposer_signature)
            if (period, shard) != NO_BODY:
                m.Shard(shard, kv).save_body(body)

    # period 1: signed headers
    while chain.block_number < cfg.period_length - 1:
        chain.commit()
    propose(1, signed=True)
    head(1)
    # period 2: unsigned headers; member 2 deregisters after the votes
    while chain.block_number < 2 * cfg.period_length - 1:
        chain.commit()
    propose(2, signed=False)
    head(2)
    clients[RELEASED].deregister_notary()
    while chain.block_number < 3 * cfg.period_length - 1:
        chain.commit()
    # period 2 is closed: forge a stored vote signature, drift a tally
    rec = chain.collation_record(*FORGED[::-1])
    vote = rec.vote_sigs[min(rec.vote_sigs)]
    vote.sig = m.bn256.g1_add(vote.sig, m.bn256.G1_GEN)
    rec = chain.collation_record(*DRIFT[::-1])
    rec.vote_count = (cfg.quorum_size - 1 if rec.is_elected
                      else cfg.quorum_size)
    # period 3: member 2 releases in its first pending block
    clients[RELEASED].release_notary()
    head(3)
    head(4)
    periods = [1, 2, 3]
    summary = {
        "heads": heads,
        "head_launches": head_launches,
        "head_counters": notary_counters(notary),
        "audit_data": {p: audit_data_plain(clients[0].audit_data(p))
                       for p in periods},
        "contexts": contexts,
        "audit_periods": notary.audit_periods(periods),
        "counters": notary_counters(notary),
        "replay": {p: chain.verify_period_batch(p, **verify_kw)
                   for p in periods},
        "errors": list(notary.errors),
        "shard_db": sorted((k.hex(), v.hex()) for k, v in kv.items()),
        "words": dict(chain.smc.current_vote),
        "blocks": [bytes(b.hash).hex() for b in chain.blocks],
        "receipts": receipts_plain(chain),
    }
    return {"chain": chain, "notary": notary, "kv": kv, "summary": summary}


def jsonable(summary: dict) -> dict:
    """The JSON-able part of a summary, as a JSON round trip gives it."""
    return json.loads(json.dumps({k: summary[k] for k in JSON_KEYS}))
