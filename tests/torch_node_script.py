"""One seeded sharding devnet, written once for either package (the JAX
reference `gethsharding_tpu` or the port `gethsharding_tpu_torch`, whose
nodes, chain, hub and services have the same API). Imports neither package
itself, so the port's side runs in a process where `jax` and
`gethsharding_tpu` are blocked, and `chip_smoke.py` runs it on the card.

The topology of `python -m ... sharding` run several times against one
chain: one `SimulatedMainchain` and one shardp2p `Hub` shared by

- a notary node (`ShardNode(actor="notary", deposit=True)`), whose pool
  index the script picks among the members it registers around it;
- the other pool members, registered and voting from the script where the
  SMC samples them (committee sampling depends only on block numbers and
  pool indices: the dev chain's block hashes are fixed, so `plan` knows
  every period's committee in advance and each head checks it);
- proposer nodes, one a shard of `Plan.proposers`, each with its own shard
  DB, their txpools fed signed transactions every period (the proposer is
  stopped while a period's transactions are admitted and started again
  before the last one, so its first collation of the period holds them
  all);
- an observer node on `Plan.observer`, a proposer shard some member votes
  on in every period.

With `da_proofs` ("merkle" or "poly") every node runs with `da_mode=
"sampled"`: the proposers publish each collation through their node's
`DASService`, and the notary votes on sampled proofs, fetching no body.
`hostile` then names kinds of hostile shards (`HOSTILE_KINDS`), placed on
shards the notary is sampled for and proposed by the script, which
publishes them through DAS services of its own on the hub: every sample
withheld, garbage chunks served under a commitment signed over the real
blob, a commitment signed by another key, a commitment without the
polynomial part (poly mode).

The other shards' headers are proposed by the script. The script seals
blocks as the CLI's loop does and, after each, waits on the services' own
counters (never a fixed sleep): a period's proposals land, its first block
runs the notary's head (the previous period's audit, this period's votes,
the bodies fetched over the hub for the availability and windback checks),
the members vote, the observer's canonical header is copied into its shard
DB from the SMC's record (nothing else writes it there) and its body
requested over the hub, and the next block runs the observer's replay.

`run` returns the nodes and a summary a period: shard DBs byte for byte,
the SMC's vote words and records, the notary's counters, journal and
mirror snapshot, the observer's roots, each node's errors and, where
`counts` is given, the kernel launches of each head.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time
from types import SimpleNamespace

# a wait on a service counter fails after this many seconds
WAIT_S = 120.0


def modules(root: str) -> SimpleNamespace:
    """The classes and functions the script uses, from package `root`."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    types = mod("core.types")
    return SimpleNamespace(
        Config=mod("params").Config,
        ETHER=mod("params").ETHER,
        SimulatedMainchain=mod("smc.chain").SimulatedMainchain,
        SMCClient=mod("mainchain.client").SMCClient,
        AccountManager=mod("mainchain.accounts").AccountManager,
        ShardNode=mod("node.backend").ShardNode,
        Hub=mod("p2p.service").Hub,
        P2PServer=mod("p2p.service").P2PServer,
        Notary=mod("actors.notary").Notary,
        LightClient=mod("actors.light").LightClient,
        Observer=mod("actors.observer").Observer,
        Proposer=mod("actors.proposer").Proposer,
        TXPool=mod("actors.txpool").TXPool,
        Syncer=mod("actors.syncer").Syncer,
        StateMirror=mod("mainchain.mirror").StateMirror,
        request_collation_body=mod("actors.syncer").request_collation_body,
        DASService=mod("das.service").DASService,
        CollationBodyRequest=mod("p2p.messages").CollationBodyRequest,
        ChunkProofRequest=mod("p2p.messages").ChunkProofRequest,
        ChunkProofResponse=mod("p2p.messages").ChunkProofResponse,
        Collation=types.Collation,
        CollationHeader=types.CollationHeader,
        Transaction=types.Transaction,
        serialize_txs_to_blob=types.serialize_txs_to_blob,
        sp=mod("core.state_processor"),
        secp256k1=mod("crypto.secp256k1"),
        keccak256=mod("crypto.keccak").keccak256,
        vote_digest=mod("smc.state_machine").vote_digest,
    )


# the CPU tests' pool: the committee's 8 slots filled
CPU_POOL = 8

# the hostile shards a sampled devnet can hold, in the order `plan` places
# them on the shards the notary is sampled for
HOSTILE_KINDS = ("withhold", "garbage", "foreign", "merkle_only")


def cpu_config(m):
    """The CPU tests' devnet: 4 shards, committee 8, quorum 1, periods of
    2 blocks (one voting head a period), windback depth 1."""
    return m.Config(shard_count=4, committee_size=8, quorum_size=1,
                    period_length=2, notary_lockup_length=0,
                    windback_depth=1)


def eligibility(m, cfg, pool: int, periods: int) -> dict:
    """period -> pool index -> the shards the SMC samples it for (the
    committee keccak over the last block of the period before)."""
    chain = m.SimulatedMainchain(cfg)
    while chain.block_number < periods * cfg.period_length:
        chain.commit()
    out = {}
    for period in range(1, periods + 1):
        bh = bytes(chain.blockhash(period * cfg.period_length - 1))
        out[period] = {
            i: [s for s in range(cfg.shard_count)
                if int.from_bytes(m.keccak256(
                    bh + i.to_bytes(32, "big") + s.to_bytes(32, "big")),
                    "big") % pool == i]
            for i in range(pool)}
    return out


def plan(m, cfg, pool: int, periods: int, min_proposers: int,
         hostile=()) -> dict:
    """Who sits where: the notary's pool index (sampled in the most
    periods from period 2 on, then in the most periods, then for the
    fewest distinct shards, so the fewest proposer nodes; with `hostile`
    kinds, sampled for the most distinct shards, then in the most
    periods), its own shard (its first sampled shard), the observer's
    shard (a shard some member is sampled for in every period, a notary
    one if there is one), the hostile shards (the notary's shards in the
    order it is first sampled for them, the observer's skipped, one a
    kind), the proposer shards (the notary's other shards, the
    observer's, then the lowest others up to `min_proposers`)."""
    elig = eligibility(m, cfg, pool, periods)
    distinct = lambda i: len({s for p in elig for s in elig[p][i]})
    active = lambda i: sum(1 for p in elig if elig[p][i])
    if hostile:
        score = lambda i: (distinct(i), active(i), -i)
    else:
        score = lambda i: (sum(1 for p in range(2, periods + 1)
                               if elig[p][i]), active(i), -distinct(i), -i)
    notary = max(range(pool), key=score)
    mine = sorted({s for p in elig for s in elig[p][notary]})
    if not mine:
        raise AssertionError("no pool index is ever sampled")
    voted = [{s for i in range(pool) for s in elig[p][i]} for p in elig]
    steady = sorted(set.intersection(*voted))
    if not steady:
        raise AssertionError("no shard is voted in every period")
    observer = next((s for s in steady if s in mine), steady[0])
    first_seen = sorted(mine, key=lambda s: (min(
        p for p in elig if s in elig[p][notary]), s))
    targets = [s for s in first_seen if s != observer]
    if len(targets) < len(hostile) or len(mine) == len(hostile):
        raise AssertionError(f"the notary is sampled for {mine}: too few "
                             f"shards for {len(hostile)} hostile ones and "
                             f"an honest one")
    bad = dict(zip(targets, hostile))
    proposers = sorted((set(mine) | {observer}) - set(bad))
    for s in range(cfg.shard_count):
        if len(proposers) >= min_proposers:
            break
        if s not in proposers and s not in bad:
            proposers.append(s)
    return {"notary": notary, "notary_shard": elig[min(
        p for p in elig if elig[p][notary])][notary][0],
            "proposers": sorted(proposers), "observer": observer,
            "hostile": bad, "eligibility": elig}


def sampled_expected(layout, plen: int, periods: int) -> dict:
    """The sampled notary's known answers from the layout: its votes (the
    honest shards it is sampled for), its checks, and the batched DAS
    calls each block's head makes, at windback depth 1. A period's voting
    heads are its first plen - 1 blocks; the first checks every candidate
    in one call, votes on the honest ones and checks each vote's windback
    period in a call of its own unless that verdict is cached; every later
    head checks the hostile candidates again (a negative verdict is not
    cached). A candidate whose commitment is rejected ("foreign") gives
    no row."""
    elig, me, bad = layout["eligibility"], layout["notary"], layout["hostile"]
    honest, hostile, calls = [], [], {}
    rowless = {"foreign"}
    for p in range(1, periods + 1):
        mine = elig[p][me]
        good = [s for s in mine if s not in bad]
        honest += [(s, p) for s in good]
        for k in range(plen - 1):
            block = p * plen + k
            fresh = mine if k == 0 else [s for s in mine if s in bad]
            hostile += [(s, p) for s in fresh if s in bad]
            phase3 = any(bad.get(s) not in rowless for s in fresh)
            windback = (sum(1 for s in good if p > 1
                            and s not in elig[p - 1][me]) if k == 0 else 0)
            if phase3 or windback:
                calls[block] = int(phase3) + windback
    held = set(honest) | {(s, p - 1) for s, p in honest if p > 1}
    return {"honest": honest, "hostile": hostile, "held": sorted(held),
            "calls": calls}


def wait_for(cond, what: str) -> None:
    """Poll `cond` until it holds; fail after WAIT_S seconds."""
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _seed_identity(node, seed: bytes) -> None:
    """Give the node a seeded account (the reference's `ShardNode` makes a
    fresh random one unless a keystore is given, which the port lacks):
    both packages then sign the same votes and headers."""
    client = node.client
    client._account = client.accounts.new_account(seed=seed)


def _sender_key(m, shard: int, sender: int) -> int:
    return int.from_bytes(m.keccak256(
        b"devnet-sender-%d-%d" % (shard, sender)), "big") % (
            m.secp256k1.N - 1) + 1


def _signed_txs(m, period: int, shard: int, count: int) -> list:
    """`count` signed zero-price transactions of `period` on `shard`. The
    senders hold nothing, so a transfer of zero applies and a transfer of
    value is rejected: up to four senders take the first count - 1 (or the
    one) in turn, nonces running on across periods; where count > 1 the
    last moves a value from a fifth sender (the replay rejects it)."""
    regular = max(1, count - 1)
    senders = min(4, regular)
    out = []
    for k in range(regular):
        sender = k % senders
        per_period = (regular - sender + senders - 1) // senders
        priv = _sender_key(m, shard, sender)
        tx = m.Transaction(nonce=(period - 1) * per_period + k // senders,
                           gas_price=0, gas_limit=25000,
                           to=m.secp256k1.priv_to_address(priv + 1),
                           value=0,
                           payload=b"devnet %d/%d/%d" % (period, shard, k))
        out.append(m.sp.sign_transaction(tx, priv))
    if count > 1:
        priv = _sender_key(m, shard, 4)
        tx = m.Transaction(nonce=0, gas_price=0, gas_limit=25000,
                           to=m.secp256k1.priv_to_address(priv + 1),
                           value=1, payload=b"devnet %d/%d/poor" % (period,
                                                                 shard))
        out.append(m.sp.sign_transaction(tx, priv))
    return out


def _kv_items(kv) -> list:
    return sorted((k.hex(), v.hex()) for k, v in kv.items())


# the notary's DAS counters a sampled devnet's summary holds: those whose
# count does not depend on how many fetch attempts a deadline allows
DAS_COUNTERS = ("samples_fetched", "samples_verified", "sample_failures",
                "multiproofs_fetched")


def _hostile_payload(m, period: int, shard: int, size: int) -> bytes:
    """`size` seeded bytes of a hostile shard's transaction payload."""
    seed = b"devnet hostile %d/%d" % (period, shard)
    return b"".join(m.keccak256(seed + i.to_bytes(4, "big"))
                    for i in range(-(-size // 32)))[:size]


def run(m, cfg, pool: int, periods: int, node_kw: dict,
        txs_per_collation: int = 1, min_proposers: int = 0,
        counts=None, seal_with=None, members=None, da_proofs=None,
        hostile=(), hostile_payload: int = 0, proposer_kw=None,
        finale=None) -> dict:
    """The devnet. `node_kw` goes to every `ShardNode` (the port's
    `sig_backend` and `device`, or the reference's `sig_backend`), and
    `proposer_kw`, where given, over it to the proposer nodes;
    `counts`, where given, returns kernel launch counts by name, read
    around each sealed block; `seal_with(block_number, commit)`, where
    given, seals each block by calling `commit` (a profiler's hook) and
    returns its result; `members`, where given, is (an `AccountManager`,
    at least `pool` of its accounts) to register, keys already derived
    (else seeded ones are made); `da_proofs` ("merkle" or "poly"), where
    given, runs every node sampled with that proof scheme, with the
    `hostile` kinds of `HOSTILE_KINDS` placed by `plan`, their bodies a
    transaction of `hostile_payload` seeded bytes (where non-zero);
    `finale(env)`, where given, runs after the last summary with every
    node still up (`env`: the chain, the hub, the nodes, the layout, the
    periods and the keyword arguments every node was built with; see
    `light_check` and `das_light_check`).
    Returns the chain, the nodes, the layout, the summaries by period
    (the last one after the final audit), the launches by period and
    block, each sealed block's seconds and what `finale` returned."""
    layout = plan(m, cfg, pool, periods, min_proposers or cfg.shard_count,
                  hostile)
    elig = layout["eligibility"]
    bad = layout["hostile"]
    if da_proofs is not None:
        node_kw = {**node_kw, "da_mode": "sampled", "da_proofs": da_proofs}
    if members is None:
        am = m.AccountManager()
        members = [am.new_account(seed=b"devnet-member-%d" % i)
                   for i in range(pool)]
    else:
        am, members = members
    chain = m.SimulatedMainchain(cfg)
    hub = m.Hub()
    common = dict(config=cfg, backend=chain, hub=hub, **node_kw)
    clients = {}

    def register(i):
        acct = members[i]
        chain.fund(acct.address)
        client = m.SMCClient(backend=chain, accounts=am, account=acct,
                             config=cfg)
        client.register_notary()
        clients[i] = client

    for i in range(layout["notary"]):
        register(i)
    notary_node = m.ShardNode(actor="notary", shard_id=layout["notary_shard"],
                              deposit=True, **common)
    _seed_identity(notary_node, b"devnet-notary")
    chain.fund(notary_node.client.account(), 2000 * m.ETHER)
    notary_node.start()    # deposits in its start: pool index fixed here
    for i in range(layout["notary"] + 1, pool):
        register(i)
    proposer_nodes = {}
    for s in layout["proposers"]:
        node = m.ShardNode(actor="proposer", shard_id=s,
                           txpool_interval=None, simulator_interval=3600.0,
                           **{**common, **(proposer_kw or {})})
        _seed_identity(node, b"devnet-proposer-%d" % s)
        chain.fund(node.client.account(), 2000 * m.ETHER)
        proposer_nodes[s] = node
    observer_node = m.ShardNode(actor="observer", shard_id=layout["observer"],
                                simulator_interval=3600.0, **common)
    _seed_identity(observer_node, b"devnet-observer")
    script_proposer = am.new_account(seed=b"devnet-script-proposer")
    nodes = {"notary": notary_node, "observer": observer_node,
             **{f"proposer-{s}": n for s, n in proposer_nodes.items()}}
    # sampled: the script's own DAS services for the hostile shards it
    # proposes (a merkle-only one besides for that kind), and a watch on
    # the body requests every node sends
    script_das = {}
    watch = body_requests = das0 = None
    if da_proofs is not None:
        script_client = m.SMCClient(backend=chain, accounts=am,
                                    account=script_proposer, config=cfg)
        modes = {da_proofs} | ({"merkle"} if "merkle_only" in bad.values()
                               else set())
        for mode in sorted(modes):
            script_das[mode] = m.DASService(
                client=script_client, p2p=m.P2PServer(hub), proof_mode=mode)
            script_das[mode].start()
        foreign = am.new_account(seed=b"devnet-foreign-key")
        watch = m.P2PServer(hub)
        watch.start()
        body_requests = watch.subscribe(m.CollationBodyRequest)
        das0 = {k: getattr(notary_node.das_service, f"m_{k}").value
                for k in DAS_COUNTERS}
    notary_requests = []

    if notary_node.client.notary_registry().pool_index != layout["notary"]:
        raise AssertionError("the notary node took another pool index")
    for node in list(proposer_nodes.values()) + [observer_node]:
        node.start()
    notary = notary_node.service(m.Notary)
    observer = observer_node.service(m.Observer)
    obs_syncer = observer_node.service(m.Syncer)
    plen = cfg.period_length
    summaries, launches, block_s = {}, {}, {}
    windback0 = notary.m_windback_checks.value

    def seal(period):
        """Commit one block (every node's heads run in this thread);
        count its launches and time it."""
        before = counts() if counts is not None else {}
        t0 = time.perf_counter()
        block = (chain.commit() if seal_with is None
                 else seal_with(chain.block_number + 1, chain.commit))
        block_s[block.number] = time.perf_counter() - t0
        if counts is not None:
            got = {k: c - before.get(k, 0) for k, c in counts().items()
                   if c != before.get(k, 0)}
            if got:
                launches.setdefault(period, {})[block.number] = got
        return block

    def feed(period):
        for s, node in proposer_nodes.items():
            txpool = node.service(m.TXPool)
            proposer = node.service(m.Proposer)
            made = proposer.collations_proposed
            txs = _signed_txs(m, period, s, txs_per_collation)
            if len(txs) > 1:
                proposer.stop()
                for tx in txs[:-1]:
                    txpool.submit(tx)
                proposer.start()
            txpool.submit(txs[-1])
            wait_for(lambda: proposer.collations_proposed > made
                     and chain.last_submitted_collation(s) == period,
                     f"the proposer of shard {s} in period {period}")
        for s in range(cfg.shard_count):
            if s in proposer_nodes:
                continue
            payload = b"script %d/%d" % (period, s)
            if s in bad and hostile_payload:
                payload = _hostile_payload(m, period, s, hostile_payload)
            tx = m.Transaction(nonce=s, gas_limit=21000, value=period,
                               payload=payload)
            body = m.serialize_txs_to_blob([tx])
            root = m.Collation(header=m.CollationHeader(),
                               body=body).calculate_chunk_root()
            header = m.CollationHeader(
                shard_id=s, chunk_root=root, period=period,
                proposer_address=script_proposer.address)
            header.add_sig(m.secp256k1.sign(
                bytes(header.hash()), script_proposer.priv).to_bytes65())
            if s in bad:
                publish_hostile(bad[s], s, period, root, body)
            chain.add_header(script_proposer.address, s, period, root,
                             header.proposer_signature)

    def publish_hostile(kind, s, period, root, body):
        """Publish shard `s`'s collation through the script's DAS service,
        then make it `kind`: the commitment served but no sample; garbage
        chunks under the real commitment; the commitment signed by another
        key; or published merkle-only."""
        das = script_das["merkle" if kind == "merkle_only" else da_proofs]
        commitment = das.publish(s, period, root, body)
        key = bytes(commitment.das_root)
        if kind == "withhold":
            del das._blobs[key]
            das._poly.pop(key, None)
        elif kind == "garbage":
            xb, levels = das._blobs[key]
            junk = tuple(m.keccak256(b"garbage %d" % i) * 128
                         for i in range(xb.n))
            das._blobs[key] = (dataclasses.replace(xb, chunks=junk), levels)
        elif kind == "foreign":
            das._commitments[(s, period)] = dataclasses.replace(
                commitment, signature=m.secp256k1.sign(
                    commitment.digest(), foreign.priv).to_bytes65())

    def members_vote(period):
        ctx = chain.committee_context()
        size = ctx["sample_size"]
        for i in range(pool):
            prefix = ctx["blockhash"] + i.to_bytes(32, "big")
            got = [s for s in range(cfg.shard_count)
                   if int.from_bytes(m.keccak256(
                       prefix + s.to_bytes(32, "big")), "big") % size == i]
            if got != elig[period][i]:
                raise AssertionError(f"period {period}: member {i} "
                                     f"sampled for {got}")
            if i == layout["notary"]:
                continue
            for s in got:
                rec = chain.collation_record(s, period)
                digest = m.vote_digest(s, period, rec.chunk_root)
                clients[i].submit_vote(s, period, i, rec.chunk_root,
                                       bls_sig=clients[i].bls_sign(digest))

    def show_observer(period):
        """The observer's canonical header from the SMC's record, its body
        over the hub from the proposer's syncer."""
        s = layout["observer"]
        if chain.last_approved_collation(s) != period:
            raise AssertionError(f"shard {s} not approved in {period}")
        rec = chain.collation_record(s, period)
        header = m.CollationHeader(shard_id=s, chunk_root=rec.chunk_root,
                                   period=period,
                                   proposer_address=rec.proposer,
                                   proposer_signature=rec.signature)
        observer_node.shard.save_header(header)
        stored = obs_syncer.bodies_stored
        observer_node.p2p.broadcast(
            m.request_collation_body(observer_node.client, s, period))
        wait_for(lambda: obs_syncer.bodies_stored > stored,
                 f"the observer's body of period {period}")
        observer_node.shard.set_canonical(header)

    def summary(period):
        mirror = notary_node.service(m.StateMirror).snapshot()
        journal = notary.journal
        return {
            "shard_dbs": {name: _kv_items(node.services[0].db)
                          for name, node in nodes.items()},
            "words": sorted(chain.smc.current_vote.items()),
            "records": sorted(
                (s, p, bytes(r.chunk_root).hex(), r.vote_count,
                 bool(r.is_elected), sorted(r.vote_sigs))
                for (s, p), r in chain.smc.collation_records.items()),
            "approved": {s: chain.last_approved_collation(s)
                         for s in range(cfg.shard_count)},
            "notary": {k: getattr(notary, k) for k in (
                "votes_submitted", "signatures_rejected", "canonical_set",
                "audits_run", "audit_mismatches",
                "aggregate_sigs_verified")},
            "windback_checks": notary.m_windback_checks.value - windback0,
            "journal": {"votes": sorted(journal.votes()),
                        "audit_high_water": journal.audit_high_water()},
            "mirror": json.loads(json.dumps(mirror, sort_keys=True)),
            "state_roots": {p: bytes(r).hex()
                            for p, r in observer.state_roots.items()},
            "canonical_roots": {p: bytes(r).hex()
                                for p, r in observer.canonical_roots.items()},
            "observer": {"txs_replayed": observer.txs_replayed,
                         "txs_rejected": observer.txs_rejected},
            "errors": {name: node.errors() for name, node in nodes.items()},
            **(das_summary() if da_proofs is not None else {}),
        }

    def das_summary():
        """The sampled notary's verdicts, DAS counters and fetched bytes,
        the proposers' publications, and the body requests the notary
        sent (the script's own, for the observer, come from another
        peer)."""
        das = notary_node.das_service
        me = notary_node.p2p.self_peer
        while True:
            msg = body_requests.try_get()
            if msg is None:
                break
            if msg.peer == me:
                notary_requests.append(msg.data)
        return {"das": {
            "verdicts": sorted(notary._da_verdicts),
            "counters": {k: getattr(das, f"m_{k}").value - das0[k]
                         for k in DAS_COUNTERS},
            "bytes_fetched": das.bytes_fetched,
            "published": {s: node.service(m.Proposer).das_published
                          for s, node in proposer_nodes.items()},
            "notary_body_requests": len(notary_requests)}}

    try:
        for period in range(1, periods + 1):
            while chain.block_number < period * plen - 1:
                seal(period - 1)
            feed(period)
            seal(period)                       # the notary's head
            members_vote(period)
            show_observer(period)
            seal(period)                       # the observer's replay
            wait_for(lambda: period in observer.seen_periods,
                     f"the observer's replay of period {period}")
            summaries[period] = summary(period)
        while chain.block_number < (periods + 1) * plen:
            seal(periods)                      # the last period's audit
        summaries[periods + 1] = summary(periods + 1)
        ended = None if finale is None else finale(SimpleNamespace(
            chain=chain, hub=hub, nodes=nodes, layout=layout,
            periods=periods, node_kw=common))
    finally:
        for node in nodes.values():
            node.stop()
        for das in script_das.values():
            das.stop()
        if watch is not None:
            watch.stop()
    return {"chain": chain, "nodes": nodes, "layout": layout,
            "summaries": summaries, "launches": launches,
            "block_s": block_s, "finale": ended}


def _light_node(m, env, shard: int):
    """A light node joining the devnet's chain and hub, started."""
    node = m.ShardNode(actor="light", shard_id=shard, **env.node_kw)
    node.start()
    return node


def light_check(m, env, k: int = 16, seed: bytes = b"devnet-light") -> dict:
    """A `run` finale: a light node proves the observer's canonical
    collation of the last period from the hub (the proposer's and the
    notary's syncers serve the proofs): its proven length, an availability
    check of `k` draws from `seed`, four samples against the body's bytes,
    its counters and errors."""
    s, p = env.layout["observer"], env.periods
    body = env.nodes["observer"].shard.canonical_collation(s, p).body
    node = _light_node(m, env, s)
    try:
        light = node.service(m.LightClient)
        indices = [0, len(body) // 3, 2 * len(body) // 3, len(body) - 1]
        return {"body_len": len(body),
                "proven_length": light.proven_length(s, p),
                "available": light.availability_check(s, p, k=k, seed=seed),
                "samples": light.sample(s, p, indices),
                "want": {i: body[i] for i in indices},
                "samples_verified": light.samples_verified,
                "proofs_rejected": light.proofs_rejected,
                "errors": node.errors()}
    finally:
        node.stop()


def das_light_check(m, env, seed: bytes = b"devnet-das-light") -> dict:
    """A `run` finale of a sampled devnet: a light node (`da_mode=
    "sampled"`, a DAS service with no store) runs `das_check` on the
    first proposer's shard and on the withheld shard (where the layout has
    one) of the last period, draws from `seed`."""
    p = env.periods
    withheld = [s for s, kind in env.layout["hostile"].items()
                if kind == "withhold"]
    honest = env.layout["proposers"][0]
    node = _light_node(m, env, honest)
    try:
        light = node.service(m.LightClient)
        out = {"honest": light.das_check(honest, p, seed=seed)}
        if withheld:
            out["withheld"] = light.das_check(withheld[0], p, seed=seed)
        out.update(samples_verified=light.samples_verified,
                   proofs_rejected=light.proofs_rejected,
                   errors=node.errors())
        return out
    finally:
        node.stop()


def jsonable(summaries: dict) -> dict:
    """The summaries as a JSON round trip gives them."""
    return json.loads(json.dumps(summaries, sort_keys=True))
