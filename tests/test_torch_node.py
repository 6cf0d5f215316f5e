"""The port's sharding node (`gethsharding_tpu_torch.node`: `ShardNode`, its
services and the CLI) held against the JAX package's, on the CPU, both on
the same seeded inputs, bytes equal:

1. the composition: each actor's services in registration order, and the
   refusals of what the port has not ported;
2. the parts: feed and hub delivery order, a datadir written by one
   package's `ShardDB` read by the other's, `assemble_snapshot` and the
   state mirror's persisted snapshot, `VoteJournal` keys and values,
   `TXPool` selection (nonce gaps, replacement by price, eviction at the
   cap), its journal replayed across packages and its sender recovery
   through a signature backend, `create_collation`, a syncer round trip over the hub, the
   notary's windback fetched over the hub, the journal's recovery on
   start, the supervisor, the `convert` carriers of the node's state;
3. the observer's `torch` engine on the CPU against the reference's
   `python` engine (and its `jax` engine in `-m slow`), an all-rejected
   collation included;
4. a whole seeded devnet (`tests/torch_node_script.py`: a notary, a
   proposer a shard, an observer, one chain and one hub; 4 shards, a pool
   of 8, quorum 1, windback 1): shard DBs, votes, journal, mirror
   snapshot, observer roots and errors equal the reference's after every
   period; the canonical headers the notary wrote are the SMC's; the
   same devnet in a subprocess where `jax` and `gethsharding_tpu` are
   blocked (started with the in-process devnets, so it runs beside them)
   equal to the in-process run; a light node joining each devnet proves
   the observer's collation as the reference's does;
5. the CLI: the ported flags and their defaults against the reference's,
   every other reference flag absent, `--actor light` running with no
   device and logging its exit line, the node's loop on the CPU, and no
   card: a non-zero exit.

Blocks are sealed by explicit commits; the threaded services are waited on
through their own counters, never a fixed sleep.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import torch_node_script as script
from gethsharding_tpu.actors.notary import Notary as RNotary
from gethsharding_tpu.actors.observer import Observer as RObserver
from gethsharding_tpu.actors.proposer import create_collation as r_create
from gethsharding_tpu.actors.syncer import Syncer as RSyncer
from gethsharding_tpu.actors.txpool import TXPool as RTXPool
from gethsharding_tpu.core.shard import Shard as RShard
from gethsharding_tpu.core.types import Transaction as RTransaction
from gethsharding_tpu.db.kv import MemoryKV as RMemoryKV
from gethsharding_tpu.db.shard_db import ShardDB as RShardDB
from gethsharding_tpu.mainchain import mirror as rmirror
from gethsharding_tpu.node.backend import ShardNode as RShardNode
from gethsharding_tpu.node.cli import build_parser as r_build_parser
from gethsharding_tpu.resilience.journal import VoteJournal as RVoteJournal
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.actors.observer import Observer
from gethsharding_tpu_torch.actors.proposer import create_collation
from gethsharding_tpu_torch.actors.syncer import Syncer
from gethsharding_tpu_torch.actors.txpool import TXPool, TxPoolError
from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.shard import Shard, ShardError
from gethsharding_tpu_torch.core.types import CollationHeader, Transaction
from gethsharding_tpu_torch.crypto import secp256k1
from gethsharding_tpu_torch.db.kv import MemoryKV
from gethsharding_tpu_torch.db.shard_db import ShardDB
from gethsharding_tpu_torch.mainchain import mirror
from gethsharding_tpu_torch.node import cli
from gethsharding_tpu_torch.node.backend import ShardNode
from gethsharding_tpu_torch.resilience.journal import VoteJournal

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = script.modules("gethsharding_tpu_torch")
REF = script.modules("gethsharding_tpu")
PORT_NODE = {"sig_backend": "torch", "device": "cpu"}
REF_NODE = {"sig_backend": "python"}
PERIODS = 2

_JAX_FREE = r'''
import json, sys
sys.modules["jax"] = None
sys.modules["gethsharding_tpu"] = None
import torch
torch.set_num_threads(2)
import torch_node_script as script
m = script.modules("gethsharding_tpu_torch")
out = script.run(m, script.cpu_config(m), script.CPU_POOL, %d,
                 {"sig_backend": "torch", "device": "cpu"})
bad = sorted(n for n, mod in sys.modules.items() if mod is not None
             and (n in ("jax", "gethsharding_tpu") or n.startswith("jax.")
                  or n.startswith("gethsharding_tpu.")))
print("RESULTS " + json.dumps({"summaries": script.jsonable(
    out["summaries"]), "bad": bad}))
''' % PERIODS


@pytest.fixture(scope="module")
def jax_free_run():
    """The port's devnet in a fresh interpreter that cannot import jax or
    the JAX package; started with the in-process devnets (`port_devnet`)
    so that it runs beside them."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FREE], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_devnet(jax_free_run):
    return script.run(PORT, script.cpu_config(PORT), script.CPU_POOL,
                      PERIODS, PORT_NODE,
                      finale=lambda env: script.light_check(PORT, env))


@pytest.fixture(scope="module")
def ref_devnet():
    return script.run(REF, script.cpu_config(REF), script.CPU_POOL,
                      PERIODS, REF_NODE,
                      finale=lambda env: script.light_check(REF, env))


def _names(node) -> list:
    return [type(s).__name__ for s in node.services]


# == 1. the composition =======================================================

@pytest.mark.parametrize("actor", ["notary", "proposer", "observer",
                                   "light"])
def test_registry_composition_per_actor(actor):
    """Each actor's services, in registration order, are the reference's
    (the counterpart of tests/test_node.py)."""
    ref = RShardNode(actor=actor, backend=REF.SimulatedMainchain(),
                     txpool_interval=None, **REF_NODE)
    port = ShardNode(actor=actor, backend=PORT.SimulatedMainchain(),
                     txpool_interval=None, **PORT_NODE)
    assert _names(port) == _names(ref)
    assert port.service(type(port.services[0])).db is port.shard._db
    if actor == "observer":
        obs = port.service(Observer)
        assert (obs.replay_engine, obs.device.type) == ("torch", "cpu")
    if actor == "notary":
        notary = port.service(PORT.Notary)
        assert notary.p2p is port.p2p and notary.journal is not None
        assert notary.mirror is port.service(PORT.StateMirror)
        assert notary.sig_backend.device.type == "cpu"


def test_nodes_share_hub_and_backend():
    chain, hub = PORT.SimulatedMainchain(), PORT.Hub()
    a = ShardNode(actor="proposer", backend=chain, hub=hub,
                  txpool_interval=None, **PORT_NODE)
    b = ShardNode(actor="notary", backend=chain, hub=hub, **PORT_NODE)
    assert a.client.backend is b.client.backend
    assert a.p2p.hub is b.p2p.hub


def test_journal_knob_turns_the_journal_off(monkeypatch):
    monkeypatch.setenv("GETHSHARDING_TORCH_VOTE_JOURNAL", "0")
    node = ShardNode(actor="notary", backend=PORT.SimulatedMainchain(),
                     **PORT_NODE)
    assert node.service(PORT.Notary).journal is None


_REFUSED = ("fleet_frontend", "http_port")


@pytest.mark.parametrize("option", sorted(_REFUSED))
def test_unported_options_refuse_by_module(option):
    """The two node options that waited for their modules (`fleet/` and
    `node/http_status.py`) are taken now, as the reference takes them:
    `fleet_frontend` dials the frontend (one endpoint an
    `RpcReplicaBackend`, a comma list a `FrontendPool`) and resolves no
    device for a notary, so no card is needed; `http_port` registers the
    status page."""
    import socket

    from gethsharding_tpu_torch.fleet.router import RpcReplicaBackend
    from gethsharding_tpu_torch.node.http_status import StatusServer
    from gethsharding_tpu_torch.rpc.client import FrontendPool

    if option == "http_port":
        node = ShardNode(backend=PORT.SimulatedMainchain(), http_port=0,
                         **PORT_NODE)
        status = node.service(StatusServer)
        assert node.services[-1] is status and status.port == 0
        return
    with socket.socket() as listener:
        listener.bind(("127.0.0.1", 0))
        listener.listen(4)
        endpoint = "127.0.0.1:%d" % listener.getsockname()[1]
        for spec, kind in ((endpoint, RpcReplicaBackend),
                           (f"{endpoint},127.0.0.1:1", FrontendPool)):
            node = ShardNode(actor="notary",
                             backend=PORT.SimulatedMainchain(),
                             fleet_frontend=spec)
            try:
                assert isinstance(node.sig_backend, kind)
                assert node.device is None and node.soundness_backend is None
                # the notary's audit reads the backend's name (the JAX
                # package's pool has none)
                assert node.sig_backend.name != "torch"
            finally:
                node.sig_backend.close()


def test_unknown_actor_and_backend_rejected():
    with pytest.raises(ValueError, match="unknown actor"):
        ShardNode(actor="validator", device="cpu")
    with pytest.raises(ValueError, match="unknown sigbackend"):
        ShardNode(sig_backend="jax", device="cpu")


def test_node_without_a_card_raises():
    """No fallback to the CPU: the default device is the card."""
    if torch.cuda.is_available():
        node = ShardNode(backend=PORT.SimulatedMainchain())
        assert node.device.type == "cuda"
        return
    for actor in ("notary", "proposer", "observer"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardNode(actor=actor, backend=PORT.SimulatedMainchain())


# == 2. the parts =============================================================

def _hub_traffic(m):
    """Three servers on one hub: directed sends, broadcasts and loopbacks;
    what each server's feeds received, in order."""
    hub = m.Hub()
    p2p = importlib_p2p(m)
    servers = [p2p.P2PServer(hub=hub) for _ in range(3)]
    for s in servers:
        s.start()
    subs = [(s.subscribe(p2p.CollationBodyRequest),
             s.subscribe(p2p.CollationBodyResponse)) for s in servers]
    root = m.keccak256(b"hub-root")
    req = lambda i: p2p.CollationBodyRequest(
        chunk_root=root, shard_id=i, period=i + 1, proposer=None)
    resp = lambda i: p2p.CollationBodyResponse(header_hash=root,
                                               body=b"body-%d" % i)
    servers[0].broadcast(req(0))
    servers[1].send(resp(1), servers[0].self_peer)
    servers[2].broadcast(req(2))
    servers[0].send(resp(3), servers[2].self_peer)
    servers[1].loopback(req(4))
    servers[2].stop()
    servers[0].broadcast(req(5))          # server 2 is detached
    out = []
    for i, (rq, rs) in enumerate(subs):
        for sub in (rq, rs):
            while (msg := sub.try_get()) is not None:
                data = msg.data
                out.append((i, msg.peer.peer_id, type(data).__name__,
                            getattr(data, "shard_id", None),
                            getattr(data, "body", None)))
    return out


def importlib_p2p(m):
    import importlib

    return importlib.import_module(
        m.Hub.__module__.rsplit(".", 1)[0])


def test_feed_and_hub_delivery_order_match_reference():
    assert _hub_traffic(PORT) == _hub_traffic(REF)
    # the feed's drop-oldest policy at a full queue, as the reference
    got = []
    for m in (PORT, REF):
        feed = importlib_p2p(m).Feed()
        sub = feed.subscribe(maxsize=2)
        reached = [feed.send(i) for i in range(3)]
        got.append((reached, [sub.try_get() for _ in range(3)],
                    feed.subscriber_count))
        sub.unsubscribe()
        got.append(feed.subscriber_count)
    assert got[0] == got[2] == ([1, 1, 1], [1, 2, None], 1)
    assert got[1] == got[3] == 0


def _fill_shard_db(pkg, db):
    """Collations, availability bits, a canonical header, journal votes,
    an audit mark and a mirror snapshot into `db`."""
    types = pkg.Collation.__module__
    shard = (Shard if types.startswith("gethsharding_tpu_torch")
             else RShard)(1, db.db)
    for i in range(3):
        tx = pkg.Transaction(nonce=i, gas_limit=21000,
                             payload=b"db-%d" % i * (i + 1))
        col = pkg.Collation(
            header=pkg.CollationHeader(shard_id=1, period=i + 1,
                                       proposer_address=None),
            body=pkg.serialize_txs_to_blob([tx]), transactions=[tx])
        col.calculate_chunk_root()
        shard.save_collation(col)
        if i == 1:
            shard.set_canonical(col.header)
    shard.set_availability(pkg.keccak256(b"absent"), False)
    journal_cls = (VoteJournal if types.startswith("gethsharding_tpu_torch")
                   else RVoteJournal)
    journal = journal_cls(db.db)
    journal.record_vote(1, 2)
    journal.record_vote(3, 2)
    journal.set_audit_high_water(1)
    db.db.put(b"smc-mirror:latest", b'{"period": 2}')


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_datadir_crosses_packages(writer):
    """A datadir written by one package's `ShardDB` (SQLite under
    `<datadir>/shardchaindata`) opens in the other's with the same items,
    and its shard reads answer the same."""
    with tempfile.TemporaryDirectory() as tmp:
        wcls, rcls = ((RShardDB, ShardDB) if writer == "reference"
                      else (ShardDB, RShardDB))
        wpkg = REF if writer == "reference" else PORT
        db = wcls(data_dir=tmp, in_memory=False)
        _fill_shard_db(wpkg, db)
        written = convert.kv_items(db.db)
        db.stop()
        assert os.path.exists(os.path.join(tmp, "shardchaindata"))
        other = rcls(data_dir=tmp, in_memory=False)
        assert convert.kv_items(other.db) == written
        rshard = (RShard if rcls is RShardDB else Shard)(1, other.db)
        got = rshard.canonical_collation(1, 2)
        assert got.body == wpkg.serialize_txs_to_blob(
            [wpkg.Transaction(nonce=1, gas_limit=21000,
                              payload=b"db-1" * 2)])
        other.stop()
    assert len(written) == 15   # 3 collations × 3 keys, 6 more


def test_shard_db_items_carry_across():
    """`convert.kv_items` of the reference's shard DB, written into the
    port's by `kv_from_items`: the same items, and the port's `Shard`
    reads the reference's collations from them."""
    ref = RShardDB()
    _fill_shard_db(REF, ref)
    items = convert.kv_items(ref.db)
    port = convert.kv_from_items(items)
    assert convert.kv_items(port) == items
    got = Shard(1, port).canonical_collation(1, 2)
    assert [t.payload for t in got.transactions] == [b"db-1" * 2]
    assert VoteJournal(port).audit_high_water() == 1


def _snapshot_chain(m):
    """A chain with 3 registered notaries, headers in periods 1-3 and
    votes, at windback depth 2; returns (chain, client)."""
    cfg = m.Config(shard_count=3, committee_size=4, quorum_size=1,
                   period_length=2, notary_lockup_length=0,
                   windback_depth=2)
    chain = m.SimulatedMainchain(cfg)
    am = m.AccountManager()
    accts = [am.new_account(seed=b"snap-%d" % i) for i in range(3)]
    clients = []
    for a in accts:
        chain.fund(a.address)
        c = m.SMCClient(backend=chain, accounts=am, account=a, config=cfg)
        c.register_notary()
        clients.append(c)
    for period in (1, 2, 3):
        while chain.block_number < period * 2 - 1:
            chain.commit()
        for s in range(2):
            root = m.keccak256(b"snap-root-%d-%d" % (period, s))
            chain.add_header(accts[0].address, s, period, root,
                             b"\x01" * 65 if s else b"")
        chain.commit()
        for i, c in enumerate(clients):
            for s in range(2):
                if chain.get_notary_in_committee(c.account(), s) \
                        == c.account():
                    rec = chain.collation_record(s, period)
                    c.submit_vote(s, period, i, rec.chunk_root,
                                  bls_sig=c.bls_sign(m.vote_digest(
                                      s, period, rec.chunk_root)))
    return chain, clients[0]


def test_assemble_snapshot_bytes_match_reference():
    rchain, rclient = _snapshot_chain(REF)
    pchain, pclient = _snapshot_chain(PORT)
    for rsrc, psrc in ((rchain, pchain), (rclient, pclient)):
        want = rmirror._encode(rmirror.assemble_snapshot(rsrc))
        got = mirror._encode(mirror.assemble_snapshot(psrc))
        assert got == want
    snap = mirror._decode(got)
    assert sorted(snap["prior_records"]) == [1, 2]
    assert snap == rmirror._decode(want)
    # the read surface
    rec = next(iter(snap["records"].values()))
    assert tuple(mirror.decode_record(rec)) == tuple(
        rmirror.decode_record(rec))
    ctx = mirror.decode_committee_context(snap["committee_context"])
    assert ctx == rmirror.decode_committee_context(
        rmirror._decode(want)["committee_context"])
    assert ctx["blockhash"] == bytes(pchain.committee_context()["blockhash"])
    # carried across in the persisted encoding
    assert convert.mirror_snapshot_fields(
        rmirror.assemble_snapshot(rchain)) == want
    assert convert.mirror_snapshot_from_fields(want) == snap


def test_state_mirror_persists_and_resumes_like_reference():
    out = []
    for m, kv in ((PORT, MemoryKV()), (REF, RMemoryKV())):
        chain, client = _snapshot_chain(m)
        mir = m.StateMirror(client=client, shard_db=kv)
        mir.start()
        chain.commit()                   # a head refreshes it
        snap = mir.snapshot()
        mir.stop()
        warm = m.StateMirror(client=client, shard_db=kv)
        assert warm.resumed_from_disk and warm.snapshot() == snap
        out.append((sorted(kv.items()), mir.refreshes, snap["block_number"],
                    warm.record_view(0)))
    assert out[0][:3] == out[1][:3]
    assert tuple(out[0][3]) == tuple(out[1][3])


def _journal_ops(journal):
    log = []
    for s, p in ((0, 1), (2, 1), (1, 2), (0, 3)):
        journal.record_vote(s, p)
    log.append(journal.has_vote(2, 1))
    log.append(journal.has_vote(2, 2))
    journal.set_audit_high_water(2)
    journal.set_audit_high_water(1)      # monotonic
    log.append(journal.audit_high_water())
    log.append(journal.prune_votes(before_period=2))
    log.append(sorted(journal.votes()))
    log.append(journal.invalidate_if_reset(5))
    return log


def test_vote_journal_keys_and_values_match_reference():
    pkv, rkv = MemoryKV(), RMemoryKV()
    assert _journal_ops(VoteJournal(pkv)) == _journal_ops(RVoteJournal(rkv))
    assert sorted(pkv.items()) == sorted(rkv.items())
    keys = sorted(k for k, _ in pkv.items())
    assert keys[0] == b"vj/audit_hwm"
    assert keys[1] == b"vj/v/" + (0).to_bytes(8, "big") + (3).to_bytes(8,
                                                                        "big")
    # a journal ahead of the chain is cleared
    rj, pj = RVoteJournal(rkv), VoteJournal(pkv)
    assert (pj.invalidate_if_reset(1), rj.invalidate_if_reset(1)) == (
        True, True)
    assert sorted(pkv.items()) == sorted(rkv.items()) == []
    # carried across
    rj.record_vote(4, 7)
    rj.set_audit_high_water(6)
    carried = convert.journal_from_records(convert.journal_records(rj))
    assert sorted(carried.kv.items()) == sorted(rkv.items())


_KEYS = [0xA11CE + i for i in range(3)]


def _tx_stream():
    """A seeded stream of (sender key, nonce, price, payload) rows: nonce
    runs, a gap, a duplicate, replacements under- and over-priced, and
    more than the pool's cap of 6."""
    return [(0, 0, 5, b"a0"), (0, 1, 5, b"a1"), (0, 3, 9, b"a3-gap"),
            (1, 0, 7, b"b0"), (1, 0, 7, b"b0"), (1, 0, 6, b"b0-cheap"),
            (1, 0, 8, b"b0-dear"), (2, 0, 1, b"c0"), (2, 1, 2, b"c1"),
            (1, 1, 4, b"b1"), (0, 2, 3, b"a2"), (2, 2, 10, b"c2")]


def _signed(tx_cls, key, nonce, price, payload):
    tx = sp.sign_transaction(Transaction(
        nonce=nonce, gas_price=price, gas_limit=25000,
        to=secp256k1.priv_to_address(0xB0B), value=1, payload=payload),
        _KEYS[key])
    return tx_cls.decode_rlp(tx.encode_rlp())


def _txpool_run(pool_cls, tx_cls, error_cls):
    pool = pool_cls(simulate_interval=None, capacity=6)
    log = []
    for row in _tx_stream():
        tx = _signed(tx_cls, *row)
        try:
            log.append(pool.submit(tx))
        except error_cls as exc:
            log.append(str(exc))
        log.append((pool.known_count(), pool.queued_count()))
    pending = [bytes(t.encode_rlp()) for t in pool.pending()]
    held = convert.txpool_pending(pool)
    taken = [bytes(t.encode_rlp()) for t in pool.take_pending(limit=3)]
    return log, pending, held, taken, pool.known_count()


def test_txpool_selection_matches_reference():
    from gethsharding_tpu.actors.txpool import TxPoolError as RTxPoolError

    port = _txpool_run(TXPool, Transaction, TxPoolError)
    ref = _txpool_run(RTXPool, RTransaction, RTxPoolError)
    assert port == ref
    log, pending, held, taken, left = port
    assert "replacement transaction underpriced" in log
    assert "already known" in log
    assert len(held) == 6 and left == len(held) - 3
    # carried across: the reference's pool, rebuilt in the port
    rpool = RTXPool(simulate_interval=None)
    for blob in held:
        rpool.submit(RTransaction.decode_rlp(blob))
    carried = convert.txpool_from_pending(convert.txpool_pending(rpool))
    assert [bytes(t.encode_rlp()) for t in carried.pending()] == [
        bytes(t.encode_rlp()) for t in rpool.pending()]


def _txpool_journal(pool_cls, tx_cls, error_cls, path):
    """The seeded stream through a journaled pool of cap 6, then a torn
    tail as after a crash mid-write. Returns the journal's bytes and the
    live pool's holdings."""
    pool = pool_cls(simulate_interval=None, capacity=6, journal_path=path)
    pool.start()
    for row in _tx_stream():
        try:
            pool.submit(_signed(tx_cls, *row))
        except error_cls:
            pass
    pool.stop()
    with open(path, "ab") as fh:
        fh.write((100).to_bytes(4, "big") + b"torn")
    return Path(path).read_bytes(), convert.txpool_pending(pool)


def _txpool_replayed(pool_cls, path):
    """A fresh pool of cap 6 started on the journal at `path`."""
    pool = pool_cls(simulate_interval=None, capacity=6, journal_path=path)
    pool.start()
    pool.stop()
    return (convert.txpool_pending(pool),
            [bytes(t.encode_rlp()) for t in pool.pending()],
            pool.known_count(), pool.queued_count(), pool.errors)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_txpool_journal_replays_across_packages(writer, tmp_path):
    """Both packages journal the same bytes; a journal written by either
    restarts either's pool into the same holdings, the live pool's, the
    torn tail dropped."""
    from gethsharding_tpu.actors.txpool import TxPoolError as RTxPoolError

    port_bytes, port_held = _txpool_journal(
        TXPool, Transaction, TxPoolError, str(tmp_path / "port.journal"))
    ref_bytes, ref_held = _txpool_journal(
        RTXPool, RTransaction, RTxPoolError, str(tmp_path / "ref.journal"))
    assert port_bytes == ref_bytes and port_held == ref_held
    path = str(tmp_path / f"{'ref' if writer == 'reference' else 'port'}"
                          f".journal")
    port = _txpool_replayed(TXPool, path)
    assert port == _txpool_replayed(RTXPool, path)
    held, _, known, _, errors = port
    assert held == port_held and known == 6 and errors == []


class _DownBackend:
    """A signature backend whose every recovery fails."""

    def ecrecover_addresses(self, digests, sigs65):
        raise RuntimeError("backend down")


def _txpool_backend_run(pool_cls, tx_cls, error_cls, backend):
    """Admission with sender recovery through `backend`: a good signature
    (one backend row), v outside {27, 28} and an r past 256 bits (both
    refused before the backend), an opaque payload (no signature), and a
    failing backend."""
    good = _signed(tx_cls, 0, 0, 5, b"a0")
    cases = [good, dataclasses.replace(good, v=29, payload=b"v29"),
             dataclasses.replace(good, r=1 << 256, payload=b"r-wide"),
             tx_cls(nonce=1, payload=b"opaque")]
    pool = pool_cls(simulate_interval=None, sig_backend=backend)
    log = []
    for tx in cases:
        try:
            log.append(pool.submit(tx))
        except error_cls as exc:
            log.append(str(exc))
    down = pool_cls(simulate_interval=None, sig_backend=_DownBackend())
    try:
        down.submit(good)
    except error_cls as exc:
        log.append(str(exc))
    senders = sorted(bytes(a).hex() for a in pool._senders.values())
    return log, convert.txpool_pending(pool), senders, down.known_count()


def test_txpool_backend_recovery_matches_reference():
    """The port's pool recovering through `TorchSigBackend` (the plain
    `ecrecover` on the CPU) against the reference's through its python
    backend: the same admissions, refusals and senders."""
    from gethsharding_tpu.actors.txpool import TxPoolError as RTxPoolError
    from gethsharding_tpu.sigbackend import get_backend
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    port = _txpool_backend_run(TXPool, Transaction, TxPoolError,
                               TorchSigBackend(device="cpu"))
    assert port == _txpool_backend_run(RTXPool, RTransaction, RTxPoolError,
                                       get_backend("python"))
    log, held, senders, down_known = port
    assert log[1] == log[2] == "invalid signature"
    assert log[4] == "signature verification unavailable: backend down"
    assert len(held) == 2 and down_known == 0
    assert bytes(secp256k1.priv_to_address(_KEYS[0])).hex() in senders


def test_create_collation_matches_reference():
    out = []
    for m in (PORT, REF):
        am = m.AccountManager()
        acct = am.new_account(seed=b"collation-proposer")
        client = m.SMCClient(backend=m.SimulatedMainchain(), accounts=am,
                             account=acct)
        txs = [m.Transaction(nonce=i, gas_limit=21000, value=i,
                             payload=b"x" * (7 * i)) for i in range(5)]
        col = (create_collation if m is PORT else r_create)(client, 3, 2,
                                                            txs)
        out.append((bytes(col.header.encode_rlp()),
                    bytes(col.header.proposer_signature), bytes(col.body),
                    bytes(col.header.hash())))
        with pytest.raises(ValueError, match="out of range"):
            (create_collation if m is PORT else r_create)(client, 100, 2,
                                                          txs)
    assert out[0] == out[1]
    header = CollationHeader.decode_rlp(out[0][0])
    assert secp256k1.priv_to_address(
        PORT.AccountManager().new_account(seed=b"collation-proposer")
        .priv) == header.proposer_address


def _syncer_round_trip(m, syncer_cls, shard_cls, kv_cls):
    """Node A holds a collation; node B broadcasts the body request built
    from the SMC record; A's syncer answers over the hub and B's stores
    it. Returns B's store."""
    p2p = importlib_p2p(m)
    cfg = m.Config(shard_count=2, period_length=2)
    chain, hub = m.SimulatedMainchain(cfg), m.Hub()
    am = m.AccountManager()
    clients = [m.SMCClient(backend=chain, accounts=am, config=cfg,
                           account=am.new_account(seed=b"sync-%d" % i))
               for i in range(2)]
    shards = [shard_cls(1, kv_cls()) for _ in range(2)]
    servers = [p2p.P2PServer(hub=hub) for _ in range(2)]
    syncers = [syncer_cls(client=c, shard=s, p2p=p)
               for c, s, p in zip(clients, shards, servers)]
    for svc in servers + syncers:
        svc.start()
    try:
        chain.commit()
        tx = m.Transaction(nonce=1, gas_limit=21000, payload=b"synced")
        col = (create_collation if m is PORT else r_create)(
            clients[0], 1, 1, [tx])
        shards[0].save_collation(col)
        chain.add_header(clients[0].account(), 1, 1, col.header.chunk_root,
                         col.header.proposer_signature)
        req = m.request_collation_body(clients[1], 1, 1)
        assert m.request_collation_body(clients[1], 0, 1) is None
        servers[1].broadcast(req)
        script.wait_for(lambda: syncers[1].bodies_stored == 1,
                        "the synced body")
        assert syncers[0].responses_sent == 1
        assert shards[1].check_availability(col.header) is True
        return sorted(shards[1]._db.items()), req
    finally:
        for svc in syncers + servers:
            svc.stop()


def test_syncer_round_trip_over_the_hub():
    got, preq = _syncer_round_trip(PORT, Syncer, Shard, MemoryKV)
    want, rreq = _syncer_round_trip(REF, RSyncer, RShard, RMemoryKV)
    assert got == want and len(got) == 2
    assert (bytes(preq.chunk_root), preq.shard_id, preq.period,
            bytes(preq.proposer)) == (bytes(rreq.chunk_root), rreq.shard_id,
                                      rreq.period, bytes(rreq.proposer))


def _windback_over_hub(m, notary_cls, syncer_cls, shard_cls, kv_cls,
                       backend):
    """The counterpart of tests/test_actors.py::
    test_windback_blocks_vote_until_prior_body_available, with the prior
    body held by another node and fetched over the hub: refused while no
    node serves it, voted once a holder's syncer does."""
    p2p = importlib_p2p(m)
    cfg = m.Config(quorum_size=1, windback_depth=3)
    chain, hub = m.SimulatedMainchain(cfg), m.Hub()
    am = m.AccountManager()
    client = m.SMCClient(backend=chain, accounts=am, config=cfg,
                         account=am.new_account(seed=b"windback-notary"))
    holder_client = m.SMCClient(backend=chain, accounts=am, config=cfg,
                                account=am.new_account(seed=b"holder"))
    chain.fund(client.account(), 2000 * m.ETHER)
    shard = shard_cls(0, kv_cls())
    holder_shard = shard_cls(0, kv_cls())
    server, holder_server = p2p.P2PServer(hub=hub), p2p.P2PServer(hub=hub)
    notary = notary_cls(client=client, shard=shard, p2p=server, config=cfg,
                        deposit_flag=True, all_shards=False,
                        sig_backend=backend)
    own_syncer = syncer_cls(client=client, shard=shard, p2p=server)
    holder = syncer_cls(client=holder_client, shard=holder_shard,
                        p2p=holder_server)
    for svc in (server, holder_server, own_syncer, notary):
        svc.start()
    try:
        chain.fast_forward(1)
        create = create_collation if m is PORT else r_create
        old = create(client, 0, 1, [m.Transaction(nonce=1, payload=b"old")])
        holder_shard.save_collation(old)
        client.add_header(0, 1, old.header.chunk_root, b"")
        chain.fast_forward(1)
        fresh = create(client, 0, 2, [m.Transaction(nonce=2,
                                                    payload=b"new")])
        shard.save_collation(fresh)
        client.add_header(0, 2, fresh.header.chunk_root, b"")
        record = chain.collation_record(0, 2)
        first = notary.submit_vote(0, 2, record)
        errors = list(notary.errors)
        holder.start()
        second = notary.submit_vote(0, 2, record)
        return (first, second, errors, notary.votes_submitted,
                chain.last_approved_collation(0),
                shard.check_availability(old.header), holder.responses_sent)
    finally:
        for svc in (notary, holder, own_syncer, holder_server, server):
            svc.stop()


def test_windback_vote_fetched_over_the_hub():
    from gethsharding_tpu.sigbackend import get_backend
    from gethsharding_tpu_torch.actors.notary import Notary
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    port = _windback_over_hub(PORT, Notary, Syncer, Shard, MemoryKV,
                              TorchSigBackend(device="cpu"))
    ref = _windback_over_hub(REF, RNotary, RSyncer, RShard, RMemoryKV,
                             get_backend("python"))
    assert port[:6] == ref[:6]
    first, second, errors, votes, approved, held, served = port
    assert (first, second, votes, approved, held) == (False, True, 1, 2,
                                                      True)
    # the heads of period 1 found its body on no node either
    assert errors[-1] == ("windback: collation body unavailable for shard 0 "
                          "period 1; refusing to vote")
    assert set(errors[:-1]) == {"collation body unavailable for shard 0 "
                                "period 1"}
    assert served >= 1


def _journal_recovery(m, notary_cls, backend, kv, journal):
    """A notary started over a journal: the audit mark becomes its
    watermark and a journaled vote is not submitted again."""
    cfg = m.Config(shard_count=2, quorum_size=1, period_length=2)
    chain = m.SimulatedMainchain(cfg)
    am = m.AccountManager()
    client = m.SMCClient(backend=chain, accounts=am, config=cfg,
                         account=am.new_account(seed=b"journal-notary"))
    chain.fund(client.account(), 2000 * m.ETHER)
    while chain.block_number < 8:
        chain.commit()
    journal.record_vote(0, 4)
    journal.set_audit_high_water(3)
    shard_mod = RShard if notary_cls is RNotary else Shard
    notary = notary_cls(client=client, shard=shard_mod(0, kv), config=cfg,
                        deposit_flag=True, sig_backend=backend,
                        journal=journal)
    notary.start()
    try:
        mark = notary._last_audited_period
        chain.add_header(client.account(), 0, 4,
                         m.keccak256(b"journal-root"), b"")
        voted = notary.submit_vote(0, 4, chain.collation_record(0, 4))
        return mark, voted, sorted(journal.votes())
    finally:
        notary.stop()


def test_journal_recovery_on_start_matches_reference():
    from gethsharding_tpu.sigbackend import get_backend
    from gethsharding_tpu_torch.actors.notary import Notary
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    pkv, rkv = MemoryKV(), RMemoryKV()
    port = _journal_recovery(PORT, Notary, TorchSigBackend(device="cpu"),
                             pkv, VoteJournal(pkv))
    ref = _journal_recovery(REF, RNotary, get_backend("python"), rkv,
                            RVoteJournal(rkv))
    assert port == ref == (4, False, [(0, 4)])


def test_supervisor_heals_a_crashed_service_as_fresh_instance():
    node = ShardNode(actor="observer", backend=PORT.SimulatedMainchain(),
                     **PORT_NODE)
    node.start()
    try:
        victim = node.service(Syncer)
        victim.spawn(lambda: (_ for _ in ()).throw(RuntimeError("boom")),
                     name="crash-loop")
        victim._threads[-1].join()
        assert victim.crashed
        assert node.heal() == ["syncer"]
        fresh = node.service(Syncer)
        assert fresh is not victim and fresh.running and not fresh.crashed
        assert node.restarts == {"syncer": 1}
        assert any("crashed" in e for e in fresh.errors)
        # a systemic crash: the restart budget runs out and it stays down
        for _ in range(node.MAX_RESTARTS):
            svc = node.service(Syncer)
            svc._crashed = True
            node.heal()
        last = node.service(Syncer)
        last._crashed = True
        assert node.heal() == []
        assert not last.running
        assert any("giving up" in e for e in last.errors)
    finally:
        node.stop()


# == 3. the observer's engines ================================================

def _observer_collations(m):
    """Two collations: transfers with one bad nonce, then one whose every
    transaction is rejected (a fresh account only touched)."""
    a, b = 0xAAA1, 0xBBB2
    addr = m.secp256k1.priv_to_address
    proposer = addr(0xCCC3)

    def collation(period, rows):
        header = m.CollationHeader(
            shard_id=0, chunk_root=m.keccak256(b"obs-%d" % period),
            period=period, proposer_address=proposer)
        txs = [m.sp.sign_transaction(m.Transaction(
            nonce=n, gas_price=p, gas_limit=25000, to=addr(to), value=v,
            payload=pl), key) for key, n, p, to, v, pl in rows]
        return m.Collation(header=header, transactions=txs)

    genesis = {addr(a): m.sp.AccountState(balance=10**12),
               addr(b): m.sp.AccountState(balance=10**9)}
    return genesis, [
        collation(1, [(a, 0, 3, b, 500, b"one"), (b, 0, 1, a, 9, b""),
                      (b, 7, 1, a, 9, b"")]),
        collation(2, [(b, 42, 1, 0xFFF7, 1, b"")]),
    ]


def _observer_roots(m, cls, engine, **kw) -> dict:
    genesis, cols = _observer_collations(m)
    obs = cls(client=m.SMCClient(backend=m.SimulatedMainchain()),
              shard=(Shard if cls is Observer else RShard)(
                  0, (MemoryKV if cls is Observer else RMemoryKV)()),
              replay_engine=engine, genesis=genesis, **kw)
    out = {}
    for i, col in enumerate(cols, start=1):
        canonical = obs.replay_collation(i, col)
        out[i] = (bytes(obs.state_roots[i]), bytes(canonical))
    assert (obs.txs_replayed, obs.txs_rejected) == (2, 2)
    return out


def test_observer_torch_engine_matches_reference_python_engine():
    port = _observer_roots(PORT, Observer, "torch", device="cpu")
    assert port == _observer_roots(REF, RObserver, "python")
    assert port == _observer_roots(PORT, Observer, "python")
    with pytest.raises(ValueError, match="unknown replay engine"):
        Observer(client=None, shard=None, replay_engine="jax")


@pytest.mark.slow
def test_observer_torch_engine_matches_reference_jax_engine():
    assert _observer_roots(PORT, Observer, "torch", device="cpu") == \
        _observer_roots(REF, RObserver, "jax")


# == 4. the devnet ============================================================

def test_devnet_matches_reference_after_every_period(port_devnet,
                                                     ref_devnet):
    assert port_devnet["layout"] == ref_devnet["layout"]
    port = script.jsonable(port_devnet["summaries"])
    ref = script.jsonable(ref_devnet["summaries"])
    assert sorted(port) == [str(p) for p in range(1, PERIODS + 2)]
    for period in port:
        for key in ref[period]:
            assert port[period][key] == ref[period][key], (period, key)


def test_devnet_answers(port_devnet):
    """What the devnet must show whatever the package: the notary voted,
    fetched the proposers' bodies over the hub for its availability and
    windback checks, audited every period without a mismatch, journaled
    its votes and audits; the observer replayed every period; no node
    recorded an error."""
    layout = port_devnet["layout"]
    summaries = port_devnet["summaries"]
    last = summaries[PERIODS + 1]
    assert last["notary"]["audits_run"] == PERIODS
    assert last["notary"]["audit_mismatches"] == 0
    assert last["notary"]["votes_submitted"] == sum(
        len(layout["eligibility"][p][layout["notary"]])
        for p in range(1, PERIODS + 1))
    assert last["windback_checks"] > 0
    assert last["journal"]["audit_high_water"] == PERIODS
    assert sorted(last["state_roots"]) == list(range(1, PERIODS + 1))
    assert last["observer"]["txs_replayed"] == PERIODS
    for period in range(1, PERIODS + 2):
        assert all(not e for e in summaries[period]["errors"].values()), \
            summaries[period]["errors"]
    # the notary's shard DB holds the bodies of every shard it voted on,
    # none of which it was given: they came over the hub
    nodes = port_devnet["nodes"]
    notary_kv = nodes["notary"].services[0].db
    chain = port_devnet["chain"]
    for p in range(1, PERIODS + 1):
        for s in layout["eligibility"][p][layout["notary"]]:
            rec = chain.collation_record(s, p)
            assert notary_kv.get(bytes(rec.chunk_root)), (s, p)
    # the mirror's snapshot is the chain's own at the last head
    snap = last["mirror"]
    assert snap["block_number"] == chain.block_number
    assert snap["period"] == PERIODS + 1


def test_devnet_canonical_headers_follow_the_smc(port_devnet):
    """The notary writes a canonical header into its shard DB for each
    period it voted its own shard into approval, and that header is the
    SMC's approved record. No other node's service writes one (the
    observer's is the script's copy of the SMC's record, as nothing in
    either package's node writes it)."""
    chain = port_devnet["chain"]
    layout = port_devnet["layout"]
    nodes = port_devnet["nodes"]
    own = layout["notary_shard"]
    mine = layout["eligibility"]
    voted_own = [p for p in range(1, PERIODS + 1)
                 if own in mine[p][layout["notary"]]]
    assert voted_own
    notary = nodes["notary"].service(PORT.Notary)
    assert notary.canonical_set == len(voted_own)
    for period in voted_own:
        rec = chain.collation_record(own, period)
        assert rec.is_elected
        want = CollationHeader(shard_id=own, chunk_root=rec.chunk_root,
                               period=period, proposer_address=rec.proposer,
                               proposer_signature=rec.signature)
        got = nodes["notary"].shard.canonical_header_hash(own, period)
        assert got == want.hash()
    for name, node in nodes.items():
        if name in ("notary", "observer"):
            continue
        for period in range(1, PERIODS + 1):
            with pytest.raises(ShardError):
                node.shard.canonical_header_hash(node.shard.shard_id, period)


def test_devnet_light_node_proves_the_observers_collation(port_devnet,
                                                         ref_devnet):
    """A light node joining each devnet's hub after the last audit: the
    observer's canonical collation proven by length, available at the
    same draws and sampled to its bytes, equal to the reference's."""
    port, ref = port_devnet["finale"], ref_devnet["finale"]
    assert port == ref
    assert port["proven_length"] == port["body_len"] > 0
    assert port["available"] is True and port["samples"] == port["want"]
    assert port["proofs_rejected"] == 0 and port["errors"] == []


def test_jax_free_devnet_run(jax_free_run, port_devnet):
    out, err = jax_free_run.communicate(timeout=900)
    assert jax_free_run.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULTS "))
    got = json.loads(line[len("RESULTS "):])
    assert got["bad"] == []
    assert got["summaries"] == script.jsonable(port_devnet["summaries"])


# == 5. the CLI ===============================================================

# the reference's sharding flags whose features the port has
PORTED_FLAGS = ("actor", "shardid", "deposit", "datadir", "periodlength",
                "windback", "blocktime", "runtime", "txinterval",
                "sigbackend", "supervise", "verbosity", "da_mode",
                "da_proofs", "da_samples", "da_parity", "serving",
                "serving_max_batch", "serving_flush_us",
                "serving_queue_cap", "serving_policy",
                "serving_quota_rows", "serving_watchdog_s", "chaos",
                "soundness_rate", "password", "endpoint", "mesh_devices",
                "fleet_frontend", "http")


def _sharding_actions(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return {a.dest: a for a in sub.choices["sharding"]._actions
            if a.dest != "help"}


def test_cli_flags_and_defaults_match_reference():
    port = _sharding_actions(cli.build_parser())
    ref = _sharding_actions(r_build_parser())
    assert sorted(port) == sorted(PORTED_FLAGS)
    for dest in PORTED_FLAGS:
        assert port[dest].option_strings == ref[dest].option_strings, dest
        if dest != "sigbackend":
            assert port[dest].default == ref[dest].default, dest
            assert port[dest].choices == ref[dest].choices, dest
    assert port["sigbackend"].default == "torch"
    assert sorted(port["sigbackend"].choices) == sorted(
        c.replace("jax", "torch") for c in ref["sigbackend"].choices)
    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "notary", "--shardid", "7", "--deposit",
         "--runtime", "2", "--windback", "1", "--blocktime", "0.2"])
    assert (args.actor, args.shardid, args.deposit, args.runtime,
            args.windback, args.blocktime) == ("notary", 7, True, 2.0, 1,
                                               0.2)


_UNPORTED_FLAGS = sorted(
    set(_sharding_actions(r_build_parser())) - set(PORTED_FLAGS))


@pytest.mark.parametrize("dest", _UNPORTED_FLAGS)
def test_cli_lacks_unported_flag(dest, capsys):
    action = _sharding_actions(r_build_parser())[dest]
    flag = action.option_strings[0]
    value = [] if action.nargs == 0 else [
        str(action.choices[-1]) if action.choices else "1"]
    argv = ["sharding", flag] + value
    r_build_parser().parse_args(argv)          # the reference takes it
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_runs_the_light_actor(caplog):
    """`sharding --actor light`, given no device and run where there may be
    no card: the node starts, seals blocks, and logs its exit line with its
    samples, rejected proofs and no launch."""
    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "light", "--runtime", "0.5",
         "--blocktime", "0.05"])
    with caplog.at_level(logging.INFO, logger="sharding"):
        assert cli.run_sharding_node(args) == 0
    text = caplog.text
    assert "actor=light" in text and "device=None" in text
    assert "service error" not in text
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("node at exit: ")][-1]
    summary = json.loads(line[len("node at exit: "):])
    assert summary["samples_verified"] == summary["proofs_rejected"] == 0
    assert summary["launches"] == {}


def test_cli_node_loop_on_the_cpu(caplog):
    """The CLI's loop (`run_sharding_node`) with the node on the CPU:
    blocks sealed every --blocktime, periods logged, no service error."""
    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "notary", "--deposit", "--runtime", "1.5",
         "--blocktime", "0.02", "--periodlength", "2"])
    with caplog.at_level(logging.INFO, logger="sharding"):
        assert cli.run_sharding_node(args, device="cpu") == 0
    text = caplog.text
    assert "period 1 sealed (block 2)" in text
    assert "Joined notary pool" in text
    assert "service error" not in text


def test_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the node would run")
    out = subprocess.run(
        [sys.executable, "-m", "gethsharding_tpu_torch.cli", "sharding",
         "--actor", "notary", "--deposit", "--runtime", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
