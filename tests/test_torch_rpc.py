"""The port's cross-process topology (`gethsharding_tpu_torch/rpc/`,
`p2p/{direct,discovery,remote}.py`, `devnet.py`, the node's `--endpoint`)
held against the JAX package's, on the CPU:

1. the codec: the same objects encode to the same JSON as the reference's
   `rpc/codec.py`, and decode back to equal values;
2. wire parity: one seeded session of raw JSON-RPC lines (views, SMC
   transactions and reverts, head subscriptions, the p2p relay with its
   authenticated attach, the dev chain controls, malformed requests) sent
   to the reference's `RPCServer` and to the port's, each over its own
   `SimulatedMainchain` of one config, gets identical replies and
   notifications (the challenge nonce and the checkpoint's pickle aside);
3. interop in one process: the port's `RemoteMainchain` reads the
   reference's server as the reference's client does; the port's
   `RemoteHub` and the reference's exchange direct authenticated frames;
   a port notary and proposer run a period over the reference's server;
4. verification over the wire: `shard_verifyCommittees`,
   `shard_ecrecover`, `shard_dasVerify`, `shard_dasPolyVerify` and
   `shard_verifyAggregates` on a server holding
   `TorchSigBackend(device="cpu")`, equal to the reference's
   `get_backend("python")`, hostile rows included, computed on the serving
   tier's dispatch thread; concurrent clients coalesce;
5. the port's counterpart of `tests/test_rpc.py`'s cases: the period
   pipeline with the port's `chain_server` as a child process, the relay's
   handshake and refusals, direct frames, gossip that outlives the relay,
   the bulk mirror and audit reads, the O(1)-per-head notary, the
   bootnode;
6. the entry points: `chain_server` refuses what the port has not ported
   by naming its module and exits non-zero without a card under
   `--sigbackend torch`; the server's trace and profiler handlers refuse
   by module; `sharding --endpoint --password` keeps its account; the
   client's read retries; `devnet --http-base` is refused by module,
   `devnet --lights` spreads light children over the shards and runs one
   as an OS process, and the devnet's respawned notary keeps its account
   (`-m slow`).

Every socket binds port 0; services are waited on through counters and
chain state, never a fixed sleep; every child process has a timeout.
"""

import dataclasses
import importlib
import itertools
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import torch_das_rows
import torch_poly_rows
from test_torch_ecrecover import _hostile_sigs65
from test_torch_serving import _POLY_KEEP, _aggregate_rows, _committee_rows

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, codec=mod("rpc.codec"), server=mod("rpc.server"),
        client=mod("rpc.client"), chain=mod("smc.chain"),
        params=mod("params"), accounts=mod("mainchain.accounts"),
        msgs=mod("p2p.messages"), p2p=mod("p2p.service"),
        remote=mod("p2p.remote"), direct=mod("p2p.direct"),
        discovery=mod("p2p.discovery"), netstore=mod("storage.netstore"),
        sm=mod("smc.state_machine"), hexbytes=mod("utils.hexbytes"),
        bls=mod("crypto.bn256"), node=mod("node.backend"),
        notary=mod("actors.notary"), proposer=mod("actors.proposer"),
        txpool=mod("actors.txpool"), types=mod("core.types"),
        mirror=mod("mainchain.mirror"), client_mod=mod("mainchain.client"),
        bootnode=mod("rpc.bootnode"), sig=mod("sigbackend"),
        serving=mod("serving"), policy=mod("resilience.policy"),
        metrics=mod("metrics"))


PORT = _pkg("gethsharding_tpu_torch")
REF = _pkg("gethsharding_tpu")
BOTH = (PORT, REF)
# the port's nodes run the scalar backend on the host here: a plain
# recovery on the CPU costs ~10 s a call
PORT_NODE = {"sig_backend": "python", "device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _recorder_dir(tmp_path_factory):
    """The flight recorder's bundles under a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR",
                  str(tmp_path_factory.mktemp("recorder")))
        yield


def wait_until(predicate, timeout=30.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return predicate()


def _server(pk, chain, **kw):
    if pk is PORT:
        kw.setdefault("device", "cpu")
    server = pk.server.RPCServer(chain, port=0, **kw)
    server.start()
    return server


def _identity(pk, seed: bytes):
    manager = pk.accounts.AccountManager()
    account = manager.new_account(seed=seed)
    return manager, account.address


# == 1. the codec =============================================================

def _codec_objects(pk):
    """The same values, built from each package's own types."""
    H, A = pk.hexbytes.Hash32, pk.hexbytes.Address20
    sk, pk2 = pk.bls.bls_keygen(b"codec-key")
    sig = pk.bls.bls_sign(b"codec-msg", sk)
    msgs, disc, ns = pk.msgs, pk.discovery, pk.netstore
    announce = disc.PeerAnnounce(peer_id=3, account="ab" * 20,
                                 host="127.0.0.1", port=4567, seq=99,
                                 sig=b"\x05" * 65)
    return {
        "g1": (pk.codec.enc_g1, pk.codec.dec_g1, sig),
        "g1-none": (pk.codec.enc_g1, pk.codec.dec_g1, None),
        "g2": (pk.codec.enc_g2, pk.codec.dec_g2, pk2),
        "registry": (pk.codec.enc_registry, pk.codec.dec_registry,
                     pk.sm.Notary(deregistered_period=2, pool_index=7,
                                  balance=10**21, deposited=True,
                                  bls_pubkey=pk2, bls_pop=sig)),
        "record": (pk.codec.enc_record, pk.codec.dec_record,
                   pk.sm.CollationRecord(
                       chunk_root=H(b"\x01" * 32), proposer=A(b"\x02" * 20),
                       is_elected=True, signature=b"\x03" * 65,
                       vote_sigs={4: pk.sm.VoteSig(sig=sig,
                                                   signer=A(b"\x06" * 20))},
                       vote_count=1)),
        "block": (pk.codec.enc_block, pk.codec.dec_block,
                  pk.chain.Block(number=5, hash=H(b"\x07" * 32),
                                 parent_hash=H(b"\x08" * 32),
                                 extra=b"\x09" * 8)),
        "g1-rows": (pk.codec.enc_g1_rows, pk.codec.dec_g1_rows,
                    [[sig, None], []]),
        "g2-rows": (pk.codec.enc_g2_rows, pk.codec.dec_g2_rows, [[pk2]]),
        "das-call": (lambda v: pk.codec.enc_das_call(*v),
                     lambda v: pk.codec.dec_das_call(*v),
                     ([b"\x0a" * 5], [3], [[b"\x0b" * 32, b"\x0c" * 32]],
                      [b"\x0d" * 32])),
        "das-poly-call": (lambda v: pk.codec.enc_das_poly_call(*v),
                          lambda v: pk.codec.dec_das_poly_call(*v),
                          ([b"\x0e" * 64], [[1, 2]], [[5, 2**200]],
                           [b"\x0f" * 64], [255])),
        "pk-row-keys": (pk.codec.enc_pk_row_keys, None,
                        [(1, 2, 3), None, "k"]),
        "p2p-body-request": msgs.CollationBodyRequest(
            chunk_root=H(b"\x11" * 32), shard_id=1, period=2,
            proposer=A(b"\x12" * 20), signature=b"\x13"),
        "p2p-body-request-none": msgs.CollationBodyRequest(
            chunk_root=None, shard_id=1, period=2, proposer=None),
        "p2p-body-response": msgs.CollationBodyResponse(
            header_hash=H(b"\x14" * 32), body=b"body"),
        "p2p-chunk-proof-request": msgs.ChunkProofRequest(
            chunk_root=H(b"\x15" * 32), shard_id=0, period=1, index=9),
        "p2p-chunk-proof-response": msgs.ChunkProofResponse(
            chunk_root=H(b"\x16" * 32), index=9, proof=(b"a", b"bc"),
            body_len=12),
        "p2p-das-commitment-request": msgs.DASCommitmentRequest(
            shard_id=3, period=4),
        "p2p-das-commitment-response": msgs.DASCommitmentResponse(
            shard_id=3, period=4, chunk_root=H(b"\x17" * 32),
            das_root=b"\x18" * 32, k=11, n=17, body_len=44416,
            poly_commitment=b"\x19" * 64, signature=b"\x1a" * 65),
        "p2p-das-sample-request": msgs.DASampleRequest(
            das_root=b"\x1b" * 32, indices=(1, 5)),
        "p2p-das-sample-response": msgs.DASampleResponse(
            das_root=b"\x1c" * 32, index=5, chunk=b"\x1d" * 7,
            proof=(b"\x1e" * 32,)),
        "p2p-das-multiproof-request": msgs.DASMultiproofRequest(
            das_root=b"\x1f" * 32, indices=(0, 2)),
        "p2p-das-multiproof-response": msgs.DASMultiproofResponse(
            das_root=b"\x20" * 32, indices=(0, 2), chunks=(b"x", b"y"),
            proof=b"\x21" * 64),
        "p2p-peer-table-request": disc.PeerTableRequest(),
        "p2p-peer-table-response": disc.PeerTableResponse(
            announces=(announce,)),
        "p2p-chunk-request": ns.ChunkRequest(key=b"\x22" * 32),
        "p2p-chunk-delivery": ns.ChunkDelivery(key=b"\x23" * 32, span=3,
                                               payload=b"abc"),
    }


_CODEC_KINDS = sorted(_codec_objects(REF))


def _fields(value):
    """A comparable plain form of either package's decoded value."""
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                {f.name: _fields(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    if isinstance(value, dict):
        return {k: _fields(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_fields(v) for v in value]
    if isinstance(value, bytes):
        return bytes(value)
    if hasattr(value, "a") and hasattr(value, "b"):        # Fp2
        return ("Fp2", value.a, value.b)
    return value


@pytest.mark.parametrize("kind", _CODEC_KINDS)
def test_codec_matches_reference(kind):
    port, ref = (_codec_objects(pk)[kind] for pk in BOTH)
    if kind.startswith("p2p-"):
        wires = [pk.codec.enc_p2p(obj) for pk, obj in ((PORT, port),
                                                       (REF, ref))]
        assert json.dumps(wires[0]) == json.dumps(wires[1])
        kind_tag, payload = wires[0]
        assert _fields(PORT.codec.dec_p2p(kind_tag, payload)) == \
            _fields(REF.codec.dec_p2p(kind_tag, payload)) == _fields(port)
        return
    (enc_p, dec_p, value_p), (enc_r, dec_r, value_r) = port, ref
    wire = json.dumps(enc_p(value_p))
    assert wire == json.dumps(enc_r(value_r))
    if dec_p is not None:
        assert _fields(dec_p(json.loads(wire))) == \
            _fields(dec_r(json.loads(wire)))


def test_codec_refuses_like_reference():
    with pytest.raises(TypeError, match="no p2p wire codec"):
        PORT.codec.enc_p2p(object())
    with pytest.raises(ValueError, match="unknown p2p message type"):
        PORT.codec.dec_p2p("Nope", {})
    # the whisper envelope's module is not ported: named in the refusal
    with pytest.raises(ValueError, match="p2p/whisper.py"):
        PORT.codec.dec_p2p("WhisperEnvelope", {})
    receipt = SimpleNamespace(tx_hash=b"\x01" * 32, status=1, block_number=4)
    assert PORT.codec.enc_receipt(receipt) == REF.codec.enc_receipt(receipt)
    assert PORT.codec.TRACE_PLANE_METHODS == REF.codec.TRACE_PLANE_METHODS


# == 2. wire parity ===========================================================

class Wire:
    """A raw JSON-RPC connection: numbered requests, replies by id, and
    the notifications that arrive in between, in order."""

    def __init__(self, address):
        self.sock = socket.create_connection(address, timeout=120)
        self.rfile = self.sock.makefile("rb")
        self.wfile = self.sock.makefile("wb")
        self.ids = itertools.count(1)
        self.notes = []

    def _send(self, line: bytes) -> None:
        self.wfile.write(line + b"\n")
        self.wfile.flush()

    def _until(self, rid):
        while True:
            msg = json.loads(self.rfile.readline())
            if "method" in msg:
                self.notes.append(msg)
                continue
            if msg.get("id") == rid:
                return {k: msg[k] for k in ("result", "error") if k in msg}

    def call(self, method, *params):
        rid = next(self.ids)
        self._send(json.dumps({"jsonrpc": "2.0", "id": rid,
                               "method": method,
                               "params": list(params)}).encode())
        return self._until(rid)

    def raw(self, line: bytes):
        self._send(line)
        return self._until(None)

    def note(self):
        """The next notification (read from the socket if none is
        buffered)."""
        while not self.notes:
            msg = json.loads(self.rfile.readline())
            if "method" in msg:
                self.notes.append(msg)
        return self.notes.pop(0)

    def close(self):
        self.sock.close()


def _wire_session(pk):
    """The seeded session against `pk`'s server over its own chain.
    Returns the replies and notifications in order."""
    config = pk.params.Config(shard_count=4, quorum_size=1,
                              period_length=5, network_id=21)
    chain = pk.chain.SimulatedMainchain(config=config)
    server = _server(pk, chain)
    enc = REF.codec            # the wire's values (the codecs agree, §1)
    mgr = pk.accounts.AccountManager()
    a = mgr.new_account(seed=b"wire-a")
    b = mgr.new_account(seed=b"wire-b")
    ha, hb = enc.enc_bytes(bytes(a.address)), enc.enc_bytes(bytes(b.address))
    c1, c2 = Wire(server.address), Wire(server.address)
    out = []
    log = lambda label, reply: out.append((label, reply))
    try:
        for method, params in (
                ("shard_networkId", ()), ("shard_blockNumber", ()),
                ("shard_currentPeriod", ()), ("shard_shardCount", ()),
                ("shard_chainConfig", ()), ("shard_health", ()),
                ("shard_servingStats", ()), ("shard_daStatus", (0, 1)),
                ("shard_getSample", (0, 1, [0]))):
            log(method, c1.call(method, *params))
        log("subscribe", c2.call("shard_subscribe", "newHeads"))
        for h in (ha, hb):
            log("fund", c1.call("shard_fund", h, 2000 * 10**18))
        pop = mgr.bls_proof_of_possession(a.address)
        log("register a", c1.call("shard_registerNotary", ha,
                                  enc.enc_g2(a.bls_pubkey), enc.enc_g1(pop)))
        log("register a again", c1.call(
            "shard_registerNotary", ha, enc.enc_g2(a.bls_pubkey),
            enc.enc_g1(pop)))
        log("fast forward", c1.call("shard_fastForward", 1))
        log("heads", [c2.note() for _ in range(config.period_length)])
        period = c1.call("shard_currentPeriod")["result"]
        root = pk.hexbytes.Hash32(b"\x42" * 32)
        header = c1.call("shard_addHeader", ha, 1, period,
                         enc.enc_bytes(root), enc.enc_bytes(b""))
        log("add header", header)
        log("add header again", c1.call(
            "shard_addHeader", ha, 1, period, enc.enc_bytes(root), "0x"))
        committee = c1.call("shard_getNotaryInCommittee", ha, 1)
        log("committee member", committee)
        vote_sig = mgr.bls_sign(a.address, bytes(
            pk.sm.vote_digest(1, period, root)))
        log("vote", c1.call("shard_submitVote", ha, 1, period, 0,
                            enc.enc_bytes(root), enc.enc_g1(vote_sig)))
        log("vote again", c1.call("shard_submitVote", ha, 1, period, 0,
                                  enc.enc_bytes(root), enc.enc_g1(vote_sig)))
        tx = header["result"]["txHash"]
        for method, params in (
                ("shard_collationRecord", (1, period)),
                ("shard_collationRecord", (2, period)),
                ("shard_lastSubmittedCollation", (1,)),
                ("shard_lastApprovedCollation", (1,)),
                ("shard_hasVoted", (1, 0)), ("shard_getVoteCount", (1,)),
                ("shard_committeeContext", ()),
                ("shard_notaryRegistry", (ha,)),
                ("shard_notaryRegistry", (hb,)),
                ("shard_notaryByPoolIndex", (0,)),
                ("shard_notaryByPoolIndex", (5,)),
                ("shard_balanceOf", (ha,)),
                ("shard_transactionReceipt", (tx,)),
                ("shard_transactionReceipt", ("0x" + "00" * 32,)),
                ("shard_traceTransaction", (tx,)),
                ("shard_auditData", (period,)),
                ("shard_mirrorSnapshot", ()), ("shard_stateSeq", ()),
                ("shard_blockRange", (0, 3)),
                ("shard_blockRange", (0, 99999)),
                ("shard_blockByNumber", (None,)),
                ("shard_blockByNumber", (2,))):
            log(method, c1.call(method, *params))
        while c1.call("shard_currentPeriod")["result"] == period:
            c1.call("shard_commit")
        log("heads to the next period",
            len([c2.note() for _ in range(config.period_length)]))
        log("vote log replay", c1.call("shard_verifyPeriodBatch", period))
        log("vote log replay, open period", c1.call(
            "shard_verifyPeriodBatch", period + 1))
        log("register b", c1.call("shard_registerNotary", hb, None, None))
        log("deregister", c1.call("shard_deregisterNotary", ha))
        log("release early", c1.call("shard_releaseNotary", ha))
        log("set head", c1.call("shard_setHead", 3))
        checkpoint = c1.call("shard_stateCheckpoint")["result"]
        log("checkpoint", {k: v for k, v in checkpoint.items()
                           if k != "state"})
        # the p2p relay: authenticated attaches, peers, relayed frames
        kind, payload = REF.codec.enc_p2p(REF.msgs.CollationBodyRequest(
            chunk_root=None, shard_id=1, period=2, proposer=None))
        log("unsigned attach", c1.call("shard_p2pAttach", {
            "protocol": "shardp2p", "version": 1, "network_id": 21,
            "account": ha}))
        log("wrong network", c1.call("shard_p2pAttach", {
            "protocol": "shardp2p", "version": 1, "network_id": 22}))
        log("no challenge", c1.call("shard_p2pAttach", {
            "network_id": 21, "account": ha, "sig": "00" * 65}))
        for conn, acct in ((c1, a), (c2, b)):
            nonce = conn.call("shard_p2pChallenge")["result"]
            sig = mgr.sign_hash(acct.address, pk.direct.attach_digest(
                21, bytes.fromhex(nonce)))
            log("attach", conn.call("shard_p2pAttach", {
                "protocol": "shardp2p", "version": 1, "network_id": 21,
                "account": bytes(acct.address).hex(), "sig": sig.hex(),
                "endpoint": ["127.0.0.1", 1]}))
        log("peers", c1.call("shard_p2pPeers"))
        log("peer info", c1.call("shard_p2pPeerInfo", 2))
        log("send", c1.call("shard_p2pSend", 1, 2, kind, payload))
        log("sent frame", c2.note())
        log("broadcast", c2.call("shard_p2pBroadcast", 2, kind, payload))
        log("broadcast frame", c1.note())
        log("stats", c1.call("shard_p2pStats"))
        log("detach", c1.call("shard_p2pDetach", 1))
        log("peers after", c1.call("shard_p2pPeers"))
        log("unknown", c1.call("shard_noSuchMethod"))
        log("bad json", c1.raw(b"{not json"))
        log("method stats", c1.call("shard_methodStats"))
        log("late notes", (c1.notes, c2.notes))
    finally:
        c1.close()
        c2.close()
        server.stop()
    return out


def test_wire_session_replies_equal_reference():
    port, ref = (_wire_session(pk) for pk in BOTH)
    assert [label for label, _ in port] == [label for label, _ in ref]
    for (label, got), (_, want) in zip(port, ref):
        assert got == want, label
    replies = dict(port)
    # the session is not vacuous: a vote landed, reverts came as code 3,
    # the relay carried both frames, the vote log replayed
    assert replies["vote"]["result"]["status"] == 1
    assert replies["register a again"]["error"]["code"] == 3
    assert replies["vote log replay"] == {"result": True}
    assert replies["send"] == {"result": True}
    assert replies["broadcast"] == {"result": 1}
    assert replies["stats"]["result"]["relayed_sends"] == 1
    assert replies["unknown"]["error"]["code"] == -32601
    assert replies["bad json"]["error"]["code"] == -32600
    assert replies["shard_auditData"]["result"]["shards"]["1"]["votes"]


# == 3. interop with the reference's server ===================================

@pytest.fixture
def ref_server():
    config = REF.params.Config(shard_count=4, quorum_size=1, network_id=31)
    chain = REF.chain.SimulatedMainchain(config=config)
    server = REF.server.RPCServer(chain, port=0)
    server.start()
    yield chain, server
    server.stop()


def test_port_client_reads_reference_server_like_reference_client(
        ref_server):
    chain, server = ref_server
    mgr = REF.accounts.AccountManager()
    acct = mgr.new_account(seed=b"interop")
    chain.fund(acct.address, 2000 * REF.params.ETHER)
    chain.register_notary(acct.address, bls_pubkey=acct.bls_pubkey,
                          bls_pop=mgr.bls_proof_of_possession(acct.address))
    chain.fast_forward(1)
    period = chain.current_period()
    root = REF.hexbytes.Hash32(b"\x33" * 32)
    chain.add_header(acct.address, 2, period, root)
    chain.submit_vote(acct.address, 2, period, 0, root, bls_sig=mgr.bls_sign(
        acct.address, bytes(REF.sm.vote_digest(2, period, root))))
    chain.commit()
    port = PORT.client.RemoteMainchain.dial(*server.address)
    ref = REF.client.RemoteMainchain.dial(*server.address)
    try:
        addr = PORT.hexbytes.Address20(bytes(acct.address))
        reads = lambda c, a: {
            "block": c.block_number, "period": c.current_period(),
            "head": c.block_by_number(None), "registry": c.notary_registry(a),
            "record": c.collation_record(2, period),
            "context": c.committee_context(),
            "member": c.get_notary_in_committee(a, 2),
            "submitted": c.last_submitted_collation(2),
            "approved": c.last_approved_collation(2),
            "pool0": c.notary_by_pool_index(0), "voted": c.has_voted(2, 0),
            "votes": c.get_vote_count(2), "shards": c.shard_count(),
            "balance": c.balance_of(a), "network": c.network_id(),
            "audit": c.audit_data(period), "mirror": c.mirror_snapshot(),
            "config": dataclasses.asdict(c.chain_config()),
            "replay": c.verify_period_batch(period)}
        got, want = reads(port, addr), reads(ref, acct.address)
        assert _fields(got) == _fields(want)
        assert got["record"].vote_count == 1 and got["audit"]["shards"]
        assert type(got["record"]).__module__.startswith(
            "gethsharding_tpu_torch.")
        heads = []
        port.subscribe_new_head(lambda block: heads.append(block.number))
        chain.commit()
        assert wait_until(lambda: heads == [chain.block_number])
        with pytest.raises(PORT.sm.SMCRevert, match="already deposited"):
            port.register_notary(addr, bls_pubkey=None, bls_pop=None)
    finally:
        port.close()
        ref.close()


def test_port_and_reference_hubs_exchange_direct_frames(ref_server):
    """A port `RemoteHub` and a reference `RemoteHub` on the reference's
    relay: authenticated attach, mutual direct handshakes (AEAD frames
    where both ends have the `cryptography` package, as here), a directed
    request each way and a broadcast, none relayed."""
    _, server = ref_server
    host, port = server.address
    hubs, servers = [], []
    try:
        for pk, seed in ((PORT, b"mixed-port"), (REF, b"mixed-ref")):
            mgr, addr = _identity(pk, seed)
            hub = pk.remote.RemoteHub.dial(host, port, accounts=mgr,
                                           account=addr)
            srv = pk.p2p.P2PServer(hub=hub)
            srv.start()
            hubs.append(hub)
            servers.append(srv)
        p_srv, r_srv = servers
        sub_r = r_srv.subscribe(REF.msgs.CollationBodyRequest)
        sub_p = p_srv.subscribe(PORT.msgs.CollationBodyRequest)
        req = PORT.msgs.CollationBodyRequest(
            chunk_root=PORT.hexbytes.Hash32(b"\x44" * 32), shard_id=1,
            period=3, proposer=None)
        assert p_srv.send(req, r_srv.self_peer) is True
        got = sub_r.get(timeout=10.0)
        assert type(got.data).__module__ == "gethsharding_tpu.p2p.messages"
        assert _fields(got.data) == _fields(req)
        assert got.peer.peer_id == p_srv.self_peer.peer_id
        assert r_srv.send(got.data, got.peer) is True
        back = sub_p.get(timeout=10.0)
        assert _fields(back.data) == _fields(req)
        assert p_srv.broadcast(req) == 1
        assert _fields(sub_r.get(timeout=10.0).data) == _fields(req)
        assert server.p2p_relayed_sends == 0
        conn = next(iter(hubs[0]._dialer._conns.values()))
        assert conn[3] is not None                      # AEAD frames
    finally:
        for srv in servers:
            srv.stop()


def _run_period(ctl, proposer_node, notary_node, shard_id, config):
    """Fast-forward a period, feed the proposer one transaction, and commit
    until the notary's vote elects the collation. Returns the period."""
    notary = notary_node.service(notary_node_mod(notary_node).Notary)
    assert wait_until(notary.is_account_in_notary_pool)
    ctl.fast_forward(1)
    period = ctl.current_period()
    pk = notary_node_mod(proposer_node)
    proposer_node.service(pk.TXPool).submit(
        pk.Transaction(nonce=1, payload=b"cross-process tx"))
    errors = lambda: notary_node.errors() + proposer_node.errors()
    assert wait_until(
        lambda: proposer_node.service(pk.Proposer).collations_proposed >= 1
    ), errors()
    assert wait_until(
        lambda: ctl.last_submitted_collation(shard_id) == period), errors()
    approved = False
    for _ in range(config.period_length - 1):
        ctl.commit()
        if wait_until(lambda: ctl.last_approved_collation(shard_id) == period,
                      timeout=10.0):
            approved = True
            break
    assert approved, errors()
    return period


def notary_node_mod(node):
    root = type(node).__module__.split(".")[0]
    return SimpleNamespace(
        Notary=importlib.import_module(f"{root}.actors.notary").Notary,
        Proposer=importlib.import_module(f"{root}.actors.proposer").Proposer,
        TXPool=importlib.import_module(f"{root}.actors.txpool").TXPool,
        Transaction=importlib.import_module(f"{root}.core.types").Transaction)


def _pipeline(host, port, config, shard_id=2):
    """A port proposer and notary `ShardNode`, each over its own
    `RemoteMainchain` and `RemoteHub`, run one period on the chain at
    (host, port). Returns the chain's record and relay stats."""
    ctl = PORT.client.RemoteMainchain.dial(host, port)
    nodes = []
    try:
        proposer = PORT.node.ShardNode(
            actor="proposer", shard_id=shard_id, config=config,
            backend=PORT.client.RemoteMainchain.dial(host, port),
            hub=PORT.remote.RemoteHub.dial(host, port),
            txpool_interval=None, **PORT_NODE)
        nodes.append(proposer)
        notary = PORT.node.ShardNode(
            actor="notary", shard_id=shard_id, config=config,
            backend=PORT.client.RemoteMainchain.dial(host, port),
            hub=PORT.remote.RemoteHub.dial(host, port), deposit=True,
            **PORT_NODE)
        nodes.append(notary)
        ctl.fund(notary.client.account(), 2000 * PORT.params.ETHER)
        proposer.start()
        notary.start()
        period = _run_period(ctl, proposer, notary, shard_id, config)
        record = ctl.collation_record(shard_id, period)
        service = notary.service(PORT.notary.Notary)
        assert wait_until(lambda: service.canonical_set >= 1)
        return record, ctl.rpc.call("shard_p2pStats"), notary.errors()
    finally:
        for node in reversed(nodes):
            node.stop()
        ctl.close()


def test_port_nodes_run_a_period_over_reference_server(ref_server):
    chain, server = ref_server
    record, stats, errors = _pipeline(*server.address, chain.config)
    assert record.is_elected is True and record.vote_sigs
    assert stats["relayed_sends"] == 0 and errors == []


# == 4. verification over the wire ============================================

OPS = {"bls_verify_committees": "shard_verifyCommittees",
       "ecrecover_addresses": "shard_ecrecover",
       "das_verify_samples": "shard_dasVerify",
       "das_verify_multiproofs": "shard_dasPolyVerify",
       "bls_verify_aggregates": "shard_verifyAggregates"}


def _wire_args(op, cols, keys):
    enc = PORT.codec
    if op == "bls_verify_committees":
        msgs, sig_rows, pk_rows = cols
        return ([enc.enc_bytes(m) for m in msgs], enc.enc_g1_rows(sig_rows),
                enc.enc_g2_rows(pk_rows), enc.enc_pk_row_keys(keys))
    if op == "ecrecover_addresses":
        return ([enc.enc_bytes(d) for d in cols[0]],
                [enc.enc_bytes(s) for s in cols[1]])
    if op == "das_verify_samples":
        return enc.enc_das_call(*cols)
    if op == "das_verify_multiproofs":
        return enc.enc_das_poly_call(*cols)
    msgs, sigs, pks = cols
    return ([enc.enc_bytes(m) for m in msgs], [enc.enc_g1(s) for s in sigs],
            [enc.enc_g2(p) for p in pks])


@pytest.fixture(scope="module")
def small_srs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_DAS_SRS_SIZE", torch_poly_rows.SMALL_SRS_SIZE)
        yield


@pytest.fixture(scope="module")
def verify_rows(small_srs):
    names, poly, _ = torch_poly_rows.hostile_rows()
    poly = [row for name, row in zip(names, poly) if name in _POLY_KEEP]
    digests, sigs, _ = _hostile_sigs65()
    msgs, sig_rows, pk_rows, keys = _committee_rows()
    rows = {"ecrecover_addresses": (digests, sigs),
            "bls_verify_aggregates": _aggregate_rows(),
            "bls_verify_committees": (msgs, sig_rows, pk_rows),
            "das_verify_samples": torch_das_rows.mixed_rows(12),
            "das_verify_multiproofs": tuple(torch_poly_rows.columns(poly))}
    ref = REF.sig.get_backend("python")
    want = {op: getattr(ref, op)(*cols) for op, cols in rows.items()}
    return rows, keys, want


class ThreadNoting:
    """`TorchSigBackend(device="cpu")` noting the thread of each call."""

    def __init__(self):
        from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

        self.inner = TorchSigBackend(device="cpu")
        self.threads = []
        self.name = self.inner.name

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if name not in OPS and name != "bls_verify_committees_async":
            return fn

        def call(*args, **kw):
            self.threads.append(threading.current_thread().name)
            return fn(*args, **kw)
        return call


@pytest.fixture(scope="module")
def wire_server():
    backend = ThreadNoting()
    serving = PORT.serving.ServingSigBackend(backend)
    server = _server(PORT, PORT.chain.SimulatedMainchain(),
                     sig_backend=serving)
    client = PORT.client.RPCClient(*server.address, timeout=600)
    yield backend, serving, server, client
    client.close()
    server.stop()
    serving.close()


@pytest.mark.parametrize("op", sorted(OPS))
def test_verification_over_the_wire_equals_reference(op, verify_rows,
                                                     wire_server):
    rows, keys, want = verify_rows
    backend, serving, server, client = wire_server
    before = serving.batcher.dispatch_counts[op]
    got = client.call(OPS[op], *_wire_args(op, rows[op], keys))
    if op == "ecrecover_addresses":
        want_wire = [None if a is None else PORT.codec.enc_bytes(bytes(a))
                     for a in want[op]]
        assert got == want_wire
    else:
        assert got == [bool(v) for v in want[op]]
    assert any(got) and not all(got)          # hostile rows included
    assert serving.batcher.dispatch_counts[op] == before + 1
    # the handler thread submitted; the tier's dispatch thread computed
    assert backend.threads and set(backend.threads) == {"serving-dispatch"}
    stats = client.call("shard_servingStats")
    assert stats["dispatches"][op] == before + 1
    assert client.call("shard_health")["serving"]["depth"][op] == {
        "interactive": 0, "bulk_audit": 0, "catchup_replay": 0}


def test_concurrent_clients_coalesce_over_the_wire(verify_rows):
    """8 clients, each on its own connection, split the committee rows:
    each gets the reference's verdicts for its rows, in fewer dispatches
    than requests (the tier's flush window held long)."""
    rows, keys, want = verify_rows
    serving = PORT.serving.ServingSigBackend(
        PORT.sig.PythonSigBackend(),
        PORT.serving.ServingConfig(flush_us=2_000_000))
    server = _server(PORT, PORT.chain.SimulatedMainchain(),
                     sig_backend=serving)
    msgs, sig_rows, pk_rows = rows["bls_verify_committees"]
    n = len(msgs)
    cuts = list(range(0, n, 2)) + [n]
    parts = list(zip(cuts, cuts[1:]))
    results = [None] * len(parts)
    barrier = threading.Barrier(len(parts))

    def run(i):
        a, b = parts[i]
        client = PORT.client.RPCClient(*server.address, timeout=300)
        try:
            barrier.wait()
            results[i] = client.call(
                "shard_verifyCommittees", *_wire_args(
                    "bls_verify_committees",
                    (msgs[a:b], sig_rows[a:b], pk_rows[a:b]), keys[a:b]),
                "bulk_audit", "tenant-%d" % i)
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(parts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert [r for r in results] == [
            [bool(v) for v in want["bls_verify_committees"][a:b]]
            for a, b in parts]
        dispatches = serving.batcher.dispatch_counts["bls_verify_committees"]
        assert 1 <= dispatches < len(parts)
        assert server.method_calls["shard_verifyCommittees"] == len(parts)
    finally:
        server.stop()
        serving.close()


def test_draining_server_refuses_verification():
    server = _server(PORT, PORT.chain.SimulatedMainchain(),
                     sig_backend=PORT.sig.PythonSigBackend())
    client = PORT.client.RPCClient(*server.address)
    try:
        assert client.call("shard_drain")["draining"] is True
        with pytest.raises(PORT.client.RPCError,
                           match="replica draining: shard_ecrecover"):
            client.call("shard_ecrecover", [], [])
        assert client.call("shard_health")["draining"] is True
    finally:
        client.close()
        server.stop()


# == 5. the reference's rpc cases on the port =================================

@pytest.fixture()
def rpc_pair():
    backend = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(quorum_size=1))
    server = _server(PORT, backend)
    remote = PORT.client.RemoteMainchain.dial(*server.address)
    yield backend, remote, server
    remote.close()
    server.stop()


def test_views_transactions_and_revert(rpc_pair):
    backend, remote, _ = rpc_pair
    assert remote.block_number == 0
    assert remote.shard_count() == backend.smc.shard_count
    backend.commit()
    assert bytes(remote.block_by_number(1).hash) == \
        bytes(backend.blocks[1].hash)
    assert remote.collation_record(0, 1) is None
    addr = PORT.hexbytes.Address20(b"\x11" * 20)
    remote.fund(addr, 2000 * PORT.params.ETHER)
    assert remote.balance_of(addr) == 2000 * PORT.params.ETHER
    receipt = remote.register_notary(addr)
    assert receipt.status == 1
    entry = remote.notary_registry(addr)
    assert entry.deposited and entry.pool_index == 0
    with pytest.raises(PORT.sm.SMCRevert, match="already deposited"):
        remote.register_notary(addr)
    assert remote.transaction_receipt(receipt.tx_hash).status == 1
    trace = remote.trace_transaction(receipt.tx_hash)
    assert trace["trace"] and trace["status"] == 1


def test_head_subscription_pushes(rpc_pair):
    backend, remote, _ = rpc_pair
    seen = []
    remote.subscribe_new_head(lambda b: seen.append(b.number))
    backend.commit()
    backend.commit()
    assert wait_until(lambda: len(seen) >= 2)
    assert seen[:2] == [1, 2]


def test_full_period_pipeline_cross_process():
    """The period pipeline with the chain in its own OS process (the
    port's `chain_server`, `--sigbackend python`): the proposer and the
    notary live here, and every SMC transaction, head and shardp2p frame
    crosses the wire; the directed body exchange flows peer to peer."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "gethsharding_tpu_torch.rpc.chain_server",
         "--periodlength", "5", "--quorum", "1", "--runtime", "120",
         "--sigbackend", "python"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        endpoint = json.loads(proc.stdout.readline())
        record, stats, errors = _pipeline(
            endpoint["host"], endpoint["port"],
            PORT.params.Config(quorum_size=1))
        assert record.is_elected is True
        assert record.vote_sigs            # the BLS-signed vote crossed
        assert stats["relayed_sends"] == 0, stats
        assert errors == []
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    summary = json.loads(err.split("chain-server at exit: ")[1])
    assert summary["methods"]["shard_submitVote"] >= 1
    assert summary["launches"] == {}          # the scalar backend


def test_p2p_handshake_and_peer_table():
    backend = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(network_id=77))
    server = _server(PORT, backend)
    try:
        host, port = server.address
        manager, address = _identity(PORT, b"peer-table")
        hub = PORT.remote.RemoteHub.dial(host, port, network_id=77,
                                         accounts=manager, account=address)
        p2p = PORT.p2p.P2PServer(hub=hub)
        p2p.start()
        chain = PORT.client.RemoteMainchain.dial(host, port)
        assert chain.network_id() == 77
        peers = chain.p2p_peers()
        assert [p["account"] for p in peers] == [bytes(address).hex()]
        assert peers[0]["version"] == 1 and peers[0]["endpoint"]
        mgr2, addr2 = _identity(PORT, b"wrong-net")
        bad_hub = PORT.remote.RemoteHub.dial(host, port, network_id=78,
                                             accounts=mgr2, account=addr2)
        with pytest.raises(Exception, match="network mismatch"):
            PORT.p2p.P2PServer(hub=bad_hub).start()
        bad_hub.close()
        worse = PORT.remote.RemoteHub.dial(host, port)
        with pytest.raises(Exception, match="version mismatch"):
            worse.rpc.call("shard_p2pAttach", {"protocol": "shardp2p",
                                               "version": 99})
        worse.close()
        p2p.stop()
        assert chain.p2p_peers() == []
        chain.close()
    finally:
        server.stop()


def test_unsigned_and_forged_attaches_refused():
    backend = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(network_id=5))
    server = _server(PORT, backend)
    try:
        host, port = server.address
        manager, address = _identity(PORT, b"honest")
        thief_mgr, thief_addr = _identity(PORT, b"thief")
        anon = PORT.remote.RemoteHub.dial(host, port)
        with pytest.raises(RuntimeError, match="identity required"):
            PORT.p2p.P2PServer(hub=anon).start()
        anon.close()
        bare = PORT.remote.RemoteHub.dial(host, port)
        with pytest.raises(Exception, match="unsigned attach"):
            bare.rpc.call("shard_p2pAttach", {
                "protocol": "shardp2p", "version": 1, "network_id": 5,
                "account": bytes(address).hex()})
        challenge = bytes.fromhex(bare.rpc.call("shard_p2pChallenge"))
        sig = thief_mgr.sign_hash(thief_addr,
                                  PORT.direct.attach_digest(5, challenge))
        with pytest.raises(Exception, match="does not prove"):
            bare.rpc.call("shard_p2pAttach", {
                "protocol": "shardp2p", "version": 1, "network_id": 5,
                "account": bytes(address).hex(), "sig": sig.hex()})
        sig = manager.sign_hash(address,
                                PORT.direct.attach_digest(5, challenge))
        with pytest.raises(Exception, match="no pending challenge"):
            bare.rpc.call("shard_p2pAttach", {
                "protocol": "shardp2p", "version": 1, "network_id": 5,
                "account": bytes(address).hex(), "sig": sig.hex()})
        bare.close()
        hub = PORT.remote.RemoteHub.dial(host, port, accounts=manager,
                                         account=address)
        p2p = PORT.p2p.P2PServer(hub=hub)
        p2p.start()
        p2p.stop()
    finally:
        server.stop()


def test_directed_messages_flow_peer_to_peer():
    backend = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(network_id=9))
    server = _server(PORT, backend)
    try:
        host, port = server.address
        mgr_a, addr_a = _identity(PORT, b"alice")
        mgr_b, addr_b = _identity(PORT, b"bob")
        hub_a = PORT.remote.RemoteHub.dial(host, port, accounts=mgr_a,
                                           account=addr_a)
        hub_b = PORT.remote.RemoteHub.dial(host, port, accounts=mgr_b,
                                           account=addr_b)
        a, b = PORT.p2p.P2PServer(hub=hub_a), PORT.p2p.P2PServer(hub=hub_b)
        a.start()
        b.start()
        try:
            sub = b.subscribe(PORT.msgs.CollationBodyRequest)
            req = PORT.msgs.CollationBodyRequest(
                shard_id=1, period=2,
                chunk_root=PORT.hexbytes.Hash32(b"\x11" * 32),
                proposer=addr_a)
            assert a.send(req, b.self_peer) is True
            msg = sub.get(timeout=10.0)
            assert msg.data == req and msg.peer == a.self_peer
            assert server.p2p_relayed_sends == 0
            conn = next(iter(hub_a._dialer._conns.values()))
            assert conn[3] is not None            # AEAD frames
            sub_a = a.subscribe(PORT.msgs.CollationBodyRequest)
            assert b.send(req, msg.peer) is True
            assert sub_a.get(timeout=10.0).peer == b.self_peer
            assert server.p2p_relayed_sends == 0
            # a forged direct connection: the signature cannot prove the
            # account the relay holds for peer A
            thief_mgr, thief_addr = _identity(PORT, b"mallory")
            with socket.create_connection(tuple(
                    hub_b.peer_info(b.self_peer.peer_id)["endpoint"]),
                    timeout=10.0) as sock:
                rfile, wfile = sock.makefile("rb"), sock.makefile("wb")
                challenge = bytes.fromhex(
                    json.loads(rfile.readline())["challenge"])
                sig = thief_mgr.sign_hash(
                    thief_addr, PORT.direct.direct_digest(9, challenge))
                wfile.write((json.dumps({
                    "peer_id": a.self_peer.peer_id,
                    "account": bytes(addr_a).hex(),
                    "challenge2": bytes(32).hex(),
                    "sig": sig.hex()}) + "\n").encode())
                wfile.flush()
                reply = json.loads(rfile.readline())
            assert "error" in reply and "prove" in reply["error"]
        finally:
            a.stop()
            b.stop()
    finally:
        server.stop()


def test_plaintext_frames_where_a_side_lacks_aead(monkeypatch):
    """The AEAD gate: where one end has no `cryptography` (the card's
    machine), the direct frames fall back to plaintext after the same
    mutual authentication, and still flow peer to peer."""
    monkeypatch.setattr(PORT.direct, "AESGCM", None)
    backend = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(network_id=13))
    server = _server(PORT, backend)
    try:
        host, port = server.address
        servers = []
        for seed in (b"plain-a", b"plain-b"):
            mgr, addr = _identity(PORT, seed)
            srv = PORT.p2p.P2PServer(hub=PORT.remote.RemoteHub.dial(
                host, port, accounts=mgr, account=addr))
            srv.start()
            servers.append(srv)
        a, b = servers
        sub = b.subscribe(PORT.msgs.CollationBodyRequest)
        req = PORT.msgs.CollationBodyRequest(shard_id=0, period=1,
                                             chunk_root=None, proposer=None)
        assert a.send(req, b.self_peer) is True
        assert sub.get(timeout=10.0).data == req
        conn = next(iter(a.hub._dialer._conns.values()))
        assert conn[3] is None and server.p2p_relayed_sends == 0
        for srv in servers:
            srv.stop()
    finally:
        server.stop()


def test_gossip_introduction_survives_relay_death():
    backend = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(network_id=11))
    server = _server(PORT, backend)
    host, port = server.address
    hubs, servers = [], []
    try:
        for seed in (b"ga", b"gb", b"gc"):
            mgr, addr = _identity(PORT, seed)
            hub = PORT.remote.RemoteHub.dial(host, port, accounts=mgr,
                                             account=addr)
            srv = PORT.p2p.P2PServer(hub=hub)
            srv.start()
            hubs.append(hub)
            servers.append(srv)
        a, b, c = servers
        deadline = time.time() + 30.0
        while time.time() < deadline:
            for hub in hubs:
                hub.gossip_once()
            if all(len(hub.directory.gossip_set()) == 3 for hub in hubs):
                break
            time.sleep(0.05)
        assert all(len(hub.directory.gossip_set()) == 3 for hub in hubs)
        sub_b = b.subscribe(PORT.msgs.CollationBodyRequest)
        sub_c = c.subscribe(PORT.msgs.CollationBodyRequest)
        req = PORT.msgs.CollationBodyRequest(
            shard_id=3, period=1, chunk_root=PORT.hexbytes.Hash32(b"\x22" * 32),
            proposer=None)
        bcasts = server.method_calls.get("shard_p2pBroadcast", 0)
        sends = server.p2p_relayed_sends
        assert a.broadcast(req) == 2
        assert sub_b.get(timeout=10.0).data == req
        assert sub_c.get(timeout=10.0).data == req
        assert server.method_calls.get("shard_p2pBroadcast", 0) == bcasts
        assert server.p2p_relayed_sends == sends
        server.stop()
        req2 = dataclasses.replace(req, shard_id=4, period=2)
        assert a.broadcast(req2) == 2
        assert sub_b.get(timeout=10.0).data == req2
        assert sub_c.get(timeout=10.0).data == req2
        sub_a = a.subscribe(PORT.msgs.CollationBodyRequest)
        assert b.send(req2, a.self_peer) is True
        assert sub_a.get(timeout=10.0).peer == b.self_peer
    finally:
        for srv in servers:
            srv.stop()
        server.stop()


def test_announces_verify_and_merge_like_reference():
    """The signed announces: the same digest in both packages, a
    reference-signed announce verified by the port's directory, a forged
    one refused, one per account (the fresher wins)."""
    mgr, addr = _identity(REF, b"announce")
    digest_args = (7, 3, bytes(addr).hex(), "127.0.0.1", 4000, 10)
    assert PORT.discovery.announce_digest(*digest_args) == \
        REF.discovery.announce_digest(*digest_args)
    ref_dir = REF.discovery.PeerDirectory(7)
    ann = ref_dir.make_self(3, bytes(addr).hex(), ("127.0.0.1", 4000),
                            lambda d: mgr.sign_hash(addr, d))
    port_ann = PORT.discovery.PeerAnnounce(**dataclasses.asdict(ann))
    port_dir = PORT.discovery.PeerDirectory(7)
    forged = dataclasses.replace(port_ann, port=4001)
    assert port_dir.merge([forged]) == 0
    assert port_dir.merge([port_ann]) == 1
    newer = PORT.discovery.PeerAnnounce(**dataclasses.asdict(
        ref_dir.make_self(4, bytes(addr).hex(), ("127.0.0.1", 4002),
                          lambda d: mgr.sign_hash(addr, d))))
    if newer.seq > port_ann.seq:
        assert port_dir.merge([newer]) == 1
        assert [a.peer_id for a in port_dir.gossip_set()] == [4]
    assert port_dir.lookup(99) is None


def test_mirror_snapshot_and_audit_data_in_bulk():
    """A remote actor's state mirror pulls one bulk snapshot a head, and
    the notary's audit one bulk `shard_auditData` a period, decoded from
    the hex wire form."""
    from gethsharding_tpu_torch.crypto.keccak import keccak256

    config = PORT.params.Config(shard_count=5, quorum_size=1)
    backend = PORT.chain.SimulatedMainchain(config=config)
    manager = PORT.accounts.AccountManager()
    acct = manager.new_account(seed=b"mirror-rpc")
    backend.fund(acct.address, 2000 * PORT.params.ETHER)
    server = _server(PORT, backend)
    try:
        remote = PORT.client.RemoteMainchain.dial(*server.address)
        client = PORT.client_mod.SMCClient(backend=remote, accounts=manager,
                                           account=acct, config=config)
        mirror = PORT.mirror.StateMirror(client=client)
        mirror.start()
        try:
            backend.fast_forward(1)
            period = backend.current_period()
            root = PORT.hexbytes.Hash32(keccak256(b"rpc-mirror"))
            backend.add_header(acct.address, 4, period, root)
            backend.commit()
            assert wait_until(lambda: mirror.period() == period
                              and mirror.record(4) is not None)
            assert mirror.record(4)["chunk_root"] == bytes(root).hex()
            assert mirror.snapshot()["last_submitted"][4] == period
        finally:
            mirror.stop()
        local = PORT.client_mod.SMCClient(backend=backend, config=config)
        assert remote.audit_data(period) == \
            PORT.mirror.assemble_audit_data(backend, period)
        assert local.audit_data(period)["raw"] is True
        remote.close()
    finally:
        server.stop()


def test_remote_notary_hot_loop_is_o1_per_head():
    config = PORT.params.Config(shard_count=32, quorum_size=1)
    backend = PORT.chain.SimulatedMainchain(config=config)
    server = _server(PORT, backend)
    node = None
    try:
        remote = PORT.client.RemoteMainchain.dial(*server.address)
        node = PORT.node.ShardNode(actor="notary", backend=remote,
                                   config=config, deposit=False,
                                   txpool_interval=None, **PORT_NODE)
        backend.fund(node.client.account(), 2000 * PORT.params.ETHER)
        node.client.register_notary()
        node.start()
        mirror = node.service(PORT.mirror.StateMirror)
        assert mirror is node.service(PORT.notary.Notary).mirror
        baseline = dict(server.method_calls)
        heads = 3 * config.period_length
        for _ in range(heads):
            backend.commit()
        assert wait_until(lambda: (mirror.snapshot() or {}).get(
            "block_number", 0) >= backend.block_number)
        calls = {m: n - baseline.get(m, 0)
                 for m, n in server.method_calls.items()}
        for method in ("shard_collationRecord",
                       "shard_lastSubmittedCollation",
                       "shard_committeeContext",
                       "shard_getNotaryInCommittee"):
            assert calls.get(method, 0) == 0, calls
        assert calls.get("shard_mirrorSnapshot", 0) <= 2 * heads + 2, calls
        assert sum(calls.values()) / heads < 8, calls
    finally:
        if node is not None:
            node.stop()
        server.stop()


def test_bootnode_introduction_without_a_chain():
    server = PORT.bootnode.make_bootnode(network_id=12)
    server.start()
    try:
        host, port = server.address
        mgr_a, addr_a = _identity(PORT, b"boot-a")
        mgr_b, addr_b = _identity(PORT, b"boot-b")
        hub_a = PORT.remote.RemoteHub.dial(host, port, accounts=mgr_a,
                                           account=addr_a)
        hub_b = PORT.remote.RemoteHub.dial(host, port, accounts=mgr_b,
                                           account=addr_b)
        a, b = PORT.p2p.P2PServer(hub=hub_a), PORT.p2p.P2PServer(hub=hub_b)
        a.start()
        b.start()
        try:
            assert hub_a.rpc.call("shard_networkId") == 12
            sub = b.subscribe(PORT.msgs.CollationBodyRequest)
            req = PORT.msgs.CollationBodyRequest(
                shard_id=0, period=1,
                chunk_root=PORT.hexbytes.Hash32(b"\x22" * 32),
                proposer=addr_a)
            assert a.send(req, b.self_peer) is True
            assert sub.get(timeout=10.0).data == req
            assert server.p2p_relayed_sends == 0
            with pytest.raises(Exception, match="chain process"):
                hub_a.rpc.call("shard_blockNumber")
        finally:
            a.stop()
            b.stop()
    finally:
        server.stop()


# == 6. the entry points ======================================================

@pytest.mark.parametrize("argv,module", [
    pytest.param(["--trace-out", "t.json"], "tracing/export.py",
                 id="argv1-tracing/export.py"),
    pytest.param(["--fleettrace-export", "127.0.0.1:1"], "fleettrace/",
                 id="argv2-fleettrace/"),
])
def test_chain_server_refuses_unported_options_by_module(argv, module,
                                                         capsys):
    from gethsharding_tpu_torch.rpc import chain_server

    assert chain_server.main(argv) == 2
    assert f"no {module} yet" in capsys.readouterr().err


def test_chain_server_flags_match_reference():
    from gethsharding_tpu.rpc import chain_server as ref_cs
    from gethsharding_tpu_torch.rpc import chain_server as port_cs

    import argparse

    real = argparse.ArgumentParser.parse_args
    seen = {}

    def grab(parser, args=None, namespace=None):
        seen[parser.prog] = parser
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            ref_cs.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    ref_actions = {a.dest: a for a in seen["chain-server"]._actions}
    port_actions = {a.dest: a for a in port_cs.build_parser()._actions}
    assert sorted(port_actions) == sorted(ref_actions)
    for dest, action in port_actions.items():
        assert action.option_strings == ref_actions[dest].option_strings
        if dest != "sigbackend":
            assert action.default == ref_actions[dest].default, dest
    assert port_actions["sigbackend"].choices == (
        "python", "torch", "failover-python", "failover-torch")


def test_chain_server_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the chain would serve")
    out = subprocess.run(
        [sys.executable, "-m", "gethsharding_tpu_torch.rpc.chain_server",
         "--sigbackend", "torch", "--runtime", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("entry", ["chain_server", "devnet", "sharding",
                                   "RPCServer"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """With no backend flag, every entry point of the cross-process
    topology runs the port's kernels on the card: its `--sigbackend`
    defaults to `torch`, and on a host with no card it exits 2 (the
    server: its verification RPCs raise) and never serves from the plain
    versions."""
    from gethsharding_tpu_torch.node import cli
    from gethsharding_tpu_torch.rpc import chain_server

    card = torch.cuda.is_available()
    if entry == "RPCServer":
        server = PORT.server.RPCServer(PORT.chain.SimulatedMainchain(),
                                       port=0)
        server.start()
        try:
            if card:
                backend = server._serving().inner
                assert backend.device.type == "cuda"
            else:
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    server.rpc_ecrecover([], [])
        finally:
            server.stop()
        return
    if entry == "chain_server":
        assert chain_server.build_parser().parse_args([]).sigbackend == \
            "torch"
        argv = [sys.executable, "-m",
                "gethsharding_tpu_torch.rpc.chain_server", "--runtime", "1"]
    else:
        assert cli.build_parser().parse_args([entry]).sigbackend == "torch"
        argv = [sys.executable, "-m", "gethsharding_tpu_torch.cli", entry,
                "--runtime", "1"]
        argv += (["--datadir", str(tmp_path)] if entry == "devnet" else
                 ["--actor", "notary"])
    if card:
        return          # the card's own run is `chip_smoke.py` step 18
    out = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and '"host"' not in out.stdout
    log = (tmp_path / "logs" / "chain.log").read_text() \
        if entry == "devnet" else out.stderr
    assert "no CUDA device" in log


@pytest.mark.parametrize("method,module", [
    ("shard_traceHandshake", "tracing/export.py"),
    ("shard_traceExport", "fleettrace/"),
    ("shard_traceAttribution", "fleettrace/"),
    ("shard_traceExemplars", "fleettrace/"),
    ("shard_profileStart", "devscope/"),
    ("shard_profileStop", "devscope/"),
    ("shard_profileStacks", "devscope/"),
    ("shard_devscopeStatus", "devscope/"),
])
def test_unported_handlers_refuse_by_module(method, module, rpc_pair):
    _, remote, _ = rpc_pair
    params = [{}] if method == "shard_traceExport" else []
    with pytest.raises(PORT.client.RPCError,
                       match=f"{method}: the port has no {module}"):
        remote.rpc.call(method, *params)


def test_endpoint_node_keeps_its_account_across_restarts(tmp_path,
                                                         monkeypatch,
                                                         caplog):
    """`sharding --endpoint HOST:PORT --datadir D --password P` twice
    against one chain process: the node adopts the chain's config, joins
    the pool once, and comes back with the same account, which its
    `node at exit` line names beside its votes and missed votes."""
    import logging

    from gethsharding_tpu_torch.mainchain import keystore
    from gethsharding_tpu_torch.node import cli

    monkeypatch.setattr(keystore.Keystore.__init__, "__kwdefaults__",
                        {"scrypt_n": keystore.LIGHT_SCRYPT_N, "scrypt_p": 1})
    password = tmp_path / "password.txt"
    password.write_text("devnet\n")
    chain = PORT.chain.SimulatedMainchain(
        config=PORT.params.Config(quorum_size=1, period_length=3))
    server = _server(PORT, chain)
    host, port = server.address
    try:
        argv = ["sharding", "--actor", "notary", "--deposit", "--endpoint",
                f"{host}:{port}", "--datadir", str(tmp_path / "node"),
                "--password", str(password), "--sigbackend", "python",
                "--runtime", "1", "--blocktime", "0.05"]
        stored = tmp_path / "node" / "keystore"
        caplog.set_level(logging.INFO)
        for _ in range(2):
            assert cli.run_cli(argv) == 0
            (key_file,) = list(stored.iterdir())
        exits = [json.loads(r.getMessage().split("node at exit: ", 1)[1])
                 for r in caplog.records
                 if r.getMessage().startswith("node at exit: ")]
        assert len(exits) == 2
        assert {e["account"] for e in exits} == {
            "0x" + json.loads(key_file.read_text())["address"]}
        assert all(isinstance(e["votes"], int) and e["votes_missed"] == 0
                   for e in exits)
        address = PORT.hexbytes.Address20(bytes.fromhex(
            json.loads(key_file.read_text())["address"]))
        entry = chain.notary_registry(address)
        assert entry is not None and entry.deposited
        assert chain.notary_by_pool_index(1) is None     # one deposit
        assert cli.run_cli(["sharding", "--endpoint", "nohostport"]) == 2
    finally:
        server.stop()


def test_client_read_retries_like_reference():
    """The retry policy's remote-seam parts: the jitter scales each rung
    of the reference's backoff ladder into [0.5, 1] of itself;
    the client's reads ride a flaky chain's connection errors; a
    non-retryable error and a write are not retried; stop() ends a
    ladder mid-backoff."""
    policy = PORT.policy.RetryPolicy(attempts=6, base_s=0.01, cap_s=0.1)
    for k in range(6):
        rung = min(0.1, 0.01 * 2 ** k)
        assert 0.5 * rung <= policy.backoff_s(k) <= rung

    class Flaky:
        def __init__(self, fails, exc=ConnectionError):
            self.fails, self.exc, self.calls = fails, exc, 0
            self.inner = PORT.chain.SimulatedMainchain()

        def current_period(self):
            self.calls += 1
            if self.calls <= self.fails:
                raise self.exc("chain process unreachable")
            return self.inner.current_period()

        def register_notary(self, *args, **kw):
            self.calls += 1
            raise ConnectionError("mid-write")

    registry = PORT.metrics.DEFAULT_REGISTRY
    retries = registry.counter("resilience/retry/mainchain/retries")
    before = retries.value
    policy = lambda: PORT.policy.RetryPolicy(attempts=4, base_s=0.0)
    flaky = Flaky(2)
    client = PORT.client_mod.SMCClient(backend=flaky, retry_policy=policy())
    assert client.current_period() == 0 and flaky.calls == 3
    assert retries.value - before == 2
    missing = Flaky(5, FileNotFoundError)
    client = PORT.client_mod.SMCClient(backend=missing,
                                       retry_policy=policy())
    with pytest.raises(FileNotFoundError):
        client.current_period()
    assert missing.calls == 1
    with pytest.raises(ConnectionError, match="mid-write"):
        client.register_notary()
    assert missing.calls == 2
    slow = PORT.client_mod.SMCClient(
        backend=Flaky(100), retry_policy=PORT.policy.RetryPolicy(
            attempts=50, base_s=5.0, cap_s=5.0))
    threading.Timer(0.2, slow.stop).start()
    t0 = time.monotonic()
    with pytest.raises(PORT.client_mod.ClientStopped):
        slow.current_period()
    assert time.monotonic() - t0 < 4.0


def test_devnet_stops_readers_then_proposers_then_chain(tmp_path):
    """`Devnet.stop` stops its children in waves, each waited on before
    the next starts: the notaries and observers (they fetch bodies), the
    proposers (they serve them), then the chain."""
    from gethsharding_tpu_torch.devnet import Child, Devnet

    events = []

    class Proc:
        def __init__(self, name):
            self.name, self.done = name, False

        def poll(self):
            return 0 if self.done else None

        def terminate(self):
            events.append(("term", self.name))

        def wait(self, timeout=None):
            self.done = True
            events.append(("wait", self.name))

    net = Devnet(base_dir=str(tmp_path), sigbackend="python")
    child = lambda name: Child(name=name, argv=[], proc=Proc(name))
    net.actors = {n: child(n) for n in ("proposer-0", "notary-0",
                                        "observer-0", "proposer-1")}
    net.chain = child("chain")
    net.stop()
    waves = [{"notary-0", "observer-0"}, {"proposer-0", "proposer-1"},
             {"chain"}]
    at = 0
    for wave in waves:
        got = events[at:at + 2 * len(wave)]
        assert [kind for kind, _ in got] == \
            ["term"] * len(wave) + ["wait"] * len(wave)
        assert {name for _, name in got} == wave
        at += 2 * len(wave)
    assert at == len(events)


def test_devnet_refuses_status_ports_by_module(capsys):
    from gethsharding_tpu_torch.node import cli

    assert cli.run_cli(["devnet", "--http-base", "9000",
                        "--runtime", "1"]) == 2
    assert "no node/http_status.py yet" in capsys.readouterr().err


def test_devnet_spreads_light_children_over_the_shards(tmp_path):
    """`--lights N`: light children round-robin over the shards (as the
    proposers and observers), without `--deposit`."""
    from gethsharding_tpu_torch.devnet import Devnet

    net = Devnet(notaries=1, proposers=1, lights=3, base_dir=str(tmp_path),
                 shard_count=2)
    net.endpoint = ("127.0.0.1", 1)
    assert net.counts["light"] == 3
    for i in range(3):
        argv = net._actor_argv("light", i, 0)
        at = argv.index("--actor")
        assert argv[at + 1] == "light" and "--deposit" not in argv
        assert argv[argv.index("--shardid") + 1] == str(i % 2)
        assert argv[argv.index("--datadir") + 1] == str(tmp_path /
                                                        f"light-{i}")


def test_devnet_runs_a_light_child(tmp_path):
    """A devnet of OS processes with a light child (`--sigbackend python`,
    no notary): the light node starts on the chain process's endpoint,
    logs no error, and its exit line counts no launch."""
    proc = subprocess.run(
        [sys.executable, "-m", "gethsharding_tpu_torch.cli", "devnet",
         "--notaries", "0", "--proposers", "1", "--lights", "1",
         "--shardcount", "2", "--sigbackend", "python", "--blocktime",
         "0.2", "--interval", "1", "--runtime", "25", "--datadir",
         str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '"light-0": "running"' in proc.stdout
    log = (tmp_path / "logs" / "light-0.log").read_text()
    assert "actor=light" in log
    assert "service error" not in log and "Traceback" not in log
    line = [l for l in log.splitlines() if "node at exit: " in l][-1]
    summary = json.loads(line.split("node at exit: ", 1)[1])
    assert summary["launches"] == {}
    assert summary["samples_verified"] == summary["proofs_rejected"] == 0


@pytest.mark.slow
def test_devnet_respawned_notary_keeps_its_account(tmp_path):
    """A devnet of OS processes (`--sigbackend python`): the notary joins
    the pool and votes; SIGKILLed, it is respawned with the same account
    from its keystore, makes no second deposit, and votes again."""
    from gethsharding_tpu_torch.devnet import Devnet

    net = Devnet(notaries=1, proposers=1, base_dir=str(tmp_path),
                 blocktime=0.2, quorum=1, shard_count=1,
                 sigbackend="python")
    try:
        host, port = net.start()
        chain = PORT.client.RemoteMainchain.dial(host, port)
        try:
            assert wait_until(lambda: chain.notary_by_pool_index(0)
                              is not None, timeout=120)
            account = chain.notary_by_pool_index(0)
            assert wait_until(lambda: chain.last_approved_collation(0) > 0,
                              timeout=120)
            approved = chain.last_approved_collation(0)
            victim = net.actors["notary-0"]
            victim.proc.kill()
            victim.proc.wait(timeout=10)
            assert "restarted" in net.poll()["actors"]["notary-0"]
            assert wait_until(lambda: chain.last_approved_collation(0)
                              > approved, timeout=120)
            assert chain.notary_by_pool_index(0) == account
            assert chain.notary_by_pool_index(1) is None
        finally:
            chain.close()
    finally:
        net.stop()
    for child in list(net.actors.values()) + [net.chain]:
        assert child.proc.poll() is not None
    assert (tmp_path / "notary-0" / "keystore").is_dir()
