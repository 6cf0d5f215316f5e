"""The port's light client (`gethsharding_tpu_torch.actors.light`, the
syncer's chunk-proof handler, the `light` actor of `ShardNode`) held against
the JAX package's, on the CPU, on the same seeded inputs:

1. the reference's `tests/test_light.py` cases on the port: chunk proofs
   round trip and absence, sampling and the proven length, forged proofs
   rejected, the empty body, the end-to-end `ShardNode` pair, the proof
   cap;
2. against the reference's `LightClient`: the same sampled indices and
   verdicts for the same seed, the same proven lengths and samples, and
   `das_check` (merkle and poly, honest and withheld) giving the
   reference's verdicts on the same draws;
3. the node and the wire: a light `ShardNode` composes the reference's
   services and starts without a device (it launches nothing), a
   `ChunkProofResponse` survives the wire codec and still verifies, and a
   light node over `RemoteMainchain` and `RemoteHub` samples a body a
   syncer serves through a chain process.

Threaded services are waited on through their own counters or a bounded
sampling timeout, never a fixed sleep.
"""

import importlib
import threading
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

BODY = bytes(range(256)) * 3 + b"tail-of-the-collation"
SHARD, PERIOD = 2, 1


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, light=mod("actors.light"), syncer=mod("actors.syncer"),
        ds=mod("core.derive_sha"), shard=mod("core.shard"),
        types=mod("core.types"), kv=mod("db.kv"),
        client=mod("mainchain.client"), msgs=mod("p2p.messages"),
        p2p=mod("p2p.service"), params=mod("params"), chain=mod("smc.chain"),
        hexbytes=mod("utils.hexbytes"), das=mod("das.service"),
        node=mod("node.backend"), codec=mod("rpc.codec"))


PORT = _pkg("gethsharding_tpu_torch")
REF = _pkg("gethsharding_tpu")
BOTH = (PORT, REF)


def _launches() -> int:
    from gethsharding_tpu_torch.ops import _build

    return sum(_build.launch_counts().values())


def _setup(pk, body=BODY, shard=SHARD):
    """One full node's syncer holding a canonical body and one light client
    on a shared in-process hub, both anchored on the same chain (the
    reference's `_light_setup`)."""
    config = pk.params.Config(shard_count=4, quorum_size=1)
    chain = pk.chain.SimulatedMainchain(config=config)
    hub = pk.p2p.Hub()
    full_client = pk.client.SMCClient(backend=chain, config=config)
    chain.fund(full_client.account(), 2000 * pk.params.ETHER)
    store = pk.shard.Shard(shard_id=shard, shard_db=pk.kv.MemoryKV())
    collation = pk.types.Collation(
        header=pk.types.CollationHeader(shard_id=shard, period=PERIOD),
        body=body)
    root = pk.hexbytes.Hash32(collation.calculate_chunk_root())
    store.save_collation(collation)
    syncer = pk.syncer.Syncer(client=full_client, shard=store,
                              p2p=pk.p2p.P2PServer(hub=hub),
                              poll_interval=0.01)
    chain.fast_forward(1)
    chain.add_header(full_client.account(), shard, PERIOD, root)
    light = pk.light.LightClient(
        client=pk.client.SMCClient(backend=chain, config=config),
        p2p=pk.p2p.P2PServer(hub=hub))
    return SimpleNamespace(chain=chain, hub=hub, syncer=syncer, light=light,
                           root=root, config=config)


class _Running:
    """Start the setup's services (and a watch on the proof requests the
    light client broadcasts); stop them on exit."""

    def __init__(self, s, pk, syncer=True):
        self.s, self.pk = s, pk
        self.services = ([s.syncer] if syncer else []) + [s.light]

    def __enter__(self):
        self.watch = self.pk.p2p.P2PServer(hub=self.s.hub)
        self.watch.start()
        self.requests = self.watch.subscribe(self.pk.msgs.ChunkProofRequest)
        for service in self.services:
            service.p2p.start()
            service.start()
        return self

    def requested(self) -> list:
        out = []
        while (msg := self.requests.try_get()) is not None:
            out.append(msg.data.index)
        return out

    def __exit__(self, *exc):
        for service in reversed(self.services):
            service.stop()
            service.p2p.stop()
        self.watch.stop()


# == 1. the reference's cases on the port =====================================

def test_chunk_proof_round_trip_and_absence():
    ds = PORT.ds
    root = ds.chunk_root(BODY)
    for index in (0, 1, 127, len(BODY) - 1):
        assert ds.verify_chunk(root, index, ds.chunk_proof(BODY, index)) \
            == BODY[index]
    assert ds.verify_chunk(root, len(BODY),
                           ds.chunk_proof(BODY, len(BODY))) is None
    proof = ds.chunk_proof(BODY, 5)
    with pytest.raises(ValueError):
        ds.verify_chunk(root, 5, [b"\x00" + proof[0][1:]] + proof[1:])


def test_light_client_samples_and_proves_length():
    s = _setup(PORT)
    before = _launches()
    with _Running(s, PORT):
        light = s.light
        assert bytes(light.canonical_chunk_root(SHARD, PERIOD)) \
            == bytes(s.root)
        got = light.sample(SHARD, PERIOD, [0, 7, 100, len(BODY) - 1])
        assert got == {0: BODY[0], 7: BODY[7], 100: BODY[100],
                       len(BODY) - 1: BODY[-1]}
        assert light.samples_verified >= 4
        assert s.syncer.proofs_served >= 4
        assert light.proven_length(SHARD, PERIOD) == len(BODY)
        assert light.availability_check(SHARD, PERIOD, k=8) is True
        assert light.proofs_rejected == 0
        assert light.m_sample_latency.count >= 3
    assert _launches() == before


class _Liar:
    """A bare peer answering every chunk-proof request with a proof over a
    body the SMC never anchored."""

    FAKE = b"forged body that the SMC never anchored"

    def __init__(self, pk, hub):
        self.pk = pk
        self.p2p = pk.p2p.P2PServer(hub=hub)
        self.p2p.start()
        self.sub = self.p2p.subscribe(pk.msgs.ChunkProofRequest)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._answer, daemon=True)
        self.thread.start()

    def _answer(self):
        while not self.stop.is_set():
            msg = self.sub.try_get()
            if msg is None:
                self.stop.wait(0.005)
                continue
            req = msg.data
            self.p2p.send(self.pk.msgs.ChunkProofResponse(
                chunk_root=req.chunk_root, index=req.index,
                proof=tuple(self.pk.ds.chunk_proof(self.FAKE, req.index)),
                body_len=len(self.FAKE)), msg.peer)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        self.p2p.stop()


@pytest.mark.parametrize("pk", BOTH, ids=["port", "ref"])
def test_light_client_rejects_forged_proofs(pk):
    """A lying peer cannot make the light client accept wrong bytes: its
    proofs fail against the anchored root, in both packages alike."""
    s = _setup(pk)
    liar = _Liar(pk, s.hub)
    try:
        with _Running(s, pk, syncer=False):
            assert s.light.sample(SHARD, PERIOD, [3], timeout=2.0) == {}
            assert s.light.proofs_rejected >= 1
            assert s.light.availability_check(SHARD, PERIOD, k=4,
                                              timeout=1.0) is False
            assert any("invalid proof" in e for e in s.light.errors)
    finally:
        liar.close()
        assert not liar.thread.is_alive()


def test_light_client_empty_body_is_trivially_available():
    pk = PORT
    config = pk.params.Config(shard_count=4, quorum_size=1)
    chain = pk.chain.SimulatedMainchain(config=config)
    client = pk.client.SMCClient(backend=chain, config=config)
    chain.fund(client.account(), 2000 * pk.params.ETHER)
    chain.fast_forward(1)
    chain.add_header(client.account(), 1, 1,
                     pk.hexbytes.Hash32(pk.ds.chunk_root(b"")))
    light = pk.light.LightClient(client=client,
                                 p2p=pk.p2p.P2PServer(hub=pk.p2p.Hub()))
    light.start()
    try:
        assert light.proven_length(1, 1) == 0
        assert light.availability_check(1, 1) is True
        assert light.proven_length(1, 2) is None       # no record
        assert light.availability_check(1, 2) is False
        with pytest.raises(ValueError, match="no canonical collation"):
            light.sample(1, 2, [0])
    finally:
        light.stop()


def test_light_node_end_to_end_over_node_containers():
    """`actor="light"` as a `ShardNode`: a full observer node (its syncer
    owns the body) and a light node on one hub; the light node, given no
    device, proves the canonical collation available without holding any
    shard data, and launches nothing."""
    pk = PORT
    config = pk.params.Config(shard_count=4, quorum_size=1)
    chain = pk.chain.SimulatedMainchain(config=config)
    hub = pk.p2p.Hub()
    full = pk.node.ShardNode(actor="observer", shard_id=SHARD,
                             config=config, backend=chain, hub=hub,
                             sig_backend="python", device="cpu",
                             simulator_interval=3600.0)
    light_node = pk.node.ShardNode(actor="light", shard_id=SHARD,
                                   config=config, backend=chain, hub=hub)
    full.start()
    light_node.start()
    before = _launches()
    try:
        body = b"node-level light client drive " * 9
        collation = pk.types.Collation(
            header=pk.types.CollationHeader(shard_id=SHARD, period=PERIOD),
            body=body)
        root = pk.hexbytes.Hash32(collation.calculate_chunk_root())
        full.shard.save_collation(collation)
        chain.fast_forward(1)
        chain.add_header(full.client.account(), SHARD, PERIOD, root)
        light = light_node.service(pk.light.LightClient)
        assert light.proven_length(SHARD, PERIOD) == len(body)
        assert light.availability_check(SHARD, PERIOD, k=6) is True
        assert light.sample(SHARD, PERIOD, [11]) == {11: body[11]}
        assert light_node.errors() == [] and full.errors() == []
    finally:
        light_node.stop()
        full.stop()
    assert _launches() == before
    assert light_node.device is None and light_node.slots is None


@pytest.mark.parametrize("pk", BOTH, ids=["port", "ref"])
def test_proof_serving_capped_for_untrusted_large_bodies(pk):
    """Proofs are refused above `Syncer.PROOF_BODY_CAP` (the whole-body
    path still serves such collations), and a negative index is ignored."""
    s = _setup(pk)
    assert pk.syncer.Syncer.PROOF_BODY_CAP == 1 << 16
    with _Running(s, pk):
        s.syncer.PROOF_BODY_CAP = len(BODY) - 1
        assert s.light.sample(SHARD, PERIOD, [0], timeout=0.5) == {}
        s.syncer.PROOF_BODY_CAP = len(BODY)
        assert s.light.sample(SHARD, PERIOD, [-1], timeout=0.5) == {}
        assert s.syncer.proofs_served == 0
        assert s.light.sample(SHARD, PERIOD, [0], timeout=5.0) == {0: 0}
        assert s.syncer.proofs_served == 1
        assert s.syncer.errors == []


# == 2. against the reference's LightClient ===================================

@pytest.mark.parametrize("seed", [b"\x00" * 32, b"light-seed-1", b"\xff"],
                         ids=["zeros", "text", "one-byte"])
def test_availability_draws_and_verdicts_match_the_reference(seed):
    """The same seed draws the same indices (the keccak chain over the
    anchored root), in the same order on the wire, and gives the same
    verdicts, proven lengths and samples."""
    body = bytes((7 * i + 3) % 256 for i in range(1500))
    got = {}
    for pk in BOTH:
        s = _setup(pk, body=body)
        with _Running(s, pk) as run:
            length = s.light.proven_length(SHARD, PERIOD)
            ok = s.light.availability_check(SHARD, PERIOD, k=16, seed=seed)
            sampled = s.light.sample(SHARD, PERIOD, [5, 1499, 1500])
            got[pk.root] = (length, ok, run.requested(), sampled,
                            s.light.samples_verified,
                            s.light.proofs_rejected)
    port, ref = got["gethsharding_tpu_torch"], got["gethsharding_tpu"]
    assert port == ref
    length, ok, requested, sampled, _, _ = port
    assert (length, ok) == (1500, True)
    # the length proof (0, then L-1 and L) of each call, the 16 distinct
    # draws in order, the samples
    boundary = [0, 1499, 1500]
    draws = requested[6:-3]
    assert requested[:6] == boundary * 2 and requested[-3:] == [5, 1499,
                                                                 1500]
    assert draws == sorted(set(draws)) and len(draws) == 16
    assert sampled == {5: body[5], 1499: body[1499], 1500: None}


def _das_setup(pk, mode: str, withheld: bool):
    """A proposer's DAS service publishing a body's extension on the hub
    under the header it added, and a light client with a DAS service of
    its own (no store); `withheld` drops every sample after publishing."""
    config = pk.params.Config(shard_count=4, quorum_size=1)
    chain = pk.chain.SimulatedMainchain(config=config)
    hub = pk.p2p.Hub()
    proposer = pk.client.SMCClient(backend=chain, config=config)
    chain.fund(proposer.account(), 2000 * pk.params.ETHER)
    body = bytes((11 * i + 5) % 256 for i in range(9000))
    root = pk.hexbytes.Hash32(pk.ds.chunk_root(body))
    chain.fast_forward(1)
    chain.add_header(proposer.account(), SHARD, PERIOD, root)
    publisher = pk.das.DASService(client=proposer,
                                  p2p=pk.p2p.P2PServer(hub=hub),
                                  proof_mode=mode, fetch_timeout=1.0)
    commitment = publisher.publish(SHARD, PERIOD, root, body)
    if withheld:
        key = bytes(commitment.das_root)
        del publisher._blobs[key]
        publisher._poly.pop(key, None)
    client = pk.client.SMCClient(backend=chain, config=config)
    das = pk.das.DASService(client=client, p2p=pk.p2p.P2PServer(hub=hub),
                            store=None, proof_mode=mode, fetch_timeout=1.0)
    light = pk.light.LightClient(client=client, p2p=das.p2p, das=das)
    return publisher, das, light


@pytest.mark.parametrize("mode", ["merkle", "poly"])
def test_das_check_gives_the_reference_verdicts(mode):
    """`das_check` on an honest and on a withheld shard, the same seed in
    both packages: the reference's verdicts and counters; the port's light
    client launches nothing."""
    got = {}
    before = _launches()
    for pk in BOTH:
        for withheld in (False, True):
            publisher, das, light = _das_setup(pk, mode, withheld)
            publisher.start()
            das.start()
            light.start()
            try:
                verdict = light.das_check(SHARD, PERIOD, k=6,
                                          seed=b"das-check-seed")
                got[(pk.root, withheld)] = (verdict, light.samples_verified,
                                            light.proofs_rejected)
                assert light.das_check(SHARD, PERIOD + 1) is False
            finally:
                light.stop()
                das.stop()
                publisher.stop()
    assert _launches() == before
    for withheld in (False, True):
        assert got[("gethsharding_tpu_torch", withheld)] \
            == got[("gethsharding_tpu", withheld)]
    # the same draws (of at most k distinct chunks) verified, then failed
    honest, held = (got[("gethsharding_tpu_torch", w)] for w in (False,
                                                                  True))
    assert honest[0] is True and held[0] is False
    assert 0 < honest[1] == held[2] <= 6 and honest[2] == held[1] == 0


def test_das_check_without_a_das_service_raises():
    s = _setup(PORT)
    with pytest.raises(RuntimeError, match="no DAS service"):
        s.light.das_check(SHARD, PERIOD)


# == 3. the node and the wire =================================================

@pytest.mark.parametrize("da_mode", ["full", "sampled"])
def test_light_node_composes_the_reference_services(da_mode):
    """No netstore, no simulator, no syncer; under `da_mode="sampled"` a
    DAS service with no store of its own. Built without `device` (and
    without a card), it resolves none."""
    ref = REF.node.ShardNode(actor="light", backend=REF.chain.
                             SimulatedMainchain(), sig_backend="python",
                             da_mode=da_mode)
    port = PORT.node.ShardNode(actor="light",
                               backend=PORT.chain.SimulatedMainchain(),
                               da_mode=da_mode)
    names = lambda node: [type(s).__name__ for s in node.services]
    assert names(port) == names(ref)
    assert "LightClient" in names(port) and "Syncer" not in names(port)
    assert port.device is None and port.sig_backend.name == "python"
    if da_mode == "sampled":
        assert port.service(PORT.light.LightClient).das is port.das_service
        assert port.das_service.store is not None   # its own, unshared
    port.start()
    port.stop()
    assert port.errors() == []


@pytest.mark.parametrize("kw", [
    {"sig_backend": "failover-torch"},
    {"serving": True},
    {"soundness_rate": 0.5},
    {"sig_backend": "torch", "mesh_devices": 4},
], ids=["failover", "serving", "soundness", "mesh"])
def test_light_node_wrappers_compose_over_the_host(kw):
    """The wrappers a light node is given compose as for every actor, over
    the host's backend: no device is resolved (a mesh of 4 is not asked
    for) and nothing is launched."""
    before = _launches()
    node = PORT.node.ShardNode(actor="light",
                               backend=PORT.chain.SimulatedMainchain(), **kw)
    node.start()
    node.stop()
    assert node.device is None and node.errors() == []
    assert _launches() == before
    if "sig_backend" in kw and kw["sig_backend"].startswith("failover-"):
        assert node.sig_backend.breaker is not None


def test_chunk_proof_response_survives_the_codec():
    ds = PORT.ds
    root = ds.chunk_root(BODY)
    for index in (0, 300, len(BODY)):
        msg = PORT.msgs.ChunkProofResponse(
            chunk_root=PORT.hexbytes.Hash32(root), index=index,
            proof=tuple(ds.chunk_proof(BODY, index)), body_len=len(BODY))
        kind, payload = PORT.codec.enc_p2p(msg)
        back = PORT.codec.dec_p2p(kind, payload)
        assert back == msg
        assert REF.codec.enc_p2p(REF.codec.dec_p2p(kind, payload)) \
            == (kind, payload)
        want = BODY[index] if index < len(BODY) else None
        assert ds.verify_chunk(back.chunk_root, back.index, back.proof) \
            == want


def test_light_node_samples_over_the_remote_hub():
    """A chain process's relay (`RPCServer`) between a syncer on one
    `RemoteHub` and a light node on `RemoteMainchain` + `RemoteHub`: the
    requests and the proofs cross the wire codec, and the samples verify."""
    from gethsharding_tpu_torch.p2p.remote import RemoteHub
    from gethsharding_tpu_torch.rpc.client import RemoteMainchain
    from gethsharding_tpu_torch.rpc.server import RPCServer

    config = PORT.params.Config(shard_count=4, quorum_size=1)
    chain = PORT.chain.SimulatedMainchain(config=config)
    server = RPCServer(chain, port=0, device="cpu")
    server.start()
    host, port = server.address
    closers = [server.stop]
    try:
        full_client = PORT.client.SMCClient(backend=chain, config=config)
        chain.fund(full_client.account(), 2000 * PORT.params.ETHER)
        store = PORT.shard.Shard(shard_id=SHARD,
                                 shard_db=PORT.kv.MemoryKV())
        collation = PORT.types.Collation(
            header=PORT.types.CollationHeader(shard_id=SHARD,
                                              period=PERIOD), body=BODY)
        root = collation.calculate_chunk_root()
        store.save_collation(collation)
        chain.fast_forward(1)
        chain.add_header(full_client.account(), SHARD, PERIOD, root)
        syncer = PORT.syncer.Syncer(
            client=full_client, shard=store,
            p2p=PORT.p2p.P2PServer(hub=RemoteHub.dial(
                host, port, accounts=full_client.accounts,
                account=full_client.account())),
            poll_interval=0.01)
        syncer.p2p.start()
        syncer.start()
        closers += [syncer.p2p.stop, syncer.stop]
        light_node = PORT.node.ShardNode(
            actor="light", shard_id=SHARD, config=config,
            backend=RemoteMainchain.dial(host, port),
            hub=RemoteHub.dial(host, port))
        light_node.start()
        closers.append(light_node.stop)
        light = light_node.service(PORT.light.LightClient)
        assert light.sample(SHARD, PERIOD, [9, 500]) == {9: BODY[9],
                                                         500: BODY[500]}
        assert light.proven_length(SHARD, PERIOD) == len(BODY)
        assert light.proofs_rejected == 0 and syncer.proofs_served >= 4
    finally:
        for close in reversed(closers):
            close()
