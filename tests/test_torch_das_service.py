"""The port's DAS plane (`gethsharding_tpu_torch/das/{erasure,sampler,
service}.py`, `storage/{chunker,netstore}.py`, the DAS messages, the
sampled notary, the node's `--da-mode sampled`) held against the JAX
package's on the CPU. Both packages take the same seeded inputs; every
comparison is exact (bytes, booleans, integers):

1. the erasure code: the GF(2^8) tables, `extend_body`'s chunks for k in
   {1, 2, 11, 170} at parity ratios 0.5 and 1.0, `recover_body` from
   random k-subsets, and `ErasureError` where the reference raises it;
2. the sampler: `sample_seed`, `sample_indices` (k >= n and n = 0
   included), `detection_probability`, `proof_bytes`, `soundness_table`;
3. the commitment: `commitment_digest` with and without the polynomial
   part, `verify_commitment` on good, foreign-key and garbage signatures,
   the `convert` carrier; the chunk store and the netstore;
4. `DASService` on each package's hub, the same scenario in both: rows
   collected, counters, verdicts and `bytes_fetched`, and the hostile
   frames (a forged commitment first, unsolicited and duplicate
   responses, a tampered chunk, a withheld index, the index cap, a
   garbage multiproof, a merkle-only commitment in poly mode), and the
   chaos seams fired per publish and per fetch attempt;
5. the two rows the fetcher synthesizes (an empty sample, an empty
   multiproof) scoring False through `TorchSigBackend(device="cpu")`;
6. the sampled notary in both proof modes on the reference's
   `tests/test_das.py::_sampled_network` shape (seeded accounts, headers
   unsigned so no plain recovery runs): votes, verdict cache, errors, no
   body request, the cache's pruning;
7. the node: services in sampled mode, the DAS options, the CLI's four
   flags, the CLI loop in poly mode; the seeded sampled devnet of
   `tests/torch_node_script.py` (merkle, a withheld and a garbage shard)
   equal to the reference's after every period, its known answers, and
   the same devnet in a process where `jax` and `gethsharding_tpu` are
   blocked.
"""

import dataclasses
import importlib
import json
import logging
import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import torch_node_script as script
from gethsharding_tpu.node.cli import build_parser as r_build_parser
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.node import cli
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PERIODS = 2
HOSTILE = ("withhold", "garbage")


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        erasure=mod("das.erasure"), sampler=mod("das.sampler"),
        service=mod("das.service"), proofs=mod("das.proofs"),
        pcs=mod("das.pcs"), msgs=mod("p2p.messages"),
        p2p=mod("p2p.service"), chunker=mod("storage.chunker"),
        netstore=mod("storage.netstore"), params=mod("params"),
        chain=mod("smc.chain"), client=mod("mainchain.client"),
        accounts=mod("mainchain.accounts"), hexbytes=mod("utils.hexbytes"),
        ecdsa=mod("crypto.secp256k1"), notary=mod("actors.notary"),
        proposer=mod("actors.proposer"), shard=mod("core.shard"),
        kv=mod("db.kv"), types=mod("core.types"),
        backend=mod("node.backend"))


PORT = _pkg("gethsharding_tpu_torch")
REF = _pkg("gethsharding_tpu")
BOTH = (PORT, REF)


# the fetch budget of a fetch that succeeds: a fetch returns as soon as
# its answers are admitted (the services' counters), so a long deadline
# costs nothing there, and a loaded host does not miss it
STEADY_FETCH_S = 30.0


def _budget(proof_mode: str, honest: bool = False) -> dict:
    """The fetch budget of a test's fetcher. A fetch that must fail (a
    withheld or garbage answer) waits its deadline out, so it keeps a
    short one: 1 s for merkle rows, the service's default (3 s) where
    admission runs a host pairing. A fetch that succeeds gets
    `STEADY_FETCH_S`."""
    if honest:
        return {"fetch_timeout": STEADY_FETCH_S,
                "fetch_attempts": 3 if proof_mode == "poly" else 2}
    return ({} if proof_mode == "poly"
            else {"fetch_timeout": 1.0, "fetch_attempts": 2})


def _sig(pk):
    return (TorchSigBackend(device="cpu") if pk is PORT
            else ref_get_backend("python"))


def _body(seed: int, size: int) -> bytes:
    return random.Random(seed).randbytes(size)


# == 1. the erasure code ======================================================

def test_gf_tables_and_field_ops_match_reference():
    assert (PORT.erasure._GF_EXP == REF.erasure._GF_EXP).all()
    assert (PORT.erasure._GF_LOG == REF.erasure._GF_LOG).all()
    rng = random.Random(1)
    for _ in range(500):
        a, b = rng.randrange(256), rng.randrange(256)
        assert PORT.erasure.gf_mul(a, b) == REF.erasure.gf_mul(a, b)
        if a:
            assert PORT.erasure.gf_inv(a) == REF.erasure.gf_inv(a)
    with pytest.raises(ZeroDivisionError):
        PORT.erasure.gf_inv(0)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("k", [1, 2, 11, 170])
def test_extend_body_matches_reference(k, ratio):
    size = (k - 1) * 4096 + 1 + k * 97 % 4000
    body = _body(k, size)
    results = []
    for pk in BOTH:
        try:
            results.append(pk.erasure.extend_body(body, parity_ratio=ratio))
        except pk.erasure.ErasureError as exc:
            results.append(("ErasureError", str(exc)))
    port, ref = results
    if k == 170 and ratio == 1.0:   # n = 340 > 255
        assert port == ref and port[0] == "ErasureError"
        return
    assert (port.k, port.n, port.body_len) == (ref.k, ref.n, ref.body_len)
    assert port.k == k
    assert port.chunks == ref.chunks


@pytest.mark.parametrize("k", [1, 2, 11, 170])
def test_recover_body_from_random_subsets(k):
    body = _body(100 + k, k * 4096 - 5)
    xb = PORT.erasure.extend_body(body)
    rng = random.Random(k)
    for _ in range(2):
        keep = rng.sample(range(xb.n), xb.k)
        shares = {i: xb.chunks[i] for i in keep}
        got = PORT.erasure.recover_body(shares, xb.k, xb.n, xb.body_len)
        assert got == body
        assert got == REF.erasure.recover_body(shares, xb.k, xb.n,
                                               xb.body_len)


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the class and text compared
        return type(exc).__name__, str(exc)
    return None


def test_erasure_errors_match_reference():
    xb = PORT.erasure.extend_body(_body(3, 9000))
    few = {i: xb.chunks[i] for i in range(xb.k - 1)}
    cases = [
        lambda e: e.extend_body(b"x" * (171 * 4096)),        # n > 255
        lambda e: e.extend_body(b"x", parity_ratio=0),
        lambda e: e.recover_body(few, xb.k, xb.n, xb.body_len),
        lambda e: e.rs_decode({0: b"ab", 1: b"abc"}, 2, 3),
        lambda e: e.rs_encode([], 2),
        lambda e: e.rs_encode([b"ab", b"abc"], 1),
        lambda e: e.recover_body({i: xb.chunks[i] for i in range(xb.k)},
                                 xb.k, xb.n, xb.k * 4096 + 1),
    ]
    for case in cases:
        port = _raised(lambda: case(PORT.erasure))
        assert port is not None and port[0] == "ErasureError"
        assert port == _raised(lambda: case(REF.erasure))


def test_rs_any_k_of_n_matches_reference():
    rng = random.Random(9)
    data = [rng.randbytes(33) for _ in range(5)]
    out = PORT.erasure.rs_encode(data, 4)
    assert out == REF.erasure.rs_encode(data, 4)
    for _ in range(5):
        keep = rng.sample(range(9), 5)
        shares = {i: out[i] for i in keep}
        assert PORT.erasure.rs_decode(shares, 5, 9) == data


# == 2. the sampler ===========================================================

_SAMPLER_CASES = [(16, 17), (16, 255), (5, 3), (3, 3), (4, 0), (1, 1)]


@pytest.mark.parametrize("k,n", _SAMPLER_CASES)
def test_sample_seed_and_indices_match_reference(k, n):
    rng = random.Random(k * 1000 + n)
    for _ in range(5):
        account, root = rng.randbytes(20), rng.randbytes(32)
        shard, period = rng.randrange(100), rng.randrange(1 << 20)
        seed = PORT.sampler.sample_seed(account, shard, period, root)
        assert seed == REF.sampler.sample_seed(account, shard, period, root)
        got = PORT.sampler.sample_indices(seed, k, n)
        assert got == REF.sampler.sample_indices(seed, k, n)
        assert got == sorted(set(got)) and len(got) == min(k, max(n, 0))


def test_soundness_accounting_matches_reference():
    for args in ((16, 255, 170), (4, 17, 11), (32, 3, 2), (8, 9, 9)):
        for checkers in (1, 3):
            assert PORT.sampler.detection_probability(
                *args, checkers=checkers) == \
                REF.sampler.detection_probability(*args, checkers=checkers)
    for args in ((0, 5), (5, 0), (6, 5)):
        assert _raised(lambda: PORT.sampler.detection_probability(
            4, *args)) == _raised(lambda: REF.sampler.detection_probability(
                4, *args))
    for samples in (0, 1, 16, 64):
        for mode in ("merkle", "poly"):
            assert PORT.sampler.proof_bytes(samples, mode) == \
                REF.sampler.proof_bytes(samples, mode)
    assert _raised(lambda: PORT.sampler.proof_bytes(16, "zk")) == \
        _raised(lambda: REF.sampler.proof_bytes(16, "zk"))
    for kw in ({"n": 255, "k_data": 170},
               {"n": 17, "k_data": 11, "ks": (2, 16), "checkers": 5}):
        assert PORT.sampler.soundness_table(**kw) == \
            REF.sampler.soundness_table(**kw)


# == 3. the commitment and the chunk stores ===================================

@pytest.mark.parametrize("poly", [False, True])
def test_commitment_digest_matches_reference(poly):
    rng = random.Random(int(poly))
    for _ in range(5):
        args = (rng.randrange(100), rng.randrange(1 << 30), rng.randbytes(32),
                rng.randbytes(32), rng.randrange(1, 170),
                rng.randrange(170, 256), rng.randrange(1 << 20))
        extra = (rng.randbytes(64),) if poly else ()
        assert PORT.service.commitment_digest(*args, *extra) == \
            REF.service.commitment_digest(*args, *extra)
        if not poly:   # a merkle-only digest is the pre-poly wire format
            assert PORT.service.commitment_digest(*args, b"") == \
                PORT.service.commitment_digest(*args)


def _signed_commitment(pk, signer_seed: bytes, poly: bool = False):
    am = pk.accounts.AccountManager()
    acct = am.new_account(seed=signer_seed)
    poly_commitment = (pk.pcs.g1_to_bytes(pk.pcs.commit([5, 7, 11]))
                       if poly else b"")
    com = pk.service.DASCommitment(
        shard_id=3, period=9, chunk_root=b"\x11" * 32, das_root=b"\x22" * 32,
        k=2, n=3, body_len=5000, poly_commitment=poly_commitment)
    sig = pk.ecdsa.sign(com.digest(), acct.priv).to_bytes65()
    return dataclasses.replace(com, signature=sig), acct.address


@pytest.mark.parametrize("kind", ["good", "foreign", "garbage"])
def test_verify_commitment_agrees_with_reference(kind):
    verdicts = []
    for pk in BOTH:
        com, proposer = _signed_commitment(pk, b"das-proposer")
        if kind == "foreign":
            _, proposer = _signed_commitment(pk, b"das-someone-else")
        elif kind == "garbage":
            com = dataclasses.replace(com, signature=b"\x01" * 64 + b"\x05")
        verdicts.append((bytes(com.signature),
                         pk.service.verify_commitment(com, proposer)))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][1] is (kind == "good")


def test_commitment_carrier_crosses_packages():
    ref, _ = _signed_commitment(REF, b"das-proposer")
    port = convert.das_commitment_from_fields(
        convert.das_commitment_fields(ref))
    assert isinstance(port, PORT.service.DASCommitment)
    assert port.digest() == ref.digest()
    assert convert.das_commitment_fields(port) == \
        convert.das_commitment_fields(ref)


def test_chunk_store_matches_reference():
    data = _body(21, 3 * 4096 * 128 + 777)     # three levels of keys
    stores = [pk.chunker.ChunkStore() for pk in BOTH]
    roots = [s.store(data) for s in stores]
    assert roots[0] == roots[1]
    assert PORT.chunker.KEY_SIZE == REF.chunker.KEY_SIZE == 32
    port, ref = stores
    assert sorted(port.kv.items()) == sorted(ref.kv.items())
    assert port.retrieve(roots[0]) == data
    assert port.size(roots[0]) == len(data)
    key = next(k for k, _ in port.kv.items())
    port.kv.put(key, port.kv.get(key)[:-1] + b"\x00")
    with pytest.raises(PORT.chunker.ChunkStoreError, match="corrupted"):
        port.chunk(key[len(b"chunk:"):])
    with pytest.raises(PORT.chunker.ChunkStoreError, match="missing"):
        port.chunk(b"\x00" * 32)


def test_netstore_fetches_over_the_hub_like_reference():
    """A chunk tree published on one node is retrieved from another over
    the hub; an unsolicited delivery and a delivery whose key does not
    commit to its payload are dropped. Both packages count the same."""
    data = _body(22, 3 * 4096 + 5)
    got = []
    for pk in BOTH:
        hub = pk.p2p.Hub()
        server = pk.netstore.NetStore(p2p=pk.p2p.P2PServer(hub))
        fetcher = pk.netstore.NetStore(p2p=pk.p2p.P2PServer(hub),
                                       fetch_timeout=STEADY_FETCH_S)
        server.start()
        fetcher.start()
        try:
            root = server.store_content(data)
            assert fetcher.retrieve(root) == data
            stray = pk.netstore.ChunkDelivery(key=b"\x01" * 32, span=3,
                                              payload=b"abc")
            fetcher.p2p.loopback(stray)
            with fetcher._fetch_lock:
                fetcher._fetching.add(b"\x02" * 32)
            fetcher.p2p.loopback(dataclasses.replace(stray,
                                                     key=b"\x02" * 32))
            script.wait_for(lambda: fetcher.deliveries_rejected >= 2,
                            "the netstore's rejections")
            with pytest.raises(pk.chunker.ChunkStoreError):
                fetcher.store.chunk(b"\x02" * 32)
            got.append((root, server.chunks_served, fetcher.chunks_fetched,
                        fetcher.deliveries_rejected))
        finally:
            fetcher.stop()
            server.stop()
    assert got[0] == got[1]


# == 4. the service on the hub ================================================

class _Record:
    def __init__(self, chunk_root, proposer):
        self.chunk_root = chunk_root
        self.proposer = proposer


_COUNTERS = ("published", "samples_served", "samples_fetched",
             "sample_wire_bytes", "samples_verified", "sample_failures",
             "commitments_rejected", "samples_rejected",
             "multiproofs_served", "multiproofs_fetched",
             "multiproofs_rejected")


# the counters whose movement does not depend on fetch timing
_SETTLED = ("published", "samples_fetched", "sample_wire_bytes",
            "samples_verified", "sample_failures", "multiproofs_fetched")


class _Pair:
    """A publishing and a fetching `DASService` of one package on one hub,
    seeded accounts; `counters()` reads the `das/*` counters' movement
    since the pair was made. A poly fetcher keeps the service's default
    fetch budget (3 s over 3 attempts): its admission check is a host
    pairing, ~1.4 s on this CPU. `honest` pairs, whose fetches succeed,
    get the steady budget (`_budget`)."""

    def __init__(self, pk, samples=6, proof_mode="merkle",
                 fetch_proof_mode=None, chaos=(None, None), honest=False):
        self.pk = pk
        config = pk.params.Config()
        self.chain = pk.chain.SimulatedMainchain(config=config)
        self.hub = pk.p2p.Hub()
        am = pk.accounts.AccountManager()
        self.services, self.clients = [], []
        for i, mode in enumerate((proof_mode, fetch_proof_mode or
                                  proof_mode)):
            client = pk.client.SMCClient(
                backend=self.chain, config=config, accounts=am,
                account=am.new_account(seed=b"das-pair-%d" % i))
            svc = pk.service.DASService(
                client=client, p2p=pk.p2p.P2PServer(self.hub),
                samples=samples, proof_mode=mode, chaos=chaos[i],
                **_budget(fetch_proof_mode or proof_mode, honest))
            svc.start()
            self.services.append(svc)
            self.clients.append(client)
        self.prop, self.fetch = self.services
        self._base = self._values()

    def _values(self):
        return {k: getattr(self.fetch, f"m_{k}").value for k in _COUNTERS}

    def counters(self, keys=_COUNTERS):
        """The counters' movement; a poly fetch's served and rejected
        counts depend on how many attempts its deadline allowed, so the
        poly tests compare `_SETTLED` only."""
        values = self._values()
        return {k: values[k] - self._base[k] for k in keys}

    def record(self, root):
        return _Record(root, self.clients[0].account())

    def account(self):
        return bytes(self.clients[1].account())

    def stop(self):
        for svc in self.services:
            svc.stop()


@pytest.fixture
def pairs(request):
    made = []

    def make(**kw):
        out = [_Pair(pk, **kw) for pk in BOTH]
        made.extend(out)
        return out

    yield make
    for pair in made:
        pair.stop()


def _rows(rows) -> dict:
    """Collected rows as plain values (the commitment by its fields)."""
    if rows is None:
        return None
    out = {k: v for k, v in rows.items() if k != "commitment"}
    out["proofs"] = [list(map(bytes, p)) for p in out.get("proofs", [])]
    out["commitment"] = convert.das_commitment_fields(rows["commitment"])
    return out


def test_service_publish_fetch_verify_matches_reference(pairs):
    got = []
    for pair in pairs(honest=True):
        pk = pair.pk
        root32 = pk.hexbytes.Hash32(b"\x07" * 32)
        commitment = pair.prop.publish(2, 5, root32, _body(5, 21000))
        assert pk.service.verify_commitment(commitment,
                                            pair.clients[0].account())
        rows = pair.fetch.collect_rows(2, 5, pair.record(root32),
                                       pair.account())
        ok = _sig(pk).das_verify_samples(rows["chunks"], rows["indices"],
                                         rows["proofs"], rows["roots"])
        bad = pair.fetch.note_verdicts(ok)
        status = pair.fetch.da_status(2, 5)
        got.append((_rows(rows), ok, bad, pair.counters(),
                    pair.fetch.bytes_fetched, status,
                    pair.prop.da_status(2, 5)))
    assert got[0] == got[1]
    rows, ok, bad, counters = got[0][:4]
    assert len(rows["chunks"]) == 6 and ok == [True] * 6 and bad == 0
    assert counters["samples_fetched"] == counters["samples_served"] == 6
    assert got[0][4] <= 6 * (4096 + 32 * 8 + 40)
    assert got[0][5]["known"] and not got[0][5]["holds_blob"]
    assert got[0][6]["holds_blob"]


def test_wrong_proposer_commitment_is_rejected(pairs):
    got = []
    for pair in pairs():
        root32 = pair.pk.hexbytes.Hash32(b"\x08" * 32)
        pair.prop.publish(2, 5, root32, _body(6, 9000))
        impostor = pair.clients[1].account()
        got.append(pair.fetch.fetch_commitment(2, 5, root32, impostor))
        assert pair.counters()["commitments_rejected"] >= 1
        assert any("rejected DAS commitment for shard 2 period 5" in e
                   for e in pair.fetch.errors)
    assert got == [None, None]


def test_forged_commitment_first_does_not_shadow(pairs):
    got = []
    for pair in pairs():
        pk = pair.pk
        root32 = pk.hexbytes.Hash32(b"\x0e" * 32)
        commitment = pair.prop.publish(4, 2, root32, _body(7, 9000))
        genuine = pk.msgs.DASCommitmentResponse(
            shard_id=4, period=2, chunk_root=commitment.chunk_root,
            das_root=commitment.das_root, k=commitment.k, n=commitment.n,
            body_len=commitment.body_len, signature=commitment.signature)
        forged = dataclasses.replace(genuine, das_root=b"\x66" * 32)
        pair.fetch._want_commitments.add((4, 2))
        pair.fetch._on_commitment_response(
            pk.p2p.Message(pk.p2p.Peer(99), forged))
        pair.fetch._on_commitment_response(
            pk.p2p.Message(pk.p2p.Peer(1), genuine))
        fetched = pair.fetch.fetch_commitment(4, 2, root32,
                                              pair.clients[0].account())
        got.append((convert.das_commitment_fields(fetched),
                    pair.counters()["commitments_rejected"]))
    assert got[0] == got[1]
    assert got[0][1] == 1


def test_parked_commitments_are_bounded(pairs):
    got = []
    for pair in pairs():
        pk = pair.pk
        pair.fetch._want_commitments.add((1, 1))
        for i in range(7):
            pair.fetch._on_commitment_response(pk.p2p.Message(
                pk.p2p.Peer(i), pk.msgs.DASCommitmentResponse(
                    shard_id=1, period=1, chunk_root=b"\x00" * 32,
                    das_root=bytes([i]) * 32, k=1, n=2, body_len=1)))
        # and an unsolicited one parks nowhere
        pair.fetch._on_commitment_response(pk.p2p.Message(
            pk.p2p.Peer(8), pk.msgs.DASCommitmentResponse(
                shard_id=2, period=1, chunk_root=b"\x00" * 32,
                das_root=b"\x09" * 32, k=1, n=2, body_len=1)))
        got.append({key: [bytes(r.das_root) for r in parked]
                    for key, parked in pair.fetch._recv_commitments.items()})
    assert got[0] == got[1]
    assert len(got[0][(1, 1)]) == PORT.service.MAX_PARKED_COMMITMENTS == 4


def test_unsolicited_duplicate_and_tampered_samples(pairs):
    """Only solicited, verified samples are admitted, first one wins: an
    unsolicited frame costs nothing, a tampered chunk costs a rejection
    and leaves the slot to the honest answer behind it, a duplicate of an
    admitted answer is dropped."""
    got = []
    for pair in pairs():
        pk = pair.pk
        commitment = pair.prop.publish(3, 1, pk.hexbytes.Hash32(b"\x0d" * 32),
                                       _body(8, 9000))
        root = bytes(commitment.das_root)
        xb, levels = pair.prop._blobs[root]
        resp = lambda i, chunk: pk.p2p.Message(pk.p2p.Peer(1),
                                               pk.msgs.DASampleResponse(
            das_root=root, index=i, chunk=chunk,
            proof=pk.proofs.merkle_proof(levels, i)))
        steps = []
        pair.fetch._on_sample_response(resp(0, xb.chunks[0]))  # unsolicited
        steps.append((dict(pair.fetch._recv_samples), pair.counters()))
        pair.fetch._want_samples.update({(root, 0), (root, 1)})
        pair.fetch._on_sample_response(resp(0, b"\xaa" * 4096))  # tampered
        steps.append((dict(pair.fetch._recv_samples), pair.counters()))
        pair.fetch._on_sample_response(resp(0, xb.chunks[0]))   # honest
        pair.fetch._on_sample_response(resp(0, xb.chunks[0]))   # duplicate
        pair.fetch._on_sample_response(resp(1, xb.chunks[1][:-1]))  # short
        steps.append(({k: (v[0], list(v[1]))
                       for k, v in pair.fetch._recv_samples.items()},
                      pair.counters(), pair.fetch.bytes_fetched))
        got.append(steps)
    assert got[0] == got[1]
    first, tampered, last = got[0]
    assert first[0] == {} and first[1]["samples_rejected"] == 0
    assert tampered[0] == {} and tampered[1]["samples_rejected"] == 1
    assert [key[1] for key in last[0]] == [0]
    assert last[1]["samples_fetched"] == 1
    assert last[1]["samples_rejected"] == 2


def test_withheld_sample_becomes_an_empty_row(pairs):
    """The publisher forgets the blob: the commitment still resolves, the
    samples never arrive, `collect_rows` synthesizes empty rows, and they
    score False through the backend."""
    got = []
    for pair in pairs(samples=4):
        pk = pair.pk
        root32 = pk.hexbytes.Hash32(b"\x09" * 32)
        commitment = pair.prop.publish(1, 3, root32, _body(9, 15000))
        del pair.prop._blobs[bytes(commitment.das_root)]
        rows = pair.fetch.collect_rows(1, 3, pair.record(root32),
                                       pair.account())
        ok = _sig(pk).das_verify_samples(rows["chunks"], rows["indices"],
                                         rows["proofs"], rows["roots"])
        got.append((_rows(rows), ok, pair.fetch.note_verdicts(ok),
                    pair.counters()))
    assert got[0] == got[1]
    rows, ok, bad, counters = got[0]
    assert rows["chunks"] == [b""] * 4 and rows["proofs"] == [[]] * 4
    assert ok == [False] * 4 and bad == 4
    assert counters["sample_failures"] == 4


def test_sample_request_index_cap(pairs):
    """One request frame asks for 100 indices of a 66-chunk blob: the
    server answers the first MAX_SAMPLE_INDICES (64) only."""
    got = []
    for pair in pairs():
        pk = pair.pk
        commitment = pair.prop.publish(0, 1, pk.hexbytes.Hash32(b"\x01" * 32),
                                       _body(10, 44 * 4096))
        assert commitment.n == 66
        watch = pk.p2p.P2PServer(pair.hub)
        watch.start()
        sub = watch.subscribe(pk.msgs.DASampleResponse)
        try:
            watch.broadcast(pk.msgs.DASampleRequest(
                das_root=commitment.das_root, indices=tuple(range(100))))
            script.wait_for(lambda: pair.counters()["samples_served"] >= 64,
                            "the served samples")
            answers = [sub.get(timeout=5.0).data.index for _ in range(64)]
            assert sub.try_get() is None
            got.append((sorted(answers), pair.counters()["samples_served"]))
        finally:
            watch.stop()
    assert got[0] == got[1] == (list(range(64)), 64)
    assert PORT.service.MAX_SAMPLE_INDICES == 64


def test_get_sample_and_status_match_reference(pairs):
    got = []
    for pair in pairs():
        pk = pair.pk
        assert pair.prop.get_sample(0, 1, 0) is None
        assert pair.prop.da_status(0, 1)["known"] is False
        commitment = pair.prop.publish(0, 1, pk.hexbytes.Hash32(b"\x03" * 32),
                                       _body(11, 12000))
        sample = pair.prop.get_sample(0, 1, commitment.n - 1)
        got.append((sample["index"], sample["chunk"],
                    list(map(bytes, sample["proof"])),
                    pair.prop.get_sample(0, 1, 999),
                    pair.prop.get_multiproof(0, 1, [0]),
                    pair.prop.da_status(0, 1)))
    assert got[0] == got[1]


def test_service_fires_chaos_seams_like_reference(pairs):
    """A chaos schedule on each service: the publisher's first publish
    fails (`das.parity_publish`), the fetcher's first commitment and
    sample fetch attempts fail and ride the retry ladder; the rows,
    verdicts, counters and the schedules' call and injection counts equal
    the reference's. (Merkle mode: a poly fetch's attempt count depends on
    the host pairing's pace.)"""
    spec = "seed=3,das.commitment_fetch=1,das.sample_fetch=1"
    proof_mode = "merkle"
    got = []
    for pk in BOTH:
        chaos = importlib.import_module(
            pk.service.__name__.replace("das.service", "resilience.chaos"))
        schedules = (chaos.parse_spec("seed=3,das.parity_publish=1"),
                     chaos.parse_spec(spec))
        (pair,) = [p for p in pairs(samples=4, proof_mode=proof_mode,
                                    chaos=schedules, honest=True)
                   if p.pk is pk]
        root32 = pk.hexbytes.Hash32(b"\x09" * 32)
        with pytest.raises(chaos.InjectedFault):
            pair.prop.publish(1, 2, root32, _body(13, 9000))
        pair.prop.publish(1, 2, root32, _body(13, 9000))
        row = pair.fetch.collect_rows(1, 2, pair.record(root32),
                                      pair.account())
        ok = _sig(pk).das_verify_samples(row["chunks"], row["indices"],
                                         row["proofs"], row["roots"])
        seams = {seam: (s.calls(seam), s.injected.get(seam, 0))
                 for s in schedules for seam in pk.service.CHAOS_SEAMS
                 if s.calls(seam)}
        got.append((_rows(row), ok, pair.counters(), seams))
    assert got[0] == got[1]
    assert all(got[0][1])
    assert got[0][3] == {"das.parity_publish": (2, 1),
                         "das.commitment_fetch": (2, 1),
                         "das.sample_fetch": (2, 1)}
    with pytest.raises(ValueError, match="unknown DAS proof mode"):
        PORT.service.DASService(proof_mode="zk")
    assert PORT.service.CHAOS_SEAMS == REF.service.CHAOS_SEAMS
    assert PORT.service.PROOF_MODES == REF.service.PROOF_MODES


def test_multiproof_fetch_matches_reference(pairs):
    got = []
    for pair in pairs(samples=4, proof_mode="poly"):
        pk = pair.pk
        root32 = pk.hexbytes.Hash32(b"\x05" * 32)
        commitment = pair.prop.publish(6, 2, root32, _body(12, 9000))
        row = pair.fetch.collect_poly_row(6, 2, pair.record(root32),
                                          pair.account())
        ok = _sig(pk).das_verify_multiproofs(
            [row["poly_commitment"]], [row["indices"]], [row["evals"]],
            [row["proof"]], [row["n"]])
        local = pair.prop.get_multiproof(6, 2, row["indices"])
        assert pair.counters()["multiproofs_served"] >= 2  # network, local
        got.append((_rows(row), ok, pair.counters(_SETTLED),
                    pair.fetch.bytes_fetched, local["proof"],
                    len(commitment.poly_commitment)))
    assert got[0] == got[1]
    row, ok, counters = got[0][:3]
    assert ok == [True] and row["proof"] == got[0][4]
    assert counters["multiproofs_fetched"] == 1 and got[0][5] == 64


def test_garbage_multiproof_is_rejected_at_admission(pairs):
    """The publisher serves garbage chunks under its real commitment: the
    multiproof fails the scalar check at admission, the fetch gives up,
    and the row the notary gets is an empty proof that scores False."""
    got = []
    for pair in pairs(samples=3, proof_mode="poly"):
        pk = pair.pk
        root32 = pk.hexbytes.Hash32(b"\x06" * 32)
        commitment = pair.prop.publish(6, 3, root32, _body(13, 9000))
        key = bytes(commitment.das_root)
        xb, levels = pair.prop._blobs[key]
        pair.prop._blobs[key] = (dataclasses.replace(
            xb, chunks=tuple(b"\xbb" * 4096 for _ in xb.chunks)), levels)
        row = pair.fetch.collect_poly_row(6, 3, pair.record(root32),
                                          pair.account())
        ok = _sig(pk).das_verify_multiproofs(
            [row["poly_commitment"]], [row["indices"]], [row["evals"]],
            [row["proof"]], [row["n"]])
        counters = pair.counters()
        got.append((_rows(row), ok, counters["multiproofs_fetched"],
                    counters["multiproofs_rejected"] >= 1))
    assert got[0] == got[1]
    row, ok, fetched, rejected = got[0]
    assert row["proof"] == b"" and row["evals"] == [0] * 3
    assert ok == [False] and fetched == 0 and rejected


def test_merkle_only_commitment_in_poly_mode(pairs):
    """A merkle-only publisher and a poly fetcher: the commitment carries
    no polynomial part, no multiproof is requested, and the row is an
    empty proof scoring False."""
    got = []
    for pair in pairs(samples=3, proof_mode="merkle",
                      fetch_proof_mode="poly"):
        pk = pair.pk
        root32 = pk.hexbytes.Hash32(b"\x0a" * 32)
        pair.prop.publish(7, 3, root32, _body(14, 9000))
        row = pair.fetch.collect_poly_row(7, 3, pair.record(root32),
                                          pair.account())
        ok = _sig(pk).das_verify_multiproofs(
            [row["poly_commitment"]], [row["indices"]], [row["evals"]],
            [row["proof"]], [row["n"]])
        got.append((_rows(row), ok, pair.counters()["multiproofs_served"]))
    assert got[0] == got[1]   # nothing requested, nothing served
    assert got[0][0]["poly_commitment"] == b"" and got[0][0]["proof"] == b""
    assert got[0][1:] == ([False], 0)


def test_unsolicited_and_duplicate_multiproofs(pairs):
    got = []
    for pair in pairs(samples=3, proof_mode="poly"):
        pk = pair.pk
        commitment = pair.prop.publish(8, 1, pk.hexbytes.Hash32(b"\x0b" * 32),
                                       _body(15, 9000))
        local = pair.prop.get_multiproof(8, 1, [0, 2])
        msg = pk.p2p.Message(pk.p2p.Peer(1), pk.msgs.DASMultiproofResponse(
            das_root=commitment.das_root, indices=(0, 2),
            chunks=tuple(local["chunks"]), proof=local["proof"]))
        pair.fetch._on_multiproof_response(msg)               # unsolicited
        key = (bytes(commitment.das_root), (0, 2))
        before = dict(pair.fetch._recv_multi)
        pair.fetch._want_multi[key] = (commitment.poly_commitment,
                                       commitment.n)
        pair.fetch._on_multiproof_response(msg)
        pair.fetch._on_multiproof_response(msg)               # duplicate
        got.append((before, {k: (list(v[0]), v[1]) for k, v
                             in pair.fetch._recv_multi.items()},
                    pair.counters(_SETTLED)))
    assert got[0] == got[1]
    assert got[0][0] == {} and len(got[0][1]) == 1
    assert got[0][2]["multiproofs_fetched"] == 1


# == 5. the synthesized rows through the backend ==============================

def test_empty_sample_row_scores_false():
    """A withheld sample reaches `das_verify_samples` as an empty chunk
    with an empty proof, beside honest rows: False, never a raise."""
    xb = PORT.erasure.extend_body(_body(16, 9000))
    levels = PORT.proofs.merkle_levels(
        [PORT.proofs.chunk_leaf(c) for c in xb.chunks])
    root = levels[-1][0]
    chunks = [b"", xb.chunks[1], b"", xb.chunks[4]]
    indices = [0, 1, 2, 4]
    proofs = [(), PORT.proofs.merkle_proof(levels, 1), (),
              PORT.proofs.merkle_proof(levels, 4)]
    roots = [root] * 4
    got = TorchSigBackend(device="cpu").das_verify_samples(
        chunks, indices, proofs, roots)
    assert got == [False, True, False, True]
    assert got == ref_get_backend("python").das_verify_samples(
        chunks, indices, proofs, roots)


def test_empty_proof_row_scores_false():
    """A failed or merkle-only fetch reaches `das_verify_multiproofs` as an
    empty proof with zero evaluations, beside an honest row: False, never
    a raise."""
    pcs = PORT.pcs
    values = [pcs.chunk_value(bytes([i]) * 4096) for i in range(5)]
    commitment = pcs.g1_to_bytes(pcs.commit(values))
    proof, evals = pcs.open_multi(values, (1, 3))
    cols = ([commitment, commitment], [[1, 3], [0, 2, 4]],
            [evals, [0, 0, 0]], [pcs.g1_to_bytes(proof), b""], [5, 5])
    got = TorchSigBackend(device="cpu").das_verify_multiproofs(*cols)
    assert got == [True, False]
    assert got == ref_get_backend("python").das_verify_multiproofs(*cols)


# == 6. the sampled notary ====================================================

def _sampled_network(pk, proof_mode="merkle", tamper=False, body_size=9000,
                     samples=5):
    """The reference's `tests/test_das.py::_sampled_network`, seeded: a
    proposer publishing two periods' collations of shard 0 through its
    `DASService` and a sampled notary voting on them from its head; the
    headers go on-chain unsigned (so the head runs no plain recovery on
    the CPU). `tamper` serves garbage under every commitment."""
    config = pk.params.Config(quorum_size=1, period_length=4)
    chain = pk.chain.SimulatedMainchain(config=config)
    am = pk.accounts.AccountManager()
    clients = [pk.client.SMCClient(
        backend=chain, config=config, accounts=am,
        account=am.new_account(seed=b"das-net-%d" % i)) for i in range(2)]
    prop_client, not_client = clients
    for client in clients:
        chain.fund(client.account(), 2000 * pk.params.ETHER)
    hub = pk.p2p.Hub()
    watch = pk.p2p.P2PServer(hub)
    watch.start()
    body_watch = watch.subscribe(pk.msgs.CollationBodyRequest)
    svc_prop, svc_not = (pk.service.DASService(
        client=client, p2p=pk.p2p.P2PServer(hub), samples=samples,
        proof_mode=proof_mode, **_budget(proof_mode, honest=not tamper))
        for client in clients)
    svc_prop.start()
    svc_not.start()
    notary = pk.notary.Notary(
        client=not_client, shard=pk.shard.Shard(0, pk.kv.MemoryKV()),
        p2p=svc_not.p2p, config=config, deposit_flag=True,
        all_shards=False, sig_backend=_sig(pk), das=svc_not,
        da_mode="sampled")
    notary.start()
    chain.fast_forward(1)
    rng = random.Random(body_size)
    periods = []
    for _ in range(2):
        period = chain.current_period()
        collation = pk.proposer.create_collation(
            prop_client, 0, period,
            [pk.types.Transaction(nonce=period,
                                  payload=rng.randbytes(body_size))])
        commitment = svc_prop.publish(0, period, collation.header.chunk_root,
                                      collation.body)
        if tamper:
            root = bytes(commitment.das_root)
            xb, levels = svc_prop._blobs[root]
            svc_prop._blobs[root] = (dataclasses.replace(
                xb, chunks=tuple(b"\xbb" * 4096 for _ in xb.chunks)), levels)
        prop_client.add_header(0, period, collation.header.chunk_root, b"")
        chain.commit()
        notary.notarize_collations(head=chain.block_number)
        periods.append(period)
        while chain.current_period() == period:
            chain.commit()
    services = (notary, svc_prop, svc_not, watch)
    return SimpleNamespace(chain=chain, notary=notary, das=svc_not,
                           body_watch=body_watch, periods=periods,
                           services=services)


def _notary_outcome(net) -> dict:
    return {"votes": net.notary.votes_submitted,
            "verdicts": sorted(net.notary._da_verdicts),
            "errors": list(net.notary.errors),
            "approved": net.chain.last_approved_collation(0),
            "bytes_fetched": net.das.bytes_fetched,
            "body_requests": net.body_watch.try_get(),
            "periods": net.periods}


@pytest.fixture
def networks():
    made = []

    def make(**kw):
        out = [_sampled_network(pk, **kw) for pk in BOTH]
        made.extend(out)
        return out

    yield make
    for net in made:
        for svc in net.services:
            svc.stop()


@pytest.mark.parametrize("mode", ["merkle", "poly"])
def test_sampled_notary_votes_like_reference(networks, mode):
    port, ref = networks(proof_mode=mode)
    got = _notary_outcome(port)
    assert got == _notary_outcome(ref)
    assert got["votes"] == 2 and got["errors"] == []
    assert got["verdicts"] == [(0, p) for p in got["periods"]]
    assert got["approved"] == got["periods"][-1]
    assert got["body_requests"] is None        # no body request left
    if mode == "merkle":
        assert got["bytes_fetched"] <= 2 * 5 * (4096 + 32 * 8 + 40)
    assert port.notary.canonical_set == 0       # it holds no body


def test_sampled_notary_refuses_corrupted_blobs(networks):
    port, ref = networks(tamper=True)
    got = _notary_outcome(port)
    assert got == _notary_outcome(ref)
    assert got["votes"] == 0 and got["verdicts"] == []
    # every head of the period tries again (a negative verdict is not
    # cached)
    assert set(got["errors"]) == {
        f"collation body unavailable for shard 0 period {p}"
        for p in got["periods"]}
    assert got["body_requests"] is None
    assert port.das.m_samples_rejected.value > 0


def test_sampled_verdict_cache_prunes_like_reference(networks):
    """Beyond `_DA_CACHE_MAX` the oldest periods' verdicts go, in both."""
    kept = []
    for net in networks():
        notary = net.notary
        notary._DA_CACHE_MAX = 3
        notary._da_verdicts = {(s, p): True for s, p in
                               ((4, 9), (0, 2), (1, 7), (2, 3), (3, 5))}
        assert notary._sampled_verdicts([]) == {}
        kept.append(sorted(notary._da_verdicts))
    assert kept[0] == kept[1] == [(1, 7), (3, 5), (4, 9)]
    assert PORT.notary.Notary._DA_CACHE_MAX == \
        REF.notary.Notary._DA_CACHE_MAX == 4096


def test_sampled_direct_vote_checks_its_own_samples(networks):
    """The single-shard check (direct `submit_vote` callers, the
    windback) samples for itself; a positive verdict is cached, so a
    second check fetches nothing."""
    got = []
    for net in networks():
        notary, chain = net.notary, net.chain
        period = net.periods[-1]
        record = chain.collation_record(0, period)
        notary._da_verdicts.clear()
        fetched = net.das.bytes_fetched
        first = notary._check_sampled(0, period, record)
        moved = net.das.bytes_fetched - fetched
        again = notary._check_sampled(0, period, record)
        got.append((first, moved, again, net.das.bytes_fetched - fetched))
    assert got[0] == got[1]
    first, moved, again, total = got[0]
    assert first is True and again is True
    assert moved > 0 and total == moved   # the second check fetched nothing


# == 7. the node ==============================================================

PORT_NODE = {"sig_backend": "torch", "device": "cpu"}
REF_NODE = {"sig_backend": "python"}


@pytest.mark.parametrize("proofs", ["merkle", "poly"])
@pytest.mark.parametrize("actor", ["notary", "proposer", "observer"])
def test_sampled_node_composition_matches_reference(actor, proofs):
    names = []
    for pk, kw in ((PORT, PORT_NODE), (REF, REF_NODE)):
        node = pk.backend.ShardNode(
            actor=actor, backend=pk.chain.SimulatedMainchain(),
            da_mode="sampled", da_proofs=proofs, da_samples=7,
            da_parity=1.0, **kw)
        das = node.das_service
        assert isinstance(das, pk.service.DASService)
        assert (das.proof_mode, das.samples, das.parity_ratio) == \
            (proofs, 7, 1.0)
        netstore = node.service(pk.netstore.NetStore)
        assert das.store is netstore.store
        if actor == "proposer":
            assert node.service(pk.proposer.Proposer).das is das
        if actor == "notary":
            notary = node.service(pk.notary.Notary)
            assert (notary.das, notary.da_mode) == (das, "sampled")
        names.append([type(s).__name__ for s in node.services])
    assert names[0] == names[1]


def test_full_node_has_no_das_plane():
    node = PORT.backend.ShardNode(actor="notary",
                                  backend=PORT.chain.SimulatedMainchain(),
                                  **PORT_NODE)
    assert node.das_service is None and node.da_mode == "full"
    assert "NetStore" not in [type(s).__name__ for s in node.services]
    assert node.service(PORT.notary.Notary).das is None


def test_node_da_options_checked_like_reference():
    for kw in ({"da_mode": "partial"}, {"da_proofs": "zk"}):
        errors = []
        for pk, node_kw in ((PORT, PORT_NODE), (REF, REF_NODE)):
            with pytest.raises(ValueError) as exc:
                pk.backend.ShardNode(**node_kw, **kw)
            errors.append(str(exc.value))
        assert errors[0] == errors[1]


def test_sampled_node_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the node would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.backend.ShardNode(actor="notary", da_mode="sampled",
                               da_proofs="poly")


_DA_FLAGS = ("da_mode", "da_proofs", "da_samples", "da_parity")


def test_cli_parses_the_da_flags_with_reference_defaults():
    def actions(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, type(parser._subparsers._group_actions[0])))
        return {a.dest: a for a in sub.choices["sharding"]._actions}

    port, ref = actions(cli.build_parser()), actions(r_build_parser())
    for dest in _DA_FLAGS:
        for attr in ("option_strings", "default", "choices", "type"):
            assert getattr(port[dest], attr) == getattr(ref[dest], attr), \
                (dest, attr)
    argv = ["sharding", "--actor", "notary", "--da-mode", "sampled",
            "--da-proofs", "poly", "--da-samples", "8", "--da-parity", "1"]
    got = cli.build_parser().parse_args(argv)
    want = r_build_parser().parse_args(argv)
    assert [getattr(got, d) for d in _DA_FLAGS] == \
        [getattr(want, d) for d in _DA_FLAGS] == ["sampled", "poly", 8, 1.0]
    defaults = cli.build_parser().parse_args(["sharding"])
    assert [getattr(defaults, d) for d in _DA_FLAGS] == \
        ["full", "merkle", 16, 0.5]


def test_cli_sampled_poly_node_loop_on_the_cpu(caplog):
    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "notary", "--deposit", "--runtime", "1.5",
         "--blocktime", "0.02", "--periodlength", "2", "--da-mode",
         "sampled", "--da-proofs", "poly"])
    with caplog.at_level(logging.INFO, logger="sharding"):
        assert cli.run_sharding_node(args, device="cpu") == 0
    text = caplog.text
    assert "da=sampled/poly" in text and "period 1 sealed" in text
    assert "service error" not in text


# -- the sampled devnet -------------------------------------------------------

_JAX_FREE = r'''
import json, sys
sys.modules["jax"] = None
sys.modules["gethsharding_tpu"] = None
import torch
torch.set_num_threads(2)
import torch_node_script as script
m = script.modules("gethsharding_tpu_torch")
out = script.run(m, script.cpu_config(m), script.CPU_POOL, %d,
                 {"sig_backend": "torch", "device": "cpu"},
                 da_proofs="merkle", hostile=%r)
bad = sorted(n for n, mod in sys.modules.items() if mod is not None
             and (n in ("jax", "gethsharding_tpu") or n.startswith("jax.")
                  or n.startswith("gethsharding_tpu.")))
print("RESULTS " + json.dumps({"summaries": script.jsonable(
    out["summaries"]), "bad": bad}))
''' % (PERIODS, HOSTILE)

_M_PORT = script.modules("gethsharding_tpu_torch")
_M_REF = script.modules("gethsharding_tpu")


@pytest.fixture(scope="module")
def jax_free_run():
    """The port's sampled devnet in a fresh interpreter that cannot import
    jax or the JAX package; started with the in-process devnet so that it
    runs beside it."""
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
    return script.run(_M_PORT, script.cpu_config(_M_PORT), script.CPU_POOL,
                      PERIODS, PORT_NODE, da_proofs="merkle",
                      hostile=HOSTILE,
                      finale=lambda env: script.das_light_check(_M_PORT, env))


@pytest.fixture(scope="module")
def ref_devnet():
    return script.run(_M_REF, script.cpu_config(_M_REF), script.CPU_POOL,
                      PERIODS, REF_NODE, da_proofs="merkle",
                      hostile=HOSTILE,
                      finale=lambda env: script.das_light_check(_M_REF, env))


def test_sampled_devnet_matches_reference_after_every_period(port_devnet,
                                                             ref_devnet):
    assert port_devnet["layout"] == ref_devnet["layout"]
    port = script.jsonable(port_devnet["summaries"])
    ref = script.jsonable(ref_devnet["summaries"])
    assert sorted(port) == [str(p) for p in range(1, PERIODS + 2)]
    for period in port:
        assert sorted(port[period]) == sorted(ref[period])
        for key in ref[period]:
            assert port[period][key] == ref[period][key], (period, key)


def test_sampled_devnet_answers(port_devnet):
    """The known answers: the notary votes on its honest shards only,
    each verdict held by its samples (the windback's too); the withheld
    and the garbage shard get no vote and one error each; no body request
    leaves the notary; the proposers published every collation; the
    audits and the observer's replays run as in full mode."""
    layout, summaries = port_devnet["layout"], port_devnet["summaries"]
    assert sorted(layout["hostile"].values()) == sorted(HOSTILE)
    want = script.sampled_expected(
        layout, script.cpu_config(_M_PORT).period_length, PERIODS)
    honest, hostile = want["honest"], want["hostile"]
    assert honest and hostile
    last = summaries[PERIODS + 1]
    assert last["notary"]["votes_submitted"] == len(honest)
    assert last["notary"]["canonical_set"] == 0
    assert last["notary"]["audits_run"] == PERIODS
    assert last["notary"]["audit_mismatches"] == 0
    das = last["das"]
    # the honest votes' own verdicts and their windback periods
    assert [tuple(v) for v in das["verdicts"]] == want["held"]
    assert das["notary_body_requests"] == 0
    assert das["counters"]["samples_fetched"] == \
        das["counters"]["samples_verified"] > 0
    assert das["counters"]["multiproofs_fetched"] == 0
    assert set(das["published"].values()) == {PERIODS}
    errors = {k: v for k, v in last["errors"].items() if v}
    assert errors == {"notary": [
        f"collation body unavailable for shard {s} period {p}"
        for s, p in hostile]}
    assert last["observer"]["txs_replayed"] == PERIODS


def test_sampled_devnet_light_node_das_checks(port_devnet, ref_devnet):
    """A sampled light node joining each devnet after the last audit:
    `das_check` True on a proposer's shard, False on the withheld one, as
    the reference's gives."""
    port, ref = port_devnet["finale"], ref_devnet["finale"]
    assert port == ref
    assert (port["honest"], port["withheld"]) == (True, False)
    assert port["samples_verified"] > 0 and port["proofs_rejected"] > 0
    assert port["errors"] == []


def test_jax_free_sampled_devnet_run(jax_free_run, port_devnet):
    out, err = jax_free_run.communicate(timeout=900)
    assert jax_free_run.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULTS "))
    got = json.loads(line[len("RESULTS "):])
    assert got["bad"] == []
    assert got["summaries"] == script.jsonable(port_devnet["summaries"])
