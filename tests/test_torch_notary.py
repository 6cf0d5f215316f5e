"""The port's notary service and what it runs against (the scalar SMC, the
simulated mainchain, the client, the mirror's bulk reads, the shard DB)
held against the JAX package's, on the CPU:

1. the scalar `SMC`: both machines run the same seeded sequence of
   registrations, deregistrations, releases, headers and votes, reverts
   mixed in; after each call the state, the events and the revert message
   are equal. The same from a mid-life state carried over by
   `convert.smc_from_fields`. Each quirk of the contract has its own case;
2. the chain, the client and the notary through one scripted notary life
   (`tests/torch_notary_script.py`: hostile rows with known answers) on
   each package's chain, the reference's notary on its `python` backend,
   the port's on `TorchSigBackend(device="cpu")`: block hashes, receipts,
   committee contexts, `audit_data`, head audits, `audit_periods`,
   counters, errors, vote words, the shard DB's canonical headers, and
   `verify_period_batch` (the port on the CPU, the reference in JAX on the
   CPU), tampered logs included;
3. the refusals: a stopped client, a remote wire form, no
   card;
4. the same script in a subprocess where `jax` and `gethsharding_tpu`
   cannot be imported, started with the module so it runs beside the
   rest: the known answers, and results equal to the in-process run's.

Heads are driven synchronously; no test waits on the wall clock.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

import torch_notary_script as script
from gethsharding_tpu.crypto import bn256 as ref_bls
from gethsharding_tpu.crypto.keccak import keccak256 as ref_keccak
from gethsharding_tpu.params import Config as RConfig
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu.smc import state_machine as ref_sm
from gethsharding_tpu.utils.hexbytes import Address20 as RAddress20
from gethsharding_tpu.utils.hexbytes import Hash32 as RHash32
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.actors.notary import Notary
from gethsharding_tpu_torch.core.shard import Shard
from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.db.kv import MemoryKV
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.params import Config
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend
from gethsharding_tpu_torch.smc import state_machine as sm
from gethsharding_tpu_torch.smc.chain import SimulatedMainchain
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

_JAX_FREE = r'''
import json, sys
sys.modules["jax"] = None
sys.modules["gethsharding_tpu"] = None
import torch
torch.set_num_threads(2)
import torch_notary_script as script
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend
out = script.run(script.modules("gethsharding_tpu_torch"),
                 TorchSigBackend(device="cpu"), {"device": "cpu"})
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "gethsharding_tpu") or m.startswith("jax.")
                  or m.startswith("gethsharding_tpu.")))
print("RESULTS " + json.dumps({"summary": script.jsonable(out["summary"]),
                               "bad": bad}))
'''


@pytest.fixture(scope="module", autouse=True)
def jax_free_run():
    """The port's side of the script in a fresh interpreter that cannot
    import jax or the JAX package; started with the module so that it runs
    beside its other tests."""
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
def ref_run():
    # the reference's head in its overlapped form, the port's only one
    with mock.patch.dict(os.environ, {"GETHSHARDING_NOTARY_OVERLAP": "1"}):
        return script.run(script.modules("gethsharding_tpu"),
                          ref_get_backend("python"), {})


@pytest.fixture(scope="module")
def port_run():
    return script.run(script.modules("gethsharding_tpu_torch"),
                      TorchSigBackend(device="cpu"), {"device": "cpu"})


# == 1. the scalar SMC ========================================================

SMC_CFG = dict(shard_count=4, committee_size=6, quorum_size=2,
               period_length=5, notary_lockup_length=1)
ADDRS = [ref_keccak(b"smc-sender-%d" % i)[:20] for i in range(8)]
# a few BLS pubkeys and PoPs, the same points in both packages' types
_KEYS = [bls.bls_keygen(b"smc-key-%d" % i) for i in range(3)]
_PK = [pk for _, pk in _KEYS]
_POP = [bls.bls_prove_possession(sk, pk) for sk, pk in _KEYS]


def _ref_g2(pt):
    return (ref_bls.Fp2(pt[0].a, pt[0].b), ref_bls.Fp2(pt[1].a, pt[1].b))


def _blockhash(n: int) -> bytes:
    return ref_keccak(b"smc-block" + n.to_bytes(8, "big"))


def _machines():
    ref = ref_sm.SMC(RConfig(**SMC_CFG),
                     blockhash_fn=lambda n: RHash32(_blockhash(n)))
    port = sm.SMC(Config(**SMC_CFG),
                  blockhash_fn=lambda n: Hash32(_blockhash(n)))
    return ref, port


def _both(ref, port, op: str, *args, **kwargs):
    """Apply one call to both machines (the reference's arguments through
    `_to_ref`): [ref outcome, port outcome], each a return value or
    ("revert", exception name, message)."""
    out = []
    for machine, conv in ((ref, _to_ref), (port, lambda v: v)):
        try:
            out.append(getattr(machine, op)(
                *map(conv, args), **{k: conv(v) for k, v in kwargs.items()}))
        except (ref_sm.SMCRevert, sm.SMCRevert) as exc:
            out.append(("revert", type(exc).__name__, str(exc)))
    return out


def _to_ref(v):
    """A call argument in the reference's types (addresses, roots, G2
    points; the calls are made in the port's)."""
    if isinstance(v, Address20):
        return RAddress20(bytes(v))
    if isinstance(v, Hash32):
        return RHash32(bytes(v))
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], bls.Fp2):
        return _ref_g2(v)
    return v


def _sampled(machine, block: int) -> list:
    """(sender, shard) pairs where a deposited notary is the sampled
    committee member at `block`."""
    pairs = []
    for addr, entry in machine.notary_registry.items():
        for shard in range(machine.shard_count):
            try:
                if machine.get_notary_in_committee_view(
                        addr, shard, block) == addr:
                    pairs.append((Address20(bytes(addr)), shard))
            except (ref_sm.SMCRevert, sm.SMCRevert):
                return []  # sample size zero
    return pairs


def _random_op(rng: random.Random, machine, block: int):
    """A plausible call with reverts mixed in: (name, args, kwargs), in the
    port's types (`_to_ref` converts them for the reference)."""
    sender = Address20(rng.choice(ADDRS))
    kind = rng.choice(["register", "register", "deregister", "release",
                       "header", "header", "vote", "vote", "vote"])
    if kind == "register":
        k = rng.randrange(len(_KEYS))
        value = machine.config.notary_deposit if rng.random() < 0.9 else 1
        kw = {}
        if rng.random() < 0.7:
            kw = {"bls_pubkey": _PK[k],
                  "bls_pop": _POP[k] if rng.random() < 0.9 else None}
        return "register_notary", (sender, value, block), kw
    if kind == "deregister":
        return "deregister_notary", (sender, block), {}
    if kind == "release":
        return "release_notary", (sender, block), {}
    period = block // machine.config.period_length
    shard = rng.randrange(-1, machine.shard_count + 1)
    if kind == "header":
        root = Hash32(ref_keccak(b"root-%d-%d" % (shard, rng.randrange(3))))
        return ("add_header",
                (sender, shard, period + rng.choice([0, 0, 0, 1]), root,
                 b"sig", block), {})
    # a vote: mostly by a sampled member at its pool index, signed
    sampled = [(a, sh) for a, sh in _sampled(machine, block)
               if (sh, period) in machine.collation_records]
    if sampled and rng.random() < 0.8:
        sender, shard = rng.choice(sampled)
    entry = machine.notary_registry.get(sender)
    index = entry.pool_index if entry is not None else rng.randrange(8)
    if rng.random() < 0.15:
        index = rng.randrange(-1, machine.config.committee_size + 1)
    rec = machine.collation_records.get((shard, period))
    root = (Hash32(bytes(rec.chunk_root))
            if rec is not None and rng.random() < 0.9
            else Hash32(ref_keccak(b"other")))
    kw = {}
    if entry is not None and entry.bls_pubkey is not None \
            and rng.random() < 0.9:
        kw = {"bls_sig": bls.g1_mul(index + 2, bls.G1_GEN)}
    return "submit_vote", (sender, shard, period, index, root, block), kw


def _run_ops(ref, port, rng, steps: int, block: int) -> int:
    """`steps` random calls, the block advancing, on the reference alone
    (`port` None) or on both, compared after each call. Returns the block
    reached."""
    for _ in range(steps):
        block += rng.choice([0, 0, 0, 0, 0, 1, 1, 2, 5])
        name, args, kw = _random_op(rng, port or ref, block)
        if port is None:
            try:
                getattr(ref, name)(*map(_to_ref, args),
                                   **{k: _to_ref(v) for k, v in kw.items()})
            except ref_sm.SMCRevert:
                pass
            continue
        got_ref, got_port = _both(ref, port, name, *args, **kw)
        if isinstance(got_ref, tuple):
            assert got_port[0] == "revert" and got_port[2] == got_ref[2], \
                (name, got_ref, got_port)
        else:
            assert got_ref == got_port, name
        assert convert.smc_fields(port) == convert.smc_fields(ref), name
    return block


@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_smc_matches_reference(seed):
    """The same seeded calls on both machines: equal state, events and
    revert messages after every call."""
    ref, port = _machines()
    rng = random.Random(seed)
    _run_ops(ref, port, rng, 300, 0)
    assert len(port.events) > 40
    assert sum(e.name == "VoteSubmitted" for e in port.events) > 5


def test_scalar_smc_from_a_carried_state():
    """A reference machine driven to mid-life alone, carried across by
    `convert.smc_from_fields`, then both driven on: equal throughout."""
    ref, _ = _machines()
    rng = random.Random(7)
    block = _run_ops(ref, None, rng, 200, 0)
    fields = convert.smc_fields(ref)
    assert fields["records"] and fields["registry"] and fields["events"]
    port = convert.smc_from_fields(
        fields, Config(**SMC_CFG), blockhash_fn=lambda n: Hash32(_blockhash(n)))
    assert convert.smc_fields(port) == fields
    _run_ops(ref, port, rng, 200, block)


def _registered(n: int, block: int = 0):
    ref, port = _machines()
    for i in range(n):
        _both(ref, port, "register_notary", Address20(ADDRS[i]),
              port.config.notary_deposit, block)
    return ref, port


def test_quirk_last_freed_slot_unreachable():
    """stackPop needs a stack top > 1 (.sol:262): with one freed slot a
    registration reverts; after a second, it takes the last freed slot and
    the first stays unreachable."""
    ref, port = _registered(4)
    _both(ref, port, "deregister_notary", Address20(ADDRS[1]), 1)
    got = _both(ref, port, "register_notary", Address20(ADDRS[5]),
                port.config.notary_deposit, 1)
    assert got[0][2] == got[1][2] == "stackPop: emptySlotsStackTop <= 1"
    _both(ref, port, "deregister_notary", Address20(ADDRS[2]), 1)
    _both(ref, port, "register_notary", Address20(ADDRS[5]),
          port.config.notary_deposit, 1)
    assert port.notary_registry[Address20(ADDRS[5])].pool_index == 2
    assert port.notary_pool[1] is None and port.empty_slots_stack_top == 1
    assert convert.smc_fields(port) == convert.smc_fields(ref)


def test_quirk_mutating_committee_view():
    """get_notary_in_committee updates the sample size inside a
    transaction (.sol:175-186); the view form leaves it."""
    ref, port = _registered(3)
    block = 2 * port.config.period_length
    # each registration moved the current size to the previous next size
    assert port.current_period_notary_sample_size == 2
    got = _both(ref, port, "get_notary_in_committee_view",
                Address20(ADDRS[0]), 1, block)
    assert bytes(got[0]) == bytes(got[1])
    assert port.current_period_notary_sample_size == 2
    assert convert.smc_fields(port) == convert.smc_fields(ref)
    got = _both(ref, port, "get_notary_in_committee", Address20(ADDRS[0]),
                1, block)
    assert bytes(got[0]) == bytes(got[1])
    assert port.current_period_notary_sample_size == 3
    assert port.sample_size_last_updated_period == 2
    assert convert.smc_fields(port) == convert.smc_fields(ref)


def _voting_setup():
    """Three notaries with BLS keys, a header on every shard in period 1,
    and a notary sampled for one: (ref, port, voter, shard, index, root,
    block)."""
    ref, port = _machines()
    for i in range(3):
        _both(ref, port, "register_notary", Address20(ADDRS[i]),
              port.config.notary_deposit, 0, bls_pubkey=_PK[i],
              bls_pop=_POP[i])
    block = port.config.period_length
    root = Hash32(ref_keccak(b"quirk-root"))
    for shard in range(port.shard_count):
        _both(ref, port, "add_header", Address20(ADDRS[7]), shard, 1, root,
              b"", block)
    voter, shard = _sampled(port, block)[0]
    index = port.notary_registry[voter].pool_index
    return ref, port, voter, shard, index, root, block


def test_quirk_signed_vote_index_is_pool_index():
    """A signed vote's index must be the sender's pool index (:380-388)."""
    ref, port, voter, shard, index, root, block = _voting_setup()
    other = (index + 1) % 3
    sig = bls.g1_mul(5, bls.G1_GEN)
    got = _both(ref, port, "submit_vote", voter, shard, 1, other, root,
                block, bls_sig=sig)
    assert got[0][2] == got[1][2] == \
        "signed vote index must be the sender's pool index"
    assert convert.smc_fields(port) == convert.smc_fields(ref)


def test_quirk_packed_vote_word():
    """castVote (:410): bit 255 - index, then the count in the low byte."""
    ref, port, voter, shard, index, root, block = _voting_setup()
    _both(ref, port, "submit_vote", voter, shard, 1, index, root, block,
          bls_sig=bls.g1_mul(5, bls.G1_GEN))
    word = (1 << (255 - index)) + 1
    assert port.current_vote[shard] == ref.current_vote[shard] == word
    assert port.get_vote_count(shard) == 1
    assert port.has_voted(shard, index)
    assert convert.smc_fields(port) == convert.smc_fields(ref)


# == 2. the chain, the client and the notary ==================================

_HEADERS = [
    dict(),
    dict(shard_id=0, period=0),
    dict(shard_id=3, chunk_root=b"\x11" * 32, period=7,
         proposer_address=b"\x22" * 20),
    dict(shard_id=99, chunk_root=b"\x00" * 32, period=1 << 40,
         proposer_address=b"\x00" * 20, proposer_signature=b"\x33" * 65),
]


@pytest.mark.parametrize("fields", _HEADERS)
def test_collation_header_bytes_match_reference(fields):
    """Encodings, hashes and decodes equal the reference's byte for byte,
    unset fields and zero values included; so does the signing digest the
    notary recovers proposers from."""
    from gethsharding_tpu.core import types as ref_types
    from gethsharding_tpu_torch.core import types

    conv = lambda cls: {k: (cls[0](v) if k == "chunk_root" else
                            cls[1](v) if k == "proposer_address" else v)
                        for k, v in fields.items()}
    ref = ref_types.CollationHeader(**conv((RHash32, RAddress20)))
    port = types.CollationHeader(**conv((Hash32, Address20)))
    assert port.encode_rlp() == ref.encode_rlp()
    assert bytes(port.hash()) == bytes(ref.hash())
    back = types.CollationHeader.decode_rlp(port.encode_rlp())
    assert back.encode_rlp() == ref_types.CollationHeader.decode_rlp(
        ref.encode_rlp()).encode_rlp()
    if port.chunk_root is None or port.proposer_address is None:
        return
    # the digest the notary recovers a proposer from: the header's hash
    # with an empty signature
    record = sm.CollationRecord(chunk_root=port.chunk_root,
                                proposer=port.proposer_address,
                                signature=port.proposer_signature)
    digests, sigs = Notary._proposer_sig_inputs(
        [(port.shard_id, port.period, record)])
    unsigned = ref_types.CollationHeader(
        shard_id=ref.shard_id, chunk_root=ref.chunk_root, period=ref.period,
        proposer_address=ref.proposer_address)
    assert digests == [bytes(unsigned.hash())]
    assert sigs == [ref.proposer_signature]


@pytest.mark.parametrize("size", [0, 1, 31, 32, 62, 300])
def test_bodies_and_chunk_roots_match_reference(size):
    """The blob codec, the body's transactions, the chunk root and the
    shard DB's lookup keys equal the reference's."""
    import importlib

    from gethsharding_tpu.core import shard as ref_shard
    from gethsharding_tpu.core import types as ref_types
    from gethsharding_tpu_torch.core import derive_sha, shard, types

    # the reference's package re-exports a function under the module's name
    ref_derive = importlib.import_module("gethsharding_tpu.core.derive_sha")
    rng = random.Random(size)
    payload = bytes(rng.randrange(256) for _ in range(size))
    txs = [types.Transaction(nonce=i, gas_price=i + 1, gas_limit=21000,
                             to=Address20(b"\x05" * 20), value=size,
                             payload=payload[i:]) for i in range(3)]
    ref_txs = [ref_types.Transaction(
        nonce=t.nonce, gas_price=t.gas_price, gas_limit=t.gas_limit,
        to=RAddress20(bytes(t.to)), value=t.value, payload=t.payload)
        for t in txs]
    body = types.serialize_txs_to_blob(txs)
    assert body == ref_types.serialize_txs_to_blob(ref_txs)
    assert [t.encode_rlp() for t in types.deserialize_blob_to_txs(body)] \
        == [t.encode_rlp() for t in ref_types.deserialize_blob_to_txs(body)]
    for data in (payload, body):
        assert derive_sha.chunk_root(data) == ref_derive.chunk_root(data)
    root = Hash32(derive_sha.chunk_root(body))
    assert bytes(shard.data_availability_lookup_key(root)) == bytes(
        ref_shard.data_availability_lookup_key(RHash32(bytes(root))))
    assert bytes(shard.canonical_collation_lookup_key(size, 3)) == bytes(
        ref_shard.canonical_collation_lookup_key(size, 3))


def test_chain_rollback_import_and_checkpoint_match_reference():
    """`set_head`, `import_chain` of a longer branch and a checkpoint
    installed on a follower: the same block hashes and SMC state as the
    reference's chain through the same calls."""
    from gethsharding_tpu.smc.chain import SimulatedMainchain as RChain

    chains = (RChain(RConfig(shard_count=2)),
              SimulatedMainchain(Config(shard_count=2)))
    addr = ref_keccak(b"chain-sender")[:20]
    out = []
    for chain, a in zip(chains, (RAddress20(addr), Address20(addr))):
        chain.fund(a)
        chain.register_notary(a)
        chain.fast_forward(2)
        branch = chain.blocks[4:]
        chain.set_head(3)
        assert chain.notary_registry(a) is not None
        adopted = chain.import_chain(branch)
        follower = type(chain)(chain.config)
        follower.import_chain(chain.blocks[1:])
        assert follower.install_checkpoint(chain.state_checkpoint())
        out.append((adopted, [bytes(b.hash) for b in chain.blocks],
                    [bytes(b.hash) for b in follower.blocks],
                    convert.smc_fields(chain.smc),
                    convert.smc_fields(follower.smc),
                    chain.reorg_generation, chain.state_seq()))
    assert out[0] == out[1]
    assert out[1][0] == 7 and out[1][3] == out[1][4]


_STOPPED_CALLS = {
    "read": lambda c: c.current_period(),
    "write": lambda c: c.register_notary(),
    "sign": lambda c: c.sign(b"\x01" * 32),
    "wait": lambda c: c.wait_for_transaction(Hash32(b"\x02" * 32)),
}


@pytest.mark.parametrize("call", sorted(_STOPPED_CALLS))
def test_stopped_client_refuses(call):
    """Every read, write, signature and transaction wait of a stopped
    client raises `ClientStopped`; a restarted client answers again."""
    from gethsharding_tpu_torch.mainchain.client import ClientStopped

    client = _client()
    client.backend.fund(client.account())
    client.stop()
    assert client.stopped
    with pytest.raises(ClientStopped):
        _STOPPED_CALLS[call](client)
    client.start()
    if call != "wait":
        _STOPPED_CALLS[call](client)


def test_tracer_spans_nest_and_cost_nothing_off():
    """Spans nest under the context's open span and feed a trace/<name>
    timer; with tracing off every span is the shared no-op."""
    from gethsharding_tpu_torch import metrics, tracing

    assert tracing.span("notary/audit") is tracing.NOOP_SPAN
    registry = metrics.Registry()
    tracer = tracing.enable(ring_spans=8, registry=registry)
    try:
        tracer.clear()
        with tracing.span("notary/notarize"):
            with tracing.span("notary/audit", rows=3):
                pass
    finally:
        tracing.disable()
    inner, outer = tracer.recent_spans()
    assert (inner["name"], outer["name"]) == ("notary/audit",
                                              "notary/notarize")
    assert inner["parent"] == outer["span"] and inner["tags"] == {"rows": 3}
    assert registry.timer("trace/notary/audit").count == 1


def test_chain_and_client_match_reference(ref_run, port_run):
    ref, port = ref_run["summary"], port_run["summary"]
    for key in ("blocks", "receipts", "contexts", "audit_data", "words",
                "shard_db"):
        assert port[key] == ref[key], key
    assert len(port["blocks"]) == 21 and len(port["receipts"]) > 20
    # period 1 shard 0: every member voted, the notary last
    votes = port["audit_data"][1][0]["votes"]
    assert [v[0] for v in votes] == [0, 1, 2, 4, 3]


def test_notary_matches_reference(ref_run, port_run):
    """Head audits, `audit_periods`, counters, errors and canonical
    headers: the known answers, on both packages."""
    ref, port = ref_run["summary"], port_run["summary"]
    for summary in (ref, port):
        assert summary["heads"] == script.HEAD_AUDITS
        assert summary["audit_periods"] == script.AUDIT_PERIODS
    for key in ("head_counters", "counters", "errors"):
        assert port[key] == ref[key], key
    assert port["head_counters"] == {
        "votes_submitted": 2, "signatures_rejected": 1, "canonical_set": 1,
        "audits_run": 2, "audit_mismatches": 2,
        "aggregate_sigs_verified": 8}
    assert port["counters"]["audit_mismatches"] == 4
    assert port["errors"][:2] == [
        "proposer signature invalid: shard 2 period 1",
        "collation body unavailable for shard 3 period 2"]
    # the notary's own shard: its period-1 header is canonical
    notary, kv = port_run["notary"], port_run["kv"]
    canonical = notary.shard.canonical_header_hash(script.OWN_SHARD, 1)
    record = port_run["chain"].collation_record(script.OWN_SHARD, 1)
    assert canonical == notary._reconstruct_header(
        script.OWN_SHARD, 1, record).hash()
    assert kv.has(bytes(canonical))


def test_verify_period_batch_matches_reference(ref_run, port_run):
    """The port's replay (CPU) and the reference's (JAX on the CPU): True
    on the voted period, None for the churned and the empty one, False
    for a tampered final vote word and for an altered elected flag."""
    assert ref_run["summary"]["replay"] == script.REPLAY
    assert port_run["summary"]["replay"] == script.REPLAY
    for key in ("words", "elected"):
        got = []
        for run, kw in ((ref_run, {}), (port_run, {"device": "cpu"})):
            final = run["chain"]._vote_audit[1]["final"][key]
            shard = min(final)
            saved = final[shard]
            final[shard] = saved ^ 1 if key == "words" else not saved
            try:
                got.append(run["chain"].verify_period_batch(1, **kw))
            finally:
                final[shard] = saved
        assert got == [False, False], key
    assert port_run["chain"].verify_period_batch(1, device="cpu") is True


def test_notary_replays_on_its_backends_device(port_run):
    """The port's notary runs `verify_period_batch` on its backend's
    device: True on the honest period 1 (no replay error in the head
    audit), False on a tampered log, counted as a mismatch."""
    notary, chain = port_run["notary"], port_run["chain"]
    assert not any("batch-replay" in e for e in notary.errors)
    calls = []
    replay = chain.verify_period_batch

    def spy(period, device=None):
        calls.append(device)
        return replay(period, device=device)

    final = chain._vote_audit[1]["final"]["words"]
    shard = min(final)
    saved = final[shard]
    final[shard] = saved ^ (1 << 200)
    before = notary.audit_mismatches
    chain.verify_period_batch = spy
    try:
        assert notary.audit_periods([1]) == {1: False}
    finally:
        chain.verify_period_batch = replay
        final[shard] = saved
    assert calls == [torch.device("cpu")]
    assert notary.audit_mismatches == before + 1
    assert notary.errors[-1] == ("period 1 batch-replay mismatch: "
                                 "submit_votes_batch disagrees with the "
                                 "scalar SMC")


def test_audit_periods_overlapped(port_run):
    """The pipelined form gives the batched form's results."""
    notary = port_run["notary"]
    before = notary.audit_mismatches
    assert notary.audit_periods([1, 2, 3], overlap=True) == \
        script.AUDIT_PERIODS
    assert notary.audit_mismatches == before + 2


# == 3. the refusals ==========================================================

def _client(cfg=Config(shard_count=2)):
    return SMCClient(backend=SimulatedMainchain(cfg), config=cfg)


def test_default_backend_is_the_card():
    if torch.cuda.is_available():
        notary = Notary(client=_client(), shard=Shard(0, MemoryKV()))
        assert notary.sig_backend.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Notary(client=_client(), shard=Shard(0, MemoryKV()))


@pytest.mark.parametrize("sealed", [True, False])
def test_vote_that_misses_the_period_is_counted(sealed):
    """A vote the chain reverts with 'period is not current' after it
    sealed the period's last block is a missed vote: counted in
    `notary/votes_missed`, no service error. The same revert inside the
    period is a service error, as any other revert is."""
    from types import SimpleNamespace

    cfg = Config(shard_count=2, period_length=5)
    client = _client(cfg)
    notary = Notary(client=client, shard=Shard(0, MemoryKV()),
                    sig_backend=TorchSigBackend(device="cpu"), config=cfg)
    period = 3
    client.notary_registry = lambda *a: SimpleNamespace(deposited=True,
                                                        pool_index=0)
    client.has_voted = lambda *a: False
    client.bls_sign = lambda digest: None

    def revert(*args, **kw):
        raise sm.SMCRevert("period is not current")

    client.submit_vote = revert
    # the pending block is the next period's first when the period's last
    # block is sealed; else still one of this period's
    last = (period + 1) * cfg.period_length - 1
    head = property(lambda self: last if sealed else last - 1)
    record = SimpleNamespace(chunk_root=Hash32(b"\x11" * 32), signature=b"")
    with mock.patch.object(SMCClient, "block_number", head):
        before = notary.m_votes_missed.value
        assert notary.submit_vote(1, period, record,
                                  availability=True) is False
        counted = notary.m_votes_missed.value - before
    assert (notary.votes_missed, counted, notary.errors) == (
        (1, 1, []) if sealed
        else (0, 0, ["vote reverted: period is not current"]))


def test_wire_form_audit_data_refuses():
    """A remote chain's hex wire form (`shard_auditData`, `rpc/codec.py`)
    and the in-process raw form give the same audit rows; a released
    voter's row (no pubkey) is skipped in both."""
    from gethsharding_tpu_torch.rpc import codec

    sks = [bls.bls_keygen(b"wire-audit-%d" % j) for j in range(3)]
    root = Hash32(b"\x5a" * 32)
    digest = sm.vote_digest(1, 4, root)
    raw_votes = [{"index": j, "signer": Address20(bytes([j + 1]) * 20),
                  "sig": bls.bls_sign(bytes(digest), sk), "pubkey": pk}
                 for j, (sk, pk) in enumerate(sks)]
    released = [dict(raw_votes[0], pubkey=None)]
    raw = {"period": 4, "raw": True, "shards": {
        1: {"chunk_root": bytes(root), "vote_count": 3, "is_elected": True,
            "votes": raw_votes},
        0: {"chunk_root": bytes(root), "vote_count": 1, "is_elected": False,
            "votes": released}}}
    wire = {"period": 4, "shards": {
        shard: {**rec, "chunk_root": rec["chunk_root"].hex(),
                "votes": [{"index": v["index"],
                           "signer": bytes(v["signer"]).hex(),
                           "sig": codec.enc_g1(v["sig"]),
                           "pubkey": codec.enc_g2(v["pubkey"])}
                          for v in rec["votes"]]}
        for shard, rec in raw["shards"].items()}}
    rows = []
    for data in (raw, json.loads(json.dumps(wire))):
        client = _client()
        data = dict(data, shards={int(k): v for k, v in
                                  data["shards"].items()})
        client.audit_data = lambda period, data=data: data
        notary = Notary(client=client, shard=Shard(0, MemoryKV()),
                        sig_backend=TorchSigBackend(device="cpu"))
        rows.append(notary._collect_audit_rows(4))
    assert rows[0] == rows[1]
    assert rows[0]["shards"] == [1] and rows[0]["msgs"] == [digest]


# == 4. the port's notary with jax absent ====================================

def test_jax_free_notary_run(jax_free_run, port_run):
    out, err = jax_free_run.communicate(timeout=600)
    assert jax_free_run.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULTS "))
    got = json.loads(line[len("RESULTS "):])
    assert got["bad"] == []
    summary = got["summary"]
    want = json.loads(json.dumps({
        "heads": script.HEAD_AUDITS, "audit_periods": script.AUDIT_PERIODS,
        "replay": script.REPLAY}))
    for key, value in want.items():
        assert summary[key] == value, key
    # the same results as the in-process run's
    assert summary == script.jsonable(port_run["summary"])
