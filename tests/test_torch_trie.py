"""The port's trie family (`gethsharding_tpu_torch.core`: `trie.py` with its
proofs and `SecureTrie`, `trie_db.py`, the compiled root of `mpt.py`, and
`derive_sha.py`'s native route, `poc_root` and chunk proofs) held against
the JAX package's, on the CPU, on the same seeded inputs, bytes equal:

1. the trie: `prove` node lists on random tries, each package's
   `verify_proof` on the other's proofs, tampered and absence proofs,
   `get` and `delete` over seeded operation sequences (roots after every
   operation), `SecureTrie`, each node's encoding kept until it changes;
2. `TrieDatabase` commit, dereference and load and `TrieSync`: the same
   roots and node counts, on the memory and the SQLite store;
3. the compiled root (`core/mpt.py`): against the port's Python trie and
   the reference's `native.mpt_root` on the empty list, 1, 63 and 64
   items, every rlp(uint) key boundary from 127 to 300, duplicate keys,
   values of 55-64 bytes, lists over the caps (the Python route), the state
   tables of `tests/torch_replay_rows.py`, and (`-m slow`) a 1 MiB body;
   many threads at once; the build of two sources into one library;
4. `derive_sha`'s routes, `poc_root` and the chunk proofs.
"""

import hashlib
import importlib
import threading

import numpy as np
import pytest

import torch_replay_rows
from gethsharding_tpu import native as rnative
from gethsharding_tpu.core import state_processor as rsp
from gethsharding_tpu.core import trie as rtrie
from gethsharding_tpu.core import trie_db as rtrie_db
from gethsharding_tpu.core.types import Transaction as RTransaction
from gethsharding_tpu.crypto import secp256k1 as rsecp
from gethsharding_tpu.db.kv import MemoryKV as RMemoryKV
from gethsharding_tpu.db.kv import SqliteKV as RSqliteKV
from gethsharding_tpu.utils.hexbytes import Address20 as RAddress20
from gethsharding_tpu_torch import core
from gethsharding_tpu_torch.core import derive_sha as ds
from gethsharding_tpu_torch.core import mpt
from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core import trie
from gethsharding_tpu_torch.core import trie_db
from gethsharding_tpu_torch.core.types import Collation, CollationHeader
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.crypto import hostlib
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.db.kv import MemoryKV, SqliteKV
from gethsharding_tpu_torch.utils.hexbytes import Address20
from gethsharding_tpu_torch.utils.rlp import int_to_big_endian, rlp_encode

# the module: the JAX package's `core` exports a function of that name
rds = importlib.import_module("gethsharding_tpu.core.derive_sha")


def _pairs(seed: int, n: int, max_key: int = 8, max_val: int = 64) -> list:
    """`n` seeded (key, value) pairs: short random keys (shared prefixes
    likely, so extensions and embedded nodes occur) and values of 1 to
    `max_val` bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        key = bytes(rng.integers(0, 256, int(rng.integers(1, max_key + 1)),
                                 dtype=np.uint8))
        val = bytes(rng.integers(0, 256, int(rng.integers(1, max_val + 1)),
                                 dtype=np.uint8))
        out.append((key, val))
    return out


def _both(pairs):
    """The port's and the reference's trie over the same pairs."""
    port, ref = trie.Trie(), rtrie.Trie()
    for k, v in pairs:
        port.update(k, v)
        ref.update(k, v)
    return port, ref


def _python_root(pairs) -> bytes:
    t = trie.Trie()
    for k, v in pairs:
        t.update(k, v)
    return t.root_hash()


# == 1. the trie ==============================================================

@pytest.mark.parametrize("seed", range(4))
def test_prove_gives_the_reference_node_lists(seed):
    pairs = _pairs(seed, 40 + 30 * seed)
    port, ref = _both(pairs)
    assert port.root_hash() == ref.root_hash()
    absent = [k for k, _ in _pairs(100 + seed, 20)]
    for key in [k for k, _ in pairs] + absent + [b"", b"\x00" * 9]:
        assert port.prove(key) == ref.prove(key), key.hex()


@pytest.mark.parametrize("seed", range(3))
def test_each_verify_proof_takes_the_other_packages_proofs(seed):
    pairs = dict(_pairs(10 + seed, 60))
    port, ref = _both(pairs.items())
    root = port.root_hash()
    for key in list(pairs) + [k for k, _ in _pairs(200 + seed, 10)]:
        want = pairs.get(key)
        assert trie.verify_proof(root, key, ref.prove(key)) == want
        assert rtrie.verify_proof(root, key, port.prove(key)) == want


def test_tampered_and_absence_proofs_behave_as_the_reference():
    pairs = _pairs(7, 50)
    port, ref = _both(pairs)
    root = port.root_hash()
    key = pairs[3][0]
    proof = port.prove(key)
    cases = {
        "first byte": [b"\x00" + proof[0][1:]] + proof[1:],
        "last node": proof[:-1] + [proof[-1][:-1] + b"\x01"],
        "truncated": proof[:-1],
        "trailing": proof + [proof[-1]],
    }
    for name, bad in cases.items():
        if bad == proof:
            continue
        outcomes = []
        for verify in (trie.verify_proof, rtrie.verify_proof):
            try:
                outcomes.append(("value", verify(root, key, bad)))
            except ValueError:
                outcomes.append(("raised", None))
        assert outcomes[0] == outcomes[1], name
    # a changed byte of a hashed node always raises
    with pytest.raises(ValueError):
        trie.verify_proof(root, key, cases["first byte"])
    # absence: a key that is not there is proven absent
    missing = b"\xff" * 12
    assert trie.verify_proof(root, missing, port.prove(missing)) is None
    assert rtrie.verify_proof(root, missing, port.prove(missing)) is None
    # the empty trie proves every absence with no node; a non-empty root
    # takes no empty proof
    assert trie.verify_proof(trie.EMPTY_ROOT, key, []) is None
    with pytest.raises(ValueError):
        trie.verify_proof(root, key, [])
    with pytest.raises(ValueError):
        rtrie.verify_proof(root, key, [])


@pytest.mark.parametrize("seed", range(4))
def test_get_and_delete_follow_the_reference(seed):
    """Seeded sequences of inserts, updates, deletes (present and absent
    keys) and empty-value updates: roots equal after every operation, and
    `get` equal on every key seen."""
    rng = np.random.default_rng(1000 + seed)
    keys = [k for k, _ in _pairs(2000 + seed, 30, max_key=4)]
    port, ref = trie.Trie(), rtrie.Trie()
    for step in range(300):
        key = keys[int(rng.integers(len(keys)))]
        op = int(rng.integers(10))
        if op < 5:
            val = bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                     dtype=np.uint8))
            port.update(key, val)
            ref.update(key, val)
        elif op < 9:
            port.delete(key)
            ref.delete(key)
        else:
            port.update(key, b"")
            ref.update(key, b"")
        assert port.root_hash() == ref.root_hash(), step
    for key in keys:
        assert port.get(key) == ref.get(key)
    # a trie emptied by deletes is the empty trie
    for key in keys:
        port.delete(key)
    assert port.root_hash() == trie.EMPTY_ROOT


def test_secure_trie_matches_the_reference():
    port, ref = trie.SecureTrie(), rtrie.SecureTrie()
    pairs = _pairs(31, 80, max_key=20)
    for k, v in pairs:
        port.update(k, v)
        ref.update(k, v)
    assert port.root_hash() == ref.root_hash()
    for k, _ in pairs[:10]:
        assert port.get(k) == ref.get(k)
        assert port.prove(k) == ref.prove(k)
    for k, _ in pairs[::3]:
        port.delete(k)
        ref.delete(k)
    assert port.root_hash() == ref.root_hash()


def test_nodes_keep_their_encodings_until_changed(monkeypatch):
    """A node is encoded once until an update or delete changes it: after
    the root, proofs encode nothing anew, an update re-encodes only its
    path, and the roots stay the reference's. (The JAX package's trie
    encodes the whole trie again on every proof.)"""
    pairs = [(rlp_encode(int_to_big_endian(i)), rlp_encode(i % 256))
             for i in range(4096)]
    port, ref = _both(pairs)
    assert port.root_hash() == ref.root_hash()
    encoded = []
    real = trie.rlp_encode
    monkeypatch.setattr(trie, "rlp_encode",
                        lambda item: encoded.append(1) or real(item))
    for key, _ in pairs[::97]:
        assert port.prove(key) == ref.prove(key)
    assert encoded == []
    port.update(pairs[5][0], b"\x07")
    ref.update(pairs[5][0], b"\x07")
    assert port.root_hash() == ref.root_hash()
    assert 0 < len(encoded) <= 8          # the path from the leaf up
    del encoded[:]
    port.delete(pairs[6][0])
    ref.delete(pairs[6][0])
    assert port.root_hash() == ref.root_hash() and len(encoded) <= 8


# == 2. the node database =====================================================

def _nodes(kv) -> int:
    return sum(1 for _ in kv.keys(b"trie-node:"))


@pytest.mark.parametrize("engine", ["memory", "sqlite"])
def test_trie_database_follows_the_reference(engine, tmp_path):
    """Two versions of a trie sharing most of their nodes: commit both,
    load each back, drop the first (only its own nodes go), then the
    second; node counts and roots equal the reference's at every step."""
    make = {"memory": (MemoryKV, RMemoryKV),
            "sqlite": (lambda: SqliteKV(str(tmp_path / "port.db")),
                       lambda: RSqliteKV(str(tmp_path / "ref.db")))}[engine]
    dbs = trie_db.TrieDatabase(make[0]()), rtrie_db.TrieDatabase(make[1]())
    pairs = _pairs(41, 120)
    v1 = _both(pairs)
    v2 = _both(pairs[:100] + _pairs(42, 15))
    roots = []
    for db, t1, t2 in zip(dbs, v1, v2):
        roots.append((db.commit(t1), db.commit(t2)))
    assert roots[0] == roots[1]
    r1, r2 = roots[0]
    counts = lambda: [_nodes(db.kv) for db in dbs]
    assert counts()[0] == counts()[1] > 0
    for db in dbs:
        assert db.load(r1).root_hash() == r1
        assert db.load(r2).root_hash() == r2
    assert trie.Trie.__name__ == type(dbs[0].load(r1)).__name__
    deleted = [db.dereference(r1) for db in dbs]
    assert deleted[0] == deleted[1] > 0 and counts()[0] == counts()[1]
    assert dbs[0].load(r2).root_hash() == r2
    with pytest.raises(KeyError):
        dbs[0].load(r1)
    deleted = [db.dereference(r2) for db in dbs]
    assert deleted[0] == deleted[1] and counts() == [0, 0]
    assert dbs[0].commit(trie.Trie()) == trie.EMPTY_ROOT
    assert counts() == [0, 0]


def test_trie_sync_follows_the_reference():
    """Pull a committed trie into an empty database and into one holding
    an older version: the fetched node counts, node counts and roots equal
    the reference's; a blob that fails its hash raises."""
    pairs = _pairs(51, 150)
    port_src, ref_src = (trie_db.TrieDatabase(), rtrie_db.TrieDatabase())
    t_port, t_ref = _both(pairs)
    root = port_src.commit(t_port)
    assert ref_src.commit(t_ref) == root
    old_port, old_ref = _both(pairs[:120])
    got = []
    for make_db, src, old in ((trie_db.TrieDatabase, port_src, None),
                              (rtrie_db.TrieDatabase, ref_src, None),
                              (trie_db.TrieDatabase, port_src, old_port),
                              (rtrie_db.TrieDatabase, ref_src, old_ref)):
        db = make_db()
        if old is not None:
            db.commit(old)
        sync = (trie_db.TrieSync if make_db is trie_db.TrieDatabase
                else rtrie_db.TrieSync)(db)
        fetched = sync.run(root, src.node)
        assert db.load(root).root_hash() == root
        got.append((fetched, _nodes(db.kv), sync.missing(root)))
    assert got[0] == got[1] and got[2] == got[3]
    assert got[2][0] < got[0][0]     # the overlap is not fetched again
    with pytest.raises(ValueError):
        trie_db.TrieSync(trie_db.TrieDatabase()).run(
            root, lambda h: b"\xc0")
    assert core.TrieDatabase is trie_db.TrieDatabase
    assert core.TrieSync is trie_db.TrieSync


# == 3. the compiled root =====================================================

def _index_items(n: int):
    keys = [rlp_encode(int_to_big_endian(i)) for i in range(n)]
    vals = [rlp_encode(i % 256) for i in range(n)]
    return keys, vals


@pytest.mark.parametrize("n", [0, 1, 63, 64, 127, 128, 129, 255, 256, 257,
                               300])
def test_mpt_root_on_index_lists(n):
    """Every rlp(uint) key shape: 1-byte keys up to 127, 2-byte 128-255,
    3-byte from 256."""
    keys, vals = _index_items(n)
    got = mpt.mpt_root(keys, vals)
    assert got == _python_root(zip(keys, vals)) == rnative.mpt_root(keys,
                                                                     vals)


def test_mpt_root_on_every_length_from_127_to_300():
    for n in range(127, 301):
        keys, vals = _index_items(n)
        assert mpt.mpt_root(keys, vals) == rnative.mpt_root(keys, vals), n
    keys, vals = _index_items(300)
    assert mpt.mpt_root(keys, vals) == _python_root(zip(keys, vals))


@pytest.mark.parametrize("seed", range(3))
def test_mpt_root_on_random_pairs_and_duplicates(seed):
    pairs = _pairs(300 + seed, 400)
    pairs += [(k, v[::-1] + b"!") for k, v in pairs[::7]]  # later wins
    keys, vals = [k for k, _ in pairs], [v for _, v in pairs]
    got = mpt.mpt_root(keys, vals)
    assert got == _python_root(pairs) == rnative.mpt_root(keys, vals)


@pytest.mark.parametrize("vlen", range(55, 65))
def test_mpt_root_on_long_string_values(vlen):
    """Values of 56 bytes and more take RLP's long-string form."""
    pairs = [(bytes([i]), bytes([i]) * vlen) for i in range(70)]
    keys, vals = [k for k, _ in pairs], [v for _, v in pairs]
    assert mpt.mpt_root(keys, vals) == _python_root(pairs) \
        == rnative.mpt_root(keys, vals)


def test_lists_over_the_caps_take_the_python_route():
    over_key = [(b"k" * 33, b"v")] + _pairs(61, 70)
    over_val = [(b"k", b"v" * 129)] + _pairs(62, 70)
    for pairs in (over_key, over_val):
        keys, vals = [k for k, _ in pairs], [v for _, v in pairs]
        assert mpt.mpt_root(keys, vals) is None
        assert rnative.mpt_root(keys, vals) is None
    # derive_sha's items beyond the value cap: the Python trie builds it
    items = [b"\xb8\x80" + bytes(128)] * 64
    before = ds.m_python_roots.value
    assert ds.derive_sha(items) == rds.derive_sha(items)
    assert ds.m_python_roots.value == before + 1


def test_state_roots_of_the_replay_tables():
    """The genesis tables of `tests/torch_replay_rows.py` and the states
    after its scalar replay: the native route, the Python trie and the
    reference's root agree."""
    txs, genesis, coinbases = torch_replay_rows.batch(
        sp, Transaction, ecdsa, Address20)
    rtxs, rgenesis, rcoinbases = torch_replay_rows.batch(
        rsp, RTransaction, rsecp, RAddress20)
    before = sp.m_native_state_roots.value
    checked = 0
    for shard in range(len(genesis)):
        state = sp.ShardState({a: sp.AccountState(s.nonce, s.balance)
                               for a, s in genesis[shard].items()})
        rstate = rsp.ShardState({a: rsp.AccountState(s.nonce, s.balance)
                                 for a, s in rgenesis[shard].items()})
        for _ in range(2):
            got = sp.state_trie_root(state.accounts)
            assert got == sp.python_state_trie_root(state.accounts)
            assert bytes(got) == bytes(rsp.state_trie_root(rstate.accounts))
            checked += 1
            sp.process(state, txs[shard], coinbases[shard])
            rsp.process(rstate, rtxs[shard], rcoinbases[shard])
    assert sp.m_native_state_roots.value - before == checked
    assert sp.state_trie_root({}) == trie.EMPTY_ROOT


def test_mpt_root_on_many_threads_at_once():
    """The builder's sort reads a per-thread context: threads building
    different roots at once (ctypes releases the interpreter lock around
    the call) each get their own list's root."""
    lists = [_index_items(200 + 37 * i) for i in range(8)]
    want = [_python_root(zip(k, v)) for k, v in lists]
    wrong = []

    def work(i):
        keys, vals = lists[i % len(lists)]
        for _ in range(25):
            if mpt.mpt_root(keys, vals) != want[i % len(lists)]:
                wrong.append(i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []


def test_two_sources_build_into_one_library(tmp_path):
    """`hostlib.build` over a list: one library exporting both sources'
    symbols, stamped with the hash of the sources in order, and not built
    again while they are unchanged."""
    import ctypes

    sources = [hostlib.SRC_DIR / "keccak.c", hostlib.SRC_DIR / "mpt.c"]
    lib = hostlib.build(sources, tmp_path / "libmpt.so")
    loaded = ctypes.CDLL(str(lib))
    assert loaded.gs_keccak256 and loaded.gs_mpt_root
    h = hashlib.sha256()
    for s in sources:
        h.update(s.read_bytes())
    stamp = tmp_path / "libmpt.so.sha256"
    assert stamp.read_text().strip() == h.hexdigest()
    mtime = lib.stat().st_mtime_ns
    assert hostlib.build(sources, tmp_path / "libmpt.so") == lib
    assert lib.stat().st_mtime_ns == mtime
    assert mpt.native_available()


@pytest.mark.slow
def test_one_mebibyte_chunk_root():
    """The protocol's collation size cap (`collation.go:45`): the native
    route of each package on a 1 MiB body."""
    body = bytes(range(256)) * (2 ** 20 // 256)
    assert ds.chunk_root(body) == rds.chunk_root(body)


# == 4. derive_sha ============================================================

def test_derive_sha_routes_by_length(monkeypatch):
    """63 items build in Python, 64 in C; with the builder unavailable the
    Python trie builds every list, to the same roots."""
    for n, route in ((63, ds.m_python_roots), (64, ds.m_native_roots),
                     (300, ds.m_native_roots)):
        items = [rlp_encode(i % 256) for i in range(n)]
        before = route.value
        assert ds.derive_sha(items) == rds.derive_sha(items)
        assert route.value == before + 1
    monkeypatch.setattr(mpt, "_native", lambda: None)
    items = [rlp_encode(i % 256) for i in range(300)]
    before = ds.m_python_roots.value
    assert ds.derive_sha(items) == rds.derive_sha(items)
    assert ds.m_python_roots.value == before + 1


@pytest.mark.parametrize("size", [0, 1, 31, 64, 700])
def test_poc_root_matches_the_reference(size):
    rng = np.random.default_rng(size)
    body = bytes(rng.integers(0, 256, size, dtype=np.uint8))
    for salt in (b"", b"\x01", b"salt-of-custody!" * 2):
        assert ds.poc_root(body, salt) == rds.poc_root(body, salt)
    col = Collation(header=CollationHeader(shard_id=1, period=2), body=body)
    assert bytes(col.calculate_poc(b"s")) == rds.poc_root(body, b"s")


def test_chunk_proofs_match_the_reference():
    body = bytes(range(256)) * 3 + b"tail-of-the-collation"
    root = ds.chunk_root(body)
    assert root == rds.chunk_root(body)
    for index in (0, 1, 127, 128, 255, 256, len(body) - 1, len(body),
                  len(body) + 40):
        proof = ds.chunk_proof(body, index)
        assert proof == rds.chunk_proof(body, index)
        want = body[index] if index < len(body) else None
        assert ds.verify_chunk(root, index, proof) == want
        assert rds.verify_chunk(root, index, proof) == want
    with pytest.raises(ValueError):
        ds.chunk_proof(body, -1)
    proof = ds.chunk_proof(body, 5)
    with pytest.raises(ValueError):
        ds.verify_chunk(root, 5, [b"\x00" + proof[0][1:]] + proof[1:])
    # the proof tries: one a body, an LRU of 4
    bodies = [body + bytes([i]) for i in range(6)]
    for b in bodies:
        ds.chunk_proof(b, 0)
    assert len(ds._PROOF_TRIES) == 4
    assert ds._body_trie(bodies[-1]) is ds._body_trie(bodies[-1])
