"""DeriveSha: merklize an indexed list into a trie root, and the chunk
proofs over it (the port's copy of the JAX package's
`core/derive_sha.py`).

Parity with `core/types/derive_sha.go:32`: a trie mapping rlp(uint index)
-> item-RLP, returning the root hash. The collation chunk root
(`sharding/collation.go:115 CalculateChunkRoot`) applies it to the body's
bytes, one list entry a byte (`collation.go:210-220`). Lists of 64 items
or more take the compiled builder (`core/mpt.py`); the Python trie builds
the shorter ones, and every list where the builder is unavailable.

`chunk_proof` and `verify_chunk` prove one body byte under the chunk
root (`trie/proof.go`): what a light client (`actors/light.py`) checks
against the SMC's record and a syncer (`actors/syncer.py`) serves.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.core import mpt
from gethsharding_tpu_torch.core.trie import EMPTY_ROOT, Trie, verify_proof
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.rlp import (big_endian_to_int,
                                              int_to_big_endian, rlp_decode,
                                              rlp_encode)

# the lists the compiled builder takes: shorter ones cost the Python trie
# less than the packing
NATIVE_MIN_ITEMS = 64

# the roots built by each route (`chip_smoke.py` reads them)
m_native_roots = metrics.counter("trie/derive_sha/native_roots")
m_python_roots = metrics.counter("trie/derive_sha/python_roots")


def derive_sha(items: Sequence[bytes]) -> bytes:
    """Root hash over rlp(index) -> item (items are already RLP-encoded)."""
    if not items:
        return EMPTY_ROOT
    if len(items) >= NATIVE_MIN_ITEMS:
        root = mpt.mpt_root(_index_keys(len(items)), items)
        if root is not None:
            m_native_roots.inc()
            return root
    m_python_roots.inc()
    return python_derive_sha(items)


def python_derive_sha(items: Sequence[bytes]) -> bytes:
    """`derive_sha` built in the Python trie: its fallback, and its twin
    in the tests."""
    trie = Trie()
    for key, item in zip(_index_keys(len(items)), items):
        trie.update(key, item)
    return trie.root_hash()


def _index_keys(n: int) -> list:
    return [rlp_encode(int_to_big_endian(index)) for index in range(n)]


def chunk_root(body: bytes) -> bytes:
    """Chunk root of a serialized collation body (per-byte DeriveSha).

    `Chunks.GetRlp(i)` RLP-encodes the single byte body[i] as a uint (Go's
    `rlp.EncodeToBytes(byte)` takes writeUint), so 0x00 encodes as 0x80,
    not as a 1-byte string.
    """
    return derive_sha([rlp_encode(int(b)) for b in body])


def poc_root(body: bytes, salt: bytes) -> bytes:
    """Proof-of-custody root: the salt interleaved before every body byte
    (`Collation.CalculatePOC`, `sharding/collation.go:124-138`), over the
    salt alone for an empty body."""
    if len(body) == 0:
        salted = salt
    else:
        out = bytearray()
        for b in body:
            out += salt
            out.append(b)
        salted = bytes(out)
    return chunk_root(bytes(salted))


# -- on-demand chunk proofs (the les/light ODR building block) -------------

_PROOF_TRIES: "OrderedDict[bytes, Trie]" = OrderedDict()
_PROOF_TRIES_CAP = 4
_PROOF_TRIES_LOCK = threading.Lock()  # the serving threads of several nodes


def _body_trie(body: bytes) -> Trie:
    """The per-byte DeriveSha trie of a body, kept in an LRU of 4 keyed by
    the body's keccak: a light client samples many indices of one root,
    so the trie builds once a body. A caller serving untrusted requests
    bounds the body's size (`Syncer.PROOF_BODY_CAP`): the build is
    O(len(body)) in Python, and requests cycling roots thrash the LRU."""
    key = keccak256(body)
    with _PROOF_TRIES_LOCK:
        cached = _PROOF_TRIES.get(key)
        if cached is not None:
            _PROOF_TRIES.move_to_end(key)
            return cached
    trie = Trie()
    for index, byte in enumerate(body):
        trie.update(rlp_encode(int_to_big_endian(index)),
                    rlp_encode(int(byte)))
    with _PROOF_TRIES_LOCK:
        _PROOF_TRIES[key] = trie
        while len(_PROOF_TRIES) > _PROOF_TRIES_CAP:
            _PROOF_TRIES.popitem(last=False)
    return trie


def chunk_proof(body: bytes, index: int) -> list:
    """Merkle proof of byte `index` of `body` under its chunk root
    (`trie/proof.go Prove` over the DeriveSha trie). An index at or past
    the body's length yields a proof of absence: how a light client pins
    the body's length without downloading the body."""
    if index < 0:
        raise ValueError(f"negative index {index}")
    return _body_trie(body).prove(rlp_encode(int_to_big_endian(index)))


def verify_chunk(root: bytes, index: int, proof) -> Optional[int]:
    """Check a chunk proof against a chunk root anchored on the SMC;
    returns the proven byte, or None for a proven absence (an index
    outside the body). Raises ValueError on an invalid proof
    (`trie/proof.go VerifyProof`)."""
    value = verify_proof(bytes(root), rlp_encode(int_to_big_endian(index)),
                         list(proof))
    if value is None:
        return None
    return big_endian_to_int(rlp_decode(value))
