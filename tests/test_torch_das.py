"""The port's DAS sample verifier (gethsharding_tpu_torch/das/proofs.py,
csrc/das.cu), its batched keccak (ops/keccak.py) and the notary's vote
phase on the port, against the JAX package, on the CPU:

1. `keccak256_fixed` against the reference's `keccak_jax.keccak256_fixed`
   and the host keccak at 32, 40, 64, 135, 136 and 200 bytes (one and two
   blocks);
2. the port's scalar copies (`bmt_hash`, `chunk_key`, `chunk_leaf`, the
   merkle tree and proofs, `verify_samples`) against the reference's;
3. `marshal_samples` planes byte-equal to the reference's, and
   `verify_planes` (the plain version) against the reference's jitted
   `batch_verifier()` and the scalar truth, on honest rows and every
   hostile kind: a flipped chunk byte, a wrong sibling, a flipped index
   bit, a proof of 9 levels, a 4095-byte chunk, a ragged sibling, an
   index outside the proven tree, a wrong root, a withheld sample;
4. `csrc/das.cu` compiled for the host (tests/torch_host_shim.py, one
   thread per block) against `verify_planes` on the same rows and on a
   partial bucket;
5. `TorchSigBackend(device="cpu").das_verify_samples` against the
   reference `python` and `jax` backends, with its wire ledger, on the
   hostile set, the empty batch and a 1-row batch;
6. the reference's `Notary.verify_proposer_signatures` and
   `_sampled_verdicts` (merkle mode) on `TorchSigBackend(device="cpu")`,
   equal to the `python` backend's on a period with a forged proposer
   signature, a withheld chunk and a shard without a commitment.

Inputs come from seeded generators; everything is bytes and integers, so
every comparison is exact."""

import ctypes
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_host_shim
from gethsharding_tpu.crypto import secp256k1 as ref_ecdsa
from gethsharding_tpu.crypto.keccak import keccak256
from gethsharding_tpu.das import proofs as rproofs
from gethsharding_tpu.das.erasure import extend_body
from gethsharding_tpu.ops import keccak_jax
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu.storage import bmt as rbmt
from gethsharding_tpu.storage.chunker import chunk_key as ref_chunk_key
from gethsharding_tpu_torch.das import proofs
from gethsharding_tpu_torch.das.erasure import (DAS_CHUNK_SIZE,
                                               MAX_TOTAL_CHUNKS)
from gethsharding_tpu_torch.ops.keccak import keccak256_fixed
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend
from gethsharding_tpu_torch.storage.bmt import bmt_hash
from gethsharding_tpu_torch.storage.chunker import chunk_key

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)


# == 1. batched keccak =======================================================


@pytest.mark.parametrize("length", [32, 40, 64, 135, 136, 200])
def test_keccak256_fixed_equals_reference(length):
    rng = np.random.default_rng(200 + length)
    data = rng.integers(0, 256, (3, 2, length)).astype(np.uint8)
    got = keccak256_fixed(torch.as_tensor(data))
    assert got.dtype == torch.uint8 and got.shape == (3, 2, 32)
    want = np.asarray(keccak_jax.keccak256_fixed(jnp.asarray(data)))
    assert (got.numpy() == want).all()
    assert [bytes(d) for d in got.numpy().reshape(6, 32)] == \
        [keccak256(bytes(m)) for m in data.reshape(6, length)]


# == 2. the scalar copies ====================================================


def _blob(seed: int, size: int):
    """An extended blob's chunks, its commitment tree and root."""
    rng = random.Random(seed)
    xb = extend_body(bytes(rng.randrange(256) for _ in range(size)))
    levels = proofs.merkle_levels([proofs.chunk_leaf(c) for c in xb.chunks])
    return xb.chunks, levels, levels[-1][0]


def test_scalar_copies_equal_reference():
    assert (DAS_CHUNK_SIZE, MAX_TOTAL_CHUNKS) == (4096, 255)
    rng = random.Random(3)
    for n in (0, 1, 31, 32, 33, 100, 2048, 4095, 4096):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert bmt_hash(data) == rbmt.bmt_hash(data)
        assert chunk_key(n, data) == ref_chunk_key(n, data)
    chunks, levels, root = _blob(5, 20000)
    assert levels == rproofs.merkle_levels(
        [rproofs.chunk_leaf(c) for c in chunks])
    for i in (0, 3, len(chunks) - 1):
        assert proofs.merkle_proof(levels, i) == \
            rproofs.merkle_proof(levels, i)


def _sample_rows():
    """(chunks, indices, proofs, roots, labels): honest samples of two
    blobs and one row of every hostile kind."""
    rows = []
    for seed, size in ((11, 9000), (12, 30000)):
        chunks, levels, root = _blob(seed, size)
        for i in random.Random(seed).sample(range(len(chunks)), 3):
            rows.append((chunks[i], i, proofs.merkle_proof(levels, i), root,
                         "honest"))
    chunks, levels, root = _blob(13, 30000)
    good = proofs.merkle_proof(levels, 2)
    chunk = chunks[2]
    flipped = bytes([chunk[0] ^ 1]) + chunk[1:]
    wrong_sib = (good[0][:-1] + bytes([good[0][-1] ^ 0x80]),) + good[1:]
    rows += [
        (flipped, 2, good, root, "flipped chunk byte"),
        (chunk, 2, wrong_sib, root, "wrong sibling"),
        (chunk, 3, good, root, "flipped index bit"),
        (chunk, 2, good + (b"\x00" * 32,) * (9 - len(good)), root,
         "9 levels"),
        (chunk[:-1], 2, good, root, "4095-byte chunk"),
        (chunk, 2, (b"\x00" * 31,) + good[1:], root, "ragged sibling"),
        (chunk, 2 + (1 << len(good)), good, root, "outside the tree"),
        (chunk, 2, good, b"\x02" * 32, "wrong root"),
        (b"", 2, (), root, "withheld"),
    ]
    return tuple(map(list, zip(*rows)))


@pytest.fixture(scope="module")
def samples():
    *rows, labels = _sample_rows()
    want = rproofs.verify_samples(*rows)
    assert want == [label == "honest" for label in labels]
    return rows, labels, want


def test_scalar_verdicts_equal_reference(samples):
    rows, _, want = samples
    assert proofs.verify_samples(*rows) == want


# == 3. the planes and the plain verifier ====================================

BUCKET = 16     # the backend's bucket of the 15 hostile rows


@pytest.fixture(scope="module")
def planes(samples):
    rows, _, _ = samples
    got = proofs.marshal_samples(*rows, BUCKET)
    want = rproofs.marshal_samples(*rows, BUCKET)
    return got, want


def test_marshal_planes_equal_reference(planes):
    got, want = planes
    assert got["rows"] == want["rows"] == 15
    for key in proofs.PLANES:
        assert got[key].dtype == want[key].dtype
        assert got[key].shape == want[key].shape
        assert (got[key] == want[key]).all(), key


@pytest.fixture(scope="module")
def plain_verdicts(planes):
    got, _ = planes
    return proofs.verify_planes(*(torch.as_tensor(got[k])
                                  for k in proofs.PLANES))


def test_plain_verifier_equals_reference(samples, planes, plain_verdicts):
    _, _, want = samples
    _, ref_planes = planes
    ref_out = np.asarray(rproofs.batch_verifier()(
        *(ref_planes[k] for k in proofs.PLANES)))
    assert plain_verdicts.dtype == torch.bool
    assert (plain_verdicts.numpy() == ref_out).all()
    assert plain_verdicts[:15].tolist() == want
    assert not plain_verdicts[15:].any()


# == 4. the kernel source, compiled for the host =============================

_RUNNER = r"""
extern "C" void run(const unsigned char* chunks, const unsigned char* sibs,
                    const unsigned char* bits, const unsigned char* levels,
                    const unsigned char* roots, const unsigned char* valid,
                    int n, unsigned char* out) {
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    gs::das_kernel(chunks, sibs, bits, levels, roots, valid, out);
  }
}"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return torch_host_shim.build(tmp_path_factory.mktemp("das_kernel"),
                                 "das.cu", _RUNNER)


def _on_host(lib, plane_map, n):
    arrs = [np.ascontiguousarray(plane_map[k][:n]) for k in proofs.PLANES]
    out = np.zeros(n, np.uint8)
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.run(*map(ptr, arrs), n, ptr(out))
    return out.astype(bool)


@pytest.mark.parametrize("rows", [15, 16, 4])
def test_das_source_on_host_equals_plain(host_kernel, planes, plain_verdicts,
                                         rows):
    """The hostile set, the whole bucket (its pad rows are invalid), and
    the first 4 rows alone."""
    got, _ = planes
    assert (_on_host(host_kernel, got, rows)
            == plain_verdicts[:rows].numpy()).all()


def test_sample_permutations_count_the_work():
    assert proofs.sample_permutations(8) == 264
    assert proofs.ROUND_OPS == 180
    assert proofs.PERMUTATION_OPS == 24 * proofs.ROUND_OPS


# == 5. the backend ==========================================================


def test_backend_verifies_as_the_reference_backends(samples):
    rows, _, want = samples
    backend = TorchSigBackend(device="cpu")
    assert backend.das_verify_samples(*rows) == want
    assert ref_get_backend("jax").das_verify_samples(*rows) == want
    wire = backend.last_wire
    assert wire["op"] == "das_verify_samples"
    assert wire["rows"] == 15 and wire["bucket"] == BUCKET
    assert wire["sample_wire_bytes"] == wire["wire_bytes"] == \
        BUCKET * (DAS_CHUNK_SIZE + 8 * 32 + 8 + 8 + 32 + 1)
    assert backend.last_timing["rows"] == 15


def test_backend_empty_and_one_row_batches(samples):
    rows, _, _ = samples
    backend = TorchSigBackend(device="cpu")
    assert backend.das_verify_samples([], [], [], []) == []
    assert backend.last_wire is None
    one = [r[:1] for r in rows]
    want = ref_get_backend("python").das_verify_samples(*one)
    assert want == [True]
    assert ref_get_backend("jax").das_verify_samples(*one) == want
    assert backend.das_verify_samples(*one) == want
    assert backend.last_wire["bucket"] == 1


# == 6. the notary's vote phase on the port ==================================


class _DAS:
    """The notary's DAS service seam, serving rows made up front (as
    `DASService.collect_rows` returns them, a withheld sample as an
    empty chunk and proof; None where no commitment was found)."""

    proof_mode = "merkle"

    def __init__(self, rows_by_shard):
        self.rows_by_shard = rows_by_shard
        self.failures = 0

    def prefetch_commitments(self, pairs):
        pass

    def collect_rows(self, shard_id, period, record, account):
        rows = self.rows_by_shard[shard_id]
        return None if rows is None else {k: list(v) for k, v in rows.items()}

    def note_verdicts(self, verdicts):
        bad = sum(1 for v in verdicts if not v)
        self.failures += bad
        return bad


class _Record:
    def __init__(self, chunk_root, proposer, signature):
        self.chunk_root = chunk_root
        self.proposer = proposer
        self.signature = signature


def _vote_period():
    """Four shards of one period: honest; a forged proposer signature; a
    withheld sampled chunk; no DAS commitment."""
    from gethsharding_tpu.core.types import CollationHeader
    from gethsharding_tpu.utils.hexbytes import Hash32

    period, records, das_rows = 7, [], {}
    for shard in range(4):
        priv = 0xC0FFEE + shard
        proposer = ref_ecdsa.priv_to_address(priv)
        root = Hash32(keccak256(b"chunk-root-%d" % shard))
        digest = bytes(CollationHeader(shard_id=shard, chunk_root=root,
                                       period=period,
                                       proposer_address=proposer).hash())
        signer = priv + 1 if shard == 1 else priv
        sig = ref_ecdsa.sign(digest, signer).to_bytes65()
        records.append((shard, period, _Record(root, proposer, sig)))
        chunks, levels, das_root = _blob(40 + shard, 9000)
        picked = [0, 2] if shard != 2 else [1, 3]
        rows = {"chunks": [chunks[i] for i in picked], "indices": picked,
                "proofs": [proofs.merkle_proof(levels, i) for i in picked],
                "roots": [das_root] * len(picked)}
        if shard == 2:
            rows["chunks"][1], rows["proofs"][1] = b"", ()
        das_rows[shard] = None if shard == 3 else rows
    return records, das_rows


def _notary(backend, das_rows):
    from gethsharding_tpu.actors.notary import Notary
    from gethsharding_tpu.core.shard import Shard
    from gethsharding_tpu.db.kv import MemoryKV
    from gethsharding_tpu.mainchain.client import SMCClient
    from gethsharding_tpu.smc.chain import SimulatedMainchain

    return Notary(client=SMCClient(backend=SimulatedMainchain()),
                  shard=Shard(0, MemoryKV()), sig_backend=backend,
                  das=_DAS(das_rows), da_mode="sampled")


def test_notary_vote_phase_on_the_port():
    """Phase 2 (proposer signatures) and phase 3 (sampled availability)
    of the reference notary give the `python` backend's verdicts on
    `TorchSigBackend(device="cpu")`."""
    records, das_rows = _vote_period()
    python = _notary(ref_get_backend("python"), das_rows)
    want_sigs = python.verify_proposer_signatures(records)
    want_da = python._sampled_verdicts(records)
    assert want_sigs == [True, False, True, True]
    assert want_da == {0: True, 1: True, 2: False, 3: False}

    backend = TorchSigBackend(device="cpu")
    notary = _notary(backend, das_rows)
    assert notary.verify_proposer_signatures(records) == want_sigs
    assert backend.last_timing["rows"] == 4
    assert notary._sampled_verdicts(records) == want_da
    assert backend.last_wire["rows"] == 6      # 2 samples x 3 shards
    assert notary.das.failures == python.das.failures == 1
