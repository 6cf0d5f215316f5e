"""The port's DAS polynomial multiproofs (gethsharding_tpu_torch/das/pcs.py,
das/poly_proofs.py, `TorchSigBackend.das_verify_multiproofs`) and its
host pairing (crypto/bn256.py), against the JAX package, on the CPU:

1. the port's dev SRS equals the reference's power for power (the
   reference's carried across by `convert.srs_from_reference`);
2. `chunk_value`, `commit`, `open_multi`, the G1 wire codec and
   `check_shape` give the reference's bytes, values and rejections on
   seeded values (the rejections of tests/test_das_poly.py among them);
3. the host pairing: `pairing_check` and `pairing_check_optimal` give the
   reference's answers and raise where it raises (a G1 point off the
   curve, a G2 point on the twist outside the order-n subgroup), and the
   scalar BLS face makes the reference's keys, signatures and proofs of
   possession;
4. the scalar `verify_multiproof` and `verify_multiproofs` equal the
   reference `python` backend on every row below; `marshal_multiproofs`
   gives the reference's planes limb for limb at bucket 16;
5. `TorchSigBackend(device="cpu").das_verify_multiproofs` equals the
   reference `python` and `jax` backends on the rows of
   tests/test_das_poly.py::_poly_rows, the hostile kinds of
   tests/torch_poly_rows.py that those lack (a commitment coordinate
   >= p, an all-zero proof on a non-constant polynomial, a set that opens
   every index: A and π at infinity) and the wire probes (an eval >= N,
   n = 0 and n = 257, 65 indices, indices holding a bool, a string or
   None, a 65-byte commitment), with its wire ledger; the empty batch; 1,
   8 and 9 rows, the bucket edges;
6. the reference notary's `--da-proofs poly` phase (`_poly_verdicts`) on
   the port: the `python` backend's verdicts and failure counts, with a
   shard without a commitment and one whose fetch failed.

Values come from seeded generators; everything is bytes and integers, so
every comparison is exact."""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_poly_rows
from test_das_poly import _poly_rows
from gethsharding_tpu.crypto import bn256 as ref_bls
from gethsharding_tpu.das import pcs as ref_pcs
from gethsharding_tpu.das import poly_proofs as ref_poly
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.das import pcs, poly_proofs
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.sigbackend import SigBackend, marshal
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

N = pcs.N


@pytest.fixture(scope="module")
def srs():
    """The reference's dev SRS, built once, and the port's copy of it."""
    ref_srs = ref_pcs.dev_srs()
    return ref_srs, convert.srs_from_reference(ref_srs)


def _values(seed: int, n: int) -> list:
    rng = random.Random(seed)
    return [rng.randrange(N) for _ in range(n)]


# == 1. the SRS ==============================================================


def test_dev_srs_equals_reference(srs):
    """The port derives the reference's τ and powers from the same seed
    (every node of a devnet must), under the same protocol knobs."""
    ref_srs, port = srs
    own = pcs.dev_srs()
    assert own == port
    assert (own.seed, own.tau, own.max_degree, own.max_set) == \
        (ref_srs.seed, ref_srs.tau, 255, 64)
    assert [bls.g1_mul(own.tau, bls.G1_GEN)] == list(own.g1_powers[1:2])
    assert pcs.dev_srs() is own        # built once per process


def test_srs_from_reference_keeps_infinity():
    small = ref_pcs.SRS(seed="s", tau=3, g1_powers=((1, 2), None),
                        g2_powers=(ref_bls.G2_GEN, None))
    got = convert.srs_from_reference(small)
    assert got == pcs.SRS(seed="s", tau=3, g1_powers=((1, 2), None),
                          g2_powers=(bls.G2_GEN, None))


# == 2. commitments, openings, the wire codec, shapes =======================


@pytest.mark.parametrize("size", [0, 1, 31, 4096])
def test_chunk_value_equals_reference(size):
    chunk = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    assert pcs.chunk_value(chunk) == ref_pcs.chunk_value(chunk)


@pytest.mark.parametrize("n", [1, 5, 255])
def test_commit_equals_reference(srs, n):
    ref_srs, port = srs
    values = _values(300 + n, n)
    got = pcs.g1_to_bytes(pcs.commit(values, port))
    assert got == ref_pcs.g1_to_bytes(ref_pcs.commit(values, ref_srs))
    with pytest.raises(ValueError):
        pcs.commit([0] * 257, port)
    with pytest.raises(ValueError):
        ref_pcs.commit([0] * 257, ref_srs)


@pytest.mark.parametrize("indices", [(0, 2, 5), (3,), (), tuple(range(8)),
                                     (7, 0, 4)])
def test_open_multi_equals_reference(srs, indices):
    ref_srs, port = srs
    values = _values(7, 8)
    proof, evals = pcs.open_multi(values, indices, port)
    want_proof, want_evals = ref_pcs.open_multi(values, indices, ref_srs)
    assert evals == want_evals
    assert pcs.g1_to_bytes(proof) == ref_pcs.g1_to_bytes(want_proof)


@pytest.mark.parametrize("indices", [(0, 0), (100,), (-1,),
                                     tuple(range(65))])
def test_open_multi_refuses_as_reference(srs, indices):
    ref_srs, port = srs
    values = _values(8, 100)
    with pytest.raises(ValueError) as got:
        pcs.open_multi(values, indices, port)
    with pytest.raises(ValueError) as want:
        ref_pcs.open_multi(values, indices, ref_srs)
    assert str(got.value) == str(want.value)


def _wire_probes():
    point = ref_pcs.g1_to_bytes(ref_pcs.commit(_values(19, 4)))
    x = int.from_bytes(point[:32], "big")
    return [point, b"\x00" * 64, b"\x01" * 63, b"\x01" * 64, b"",
            point + b"\x00", (x + ref_bls.P).to_bytes(32, "big") + point[32:],
            point[:32] + (ref_bls.P).to_bytes(32, "big"),
            bytearray(point)]


@pytest.mark.parametrize("raw", _wire_probes())
def test_g1_wire_codec_equals_reference(raw):
    try:
        want = ref_pcs.g1_from_bytes(raw)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            pcs.g1_from_bytes(raw)
        assert str(got.value) == str(exc)
        return
    point = pcs.g1_from_bytes(raw)
    assert point == want
    assert pcs.g1_to_bytes(point) == ref_pcs.g1_to_bytes(want)


_ONE, _TWO = [7], [7, 8]
_SHAPES = [
    ((2,), _ONE, 5), ((5,), _ONE, 5), ((-1,), _ONE, 5), ((2, 2), _TWO, 5),
    ((2,), _TWO, 5), ((2,), [N], 5), ((2,), [N - 1], 5), ((2,), _ONE, 0),
    ((2,), _ONE, 256), ((2,), _ONE, 257), (tuple(range(64)), [0] * 64, 200),
    (tuple(range(65)), [0] * 65, 200), ((), [], 5), ((True,), _ONE, 5),
    (("1",), _ONE, 5), ((None,), _ONE, 5), ((2,), ["x"], 5),
    ((2,), _ONE, "5"), ((2,), _ONE, None), ((2.5,), _ONE, 5),
    ("13", _TWO, 5),
]


@pytest.mark.parametrize("indices, evals, n", _SHAPES)
def test_check_shape_equals_reference(srs, indices, evals, n):
    """The domain preconditions, the rejections of
    tests/test_das_poly.py::test_domain_rejection_is_cheap_and_total
    among them: out-of-domain, negative, duplicate, ragged, an eval of N,
    n = 0, more indices than the SRS cap; and indices, evals and n of
    other types."""
    ref_srs, port = srs
    assert pcs.check_shape(indices, evals, n, port) == \
        ref_pcs.check_shape(indices, evals, n, ref_srs)


# == 3. the host pairing and the BLS face ===================================


def _fp2_sqrt(a):
    """A square root in Fp2 (p = 3 mod 4), or None."""
    P = bls.P
    norm = (a.a * a.a + a.b * a.b) % P
    s = pow(norm, (P + 1) // 4, P)
    if s * s % P != norm:
        return None
    for t in (s, -s % P):
        half = (a.a + t) * pow(2, -1, P) % P
        x0 = pow(half, (P + 1) // 4, P)
        if x0 * x0 % P != half or x0 == 0:
            continue
        root = bls.Fp2(x0, a.b * pow(2 * x0, -1, P) % P)
        if root * root == a:
            return root
    return None


def _twist_point_outside_subgroup():
    """A point on the twist E'(Fp2) whose order is not n (the twist has
    order n·(2p - n)): the first x = k + i with x³ + b' a square."""
    for k in range(1, 100):
        x = bls.Fp2(k, 1)
        y = _fp2_sqrt(x * x * x + bls.B2)
        if y is not None and not bls.g2_in_subgroup((x, y)):
            return (x, y)
    raise AssertionError("no twist point outside the subgroup found")


def _to_ref(q):
    return (ref_bls.Fp2(q[0].a, q[0].b), ref_bls.Fp2(q[1].a, q[1].b))


def test_pairing_check_raises_as_reference():
    q = _twist_point_outside_subgroup()
    assert bls.g2_is_on_curve(q) and ref_bls.g2_is_on_curve(_to_ref(q))
    assert not ref_bls.g2_in_subgroup(_to_ref(q))
    off_curve = (1, 1)
    assert not bls.g1_is_on_curve(off_curve)
    cases = [
        ((off_curve, bls.G2_GEN), (off_curve, ref_bls.G2_GEN),
         "pairing input not on curve"),
        ((bls.G1_GEN, q), (ref_bls.G1_GEN, _to_ref(q)),
         "G2 point not on curve or not in the order-n subgroup"),
    ]
    for port_pair, ref_pair, message in cases:
        for check, pair in ((bls.pairing_check, port_pair),
                            (bls.pairing_check_optimal, port_pair),
                            (ref_bls.pairing_check, ref_pair),
                            (ref_bls.pairing_check_optimal, ref_pair)):
            with pytest.raises(ValueError, match=message):
                check([pair])
    # a pair with a point at infinity is skipped before any check
    assert bls.pairing_check([(None, q), (off_curve, None)])


def test_pairing_check_equals_reference():
    """e(2·G1, G2)·e(−G1, 2·G2) == 1 and e(G1, G2)² != 1, through both
    Miller loops, and `miller_loop` before the final exponentiation."""
    two = bls.g1_mul(2, bls.G1_GEN)
    two2 = bls.g2_mul(2, bls.G2_GEN)
    good = [(two, bls.G2_GEN), (bls.g1_neg(bls.G1_GEN), two2)]
    bad = [(bls.G1_GEN, bls.G2_GEN), (bls.G1_GEN, bls.G2_GEN)]
    ref_pairs = lambda pairs: [(p, _to_ref(q)) for p, q in pairs]
    assert bls.pairing_check(good) and ref_bls.pairing_check(
        ref_pairs(good))
    assert not bls.pairing_check_optimal(bad)
    assert not ref_bls.pairing_check_optimal(ref_pairs(bad))
    f = bls.miller_loop(two2, two)
    want = ref_bls.miller_loop(_to_ref(two2), two)
    flat = lambda v: [c for c6 in (v.c0, v.c1) for c2 in (c6.c0, c6.c1, c6.c2)
                      for c in (c2.a, c2.b)]
    assert flat(f) == flat(want)


def test_bls_face_equals_reference():
    sk, pk = bls.bls_keygen(b"poly-bls")
    want_sk, want_pk = ref_bls.bls_keygen(b"poly-bls")
    assert sk == want_sk and _to_ref(pk) == want_pk
    sig = bls.bls_sign(b"header", sk)
    assert sig == ref_bls.bls_sign(b"header", sk)
    pop = bls.bls_prove_possession(sk, pk)
    assert pop == ref_bls.bls_prove_possession(want_sk, want_pk)
    sk2, pk2 = bls.bls_keygen(b"poly-bls-2")
    agg = bls.bls_aggregate_sigs([sig, bls.bls_sign(b"header", sk2)])
    assert agg == ref_bls.bls_aggregate_sigs(
        [sig, ref_bls.bls_sign(b"header", sk2)])
    assert _to_ref(bls.bls_aggregate_pks([pk, pk2])) == \
        ref_bls.bls_aggregate_pks([want_pk, _to_ref(pk2)])
    assert bls.bls_verify_aggregate(b"header", agg, [pk, pk2])
    assert not bls.bls_verify(b"other", sig, pk)
    assert not bls.bls_verify(b"header", None, pk)
    assert not bls.bls_verify_aggregate(b"header", agg, [])
    assert not bls.bls_verify_possession(pk, None)


# == 4. scalar verdicts and planes ===========================================


def _probe_rows():
    """The wire probes, each a variant of an honest row over n = 6."""
    values = _values(104, 6)
    commitment = ref_pcs.g1_to_bytes(ref_pcs.commit(values))
    proof, evals = ref_pcs.open_multi(values, (1, 3))
    proof = ref_pcs.g1_to_bytes(proof)
    return [
        ("eval >= N", (commitment, [1, 3], [evals[0], evals[1] + N], proof,
                       6)),
        ("n = 0", (commitment, [1, 3], evals, proof, 0)),
        ("n = 257", (commitment, [1, 3], evals, proof, 257)),
        ("65 indices", (commitment, list(range(65)), [0] * 65, proof, 200)),
        ("bool index", (commitment, [True, 3], evals, proof, 6)),
        ("string index", (commitment, ["1", 3], evals, proof, 6)),
        ("None index", (commitment, [None, 3], evals, proof, 6)),
        ("65-byte commitment", (commitment + b"\x00", [1, 3], evals, proof,
                                6)),
    ]


# the hostile kinds of tests/torch_poly_rows.py that the reference's
# twelve rows lack (its other kinds are among those twelve; every row of
# it is held against the reference's planes below, and on the card)
_NEW_KINDS = ("coordinate >= p", "zero proof", "every index")


def _all_rows():
    names, rows, _ = torch_poly_rows.hostile_rows()
    ref_rows = list(zip(*_poly_rows()))
    probes = _probe_rows()
    kinds = [(n, r) for n, r in zip(names, rows) if n in _NEW_KINDS]
    return ([f"poly_rows {i}" for i in range(len(ref_rows))]
            + [n for n, _ in kinds + probes],
            ref_rows + [r for _, r in kinds + probes])


@pytest.fixture(scope="module")
def rows():
    """Every row, and the reference `python` backend's verdicts."""
    names, rows = _all_rows()
    want = ref_get_backend("python").das_verify_multiproofs(
        *torch_poly_rows.columns(rows))
    return names, rows, want


def test_rows_have_the_known_verdicts(rows):
    names, rows, want = rows
    verdict = dict(zip(names, want))
    assert [verdict[f"poly_rows {i}"] for i in range(12)] == \
        [True] * 3 + [False] * 8 + [True]
    known = dict(zip(*torch_poly_rows.hostile_rows()[::2]))
    assert [verdict[n] for n in _NEW_KINDS] == [known[n] for n in _NEW_KINDS]
    assert [verdict[name] for name, _ in _probe_rows()] == \
        [False, False, False, False, True, True, False, False]
    assert len(rows) >= 20


def test_scalar_verdicts_equal_reference(srs, rows):
    _, port = srs
    names, rows, want = rows
    got = [poly_proofs.verify_multiproof(*row, srs=port) for row in rows]
    assert dict(zip(names, got)) == dict(zip(names, want))
    cols = torch_poly_rows.columns(rows[:4])
    assert poly_proofs.verify_multiproofs(*cols) == want[:4]


def test_marshal_planes_equal_reference():
    """`marshal_multiproofs` at bucket 16, on every row of
    tests/torch_poly_rows.py (the trivially true pairing rows of the
    infinity path included), limb for limb."""
    _, picked, _ = torch_poly_rows.hostile_rows()
    cols = torch_poly_rows.columns(picked)
    got = poly_proofs.marshal_multiproofs(*cols, 16)
    want = ref_poly.marshal_multiproofs(*cols, 16)
    assert set(got) == set(want)
    assert got["rows"] == want["rows"] == len(picked)
    for key in poly_proofs.PLANES:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        assert (got[key] == np.asarray(want[key])).all(), key
    assert got["ax"].shape == (16, bn.NLIMBS)
    assert got["zx"].shape == (16, 2, bn.NLIMBS)
    assert got["valid"].tolist() == [True, True, True, True, True, False,
                                     False, False, False, False, False,
                                     False, True, True] + [False] * 2


# == 5. the backend ===========================================================


def test_sigbackend_declares_multiproofs():
    with pytest.raises(NotImplementedError):
        SigBackend().das_verify_multiproofs([b""], [[0]], [[0]], [b""], [1])


def test_backend_equals_python_and_jax(rows):
    names, rows, want = rows
    cols = torch_poly_rows.columns(rows)
    backend = TorchSigBackend(device="cpu")
    got = backend.das_verify_multiproofs(*cols)
    assert dict(zip(names, got)) == dict(zip(names, want))
    jax_backend = ref_get_backend("jax")
    assert jax_backend.das_verify_multiproofs(*cols) == want
    wire = backend.last_wire
    bucket = marshal.bucket_size(len(rows))
    assert wire == {"op": "das_verify_multiproofs",
                    "wire_bytes": jax_backend.last_wire["wire_bytes"],
                    "sample_wire_bytes": wire["wire_bytes"],
                    "rows": len(rows), "bucket": bucket}
    assert jax_backend.last_wire["bucket"] == bucket
    timing = backend.last_timing
    assert (timing["rows"], timing["bucket"]) == (len(rows), bucket)
    assert not any(timing["launches"].values())   # CPU: the plain versions


def test_backend_builds_no_srs_before_its_first_multiproof():
    """A backend that never verifies a multiproof never pays for the dev
    SRS: neither making it nor an empty batch builds it."""
    code = (
        "from gethsharding_tpu_torch.das import pcs\n"
        "from gethsharding_tpu_torch.sigbackend.dispatch import "
        "TorchSigBackend\n"
        "backend = TorchSigBackend(device='cpu')\n"
        "assert backend.das_verify_multiproofs([], [], [], [], []) == []\n"
        "assert pcs._dev_srs.cache_info().currsize == 0\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_backend_empty_batch():
    backend = TorchSigBackend(device="cpu")
    backend.last_wire = {"op": "stale"}
    assert backend.das_verify_multiproofs([], [], [], [], []) == []
    assert backend.last_wire is None


@pytest.mark.parametrize("count, bucket", [(1, 1), (8, 8), (9, 10)])
def test_backend_bucket_edges(rows, count, bucket):
    """The first rows at the bucket edges: one row, a full bucket of 8,
    and 9 rows padded to 10."""
    _, rows, want = rows
    cols = torch_poly_rows.columns(rows[:count])
    backend = TorchSigBackend(device="cpu")
    assert backend.das_verify_multiproofs(*cols) == want[:count]
    assert backend.last_wire["bucket"] == bucket
    assert backend.last_wire["rows"] == count


# == 6. the reference notary's --da-proofs poly phase on the port ===========


class _PolyDAS:
    """The notary's DAS service seam in poly mode, serving rows made up
    front (as `DASService.collect_poly_row` returns them: a failed fetch
    as an empty proof with zero evals; None where no commitment was
    found)."""

    proof_mode = "poly"

    def __init__(self, rows_by_shard):
        self.rows_by_shard = rows_by_shard
        self.failures = 0
        self.verified = 0

    def prefetch_commitments(self, pairs):
        pass

    def collect_poly_row(self, shard_id, period, record, account):
        row = self.rows_by_shard[shard_id]
        return None if row is None else dict(row)

    def note_verdicts(self, verdicts):
        bad = sum(1 for v in verdicts if not v)
        self.failures += bad
        self.verified += len(verdicts) - bad
        return bad


def _poly_period():
    """Five shards: honest; a tampered proof; no commitment; a failed
    fetch; a constant polynomial (π at infinity)."""
    rng = np.random.default_rng(71)
    honest = torch_poly_rows.opened(torch_poly_rows.chunk_values(rng, 9),
                                    [0, 4, 8])
    tampered = torch_poly_rows.opened(torch_poly_rows.chunk_values(rng, 6),
                                      [2, 5])
    bad_proof = bls.g1_add(pcs.g1_from_bytes(tampered[3]), bls.G1_GEN)
    tampered = tampered[:3] + (pcs.g1_to_bytes(bad_proof),) + tampered[4:]
    const = torch_poly_rows.opened([5] * 4, [1, 3])
    row = lambda r: {"poly_commitment": r[0], "indices": r[1],
                     "evals": r[2], "proof": r[3], "n": r[4]}
    failed = row(honest)
    failed.update(evals=[0, 0, 0], proof=b"")
    return {0: row(honest), 1: row(tampered), 2: None, 3: failed,
            4: row(const)}


def _poly_notary(backend, rows):
    from gethsharding_tpu.actors.notary import Notary
    from gethsharding_tpu.core.shard import Shard
    from gethsharding_tpu.db.kv import MemoryKV
    from gethsharding_tpu.mainchain.client import SMCClient
    from gethsharding_tpu.smc.chain import SimulatedMainchain

    return Notary(client=SMCClient(backend=SimulatedMainchain()),
                  shard=Shard(0, MemoryKV()), sig_backend=backend,
                  das=_PolyDAS(rows), da_mode="sampled")


def test_notary_poly_phase_on_the_port():
    """Phase 3 of the reference notary in `--da-proofs poly` mode
    (`_sampled_verdicts` → `_poly_verdicts`) gives the `python` backend's
    verdicts and DAS counts on `TorchSigBackend(device="cpu")`, with one
    `das_verify_multiproofs` call over the shards that have a
    commitment."""
    rows = _poly_period()
    candidates = [(shard, 9, None) for shard in sorted(rows)]
    python = _poly_notary(ref_get_backend("python"), rows)
    want = python._sampled_verdicts(candidates)
    assert want == {0: True, 1: False, 2: False, 3: False, 4: True}

    backend = TorchSigBackend(device="cpu")
    notary = _poly_notary(backend, rows)
    assert notary._sampled_verdicts(candidates) == want
    assert backend.last_wire["rows"] == 4          # shard 2 has no row
    assert (notary.das.failures, notary.das.verified) == \
        (python.das.failures, python.das.verified) == (2, 2)
