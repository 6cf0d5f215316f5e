"""The port's `bls_verify_aggregates` and the reference's notary on the
port, against the JAX package, on the CPU through the plain versions of
the kernels:

- `TorchSigBackend(device="cpu").bls_verify_aggregates` gives the
  reference `python` and `jax` backends' verdicts on valid, forged,
  swapped-message, infinity-signature and infinity-pubkey rows, and on
  empty and one-row batches (the reference's cases in
  tests/test_sigbackend.py and tests/test_soundness.py), and on ten
  wire probes: coordinates + p, (1, 1) and (0, 0) signatures, a negated
  signature, an off-curve pubkey, the generators, the empty message;
- the Miller product f of `bn.bls_verify_aggregate_batch` (affine points
  at Z = 1 through the projective Miller product) equals the reference's
  projective `_bls_miller_opt` at z = 1 mod p and, limb for limb, the
  projective oracle that `_bls_miller_opt` dispatches to under
  `GETHSHARDING_TPU_MILLER=mega` (`run_miller_xla`, slow);
- the reference's `Notary.audit_periods`, batched and overlapped, gives
  the `python` backend's results on `TorchSigBackend(device="cpu")`,
  the nothing-auditable period included.

Committees are made with the reference's scalar crypto from fixed seeds.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.crypto import bn256 as ref
from gethsharding_tpu.ops import bn256_jax as k
from gethsharding_tpu.ops import pallas_finalexp as m
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.sigbackend import SigBackend
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)


def _aggregate(tag: bytes, n: int, message: bytes):
    keys = [ref.bls_keygen(tag + bytes([i])) for i in range(n)]
    sig = ref.bls_aggregate_sigs([ref.bls_sign(message, sk) for sk, _ in keys])
    return sig, ref.bls_aggregate_pks([pk for _, pk in keys])


@pytest.fixture(scope="module")
def hostile():
    """Six aggregate votes: two valid committees, a forged signature, a
    vote checked against another header, a signature at infinity and a
    pubkey at infinity."""
    headers = [b"agg-header-%d" % i for i in range(2)]
    (s0, p0), (s1, p1) = (_aggregate(b"agg-%d" % i, 3, h)
                          for i, h in enumerate(headers))
    msgs = [headers[0], headers[1], headers[0], headers[0], headers[1],
            headers[0]]
    sigs = [s0, s1, ref.g1_add(s0, ref.G1_GEN), s1, None, s0]
    pks = [p0, p1, p0, p1, p1, None]
    want = ref_get_backend("python").bls_verify_aggregates(msgs, sigs, pks)
    assert want == [True, True, False, False, False, False]
    return msgs, sigs, pks, want


def test_aggregates_match_python_backend(hostile):
    msgs, sigs, pks, want = hostile
    backend = TorchSigBackend(device="cpu")
    assert backend.bls_verify_aggregates(msgs, sigs, pks) == want
    timing = backend.last_timing
    assert timing["rows"] == 6 and timing["bucket"] == 8
    assert timing["g2_wire_bytes"] == 2 * 8 * 2 * bn.NLIMBS * 4
    assert not any(timing["launches"].values())   # CPU: the plain versions


def test_aggregates_match_jax_backend(hostile):
    msgs, sigs, pks, want = hostile
    assert ref_get_backend("jax").bls_verify_aggregates(msgs, sigs, pks) \
        == want
    assert TorchSigBackend(device="cpu").bls_verify_aggregates(
        msgs, sigs, pks) == want


@pytest.mark.parametrize("rows", [0, 1])
def test_aggregates_empty_and_one_row_batches(hostile, rows):
    msgs, sigs, pks, _ = hostile
    backend = TorchSigBackend(device="cpu")
    for pick in ([0], [2]):   # one valid row, one forged row
        batch = [[col[i] for i in pick][:rows] for col in (msgs, sigs, pks)]
        want = ref_get_backend("python").bls_verify_aggregates(*batch)
        assert backend.bls_verify_aggregates(*batch) == want
        assert len(want) == rows


def _probes(hostile):
    """The ten wire probes of `bls_verify_aggregates`: a valid vote; the
    signature's x + p and y + p; signatures (1, 1) and (0, 0); the
    negated signature; the pubkey's x.a + p; an off-curve pubkey; the
    generators (G1, G2); a vote on the empty message."""
    msgs, sigs, pks, _ = hostile
    m, (x, y), pk = msgs[0], sigs[0], pks[0]
    P = ref.P
    off_curve = (ref.Fp2(pk[0].a, pk[0].b), ref.Fp2(pk[1].a + 1, pk[1].b))
    empty_sig, empty_pk = _aggregate(b"agg-empty", 2, b"")
    return [
        ("valid", m, (x, y), pk),
        ("sig x + p", m, (x + P, y), pk),
        ("sig y + p", m, (x, y + P), pk),
        ("sig (1, 1)", m, (1, 1), pk),
        ("sig (0, 0)", m, (0, 0), pk),
        ("negated sig", m, ref.g1_neg((x, y)), pk),
        ("pk x.a + p", m, (x, y), (ref.Fp2(pk[0].a + P, pk[0].b), pk[1])),
        ("off-curve pk", m, (x, y), off_curve),
        ("generators", m, ref.G1_GEN, ref.G2_GEN),
        ("empty message", b"", empty_sig, empty_pk),
    ]


def test_aggregate_probes_match_python_and_jax(hostile):
    """The probes of the `bls_verify_aggregates` wire, in two batches of
    five (bucket 8, the compile the other cases use): the port equals
    the reference `python` and `jax` backends on each."""
    probes = _probes(hostile)
    names = [name for name, *_ in probes]
    backend = TorchSigBackend(device="cpu")
    python, jax_backend = ref_get_backend("python"), ref_get_backend("jax")
    got, want, want_jax = [], [], []
    for half in (probes[:5], probes[5:]):
        cols = [list(col) for col in zip(*(row[1:] for row in half))]
        got += backend.bls_verify_aggregates(*cols)
        want += python.bls_verify_aggregates(*cols)
        want_jax += jax_backend.bls_verify_aggregates(*cols)
    assert dict(zip(names, got)) == dict(zip(names, want)) == \
        dict(zip(names, want_jax))
    assert want == [True, True, True, False, False, False, True, False,
                    False, True]


def test_g2_to_limbs_equals_reference(hostile):
    _, _, pks, _ = hostile
    for got, want in zip(bn.g2_to_limbs(pks), k.g2_to_limbs(pks)):
        assert (got == np.asarray(want)).all()
    assert bn.g2_to_limbs([])[0].shape == (0, 2, bn.NLIMBS)


def test_sigbackend_declares_aggregates():
    with pytest.raises(NotImplementedError):
        SigBackend().bls_verify_aggregates([b"m"], [None], [None])


def _miller_inputs(hostile):
    """The first three rows' planes, affine, with Z = 1."""
    msgs, sigs, pks, _ = hostile
    hx, hy, _ = bn.g1_to_limbs([ref.hash_to_g1(m) for m in msgs[:3]])
    sx, sy, _ = bn.g1_to_limbs(sigs[:3])
    px, py, _ = bn.g2_to_limbs(pks[:3])
    one = np.broadcast_to(bn._FP_ONE, sx.shape).copy()
    one2 = np.broadcast_to(bn._FP2_ONE, px.shape).copy()
    return (sx, sy, one), (hx, hy), (px, py, one2)


def test_aggregate_miller_f_equals_reference_mod_p(hostile):
    """The port's f at Z = 1 and the reference's projective
    `_bls_miller_opt` at z = 1 are the same Fp12 values (their lazy limbs
    differ: the reference's XLA route normalizes after every product),
    and both pass the final exponentiation exactly on the valid rows."""
    sig, h, pk = _miller_inputs(hostile)
    t, j = torch.as_tensor, jnp.asarray
    got = mk.miller_f(tuple(map(t, sig)), *map(t, h), tuple(map(t, pk)))
    want = k._bls_miller_opt(tuple(map(j, sig)), *map(j, h),
                             tuple(map(j, pk)))
    assert (bn.FP.canon(got).numpy() == np.asarray(k.FP.canon(want))).all()
    assert mk.finalexp_is_one(got).tolist() == [True, True, False]


@pytest.mark.slow
def test_aggregate_miller_f_equals_reference_projective_oracle(hostile):
    """Limb for limb against the projective oracle of the reference's
    mega-kernel route (`run_miller_xla`, normalized as `miller_f`
    returns it) at z = 1."""
    sig, h, pk = _miller_inputs(hostile)
    t = torch.as_tensor
    got = mk.miller_f(tuple(map(t, sig)), *map(t, h), tuple(map(t, pk)))
    raw = m.run_miller_xla(sig, h, pk)
    assert (got.numpy() == np.asarray(k.FP.normalize(jnp.asarray(raw)))).all()


# == the reference's notary on the port ======================================

_KEYPOOL = [ref.bls_keygen(b"torch-notary-%d" % i) for i in range(5)]


def _round(rng, hostile: str):
    """One audit period's rows: two honest committees of random members
    and one `hostile` row ("forged": a tampered vote; "missing": a
    signature left out, its pubkey kept; "empty": no committee); each
    key names its row's members, so it determines the row's pubkeys."""
    msgs, sig_rows, pk_rows, keys = [], [], [], []
    for r in range(3):
        tag = b"torch-notary-msg-%d" % rng.randrange(4)
        members = rng.sample(range(len(_KEYPOOL)), rng.randrange(2, 4))
        if r == 2 and hostile == "empty":
            members = []
        sigs = [ref.bls_sign(tag, _KEYPOOL[i][0]) for i in members]
        if r == 2 and hostile == "forged":
            sigs[0] = ref.g1_add(sigs[0], ref.G1_GEN)
        elif r == 2 and hostile == "missing":
            sigs[-1] = None
        msgs.append(tag)
        sig_rows.append(sigs)
        pk_rows.append([_KEYPOOL[i][1] for i in members])
        keys.append(("torch-notary", hostile, r, tuple(members)))
    return msgs, sig_rows, pk_rows, keys


def _notary(backend):
    from gethsharding_tpu.actors.notary import Notary
    from gethsharding_tpu.core.shard import Shard
    from gethsharding_tpu.db.kv import MemoryKV
    from gethsharding_tpu.mainchain.client import SMCClient
    from gethsharding_tpu.smc.chain import SimulatedMainchain

    notary = Notary(client=SMCClient(backend=SimulatedMainchain()),
                    shard=Shard(0, MemoryKV()), sig_backend=backend)
    rng = random.Random(11)
    rows_by_period = {4: None}  # period 4: nothing auditable
    for p, hostile in ((1, "forged"), (2, "missing"), (3, "empty")):
        msgs, sig_rows, pk_rows, keys = _round(rng, hostile)
        rows_by_period[p] = {
            "shards": list(range(len(msgs))),
            "msgs": msgs, "sig_rows": sig_rows, "pk_rows": pk_rows,
            "pk_keys": keys,
            "signed_counts": [len(s) for s in sig_rows],
            "total_counts": [len(s) for s in sig_rows],
            "expected": [len(s) >= notary.config.quorum_size
                         for s in sig_rows],
        }
    notary._collect_audit_rows = lambda p: rows_by_period[p]
    return notary


def test_notary_audit_periods_on_the_port():
    """`Notary.audit_periods([1, 2, 3, 4])`, batched and overlapped, with
    the port's backend: the `python` backend's per-period results and
    mismatch counts, each period with a hostile row, the last with
    nothing to audit."""
    periods = [1, 2, 3, 4]
    python = _notary(ref_get_backend("python"))
    want = python.audit_periods(periods)
    assert want == {1: False, 2: False, 3: False, 4: None}
    assert python.audit_mismatches == 3

    backend = TorchSigBackend(device="cpu")
    notary = _notary(backend)
    assert notary.audit_periods(periods) == want
    assert backend.last_timing["precomp"]
    assert notary.audit_mismatches == 3
    assert notary.audit_periods(periods, overlap=True) == want
    assert backend.last_timing["hit_rows"] > 0    # the tables were resident
    assert notary.audit_mismatches == 6
    assert notary.audits_run == 6   # 3 auditable periods x 2 passes
