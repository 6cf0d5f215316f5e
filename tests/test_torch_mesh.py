"""The port's shard mesh (`gethsharding_tpu_torch/parallel/{mesh,period,
stress,dryrun}.py`, `sigbackend/layout.py`, the mesh form of
`TorchSigBackend`, `--mesh-devices`) against the JAX package, on the CPU.

The slots are explicit: ``["cpu"] * k`` is the port's counterpart of the
conftest's 8 virtual CPU devices, on which the reference's own meshes
run here. Every comparison is exact (verdicts, masks, totals and roots
are integers or bools):

1. geometry: `make_mesh` and `make_multihost_mesh` (shapes and their
   errors), `DeviceLayout`'s buckets and row placement, the knob, and
   the cross-slot sum (one reduction per mesh axis);
2. the committee sampling on global shard ids (`sample_shard`);
3. the period pipelines over 2 slots and a 2 × 1 (`"dcn"`, `"ici"`) mesh
   against one device and the known verdicts, with an uneven shard
   count, a forged vote, an empty committee and a shard with no header;
   `-m slow` holds them on 8 slots and a 4 × 2 mesh against the
   reference's `make_mesh(8)` and `make_multihost_mesh(4, 2)`;
4. `TorchSigBackend` over 2 slots on the probes of the reference's
   `tests/test_sigbackend_mesh.py` (valid, empty, infinity slots,
   forged), keyed (precomp, cold and warm) and unkeyed, against one
   device and the reference's known verdicts; `last_mesh`; the slots'
   line-table caches (placement, disjoint tensors, churn under a
   starvation budget); `-m slow` adds 1, 2 and 8 slots against the
   reference's `JaxSigBackend(mesh_devices=k)` and `PythonSigBackend`,
   and the multiproofs;
5. the stress step over 2 slots against one device (`-m slow`: the
   reference's `tests/test_stress.py` workload, 19 shards over 8 slots
   and 4 × 2, against the reference's mesh);
6. the dry run twin, and `--mesh-devices` on the node and the chain
   process.

On the CPU a slot's step costs its plain versions' fixed cost (a
committee audit ~2-3 s, a stress step ~14 s), so the fast tier keeps to
2 slots."""

import os

import numpy as np
import pytest
import torch

from gethsharding_tpu.parallel import mesh as rmesh
from gethsharding_tpu.sigbackend import layout as rlayout
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.parallel import mesh
from gethsharding_tpu_torch.parallel import period, stress
from gethsharding_tpu_torch.params import Config
from gethsharding_tpu_torch.sigbackend import PythonSigBackend, layout
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _needs_virtual_devices():
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (tests/conftest.py)")


# == 1. geometry ==============================================================


@pytest.mark.parametrize("n", [1, 2, 8])
def test_make_mesh_matches_reference(n):
    _needs_virtual_devices()
    port, ref = mesh.make_mesh(n, CPU8), rmesh.make_mesh(n)
    assert port.size == ref.devices.size == n
    assert port.axis_names == tuple(ref.axis_names) == ("shard",)
    assert port.shape == dict(ref.shape)
    assert all(d == torch.device("cpu") for d in port.devices)


def test_make_mesh_too_few_devices_is_the_reference_error():
    _needs_virtual_devices()
    with pytest.raises(ValueError) as ref:
        rmesh.make_mesh(9)
    with pytest.raises(ValueError) as port:
        mesh.make_mesh(9, CPU8)
    assert str(port.value) == str(ref.value) == \
        "requested 9 devices, only 8 visible"
    if not torch.cuda.is_available():
        with pytest.raises(ValueError,
                           match="requested 2 devices, only 0 visible"):
            mesh.make_mesh(2)


@pytest.mark.parametrize("hosts,per_host", [(4, 2), (2, 4), (8, 1)])
def test_multihost_mesh_matches_reference(hosts, per_host):
    _needs_virtual_devices()
    port = mesh.make_multihost_mesh(hosts, per_host, CPU8)
    ref = rmesh.make_multihost_mesh(n_hosts=hosts, devices_per_host=per_host)
    assert port.axis_names == tuple(ref.axis_names) == ("dcn", "ici")
    assert port.shape == dict(ref.shape)
    assert port.size == ref.devices.size


def test_multihost_mesh_errors_are_the_reference_errors():
    _needs_virtual_devices()
    for kwargs in ({"n_hosts": 3, "devices_per_host": 3}, {"n_hosts": 3}):
        with pytest.raises(ValueError) as ref:
            rmesh.make_multihost_mesh(**kwargs)
        with pytest.raises(ValueError) as port:
            mesh.make_multihost_mesh(devices=CPU8, **kwargs)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("slots", [2, 4, 8])
def test_layout_geometry_matches_reference(slots):
    _needs_virtual_devices()
    port = layout.DeviceLayout(devices=["cpu"] * slots)
    ref = rlayout.DeviceLayout(slots)
    assert port.is_mesh and ref.is_mesh
    assert port.n_devices == ref.n_devices == len(port.devices)
    for n in (1, 5, 6, 9, 19, 100, 113):
        bucket = port.mesh_bucket(n)
        assert bucket == ref.mesh_bucket(n), n
        assert port.rows_per_device(bucket) == ref.rows_per_device(bucket)
        assert [port.device_of_row(r, bucket) for r in range(bucket)] == \
            [ref.device_of_row(r, bucket) for r in range(bucket)]


def test_single_device_layout_is_the_default():
    for lay in (layout.DeviceLayout(1), layout.DeviceLayout(devices=["cpu"])):
        assert not lay.is_mesh and lay.devices == ()
        ref = rlayout.DeviceLayout(1)
        for n in (1, 5, 9, 100):
            assert lay.mesh_bucket(n) == ref.mesh_bucket(n)


def test_layout_place_and_assemble():
    lay = layout.DeviceLayout(devices=["cpu"] * 4)
    host = np.arange(24, dtype=np.int32).reshape(12, 2)
    slabs = lay.place(host)
    assert [tuple(s.shape) for s in slabs] == [(3, 2)] * 4
    assert torch.equal(lay.assemble(slabs), torch.as_tensor(host))
    with pytest.raises(ValueError, match="do not split"):
        lay.place(host[:10])


def test_mesh_knob_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(layout.MESH_ENV, raising=False)
    monkeypatch.setenv(rlayout.MESH_ENV, "3")
    assert layout.MESH_ENV == "GETHSHARDING_TORCH_MESH_DEVICES"
    assert rlayout.mesh_devices_requested() == 3
    assert layout.mesh_devices_requested() == 1
    monkeypatch.setenv(layout.MESH_ENV, "4")
    assert layout.mesh_devices_requested() == 4
    for explicit in (0, 1, 2, 5):
        assert layout.mesh_devices_requested(explicit) == \
            rlayout.mesh_devices_requested(explicit)
    b = TorchSigBackend(device="cpu")
    assert b.layout.n_devices == 4 and len(b.line_shards) == 4
    assert b.lines is None and b.device == torch.device("cpu")


def test_hierarchical_psum_reduces_once_per_axis():
    parts = [torch.tensor([i, 10 * i], dtype=torch.int32) for i in range(8)]
    want = torch.tensor([28, 280], dtype=torch.int32)
    for m, axes in ((mesh.make_mesh(8, CPU8), 1),
                    (mesh.make_multihost_mesh(4, 2, CPU8), 2),
                    (mesh.make_multihost_mesh(2, 4, CPU8), 2)):
        assert torch.equal(mesh.hierarchical_psum(parts, m), want)
        assert m.reductions == axes
    with pytest.raises(ValueError, match="partial totals"):
        mesh.hierarchical_psum(parts[:3], mesh.make_mesh(8, CPU8))


# == 2. committee sampling on global shard ids ================================


@pytest.fixture(scope="module")
def stress_workload():
    return stress.build_stress_inputs(3, votes_per_shard=3, txs_per_shard=2,
                                      committee_size=7, device="cpu")


def test_sample_shard_feeds_the_sampling_global_ids(stress_workload):
    """Slab 1 of a 2-slot mesh over 4 padded rows holds shards 2 and 3:
    with the global ids its attempts are all accepted, as on one device;
    with the slab's local ids (0, 1) the sampling picks other members and
    rejects some, so `sample_shard` is what keeps the layouts equal."""
    from gethsharding_tpu_torch.ops import smc

    inputs, pool, bh, size, _ = stress_workload
    pool_t = torch.as_tensor(pool)
    bh_t = torch.as_tensor(bh)
    lo, hi = 2, 3
    v = inputs.att_index.shape[1]
    state = smc.add_header_reset_masked(
        smc.VoteState(*(getattr(inputs, f)[lo:hi] for f in (
            "has_voted", "vote_count", "last_submitted", "last_approved",
            "is_elected", "chunk_root"))),
        inputs.new_header[lo:hi], 1, inputs.new_chunk_root[lo:hi])
    local = torch.arange(hi - lo, dtype=torch.int32).repeat_interleave(v)
    flat = lambda name: getattr(inputs, name)[lo:hi].reshape(
        (-1,) + tuple(getattr(inputs, name).shape[2:]))
    attempts = smc.VoteAttempts(
        shard=local, index=flat("att_index"),
        pool_index=flat("att_pool_index"), sender=flat("att_sender"),
        chunk_root=flat("att_chunk_root"), deposited=flat("att_deposited"),
        valid=flat("att_valid"))
    kw = dict(period=1, blockhash=bh_t, sample_size=size, committee_size=7,
              quorum_size=2)
    _, global_ok = smc.submit_votes_batch(state, pool_t, attempts,
                                          sample_shard=local + lo, **kw)
    _, local_ok = smc.submit_votes_batch(state, pool_t, attempts, **kw)
    assert bool(global_ok.all())
    assert not bool(local_ok.all())


# == 3. the period pipelines ==================================================

QUORUM = 2


@pytest.fixture(scope="module")
def committee_period():
    """5 shards (uneven over 2 slots), committee 4: 1-4 voters a shard;
    shard 1 an empty committee, shard 3 a forged vote, shard 4 no
    header."""
    keys = [bls.bls_keygen(bytes([70 + i])) for i in range(4)]
    headers, sig_rows, pk_rows = [], [], []
    for s in range(5):
        header = b"mesh-period-%d" % s
        voters = keys[:1 + (s % 4)]
        sigs = [bls.bls_sign(header, sk) for sk, _ in voters]
        if s == 3:
            sigs[0] = bls.bls_sign(b"forged", voters[0][0])
        headers.append(header if s != 4 else None)
        sig_rows.append(sigs if s != 1 else [])
        pk_rows.append([pk for _, pk in voters] if s != 1 else [])
    return headers, sig_rows, pk_rows, [True, False, True, False, False]


def _equal_outputs(a, b):
    for name in period.PeriodOutputs._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_committee_pipeline_mesh_equals_single(committee_period):
    headers, sig_rows, pk_rows, verified = committee_period
    cfg = Config(committee_size=4, quorum_size=QUORUM)
    single = period.CommitteePeriodPipeline(cfg, device="cpu")
    inputs = single.build_inputs(headers, sig_rows, pk_rows)
    want = single.run(inputs)
    assert want.verified.tolist() == verified
    counts = [len(r) for r in sig_rows]
    approved = [v and c >= QUORUM for v, c in zip(verified, counts)]
    assert want.approved.tolist() == approved
    assert int(want.total_votes) == sum(c for v, c in zip(verified, counts)
                                        if v)
    assert int(want.total_approved) == sum(approved)
    m = mesh.make_mesh(2, CPU8)
    _equal_outputs(period.CommitteePeriodPipeline(cfg, mesh=m).run(inputs),
                   want)
    assert m.reductions == 1


def test_aggregate_pipeline_mesh_equals_single(committee_period):
    """`PeriodPipeline` on host-aggregated points: the honest shards'
    aggregates, shard 3's forged one, shard 1 and 4 with none."""
    headers, sig_rows, pk_rows, verified = committee_period
    agg_sigs = [bls.bls_aggregate_sigs(r) if r else None for r in sig_rows]
    agg_pks = [bls.bls_aggregate_pks(r) if r else None for r in pk_rows]
    counts = [5 if s % 2 == 0 else 2 for s in range(5)]
    cfg = Config(committee_size=4, quorum_size=3)
    single = period.PeriodPipeline(cfg, device="cpu")
    inputs = single.build_inputs(headers, agg_sigs, agg_pks, counts)
    want = single.run(inputs)
    assert want.verified.tolist() == verified
    assert want.approved.tolist() == [True, False, True, False, False]
    assert int(want.total_votes) == 10 and int(want.total_approved) == 2
    m = mesh.make_multihost_mesh(2, 1, CPU8)
    _equal_outputs(period.PeriodPipeline(cfg, mesh=m).run(inputs), want)
    assert m.reductions == 2


def _reference_period_case():
    """The reference's `tests/test_period_pipeline.py` cases: 8 shards of
    aggregates (alternating quorum, one tampered, one without header),
    and 11 committee shards with uneven committees."""
    keys = [bls.bls_keygen(bytes([i])) for i in range(3)]
    agg_pk = bls.bls_aggregate_pks([pk for _, pk in keys])
    headers, sigs, pks, counts = [], [], [], []
    for s in range(6):
        header = b"hdr" + bytes([s])
        headers.append(header)
        sigs.append(bls.bls_aggregate_sigs(
            [bls.bls_sign(header, sk) for sk, _ in keys]))
        pks.append(agg_pk)
        counts.append(5 if s % 2 == 0 else 2)
    headers.append(b"hdr6")
    sigs.append(bls.g1_add(bls.bls_aggregate_sigs(
        [bls.bls_sign(b"hdr6", sk) for sk, _ in keys]), bls.G1_GEN))
    pks.append(agg_pk)
    counts.append(5)
    headers.append(None), sigs.append(None), pks.append(None), counts.append(0)
    ckeys = [bls.bls_keygen(bytes([40 + i])) for i in range(4)]
    cheaders, sig_rows, pk_rows = [], [], []
    for s in range(11):
        header = b"cpp-%d" % s
        voters = ckeys[: 1 + (s % 4)]
        row = [bls.bls_sign(header, sk) for sk, _ in voters]
        if s == 5:
            row = [bls.bls_sign(b"evil", voters[0][0])] + row[1:]
        cheaders.append(header if s != 7 else None)
        sig_rows.append(row)
        pk_rows.append([pk for _, pk in voters])
    return (headers, sigs, pks, counts), (cheaders, sig_rows, pk_rows)


@pytest.mark.slow
def test_period_pipelines_equal_reference_meshes():
    """Both pipelines over 8 slots and 4 × 2 against the reference's over
    `make_mesh(8)` and `make_multihost_mesh(4, 2)`, on the reference's
    own inputs carried across."""
    _needs_virtual_devices()
    from gethsharding_tpu.parallel import period as rperiod
    from gethsharding_tpu.params import Config as RConfig

    agg_case, com_case = _reference_period_case()
    for r_cls, cls, case, kw in (
            (rperiod.PeriodPipeline, period.PeriodPipeline, agg_case,
             dict(shard_count=8, committee_size=5, quorum_size=3)),
            (rperiod.CommitteePeriodPipeline, period.CommitteePeriodPipeline,
             com_case, dict(committee_size=4, quorum_size=2))):
        r_inputs = r_cls(RConfig(**kw)).build_inputs(*case)
        inputs = convert.period_inputs_from_reference(r_inputs, "cpu")
        for r_mesh, m in ((rmesh.make_mesh(8), mesh.make_mesh(8, CPU8)),
                          (rmesh.make_multihost_mesh(4, 2),
                           mesh.make_multihost_mesh(4, 2, CPU8))):
            want = r_cls(RConfig(**kw), mesh=r_mesh).run(r_inputs)
            got = cls(Config(**kw), mesh=m).run(inputs)
            single = cls(Config(**kw), device="cpu").run(inputs)
            _equal_outputs(got, single)
            assert got.verified.tolist() == np.asarray(want.verified).tolist()
            assert got.approved.tolist() == np.asarray(want.approved).tolist()
            assert int(got.total_votes) == int(want.total_votes)
            assert int(got.total_approved) == int(want.total_approved)


# == 4. the committee audit on a mesh =========================================


def _committee_cols():
    """The reference's `tests/test_sigbackend_mesh.py` rows: 6 committees
    of width 3: valid, empty, an absent voter as infinity in both halves,
    valid, forged, valid."""
    messages, sig_rows, pk_rows, keys = [], [], [], []
    for i in range(6):
        msg = bytes([11, i]) * 16
        sigs, pks = [], []
        for j in range(3):
            sk, pk = bls.bls_keygen(bytes([i + 1, j + 1, 29]) * 8)
            sigs.append(bls.bls_sign(msg, sk))
            pks.append(pk)
        messages.append(msg)
        sig_rows.append(sigs)
        pk_rows.append(pks)
        keys.append(f"mesh-row:{i}")
    sig_rows[1], pk_rows[1] = [], []
    sig_rows[2][1] = None
    pk_rows[2][1] = None
    forged_sk, _ = bls.bls_keygen(bytes([5, 1, 29]) * 8)
    sig_rows[4][0] = bls.bls_sign(b"some other collation header!!!!!",
                                  forged_sk)
    return messages, sig_rows, pk_rows, keys


WANT = [True, False, True, True, False, True]


@pytest.fixture(scope="module")
def cols():
    return _committee_cols()


@pytest.fixture(scope="module")
def two_slots():
    return TorchSigBackend(device=["cpu", "cpu"])


def test_mesh_audit_two_slots(cols, two_slots):
    """Keyed cold (precomp, tables built on each slot), keyed warm (each
    slot's batch memo), unkeyed (recompute): the scalar verdicts, one
    reduction a step, every slot holding its verdicts, the vote total of
    the verdict plane, each slot's kernels run."""
    messages, sig_rows, pk_rows, keys = cols
    b = two_slots
    for row_keys, precomp, memo in ((keys, True, False), (keys, True, True),
                                    (None, False, False)):
        fut = b.bls_verify_committees_async(messages, sig_rows, pk_rows,
                                            pk_row_keys=row_keys)
        info = b.last_mesh
        assert info["vote_total"] is None      # set by the result
        assert fut.result() == WANT
        assert info["op"] == "bls_verify_committees"
        assert (info["n_devices"], info["bucket"], info["width"]) == (2, 8, 4)
        assert info["collectives"] == 1 and info["verdict_devices"] == 2
        assert info["vote_total"] == sum(WANT)
        assert info["precomp"] is precomp
        assert len(info["slot_launches"]) == 2
        timing = b.last_timing
        assert timing["slots"] == 2 and timing["memo"] is memo
        assert timing["precomp"] is precomp
        if precomp and memo:
            assert timing["g2_wire_bytes"] == 0 and timing["hit_rows"] == 5
    assert b.bls_verify_committees([], [], []) == [] and b.last_mesh is None


def test_mesh_audit_equals_one_device(cols, two_slots):
    messages, sig_rows, pk_rows, keys = cols
    one = TorchSigBackend(device=["cpu"])
    assert not one.layout.is_mesh and one.lines is not None
    assert one.bls_verify_committees(messages, sig_rows, pk_rows,
                                     pk_row_keys=keys) == WANT
    assert one.last_mesh is None
    two_slots.bls_verify_committees(messages, sig_rows, pk_rows,
                                    pk_row_keys=keys)
    # the same tables, shard for shard: each slot holds its slab's rows
    for key in keys:
        if key == "mesh-row:1":
            continue
        slot = int(key[-1]) // 4
        table = one.lines._tables[key][0]
        held = two_slots.line_shards[slot]._tables[key][0]
        assert torch.equal(table, held)
        assert key not in two_slots.line_shards[1 - slot]._tables


def test_mesh_line_caches_are_disjoint(cols, two_slots):
    messages, sig_rows, pk_rows, keys = cols
    two_slots.bls_verify_committees(messages, sig_rows, pk_rows,
                                    pk_row_keys=keys)
    shards = two_slots.line_shards
    assert [s.budget_bytes for s in shards] == [128 << 20] * 2
    assert [len(s) for s in shards] == [3, 2]
    ptrs = [{t.untyped_storage().data_ptr() for t in s.tensors()}
            for s in shards]
    assert ptrs[0] and ptrs[1] and not ptrs[0] & ptrs[1]


def test_mesh_line_caches_churn_under_a_starvation_budget(cols):
    """1-byte budgets: every keyed insert evicts at once, the verdicts
    hold, and the caches end empty."""
    messages, sig_rows, pk_rows, _ = cols
    b = TorchSigBackend(device=["cpu", "cpu"])
    for s in b.line_shards:
        s.budget_bytes = 1
    keys = [f"churn:{i}" for i in range(len(messages))]
    assert b.bls_verify_committees(messages, sig_rows, pk_rows,
                                   pk_row_keys=keys) == WANT
    assert b.last_timing["hit_rows"] == 0
    for s in b.line_shards:
        assert s.evictions > 0 and len(s) == 0 and s.bytes == 0


@pytest.mark.slow
def test_mesh_audit_equals_reference_meshes(cols):
    """1, 2 and 8 slots against the reference's `JaxSigBackend(mesh_
    devices=k)` on its own mesh probes, keyed and unkeyed, sync and
    async; the reference's and the port's `last_mesh` agree."""
    _needs_virtual_devices()
    from gethsharding_tpu.sigbackend.dispatch import JaxSigBackend

    messages, sig_rows, pk_rows, keys = cols
    assert PythonSigBackend().bls_verify_committees(
        messages, sig_rows, pk_rows) == WANT
    for k in (1, 2, 8):
        ref = JaxSigBackend(mesh_devices=k)
        port = TorchSigBackend(device=["cpu"] * k)
        for row_keys in (keys, None):
            want = ref.bls_verify_committees(messages, sig_rows, pk_rows,
                                             pk_row_keys=row_keys)
            assert want == WANT
            fut = port.bls_verify_committees_async(
                messages, sig_rows, pk_rows, pk_row_keys=row_keys)
            assert fut.result() == want
            if k == 1:
                assert ref.last_mesh is None and port.last_mesh is None
                continue
            for field in ("op", "n_devices", "bucket", "width",
                          "collectives", "verdict_devices", "vote_total"):
                assert port.last_mesh[field] == ref.last_mesh[field], field


@pytest.mark.slow
def test_mesh_multiproofs_equal_reference_meshes():
    """The DAS multiproofs over 1, 2 and 8 slots against the reference's
    backends on `tests/torch_poly_rows.py`'s hostile rows: rows split over
    the slots, no reduction."""
    _needs_virtual_devices()
    import torch_poly_rows
    from gethsharding_tpu.sigbackend.dispatch import JaxSigBackend

    _, rows, want = torch_poly_rows.hostile_rows()
    want = list(want)
    cols_ = [list(c) for c in zip(*rows)]
    assert PythonSigBackend().das_verify_multiproofs(*cols_) == want
    for k in (1, 2, 8):
        port = TorchSigBackend(device=["cpu"] * k)
        assert port.das_verify_multiproofs(*cols_) == want
        assert JaxSigBackend(mesh_devices=k).das_verify_multiproofs(
            *cols_) == want
        if k > 1:
            info = port.last_mesh
            assert info["op"] == "das_verify_multiproofs"
            assert info["collectives"] == 0 and info["verdict_devices"] == k
    assert port.das_verify_multiproofs([], [], [], [], []) == []


def test_mesh_keeps_aggregates_on_slot_zero(two_slots):
    """Aggregate votes run on slot 0, as recovery and samples do (the
    reference keeps them off its mesh): no mesh record, no reduction."""
    before = two_slots.layout.mesh.reductions
    two_slots.last_mesh = None
    sk, pk = bls.bls_keygen(b"slot-zero")
    assert two_slots.bls_verify_aggregates(
        [b"m"], [bls.bls_sign(b"m", sk)], [pk]) == [True]
    assert two_slots.last_mesh is None
    assert two_slots.layout.mesh.reductions == before


# == 5. the stress step ========================================================


def test_stress_mesh_equals_single(stress_workload):
    """3 shards over 2 slots (one padding row) equal one device's step
    plane for plane; the totals cross in one reduction."""
    inputs, pool, bh, size, _ = stress_workload
    cfg = Config(committee_size=7, quorum_size=2)
    want = stress.StressPipeline(cfg).run(inputs, pool, bh, 1, size)
    assert bool(want.accepted.all() & want.agg_ok.all()
                & want.tx_status.all())
    m = mesh.make_mesh(2, CPU8)
    got = stress.StressPipeline(cfg, mesh=m).run(inputs, pool, bh, 1, size)
    assert m.reductions == 1
    for name in stress.StressOutputs._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.slow
def test_stress_mesh_equals_reference_mesh():
    """The reference's `tests/test_stress.py` workload (19 shards, uneven
    over 8) on 8 slots and 4 × 2 against the reference's mesh step."""
    _needs_virtual_devices()
    from gethsharding_tpu.parallel import stress as rstress
    from gethsharding_tpu.params import Config as RConfig

    r_inputs, pool, bh, size, _ = rstress.build_stress_inputs(
        19, votes_per_shard=3, txs_per_shard=2, committee_size=7)
    want = rstress.StressPipeline(
        RConfig(committee_size=7, quorum_size=2),
        mesh=rmesh.make_mesh(8)).run(r_inputs, pool, bh, 1, size)
    inputs = convert.stress_inputs_from_reference(r_inputs, "cpu")
    for m in (mesh.make_mesh(8, CPU8), mesh.make_multihost_mesh(4, 2, CPU8)):
        got = stress.StressPipeline(Config(committee_size=7, quorum_size=2),
                                    mesh=m).run(inputs, np.asarray(pool),
                                                np.asarray(bh), 1, size)
        for name in stress.StressOutputs._fields:
            assert (getattr(got, name).numpy() ==
                    np.asarray(getattr(want, name))).all(), name


# == 6. the dry run and the entry points ======================================


def test_dryrun_on_two_slots():
    from gethsharding_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(["cpu"] * 2)
    assert out["shards"] == 5 and out["layouts"] == ["1-D"]
    assert (out["total_votes"], out["total_approved"]) == (11, 4)


@pytest.mark.slow
def test_dryrun_on_four_slots():
    from gethsharding_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(["cpu"] * 4)
    assert out["shards"] == 9 and out["layouts"] == ["1-D", "2-D"]
    assert out["stress"] == {"total_votes": 18, "total_txs": 9}


def test_node_takes_mesh_devices():
    from gethsharding_tpu_torch.node.backend import ShardNode

    from gethsharding_tpu_torch.actors.notary import Notary

    node = ShardNode(actor="notary", device="cpu", mesh_devices=2)
    assert node.device == torch.device("cpu")
    assert node.slots == [torch.device("cpu")] * 2
    backend = node.service(Notary).sig_backend
    assert backend is node.sig_backend
    assert backend.layout.n_devices == 2 and len(backend.line_shards) == 2
    scalar = ShardNode(actor="notary", device="cpu", mesh_devices=2,
                       sig_backend="python")
    assert scalar.sig_backend.name == "python"


def test_cli_node_loop_on_a_cpu_mesh(caplog):
    import logging

    from gethsharding_tpu_torch.node import cli

    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "notary", "--deposit", "--runtime", "1.0",
         "--blocktime", "0.02", "--periodlength", "2", "--mesh-devices",
         "2"])
    assert args.mesh_devices == 2
    with caplog.at_level(logging.INFO, logger="sharding"):
        assert cli.run_sharding_node(args, device="cpu") == 0
    assert "service error" not in caplog.text


def test_chain_server_composes_a_mesh_backend():
    """The chain process's composition over a mesh's slots: the serving
    tier over a `TorchSigBackend` with one cache a slot, which audits
    over the slots."""
    from gethsharding_tpu_torch.rpc import chain_server

    args = chain_server.build_parser().parse_args(["--mesh-devices", "2"])
    slots = layout.resolve_slots("cpu", args.mesh_devices)
    assert slots == [torch.device("cpu")] * 2
    composed, serving = chain_server.compose(args, slots)
    try:
        backend = serving.inner
        assert backend.layout.n_devices == 2 and backend.lines is None
        msgs = [b"chain-mesh-%d" % i for i in range(3)]
        keys = [bls.bls_keygen(bytes([90 + i])) for i in range(2)]
        sig_rows = [[bls.bls_sign(m, sk) for sk, _ in keys] for m in msgs]
        pk_rows = [[pk for _, pk in keys]] * 3
        sig_rows[1] = sig_rows[1][:1]
        assert composed.bls_verify_committees(msgs, sig_rows, pk_rows) == \
            [True, False, True]
        assert backend.last_mesh["collectives"] == 1
    finally:
        composed.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA card is present: the mesh would build")
def test_entry_points_refuse_too_few_cards(capsys):
    """With no card, `--mesh-devices 2` exits non-zero with the
    reference's message, in the node and in the chain process: neither
    falls back to the CPU or to one device."""
    from gethsharding_tpu_torch.node import cli
    from gethsharding_tpu_torch.rpc import chain_server

    assert cli.run_cli(["sharding", "--actor", "notary", "--runtime", "0.1",
                        "--mesh-devices", "2", "--verbosity", "error"]) == 2
    assert "requested 2 devices, only 0 visible" in capsys.readouterr().err
    assert chain_server.main(["--mesh-devices", "2", "--runtime",
                              "0.1"]) == 2
    err = capsys.readouterr().err
    assert "requested 2 devices, only 0 visible" in err
    assert "parallel/mesh.py" not in err
    assert os.environ.get(layout.MESH_ENV) is None
