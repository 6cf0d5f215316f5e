"""The port's serving tier (`gethsharding_tpu_torch/serving/`), its scalar
`PythonSigBackend`, its `metrics.Histogram` and its admission classes held
against the JAX package's, on the CPU.

1. `PythonSigBackend`: the port's equals the JAX package's on every op,
   on the hostile rows the port's tests already have (the recovery rows
   of `test_torch_ecrecover.py`, `tests/torch_das_rows.py`,
   `tests/torch_poly_rows.py`, committee edge rows of the kinds of
   `test_torch_precomp.py::edge_period`, small committees of 3-5 votes);
2. the port's `ServingSigBackend` over `TorchSigBackend(device="cpu")`,
   driven by concurrent submitters of every op (mixed sizes, keyed and
   keyless committee rows, surplus `pk_row_keys`): every request's result
   equals the JAX package's `PythonSigBackend` on the request's rows, in
   its row order, in fewer dispatches than requests;
3. the cases of `tests/test_serving.py` on a counting fake, run in both
   packages (coalescing, row order, empty requests, shed and block,
   oversized requests, the deadline flush, poison and ragged requests,
   error propagation, the nesting guard), with the results, counters and
   error messages of the two compared where they are deterministic;
4. the admission queue's weighted, tenant-fair drain and the class
   resolution, the same puts giving the same batches in both packages.

No wall-clock bound below a second is asserted. Every serving tier made
here is closed; the flight recorder writes under `tmp_path`.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import torch_das_rows
import torch_poly_rows
from gethsharding_tpu.crypto import bn256 as rbls
from test_torch_ecrecover import _hostile_sigs65

torch.set_num_threads(2)

PORT, REF = "gethsharding_tpu_torch", "gethsharding_tpu"
PKGS = (PORT, REF)


def pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, metrics=mod("metrics"), serving=mod("serving"),
        queue=mod("serving.queue"), classes=mod("serving.classes"),
        sig=mod("sigbackend"), keccak=mod("crypto.keccak").keccak256,
        chaos=mod("resilience.chaos"), soundness=mod("resilience.soundness"))


@pytest.fixture(scope="module", autouse=True)
def _recorder_dir(tmp_path_factory):
    """The flight recorder's bundles under a temporary directory for the
    whole module, its module-scoped fixtures included."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR",
                  str(tmp_path_factory.mktemp("recorder")))
        yield


def counting_backend(m, delay_s: float = 0.0):
    """A deterministic fake of package `m`: records every dispatch's row
    count; results are a pure function of the row."""

    class Counting(m.sig.SigBackend):
        name = "counting"

        def __init__(self):
            self.calls = []
            self._lock = threading.Lock()

        def _record(self, n):
            with self._lock:
                self.calls.append(n)
            if delay_s:
                time.sleep(delay_s)

        def ecrecover_addresses(self, digests, sigs65):
            self._record(len(digests))
            return [bytes(d)[:20] for d in digests]

        def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
            self._record(len(messages))
            return [len(bytes(msg)) % 2 == 0 for msg in messages]

        def bls_verify_committees(self, messages, sig_rows, pk_rows,
                                  pk_row_keys=None):
            self._record(len(messages))
            return [len(r) > 0 for r in sig_rows]

    return Counting()


def serving_over(m, inner, **config):
    return m.serving.ServingSigBackend(
        inner, m.serving.ServingConfig(**config),
        registry=m.metrics.Registry())


# == 1. the scalar backend ====================================================

def _committee_rows():
    """Small committees (3-5 votes) and edge rows of the kinds of
    `edge_period`: (messages, sig_rows, pk_rows, keys)."""
    msgs, sig_rows, pk_rows = [], [], []
    for i, n in enumerate((3, 5, 4)):
        msg = b"serving-row-%d" % i
        keys = [rbls.bls_keygen(b"serving-key-%d-%d" % (i, j))
                for j in range(n)]
        msgs.append(msg)
        sig_rows.append([rbls.bls_sign(msg, sk) for sk, _ in keys])
        pk_rows.append([pk for _, pk in keys])
    sigs, pks = sig_rows[0], pk_rows[0]
    edge = [
        ([], pks),                               # no signatures
        (sigs, []),                              # no pubkeys
        (sigs[:2], pks),                         # fewer signatures
        ([None] * 3, pks),                       # every signature None
        (sigs, [pks[0], None, pks[2]]),          # a None pubkey
        (sigs[:2] + [(1, 1)], pks),              # an off-curve signature
        ([(sigs[0][0] + rbls.P, sigs[0][1])] + sigs[1:], pks),  # x + p
    ]
    for k, (s, p) in enumerate(edge):
        msgs.append(msgs[0])
        sig_rows.append(list(s))
        pk_rows.append(list(p))
    keys = [("serving", k) for k in range(len(msgs))]
    return msgs, sig_rows, pk_rows, keys


def _aggregate_rows():
    msg = b"serving-agg"
    keys = [rbls.bls_keygen(b"serving-agg-%d" % j) for j in range(3)]
    agg_sig = rbls.bls_aggregate_sigs([rbls.bls_sign(msg, sk)
                                       for sk, _ in keys])
    agg_pk = rbls.bls_aggregate_pks([pk for _, pk in keys])
    tampered = rbls.g1_add(agg_sig, rbls.G1_GEN)
    return ([msg, msg, msg, b"other", msg],
            [agg_sig, tampered, None, agg_sig, agg_sig],
            [agg_pk, agg_pk, agg_pk, agg_pk, None])


# the multiproof rows kept here: two honest, the rejected kinds whose check
# reaches the pairing, and the infinity path (host pairings are slow)
_POLY_KEEP = ("honest", "honest one index", "tampered eval",
              "off-curve commitment", "duplicate indices", "zero proof",
              "constant polynomial")


@pytest.fixture(scope="module")
def small_srs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_DAS_SRS_SIZE", torch_poly_rows.SMALL_SRS_SIZE)
        yield


@pytest.fixture(scope="module")
def rows(small_srs):
    """Per op, the argument columns of the rows above."""
    names, poly, _ = torch_poly_rows.hostile_rows()
    poly = [row for name, row in zip(names, poly) if name in _POLY_KEEP]
    digests, sigs, _ = _hostile_sigs65()
    msgs, sig_rows, pk_rows, keys = _committee_rows()
    return {
        "ecrecover_addresses": (digests, sigs),
        "bls_verify_aggregates": _aggregate_rows(),
        "bls_verify_committees": (msgs, sig_rows, pk_rows),
        "das_verify_samples": torch_das_rows.mixed_rows(12),
        "das_verify_multiproofs": tuple(torch_poly_rows.columns(poly)),
        "committee_keys": keys,
    }


@pytest.fixture(scope="module")
def reference_out(rows):
    """The JAX package's `PythonSigBackend` on every op."""
    ref = pkg(REF).sig.PythonSigBackend()
    return {op: getattr(ref, op)(*rows[op]) for op in OPS}


OPS = ("ecrecover_addresses", "bls_verify_aggregates",
       "bls_verify_committees", "das_verify_samples",
       "das_verify_multiproofs")


@pytest.mark.parametrize("op", OPS)
def test_python_backend_equals_reference(op, rows, reference_out):
    port = pkg(PORT).sig.PythonSigBackend()
    assert port.name == "python"
    got = getattr(port, op)(*rows[op])
    assert got == reference_out[op]
    assert len(got) == len(rows[op][0])
    if op == "bls_verify_committees":
        # the async face: computed now, a resolved future (two rows: the
        # host pairings are slow)
        future = port.bls_verify_committees_async(
            *(c[2:4] for c in rows[op]),
            pk_row_keys=rows["committee_keys"][2:4])
        assert future.done() and future.result() == got[2:4]


def test_rows_hold_both_verdicts(reference_out):
    """The rows are not vacuous: every op has accepted and rejected rows."""
    for op, out in reference_out.items():
        assert any(out) and not all(out), op


# == 2. the tier over the card's backend, on the CPU ==========================

def _split(columns, sizes):
    """Columns cut into requests of the given row counts (cycled)."""
    n = len(columns[0])
    out, start, k = [], 0, 0
    while start < n:
        end = min(n, start + sizes[k % len(sizes)])
        out.append((start, end, tuple(c[start:end] for c in columns)))
        start, k = end, k + 1
    return out


@pytest.fixture(scope="module")
def served(rows):
    """Every op's rows as concurrent requests of mixed sizes through the
    port's `ServingSigBackend(TorchSigBackend(device="cpu"))`: the
    committee rows keyed in one request, keyless in another and with a
    surplus key in a third. Returns each request's rows and result, and
    the dispatch counts."""
    m = pkg(PORT)
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    serving = m.serving.ServingSigBackend(
        TorchSigBackend(device="cpu"),
        m.serving.ServingConfig(max_batch=256, flush_us=250_000),
        registry=m.metrics.Registry())
    jobs = []
    for op in OPS:
        sizes = {"ecrecover_addresses": (1, 7, 3, 5),
                 "bls_verify_committees": (3, 4, 3)}.get(op, (2, 3, 1))
        for start, end, cols in _split(rows[op], sizes):
            kw = {}
            if op == "bls_verify_committees":
                keys = rows["committee_keys"][start:end]
                kw = [{"pk_row_keys": keys},
                      {},
                      {"pk_row_keys": keys + [("surplus", start)]}][
                          len(jobs) % 3]
            jobs.append((op, start, end, cols, kw))
    results = [None] * len(jobs)
    barrier = threading.Barrier(len(jobs))

    def submitter(i):
        op, _, _, cols, kw = jobs[i]
        barrier.wait()
        results[i] = serving.submit(op, *cols, **kw).result(timeout=600)

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(len(jobs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        assert not any(t.is_alive() for t in threads)
        counts = dict(serving.batcher.dispatch_counts)
    finally:
        serving.close()
    return {"jobs": jobs, "results": results, "dispatches": counts}


@pytest.mark.parametrize("op", OPS)
def test_served_requests_equal_reference(op, served, reference_out):
    """Each request's result is the JAX package's `PythonSigBackend` on
    the request's own rows, in its order."""
    want = reference_out[op]
    seen = 0
    for (job_op, start, end, _, _), got in zip(served["jobs"],
                                               served["results"]):
        if job_op != op:
            continue
        assert got == want[start:end], (op, start)
        seen += end - start
    assert seen == len(want)


def test_served_requests_coalesce(served):
    requests = {op: sum(1 for j in served["jobs"] if j[0] == op)
                for op in OPS}
    assert all(requests[op] > 1 for op in OPS)
    assert all(1 <= served["dispatches"][op] < requests[op] for op in OPS)


# == 3. the serving cases, in both packages ===================================

@pytest.mark.parametrize("root", PKGS)
def test_concurrent_callers_coalesce(root):
    m = pkg(root)
    fake = counting_backend(m, delay_s=0.005)
    serving = serving_over(m, fake, max_batch=64, flush_us=50_000)
    n = 64
    digests = [m.keccak(b"co-%d" % i) for i in range(n)]
    barrier = threading.Barrier(n)
    results = {}

    def caller(i):
        barrier.wait()
        results[i] = serving.ecrecover_addresses([digests[i]],
                                                 [bytes([i]) * 65])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert [results[i] for i in range(n)] == [[d[:20]] for d in digests]
        assert serving.dispatch_count == len(fake.calls)
        assert serving.dispatch_count * 4 <= n
        assert sum(fake.calls) == n
    finally:
        serving.close()


def _row_order(root):
    m = pkg(root)
    serving = serving_over(m, counting_backend(m), max_batch=128,
                           flush_us=20_000)
    try:
        futures = [serving.submit(
            "ecrecover_addresses",
            [m.keccak(b"mix-%d-%d" % (size, j)) for j in range(size)],
            [b"\x00" * 65] * size) for size in (3, 1, 5, 2, 8)]
        return [f.result(timeout=30) for f in futures]
    finally:
        serving.close()


def test_mixed_size_requests_preserve_row_order():
    got = _row_order(PORT)
    assert got == _row_order(REF)
    assert [len(r) for r in got] == [3, 1, 5, 2, 8]


@pytest.mark.parametrize("root", PKGS)
def test_empty_request_resolves_without_dispatch(root):
    m = pkg(root)
    fake = counting_backend(m)
    serving = serving_over(m, fake)
    try:
        assert serving.ecrecover_addresses([], []) == []
        assert serving.bls_verify_committees([], [], [],
                                             pk_row_keys=[]) == []
        assert fake.calls == []
    finally:
        serving.close()


@pytest.mark.parametrize("root", PKGS)
def test_shed_policy_at_queue_cap(root):
    m = pkg(root)
    registry = m.metrics.Registry()
    fake = counting_backend(m, delay_s=0.15)
    serving = m.serving.ServingSigBackend(
        fake, m.serving.ServingConfig(max_batch=4, flush_us=0, queue_cap=4,
                                      policy="shed"), registry=registry)
    digest = m.keccak(b"shed")
    futures, shed = [], 0
    try:
        for _ in range(64):
            try:
                futures.append(serving.submit(
                    "ecrecover_addresses", [digest], [b"\x00" * 65]))
            except m.queue.ServingOverloadError:
                shed += 1
        assert shed > 0 and futures
        for future in futures:
            assert future.result(timeout=60) == [digest[:20]]
        assert serving.batcher.shed_counts()["ecrecover_addresses"] == shed
        assert registry.counter("serving/ecrecover/shed").value == shed
    finally:
        serving.close()


@pytest.mark.parametrize("root", PKGS)
def test_block_policy_absorbs_overload(root):
    m = pkg(root)
    fake = counting_backend(m, delay_s=0.01)
    serving = serving_over(m, fake, max_batch=8, flush_us=0, queue_cap=8,
                           policy="block")
    digest = m.keccak(b"block")
    try:
        futures = [serving.submit("ecrecover_addresses", [digest],
                                  [b"\x00" * 65]) for _ in range(64)]
        for future in futures:
            assert future.result(timeout=60) == [digest[:20]]
        assert sum(fake.calls) == 64
    finally:
        serving.close()


@pytest.mark.parametrize("root", PKGS)
def test_oversized_request_never_deadlocks(root):
    m = pkg(root)
    queue = m.queue.AdmissionQueue(cap_rows=4, policy="block", max_batch=4,
                                   flush_us=0)
    big = m.queue.Request("ecrecover_addresses", ((), ()), rows=16)
    queue.put(big)
    batch, reason = queue.take_batch()
    assert batch == [big] and reason == "full"
    assert queue.depth_rows == 0


@pytest.mark.parametrize("root", PKGS)
def test_lone_request_flushes_at_the_deadline(root):
    m = pkg(root)
    registry = m.metrics.Registry()
    serving = m.serving.ServingSigBackend(
        counting_backend(m),
        m.serving.ServingConfig(max_batch=1024, flush_us=5_000),
        registry=registry)
    digest = m.keccak(b"deadline")
    try:
        t0 = time.monotonic()
        assert serving.ecrecover_addresses([digest],
                                           [b"\x00" * 65]) == [digest[:20]]
        assert time.monotonic() - t0 < 10.0
        assert registry.counter(
            "serving/ecrecover/flush_deadline").value == 1
        assert registry.counter("serving/ecrecover/flush_full").value == 0
        hist = registry.histogram("serving/ecrecover/batch_rows")
        assert hist.count == 1 and hist.snapshot()["le_1"] == 1
    finally:
        serving.close()


@pytest.mark.parametrize("root", PKGS)
def test_surplus_pk_row_keys_do_not_shift_batch_mates(root):
    m = pkg(root)

    class KeyRecorder(m.sig.SigBackend):
        name = "keyrec"
        seen = None

        def bls_verify_committees(self, messages, sig_rows, pk_rows,
                                  pk_row_keys=None):
            self.seen = list(pk_row_keys)
            return [True] * len(messages)

    fake = KeyRecorder()
    serving = serving_over(m, fake, max_batch=64, flush_us=200_000)
    try:
        a = serving.submit("bls_verify_committees", [b"a0", b"a1"],
                           [[], []], [[], []],
                           pk_row_keys=["a0", "a1", "surplus"])
        b = serving.submit("bls_verify_committees", [b"b0", b"b1"],
                           [[], []], [[], []], pk_row_keys=["b0", "b1"])
        c = serving.submit("bls_verify_committees", [b"c0"], [[]], [[]])
        assert [f.result(timeout=30) for f in (a, b, c)] == [
            [True, True], [True, True], [True]]
        assert fake.seen == ["a0", "a1", "b0", "b1", None]
    finally:
        serving.close()


def _errors(root):
    """(type name, message) of the tier's refusals and failures."""
    m = pkg(root)

    class Broken(m.sig.SigBackend):
        name = "broken"

        def ecrecover_addresses(self, digests, sigs65):
            raise RuntimeError("device on fire")

    fake = counting_backend(m)
    serving = serving_over(m, fake, flush_us=1_000)
    broken = serving_over(m, Broken(), flush_us=1_000)
    out = []

    def grab(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - the refusal is compared
            out.append((type(exc).__name__, str(exc)))
        else:
            out.append(None)

    digest = m.keccak(b"r")
    try:
        grab(lambda: serving.submit("ecrecover_addresses", [digest],
                                    [b"\x00" * 65] * 2))
        grab(lambda: serving.batcher.submit(
            "ecrecover_addresses", ([digest], [b"\x00" * 65] * 2), 2))
        grab(lambda: serving.submit("no_such_op", [digest]))
        grab(lambda: serving.submit("ecrecover_addresses", [digest],
                                    [b"\x00" * 65], pk_row_keys=[1]))
        grab(lambda: m.serving.ServingSigBackend(serving))
        # a poison request past the validation: rows claims 2, the
        # columns hold 1; it fails its own future and the flusher lives
        poison = m.queue.Request("ecrecover_addresses",
                                 ([digest], [b"\x00" * 65]), rows=2)
        serving.batcher._queues["ecrecover_addresses"].put(poison)
        grab(lambda: poison.future.result(timeout=30))
        grab(lambda: serving.ecrecover_addresses([digest], [b"\x00" * 65]))
        futures = [broken.submit("ecrecover_addresses", [digest],
                                 [b"\x00" * 65]) for _ in range(3)]
        for future in futures:
            grab(lambda: future.result(timeout=30))
        serving.close()
        grab(lambda: serving.submit("ecrecover_addresses", [digest],
                                    [b"\x00" * 65]))
    finally:
        serving.close()
        broken.close()
    return out


def test_errors_equal_reference():
    """Ragged requests, unknown ops, keys on a keyless op, nesting, a
    poison request, a failing backend and a closed tier: the same
    exception types and messages as the JAX package's tier."""
    got = _errors(PORT)
    assert got == _errors(REF)
    assert got[5][0] == "RuntimeError" and got[6] is None
    assert [e[1] for e in got[7:10]] == ["device on fire"] * 3
    assert got[10][0] == "QueueClosed"


@pytest.mark.parametrize("root", PKGS)
def test_nesting_guard_sees_through_wrappers(root):
    """One admission tier per device, whatever the wrappers in between
    (the spot-checker, a chaos front)."""
    m = pkg(root)
    serving = serving_over(m, counting_backend(m))
    try:
        spot = m.soundness.SpotCheckSigBackend(serving, rate=0.0,
                                               registry=m.metrics.Registry())
        chaos = m.chaos.ChaosSigBackend(spot, m.chaos.ChaosSchedule())
        for wrapped in (serving, spot, chaos):
            with pytest.raises(ValueError, match="nest"):
                m.serving.ServingSigBackend(wrapped)
    finally:
        serving.close()


def test_registry_names_follow_reference():
    """The port's registry: the JAX package's names with `jax` read as
    `torch`; the serving and failover names wrap the registry's own
    singletons."""
    port, ref = pkg(PORT).sig, pkg(REF).sig
    assert sorted(port.BACKEND_NAMES) == sorted(
        n.replace("jax", "torch") for n in ref._BACKENDS)
    serving = port.get_backend("serving-python")
    try:
        assert isinstance(serving, pkg(PORT).serving.ServingSigBackend)
        assert serving.inner is port.get_backend("python")
        assert serving.name == "serving+python"
        assert port.get_backend("serving-python") is serving
        failover = port.get_backend("failover-serving-python")
        assert failover.primary is serving
        assert failover.fallback is port.get_backend("python")
        assert failover.name == "failover+serving+python"
    finally:
        serving.close()
    with pytest.raises(ValueError, match="unknown sigbackend"):
        port.get_backend("jax")


def test_histogram_equals_reference():
    values = [0.0, 1, 2, 2, 3, 7, 8, 9, 31, 64, 65, 100, 700, 5000, 0.5]
    port = pkg(PORT).metrics.Histogram(buckets=(1, 2, 4, 8, 64, 512))
    ref = pkg(REF).metrics.Histogram(buckets=(1, 2, 4, 8, 64, 512))
    for v in values:
        port.observe(v)
        ref.observe(v)
    assert port.snapshot() == ref.snapshot()
    assert [port.quantile(q) for q in (0, 0.1, 0.5, 0.9, 0.99, 1)] == \
        [ref.quantile(q) for q in (0, 0.1, 0.5, 0.9, 0.99, 1)]
    reg = pkg(PORT).metrics.Registry()
    assert reg.histogram("h", buckets=(1, 2)) is reg.histogram("h")


# == 4. admission classes and the drain =======================================

def _drain(root, scenario):
    """Batches of a fixed put sequence: (class, tenant, rows) per put."""
    m = pkg(root)
    queue = m.queue.AdmissionQueue(cap_rows=4096, policy="block",
                                   max_batch=16, flush_us=0)
    for i, (klass, tenant, rows) in enumerate(scenario):
        queue.put(m.queue.Request("ecrecover_addresses", ((i,) * rows,),
                                  rows, klass=klass, tenant=tenant))
    batches = []
    while queue.depth_requests:
        batch, reason = queue.take_batch()
        batches.append((reason, [(r.klass, r.tenant, r.args[0][0])
                                 for r in batch]))
    return batches


_SCENARIOS = {
    "classes": [("catchup_replay", "", 4)] * 6 + [("bulk_audit", "", 2)] * 6
    + [("interactive", "", 1)] * 20,
    "tenants": [("bulk_audit", "heavy", 5)] * 8 + [("bulk_audit", "light",
                                                     1)] * 6
    + [("bulk_audit", "mid", 3)] * 4,
    "oversized": [("interactive", "", 40), ("bulk_audit", "a", 3),
                  ("bulk_audit", "b", 17), ("catchup_replay", "", 2)],
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_weighted_tenant_fair_drain_equals_reference(scenario):
    got = _drain(PORT, _SCENARIOS[scenario])
    assert got == _drain(REF, _SCENARIOS[scenario])
    assert sum(len(b) for _, b in got) == len(_SCENARIOS[scenario])


@pytest.mark.parametrize("root", PKGS)
def test_class_resolution_and_context(root, monkeypatch):
    m = pkg(root)
    c = m.classes
    env = ("GETHSHARDING_TORCH_CLASS_ECRECOVER_ADDRESSES" if root == PORT
           else "GETHSHARDING_CLASS_ECRECOVER_ADDRESSES")
    assert c.class_for("ecrecover_addresses") == "interactive"
    assert c.class_for("das_verify_samples") == "bulk_audit"
    monkeypatch.setenv(env, "catchup_replay")
    assert c.class_for("ecrecover_addresses") == "catchup_replay"
    with c.admission_class("bulk_audit", tenant="t1"):
        assert c.class_for("ecrecover_addresses") == "bulk_audit"
        with c.admission_class("interactive"):
            assert c.current_admission() == ("interactive", "t1")
        assert c.class_for("ecrecover_addresses", "catchup_replay") == \
            "catchup_replay"
    assert c.current_admission() == (None, None)
    with pytest.raises(ValueError, match="unknown admission class"):
        c.check_class("vip")


@pytest.mark.parametrize("root", PKGS)
def test_tenant_quota_and_class_expiry(root, monkeypatch):
    m = pkg(root)
    prefix = "GETHSHARDING_TORCH_" if root == PORT else "GETHSHARDING_"
    monkeypatch.setenv(f"{prefix}CLASS_CATCHUP_REPLAY_DEADLINE_S", "0.001")
    queue = m.queue.AdmissionQueue(cap_rows=64, max_batch=64, flush_us=0,
                                   tenant_quota_rows=3)
    req = lambda rows, tenant, klass="interactive": m.queue.Request(
        "ecrecover_addresses", ((0,) * rows,), rows, klass=klass,
        tenant=tenant)
    queue.put(req(3, "t"))
    with pytest.raises(m.queue.TenantQuotaExceeded):
        queue.put(req(1, "t"))
    assert queue.quota_rejections == 1
    late = req(1, "", "catchup_replay")
    queue.put(late)
    time.sleep(0.05)
    batch, _ = queue.take_batch()
    assert [r.rows for r in batch] == [3]
    with pytest.raises(m.queue.ClassDeadlineExceeded):
        late.future.result(timeout=1)
    assert queue.expired_by_class["catchup_replay"] == 1
