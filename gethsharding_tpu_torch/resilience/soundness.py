"""Continuous statistically-sound integrity audit of the fast path (the
port's copy of the JAX package's `resilience/soundness.py`).

The failover breaker (breaker.py) trips on LOUD faults — exceptions,
watchdog timeouts, half-open differential mismatches. A device that
silently returns wrong verdicts at production rate is trusted until
something crashes. Following 2G2T (constant-size, statistically sound
MSM outsourcing, PAPERS.md), `SpotCheckSigBackend` closes that gap the
verifier-side way: fold a cheap re-verification of a seeded-random
subset of rows into a sampled fraction of dispatches, so the
probability that sustained corruption goes undetected decays
geometrically in the number of dispatches — quantified by
`detection_probability`, the same soundness-accounting shape as
`das/sampler.py`.

Two layers, one wrapper:

- **always-on invariant check** (every dispatch, O(rows) python): the
  verdict plane must have exactly one entry per input row, verdict ops
  must answer in the 0/1 domain, ecrecover rows must be None or a
  20-byte address, and rows KNOWN to be rejections without any crypto
  (an empty committee aggregates to the point at infinity and proves
  nothing) must verify False. Catches the cheap-to-catch corruption
  classes — truncated pulls, dtype garbage, stuck-at-True planes —
  for free.
- **sampled spot-check** (probability `rate` per dispatch): re-verify
  `rows` seeded-random rows of the dispatch against the scalar
  reference (`PythonSigBackend`) and compare byte-for-byte. Both the
  per-dispatch decision and the row subset are pure functions of
  (seed, op, dispatch index) — the chaos-schedule idiom — so a run is
  replayable and tests are deterministic.

A detected disagreement raises `SoundnessViolation` (resilience/
errors.py) out of the wrapped call. Composed inside
`FailoverSigBackend`'s primary slot that IS the existing
`record_fault` path: the breaker trips on silent corruption exactly
as it does on loud faults, and a violation surfacing during a
half-open differential probe counts as a probe mismatch (once — the
spot-checker itself never talks to the breaker, so there is no
double-accounting).

Async is first-class: `bls_verify_committees_async` and the serving
`submit` face wrap the inner future and run the audit AT PULL TIME —
the dispatch pipeline never blocks on a scalar recompute (on the card
the host pairing of one committee row takes a large fraction of a
second, so the audit lands on the caller that pulls the verdict, never
on the dispatch thread), the breaker epoch stamped by the failover face
at submit time governs staleness, and a failure memo guarantees at most
one counted violation per dispatch no matter how often the future is
polled.

Observability: per-op ``resilience/soundness/<op>/{checks,rows,
mismatches,invariant_violations}`` counters plus the ``rate`` gauge in
the metrics registry, and ``resilience/soundness/violation`` trace
events when the span tracer is on.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional, Sequence, Tuple

from gethsharding_tpu_torch import metrics, slo, tracing
from gethsharding_tpu_torch.perfwatch import RECORDER
from gethsharding_tpu_torch.resilience.errors import SoundnessViolation
from gethsharding_tpu_torch.sigbackend import SigBackend, VerdictFuture

# the default sampled fraction of dispatches: at 4 checked rows per
# 64-row dispatch this re-verifies ~0.3% of all rows while catching an
# every-dispatch single-row corruptor within ~1500 dispatches at 99%
# confidence (corrupting MORE rows per dispatch, or a larger share of
# dispatches, detects faster)
DEFAULT_RATE = 0.05
DEFAULT_ROWS = 4

# the ops carrying consensus verdicts; everything the audit covers
AUDITED_OPS = ("ecrecover_addresses", "bls_verify_aggregates",
               "bls_verify_committees", "das_verify_samples",
               "das_verify_multiproofs")
_VERDICT_OPS = ("bls_verify_aggregates", "bls_verify_committees",
                "das_verify_samples", "das_verify_multiproofs")


# == the soundness accounting behind (rate, rows) ==========================


def detection_probability(rate: float, rows_checked: int, batch_rows: int,
                          corrupt_rows: int = 1,
                          dispatches: int = 1) -> float:
    """P(the spot-checker catches corruption within `dispatches`
    dispatches), against an adversary/fault corrupting `corrupt_rows`
    of every `batch_rows`-row dispatch.

    Per dispatch: the check fires with probability `rate` and samples
    `rows_checked` distinct rows; it misses every corrupted row with
    probability C(batch_rows - corrupt_rows, s) / C(batch_rows, s)
    = prod_{i<s} (clean - i)/(batch_rows - i). Dispatch decisions are
    independent, so `dispatches` dispatches all escape with the
    per-dispatch miss probability to that power — the complement is
    returned. Mirrors `das/sampler.detection_probability`."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    if batch_rows <= 0 or corrupt_rows <= 0 or corrupt_rows > batch_rows:
        raise ValueError(
            f"bad shape batch_rows={batch_rows} corrupt_rows={corrupt_rows}")
    s = min(rows_checked, batch_rows)
    clean = batch_rows - corrupt_rows
    miss = 1.0
    for i in range(s):
        if clean - i <= 0:
            miss = 0.0
            break
        miss *= (clean - i) / (batch_rows - i)
    p_dispatch = rate * (1.0 - miss)
    return 1.0 - (1.0 - p_dispatch) ** max(1, dispatches)


def dispatches_to_detect(rate: float, rows_checked: int, batch_rows: int,
                         corrupt_rows: int = 1,
                         confidence: float = 0.99) -> int:
    """The dispatch budget: how many corrupted dispatches until the
    spot-checker has caught one with probability >= `confidence`. The
    number a run under corruption asserts against."""
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    p = detection_probability(rate, rows_checked, batch_rows, corrupt_rows)
    if p <= 0.0:
        raise ValueError(
            f"detection probability is 0 at rate={rate} "
            f"rows_checked={rows_checked} — corruption is undetectable")
    if p >= 1.0:
        return 1
    return max(1, math.ceil(math.log(1.0 - confidence)
                            / math.log(1.0 - p)))


# == the audited futures ===================================================


class _SpotCheckFuture:
    """`concurrent.futures.Future`-compatible (on `result`) wrapper
    that runs the soundness audit AT PULL TIME: the dispatch pipeline
    (serving flush thread, staged device launch) never blocks on the
    scalar recompute; the caller that pulls the verdict pays it.

    The failure memo makes the audit count at most once per dispatch:
    a caller polling a violated future twice re-raises the CACHED
    `SoundnessViolation` instead of re-running the check (which would
    double-count the mismatch counters — and, composed under the
    failover face, the failover future's own memo already guarantees a
    single `record_fault`). A caller-timeout on a still-pending batch
    re-raises un-memoized so a later poll can still succeed."""

    __slots__ = ("_inner", "_audit", "_done", "_value", "_exc")

    def __init__(self, inner, audit):
        self._inner = inner
        self._audit = audit
        self._done = False
        self._value = None
        self._exc: Optional[BaseException] = None

    def result(self, timeout=None):
        if self._done:
            if self._exc is not None:
                raise self._exc
            return self._value
        try:
            out = self._inner.result(timeout)
        except (TimeoutError, futures.TimeoutError):
            # the CALLER's timeout, not an outcome: leave un-memoized
            # (both spellings: the classes only merged in python 3.11)
            raise
        except Exception as exc:  # noqa: BLE001 - any inner escape
            # a loud device fault is the breaker's existing territory;
            # memoize so a re-poll re-raises without re-pulling
            self._exc = exc
            self._done = True
            self._audit = None  # drop the captured input columns
            raise
        try:
            self._audit(out)
        except Exception as exc:  # noqa: BLE001 - the violation
            self._exc = exc
            self._done = True
            self._audit = None
            raise
        self._value = out
        self._done = True
        self._audit = None
        return out

    def done(self) -> bool:
        done = getattr(self._inner, "done", None)
        return self._done or (bool(done()) if done is not None else False)

    @property
    def _serving_request(self):
        # tracing passthrough (same contract as _FailoverFuture):
        # observe_future_wake attributes caller wake latency via the
        # serving future's request record — hiding it here would drop
        # the future_wake span whenever the spot-checker wraps serving
        return getattr(self._inner, "_serving_request", None)


# == the wrapper ===========================================================


class SpotCheckSigBackend(SigBackend):
    """Drop-in `SigBackend` folding a continuous soundness audit into
    every dispatch of the wrapped backend.

    Composable under `ServingSigBackend` (checks run in the dispatch
    thread, per coalesced batch) or OVER it (checks run per caller
    request at pull time), and inside `FailoverSigBackend`'s primary
    slot — the intended production shape, where a raised
    `SoundnessViolation` is a primary fault that trips the breaker.

    - ``rate``: probability a dispatch is spot-checked
      (``GETHSHARDING_TORCH_SOUNDNESS_RATE``, default 0.05);
    - ``rows``: rows re-verified per checked dispatch
      (``GETHSHARDING_TORCH_SOUNDNESS_ROWS``, default 4);
    - ``seed``: selection seed (``GETHSHARDING_TORCH_SOUNDNESS_SEED``) — the
      per-dispatch decision and the row subset are pure functions of
      (seed, op, dispatch index), replayable like a chaos schedule;
    - ``reference``: the scalar truth (default `PythonSigBackend`).
    """

    def __init__(self, inner: SigBackend,
                 rate: Optional[float] = None,
                 rows: Optional[int] = None,
                 reference: Optional[SigBackend] = None,
                 seed: Optional[int] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        # empty-string env values read as unset, like every other
        # reader of these variables (node/backend.py)
        if rate is None:
            rate = float(os.environ.get("GETHSHARDING_TORCH_SOUNDNESS_RATE", "")
                         or DEFAULT_RATE)
        if rows is None:
            rows = int(os.environ.get("GETHSHARDING_TORCH_SOUNDNESS_ROWS", "")
                       or DEFAULT_ROWS)
        if seed is None:
            seed = int(os.environ.get("GETHSHARDING_TORCH_SOUNDNESS_SEED", "")
                       or 0)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"soundness rate must be in [0, 1], got {rate}")
        if rows < 1:
            raise ValueError(f"soundness rows must be >= 1, got {rows}")
        if reference is None:
            from gethsharding_tpu_torch.sigbackend import PythonSigBackend

            reference = PythonSigBackend()
        self.inner = inner
        self.rate = rate
        self.rows = rows
        self.seed = seed
        self.reference = reference
        self.name = f"soundness+{inner.name}"
        self._lock = threading.Lock()
        self._dispatches: Dict[str, int] = {}
        base = "resilience/soundness"
        registry.gauge(f"{base}/rate").set(rate)
        self._m = {op: {"checks": registry.counter(f"{base}/{op}/checks"),
                        "rows": registry.counter(f"{base}/{op}/rows"),
                        "mismatches": registry.counter(
                            f"{base}/{op}/mismatches"),
                        "invariant_violations": registry.counter(
                            f"{base}/{op}/invariant_violations")}
                   for op in AUDITED_OPS}

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """The operator summary: the configured knobs
        plus what they buy — per-dispatch detection probability and the
        99%-confidence dispatch budget at a representative 64-row
        dispatch with one corrupted row (the hardest-to-hit case: more
        corrupted rows only detect faster)."""
        return {
            "rate": self.rate,
            "rows_per_check": self.rows,
            "reference": self.reference.name,
            "p_detect_per_dispatch_64": round(
                detection_probability(self.rate, self.rows, 64), 6),
            "dispatches_p99_64": dispatches_to_detect(
                self.rate, self.rows, 64) if self.rate > 0 else None,
        }

    # -- the decision plane (the chaos-schedule idiom) ---------------------

    def _tick(self, op: str) -> Tuple[bool, int]:
        """Consume one dispatch slot on `op`; returns (check?, index).
        The verdict for dispatch k never depends on other ops' traffic."""
        with self._lock:
            idx = self._dispatches.get(op, 0)
            self._dispatches[op] = idx + 1
        if self.rate <= 0.0:
            return False, idx
        if self.rate >= 1.0:
            return True, idx
        verdict = random.Random(
            f"{self.seed}:{op}:{idx}").random() < self.rate
        return verdict, idx

    def _select_rows(self, op: str, idx: int, n: int) -> List[int]:
        k = min(self.rows, n)
        return sorted(random.Random(
            f"{self.seed}:{op}:{idx}:rows").sample(range(n), k))

    # -- violation plumbing ------------------------------------------------

    def _violation(self, op: str, kind: str, detail: str) -> None:
        self._m[op][("mismatches" if kind == "mismatch"
                     else "invariant_violations")].inc()
        # the integrity SLO: every violation burns the integrity
        # objective's error budget, so the 2G2T detection budget reads
        # as a burn rate, not just a counter (slo/tracker.py)
        slo.record(slo.INTEGRITY, ok=False)
        tracer = tracing.TRACER
        if tracer.enabled:
            now = time.monotonic()
            tracer.record("resilience/soundness/violation", now, now,
                          tags={"op": op, "kind": kind})
        # silent corruption detected: black-box moment — bundle dumped
        # (async) with the event/span/wire rings leading up to it
        RECORDER.trigger("soundness_violation", dump=True, op=op,
                         violation_kind=kind, detail=detail)
        raise SoundnessViolation(
            f"soundness {kind} on {op}: {detail} "
            f"(backend {self.inner.name} vs reference "
            f"{self.reference.name})")

    # -- the always-on verdict-plane invariant check -----------------------

    def _check_invariants(self, op: str, cols: Tuple, out) -> None:
        """O(rows) pure-python sanity of the verdict plane — runs on
        EVERY dispatch, sampled or not. Catches the corruption classes
        that need no crypto to catch."""
        n = len(cols[0]) if cols else 0
        try:
            got_n = len(out)
        except TypeError:
            self._violation(op, "invariant",
                            f"result is not a sequence: {type(out).__name__}")
        if got_n != n:
            self._violation(op, "invariant",
                            f"{got_n} result rows for {n} input rows")
        if op == "ecrecover_addresses":
            for i, addr in enumerate(out):
                if addr is None:
                    continue
                try:
                    size = len(addr)
                except TypeError:
                    size = -1
                if size != 20:
                    self._violation(op, "invariant",
                                    f"row {i}: recovered address is not "
                                    f"None or 20 bytes ({addr!r})")
            return
        for i, verdict in enumerate(out):
            # the 0/1 domain: a verdict plane pulled off the device must
            # decode to exactly True or False — ints outside {0, 1},
            # floats, strings are dtype/transfer corruption
            if not (isinstance(verdict, bool)
                    or (isinstance(verdict, int) and verdict in (0, 1))
                    or (hasattr(verdict, "dtype") and verdict in (0, 1))):
                self._violation(op, "invariant",
                                f"row {i}: verdict {verdict!r} outside "
                                f"the 0/1 domain")
        if op == "bls_verify_committees":
            # the known-infinity rows: an empty committee aggregates to
            # the point at infinity and proves nothing — True here is
            # corruption no matter what the device claims
            _, sig_rows, pk_rows = cols
            for i, (sigs, pks) in enumerate(zip(sig_rows, pk_rows)):
                if (len(sigs) == 0 or len(pks) == 0) and bool(out[i]):
                    self._violation(op, "invariant",
                                    f"row {i}: empty committee row "
                                    f"verified True")

    # -- the sampled spot-check --------------------------------------------

    def _spot_check(self, op: str, cols: Tuple, out, idx: int) -> None:
        n = len(cols[0]) if cols else 0
        if n == 0:
            return
        picked = self._select_rows(op, idx, n)
        sub = [[col[i] for i in picked] for col in cols]
        want = getattr(self.reference, op)(*sub)
        got = [out[i] for i in picked]
        counters = self._m[op]
        counters["checks"].inc()
        counters["rows"].inc(len(picked))
        # normalize to plain bools for the verdict ops so a tensor or
        # numpy bool compares by VALUE against the scalar python
        if op in _VERDICT_OPS:
            got = [bool(v) for v in got]
            want = [bool(v) for v in want]
        if got != want:
            bad = [picked[j] for j in range(len(picked))
                   if got[j] != want[j]]
            self._violation(op, "mismatch",
                            f"dispatch {idx}, rows {bad}: device said "
                            f"{[got[picked.index(i)] for i in bad]}, "
                            f"reference says "
                            f"{[want[picked.index(i)] for i in bad]}")
        # a clean spot-check is one GOOD integrity event: the SLO's
        # event stream runs at the sampled check rate, so its burn rate
        # is the detected-corruption fraction of audited dispatches
        slo.record(slo.INTEGRITY, ok=True)

    def _audit(self, op: str, cols: Tuple, out) -> None:
        self._check_invariants(op, cols, out)
        check, idx = self._tick(op)
        if check:
            self._spot_check(op, cols, out, idx)

    # -- the SigBackend surface --------------------------------------------

    def ecrecover_addresses(self, digests, sigs65):
        cols = (list(digests), list(sigs65))
        out = self.inner.ecrecover_addresses(*cols)
        self._audit("ecrecover_addresses", cols, out)
        return out

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        cols = (list(messages), list(agg_sigs), list(agg_pks))
        out = self.inner.bls_verify_aggregates(*cols)
        self._audit("bls_verify_aggregates", cols, out)
        return out

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        cols = (list(messages), list(sig_rows), list(pk_rows))
        out = self.inner.bls_verify_committees(*cols,
                                               pk_row_keys=pk_row_keys)
        # the reference recompute never sees pk_row_keys: the scalar
        # backend has no cache, and the check must not depend on one
        self._audit("bls_verify_committees", cols, out)
        return out

    def das_verify_samples(self, chunks, indices, proofs, roots):
        cols = (list(chunks), list(indices), list(proofs), list(roots))
        out = self.inner.das_verify_samples(*cols)
        self._audit("das_verify_samples", cols, out)
        return out

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        # the spot check re-verifies sampled rows against the scalar
        # PCS reference (PythonSigBackend -> das/pcs.verify_multi)
        cols = (list(commitments), list(index_rows), list(eval_rows),
                list(proofs), list(ns))
        out = self.inner.das_verify_multiproofs(*cols)
        self._audit("das_verify_multiproofs", cols, out)
        return out

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        """The overlapped-audit face: the inner submit stays async and
        the audit runs at `result()` time — marshal/dispatch overlap is
        preserved, the scalar recompute lands on the puller. Composed
        under the failover face, the violation surfaces inside ITS
        finalize, which already stamps the submit-time breaker epoch
        and memoizes the fault (at most one per dispatch)."""
        cols = (list(messages), list(sig_rows), list(pk_rows))
        inner = self.inner.bls_verify_committees_async(
            *cols, pk_row_keys=pk_row_keys)
        state: dict = {}

        def finalize():
            # `VerdictFuture.result()` re-runs finalize when it raised:
            # carry a failure memo so a twice-polled violated dispatch
            # counts exactly one mismatch
            if "exc" in state:
                raise state["exc"]
            out = inner.result()
            try:
                self._audit("bls_verify_committees", cols, out)
            except SoundnessViolation as exc:
                state["exc"] = exc
                raise
            return out

        return VerdictFuture(finalize)

    # -- the serving async face (present iff the inner has one) ------------

    def __getattr__(self, name: str):
        # same feature-detection contract as the failover face: `submit`
        # exists on this backend only when the wrapped backend serves it
        if name == "submit" and hasattr(self.inner, "submit"):
            return self._submit
        raise AttributeError(name)

    def _submit(self, op: str, *args, pk_row_keys=None, **kwargs):
        # admission tags (klass/tenant) pass through untouched — the
        # audit has no opinion on queueing policy
        cols = tuple(list(col) for col in args)
        if op == "bls_verify_committees":
            inner = self.inner.submit(op, *cols, pk_row_keys=pk_row_keys,
                                      **kwargs)
        else:
            inner = self.inner.submit(op, *cols, **kwargs)
        if op not in AUDITED_OPS:  # pragma: no cover - SERVING_OPS today
            return inner
        return _SpotCheckFuture(inner,
                                audit=lambda out: self._audit(op, cols, out))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()
