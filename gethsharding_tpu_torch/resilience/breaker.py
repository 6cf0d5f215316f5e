"""Circuit-breaker backend failover: accelerated path over scalar truth
(the port's copy of the JAX package's `resilience/breaker.py`).

The phase-1 notary must vote every period no matter what the underlying
client is doing; a device path adds a way to miss votes — a wedged or
faulting card. The verifier must always be able to fall back to a sound
local check when the accelerated path is suspect. `FailoverSigBackend`
is that fallback, governed by a classic three-state breaker:

- **closed**: calls go to the primary (torch / serving tier). A raising
  primary call is served from the scalar fallback *for that call* and
  counted; `fault_threshold` CONSECUTIVE faults trip the breaker.
- **open**: every call is served from the fallback — the device path
  is not touched at all for `reset_s` seconds.
- **half-open**: after the cooldown, exactly one call becomes a
  differential probe: the fallback computes the authoritative answer,
  the primary recomputes it, and the breaker re-closes ONLY if the two
  agree byte-for-byte. A probe where the PRIMARY raises or disagrees
  re-opens with a fresh cooldown; a probe that reaches NO verdict
  (the fallback raised computing the authoritative answer, or the
  primary shed on backpressure) re-opens without restarting the
  cooldown or counting a primary fault, so the next call re-probes
  immediately. The spot-check matters: a device that "recovers" into
  wrong answers is worse than one that stays down.

The watchdog feeds the breaker through the normal exception path: a
hung dispatch fails its batch's futures with `DeadlineExceeded`, the
failover face catches it like any other primary fault.

Only a caller that chose a ``failover-*`` backend gets this fallback:
the default ``torch`` backend has none, so a fault on the card reaches
its caller.

Observability: gauge ``resilience/breaker/<name>/state`` (0 closed,
1 half-open, 2 open) plus trip/probe/close/fault/fallback counters in
the metrics registry, state-transition log lines, and zero-length
``resilience/breaker/*`` trace events when the span tracer is on.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures
from concurrent.futures import Future
from typing import Callable, Optional

from gethsharding_tpu_torch import metrics, tracing
from gethsharding_tpu_torch.perfwatch import RECORDER
from gethsharding_tpu_torch.resilience.errors import SoundnessViolation
from gethsharding_tpu_torch.sigbackend import SigBackend, VerdictFuture

log = logging.getLogger("resilience.breaker")

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


class CircuitBreaker:
    """The state machine, backend-agnostic: callers ask `on_call()` how
    to route ("primary" | "fallback" | "probe") and report outcomes via
    `record_fault` / `record_success` / `probe_matched` /
    `probe_failed`. Env defaults:
    ``GETHSHARDING_TORCH_BREAKER_THRESHOLD`` (consecutive faults to
    trip, default 3) and ``GETHSHARDING_TORCH_BREAKER_RESET_S`` (open
    cooldown, default 5)."""

    def __init__(self, name: str = "sigbackend",
                 fault_threshold: Optional[int] = None,
                 reset_s: Optional[float] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY,
                 clock: Callable[[], float] = time.monotonic):
        if fault_threshold is None:
            fault_threshold = int(os.environ.get(
                "GETHSHARDING_TORCH_BREAKER_THRESHOLD", "3"))
        if reset_s is None:
            reset_s = float(os.environ.get(
                "GETHSHARDING_TORCH_BREAKER_RESET_S", "5.0"))
        if fault_threshold < 1:
            raise ValueError("fault_threshold must be >= 1")
        self.name = name
        self.fault_threshold = fault_threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        # bumped on every re-close: outcomes of async work submitted
        # BEFORE a recovery (stamped with the epoch at submit time)
        # must not count against the recovered primary
        self._epoch = 0
        base = f"resilience/breaker/{name}"
        self._g_state = registry.gauge(f"{base}/state")
        self._m_trips = registry.counter(f"{base}/trips")
        self._m_closes = registry.counter(f"{base}/closes")
        self._m_probes = registry.counter(f"{base}/probes")
        self._m_probe_mismatches = registry.counter(
            f"{base}/probe_mismatches")
        self._m_faults = registry.counter(f"{base}/primary_faults")

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self._state]

    @property
    def epoch(self) -> int:
        """Staleness stamp for deferred outcomes: capture at submit
        time, hand back to `record_fault`/`record_success` at pull
        time. Bumped on every re-close, so a backlog of watchdog-failed
        futures from BEFORE a recovery cannot re-trip the breaker
        against the recovered primary when the caller finally drains
        them."""
        return self._epoch

    # -- the routing decision ----------------------------------------------

    def on_call(self) -> str:
        """Route one call: 'primary' (closed), 'fallback' (open /
        probe already in flight), or 'probe' (this caller runs the
        differential spot-check)."""
        with self._lock:
            if self._state == CLOSED:
                return "primary"
            if self._state == OPEN and not self._probing \
                    and self._clock() - self._opened_at >= self.reset_s:
                self._state = HALF_OPEN
                self._probing = True
                self._m_probes.inc()
                self._g_state.set(HALF_OPEN)
                self._event("probe")
                return "probe"
            return "fallback"

    # -- outcome reports ---------------------------------------------------

    def record_fault(self, exc: Optional[BaseException] = None,
                     epoch: Optional[int] = None) -> None:
        """One primary fault; trips the breaker at the threshold. An
        `epoch` older than the current one marks a STALE deferred
        outcome (submitted before the last re-close): it is counted on
        the fault metric but not toward tripping."""
        with self._lock:
            self._m_faults.inc()
            if epoch is not None and epoch != self._epoch:
                return
            self._consecutive += 1
            if self._state == CLOSED \
                    and self._consecutive >= self.fault_threshold:
                self._trip_locked(
                    f"{self._consecutive} consecutive primary faults"
                    + (f"; last: {exc!r}" if exc is not None else ""))

    def record_success(self, epoch: Optional[int] = None) -> None:
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return  # a stale success must not mask fresh faults
            self._consecutive = 0

    def probe_matched(self) -> None:
        """Differential spot-check agreed: re-promote the primary."""
        with self._lock:
            self._state = CLOSED
            self._probing = False
            self._consecutive = 0
            self._epoch += 1
            self._m_closes.inc()
            self._g_state.set(CLOSED)
            self._event("close")
        log.warning("breaker %s closed: half-open probe matched the "
                    "fallback (primary re-promoted)", self.name)

    def probe_failed(self, mismatch: bool,
                     detail: Optional[str] = None) -> None:
        """Probe raised (mismatch=False) or disagreed with the fallback
        (mismatch=True): back to open with a fresh cooldown."""
        with self._lock:
            if mismatch:
                self._m_probe_mismatches.inc()
            else:
                self._m_faults.inc()
            self._state = OPEN
            self._probing = False
            self._opened_at = self._clock()
            self._g_state.set(OPEN)
            self._event("reopen")
        # re-open after a failed probe: ring event only — the trip that
        # opened this episode already dumped its bundle
        RECORDER.record("breaker_reopen", breaker=self.name,
                        mismatch=mismatch, detail=detail)
        log.warning("breaker %s re-opened: probe %s%s", self.name,
                    "MISMATCHED the fallback" if mismatch else "raised",
                    f" ({detail})" if detail else "")

    def probe_aborted(self, detail: Optional[str] = None) -> None:
        """The probe reached no verdict on the primary — the fallback
        raised computing the authoritative answer, or the primary shed
        on backpressure. Back to open, but with the ORIGINAL cooldown
        timestamp and no primary-fault count: the next eligible call
        re-probes immediately instead of benching a possibly-healthy
        primary for a fresh `reset_s` over a non-verdict."""
        with self._lock:
            self._state = OPEN
            self._probing = False
            self._g_state.set(OPEN)
            self._event("probe_abort")
        log.warning("breaker %s probe aborted without a verdict%s",
                    self.name, f" ({detail})" if detail else "")

    def _trip_locked(self, reason: str) -> None:
        self._state = OPEN
        self._probing = False
        self._opened_at = self._clock()
        self._m_trips.inc()
        self._g_state.set(OPEN)
        self._event("trip")
        # a trip is a black-box moment: event into the flight-recorder
        # ring + a post-mortem bundle (the dump IO runs on the
        # recorder's own thread, never under this lock)
        RECORDER.trigger("breaker_trip", dump=True, breaker=self.name,
                         reason=reason)
        log.warning("breaker %s open: %s — serving from the scalar "
                    "fallback for %.1fs before probing", self.name,
                    reason, self.reset_s)

    def _event(self, kind: str) -> None:
        tracer = tracing.TRACER
        if tracer.enabled:
            now = time.monotonic()
            tracer.record(f"resilience/breaker/{kind}", now, now,
                          tags={"breaker": self.name,
                                "state": _STATE_NAMES[self._state]})


class _FailoverFuture:
    """`concurrent.futures.Future`-compatible (on `result`) wrapper
    around a primary async submit: a primary failure surfacing at
    `result()` is recorded as a fault and recomputed on the fallback —
    the waking caller never sees the device error."""

    __slots__ = ("_inner", "_recover", "_on_success", "_done", "_value",
                 "_exc")

    def __init__(self, inner: Future, recover: Callable,
                 on_success: Callable[[], None]):
        self._inner = inner
        self._recover = recover
        self._on_success = on_success
        self._done = False
        self._value = None
        self._exc: Optional[BaseException] = None

    def result(self, timeout=None):
        # idempotent like a real Future: a second result() must not
        # double-count the fault or recompute the fallback — including
        # when the fallback recovery itself raised (the failure is
        # cached and re-raised, not re-derived)
        if self._done:
            if self._exc is not None:
                raise self._exc
            return self._value
        try:
            out = self._inner.result(timeout)
        except (TimeoutError, futures.TimeoutError):
            # the CALLER's timeout on a still-pending batch, not a
            # device fault: re-raise so a later poll can still succeed
            # (both spellings: the classes only merged in python 3.11)
            raise
        except Exception as exc:  # noqa: BLE001 - any primary escape
            try:
                self._value = self._recover(exc)
            except Exception as recover_exc:  # noqa: BLE001
                self._exc = recover_exc
                self._done = True
                raise
            self._done = True
            return self._value
        self._on_success()
        self._value = out
        self._done = True
        return out

    def done(self) -> bool:
        return self._inner.done()

    @property
    def _serving_request(self):
        # tracing passthrough: observe_future_wake attributes caller
        # wake latency via the serving future's request record — hiding
        # it here would silently drop the future_wake span whenever
        # failover wraps the serving tier
        return getattr(self._inner, "_serving_request", None)


class FailoverSigBackend(SigBackend):
    """Drop-in `SigBackend`: primary behind a breaker, scalar fallback.

    Registered as ``failover-torch`` / ``failover-python`` (and composed
    by the node over the serving tier for ``--serving``). `.inner` is
    the primary so backend-nature unwrapping keeps working.
    """

    def __init__(self, primary: SigBackend,
                 fallback: Optional[SigBackend] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        if fallback is None:
            from gethsharding_tpu_torch.sigbackend import get_backend

            fallback = get_backend("python")
        self.inner = self.primary = primary
        self.fallback = fallback
        self.breaker = breaker or CircuitBreaker(registry=registry)
        self.name = f"failover+{primary.name}"
        base = f"resilience/breaker/{self.breaker.name}"
        self._m_primary_calls = registry.counter(f"{base}/primary_calls")
        self._m_fallback_calls = registry.counter(f"{base}/fallback_calls")

    # -- the routed call core ----------------------------------------------

    @staticmethod
    def _is_backpressure(exc: BaseException) -> bool:
        """Backpressure sheds are the CALLER's weather, not a device
        fault: counting them would trip the breaker (and defeat the
        shed policy with synchronous fallback recomputes) exactly when
        load peaks. Lazy import: the serving tier is optional."""
        from gethsharding_tpu_torch.serving.queue import ServingOverloadError

        return isinstance(exc, ServingOverloadError)

    @staticmethod
    def _is_caller_error(exc: BaseException) -> bool:
        """Deterministic input-validation errors raised at call or
        admission time (ragged rows, wrong types) are the CALLER's
        bug, not a device fault: counting them would let one buggy
        caller trip the breaker and demote a healthy device for
        everyone. They re-raise — the fallback would reject the same
        input. (A ValueError surfacing DURING a half-open probe still
        counts: the fallback accepted that input, so disagreeing on it
        is a primary defect.)"""
        return isinstance(exc, (ValueError, TypeError))

    def _fault(self, exc: BaseException,
               epoch: Optional[int] = None) -> None:
        self.breaker.record_fault(exc, epoch=epoch)
        log.warning("primary sigbackend %s fault (served from %s): %r",
                    self.primary.name, self.fallback.name, exc)

    def _call(self, op: str, *args, decision: Optional[str] = None,
              **kwargs):
        if decision is None:
            decision = self.breaker.on_call()
        if decision == "primary":
            self._m_primary_calls.inc()
            try:
                out = getattr(self.primary, op)(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - any device escape
                if self._is_backpressure(exc) or self._is_caller_error(exc):
                    raise  # the caller's problem: fast failure, no fault
                self._fault(exc)
                self._m_fallback_calls.inc()
                return getattr(self.fallback, op)(*args, **kwargs)
            self.breaker.record_success()
            return out
        if decision == "probe":
            # differential spot-check: the fallback's answer is served
            # either way; the primary only re-promotes by AGREEING
            try:
                want = getattr(self.fallback, op)(*args, **kwargs)
            except Exception:
                # the PROBE must conclude even when the fallback itself
                # raises — a dangling _probing flag would bench the
                # primary forever with every later call routed fallback
                self.breaker.probe_aborted("fallback raised during probe")
                raise
            try:
                got = getattr(self.primary, op)(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001
                if self._is_backpressure(exc):
                    # a shed at probe time is the caller's weather, not
                    # a verdict on the device — same exemption as the
                    # closed path: conclude the probe without a fault
                    # or a fresh cooldown so the next call re-probes
                    self.breaker.probe_aborted("primary shed the probe")
                elif isinstance(exc, SoundnessViolation):
                    # the spot-checker inside the primary slot already
                    # compared against the same scalar truth this probe
                    # would have: that IS the differential verdict.
                    # Count it once, on probe_mismatches — not also as
                    # a primary fault (no double-accounting).
                    self.breaker.probe_failed(mismatch=True,
                                              detail=repr(exc))
                else:
                    self.breaker.probe_failed(mismatch=False,
                                              detail=repr(exc))
                return want
            if got == want:
                self.breaker.probe_matched()
            else:
                self.breaker.probe_failed(mismatch=True,
                                          detail=f"op {op}")
            return want
        self._m_fallback_calls.inc()
        return getattr(self.fallback, op)(*args, **kwargs)

    # -- the SigBackend surface --------------------------------------------

    def ecrecover_addresses(self, digests, sigs65):
        return self._call("ecrecover_addresses", digests, sigs65)

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        return self._call("bls_verify_aggregates", messages, agg_sigs,
                          agg_pks)

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        return self._call("bls_verify_committees", messages, sig_rows,
                          pk_rows, pk_row_keys=pk_row_keys)

    def das_verify_samples(self, chunks, indices, proofs, roots):
        return self._call("das_verify_samples", chunks, indices, proofs,
                          roots)

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        return self._call("das_verify_multiproofs", commitments,
                          index_rows, eval_rows, proofs, ns)

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        """The overlapped-audit face: primary-routed submits stay
        async (the fault, if any, surfaces at `result()` and is
        recovered on the fallback there); degraded modes compute
        eagerly and return a resolved future — same contract, no
        overlap, which is exactly the degradation the breaker exists
        to make graceful."""
        decision = self.breaker.on_call()
        if decision == "primary":
            self._m_primary_calls.inc()
            # epoch stamp: this submit's outcome may be pulled long
            # after a watchdog trip and probe recovery — stale faults
            # must not re-trip the breaker against the recovered device
            epoch = self.breaker.epoch
            try:
                inner = self.primary.bls_verify_committees_async(
                    messages, sig_rows, pk_rows, pk_row_keys=pk_row_keys)
            except Exception as exc:  # noqa: BLE001 - submit-time fault
                if self._is_backpressure(exc) or self._is_caller_error(exc):
                    raise
                self._fault(exc, epoch=epoch)
                self._m_fallback_calls.inc()
                out = self.fallback.bls_verify_committees(
                    messages, sig_rows, pk_rows, pk_row_keys=pk_row_keys)
                future = VerdictFuture(lambda: out)
                future.result()
                return future

            # `VerdictFuture.result()` re-runs finalize when it raised
            # (only success is cached), so finalize carries its own
            # failure memo — a caller that polls result() twice on one
            # failed verification must not count two primary faults or
            # re-derive the fallback failure
            state: dict = {}

            def finalize():
                if "exc" in state:
                    raise state["exc"]
                try:
                    out = inner.result()
                except Exception as exc:  # noqa: BLE001 - pull-time fault
                    if (self._is_backpressure(exc)
                            or self._is_caller_error(exc)):
                        # same exemption as the sync path: the caller's
                        # problem surfacing late is still not a device
                        # fault
                        state["exc"] = exc
                        raise
                    self._fault(exc, epoch=epoch)
                    self._m_fallback_calls.inc()
                    try:
                        return self.fallback.bls_verify_committees(
                            messages, sig_rows, pk_rows,
                            pk_row_keys=pk_row_keys)
                    except Exception as fallback_exc:  # noqa: BLE001
                        state["exc"] = fallback_exc
                        raise
                self.breaker.record_success(epoch=epoch)
                return out

            return VerdictFuture(finalize)
        out = self._call("bls_verify_committees", messages, sig_rows,
                         pk_rows, pk_row_keys=pk_row_keys,
                         decision=decision)
        future = VerdictFuture(lambda: out)
        future.result()
        return future

    # -- the serving async face (present iff the primary has one) ----------

    def __getattr__(self, name: str):
        # `submit` exists on this backend only when the primary serves
        # it (a serving-tier primary): callers feature-detect with
        # getattr, and advertising an async face over a scalar primary
        # would be a lie
        if name == "submit" and hasattr(self.primary, "submit"):
            return self._submit
        raise AttributeError(name)

    def _fallback_rows(self, op: str, args, kwargs):
        # admission tags (klass/tenant) are serving-tier vocabulary the
        # scalar fallback's plain SigBackend surface does not speak
        kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("klass", "tenant")}
        return getattr(self.fallback, op)(*args, **kwargs)

    def _submit(self, op: str, *args, **kwargs) -> Future:
        decision = self.breaker.on_call()
        if decision == "primary":
            self._m_primary_calls.inc()
            epoch = self.breaker.epoch  # see bls_verify_committees_async
            try:
                inner = self.primary.submit(op, *args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - admission fault
                if self._is_backpressure(exc) or self._is_caller_error(exc):
                    raise
                self._fault(exc, epoch=epoch)
                self._m_fallback_calls.inc()
                future: Future = Future()
                future.set_result(self._fallback_rows(op, args, kwargs))
                return future

            def recover(exc):
                if self._is_backpressure(exc) or self._is_caller_error(exc):
                    raise exc  # the caller's problem, not a device fault
                self._fault(exc, epoch=epoch)
                self._m_fallback_calls.inc()
                return self._fallback_rows(op, args, kwargs)

            return _FailoverFuture(
                inner, recover,
                lambda: self.breaker.record_success(epoch=epoch))
        future = Future()
        # admission tags are serving vocabulary; the routed sync call
        # (fallback or probe) does not speak them
        kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("klass", "tenant")}
        future.set_result(
            self._call(op, *args, decision=decision, **kwargs))
        return future

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        close = getattr(self.primary, "close", None)
        if close is not None:
            close()


def breaker_of(backend):
    """The failover breaker governing `backend`, found by walking the
    wrapper chain (`.breaker` on the failover face; `.inner` hops through
    the serving, soundness and chaos wrappers). None when the composition
    has no breaker. (The port's copy of the JAX package's
    `fleet/router.py::breaker_of`, which the chain process's
    `shard_health` reads and `fleet/router.py` re-exports.)"""
    probe, hops = backend, 0
    while probe is not None and hops < 8:
        breaker = getattr(probe, "breaker", None)
        if breaker is not None:
            return breaker
        probe = getattr(probe, "inner", None)
        hops += 1
    return None
