"""Bounded admission queue: futures, classes, quotas, deadline flush (the
port's copy of the JAX package's `serving/queue.py`).

The front door of the serving tier. Producers (actor threads, other
callers' threads) `put()` requests; ONE consumer per operation drains
with `take_batch()`, which blocks until a flush condition holds:

- **full**: at least `max_batch` rows are queued — a full device bucket
  is ready, dispatch now;
- **deadline**: a class's flush deadline elapsed since ITS oldest
  queued request (base ``flush_us`` scaled by the class's
  ``flush_mult`` — an interactive request never waits longer than the
  latency budget for company that isn't coming, while bulk waits
  longer for a fuller bucket);
- **close**: shutdown drains whatever is left.

The queue is CLASS-AWARE (`serving/classes.py`): one FIFO per admission
class inside each queue, so a catch-up replay burst and an interactive
call are never the same kind of occupancy:

- `take_batch` assembles a batch with a WEIGHTED drain: each nonempty
  class is guaranteed its weight share of `max_batch` (priority order
  fills first and takes any leftover), so bulk can never starve
  interactive and interactive can never fully starve bulk;
- overload sheds BY CLASS: a higher-priority arrival displaces queued
  lower-priority work (catchup first, interactive last — the victims'
  futures fail with `ServingOverloadError`) before the arrival itself
  is shed or blocked;
- per-TENANT row quotas bound any one tenant's queue occupancy
  (`TenantQuotaExceeded`, a `ServingOverloadError`), so a single noisy
  caller cannot crowd out the rest;
- INSIDE a class, the drain is weighted-fair ACROSS TENANTS (deficit
  round-robin): each batch cycle hands every queued tenant an equal
  row quantum of the class's share, deficits carried between batches
  so a tenant whose requests are bigger than one quantum still clears
  — a heavy tenant below its quota can therefore not starve a light
  tenant in the same class, it can only consume the shares light
  tenants leave unused (untenanted traffic is one bucket);
- a class may carry an EXPIRY deadline: requests queued longer are
  failed with `ClassDeadlineExceeded` instead of occupying capacity
  forever.

Backpressure is explicit, not accidental: when queued rows reach
`cap_rows` (and nothing lower-priority is left to displace), `put()`
either blocks until the drain frees space (policy ``block`` — callers
absorb the device's pace) or raises `ServingOverloadError` immediately
(policy ``shed``). A closed queue fails fast with `QueueClosed` — work
must never be silently enqueued into (or left blocked against) a dead
queue. Capacity is accounted in ROWS (verification items), not request
objects, since rows are what size the device batch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from gethsharding_tpu_torch import slo
from gethsharding_tpu_torch.serving.classes import (
    ADMISSION_CLASSES,
    CLASS_INTERACTIVE,
    SHED_ORDER,
    check_class,
    default_policies,
)


class ServingOverloadError(RuntimeError):
    """The admission queue is at capacity and the policy is ``shed``
    (or this request was displaced by a higher-priority class)."""


class QueueClosed(ServingOverloadError):
    """`put()` on a closed queue — fail fast, never enqueue into (or
    stay blocked against) a queue nothing will ever drain."""


class TenantQuotaExceeded(ServingOverloadError):
    """One tenant's queued rows reached its quota; the request is
    refused without consuming shared capacity."""


class ClassDeadlineExceeded(ServingOverloadError):
    """The request overran its admission class's queue-wait deadline
    and was expired. A `ServingOverloadError` subclass on purpose: the
    failover face treats it as the caller's weather (late work shed
    under load), never a device fault."""


class Request:
    """One caller's batch of verification rows plus its completion future.

    `args` holds the operation's per-row parallel sequences (e.g.
    ``(digests, sigs65)``); `rows` is their common length. The future
    resolves to the per-row results in the caller's own order. `klass`
    is the admission class (serving/classes.py) and `tenant` the quota
    bucket ("" = untenanted).

    Trace fields: `trace_ctx` is the submitting caller's
    (trace_id, span_id) captured at enqueue (None when tracing is off),
    and `t_taken`/`t_dispatch`/`t_done` are the phase boundaries the
    batcher stamps as the request crosses threads — queue wait ends at
    `t_taken`, batch assembly at `t_dispatch`, device execution at
    `t_done`. `trace_ids` is set once the request's spans are emitted
    so the caller-side future wake can attach to the same trace.
    """

    __slots__ = ("op", "args", "rows", "future", "enqueued_at",
                 "klass", "tenant",
                 "trace_ctx", "t_taken", "t_dispatch", "t_done",
                 "trace_ids")

    def __init__(self, op: str, args: tuple, rows: int,
                 klass: str = CLASS_INTERACTIVE, tenant: str = ""):
        self.op = op
        self.args = args
        self.rows = rows
        self.klass = check_class(klass)
        self.tenant = tenant or ""
        self.future: Future = Future()
        self.enqueued_at = time.monotonic()
        self.trace_ctx = None
        self.t_taken = 0.0
        self.t_dispatch = 0.0
        self.t_done = 0.0
        self.trace_ids = None

    def wait_s(self, now: Optional[float] = None) -> float:
        """Seconds this request has been queued."""
        return (time.monotonic() if now is None else now) - self.enqueued_at


class AdmissionQueue:
    """Bounded, class-aware FIFO of `Request`s with deadline flush.

    One queue per operation; `take_batch()` drains WHOLE requests (a
    request's rows are never split across dispatches) up to `max_batch`
    rows, always taking at least one request so an oversized caller
    batch still flows through as its own dispatch. With ``registry``
    and ``label`` the queue emits its own shed/expiry/quota counters
    (``serving/<label>/class/<class>/...``) — the events happen here,
    where the batcher cannot see them.
    """

    FLUSH_FULL = "full"
    FLUSH_DEADLINE = "deadline"
    FLUSH_CLOSE = "close"

    def __init__(self, cap_rows: int = 4096, policy: str = "block",
                 max_batch: int = 128, flush_us: float = 500.0,
                 policies: Optional[Dict] = None,
                 tenant_quota_rows: Optional[int] = None,
                 registry=None, label: str = ""):
        if policy not in ("block", "shed"):
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"choose 'block' or 'shed'")
        if cap_rows < max_batch:
            # a cap below one flush quantum would let the queue starve the
            # batcher of ever reaching a full bucket
            cap_rows = max_batch
        self.cap_rows = cap_rows
        self.policy = policy
        self.max_batch = max_batch
        self.flush_s = flush_us / 1e6
        self.policies = policies or default_policies()
        if tenant_quota_rows is None:
            tenant_quota_rows = int(os.environ.get(
                "GETHSHARDING_TORCH_TENANT_QUOTA_ROWS", "0") or 0)
        self.tenant_quota_rows = tenant_quota_rows
        self.shed_requests = 0
        self.shed_rows = 0
        self.shed_by_class: Dict[str, int] = {c: 0 for c in ADMISSION_CLASSES}
        self.expired_by_class: Dict[str, int] = {
            c: 0 for c in ADMISSION_CLASSES}
        self.quota_rejections = 0
        self._by_class: Dict[str, List[Request]] = {
            c: [] for c in ADMISSION_CLASSES}
        self._class_rows: Dict[str, int] = {c: 0 for c in ADMISSION_CLASSES}
        self._tenant_rows: Dict[str, int] = {}
        # deficit-round-robin state for the tenant-fair drain: per-class
        # carried row deficits and the rotation cursor (see
        # _drain_class_locked)
        self._drr_deficit: Dict[str, Dict[str, int]] = {}
        self._drr_rotation: Dict[str, int] = {}
        self._rows = 0
        self._count = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._metrics = None
        if registry is not None and label:
            base = f"serving/{label}"
            self._metrics = {
                "shed": {c: registry.counter(f"{base}/class/{c}/shed")
                         for c in ADMISSION_CLASSES},
                "expired": {c: registry.counter(f"{base}/class/{c}/expired")
                            for c in ADMISSION_CLASSES},
                "quota": registry.counter(f"{base}/quota_rejections"),
            }

    # -- producer side -----------------------------------------------------

    def put(self, request: Request) -> None:
        """Admit `request`, applying quota, shed-by-class and the
        backpressure policy at the cap.

        A request is admitted whenever current depth is below the cap
        (even if its own rows push past it) — an always-oversized request
        must not deadlock against a cap it can never fit under. The same
        high-water semantics apply to the tenant quota.
        """
        with self._lock:
            if self._closed:
                raise QueueClosed(
                    f"serving queue for {request.op} is closed")
            if self.tenant_quota_rows > 0 and request.tenant:
                held = self._tenant_rows.get(request.tenant, 0)
                if held >= self.tenant_quota_rows:
                    self.quota_rejections += 1
                    if self._metrics is not None:
                        self._metrics["quota"].inc()
                    raise TenantQuotaExceeded(
                        f"tenant {request.tenant!r} holds {held} queued "
                        f"rows (quota {self.tenant_quota_rows}); "
                        f"request refused")
            while self._rows >= self.cap_rows:
                if self._shed_lower_locked(request):
                    continue  # displaced lower-priority work; re-check
                if self.policy == "shed":
                    self.shed_requests += 1
                    self.shed_rows += request.rows
                    self.shed_by_class[request.klass] += 1
                    if self._metrics is not None:
                        self._metrics["shed"][request.klass].inc()
                    raise ServingOverloadError(
                        f"serving queue for {request.op} at capacity "
                        f"({self._rows}/{self.cap_rows} rows); "
                        f"{request.klass} request shed")
                self._not_full.wait()
                if self._closed:
                    raise QueueClosed(
                        f"serving queue for {request.op} closed while "
                        f"this request was blocked on admission")
            self._by_class[request.klass].append(request)
            self._class_rows[request.klass] += request.rows
            if request.tenant:
                self._tenant_rows[request.tenant] = (
                    self._tenant_rows.get(request.tenant, 0)
                    + request.rows)
            self._rows += request.rows
            self._count += 1
            self._not_empty.notify()

    def _shed_lower_locked(self, request: Request) -> bool:
        """Displace queued work of strictly LOWER priority than the
        arriving request — catchup first, interactive last — until the
        queue is below the cap or nothing lower remains. Newest victims
        first: the oldest queued work is closest to flushing and has
        absorbed the most wait already. Victim futures fail HERE, under
        the lock — nothing in this tier registers done-callbacks on
        request futures (callers block in ``result()``, whose wake
        rides the future's own condition), and deferring the failure
        would strand victims behind a subsequently-blocked putter.
        Returns True when anything was displaced."""
        arriving = self.policies[request.klass].priority
        displaced = False
        for klass in SHED_ORDER:
            if self.policies[klass].priority <= arriving:
                continue  # never displace same-or-higher priority
            items = self._by_class[klass]
            while items and self._rows >= self.cap_rows:
                victim = items.pop()
                self._unaccount_locked(victim)
                self.shed_requests += 1
                self.shed_rows += victim.rows
                self.shed_by_class[klass] += 1
                if self._metrics is not None:
                    self._metrics["shed"][klass].inc()
                if not victim.future.done():
                    victim.future.set_exception(ServingOverloadError(
                        f"{klass} request shed by class: displaced by "
                        f"{request.klass} under overload"))
                    # displacement burns the victim class's SLO error
                    # budget — shed-under-overload is exactly what the
                    # burn-rate plane must see (slo/tracker.py)
                    slo.record(klass, ok=False)
                displaced = True
            if self._rows < self.cap_rows:
                break
        return displaced

    def _unaccount_locked(self, request: Request) -> None:
        self._rows -= request.rows
        self._count -= 1
        self._class_rows[request.klass] -= request.rows
        if request.tenant:
            left = self._tenant_rows.get(request.tenant, 0) - request.rows
            if left > 0:
                self._tenant_rows[request.tenant] = left
            else:
                self._tenant_rows.pop(request.tenant, None)

    # -- consumer side -----------------------------------------------------

    def take_batch(self) -> Tuple[Optional[List[Request]], str]:
        """Block until a flush condition holds; drain one batch.

        Returns ``(requests, reason)`` with reason in {'full',
        'deadline', 'close'}; ``(None, 'close')`` once closed AND empty.
        """
        with self._lock:
            while True:
                now = time.monotonic()
                self._expire_locked(now)
                if self._count:
                    if self._rows >= self.max_batch:
                        reason = self.FLUSH_FULL
                        break
                    if self._closed:
                        reason = self.FLUSH_CLOSE
                        break
                    flush_at, expire_at = self._deadlines_locked()
                    if flush_at is not None and flush_at <= now:
                        reason = self.FLUSH_DEADLINE
                        break
                    wake_at = flush_at
                    if expire_at is not None and (
                            wake_at is None or expire_at < wake_at):
                        wake_at = expire_at
                    self._not_empty.wait(
                        timeout=None if wake_at is None
                        else max(0.0, wake_at - now))
                else:
                    if self._closed:
                        return None, self.FLUSH_CLOSE
                    self._not_empty.wait()
            batch = self._assemble_locked()
            self._not_full.notify_all()
            return batch, reason

    def _deadlines_locked(self):
        """(earliest per-class flush deadline, earliest per-class expiry
        deadline) over the nonempty classes (None = no such deadline)."""
        flush_at = expire_at = None
        for klass, items in self._by_class.items():
            if not items:
                continue
            policy = self.policies[klass]
            head = items[0].enqueued_at
            deadline = head + self.flush_s * policy.flush_mult
            if flush_at is None or deadline < flush_at:
                flush_at = deadline
            if policy.deadline_s is not None:
                expiry = head + policy.deadline_s
                if expire_at is None or expiry < expire_at:
                    expire_at = expiry
        return flush_at, expire_at

    def _expire_locked(self, now: float) -> None:
        """Fail requests whose queue wait overran their class deadline
        (`ClassDeadlineExceeded`, failed here for the same reasons as
        `_shed_lower_locked` — an empty-again queue would otherwise
        strand the victims behind the consumer's next indefinite
        wait)."""
        freed = False
        for klass, items in self._by_class.items():
            deadline_s = self.policies[klass].deadline_s
            if deadline_s is None:
                continue
            while items and now - items[0].enqueued_at > deadline_s:
                victim = items.pop(0)
                self._unaccount_locked(victim)
                self.expired_by_class[klass] += 1
                if self._metrics is not None:
                    self._metrics["expired"][klass].inc()
                if not victim.future.done():
                    victim.future.set_exception(ClassDeadlineExceeded(
                        f"{klass} request expired after "
                        f"{victim.wait_s(now):.3f}s in the {victim.op} "
                        f"queue (class deadline {deadline_s}s)"))
                    # an expiry is a missed request: charge the class's
                    # SLO error budget like any other failure
                    slo.record(klass, ok=False)
                freed = True
        if freed:
            # expiry freed capacity: blocked putters must see it
            self._not_full.notify_all()

    def _assemble_locked(self) -> List[Request]:
        """The weighted drain: pass 1 grants every nonempty class its
        weight share of `max_batch` in priority order; pass 2 hands any
        leftover capacity out in priority order. Whole requests only; a
        batch always takes at least one request (an oversized caller
        batch flows through as its own dispatch). Inside a class the
        take is tenant-fair — `_drain_class_locked`'s deficit
        round-robin."""
        ordered = sorted(
            (klass for klass in ADMISSION_CLASSES if self._by_class[klass]),
            key=lambda klass: self.policies[klass].priority)
        total_weight = sum(self.policies[k].weight for k in ordered) or 1
        batch: List[Request] = []
        rows = 0
        for klass in ordered:
            budget = max(1, (self.max_batch
                             * self.policies[klass].weight) // total_weight)
            rows = self._drain_class_locked(klass, batch, rows, budget)
        for klass in ordered:  # pass 2: leftovers, priority first
            rows = self._drain_class_locked(klass, batch, rows, None)
        return batch

    def _account_take_locked(self, request: Request, batch: List[Request],
                             rows: int) -> int:
        """Book one taken request (the caller owns its removal from
        the class list)."""
        self._unaccount_locked(request)
        batch.append(request)
        return rows + request.rows

    def _drain_class_locked(self, klass: str, batch: List[Request],
                            rows: int, budget: Optional[int]) -> int:
        """Drain one class into `batch`, weighted-fair across its
        queued tenants (`budget` = the class's pass-1 row share; None
        = pass 2, capacity-bound only). Returns the updated batch row
        count.

        Single-tenant backlogs drain FIFO (the pre-WFQ behavior, no
        overhead). With several tenants queued, a deficit round-robin
        hands each tenant an equal row quantum per cycle, oldest
        requests first WITHIN a tenant; deficits persist across
        batches (`_drr_deficit`) so a tenant whose requests are larger
        than one quantum accumulates the right to clear them instead
        of starving by size, and the rotation cursor advances each
        batch so no tenant owns the front of every cycle. Cost: one
        pass to split the backlog into per-tenant deques, O(1) per
        take, one pass to rebuild the remainder — the admission lock
        is never held for a per-take list scan."""
        items = self._by_class[klass]
        if not items:
            return rows
        cap = self.max_batch
        taken = 0
        by_tenant: Dict[str, deque] = {}
        for request in items:
            by_tenant.setdefault(request.tenant, deque()).append(request)
        if len(by_tenant) <= 1:
            count = 0
            while count < len(items) \
                    and (not batch
                         or ((budget is None or taken < budget)
                             and rows + items[count].rows <= cap)):
                request = items[count]
                taken += request.rows
                rows = self._account_take_locked(request, batch, rows)
                count += 1
            del items[:count]
            return rows
        tenants = list(by_tenant)
        deficits = self._drr_deficit.setdefault(klass, {})
        for tenant in list(deficits):
            if tenant not in by_tenant:
                deficits.pop(tenant)  # drained away: deficit resets
        n = len(tenants)
        start = self._drr_rotation.get(klass, 0) % n
        if budget is not None:
            # advance once per take_batch (pass 1 only — pass 2 reuses
            # the same cycle's cursor, else 2-tenant rotations cancel)
            self._drr_rotation[klass] = start + 1
        order = tenants[start:] + tenants[:start]
        quantum = max(1, (cap if budget is None else budget) // n)
        taken_ids: set = set()
        remaining = len(items)
        # a deficit-blocked head clears within head.rows/quantum extra
        # rounds; the guard only backstops a logic error
        for _ in range(4 * cap + 4):
            progress = False
            deficit_blocked = False
            for tenant in order:
                queue = by_tenant[tenant]
                if not queue:
                    continue
                if batch and (rows + queue[0].rows > cap or (
                        budget is not None and taken >= budget)):
                    # capacity/budget-walled at cycle start: no
                    # accrual — classic DRR credits a flow only on a
                    # genuine sending opportunity, else a walled
                    # tenant banks unearned quantum every cycle and
                    # monopolizes later batches
                    continue
                deficits[tenant] = min(
                    deficits.get(tenant, 0) + quantum, cap + quantum)
                while queue:
                    head = queue[0]
                    if batch:
                        if rows + head.rows > cap or (
                                budget is not None and taken >= budget):
                            break  # capacity/budget wall
                        if deficits[tenant] < head.rows:
                            deficit_blocked = True
                            break  # next cycle's quantum may clear it
                    queue.popleft()
                    taken_ids.add(id(head))
                    remaining -= 1
                    deficits[tenant] = max(
                        0, deficits.get(tenant, 0) - head.rows)
                    taken += head.rows
                    rows = self._account_take_locked(head, batch, rows)
                    progress = True
            if remaining == 0 or (budget is not None and taken >= budget):
                break
            if not progress and not deficit_blocked:
                break  # capacity-walled: no quantum can help
        if taken_ids:
            items[:] = [r for r in items if id(r) not in taken_ids]
        return rows

    def close(self) -> None:
        """Stop admitting; wake the consumer to drain the remainder and
        any blocked putters to fail fast with `QueueClosed`."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    # -- observability -----------------------------------------------------

    @property
    def depth_rows(self) -> int:
        return self._rows

    @property
    def depth_requests(self) -> int:
        return self._count

    def class_depth_rows(self, klass: str) -> int:
        return self._class_rows[klass]
