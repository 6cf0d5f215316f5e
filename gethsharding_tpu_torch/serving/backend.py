"""ServingSigBackend: the drop-in `SigBackend` over the serving tier, and
`ClassedSigBackend`, its fixed-class view that fleet tenants take (the
port's copy of the JAX package's `serving/backend.py`).

Two faces on one coalescing core:

- the exact synchronous `SigBackend` API — actors keep their code;
  each call enqueues and blocks on its own future, so N concurrent
  actor/handler threads making small calls share device dispatches
  (differential-tested byte-identical against the wrapped backend);
- the async ``submit(op, *rows) -> Future`` API for callers that can
  overlap — the notary prefetches collation bodies while its proposer
  signatures recover.

The wrapper is deliberately thin: admission, flush, backpressure, and
pipelining all live in `batcher.py`/`queue.py`/`pipeline.py`; this
module only validates shapes and normalizes the committee call's
optional `pk_row_keys` so rows from keyed and keyless callers coalesce
into one dispatch.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Sequence

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.serving.batcher import (
    SERVING_OPS,
    MicroBatcher,
    observe_future_wake,
)
from gethsharding_tpu_torch.sigbackend import SigBackend


@dataclass
class ServingConfig:
    """The serving tier's knobs (CLI: --serving-*).

    - ``max_batch``: flush as soon as this many rows are queued
      (rounded to a sigbackend bucket so a full flush IS a padded
      shape).
    - ``flush_us``: the deadline — a request never waits longer than
      this for coalescing company. The latency/amortization dial:
      0 serves every request solo, hundreds of µs amortize dispatch
      overhead at little added latency next to a pairing kernel.
    - ``queue_cap``: admission cap in rows; beyond it the backpressure
      policy applies.
    - ``policy``: ``block`` (callers absorb device pace) or ``shed``
      (fast `ServingOverloadError`, counted).
    - ``watchdog_s``: dispatch watchdog deadline — a device call that
      wedges the dispatch thread longer than this fails its batch's
      futures with `resilience.DeadlineExceeded` and the dispatcher
      restarts on a fresh thread (0 = watchdog off).
    - ``tenant_quota_rows``: per-tenant queued-row quota in the
      admission queue (`TenantQuotaExceeded` beyond it; None = the
      ``GETHSHARDING_TORCH_TENANT_QUOTA_ROWS`` env default, 0 = off).
    """

    max_batch: int = 128
    flush_us: float = 500.0
    queue_cap: int = 4096
    policy: str = "block"
    watchdog_s: float = 0.0
    tenant_quota_rows: Optional[int] = None


class ServingSigBackend(SigBackend):
    """Coalescing wrapper around any `SigBackend` (torch or python)."""

    name = "serving"

    def __init__(self, inner: SigBackend,
                 config: Optional[ServingConfig] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY):
        # one admission tier per device — including a serving backend
        # hiding under thin wrappers (the soundness spot-checker, a
        # chaos front): walk the .inner chain so the guard can't be
        # defeated by composition order
        probe, hops = inner, 0
        while probe is not None and hops < 8:
            if isinstance(probe, ServingSigBackend):
                raise ValueError("refusing to nest serving backends: one "
                                 "admission tier per device")
            probe, hops = getattr(probe, "inner", None), hops + 1
        self.inner = inner
        self.config = config or ServingConfig()
        self.name = f"serving+{inner.name}"
        self.batcher = MicroBatcher(
            inner,
            max_batch=self.config.max_batch,
            flush_us=self.config.flush_us,
            queue_cap=self.config.queue_cap,
            policy=self.config.policy,
            watchdog_s=self.config.watchdog_s,
            tenant_quota_rows=self.config.tenant_quota_rows,
            registry=registry,
        )

    # -- async face --------------------------------------------------------

    def submit(self, op: str, *args: Sequence,
               pk_row_keys: Optional[Sequence] = None,
               klass: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one request; the future resolves to the per-row
        results in the caller's own order. `klass`/`tenant` tag the
        request's admission class and quota bucket (defaults: the
        thread's `admission_class` context, then the per-op map —
        serving/classes.py)."""
        if op not in SERVING_OPS:
            raise ValueError(f"unknown serving op {op!r}; "
                             f"choose from {SERVING_OPS}")
        cols = [list(column) for column in args]
        rows = len(cols[0]) if cols else 0
        for column in cols[1:]:
            if len(column) != rows:
                raise ValueError(
                    f"{op}: ragged request ({[len(c) for c in cols]} rows)")
        if op == "bls_verify_committees":
            # normalize the optional cache keys to EXACTLY one per row so
            # keyed and keyless requests share a dispatch (None =
            # uncached row, the wrapped backend's per-row contract).
            # Surplus keys are dropped like the wrapped backend drops
            # them — in a coalesced batch they would shift every
            # batch-mate's keys onto the wrong rows.
            if pk_row_keys is None:
                keys: List = [None] * rows
            else:
                keys = list(pk_row_keys)[:rows]
                keys += [None] * (rows - len(keys))
            cols.append(keys)
        elif pk_row_keys is not None:
            raise ValueError(f"{op} takes no pk_row_keys")
        return self.batcher.submit(op, tuple(cols), rows,
                                   klass=klass, tenant=tenant)

    # -- the synchronous SigBackend contract -------------------------------

    def _await(self, future):
        """Park on the future; attribute the wake when tracing is on."""
        out = future.result()
        observe_future_wake(future)
        return out

    def ecrecover_addresses(self, digests, sigs65):
        return self._await(self.submit("ecrecover_addresses", digests,
                                       sigs65))

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        return self._await(self.submit("bls_verify_aggregates", messages,
                                       agg_sigs, agg_pks))

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        return self._await(self.submit("bls_verify_committees", messages,
                                       sig_rows, pk_rows,
                                       pk_row_keys=pk_row_keys))

    def das_verify_samples(self, chunks, indices, proofs, roots):
        """The DAS sample-verdict op over the coalescing tier: many
        callers' k-sample batches share one samples × shards dispatch."""
        return self._await(self.submit("das_verify_samples", chunks,
                                       indices, proofs, roots))

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        """The DAS multiproof-verdict op over the coalescing tier:
        concurrent callers' rows share one batched pairing dispatch."""
        return self._await(self.submit("das_verify_multiproofs",
                                       commitments, index_rows, eval_rows,
                                       proofs, ns))

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        """The overlapped-notary face over the serving tier: the
        request coalesces with concurrent traffic and the returned
        `concurrent.futures.Future` is `VerdictFuture`-compatible on
        `result()`, so `Notary`'s audit pipeline works unchanged under
        ``--serving``."""
        return self.submit("bls_verify_committees", messages, sig_rows,
                           pk_rows, pk_row_keys=pk_row_keys)

    # -- class tagging -----------------------------------------------------

    def classed(self, klass: str, tenant: str = "") -> "ClassedSigBackend":
        """A fixed-class view over this serving backend: the same
        `SigBackend` surface with every call admitted under `klass`
        (and `tenant`'s quota bucket). For call trees that pass through
        wrapper compositions the caller does not control, prefer the
        `serving.classes.admission_class` context: it rides the thread."""
        return ClassedSigBackend(self, klass, tenant)

    # -- lifecycle / observability -----------------------------------------

    def close(self) -> None:
        """Drain and stop the serving threads (idempotent)."""
        self.batcher.close()

    @property
    def dispatch_count(self) -> int:
        """Total device dispatches issued (all ops) — the denominator of
        the coalescing ratio."""
        return sum(self.batcher.dispatch_counts.values())


class ClassedSigBackend(SigBackend):
    """A thin fixed-(class, tenant) facade over a `ServingSigBackend`:
    drop-in `SigBackend` whose every call coalesces under one admission
    class — hand one to a service whose whole traffic is one class
    (a catch-up replayer, a bulk re-verifier)."""

    def __init__(self, serving: ServingSigBackend, klass: str,
                 tenant: str = ""):
        from gethsharding_tpu_torch.serving.classes import check_class

        self.inner = serving
        self.klass = check_class(klass)
        self.tenant = tenant
        self.name = f"{serving.name}[{klass}]"

    def submit(self, op: str, *args, pk_row_keys=None,
               klass: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        return self.inner.submit(op, *args, pk_row_keys=pk_row_keys,
                                 klass=klass or self.klass,
                                 tenant=self.tenant if tenant is None
                                 else tenant)

    def _await(self, future):
        out = future.result()
        observe_future_wake(future)
        return out

    def ecrecover_addresses(self, digests, sigs65):
        return self._await(self.submit("ecrecover_addresses", digests,
                                       sigs65))

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        return self._await(self.submit("bls_verify_aggregates", messages,
                                       agg_sigs, agg_pks))

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        return self._await(self.submit("bls_verify_committees", messages,
                                       sig_rows, pk_rows,
                                       pk_row_keys=pk_row_keys))

    def das_verify_samples(self, chunks, indices, proofs, roots):
        return self._await(self.submit("das_verify_samples", chunks,
                                       indices, proofs, roots))

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        return self._await(self.submit("das_verify_multiproofs",
                                       commitments, index_rows, eval_rows,
                                       proofs, ns))

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        return self.submit("bls_verify_committees", messages, sig_rows,
                           pk_rows, pk_row_keys=pk_row_keys)

    def close(self) -> None:
        """Classed views never own the serving tier; closing one is a
        no-op so a per-service shutdown can't kill shared serving."""
