"""Notary actor: joins the pool, watches heads, audits the previous period
and votes on data availability (the port's copy of the JAX package's
`actors/notary.py`).

Parity: `sharding/notary/service.go` (Start :31, notarizeCollations :44)
and `notary.go` (subscribeBlockHeaders :28, checkSMCForNotary :62,
joinNotaryPool :267, leaveNotaryPool :318, releaseNotary :365, submitVote
:413, isLockUpOver :129). Each head runs:

  in pool? -> audit the previous period: its committee votes in one
  `bls_verify_committees` call on the card, the quorum flags judged, the
  vote log replayed through `ops/smc.py` (`verify_period_batch`) ->
  per shard: sampled for the committee? -> a collation record this
  period? -> the proposers' signatures recovered in one
  `ecrecover_addresses` call -> availability in the local shard DB, the
  body requested over shardp2p when it is not local -> submitVote at our
  pool index -> on quorum, the header set canonical.

In sampled mode (`da_mode="sampled"` with a `DASService` as `das`) the
availability verdicts of every candidate come first, from one batched
call: k sampled chunks with their merkle proofs a shard through one
`das_verify_samples` (one `das_samples` launch), or with `--da-proofs
poly` one multiproof a shard through one `das_verify_multiproofs` (one
`miller` and one `finalexp` launch). A sampled notary never requests a
body; the windback is held by sampling too.

`sig_backend=None` is `TorchSigBackend()` on the card, which raises where
there is none. The head launches the audit before the vote phases and
judges it after them, so the card verifies the previous period while the
host votes; `audit_period(s)` is the synchronous form. Behind a serving
tier (a backend with `submit`), the proposer signatures recover on the
tier's dispatch thread while this thread requests the bodies that are
not local, and every audit call is tagged with the ``bulk_audit``
admission class.

`p2p` (a `P2PServer`) fetches bodies that are not local; `mirror` (a
`StateMirror`) serves each head's reads and the windback's prior records
from one snapshot; `journal` (a `VoteJournal`) keeps the submitted votes
and the audit high-water mark across restarts; `das` (a `DASService`)
fetches the sampled chunks or multiproofs in sampled mode.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from gethsharding_tpu_torch import metrics, tracing
from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.core.shard import Shard, ShardError
from gethsharding_tpu_torch.core.types import CollationHeader
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.mainchain.mirror import (
    decode_committee_context, decode_record)
from gethsharding_tpu_torch.p2p.messages import CollationBodyRequest
from gethsharding_tpu_torch.p2p.service import P2PServer
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG
from gethsharding_tpu_torch.resilience.errors import (FetchAborted,
                                                      TransientError)
from gethsharding_tpu_torch.resilience.policy import (POLL_MISS,
                                                      RetryExecutor,
                                                      RetryPolicy,
                                                      poll_probe)
from gethsharding_tpu_torch.rpc import codec
from gethsharding_tpu_torch.serving.batcher import observe_future_wake
from gethsharding_tpu_torch.serving.classes import (CLASS_BULK_AUDIT,
                                                    admission_class)
from gethsharding_tpu_torch.sigbackend import SigBackend
from gethsharding_tpu_torch.smc.state_machine import SMCRevert, vote_digest
from gethsharding_tpu_torch.utils.hexbytes import Hash32


class _BodyUnavailable(TransientError):
    """A collation body did not arrive within one fetch attempt."""


class Notary(Service):
    name = "notary"
    supervisable = True

    def __init__(self, client: SMCClient, shard: Shard,
                 p2p: Optional[P2PServer] = None,
                 config: Config = DEFAULT_CONFIG,
                 deposit_flag: bool = False,
                 all_shards: bool = True,
                 sig_backend: Optional[SigBackend] = None,
                 mirror=None,
                 journal=None,
                 das=None,
                 da_mode: str = "full"):
        super().__init__()
        self.client = client
        self.shard = shard
        self.p2p = p2p
        # data-availability sampling (da_mode "sampled" with a DASService):
        # availability from sampled proofs checked in one batched call
        # across the candidate shards; no body is fetched
        self.das = das
        self.da_mode = da_mode
        # positive sampled verdicts by (shard, period): a collation's
        # chunks are immutable, so a head or windback walk that meets the
        # pair again does not fetch its samples again. Negative verdicts
        # are never cached (late samples may still flip them). Pruned to
        # _DA_CACHE_MAX, oldest periods first.
        self._da_verdicts: dict = {}
        # crash-safe vote journal: a restarted notary recovers its
        # submitted (shard, period) votes and the audit high-water mark on
        # on_start, so it neither double-votes nor re-audits finished
        # periods. None = process memory only.
        self.journal = journal
        # the state mirror: the per-head scan reads records, watermarks and
        # the committee context from one snapshot instead of one client
        # call a shard
        self.mirror = mirror
        self.config = config
        self.deposit_flag = deposit_flag
        # notaries watch every shard (the reference scans 0..shardCount)
        self.all_shards = all_shards
        if sig_backend is None:
            from gethsharding_tpu_torch.sigbackend.dispatch import (
                TorchSigBackend)

            sig_backend = TorchSigBackend()
        self.sig_backend = sig_backend
        self.votes_submitted = 0
        self.votes_missed = 0
        self.canonical_set = 0
        self.signatures_rejected = 0
        self.audits_run = 0
        self.audit_mismatches = 0
        self.aggregate_sigs_verified = 0
        self._last_audited_period = 0
        self._unsubscribe = None
        # aggregate signature verifications and the collation validate
        # latency (the notary's two throughput and latency metrics)
        self.m_sigs_verified = metrics.counter(
            "notary/aggregate_sig_verifications")
        self.m_validate_latency = metrics.timer("notary/validate_latency")
        self.m_audit_latency = metrics.timer("notary/period_audit_latency")
        # a head end to end (the node CLI logs it at exit)
        self.m_head_latency = metrics.timer("notary/head_latency")
        self.m_votes = metrics.counter("notary/votes_submitted")
        # votes the chain sealed the period before (a lost race, counted
        # and not a service error; the node CLI logs them at exit)
        self.m_votes_missed = metrics.counter("notary/votes_missed")
        self.m_audit_mismatch = metrics.counter("notary/audit_mismatches")
        self.m_windback_checks = metrics.counter("notary/windback_checks")
        # body-fetch retry seam: each attempt re-broadcasts the shardp2p
        # request and polls briefly, so a lost request frame costs one
        # backoff, not the availability verdict
        self._body_retry = RetryExecutor(
            "collation_body",
            RetryPolicy(attempts=3, base_s=0.05, cap_s=0.2,
                        retryable=(_BodyUnavailable,)))

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if self.journal is not None:
            # a journal AHEAD of the chain belongs to a previous chain
            # lifetime (a fresh simulated chain under an old datadir):
            # replaying it would mute the notary until the new chain
            # catches up. An unreachable chain keeps the journal.
            try:
                current = self.client.current_period()
            except Exception:  # noqa: BLE001 - chain down at boot
                current = None
            if current is not None \
                    and self.journal.invalidate_if_reset(current):
                self.log.warning(
                    "vote journal was ahead of the chain (period %d): "
                    "chain reset assumed, journal cleared", current)
            # recovery replay: the journal records the audited period
            # itself (None = never audited); `_last_audited_period = N`
            # means "period N-1 audited", hence the +1
            high_water = self.journal.audit_high_water()
            if high_water is not None \
                    and high_water + 1 > self._last_audited_period:
                self._last_audited_period = high_water + 1
            recovered = sum(1 for _ in self.journal.votes())
            if recovered or high_water is not None:
                self.log.info(
                    "vote journal recovered: %d submitted votes, audit "
                    "high-water period %s", recovered, high_water)
        if self.deposit_flag:
            try:
                self.join_notary_pool()
            except Exception as exc:
                self.record_error(f"joining notary pool failed: {exc}")
        self._unsubscribe = self.client.subscribe_new_head(self._on_head)

    def on_stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()

    # -- pool membership (notary.go:267,318,365) ---------------------------

    def join_notary_pool(self) -> None:
        registry = self.client.notary_registry()
        if registry is not None and registry.deposited:
            self.log.info("Already joined notary pool")
            return
        self.client.register_notary()
        self.log.info("Joined notary pool: %s", self.client.account().hex_str)

    def leave_notary_pool(self) -> None:
        self.client.deregister_notary()

    def release_notary(self) -> None:
        registry = self.client.notary_registry()
        if registry is None or registry.deregistered_period == 0:
            raise RuntimeError("account has not deregistered")
        if not self.is_lockup_over(registry):
            raise RuntimeError("lockup period is not over")
        self.client.release_notary()

    def is_lockup_over(self, registry) -> bool:
        """isLockUpOver (notary.go:129)."""
        return (self.client.current_period()
                > registry.deregistered_period + self.config.notary_lockup_length)

    def is_account_in_notary_pool(self) -> bool:
        registry = self.client.notary_registry()
        return registry is not None and registry.deposited

    # -- the hot loop (notarizeCollations / checkSMCForNotary) -------------

    def _on_head(self, block) -> None:
        try:
            with self.m_head_latency.time():
                self.notarize_collations(head=block.number)
            self.record_success()
        except Exception as exc:
            # a run of consecutive head failures marks the service crashed
            self.record_failure(
                f"notarize failed at head {block.number}: {exc}")

    def _head_snapshot(self, head: Optional[int]):
        """The mirror snapshot for this head, refreshed if the mirror has
        not caught up yet (one bulk pull); None = read via the client."""
        if self.mirror is None:
            return None
        if head is None:
            head = self.client.block_number
        try:
            snap = self.mirror.snapshot()
            if snap is None or (snap["block_number"] or 0) < head:
                snap = self.mirror.refresh()
        except Exception:
            return None  # degraded mirror: fall back to direct reads
        if snap is None or (snap["block_number"] or 0) < head:
            return None
        return snap

    def notarize_collations(self, head: Optional[int] = None) -> None:
        """One head's work. `head` is the head's block number: the
        mirror's snapshot must have reached it to be read."""
        # the per-head trace root: the audit, fetch, recover and vote
        # phases below parent under it
        with tracing.span("notary/notarize"):
            self._notarize_collations(head)

    def _notarize_collations(self, head: Optional[int]) -> None:
        if not self.is_account_in_notary_pool():
            return
        snap = self._head_snapshot(head)
        if snap is not None:
            period = snap["period"]
            block_number = snap["block_number"]
            shard_count = snap["shard_count"]
        else:
            period = self.client.current_period()
            block_number = self.client.block_number
            shard_count = self.client.shard_count()
        # audit the previous period once, in one backend call, launched
        # here and its verdicts pulled after the vote phases: the card
        # verifies period N-1 while this thread fetches candidates,
        # recovers proposer signatures and votes.
        finish_audit: Optional[Callable[[], None]] = None
        prev_audited = self._last_audited_period
        if period > 0 and self._last_audited_period < period:
            finish_audit = self._begin_period_audit(period - 1)
            self._last_audited_period = period
        try:
            self._vote_phases(snap, period, block_number, shard_count)
        except Exception:
            # the vote-phase failure wins; the audit's verdicts are still
            # collected (its device work is done)
            if finish_audit is not None:
                try:
                    finish_audit()
                except Exception as audit_exc:
                    # rewind the watermark so the next head retries it
                    self._last_audited_period = prev_audited
                    self.record_error(
                        f"period audit failed behind a vote-phase "
                        f"error: {audit_exc}")
            raise
        if finish_audit is not None:
            try:
                finish_audit()
            except Exception:
                self._last_audited_period = prev_audited  # retry next head
                raise

    def _vote_phases(self, snap, period: int, block_number: int,
                     shard_count: int) -> None:
        # a vote submitted now executes in the pending block; if that block
        # already belongs to the next period the SMC would revert with
        # "period is not current": wait for the new period's head
        pending_period = (block_number + 1) // self.config.period_length
        if pending_period != period:
            return
        shard_ids = (range(shard_count)
                     if self.all_shards else [self.shard.shard_id])

        # phase 1: every eligible (shard, record) pair of this period, from
        # the snapshot when mirrored
        candidates: List[Tuple[int, int, object]] = []
        with tracing.span("notary/fetch"):
            for shard_id in self._eligible_shards(shard_ids, snap):
                if snap is not None:
                    if snap["last_submitted"].get(shard_id) != period:
                        continue
                    rec = snap["records"].get(shard_id)
                    record = None if rec is None else decode_record(rec)
                else:
                    record = self.client.collation_record(shard_id, period)
                    if (record is not None and self.client
                            .last_submitted_collation(shard_id) != period):
                        record = None
                if record is None:
                    continue
                candidates.append((shard_id, period, record))
        if not candidates:
            return

        # phase 2: one batched proposer-signature recovery over every
        # candidate shard (one `ecrecover_addresses` launch)
        signed = [c for c in candidates if c[2].signature]
        sig_ok = {}
        if signed:
            with tracing.span("notary/recover", rows=len(signed)):
                submit = getattr(self.sig_backend, "submit", None)
                if submit is not None:
                    # serving backend: the recovery runs on the serving
                    # tier's dispatch thread while this thread fires the
                    # body requests of collations that are not local, so
                    # the syncers' round trips overlap it. Fire and forget:
                    # the authoritative (polling) availability check stays
                    # in submit_vote.
                    digests, sigs = self._proposer_sig_inputs(signed)
                    future = submit("ecrecover_addresses", digests, sigs)
                    for shard_id, p, record in candidates:
                        self._prefetch_availability(shard_id, p, record)
                    recovered = future.result()
                    observe_future_wake(future)
                    results = self._match_proposers(recovered, signed)
                else:
                    results = self.verify_proposer_signatures(signed)
                for (shard_id, _, _), good in zip(signed, results):
                    sig_ok[shard_id] = good

        # phase 3: availability checks and signed vote submission per
        # shard. In sampled mode every candidate's check runs first, in one
        # batched backend call, and submit_vote reads its verdict.
        sampled_ok = (self._sampled_verdicts(candidates)
                      if self._sampled() else None)
        with tracing.span("notary/vote", candidates=len(candidates)):
            for shard_id, p, record in candidates:
                if record.signature and not sig_ok.get(shard_id, False):
                    self.signatures_rejected += 1
                    self.record_error(
                        f"proposer signature invalid: shard {shard_id} "
                        f"period {p}")
                    continue
                with self.m_validate_latency.time():
                    self.submit_vote(
                        shard_id, p, record, proposer_sig_checked=True,
                        availability=(None if sampled_ok is None
                                      else sampled_ok.get(shard_id,
                                                          False)))

    def _eligible_shards(self, shard_ids, snap=None) -> List[int]:
        """Committee eligibility for every shard from one sampling-context
        view (the mirror snapshot's when one is current): the keccak
        sampling of `notary.go:62` runs locally over the fetched context,
        in place of one call a shard. Falls back to per-shard calls when
        the backend lacks the view."""
        if snap is not None:
            ctx = decode_committee_context(snap["committee_context"])
        else:
            ctx = self.client.committee_context()
        me = self.client.account()
        if ctx is None:
            return [s for s in shard_ids
                    if self.client.get_notary_in_committee(s) == me]
        sample_size = ctx["sample_size"]
        if sample_size <= 0:
            return []
        registry = self.client.notary_registry()
        pool_index = registry.pool_index if registry is not None else 0
        prefix = ctx["blockhash"] + pool_index.to_bytes(32, "big")
        pool = ctx["pool"]
        me_raw = bytes(me)
        out = []
        for shard_id in shard_ids:
            digest = keccak256(prefix + shard_id.to_bytes(32, "big"))
            slot = int.from_bytes(digest, "big") % sample_size
            member = pool[slot] if slot < len(pool) else None
            if member is not None and member == me_raw:
                out.append(shard_id)
        return out

    # -- voting (notary.go:413 submitVote) ---------------------------------

    def submit_vote(self, shard_id: int, period: int, record,
                    proposer_sig_checked: bool = False,
                    availability: Optional[bool] = None) -> bool:
        registry = self.client.notary_registry()
        if registry is None or not registry.deposited:
            self.record_error("cannot vote: not a deposited notary")
            return False
        if registry.pool_index >= self.config.committee_size:
            self.record_error(
                f"invalid pool index {registry.pool_index}: exceeds committee "
                f"size {self.config.committee_size}"
            )
            return False
        # the journal gate first: it answers "did this process lineage
        # already submit (shard, period)?" locally, so a restarted notary
        # cannot double-vote while its view of the chain catches up
        if self.journal is not None and self.journal.has_vote(shard_id,
                                                              period):
            return False
        if self.client.has_voted(shard_id, registry.pool_index):
            if self.journal is not None:
                # the chain knows but the journal missed it (the vote
                # landed in the crash window): sync it
                self.journal.record_vote(shard_id, period)
            return False

        # the period flow checks every candidate's proposer signature in one
        # batch (phase 2); this covers direct callers. An unsigned record is
        # accepted (header signatures are not enforced on-chain), but a
        # present signature must recover to the proposer.
        if record.signature and not proposer_sig_checked:
            if not self.verify_proposer_signatures(
                    [(shard_id, period, record)])[0]:
                self.signatures_rejected += 1
                self.record_error(
                    f"proposer signature invalid: shard {shard_id} "
                    f"period {period}")
                return False

        # data availability: full mode takes the local shard DB's verdict,
        # the body fetched over shardp2p when it is not local; sampled mode
        # checks k sampled proofs (or one multiproof) against the
        # proposer's signed commitment. The period flow passes its batched
        # verdict as `availability`; direct callers compute their own.
        with tracing.span("notary/verify", shard=shard_id):
            if availability is None:
                availability = (
                    self._check_sampled(shard_id, period, record)
                    if self._sampled()
                    else self._check_availability(shard_id, period,
                                                  record))
            if not availability:
                self.record_error(
                    f"collation body unavailable for shard {shard_id} "
                    f"period {period}"
                )
                return False
            # enforced windback: the previous W periods' collations on this
            # shard chain must also be available
            if not self._check_windback(shard_id, period):
                return False

        # the vote carries our aggregatable BLS signature over
        # (shard, period, chunkRoot): what the period audit verifies
        digest = vote_digest(shard_id, period, record.chunk_root)
        try:
            self.client.submit_vote(shard_id, period, registry.pool_index,
                                    record.chunk_root,
                                    bls_sig=self.client.bls_sign(digest))
        except SMCRevert as exc:
            pending = ((self.client.block_number + 1)
                       // self.config.period_length)
            if "period is not current" in str(exc) and pending != period:
                # the chain sealed the period's last block while this vote
                # was in flight (a chain process seals on its own clock;
                # a transaction runs in the pending block): a lost race,
                # not a fault of this service, counted as a missed vote
                self.votes_missed += 1
                self.m_votes_missed.inc()
                self.log.warning("vote on shard %s missed the end of "
                                 "period %s", shard_id, period)
                return False
            self.record_error(f"vote reverted: {exc}")
            return False
        if self.journal is not None:
            # journal after the chain accepted: the journal answers
            # "already submitted?", the chain stays authoritative
            self.journal.record_vote(shard_id, period)
        self.votes_submitted += 1
        self.m_votes.inc()

        # on quorum, persist the canonical header (notary.go:165)
        if self.client.last_approved_collation(shard_id) == period:
            self._set_canonical(shard_id, period, record)
        return True

    # -- the batched period audit ------------------------------------------

    def audit_period(self, period: int) -> Optional[bool]:
        """Verify a whole period's committee votes in one backend call.

        For every shard with a collation record in `period`, the accepted
        votes' BLS signatures and the voters' registered pubkeys are
        aggregated and verified in one `bls_verify_committees` call (on the
        card: the committee sums, the pairing and the final exponentiation
        of every shard at once). The quorum outcome recomputed from the
        votes must equal the SMC's `is_elected` flags; a mismatch (a forged
        or invalid stored signature, tally drift) is counted and reported.
        With the `torch` backend the period's vote log is also replayed
        through the batched vote kernel (`verify_period_batch`).

        Returns True (all consistent), False (mismatch), or None (nothing
        auditable this period).
        """
        return self.audit_periods([period])[period]

    def audit_periods(self, periods, overlap: bool = False) -> dict:
        """Audit many periods in one backend call: rows from every period
        share one batched call (the catch-up form of `audit_period`; the
        vote-log replay stays one `verify_period_batch` a period). Returns
        {period: True/False/None}.

        ``overlap=True`` is the pipelined form: one call a period through
        the backend's async face, so period N+1's host marshal (and period
        N's judging) runs while period N is on the card. The results are
        the same.
        """
        periods = list(periods)
        collected = {p: self._collect_audit_rows(p) for p in periods}
        results: dict = {p: None for p in periods}
        if overlap:
            return self._audit_periods_overlapped(periods, collected,
                                                  results)
        msgs, sig_rows, pk_rows, pk_keys = [], [], [], []
        spans = {}
        for period, rows in collected.items():
            if rows is None:
                continue
            start = len(msgs)
            msgs.extend(rows["msgs"])
            sig_rows.extend(rows["sig_rows"])
            pk_rows.extend(rows["pk_rows"])
            pk_keys.extend(rows["pk_keys"])
            spans[period] = (start, len(msgs))

        if not spans:
            return results
        with tracing.span("notary/audit", periods=len(spans),
                          rows=len(msgs)):
            with self.m_audit_latency.time():
                # the period audit is bulk traffic: behind a serving tier
                # it coalesces under the bulk_audit admission class, and
                # the thread-local tag survives the wrappers in between
                with admission_class(CLASS_BULK_AUDIT):
                    ok = self.sig_backend.bls_verify_committees(
                        msgs, sig_rows, pk_rows, pk_row_keys=pk_keys)
        self.audits_run += len(spans)
        for period, (start, end) in spans.items():
            results[period] = self._judge_period(
                period, collected[period], ok[start:end])
        return results

    def _audit_periods_overlapped(self, periods, collected,
                                  results) -> dict:
        """Launch every period's call through the async face, then judge
        the verdicts in order: each `result()` pull overlaps the remaining
        periods' device work."""
        pending = []  # (period, rows, verdict future)
        n_rows = sum(len(r["msgs"]) for r in collected.values()
                     if r is not None)
        with tracing.span("notary/audit", periods=len(periods),
                          rows=n_rows, overlap=True):
            # the latency timer covers launches and verdict pulls only:
            # judging (with the replay check) stays outside, as in the
            # batched form
            verdicts = []
            with self.m_audit_latency.time():
                for period in periods:
                    rows = collected[period]
                    if rows is None:
                        continue
                    with admission_class(CLASS_BULK_AUDIT):
                        future = (self.sig_backend
                                  .bls_verify_committees_async(
                                      rows["msgs"], rows["sig_rows"],
                                      rows["pk_rows"],
                                      pk_row_keys=rows["pk_keys"]))
                    pending.append((period, rows, future))
                for period, rows, future in pending:
                    verdicts.append((period, rows, future.result()))
            for period, rows, ok in verdicts:
                results[period] = self._judge_period(period, rows, ok)
        self.audits_run += len(pending)
        return results

    def _begin_period_audit(self, period: int) -> Callable[[], None]:
        """Launch one period's audit now; returns the closure that pulls
        the verdicts and judges them. The head loop calls it after the vote
        phases, so the card verifies the previous period underneath the
        current period's votes. The latency timer records launch and pull
        time only, as in the synchronous path."""
        with tracing.span("notary/audit_submit", period=period):
            collected = self._collect_audit_rows(period)
            if collected is None:
                return lambda: None
            t0 = time.monotonic()
            with admission_class(CLASS_BULK_AUDIT):
                future = self.sig_backend.bls_verify_committees_async(
                    collected["msgs"], collected["sig_rows"],
                    collected["pk_rows"], pk_row_keys=collected["pk_keys"])
            submit_s = time.monotonic() - t0

        def finish() -> None:
            with tracing.span("notary/audit_collect", period=period):
                t1 = time.monotonic()
                ok = future.result()
                self.m_audit_latency.observe(
                    submit_s + (time.monotonic() - t1))
                self.audits_run += 1
                self._judge_period(period, collected, ok)

        return finish

    def _collect_audit_rows(self, period: int) -> Optional[dict]:
        """One bulk pull of a period's auditable rows (or None). Voter
        pubkeys are resolved by the attribution recorded at vote time (pool
        slots can be freed and reused before the audit); a released voter's
        row cannot be resolved and is skipped."""
        data = self.client.audit_data(period)
        raw = bool(data.get("raw"))  # in-process pull: no hex wire codec
        shards, msgs, sig_rows, pk_rows, pk_keys = [], [], [], [], []
        signed_counts, total_counts, expected = [], [], []
        for shard_id in sorted(data["shards"]):
            rec = data["shards"][shard_id]
            member_pks, sigs, key_parts = [], [], []
            for vote in rec["votes"]:
                pk = (vote["pubkey"] if raw
                      else codec.dec_g2(vote["pubkey"]))
                if pk is None:
                    member_pks = None  # released voter: not resolvable
                    break
                member_pks.append(pk)
                sigs.append(vote["sig"] if raw
                            else codec.dec_g1(vote["sig"]))
                # the pubkeys' int limbs identify the row: the backend keeps
                # its line tables under this key
                x, y = pk
                key_parts.extend((x.a, x.b, y.a, y.b))
            if member_pks is None:
                continue
            shards.append(shard_id)
            root = (Hash32(rec["chunk_root"]) if raw
                    else Hash32(bytes.fromhex(rec["chunk_root"])))
            msgs.append(vote_digest(shard_id, period, root))
            sig_rows.append(sigs)
            pk_rows.append(member_pks)
            pk_keys.append(tuple(key_parts))
            signed_counts.append(len(rec["votes"]))
            total_counts.append(rec["vote_count"])
            expected.append(bool(rec["is_elected"]))
        if not shards:
            return None
        return {"shards": shards, "msgs": msgs, "sig_rows": sig_rows,
                "pk_rows": pk_rows, "pk_keys": pk_keys,
                "signed_counts": signed_counts,
                "total_counts": total_counts, "expected": expected}

    def _judge_period(self, period: int, rows: dict, ok) -> bool:
        """Outcome checks for one period's verified rows (`ok` aligns with
        rows["shards"])."""
        shards = rows["shards"]
        signed_counts = rows["signed_counts"]
        total_counts = rows["total_counts"]
        expected = rows["expected"]
        verified = sum(n for n, good in zip(signed_counts, ok) if good)
        self.aggregate_sigs_verified += verified
        self.m_sigs_verified.inc(verified)

        consistent = True
        quorum = self.config.quorum_size
        for shard_id, good, n_signed, n_total, elected in zip(
                shards, ok, signed_counts, total_counts, expected):
            # (1) the signed aggregate must verify (a failure means a stored
            # signature is forged or corrupt); (2) the SMC's election flag
            # must match the quorum rule over the accepted-vote count
            # (n_signed can lag n_total where key-less notaries voted)
            mismatch = None
            if not good:
                mismatch = (f"invalid aggregate signature "
                            f"({n_signed}/{n_total} votes signed)")
            elif (n_total >= quorum) != elected:
                mismatch = (f"tally drift: votes={n_total} quorum={quorum} "
                            f"smc_elected={elected}")
            if mismatch is not None:
                consistent = False
                self.audit_mismatches += 1
                self.m_audit_mismatch.inc()
                self.record_error(
                    f"period {period} audit mismatch on shard {shard_id}: "
                    f"{mismatch}")

        # the vote-log replay runs the batched vote kernel on the backend's
        # device; wrappers keep the wrapped backend's nature, so unwrap them
        base = self.sig_backend
        while hasattr(base, "inner"):
            base = base.inner
        replay = (self.client.verify_period_batch(period, device=base.device)
                  if base.name == "torch" else None)
        if replay is False:
            consistent = False
            self.audit_mismatches += 1
            self.record_error(
                f"period {period} batch-replay mismatch: "
                f"submit_votes_batch disagrees with the scalar SMC")
        if self.journal is not None:
            # this period's audit is done (mismatches are reported, not
            # retried): persist the watermark so a restart skips it, and
            # prune the votes of closed periods (a vote can only target
            # the current period)
            self.journal.set_audit_high_water(period)
            self.journal.prune_votes(before_period=period)
        return consistent

    def verify_proposer_signatures(self, records) -> list:
        """Batch-verify proposer signatures over collation-header records.

        `records`: [(shard_id, period, record)]. The signed digest is the
        header hash with an empty signature field (the proposer signs
        before add_sig). One backend call covers the batch: on the card,
        one launch of the recovery kernel.
        """
        digests, sigs = self._proposer_sig_inputs(records)
        recovered = self.sig_backend.ecrecover_addresses(digests, sigs)
        return self._match_proposers(recovered, records)

    @staticmethod
    def _proposer_sig_inputs(records) -> Tuple[list, list]:
        """(digests, sigs65) for a [(shard_id, period, record)] batch."""
        digests, sigs = [], []
        for shard_id, period, record in records:
            unsigned = CollationHeader(
                shard_id=shard_id,
                chunk_root=record.chunk_root,
                period=period,
                proposer_address=record.proposer,
            )
            digests.append(bytes(unsigned.hash()))
            sigs.append(record.signature)
        return digests, sigs

    @staticmethod
    def _match_proposers(recovered, records) -> list:
        return [
            got is not None and got == rec[2].proposer
            for got, rec in zip(recovered, records)
        ]

    # -- data-availability sampling (da_mode "sampled") --------------------

    # one verdict per (shard, period): 100 shards x a 40-period horizon
    # fits with room; entries are a bool each
    _DA_CACHE_MAX = 4096

    def _sampled(self) -> bool:
        return self.da_mode == "sampled" and self.das is not None

    def _sampled_verdicts(self, candidates) -> dict:
        """Availability verdicts {shard: bool} for [(shard, period,
        record)] rows from ONE batched backend call.

        Per candidate: the proposer's commitment and the notary's k
        deterministic sampled (chunk, proof) rows over shardp2p
        (`DASService.collect_rows`), then every candidate's samples in
        one `das_verify_samples` call (one `das_samples` launch on the
        card). A shard is available iff its commitment resolved and every
        one of its samples verified; a missing sample was synthesized as
        an empty row, so it fails rather than shrink k. In poly mode
        `_poly_verdicts` does the same with one multiproof a shard."""
        verdicts = {}
        fresh = []
        account = bytes(self.client.account())
        for shard_id, period, record in candidates:
            if self._da_verdicts.get((shard_id, period)):
                verdicts[shard_id] = True  # immutable content: cached
                continue
            fresh.append((shard_id, period, record))
        # every candidate's commitment request goes out up front, so the
        # per-shard collect below mostly finds parked responses
        if fresh:
            self.das.prefetch_commitments(
                [(shard_id, period) for shard_id, period, _ in fresh])
        if self.das.proof_mode == "poly":
            return self._poly_verdicts(fresh, account, verdicts)
        collected = [(shard_id, period,
                      self.das.collect_rows(shard_id, period, record,
                                            account))
                     for shard_id, period, record in fresh]
        chunks, indices, proofs, roots = [], [], [], []
        spans = {}
        for shard_id, _, rows in collected:
            if rows is None:
                continue
            start = len(chunks)
            chunks.extend(rows["chunks"])
            indices.extend(rows["indices"])
            proofs.extend(rows["proofs"])
            roots.extend(rows["roots"])
            spans[shard_id] = (start, len(chunks))
        ok: list = []
        if chunks:
            with tracing.span("notary/das_verify", rows=len(chunks),
                              shards=len(spans)):
                ok = self.sig_backend.das_verify_samples(
                    chunks, indices, proofs, roots)
        for shard_id, period, rows in collected:
            if rows is None:
                verdicts[shard_id] = False  # no commitment: unavailable
                continue
            start, end = spans[shard_id]
            row_ok = ok[start:end]
            self.das.note_verdicts(row_ok)
            verdicts[shard_id] = self._remember(
                shard_id, period, bool(row_ok) and all(row_ok))
        self._prune_da_verdicts()
        return verdicts

    def _poly_verdicts(self, fresh, account: bytes, verdicts: dict) -> dict:
        """The `--da-proofs poly` form of `_sampled_verdicts`: one
        `das_verify_multiproofs` row a candidate shard (one constant-size
        proof a collation), the whole batch in one call (one `miller` and
        one `finalexp` launch on the card). No commitment is unavailable;
        a failed or merkle-only fetch was synthesized by
        `collect_poly_row` as a row with an empty proof, which scores
        False."""
        collected = [(shard_id, period,
                      self.das.collect_poly_row(shard_id, period, record,
                                                account))
                     for shard_id, period, record in fresh]
        batched = [(shard_id, row) for shard_id, _, row in collected
                   if row is not None]
        ok: list = []
        if batched:
            with tracing.span("notary/das_poly_verify",
                              rows=len(batched)):
                ok = self.sig_backend.das_verify_multiproofs(
                    [row["poly_commitment"] for _, row in batched],
                    [row["indices"] for _, row in batched],
                    [row["evals"] for _, row in batched],
                    [row["proof"] for _, row in batched],
                    [row["n"] for _, row in batched])
        row_verdicts = {shard_id: good
                        for (shard_id, _), good in zip(batched, ok)}
        for shard_id, period, row in collected:
            if row is None:
                verdicts[shard_id] = False  # no commitment: unavailable
                continue
            good = bool(row_verdicts[shard_id])
            self.das.note_verdicts([good])
            verdicts[shard_id] = self._remember(shard_id, period, good)
        self._prune_da_verdicts()
        return verdicts

    def _remember(self, shard_id: int, period: int, good: bool) -> bool:
        if good:
            self._da_verdicts[(shard_id, period)] = True
        return good

    def _prune_da_verdicts(self) -> None:
        """Drop the oldest periods' verdicts beyond _DA_CACHE_MAX: closed
        periods stop being checked once the head loop moves on."""
        excess = len(self._da_verdicts) - self._DA_CACHE_MAX
        if excess > 0:
            for key in sorted(self._da_verdicts,
                              key=lambda sp: sp[1])[:excess]:
                del self._da_verdicts[key]

    def _check_sampled(self, shard_id: int, period: int, record) -> bool:
        """The single-shard sampled check (direct submit_vote callers and
        the windback; the period flow batches across shards instead)."""
        return self._sampled_verdicts(
            [(shard_id, period, record)]).get(shard_id, False)

    # -- availability ------------------------------------------------------

    def _check_windback(self, shard_id: int, period: int) -> bool:
        """Enforced windback: the last `config.windback_depth` periods'
        collations on this shard chain must be available (bodies fetched
        over shardp2p when missing), or the notary refuses to vote.

        Prior-period records come from the mirror snapshot's
        `prior_records` (closed periods are immutable); only periods
        outside the snapshot's depth fall back to `collation_record`."""
        depth = self.config.windback_depth
        if depth <= 0:
            return True
        snap = self.mirror.snapshot() if self.mirror is not None else None
        prior_records = (snap or {}).get("prior_records") or {}
        if snap is not None and (snap.get("period") or 0) != period:
            prior_records = {}  # stale snapshot: its window may not align
        for prior in range(max(1, period - depth), period):
            if prior in prior_records:
                rec = prior_records[prior].get(shard_id)
                record = None if rec is None else decode_record(rec)
            else:
                record = self.client.collation_record(shard_id, prior)
            if record is None:
                continue  # no collation that period: nothing to hold
            self.m_windback_checks.inc()
            # sampled mode holds the windback by proof too: prior periods
            # are sampled, never body-fetched
            held = (self._check_sampled(shard_id, prior, record)
                    if self._sampled()
                    else self._check_availability(shard_id, prior, record))
            if not held:
                self.record_error(
                    f"windback: collation body unavailable for shard "
                    f"{shard_id} period {prior}; refusing to vote")
                return False
        return True

    def _availability_probe(self, shard_id: int, period: int, record):
        """(header, verdict): the shard DB's local answer. True/False is
        authoritative; None means the body is not local (ShardError), and
        the body request has been broadcast over shardp2p — fire and
        forget, never blocks."""
        header = self._reconstruct_header(shard_id, period, record)
        try:
            return header, self.shard.check_availability(header)
        except ShardError:
            pass
        if self.p2p is not None:
            self.p2p.broadcast(
                CollationBodyRequest(
                    chunk_root=record.chunk_root,
                    shard_id=shard_id,
                    period=period,
                    proposer=record.proposer,
                )
            )
        return header, None

    def _prefetch_availability(self, shard_id: int, period: int,
                               record) -> None:
        """Fire the body request of a collation that is not local now, so
        the responding syncer's round trip runs while this thread waits on
        something else; `_check_availability` stays the authoritative
        (polling) gate. A sampled notary never requests a body."""
        if self._sampled():
            return
        self._availability_probe(shard_id, period, record)

    def _check_availability(self, shard_id: int, period: int, record) -> bool:
        header, verdict = self._availability_probe(shard_id, period, record)
        if verdict is not None:
            return verdict
        if self.p2p is None:
            return False

        # body not local: poll briefly for the responding syncer's store,
        # under the body-fetch retry policy; every retry re-broadcasts the
        # request (via the probe)
        def attempt() -> bool:
            got = poll_probe(
                lambda: self.shard.check_availability(header), self.wait,
                interval_s=0.05, polls=7, not_ready=(ShardError,))
            if got is not POLL_MISS:
                return got
            _, late = self._availability_probe(shard_id, period, record)
            if late is not None:
                return late
            raise _BodyUnavailable(
                f"shard {shard_id} period {period} body not delivered")

        try:
            return self._body_retry.call(attempt)
        except (_BodyUnavailable, FetchAborted):
            return False

    def _reconstruct_header(self, shard_id: int, period: int,
                            record) -> CollationHeader:
        return CollationHeader(
            shard_id=shard_id,
            chunk_root=record.chunk_root,
            period=period,
            proposer_address=record.proposer,
            proposer_signature=record.signature,
        )

    def _set_canonical(self, shard_id: int, period: int, record) -> None:
        if self._sampled():
            # a sampled notary verified availability by proof and holds no
            # body, which the shard DB's canonical index requires; the
            # body-holding nodes index canonical headers
            return
        header = self._reconstruct_header(shard_id, period, record)
        try:
            if self.shard.shard_id == shard_id:
                # the header is reconstructed from the on-chain record;
                # persist it locally before indexing it canonical
                self.shard.save_header(header)
                self.shard.set_canonical(header)
                self.canonical_set += 1
                self.log.info("Canonical header set: shard %s period %s",
                              shard_id, period)
        except ShardError as exc:
            self.record_error(f"set canonical failed: {exc}")
