"""Deterministic chaos injection: seeded failure schedules at the seams
(the port's copy of the JAX package's `resilience/chaos.py`).

One reusable injection surface driven by a seeded, replayable schedule:

- **mainchain-call seam** — ``wrap(backend, schedule, "mainchain")``
  puts a fault-injecting proxy in front of a chain backend, under the
  `SMCClient` (which does not retry: an injected fault reaches the
  actor);
- **backend-op seam** — `ChaosSigBackend` fronts any `SigBackend`;
  scheduled ``backend.<op>`` entries raise `InjectedFault` (a device
  fault the failover breaker counts), scheduled ``dispatch.<op>``
  entries HANG for `hang_s` seconds (a wedged dispatch the watchdog
  must catch); a ``backend.<op>`` seam tagged ``mode=corrupt``
  (``"backend.bls_verify_committees:mode=corrupt"`` in a spec, or the
  whole plane via ``"backend.*:mode=corrupt"``) raises NOTHING —
  scheduled calls return a seeded, silently CORRUPTED result (verdict
  bits flipped, a recovered address perturbed), the failure class only
  the soundness spot-checker (`resilience/soundness.py`) can catch;
- **DAS seams** — `das/service.py` fires ``das.commitment_fetch``,
  ``das.sample_fetch``, ``das.multiproof_fetch`` per fetch attempt and
  ``das.parity_publish`` per publish;
- **fleet-transport seam** — ``fleet.transport`` rules with
  ``mode=delay`` stall the router's wire call to a replica for
  ``delay_s``, ``mode=partition`` refuses it (`transport_disturb`,
  consulted by `fleet.router.RpcReplicaBackend` before every wire call
  and by `TransportChaos` in front of an in-process replica);
- the schedule itself is pure decision logic: per-seam call counters
  plus a seed, so the SAME spec replays the SAME failure timeline in
  tests and in a devnet node booted with ``--chaos`` — no `random`
  module state leaks between runs.

`InjectedFault` subclasses `ConnectionError` deliberately: injected
faults model transient infrastructure failure, the class the retry
policies treat as retryable.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.perfwatch import RECORDER
from gethsharding_tpu_torch.sigbackend import SigBackend


class InjectedFault(ConnectionError):
    """A deterministically scheduled failure (retryable by design)."""


# a seam rule's failure mode: "fault" raises InjectedFault (the loud
# default), "corrupt" silently perturbs the result (backend.* seams
# only — the silent-corruption chaos the soundness audit must catch),
# "delay" stalls the wire call for `delay_s` before letting it through
# and "partition" makes the wire unreachable (both on the
# ``fleet.transport`` seam only: the tail-latency and network-split
# failure classes request hedging and the router's trip path exist for)
MODES = ("fault", "corrupt", "delay", "partition")

# the one seam with a wire to delay or partition: the router-side
# transport in front of a replica (fleet/router.py TransportChaos /
# RpcReplicaBackend)
TRANSPORT_SEAM = "fleet.transport"


class ChaosSchedule:
    """Seeded per-seam failure schedule.

    ``rules`` maps a seam name (e.g. ``"mainchain.collation_record"``,
    ``"backend.bls_verify_committees"``, ``"dispatch.ecrecover_addresses"``)
    — or a bare seam prefix (``"mainchain"``) matching every op under
    it — to one of:

    - ``True``            fail every call;
    - ``int n``           fail the first n calls (then heal — the
                          retry-then-succeed / breaker-recovery shape);
    - ``float r in (0,1)``  fail each call with probability r, decided
                          by a hash of (seed, seam, call index) so the
                          verdict for call k never depends on how many
                          other seams fired;
    - ``callable(idx)``   arbitrary predicate on the per-seam call index.

    ``modes`` maps a seam (same exact-or-bare-prefix resolution) to a
    failure mode from `MODES`; unmapped seams default to ``"fault"``.
    The schedule stays pure decision logic — `mode_for` only REPORTS
    the mode, the injector at the seam acts on it. ``delay_s`` is the
    stall a ``mode=delay`` transport injector applies per scheduled
    call (the schedule carries it so one spec replays one timeline).
    """

    def __init__(self, seed: int = 0, rules: Optional[Dict] = None,
                 modes: Optional[Dict[str, str]] = None,
                 delay_s: float = 0.25):
        self.seed = seed
        self.rules = dict(rules or {})
        self.modes = dict(modes or {})
        self.delay_s = delay_s
        for seam, mode in self.modes.items():
            if mode not in MODES:
                raise ValueError(
                    f"unknown chaos mode {mode!r} for seam {seam!r}; "
                    f"choose from {MODES}")
            if mode == "corrupt" and seam != "backend" \
                    and not seam.startswith("backend."):
                # only the backend-op seam has a result to corrupt;
                # accepting corrupt on mainchain.*/dispatch.* would
                # silently degrade to every-call LOUD faults — the
                # opposite of what the operator asked to test
                raise ValueError(
                    f"mode=corrupt is only supported on backend.* seams, "
                    f"not {seam!r} (mainchain/dispatch seams have no "
                    f"result plane to corrupt)")
            if mode in ("delay", "partition") and seam != TRANSPORT_SEAM:
                # only the wire has latency to stretch or a link to cut;
                # a delayed backend op would be dispatch.* hang territory
                raise ValueError(
                    f"mode={mode} is only supported on the "
                    f"{TRANSPORT_SEAM!r} seam, not {seam!r} (only the "
                    f"replica wire has a transport to {mode})")
        self.injected: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._m_injected = metrics.counter("resilience/chaos/injected")

    def _rule_for(self, seam: str):
        rule = self.rules.get(seam)
        if rule is None and "." in seam:
            rule = self.rules.get(seam.split(".", 1)[0])
        return rule

    def has_rule(self, seam: str) -> bool:
        """True when a rule (exact or bare-prefix) names this seam."""
        rule = self._rule_for(seam)
        return rule is not None and rule is not False

    def mode_for(self, seam: str) -> str:
        """The seam's failure mode (exact match wins over bare prefix;
        default "fault")."""
        mode = self.modes.get(seam)
        if mode is None and "." in seam:
            mode = self.modes.get(seam.split(".", 1)[0])
        return mode or "fault"

    def should_fail(self, seam: str) -> bool:
        """Consume one call slot on `seam`; True = inject."""
        return self.decide(seam)[0]

    def decide(self, seam: str) -> Tuple[bool, int]:
        """Consume one call slot on `seam`; returns (inject?, index).
        The index makes corruption REPLAYABLE: a corrupt-mode injector
        seeds its perturbation from (seed, seam, index), so the same
        spec flips the same bits in the same calls every run."""
        with self._lock:
            idx = self._counts.get(seam, 0)
            self._counts[seam] = idx + 1
        rule = self._rule_for(seam)
        if rule is None or rule is False:
            return False, idx
        if rule is True:
            verdict = True
        elif isinstance(rule, bool):  # pragma: no cover - covered above
            verdict = rule
        elif isinstance(rule, int):
            verdict = idx < rule
        elif isinstance(rule, float):
            verdict = random.Random(
                f"{self.seed}:{seam}:{idx}").random() < rule
        else:
            verdict = bool(rule(idx))
        if verdict:
            with self._lock:
                self.injected[seam] = self.injected.get(seam, 0) + 1
            self._m_injected.inc()
            # every injection decision lands in the flight-recorder
            # ring: a post-mortem bundle must say whether the chaos
            # harness, not the device, caused the episode
            RECORDER.record("chaos_decision", seam=seam, index=idx,
                            mode=self.mode_for(seam))
        return verdict, idx

    def fire(self, seam: str) -> None:
        """Raise `InjectedFault` when the schedule says this call fails."""
        if self.should_fail(seam):
            raise InjectedFault(
                f"chaos: injected fault at {seam} "
                f"(call {self._counts[seam] - 1}, seed {self.seed})")

    def calls(self, seam: str) -> int:
        with self._lock:
            return self._counts.get(seam, 0)


def parse_spec(spec: str) -> ChaosSchedule:
    """Parse the CLI chaos spec string.

    ``"seed=7,backend.bls_verify_committees=2,mainchain.collation_record=0.3"``
    — `seed=` names the schedule seed; every other entry is a seam
    rule: ``always`` -> True, a value containing ``.`` -> float rate,
    otherwise -> int first-n.

    A ``<seam>:mode=corrupt`` entry tags the seam's failure mode
    (``backend.ecrecover_addresses:mode=corrupt``); a mode entry with
    no rule of its own defaults the seam's rule to every-call. A seam
    written ``backend.*`` is the bare prefix ``backend`` (every op
    under it). ``delay_s=`` names the transport-delay stall for
    ``fleet.transport:mode=delay`` entries
    (``"fleet.transport=0.3,fleet.transport:mode=delay,delay_s=0.1"``).
    Malformed mode entries fail fast with the offending
    token — a typo'd mode silently injecting nothing (or loudly
    instead of silently) would test less than the operator asked for.
    """
    seed = 0
    delay_s = 0.25
    rules: Dict = {}
    modes: Dict[str, str] = {}
    mode_only: List[str] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"chaos spec entry {part!r} is not key=value")
        key, value = (s.strip() for s in part.split("=", 1))
        if key.endswith(".*"):  # backend.* == the bare prefix rule
            key = key[:-2]
        if key == "seed":
            seed = int(value)
        elif key == "delay_s":
            delay_s = float(value)
        elif ":" in key:
            seam, attr = (s.strip() for s in key.split(":", 1))
            if seam.endswith(".*"):
                seam = seam[:-2]
            if attr != "mode":
                raise ValueError(
                    f"chaos spec entry {part!r}: unknown seam attribute "
                    f"{attr!r} (only 'mode' is supported)")
            if value not in MODES:
                raise ValueError(
                    f"chaos spec entry {part!r}: unknown mode {value!r}; "
                    f"choose from {MODES}")
            modes[seam] = value
            mode_only.append(seam)
        elif value == "always":
            rules[key] = True
        elif "." in value:
            rules[key] = float(value)
        else:
            rules[key] = int(value)
    for seam in mode_only:
        # a mode entry alone means "every call, in that mode"
        rules.setdefault(seam, True)
    return ChaosSchedule(seed=seed, rules=rules, modes=modes,
                         delay_s=delay_s)


def transport_disturb(schedule: Optional[ChaosSchedule]) -> None:
    """Consume one ``fleet.transport`` slot and act on it: ``delay``
    stalls the calling (wire) thread `schedule.delay_s` seconds before
    letting the call proceed — the slow-link tail the router's hedging
    exists to cut; ``partition`` (and plain ``fault``) raise
    `InjectedFault`, the unreachable-replica failure the router's
    consecutive-transport-failure trip absorbs. One seam, both the
    in-process `TransportChaos` front and `RpcReplicaBackend`'s real
    wire consult it, so an in-process fleet and a cross-process fleet replay
    the same timeline from the same spec."""
    if schedule is None or not schedule.has_rule(TRANSPORT_SEAM):
        return
    inject, idx = schedule.decide(TRANSPORT_SEAM)
    if not inject:
        return
    mode = schedule.mode_for(TRANSPORT_SEAM)
    if mode == "delay":
        time.sleep(schedule.delay_s)
        return
    raise InjectedFault(
        f"chaos: transport {mode} at {TRANSPORT_SEAM} "
        f"(call {idx}, seed {schedule.seed})")


class TransportChaos:
    """A transport-seam front for an IN-PROCESS replica backend: every
    public call first consults the ``fleet.transport`` schedule
    (`transport_disturb`) — a delay stalls it, a partition refuses it
    with the retryable `InjectedFault` — then passes through. Gives a
    hermetic test fleet the same wire weather a real
    `RpcReplicaBackend` sees, without sockets."""

    def __init__(self, target, schedule: ChaosSchedule):
        self._target = target
        self._schedule = schedule
        self.name = f"transport-chaos+{getattr(target, 'name', '?')}"

    @property
    def inner(self):
        """Wrapper-chain hop (breaker_of / serving nesting guard)."""
        return self._target

    def __getattr__(self, name: str):
        attr = getattr(self._target, name)
        if name.startswith("_") or name == "close" or not callable(attr):
            return attr  # lifecycle/local reads never cross the wire
        schedule = self._schedule

        def over_wire(*args, **kwargs):
            transport_disturb(schedule)
            return attr(*args, **kwargs)

        return over_wire


class _ChaosProxy:
    """Attribute proxy injecting scheduled faults in front of every
    public method of `target`. Non-callable attributes and private names pass
    through; `overrides` replaces whole methods for degraded-backend
    doubles (e.g. a backend without the batched committee view)."""

    def __init__(self, target, schedule: ChaosSchedule, seam_prefix: str,
                 overrides: Optional[Dict[str, Callable]] = None):
        self._target = target
        self._schedule = schedule
        self._seam_prefix = seam_prefix
        self._overrides = overrides or {}

    def __getattr__(self, name: str):
        override = self._overrides.get(name)
        if override is not None:
            return override
        attr = getattr(self._target, name)
        if name.startswith("_"):
            return attr
        schedule, seam = self._schedule, f"{self._seam_prefix}.{name}"
        if not callable(attr):
            # property-backed reads (e.g. mainchain.block_number) are
            # injectable too, but only when a rule NAMES them — plain
            # data passthroughs must not consume schedule slots
            if schedule.has_rule(seam):
                schedule.fire(seam)
            return attr

        def chaotic(*args, **kwargs):
            schedule.fire(seam)
            return attr(*args, **kwargs)

        return chaotic


def wrap(target, schedule: ChaosSchedule, seam_prefix: str,
         overrides: Optional[Dict[str, Callable]] = None):
    """Front `target` with scheduled ``<seam_prefix>.<method>`` faults."""
    return _ChaosProxy(target, schedule, seam_prefix, overrides)


def unwired_seams(schedule: ChaosSchedule,
                  wired: Tuple[str, ...]) -> List[str]:
    """Rules whose seam prefix is not in `wired`: a spec entry the
    caller never routes through an injector fires nothing, so the
    experiment silently tests less than the operator asked for — the
    caller should warn (or refuse) rather than stay quiet."""
    return sorted(seam for seam in schedule.rules
                  if seam.split(".", 1)[0] not in wired)


class ChaosSigBackend(SigBackend):
    """`SigBackend` front injecting device faults and dispatch hangs.

    ``backend.<op>`` schedule entries raise `InjectedFault` before the
    inner call; ``dispatch.<op>`` entries sleep `hang_s` seconds first
    — when this backend sits under the serving tier, that wedges the
    dispatch thread exactly like a hung device call, which is the
    watchdog's prey. A ``backend.<op>`` seam in ``mode=corrupt``
    raises nothing: scheduled calls run the real op and then silently
    perturb its result (seeded by (seed, seam, call index), so the
    same spec corrupts the same rows every run) — the silent-
    corruption failure class the soundness spot-checker exists for."""

    def __init__(self, inner: SigBackend, schedule: ChaosSchedule,
                 hang_s: float = 30.0):
        self.inner = inner
        self.schedule = schedule
        self.hang_s = hang_s
        self.name = f"chaos+{inner.name}"

    def _corrupt_result(self, op: str, out, idx: int):
        """Silently wrong, never loud: flip one row's verdict bit, or
        perturb one recovered address (valid -> near-miss bytes,
        invalid -> fabricated address). Callers skip empty batches
        before consuming a schedule slot (nothing to corrupt without
        changing the row count, which would be a LOUD shape error);
        the guard here is defensive only."""
        out = list(out)
        if not out:  # pragma: no cover - callers skip empty batches
            return out
        rng = random.Random(
            f"{self.schedule.seed}:corrupt:{op}:{idx}")
        row = rng.randrange(len(out))
        if op == "ecrecover_addresses":
            addr = out[row]
            if addr is None:
                out[row] = rng.randbytes(20)
            else:
                out[row] = bytes(addr[:-1]) + bytes([addr[-1] ^ 0x01])
        else:
            out[row] = not bool(out[row])
        return out

    def _op(self, op: str, *args, **kwargs):
        if self.schedule.should_fail(f"dispatch.{op}"):
            time.sleep(self.hang_s)
        seam = f"backend.{op}"
        if self.schedule.mode_for(seam) == "corrupt":
            rows = len(args[0]) if args else 0
            if rows == 0:
                # nothing to corrupt: off the books, so the schedule's
                # injected count stays equal to results actually
                # corrupted (fault mode still raises on empty batches)
                return getattr(self.inner, op)(*args, **kwargs)
            inject, idx = self.schedule.decide(seam)
            out = getattr(self.inner, op)(*args, **kwargs)
            return self._corrupt_result(op, out, idx) if inject else out
        self.schedule.fire(seam)
        return getattr(self.inner, op)(*args, **kwargs)

    def ecrecover_addresses(self, digests, sigs65):
        return self._op("ecrecover_addresses", digests, sigs65)

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        return self._op("bls_verify_aggregates", messages, agg_sigs,
                        agg_pks)

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        return self._op("bls_verify_committees", messages, sig_rows,
                        pk_rows, pk_row_keys=pk_row_keys)

    def das_verify_samples(self, chunks, indices, proofs, roots):
        return self._op("das_verify_samples", chunks, indices, proofs,
                        roots)

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        return self._op("das_verify_multiproofs", commitments, index_rows,
                        eval_rows, proofs, ns)

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        # fire at submit time: a fault lands where the real device
        # raises (the staged launch), and a hang wedges the submitter
        if self.schedule.should_fail("dispatch.bls_verify_committees"):
            time.sleep(self.hang_s)
        seam = "backend.bls_verify_committees"
        if self.schedule.mode_for(seam) == "corrupt":
            # corruption lands at PULL time, where a silently wrong
            # device plane would materialize — the submit stays async
            inject, idx = ((False, 0) if len(messages) == 0
                           else self.schedule.decide(seam))
            inner = self.inner.bls_verify_committees_async(
                messages, sig_rows, pk_rows, pk_row_keys=pk_row_keys)
            if not inject:
                return inner
            from gethsharding_tpu_torch.sigbackend import VerdictFuture

            return VerdictFuture(lambda: self._corrupt_result(
                "bls_verify_committees", inner.result(), idx))
        self.schedule.fire(seam)
        return self.inner.bls_verify_committees_async(
            messages, sig_rows, pk_rows, pk_row_keys=pk_row_keys)
