"""SLO-driven autoscaler: the fleet reshapes itself under live traffic (the
port's copy of the JAX package's `fleet/autoscaler.py`).

The signals were already federated — the router's health sweep folds
every replica's scraped snapshot into ``fleet/class/<c>/queue_depth``
and ``fleet/worst_replica_p99_s``, and the SLO tracker burns
``slo/<class>/burn_rate`` — this loop merely CLOSES them: a background
controller that reads those gauges every ``interval_s`` and drives the
membership control plane (fleet/membership.py) through a pluggable
`ReplicaSpawner`.

Control law (hysteresis bands + cooldowns, so the fleet never flaps):

- **scale OUT** on fast-burn (the interactive error budget burning at
  ``out_burn``x or worse — the page-now signal) OR on sustained queue
  depth (``out_depth`` rows across the fleet for ``sustain_s``): spawn
  a replica, admit it DRAINING, let the health sweep promote it.
- **scale IN** only when the SLOW burn is clean (<= ``in_burn``) AND
  depth is near zero (<= ``in_depth``), both sustained for
  ``sustain_s``: drain the newest autoscaled replica through the
  ordinary removal path (in-flight finishes, then detach), retire its
  process once the router lets go. Only replicas THIS loop spawned are
  candidates — the operator's boot topology is never scaled away.
- every action arms a ``cooldown_s`` during which triggers are HELD
  (counted, not acted on): the fleet must observe the last action's
  effect before the next one.

Every decision is traced (``fleet/autoscale/decision`` spans),
countered (``fleet/autoscale/{out,in,held}``) and flight-recorded, so
a post-mortem can replay why the fleet was the size it was.

`ChainServerSpawner` is the production spawner (one
``rpc.chain_server`` subprocess per replica, endpoint read from its
one-line JSON banner); tests drive an in-proc fake. Its replicas run
``--sigbackend torch`` by default, the port's kernels on the card, since
the port's entry points run on the card unless asked otherwise (the JAX
package's spawner, and its frontend's ``--autoscale-backend``, default
to ``python``); ``python`` stays a choice, and a spawner whose process
has ``GETHSHARDING_TORCH_DEVICE=cpu`` in its environment starts ``torch``
replicas on the kernels' plain versions on the host (the children
inherit it). A
``torch`` replica on a machine with no card exits non-zero before its
banner, so its spawn fails the decision: the spawner never swaps in
``python``. The knobs keep the JAX package's defaults under the port's
prefix, ``GETHSHARDING_TORCH_AUTOSCALE_*``.
"""

from __future__ import annotations

import json
import logging
import os
import select
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from gethsharding_tpu_torch import metrics, slo, tracing
from gethsharding_tpu_torch.fleet.membership import FleetMembership
from gethsharding_tpu_torch.perfwatch import RECORDER
from gethsharding_tpu_torch.serving.classes import (ADMISSION_CLASSES,
                                                    CLASS_INTERACTIVE)

log = logging.getLogger("fleet.autoscaler")


def _env_f(name: str, default: float) -> float:
    return float(os.environ.get(name, "") or default)


@dataclass
class AutoscaleConfig:
    """The control-law knobs; every field has a GETHSHARDING_TORCH_AUTOSCALE_*
    override (from_env) so soaks tune the loop without code."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 1.0
    # scale-out triggers: interactive fast-burn OR sustained depth
    out_burn: float = 2.0
    out_depth: float = 64.0
    # scale-in gate: slow-burn clean AND depth near zero, sustained
    in_burn: float = 0.25
    in_depth: float = 1.0
    sustain_s: float = 3.0
    cooldown_s: float = 10.0
    klass: str = CLASS_INTERACTIVE

    @classmethod
    def from_env(cls) -> "AutoscaleConfig":
        return cls(
            min_replicas=int(_env_f("GETHSHARDING_TORCH_AUTOSCALE_MIN", 1)),
            max_replicas=int(_env_f("GETHSHARDING_TORCH_AUTOSCALE_MAX", 4)),
            interval_s=_env_f("GETHSHARDING_TORCH_AUTOSCALE_INTERVAL_S", 1.0),
            out_burn=_env_f("GETHSHARDING_TORCH_AUTOSCALE_OUT_BURN", 2.0),
            out_depth=_env_f("GETHSHARDING_TORCH_AUTOSCALE_OUT_DEPTH", 64.0),
            in_burn=_env_f("GETHSHARDING_TORCH_AUTOSCALE_IN_BURN", 0.25),
            in_depth=_env_f("GETHSHARDING_TORCH_AUTOSCALE_IN_DEPTH", 1.0),
            sustain_s=_env_f("GETHSHARDING_TORCH_AUTOSCALE_SUSTAIN_S", 3.0),
            cooldown_s=_env_f("GETHSHARDING_TORCH_AUTOSCALE_COOLDOWN_S", 10.0),
        )


class ReplicaSpawner:
    """The pluggable replica lifecycle: `spawn` returns a dialable
    ``HOST:PORT`` endpoint (the process may still be booting — runtime
    admission enters it DRAINING and the health sweep promotes it once
    it answers); `retire` reclaims one; `close` reclaims everything."""

    def spawn(self) -> str:
        raise NotImplementedError

    def retire(self, endpoint: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ChainServerSpawner(ReplicaSpawner):
    """Production spawner: one ``rpc.chain_server`` subprocess per
    replica, on the serving sigbackend the fleet runs. The endpoint
    comes from the child's one-line JSON banner, read with a deadline
    so a wedged spawn fails the decision instead of the loop.

    With `log_dir` each child's stderr, where its
    ``chain-server at exit:`` line with the kernel launches lands, goes to
    ``<log_dir>/replica-<k>.log`` (`logs` maps endpoint to path); without
    it, to /dev/null."""

    def __init__(self, sigbackend: str = "torch",
                 host: str = "127.0.0.1",
                 extra_args: Optional[List[str]] = None,
                 spawn_timeout_s: float = 30.0,
                 log_dir: Optional[str] = None):
        self.sigbackend = sigbackend
        self.host = host
        self.extra_args = list(extra_args or [])
        self.spawn_timeout_s = spawn_timeout_s
        self.log_dir = log_dir
        self.logs: Dict[str, str] = {}
        self._spawns = 0
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def spawn(self) -> str:
        cmd = [sys.executable, "-m",
               "gethsharding_tpu_torch.rpc.chain_server",
               "--host", self.host, "--port", "0",
               "--sigbackend", self.sigbackend,
               "--verbosity", "error"] + self.extra_args
        with self._lock:
            k, self._spawns = self._spawns, self._spawns + 1
        log_path = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(self.log_dir, f"replica-{k}.log")
        with open(log_path or os.devnull, "wb") as err:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=err)
        line = self._read_banner(proc)
        if line is None:
            proc.kill()
            proc.wait()
            raise RuntimeError("spawned chain_server printed no "
                               "address banner before the deadline")
        addr = json.loads(line)
        endpoint = f"{addr['host']}:{addr['port']}"
        with self._lock:
            self._procs[endpoint] = proc
            if log_path is not None:
                self.logs[endpoint] = log_path
        log.info("spawned replica %s (pid %d)", endpoint, proc.pid)
        return endpoint

    def _read_banner(self, proc: subprocess.Popen) -> Optional[str]:
        deadline = time.monotonic() + self.spawn_timeout_s
        buf = b""
        fd = proc.stdout.fileno()
        while time.monotonic() < deadline:
            ready, _, _ = select.select([fd], [], [], 0.2)
            if not ready:
                if proc.poll() is not None:
                    return None  # died before printing
                continue
            chunk = os.read(fd, 4096)
            if not chunk:
                return None
            buf += chunk
            if b"\n" in buf:
                return buf.split(b"\n", 1)[0].decode()
        return None

    def retire(self, endpoint: str) -> None:
        with self._lock:
            proc = self._procs.pop(endpoint, None)
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.info("retired replica %s", endpoint)

    def spawned(self) -> List[str]:
        with self._lock:
            return list(self._procs)

    def close(self) -> None:
        for endpoint in self.spawned():
            self.retire(endpoint)


class Autoscaler:
    """The background control loop over a `FleetMembership`."""

    # a drained removal that never detaches (a wedged in-flight call)
    # is force-retired after this long: the membership already dropped
    # it, the router already refuses it new work, and its caller's
    # retry policy covers the severed call
    RETIRE_GRACE_S = 30.0

    def __init__(self, membership: FleetMembership,
                 spawner: ReplicaSpawner,
                 config: Optional[AutoscaleConfig] = None,
                 registry: metrics.Registry = metrics.DEFAULT_REGISTRY,
                 signals: Optional[Callable[[], dict]] = None):
        self.membership = membership
        self.spawner = spawner
        self.config = config or AutoscaleConfig.from_env()
        self.registry = registry
        self.signals = signals or self._default_signals
        self._m_out = registry.counter("fleet/autoscale/out")
        self._m_in = registry.counter("fleet/autoscale/in")
        self._m_held = registry.counter("fleet/autoscale/held")
        self._g_size = registry.gauge("fleet/autoscale/replicas")
        self._lock = threading.Lock()
        self._spawned: List[str] = []   # newest last; scale-in pops
        self._retiring: Dict[str, float] = {}  # endpoint -> deadline
        self._depth_high_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._cooldown_until = 0.0
        self.last_decision: dict = {"action": "none", "reason": "boot"}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -----------------------------------------------------------

    def _default_signals(self) -> dict:
        """The federated gauges the loop closes over: the class's SLO
        burns from the tracker, queue depth and worst p99 from the
        router sweep's fold (this process's registry)."""
        tracker = slo.tracker()
        depth = 0.0
        for klass in ADMISSION_CLASSES:
            depth += self.registry.gauge(
                f"fleet/class/{klass}/queue_depth").value
        return {
            "burn_fast": tracker.burn_rate(self.config.klass, "fast"),
            "burn_slow": tracker.burn_rate(self.config.klass, "slow"),
            "depth": depth,
            "p99": self.registry.gauge("fleet/worst_replica_p99_s").value,
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-autoscale")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.spawner.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("autoscale tick failed")

    # -- the control law ---------------------------------------------------

    def tick(self, now: Optional[float] = None) -> dict:
        """One decision: read signals, apply the hysteresis bands, act
        at most once. Public so tests (and an inline stress loop)
        can step the loop deterministically."""
        now = time.monotonic() if now is None else now
        sig = self.signals()
        cfg = self.config
        size = len(self.membership.endpoints())
        self._g_size.set(size)
        self._reap(now)

        # sustained-signal tracking (hysteresis bands)
        with self._lock:
            if sig["depth"] >= cfg.out_depth:
                if self._depth_high_since is None:
                    self._depth_high_since = now
            else:
                self._depth_high_since = None
            if sig["burn_slow"] <= cfg.in_burn \
                    and sig["depth"] <= cfg.in_depth:
                if self._calm_since is None:
                    self._calm_since = now
            else:
                self._calm_since = None

        want_out, out_reason = False, ""
        if sig["burn_fast"] >= cfg.out_burn:
            want_out = True
            out_reason = (f"fast burn {sig['burn_fast']:.1f}x >= "
                          f"{cfg.out_burn:.1f}x")
        elif self._depth_high_since is not None \
                and now - self._depth_high_since >= cfg.sustain_s:
            want_out = True
            out_reason = (f"queue depth {sig['depth']:.0f} >= "
                          f"{cfg.out_depth:.0f} for {cfg.sustain_s:.0f}s")
        want_in = (not want_out
                   and self._calm_since is not None
                   and now - self._calm_since >= cfg.sustain_s)

        decision = {"action": "none", "reason": "in band",
                    "size": size, "signals": sig}
        if want_out:
            if size >= cfg.max_replicas:
                decision.update(action="held",
                                reason=f"{out_reason}; at max "
                                       f"{cfg.max_replicas}")
            elif now < self._cooldown_until:
                decision.update(action="held",
                                reason=f"{out_reason}; cooling down")
            else:
                decision.update(action="out", reason=out_reason)
        elif want_in:
            in_reason = (f"slow burn {sig['burn_slow']:.2f}x clean, "
                         f"depth {sig['depth']:.0f} for "
                         f"{cfg.sustain_s:.0f}s")
            with self._lock:
                candidates = [e for e in self._spawned
                              if e not in self._retiring]
            if size <= cfg.min_replicas or not candidates:
                decision.update(action="none",
                                reason=f"{in_reason}; at floor")
            elif now < self._cooldown_until:
                decision.update(action="held",
                                reason=f"{in_reason}; cooling down")
            else:
                decision.update(action="in", reason=in_reason,
                                candidate=candidates[-1])
        self._act(decision, now)
        self.last_decision = decision
        return decision

    def _act(self, decision: dict, now: float) -> None:
        action = decision["action"]
        if action == "held":
            self._m_held.inc()
            RECORDER.record("autoscale_held", reason=decision["reason"])
            return
        if action not in ("out", "in"):
            return
        with tracing.span("fleet/autoscale/decision", action=action,
                          reason=decision["reason"]):
            if action == "out":
                endpoint = self.spawner.spawn()
                with self._lock:
                    self.membership.add(endpoint)
                    self._spawned.append(endpoint)
                self._m_out.inc()
                log.warning("autoscale OUT -> %s (%s)", endpoint,
                            decision["reason"])
                RECORDER.record("autoscale_out", endpoint=endpoint,
                                reason=decision["reason"],
                                signals=decision["signals"])
            else:
                endpoint = decision["candidate"]
                with self._lock:
                    self.membership.remove(endpoint)
                    self._retiring[endpoint] = now + self.RETIRE_GRACE_S
                self._m_in.inc()
                log.warning("autoscale IN <- %s (%s)", endpoint,
                            decision["reason"])
                RECORDER.record("autoscale_in", endpoint=endpoint,
                                reason=decision["reason"],
                                signals=decision["signals"])
        self._cooldown_until = now + self.config.cooldown_s
        # a fresh action resets the sustain clocks: the next trigger
        # must re-earn its band against the NEW fleet size
        with self._lock:
            self._depth_high_since = None
            self._calm_since = None

    def _reap(self, now: float) -> None:
        """Retire drained removals: once the router detached the
        replica (or the grace expired on a wedged drain), reclaim its
        process."""
        with self._lock:
            retiring = list(self._retiring.items())
        live = {r.name for r in self.membership.router.members()}
        for endpoint, deadline in retiring:
            if endpoint in live and now < deadline:
                continue  # still draining; give it its grace
            try:
                self.spawner.retire(endpoint)
            except Exception:  # noqa: BLE001 - reclaim is best-effort
                log.exception("retiring %s failed", endpoint)
            with self._lock:
                self._retiring.pop(endpoint, None)
                if endpoint in self._spawned:
                    self._spawned.remove(endpoint)

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            spawned = list(self._spawned)
            retiring = list(self._retiring)
        return {"out": self._m_out.value, "in": self._m_in.value,
                "held": self._m_held.value,
                "spawned": spawned, "retiring": retiring,
                "cooldown": time.monotonic() < self._cooldown_until,
                "last_decision": {k: v for k, v in
                                  self.last_decision.items()
                                  if k != "signals"}}
