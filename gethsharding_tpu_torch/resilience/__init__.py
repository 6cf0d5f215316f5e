"""Fault-tolerance layer of the port (the port's copy of the JAX package's
`resilience/`):

- ``errors.py``    — `TransientError`, `FetchAborted`, and the serving
  tier's and the breaker's `ResilienceError`, `DeadlineExceeded`,
  `DispatcherClosed`, `SoundnessViolation`;
- ``policy.py``    — `RetryPolicy` (with its deadline and seeded
  jitter), `RetryExecutor`, `retry_call`, `poll_probe`,
  `DEFAULT_RETRYABLE`;
- ``journal.py``   — `VoteJournal`: (shard, period) votes and the audit
  high-water mark through `db/kv`, replayed on notary start;
- ``breaker.py``   — `FailoverSigBackend`: the card's backend behind a
  circuit breaker over the scalar `PythonSigBackend`, with a half-open
  differential probe (``--sigbackend failover-*``);
- ``watchdog.py``  — `DispatchWatchdog`: a hung serving dispatch fails
  its batch with `DeadlineExceeded` and the dispatcher restarts;
- ``chaos.py``     — seeded, replayable failure schedules at the
  backend-op, dispatch, mainchain-call, DAS and fleet-transport seams
  (``--chaos``), including the silent-corruption ``mode=corrupt`` rules
  and the transport's ``delay``/``partition`` modes;
- ``soundness.py`` — `SpotCheckSigBackend`: a sampled re-verification of
  the device's rows against the scalar reference plus an always-on
  verdict-plane invariant check (``--soundness-rate``).

The submodules are imported on first use (PEP 562): `errors`, `policy`
and `journal` are leaf modules the node's services import directly, and
the wrappers load only where failover, chaos or soundness is in play.
"""

from __future__ import annotations

from gethsharding_tpu_torch.resilience.errors import (  # noqa: F401
    DeadlineExceeded,
    DispatcherClosed,
    FetchAborted,
    ResilienceError,
    SoundnessViolation,
    TransientError,
)

_LAZY = {
    "DEFAULT_RETRYABLE": ("policy", "DEFAULT_RETRYABLE"),
    "POLL_MISS": ("policy", "POLL_MISS"),
    "RetryExecutor": ("policy", "RetryExecutor"),
    "RetryPolicy": ("policy", "RetryPolicy"),
    "poll_probe": ("policy", "poll_probe"),
    "retry_call": ("policy", "retry_call"),
    "VoteJournal": ("journal", "VoteJournal"),
    "CircuitBreaker": ("breaker", "CircuitBreaker"),
    "FailoverSigBackend": ("breaker", "FailoverSigBackend"),
    "DispatchWatchdog": ("watchdog", "DispatchWatchdog"),
    "ChaosSchedule": ("chaos", "ChaosSchedule"),
    "ChaosSigBackend": ("chaos", "ChaosSigBackend"),
    "InjectedFault": ("chaos", "InjectedFault"),
    "parse_spec": ("chaos", "parse_spec"),
    "TransportChaos": ("chaos", "TransportChaos"),
    "transport_disturb": ("chaos", "transport_disturb"),
    "unwired_seams": ("chaos", "unwired_seams"),
    "wrap": ("chaos", "wrap"),
    "SpotCheckSigBackend": ("soundness", "SpotCheckSigBackend"),
    "detection_probability": ("soundness", "detection_probability"),
    "dispatches_to_detect": ("soundness", "dispatches_to_detect"),
}

__all__ = [
    "DeadlineExceeded", "DispatcherClosed", "FetchAborted",
    "ResilienceError", "SoundnessViolation", "TransientError",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(f"{__name__}.{module_name}")
    value = getattr(module, attr)
    globals()[name] = value  # cache: the next access skips __getattr__
    return value
