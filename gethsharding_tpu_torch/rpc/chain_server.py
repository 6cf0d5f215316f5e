"""Standalone mainchain process: `python -m gethsharding_tpu_torch.rpc.chain_server`
(the port's copy of the JAX package's `rpc/chain_server.py`).

The dev-mode equivalent of the geth process the reference's actors dial
(`sharding/mainchain/utils.go:17` — one mainchain node, N actor
processes). Hosts a SimulatedMainchain behind an RPCServer; block
production is either timed (--blocktime) or driven remotely via the
shard_commit / shard_fastForward dev methods.

The verification RPCs (`shard_verifyCommittees`, `shard_ecrecover`,
`shard_verifyAggregates`, `shard_dasVerify`, `shard_dasPolyVerify`) and the
vote-log replay (`shard_verifyPeriodBatch`) run through one serving tier,
composed device → (chaos) → serving → (soundness) → (failover) as the
node composes it. `--sigbackend torch` puts the port's CUDA kernels under
it and exits non-zero where there is no card; `--mesh-devices N` lays them
over an N-card shard mesh (`sigbackend/layout.py`) and exits non-zero
where fewer cards are visible; `python` serves from the host. The
vote-log replay runs where the backend runs (slot 0 of a mesh).

Prints one JSON line {"host": ..., "port": ...} on stdout once listening,
so a parent process (test harness, orchestrator) can dial it. Logs, and
at exit one line `chain-server at exit: {json}` with the kernel launches
by name, the serving tier's requests and dispatches by op and the RPC
methods served, go to stderr. SIGTERM stops it as SIGINT does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time

from gethsharding_tpu_torch.params import Config
from gethsharding_tpu_torch.rpc.server import RPCServer
from gethsharding_tpu_torch.smc.chain import SimulatedMainchain

# the reference's options whose modules the port has not ported
UNPORTED = {
    "--trace-out": "tracing/export.py",
    "--fleettrace-export": "fleettrace/",
}


def raise_interrupt(signum, frame):
    """SIGTERM as SIGINT: the `finally` blocks run and the exit lines are
    written (an orchestrator stops its children with SIGTERM)."""
    raise KeyboardInterrupt


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="chain-server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--periodlength", type=int, default=5)
    parser.add_argument("--quorum", type=int, default=None,
                        help="override QUORUM_SIZE (dev/test chains)")
    parser.add_argument("--shardcount", type=int, default=None)
    parser.add_argument("--networkid", type=int, default=None)
    parser.add_argument("--blocktime", type=float, default=0.0,
                        help="auto block production interval (0 = manual "
                             "via shard_commit / shard_fastForward)")
    parser.add_argument("--runtime", type=float, default=0.0,
                        help="seconds before exit (0 = forever)")
    parser.add_argument("--follow", default=None, metavar="HOST:PORT",
                        help="run as a FOLLOWER replicating the leader "
                             "chain process at HOST:PORT (headers "
                             "engine-verified, state via checkpoint "
                             "pull — smc/sync.py)")
    parser.add_argument("--sigbackend", default="torch",
                        choices=("python", "torch", "failover-python",
                                 "failover-torch"),
                        help="backend behind the verification serving "
                             "tier: handler threads coalesce concurrent "
                             "requests into shared dispatches (torch = "
                             "the port's CUDA kernels on the card); "
                             "failover-* composes the serving tier behind "
                             "a circuit breaker over the scalar fallback "
                             "and exports the breaker state on "
                             "shard_health")
    parser.add_argument("--mesh-devices", type=int, default=None,
                        help="lay the torch sigbackend over an N-device "
                             "1-D shard mesh (default GETHSHARDING_TORCH_"
                             "MESH_DEVICES, else 1: one card); too few "
                             "cards exit non-zero")
    parser.add_argument("--serving-watchdog-s", type=float, default=0.0,
                        help="dispatch watchdog deadline for the serving "
                             "tier (0 = off): a wedged device call fails "
                             "its batch with DeadlineExceeded — under "
                             "failover-* that is a breaker fault")
    parser.add_argument("--serving-quota-rows", type=int, default=None,
                        help="per-tenant queued-row quota in the serving "
                             "admission queues (default: "
                             "GETHSHARDING_TORCH_TENANT_QUOTA_ROWS, "
                             "0 = off)")
    parser.add_argument("--chaos", default="", metavar="SPEC",
                        help="seeded chaos schedule at the backend/"
                             "dispatch seams (resilience/chaos.py)")
    parser.add_argument("--soundness-rate", type=float, default=None,
                        help="continuous soundness spot-check rate for "
                             "this process's serving planes (resilience/"
                             "soundness.py; default GETHSHARDING_TORCH_"
                             "SOUNDNESS_RATE, 0 = off) — pair with "
                             "--sigbackend failover-* so a detected "
                             "silent corruption trips the breaker")
    parser.add_argument("--trace", action="store_true",
                        help="collect RPC-handler + serving-tier spans "
                             "in the in-memory tracer")
    parser.add_argument("--trace-out", default="",
                        help="not ported: the Chrome trace export waits "
                             "for tracing/export.py")
    parser.add_argument("--trace-ring", type=int, default=4096,
                        help="finished-span ring capacity")
    parser.add_argument("--fleettrace-export", default=None,
                        metavar="HOST:PORT",
                        help="not ported: the span export waits for "
                             "fleettrace/")
    parser.add_argument("--verbosity", default="warning")
    return parser


def refused(args) -> str:
    """The first unported option given, named with its module ('' when
    none is)."""
    given = {"--trace-out": bool(args.trace_out),
             "--fleettrace-export": args.fleettrace_export is not None}
    for option, on in given.items():
        if on:
            return (f"{option}: the port has no {UNPORTED[option]} yet "
                    f"(ROADMAP.md, queue A)")
    return ""


def compose(args, device):
    """device → (chaos) → serving → (soundness) → (failover), as the node
    composes its backend (node/backend.py); `device` a list of slots for a
    mesh. Returns (the composition, the serving tier)."""
    from gethsharding_tpu_torch.serving import (ServingConfig,
                                                ServingSigBackend)
    from gethsharding_tpu_torch.sigbackend import build_backend

    failover = args.sigbackend.startswith("failover-")
    inner_name = (args.sigbackend[len("failover-"):] if failover
                  else args.sigbackend)
    sig_backend = build_backend(inner_name, device)
    if args.chaos:
        from gethsharding_tpu_torch.resilience.chaos import (
            ChaosSigBackend, parse_spec)

        sig_backend = ChaosSigBackend(sig_backend, parse_spec(args.chaos))
    serving = sig_backend = ServingSigBackend(sig_backend, ServingConfig(
        watchdog_s=args.serving_watchdog_s,
        tenant_quota_rows=args.serving_quota_rows))
    soundness_rate = args.soundness_rate
    if soundness_rate is None:
        soundness_rate = float(os.environ.get(
            "GETHSHARDING_TORCH_SOUNDNESS_RATE", "0") or 0)
    if soundness_rate > 0:
        from gethsharding_tpu_torch.resilience.soundness import (
            SpotCheckSigBackend)

        if not failover:
            logging.getLogger("chain-server").warning(
                "--soundness-rate without --sigbackend failover-*: a "
                "detected corruption raises to the caller instead of "
                "tripping a breaker")
        sig_backend = SpotCheckSigBackend(sig_backend, rate=soundness_rate)
    if failover:
        from gethsharding_tpu_torch.resilience.breaker import (
            FailoverSigBackend)
        from gethsharding_tpu_torch.sigbackend import get_backend

        sig_backend = FailoverSigBackend(sig_backend, get_backend("python"))
    return sig_backend, serving


def exit_summary(server, serving) -> dict:
    """What this process served and launched: the kernel launches by
    name, the serving tier's requests and dispatches by op, the RPC
    methods by name."""
    from gethsharding_tpu_torch import metrics
    from gethsharding_tpu_torch.ops import _build
    from gethsharding_tpu_torch.serving.batcher import OP_LABELS

    registry = metrics.DEFAULT_REGISTRY
    value = lambda name: getattr(registry.get(name), "value", 0)
    return {
        "launches": {name: n for name, n in
                     _build.launch_counts().items() if n},
        "serving": {label: [value(f"serving/{label}/requests"),
                            serving.batcher.dispatch_counts[op]]
                    for op, label in OP_LABELS.items()},
        "methods": dict(sorted(server.method_calls.items())),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.verbosity.upper()),
        format="%(asctime)s %(levelname)-7s %(name)s  %(message)s",
        datefmt="%H:%M:%S")
    reason = refused(args)
    if reason:
        print(f"chain-server: {reason}", file=sys.stderr)
        return 2
    from gethsharding_tpu_torch import tracing
    from gethsharding_tpu_torch.device import resolve_device
    from gethsharding_tpu_torch.sigbackend.layout import resolve_slots

    if args.trace:
        tracing.enable(ring_spans=args.trace_ring)
    overrides = {"period_length": args.periodlength}
    if args.quorum is not None:
        overrides["quorum_size"] = args.quorum
    if args.shardcount is not None:
        overrides["shard_count"] = args.shardcount
    if args.networkid is not None:
        overrides["network_id"] = args.networkid
    config = Config(**overrides)
    # the card, or the mesh's cards, for the port's kernels (no card or
    # too few: exit non-zero, never a fallback); the host for the scalar
    # backend
    try:
        if args.sigbackend.endswith("torch"):
            target = resolve_slots(None, args.mesh_devices)
        else:
            target = resolve_device("cpu")
        composed, serving = compose(args, target)
        device = target[0] if isinstance(target, list) else target
    except (RuntimeError, ValueError) as exc:
        print(f"chain-server: {exc}", file=sys.stderr)
        return 2
    backend = SimulatedMainchain(config=config)
    # the SLO tracker booted so the shard_metrics snapshot carries the
    # slo/<class>/... series from the first scrape
    from gethsharding_tpu_torch import slo

    slo.tracker()
    server = RPCServer(backend, host=args.host, port=args.port,
                       sig_backend=composed, device=device)
    server.start()
    follower = None
    if args.follow:
        from gethsharding_tpu_torch.smc.sync import ChainFollower

        leader_host, leader_port = args.follow.rsplit(":", 1)
        follower = ChainFollower(backend, leader_host, int(leader_port))
        follower.start()
    previous = signal.signal(signal.SIGTERM, raise_interrupt)
    print(json.dumps({"host": server.address[0], "port": server.address[1]}),
          flush=True)

    deadline = time.monotonic() + args.runtime if args.runtime else None
    try:
        while deadline is None or time.monotonic() < deadline:
            if args.blocktime > 0 and follower is None:
                time.sleep(args.blocktime)
                backend.commit()
            else:
                time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        if follower is not None:
            follower.stop()
        server.stop()
        # the server never owned the injected composition: drain-and-fail
        # its queued serving futures here so no caller is stranded
        composed.close()
        print("chain-server at exit: "
              + json.dumps(exit_summary(server, serving), sort_keys=True),
              file=sys.stderr, flush=True)
        signal.signal(signal.SIGTERM, previous)
    return 0


if __name__ == "__main__":
    sys.exit(main())
