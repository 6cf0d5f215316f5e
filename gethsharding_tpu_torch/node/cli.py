"""`python -m gethsharding_tpu_torch.cli sharding|devnet` — the port's node
entry points (the port's copy of the `sharding` and `devnet` subcommands of
the JAX package's `node/cli.py`).

Parity: `cmd/geth/shardingcmd.go` (+ flags `cmd/utils/flags.go:536-549`):
`sharding --actor {notary,proposer,observer,light} --shardid N --deposit
--datadir PATH --password PW`, `--mesh-devices N` (the committee audit
over an N-card shard mesh), the data-availability flags (`--da-mode
sampled --da-proofs merkle|poly --da-samples K --da-parity R`), the serving
and resilience flags (`--serving` and its `--serving-*` knobs, `--chaos
SPEC`, `--soundness-rate R`, `--sigbackend failover-torch`), the fleet
and status flags (`--fleet-frontend HOST:PORT[,...]`, which hands every
verification to a fleet frontend's replicas, and `--http PORT`, the
status page), plus the dev-mode flags that run an in-process simulated
mainchain with automatic block production, or `--endpoint HOST:PORT`,
which dials a running chain process (`rpc/chain_server.py`) for the chain
(`RemoteMainchain`) and the shardp2p relay (`RemoteHub`) instead. `devnet`
starts one chain process and N actor processes and supervises them
(`devnet.py`). The flags are the
reference's of the features the port has, with the same names and
defaults; the node runs on the CUDA card and exits non-zero where there is
none, but for a light node (`--actor light`), which verifies on the host
and needs no card, and for a notary, proposer or light node behind
`--fleet-frontend`, which verifies nothing itself. `--fleet-frontend`
refuses `--serving`, `--chaos`, `--soundness-rate` and `failover-*`: that
composition lives in the frontend's replicas. The options the port has
not ported (ROADMAP.md, queue A) are absent.

At exit the node logs one line `node at exit: {json}`: this process's
kernel launches by name and, for a notary, its heads (`notary/head_latency`),
its votes and its missed votes (`notary/votes_missed`); for a light node,
its verified samples and rejected proofs. SIGTERM stops the node as SIGINT
does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time
from typing import List, Optional

from gethsharding_tpu_torch.params import Config, ETHER


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpu-sharding-torch",
        description="sharding client on the PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sharding = sub.add_parser(
        "sharding", help="run a sharding actor node"
    )
    sharding.add_argument("--actor", default="observer",
                          choices=("notary", "proposer", "observer", "light"),
                          help="what role to run (flags.go:542 ActorFlag)")
    sharding.add_argument("--shardid", type=int, default=0,
                          help="shard to operate on (flags.go:546)")
    sharding.add_argument("--deposit", action="store_true",
                          help="deposit 1000 ETH to join the notary pool "
                               "(flags.go:537)")
    sharding.add_argument("--datadir", default="",
                          help="data directory (in-memory DB if empty)")
    sharding.add_argument("--password", default=None,
                          help="password file or literal for the encrypted "
                               "keystore under <datadir>/keystore "
                               "(flags.go PasswordFileFlag); with --datadir "
                               "the node address survives restarts")
    sharding.add_argument("--periodlength", type=int, default=5)
    sharding.add_argument("--windback", type=int, default=0,
                          help="enforced windback depth: periods of prior "
                               "collation bodies a notary must hold before "
                               "voting (sharding/README.md)")
    sharding.add_argument("--blocktime", type=float, default=1.0,
                          help="dev-mode block production interval seconds")
    sharding.add_argument("--runtime", type=float, default=0.0,
                          help="seconds to run before exiting (0 = forever)")
    sharding.add_argument("--txinterval", type=float, default=5.0,
                          help="simulated txpool emission interval")
    sharding.add_argument("--sigbackend", default="torch",
                          choices=("python", "torch", "failover-python",
                                   "failover-torch"),
                          help="signature verification backend: scalar "
                               "host crypto or the port's CUDA kernels; "
                               "failover-* puts the chosen backend behind "
                               "a circuit breaker over the scalar fallback "
                               "(resilience/breaker.py)")
    sharding.add_argument("--mesh-devices", type=int, default=None,
                          help="lay the torch sigbackend over an N-device "
                               "1-D shard mesh: each card audits its slab "
                               "of committees and the vote total is the "
                               "only value crossing cards (default "
                               "GETHSHARDING_TORCH_MESH_DEVICES, else 1: "
                               "one card)")
    sharding.add_argument("--serving", action="store_true",
                          help="run signature verification through the "
                               "micro-batching serving tier: concurrent "
                               "callers' requests coalesce into shared "
                               "dispatches on the card (serving/)")
    sharding.add_argument("--serving-max-batch", type=int, default=128,
                          help="flush a coalesced batch at this many rows "
                               "(rounded to a sigbackend bucket shape)")
    sharding.add_argument("--serving-flush-us", type=float, default=500.0,
                          help="deadline flush: a queued request waits at "
                               "most this many microseconds for company")
    sharding.add_argument("--serving-queue-cap", type=int, default=4096,
                          help="admission cap in rows; beyond it the "
                               "backpressure policy applies")
    sharding.add_argument("--serving-policy", default="block",
                          choices=("block", "shed"),
                          help="backpressure at the queue cap: block the "
                               "caller or shed with a fast error")
    sharding.add_argument("--serving-quota-rows", type=int, default=None,
                          help="per-tenant queued-row quota in the "
                               "serving admission queues (default "
                               "GETHSHARDING_TORCH_TENANT_QUOTA_ROWS, "
                               "0 = off)")
    sharding.add_argument("--serving-watchdog-s", type=float, default=0.0,
                          help="dispatch watchdog deadline in seconds: a "
                               "call wedging the serving dispatch thread "
                               "longer than this fails its batch with "
                               "DeadlineExceeded and the dispatcher "
                               "restarts (0 = off)")
    sharding.add_argument("--supervise", action="store_true",
                          help="watch actor services and restart crashed "
                               "ones as fresh instances (bounded; "
                               "node/service.go:78-83 restart semantics)")
    sharding.add_argument("--da-mode", default="full",
                          choices=("full", "sampled"),
                          help="data-availability mode: 'full' fetches "
                               "whole collation bodies before voting; "
                               "'sampled' erasure-extends bodies "
                               "(proposer) and votes on k sampled chunk "
                               "proofs checked in one batched call on the "
                               "card (notary): zero body bytes")
    sharding.add_argument("--da-proofs", default="merkle",
                          choices=("merkle", "poly"),
                          help="sampled DA proof scheme: 'merkle' ships a "
                               "sibling path per sampled chunk; 'poly' "
                               "ships one constant-size polynomial "
                               "multiproof per sampled collation, checked "
                               "on the pairing kernels (das/pcs.py; dev "
                               "SRS pinned by GETHSHARDING_DAS_SRS_SEED)")
    sharding.add_argument("--da-samples", type=int, default=16,
                          help="sampled DA: chunks sampled per "
                               "(shard, period) availability check")
    sharding.add_argument("--da-parity", type=float, default=0.5,
                          help="sampled DA: parity chunks as a ratio of "
                               "data chunks in the Reed-Solomon extension "
                               "(0.5 = body recoverable from any 2/3 of "
                               "the extended chunks)")
    sharding.add_argument("--chaos", default="",
                          metavar="SPEC",
                          help="deterministic chaos schedule, e.g. "
                               "'seed=7,backend.bls_verify_committees=2,"
                               "mainchain.collation_record=0.2': seeded "
                               "failure injection at the sig-backend, "
                               "dispatch, mainchain-call and (sampled DA) "
                               "das.* seams (resilience/chaos.py); a "
                               "'backend.*:mode=corrupt' entry injects "
                               "silent corruption — pair with "
                               "--soundness-rate to watch it caught")
    sharding.add_argument("--soundness-rate", type=float, default=None,
                          metavar="RATE",
                          help="continuous integrity audit: spot-check "
                               "this fraction of sig-backend dispatches "
                               "against the scalar reference "
                               "(resilience/soundness.py; default off, or "
                               "GETHSHARDING_TORCH_SOUNDNESS_RATE; pair "
                               "with --sigbackend failover-* so a "
                               "mismatch trips the breaker)")
    sharding.add_argument("--fleet-frontend", default="",
                          metavar="HOST:PORT[,HOST:PORT...]",
                          help="dial a standalone fleet frontend "
                               "(python -m gethsharding_tpu_torch.fleet."
                               "frontend) for ALL signature/DAS "
                               "verification instead of composing a "
                               "local backend: the actor's committee "
                               "audits and sample verdicts go over the "
                               "wire to the routed, hedged replica "
                               "fleet, whose replicas run the kernels on "
                               "their cards; a comma-separated list names "
                               "replicated frontends — the actor fails "
                               "over between them (rpc.client."
                               "FrontendPool) on the typed draining/"
                               "connection-lost taxonomy")
    sharding.add_argument("--verbosity", default="info",
                          choices=("debug", "info", "warning", "error"))
    sharding.add_argument("--endpoint", default="",
                          metavar="HOST:PORT",
                          help="dial a running chain process instead of "
                               "hosting an in-process dev chain (the "
                               "`geth sharding [endpoint]` topology: N "
                               "actor processes, one mainchain)")
    sharding.add_argument("--http", type=int, default=None, metavar="PORT",
                          help="serve /healthz /metrics /status on this "
                               "port (dashboard/ethstats analog; 0 picks "
                               "a free one)")

    devnet = sub.add_parser(
        "devnet", help="spin up a whole network as OS processes: one "
                       "chain + N supervised actors (the puppeth / "
                       "ExecAdapter role)")
    devnet.add_argument("--notaries", type=int, default=1)
    devnet.add_argument("--proposers", type=int, default=1)
    devnet.add_argument("--observers", type=int, default=0)
    devnet.add_argument("--lights", type=int, default=0,
                        help="light clients, spread round-robin over the "
                             "shards (actors/light.py)")
    devnet.add_argument("--datadir", default="",
                        help="base dir for per-actor datadirs + logs "
                             "(empty = auto temp dir, kept after exit "
                             "for post-mortems)")
    devnet.add_argument("--blocktime", type=float, default=0.5)
    devnet.add_argument("--quorum", type=int, default=None)
    devnet.add_argument("--shardcount", type=int, default=None)
    devnet.add_argument("--sigbackend", default="torch",
                        choices=("python", "torch", "failover-python",
                                 "failover-torch"),
                        help="the chain process's and every actor's "
                             "signature backend (torch: the port's CUDA "
                             "kernels on the card)")
    devnet.add_argument("--http-base", type=int, default=0,
                        help="give actor i a status server on port "
                             "http-base + i (0 = none)")
    devnet.add_argument("--runtime", type=float, default=0.0,
                        help="seconds before automatic shutdown "
                             "(0 = until SIGINT)")
    devnet.add_argument("--interval", type=float, default=2.0,
                        help="supervision/status cadence")
    devnet.add_argument("--verbosity", default="warning",
                        choices=("debug", "info", "warning", "error"))
    return parser


def run_cli(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.verbosity.upper()),
        format="%(asctime)s %(levelname)-7s %(name)s  %(message)s",
        datefmt="%H:%M:%S",
    )
    if args.command == "sharding":
        return run_sharding_node(args)
    if args.command == "devnet":
        from gethsharding_tpu_torch.devnet import run_devnet

        return run_devnet(args)
    return 2


def raise_interrupt(signum, frame):
    """SIGTERM as SIGINT: the node stops and logs its exit lines (the
    devnet stops its children with SIGTERM)."""
    raise KeyboardInterrupt


def run_sharding_node(args, device=None) -> int:
    """Build the node on an in-process dev chain, or on the chain process
    at `--endpoint`, start it, seal a block every `--blocktime` seconds
    (the chain process seals its own) for `--runtime` seconds (0: until
    interrupted), stop it and log its services' errors. `device` is the
    node's (None: the card for `--sigbackend torch` and its failover
    form, the host for the scalar `python` ones, which launch no kernel)."""
    # the node's modules (torch among them) load here, not at the CLI's
    # import: `devnet` needs none of them
    from gethsharding_tpu_torch.node.backend import ShardNode
    from gethsharding_tpu_torch.smc.chain import SimulatedMainchain

    if args.fleet_frontend:
        local = [flag for flag, on in (
            ("--serving", args.serving), ("--chaos", bool(args.chaos)),
            ("--soundness-rate", float(
                args.soundness_rate if args.soundness_rate is not None
                else os.environ.get("GETHSHARDING_TORCH_SOUNDNESS_RATE",
                                    "0") or 0) > 0),
            (f"--sigbackend {args.sigbackend}",
             args.sigbackend.startswith("failover-"))) if on]
        if local:
            print(f"sharding: --fleet-frontend replaces the local "
                  f"verification composition; {', '.join(local)} apply "
                  f"inside the frontend's replicas, not this actor",
                  file=sys.stderr)
            return 2
    if device is None and args.sigbackend.endswith("python"):
        device = "cpu"
    config = Config(period_length=args.periodlength,
                    windback_depth=args.windback)
    log = logging.getLogger("sharding.node")
    hub = None
    if args.endpoint:
        from gethsharding_tpu_torch.p2p.remote import RemoteHub
        from gethsharding_tpu_torch.rpc.client import RemoteMainchain

        host, _, port = args.endpoint.rpartition(":")
        if not port.isdigit():
            print(f"--endpoint must be HOST:PORT, got {args.endpoint!r}",
                  file=sys.stderr)
            return 2
        try:
            backend = RemoteMainchain.dial(host or "127.0.0.1", int(port))
        except OSError as exc:
            print(f"sharding: --endpoint {args.endpoint}: {exc}",
                  file=sys.stderr)
            return 2
        # the chain process owns the protocol constants: every attached
        # actor adopts its config, so that all agree on periods and
        # committees
        config = backend.chain_config(windback_depth=args.windback)
        hub = RemoteHub.dial(host or "127.0.0.1", int(port),
                             network_id=config.network_id)
    else:
        backend = SimulatedMainchain(config=config)
    raw_backend = backend
    password = args.password
    if password is not None:
        try:  # geth convention: --password usually names a file
            with open(password) as fh:
                password = fh.read().strip()
        except OSError:
            pass  # treat as a literal password
    serving_config = None
    if args.serving_watchdog_s and not args.serving:
        log.warning(
            "--serving-watchdog-s has no effect without --serving (the "
            "watchdog monitors the serving tier's dispatch thread) — "
            "hung-dispatch protection is NOT armed")
    if args.serving:
        from gethsharding_tpu_torch.serving import ServingConfig

        serving_config = ServingConfig(
            max_batch=args.serving_max_batch,
            flush_us=args.serving_flush_us,
            queue_cap=args.serving_queue_cap,
            policy=args.serving_policy,
            watchdog_s=args.serving_watchdog_s,
            tenant_quota_rows=args.serving_quota_rows)
    soundness_rate = args.soundness_rate
    if soundness_rate is None:
        soundness_rate = float(os.environ.get(
            "GETHSHARDING_TORCH_SOUNDNESS_RATE", "0") or 0)
    if soundness_rate > 0 and not args.sigbackend.startswith("failover-"):
        log.warning(
            "--soundness-rate without --sigbackend failover-*: a "
            "spot-check violation will RAISE into the calling actor "
            "instead of tripping a breaker onto the scalar fallback — "
            "silent corruption becomes loud, but nothing fails over")
    chaos_schedule = None
    if args.chaos:
        from gethsharding_tpu_torch.resilience import chaos as chaos_mod

        try:
            chaos_schedule = chaos_mod.parse_spec(args.chaos)
        except ValueError as exc:
            print(f"sharding: --chaos: {exc}", file=sys.stderr)
            return 2
        if soundness_rate <= 0 and any(
                mode == "corrupt" for mode in chaos_schedule.modes.values()):
            log.warning(
                "--chaos has mode=corrupt rules but the soundness "
                "spot-checker is off (--soundness-rate 0) — injected "
                "silent corruption will NOT be detected; pair with "
                "--soundness-rate (and --sigbackend failover-*) to "
                "watch it tripped")
        # the das.* seams exist only on a node running the sampled DA plane
        wired = ("mainchain", "backend", "dispatch")
        if args.da_mode == "sampled":
            wired = wired + ("das",)
        for seam in chaos_mod.unwired_seams(chaos_schedule, wired):
            log.warning(
                "chaos rule %r targets a seam this node never wraps "
                "(wired: %s) — it will inject nothing", seam,
                ", ".join(f"{w}.*" for w in wired))
        if any(seam == "mainchain" or seam.startswith("mainchain.")
               for seam in chaos_schedule.rules):
            # the fault proxy fronts the chain under the client's retry
            # executor; the dev-mode block loop below keeps driving the
            # raw chain: chaos targets the actor's view of the chain
            backend = chaos_mod.wrap(backend, chaos_schedule, "mainchain")
            if int(os.environ.get("GETHSHARDING_CLIENT_RETRIES",
                                  "0")) <= 0:
                log.warning(
                    "chaos mainchain.* rules are wired under the client's "
                    "retry executor, but GETHSHARDING_CLIENT_RETRIES is "
                    "unset/0 — injected mainchain faults will surface to "
                    "the actors unretried")
    try:
        node = ShardNode(
            actor=args.actor,
            shard_id=args.shardid,
            config=config,
            backend=backend,
            hub=hub,
            password=password,
            data_dir=args.datadir,
            in_memory_db=args.datadir == "",
            deposit=args.deposit,
            txpool_interval=args.txinterval,
            sig_backend=args.sigbackend,
            device=device,
            supervise=args.supervise,
            da_mode=args.da_mode,
            da_samples=args.da_samples,
            da_parity=args.da_parity,
            da_proofs=args.da_proofs,
            serving=args.serving,
            serving_config=serving_config,
            chaos=chaos_schedule,
            soundness_rate=soundness_rate,
            mesh_devices=args.mesh_devices,
            fleet_frontend=args.fleet_frontend or None,
            http_port=args.http,
        )
    except (ValueError, RuntimeError, OSError) as exc:
        print(f"sharding: {exc}", file=sys.stderr)
        if hub is not None:
            hub.close()
            raw_backend.close()
        return 2
    # dev mode: fund the node account so --deposit can stake
    raw_backend.fund(node.client.account(), 2000 * ETHER)

    log.info("Starting sharding node: actor=%s shard=%d account=%s "
             "device=%s da=%s sigbackend=%s", args.actor, args.shardid,
             node.client.account().hex_str, node.device,
             args.da_mode if args.da_mode == "full"
             else f"sampled/{args.da_proofs}", node.sig_backend.name)
    previous = signal.signal(signal.SIGTERM, raise_interrupt)
    try:
        node.start()
        deadline = time.monotonic() + args.runtime if args.runtime else None
        while deadline is None or time.monotonic() < deadline:
            time.sleep(args.blocktime)
            if args.endpoint:
                continue  # the chain process owns block production
            block = raw_backend.commit()
            if block.number % config.period_length == 0:
                log.info("period %d sealed (block %d)",
                         raw_backend.current_period(), block.number)
    except KeyboardInterrupt:
        log.info("interrupt received, shutting down")
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        if args.endpoint:
            # the chain process goes on sealing: no head may run while
            # the node's services close under it
            raw_backend.rpc.quiesce()
        node.stop()
        if args.endpoint:
            raw_backend.close()
        signal.signal(signal.SIGTERM, previous)
    for error in node.errors():
        log.warning("service error: %s", error)
    log_failover_summary(log, node)
    log_exit_summary(log, node)
    return 0


def log_exit_summary(log, node) -> None:
    """Log at exit, as one JSON object, this process's kernel launches by
    name, the node's account and, for a notary, its votes, the votes the
    chain sealed the period before (`notary/votes_missed`) and its heads
    end to end (the `notary/head_latency` timer: count, median, largest,
    in ms); for a light node, its verified samples and rejected proofs."""
    from gethsharding_tpu_torch.ops import _build

    summary = {"account": node.client.account().hex_str,
               "launches": {name: n for name, n in
                            _build.launch_counts().items() if n}}
    if node.actor == "light":
        from gethsharding_tpu_torch.actors.light import LightClient

        light = node.service(LightClient)
        summary["samples_verified"] = light.samples_verified
        summary["proofs_rejected"] = light.proofs_rejected
    if node.actor == "notary":
        from gethsharding_tpu_torch.actors.notary import Notary

        notary = node.service(Notary)
        heads = notary.m_head_latency
        summary["votes"] = notary.votes_submitted
        summary["votes_missed"] = notary.votes_missed
        summary["heads"] = {
            "count": heads.count,
            "p50_ms": round(heads.percentile(0.5) * 1e3, 3),
            "max_ms": round(heads.percentile(1.0) * 1e3, 3)}
    log.info("node at exit: %s", json.dumps(summary, sort_keys=True))


def log_failover_summary(log, node) -> None:
    """Under `--sigbackend failover-*`, log at exit, as one JSON object,
    what the breaker routed (primary calls, primary faults, fallback calls,
    trips, its state), the serving tier's requests and dispatches by op,
    and this process's kernel launches by name. A card that failed to
    build or launch shows here as faults and fallbacks, since the breaker
    serves those calls from the host."""
    breaker = getattr(node.sig_backend, "breaker", None)
    if breaker is None:
        return
    from gethsharding_tpu_torch import metrics
    from gethsharding_tpu_torch.ops import _build
    from gethsharding_tpu_torch.serving.batcher import OP_LABELS

    registry = metrics.DEFAULT_REGISTRY
    value = lambda name: getattr(registry.get(name), "value", 0)
    base = f"resilience/breaker/{breaker.name}"
    summary = {k: value(f"{base}/{k}") for k in (
        "primary_calls", "primary_faults", "fallback_calls", "trips")}
    summary["state"] = breaker.state_name
    summary["serving"] = {
        label: [value(f"serving/{label}/requests"),
                value(f"serving/{label}/dispatches")]
        for label in OP_LABELS.values()}
    summary["launches"] = {name: n for name, n in
                           _build.launch_counts().items() if n}
    log.info("sigbackend %s at exit: %s", node.sig_backend.name,
             json.dumps(summary, sort_keys=True))


if __name__ == "__main__":
    sys.exit(run_cli())
