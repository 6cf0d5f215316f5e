"""`python -m gethsharding_tpu_torch.cli sharding` — the port's node entry
point (the port's copy of the `sharding` subcommand of the JAX package's
`node/cli.py`).

Parity: `cmd/geth/shardingcmd.go` (+ flags `cmd/utils/flags.go:536-549`):
`sharding --actor {notary,proposer,observer} --shardid N --deposit
--datadir PATH`, the data-availability flags (`--da-mode sampled
--da-proofs merkle|poly --da-samples K --da-parity R`), the serving and
resilience flags (`--serving` and its `--serving-*` knobs, `--chaos SPEC`,
`--soundness-rate R`, `--sigbackend failover-torch`), plus the dev-mode
flags that run an in-process simulated mainchain with automatic block
production. The flags are the reference's
of the features the port has, with the same names and defaults; the node
runs on the CUDA card and exits non-zero where there is none. The options
the port has not ported (ROADMAP.md, queue A) are absent, and `--actor
light` is refused by naming its module.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.node.backend import ShardNode
from gethsharding_tpu_torch.params import Config, ETHER
from gethsharding_tpu_torch.smc.chain import SimulatedMainchain


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
                          help="what role to run (flags.go:542 ActorFlag; "
                               "'light' is not ported yet)")
    sharding.add_argument("--shardid", type=int, default=0,
                          help="shard to operate on (flags.go:546)")
    sharding.add_argument("--deposit", action="store_true",
                          help="deposit 1000 ETH to join the notary pool "
                               "(flags.go:537)")
    sharding.add_argument("--datadir", default="",
                          help="data directory (in-memory DB if empty)")
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
    sharding.add_argument("--verbosity", default="info",
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
    return 2


def run_sharding_node(args, device=None) -> int:
    """Build the node on an in-process dev chain, start it, seal a block
    every `--blocktime` seconds for `--runtime` seconds (0: until
    interrupted), stop it and log its services' errors. `device` is the
    node's (None: the card)."""
    config = Config(period_length=args.periodlength,
                    windback_depth=args.windback)
    raw_backend = backend = SimulatedMainchain(config=config)
    log = logging.getLogger("sharding.node")
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
            # the fault proxy fronts the chain under the node's client;
            # the dev-mode block loop below keeps driving the raw chain:
            # chaos targets the actor's view of the chain
            backend = chaos_mod.wrap(backend, chaos_schedule, "mainchain")
            log.warning(
                "chaos mainchain.* rules are wired under the client, which "
                "does not retry — injected mainchain faults will surface "
                "to the actors unretried")
    try:
        node = ShardNode(
            actor=args.actor,
            shard_id=args.shardid,
            config=config,
            backend=backend,
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
        )
    except (ValueError, RuntimeError) as exc:
        print(f"sharding: {exc}", file=sys.stderr)
        return 2
    # dev mode: fund the node account so --deposit can stake
    raw_backend.fund(node.client.account(), 2000 * ETHER)

    log.info("Starting sharding node: actor=%s shard=%d account=%s "
             "device=%s da=%s sigbackend=%s", args.actor, args.shardid,
             node.client.account().hex_str, node.device,
             args.da_mode if args.da_mode == "full"
             else f"sampled/{args.da_proofs}", node.sig_backend.name)
    node.start()

    deadline = time.monotonic() + args.runtime if args.runtime else None
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(args.blocktime)
            block = raw_backend.commit()
            if block.number % config.period_length == 0:
                log.info("period %d sealed (block %d)",
                         raw_backend.current_period(), block.number)
    except KeyboardInterrupt:
        log.info("interrupt received, shutting down")
    finally:
        node.stop()
    for error in node.errors():
        log.warning("service error: %s", error)
    log_failover_summary(log, node)
    return 0


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
