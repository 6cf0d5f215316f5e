"""`python -m gethsharding_tpu_torch.cli sharding` — the port's node entry
point (the port's copy of the `sharding` subcommand of the JAX package's
`node/cli.py`).

Parity: `cmd/geth/shardingcmd.go` (+ flags `cmd/utils/flags.go:536-549`):
`sharding --actor {notary,proposer,observer} --shardid N --deposit
--datadir PATH`, plus the dev-mode flags that run an in-process simulated
mainchain with automatic block production. The flags are the reference's
of the features the port has, with the same names and defaults; the node
runs on the CUDA card and exits non-zero where there is none. The options
the port has not ported (ROADMAP.md, queue A) are absent, and `--actor
light` is refused by naming its module.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional

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
                          choices=("torch",),
                          help="signature verification backend: the "
                               "port's CUDA kernels")
    sharding.add_argument("--supervise", action="store_true",
                          help="watch actor services and restart crashed "
                               "ones as fresh instances (bounded; "
                               "node/service.go:78-83 restart semantics)")
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
    backend = SimulatedMainchain(config=config)
    log = logging.getLogger("sharding.node")
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
        )
    except (ValueError, RuntimeError) as exc:
        print(f"sharding: {exc}", file=sys.stderr)
        return 2
    # dev mode: fund the node account so --deposit can stake
    backend.fund(node.client.account(), 2000 * ETHER)

    log.info("Starting sharding node: actor=%s shard=%d account=%s "
             "device=%s", args.actor, args.shardid,
             node.client.account().hex_str, node.device)
    node.start()

    deadline = time.monotonic() + args.runtime if args.runtime else None
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(args.blocktime)
            block = backend.commit()
            if block.number % config.period_length == 0:
                log.info("period %d sealed (block %d)",
                         backend.current_period(), block.number)
    except KeyboardInterrupt:
        log.info("interrupt received, shutting down")
    finally:
        node.stop()
    for error in node.errors():
        log.warning("service error: %s", error)
    return 0


if __name__ == "__main__":
    sys.exit(run_cli())
