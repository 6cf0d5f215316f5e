"""Standalone introduction node: `python -m gethsharding_tpu_torch.rpc.bootnode`
(the port's copy of the JAX package's `rpc/bootnode.py`).

The `cmd/bootnode` analog: the reference ships a stripped node that runs
ONLY the discovery/bootstrap layer so peers can find each other without
a full chain node. Here the introduction tier is the shardp2p relay
(authenticated attach, peer table with listener endpoints, broadcast
fan-out — `rpc/server.py` shard_p2p*), so a bootnode is an RPCServer
over a chainless stub backend: it refuses every chain/SMC method but
serves the full peer-introduction surface, and the direct
(`p2p/direct.py`) data plane works unchanged — payloads never transit
the bootnode, exactly as they never transit `cmd/bootnode`.

Prints one JSON line {"host": ..., "port": ...} once listening.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from gethsharding_tpu_torch.params import Config


class _IntroductionOnly:
    """Backend stub: network identity, no chain. Any chain/SMC read or
    transaction fails loudly — a bootnode introduces peers, nothing
    else (cmd/bootnode serves discovery only)."""

    def __init__(self, config: Config):
        self.config = config

    def subscribe_new_head(self, callback):
        return lambda: None  # no chain: no heads ever

    def __getattr__(self, name):
        raise AttributeError(
            f"bootnode serves peer introduction only; {name!r} needs a "
            f"chain process (rpc/chain_server.py)")


def make_bootnode(host: str = "127.0.0.1", port: int = 0,
                  network_id: int = None):
    """An RPCServer serving only the shardp2p introduction surface."""
    from gethsharding_tpu_torch.rpc.server import RPCServer

    config = Config() if network_id is None else Config(
        network_id=network_id)
    return RPCServer(_IntroductionOnly(config), host=host, port=port)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bootnode")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--networkid", type=int, default=None)
    parser.add_argument("--runtime", type=float, default=0.0,
                        help="seconds before exit (0 = forever)")
    parser.add_argument("--verbosity", default="warning")
    args = parser.parse_args(argv)

    logging.basicConfig(level=getattr(logging, args.verbosity.upper()))
    server = make_bootnode(args.host, args.port, args.networkid)
    server.start()
    host, port = server.address
    print(json.dumps({"host": host, "port": port}), flush=True)
    deadline = time.monotonic() + args.runtime if args.runtime else None
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
