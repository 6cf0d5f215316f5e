"""CLI entry point of the port: `python -m gethsharding_tpu_torch.cli
sharding --actor {notary,proposer,observer}` (the counterpart of the JAX
package's `cli.py`; the node wiring is `node/cli.py`)."""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from gethsharding_tpu_torch.node.cli import run_cli

    return run_cli(argv)


if __name__ == "__main__":
    raise SystemExit(main())
