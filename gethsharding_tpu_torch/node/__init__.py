"""Node runtime of the port: the service container (`backend.py`) and the
CLI wiring (`cli.py`). `ShardNode` loads on first use, so that the CLI's
`devnet` (which starts processes and runs no node itself) imports no
torch."""


def __getattr__(name: str):
    if name == "ShardNode":
        from gethsharding_tpu_torch.node.backend import ShardNode

        return ShardNode
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
