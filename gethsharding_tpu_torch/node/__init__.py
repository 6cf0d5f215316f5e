"""Node runtime of the port: the service container (`backend.py`) and the
CLI wiring (`cli.py`)."""

from gethsharding_tpu_torch.node.backend import ShardNode  # noqa: F401
