"""Shard p2p: typed feed bus + request/response messaging over the
in-process hub, or across OS processes over a chain process's relay and
direct peer sockets (`p2p/remote.py`); the port's copy of the JAX
package's `p2p/`, whose whisper waits (ROADMAP.md queue A).
"""

from gethsharding_tpu_torch.p2p.feed import Feed, Subscription  # noqa: F401
from gethsharding_tpu_torch.p2p.messages import (  # noqa: F401
    ChunkProofRequest,
    ChunkProofResponse,
    CollationBodyRequest,
    CollationBodyResponse,
    DASCommitmentRequest,
    DASCommitmentResponse,
    DASMultiproofRequest,
    DASMultiproofResponse,
    DASampleRequest,
    DASampleResponse,
)
from gethsharding_tpu_torch.p2p.service import (  # noqa: F401
    Hub,
    Message,
    P2PServer,
    Peer,
)
