"""Shard p2p: typed feed bus + request/response messaging over the
in-process hub (the port's copy of the JAX package's `p2p/`; its remote
hub, direct links, discovery and whisper wait, ROADMAP.md queue A).
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
