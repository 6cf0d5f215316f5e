"""JSON-RPC transport: the actor <-> mainchain process boundary (the port's
copy of the JAX package's `rpc/`).

Parity: `rpc/` (server `rpc/server.go:46`, IPC codec, subscriptions) and
`sharding/mainchain/utils.go:17-22` (dialRPC) — the reference's actors
talk to a separate geth process over newline-delimited JSON-RPC on an IPC
socket. Here the same wire protocol runs over TCP (or a unix socket):
`RPCServer` exposes a SimulatedMainchain, `RemoteMainchain` is the
client-side backend an `SMCClient` can use in place of the in-process
chain, making the sharding node a genuinely separate OS process.
"""

from gethsharding_tpu_torch.rpc.client import (RemoteMainchain, RPCClient,
                                              RPCError)
from gethsharding_tpu_torch.rpc.server import RPCServer

__all__ = ["RPCClient", "RPCError", "RPCServer", "RemoteMainchain"]
