"""Simulator: fakes remote-notary traffic for in-process multi-node tests
(the port's copy of the JAX package's `actors/simulator.py`).

Parity: `sharding/simulator/service.go` (simulateNotaryRequests :70): on a
ticker, read the SMC collation record for the current period and inject a
CollationBodyRequest into the local feeds, exercising the syncer
round-trip without a real network.
"""

from __future__ import annotations

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.actors.syncer import request_collation_body
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.p2p.service import P2PServer


class Simulator(Service):
    name = "simulator"
    supervisable = True

    def __init__(self, client: SMCClient, p2p: P2PServer, shard_id: int,
                 tick_interval: float = 15.0):
        super().__init__()
        self.client = client
        self.p2p = p2p
        self.shard_id = shard_id
        self.tick_interval = tick_interval
        self.requests_sent = 0

    def on_start(self) -> None:
        self.spawn(self._simulate_notary_requests)

    def _simulate_notary_requests(self) -> None:
        while not self.wait(self.tick_interval):
            try:
                period = self.client.current_period()
                request = request_collation_body(self.client, self.shard_id,
                                                 period)
                if request is not None:
                    self.p2p.loopback(request)
                    self.requests_sent += 1
                    self.log.info("Sent request for collation body")
            except Exception as exc:
                self.record_error(f"simulator tick failed: {exc}")
