"""Chain-process sync: a follower mainchain replicates a leader (the port's
copy of the JAX package's `smc/sync.py`).

The reference topology runs "mainchain geth <-> devp2p <-> other geth
nodes" (SURVEY §1): block announcement/download between chain nodes
(`eth/handler.go:318` announce handling, `eth/downloader/downloader.go:
479` header+state sync). This module is that leg at dev-chain scale:

- HEADERS: the follower polls the leader's head, walks hashes back to
  the common ancestor (bounded by the snapshot horizon, exactly the
  reorg window `import_chain` supports), pulls the missing range over
  `shard_blockRange`, and imports it through `SimulatedMainchain.
  import_chain` — so every adopted block passes the consensus ENGINE's
  seal verification (the fake engine's hash rule) and
  reorgs follow longest-chain, just like a local import;
- STATE: dev-chain blocks are empty (SMC transactions execute outside
  block bodies), so the follower installs the leader's full-state
  checkpoint AT the imported head — the fast-sync pivot-state pull.
  `install_checkpoint` refuses any checkpoint whose (number, hash)
  doesn't match the engine-verified local head, and the pickle blob is
  only ever accepted from the CONFIGURED leader endpoint (never from
  gossip/untrusted peers).

A follower is a read replica: actors can point their read path at it
(load distribution, failover warm-standby); writes still go to the
leader, exactly like a light/full split.
"""

from __future__ import annotations

import logging
from typing import Optional

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.rpc import codec
from gethsharding_tpu_torch.rpc.client import RPCClient

log = logging.getLogger("chain.sync")


class ChainFollower(Service):
    """Keeps a local SimulatedMainchain in lockstep with a leader."""

    name = "chain-follower"
    supervisable = True

    def __init__(self, backend, leader_host: str, leader_port: int,
                 poll_interval: float = 0.2):
        super().__init__()
        self.backend = backend
        self.leader_host = leader_host
        self.leader_port = leader_port
        self.poll_interval = poll_interval
        self.blocks_imported = 0
        self.checkpoints_installed = 0
        self.reorgs_followed = 0
        self._rpc: Optional[RPCClient] = None
        self._installed_seq: Optional[list] = None

    def on_start(self) -> None:
        self._rpc = RPCClient(self.leader_host, self.leader_port)
        self.spawn(self._follow, name="chain-follower")

    def on_stop(self) -> None:
        if self._rpc is not None:
            self._rpc.close()

    # -- the sync loop -------------------------------------------------------

    def _follow(self) -> None:
        while not self.stopped():
            try:
                if self.sync_once():
                    self.record_success()
            except Exception as exc:
                self.record_failure(f"sync round failed: {exc}")
            if self.wait(self.poll_interval):
                return

    def sync_once(self) -> bool:
        """One sync round; True when local state advanced/refreshed."""
        # cheap steady-state gate: skip everything while the leader's
        # state seq matches what we installed (no RPC storm, no
        # per-round checkpoint deserialization)
        seq = self._rpc.call("shard_stateSeq")
        if seq == self._installed_seq:
            return False
        leader_head = self._rpc.call("shard_blockNumber")
        local_head = self.backend.block_number
        # find the common ancestor (hash walk, newest first; a reorg
        # deeper than the snapshot horizon cannot be followed — the same
        # bound import_chain/set_head enforce via state snapshots)
        probe = min(leader_head, local_head)
        ancestor = None
        while probe >= 0:
            theirs = self._rpc.call("shard_blockByNumber", probe)
            ours = self.backend.block_by_number(probe)
            if bytes(ours.hash) == codec.dec_bytes(theirs["hash"]):
                ancestor = probe
                break
            probe -= 1
            if local_head - probe >= self.backend.SNAPSHOT_HORIZON:
                self.record_error("leader diverged beyond the snapshot "
                                  "horizon; cannot follow the reorg")
                return False
        if ancestor is None:
            self.record_error("no common ancestor with the leader")
            return False

        if leader_head > ancestor:
            # chunked pull: the server caps one range at 4096 blocks, a
            # far-behind follower catches up over several calls
            blocks = []
            start = ancestor + 1
            while start <= leader_head:
                end = min(start + 4095, leader_head)
                blocks.extend(codec.dec_block(b) for b in self._rpc.call(
                    "shard_blockRange", start, end))
                start = end + 1
            if ancestor < local_head:
                self.reorgs_followed += 1
            adopted = self.backend.import_chain(blocks)
            if adopted == 0 and ancestor < local_head:
                # equal-length fork: import_chain's longest-wins keeps
                # the incumbent, but the LEADER is this follower's
                # source of truth — follow its branch explicitly
                self.backend.set_head(ancestor)
                adopted = self.backend.import_chain(blocks)
            self.blocks_imported += adopted
        elif ancestor < local_head:
            # leader is BEHIND on our branch (it reorged to a shorter
            # chain via set_head): follow it down
            self.backend.set_head(ancestor)
            self.reorgs_followed += 1

        checkpoint = self._rpc.call("shard_stateCheckpoint")
        if self.backend.install_checkpoint(checkpoint):
            self.checkpoints_installed += 1
            self._installed_seq = checkpoint.get("seq")
            return True
        return False  # leader advanced mid-round; next round catches up
