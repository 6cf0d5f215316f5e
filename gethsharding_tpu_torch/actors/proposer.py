"""Proposer actor: packages transactions into collations, registers headers
(the port's copy of the JAX package's `actors/proposer.py`).

Parity: `sharding/proposer/service.go` (proposeCollations :72,
createCollation :93) and `proposer.go` (createCollation pure :55, AddHeader
:20, checkHeaderAdded :98): subscribe to the txpool feed, build a collation
per tx batch (serialize -> chunkRoot -> sign with the node account), save
it to the shardDB, and submit `addHeader` to the SMC when the period has no
submission yet. With a `DASService` (`das=`, `--da-mode sampled`) every
collation is erasure-extended and its chunks and signed commitment
published before the header goes on-chain.
"""

from __future__ import annotations

from typing import List, Optional

from gethsharding_tpu_torch import tracing
from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.core.shard import Shard
from gethsharding_tpu_torch.core.types import (
    Collation,
    CollationHeader,
    Transaction,
    serialize_txs_to_blob,
)
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.actors.txpool import TXPool
from gethsharding_tpu_torch.params import Config, DEFAULT_CONFIG
from gethsharding_tpu_torch.smc.state_machine import SMCRevert


def create_collation(client: SMCClient, shard_id: int, period: int,
                     txs: List[Transaction]) -> Collation:
    """Pure collation construction (parity: proposer.go:55 createCollation):
    validate shard/period, serialize txs, merklize the chunk root, sign the
    header hash with the node account."""
    if not (0 <= shard_id < client.shard_count()):
        raise ValueError(f"shard id {shard_id} out of range")
    body = serialize_txs_to_blob(txs)
    header = CollationHeader(
        shard_id=shard_id,
        period=period,
        proposer_address=client.account(),
    )
    collation = Collation(header=header, body=body, transactions=list(txs))
    collation.calculate_chunk_root()
    signature = client.sign(bytes(header.hash()))
    header.add_sig(signature)
    return collation


def check_header_added(client: SMCClient, shard_id: int, period: int) -> bool:
    """True if this period still has no submitted header (proposer.go:98)."""
    return client.last_submitted_collation(shard_id) < period


class Proposer(Service):
    name = "proposer"
    supervisable = True

    def __init__(self, client: SMCClient, txpool: TXPool, shard: Shard,
                 config: Config = DEFAULT_CONFIG,
                 poll_interval: float = 0.05,
                 das=None):
        super().__init__()
        self.client = client
        self.txpool = txpool
        self.shard = shard
        self.config = config
        self.poll_interval = poll_interval
        # data-availability sampling: with a DASService every created
        # collation is erasure-extended and its chunks and signed
        # commitment published, so sampled notaries vote without the body
        self.das = das
        self.collations_proposed = 0
        self.das_published = 0
        self._sub = None

    def on_start(self) -> None:
        self._sub = self.txpool.transactions_feed.subscribe()
        self.spawn(self._propose_collations)

    def on_stop(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()

    # -- the loop (parity: proposeCollations service.go:72-90) -------------

    def _propose_collations(self) -> None:
        while not self.stopped():
            tx = self._sub.try_get()
            if tx is None:
                if self.wait(self.poll_interval):
                    return
                continue
            try:
                # a feed event wakes the proposer; the collation packs the
                # pool's full price-ordered pending selection (the feed tx
                # was admitted to the pool before publication), which the
                # pool then drops as included — core/tx_pool Pending +
                # mined-drop semantics
                batch = self.txpool.take_pending()
                self._propose(batch if batch else [tx])
            except Exception as exc:
                self.record_error(f"create collation failed: {exc}")

    def _propose(self, txs: List[Transaction]) -> None:
        """`create_and_submit`, again once for the new period where the
        chain sealed the period's last block between the head read and
        the addHeader transaction (a chain process seals on its own clock,
        so the window is its RPC round trips; in-process chains never
        hit it)."""
        try:
            self.create_and_submit(txs)
        except SMCRevert as exc:
            if "period is not current" not in str(exc):
                raise
            self.log.info("period ended before addHeader (%s): proposing "
                          "again in the new period", exc)
            self.create_and_submit(txs)

    def create_and_submit(self, txs: List[Transaction]) -> Optional[Collation]:
        # the collation lifecycle trace root: create (serialize ->
        # chunk root -> sign -> persist) then addHeader on-chain
        with tracing.span("proposer/propose", txs=len(txs)):
            # the addHeader tx executes in the pending block; derive the
            # period from it so headers never straddle a period boundary
            period = ((self.client.block_number + 1)
                      // self.config.period_length)
            with tracing.span("proposer/create"):
                collation = create_collation(self.client,
                                             self.shard.shard_id,
                                             period, txs)
                # persist locally regardless; only one header per
                # (shard, period) can go on-chain (service.go:93)
                self.shard.save_collation(collation)
            if self.das is not None:
                # extend and publish before addHeader: by the time the
                # header is on-chain, sampled notaries can pull the
                # commitment and chunks. A failed publish must not lose
                # the collation itself (full-fetch peers still serve it):
                # it is recorded as this service's error.
                try:
                    self.das.publish(collation.header.shard_id, period,
                                     collation.header.chunk_root,
                                     collation.body)
                    self.das_published += 1
                except Exception as exc:  # noqa: BLE001 - recorded
                    self.record_error(f"das publish failed: {exc}")
            self.collations_proposed += 1
            self.log.info(
                "Saved collation with header hash %s",
                collation.header.hash().hex_str,
            )
            if check_header_added(self.client, self.shard.shard_id, period):
                self.add_header(collation)
            return collation

    def add_header(self, collation: Collation) -> None:
        """Submit the header to the SMC (proposer.go:20 AddHeader)."""
        header = collation.header
        with tracing.span("proposer/add_header", shard=header.shard_id,
                          period=header.period):
            self.client.add_header(
                header.shard_id, header.period, header.chunk_root,
                header.proposer_signature,
            )
        self.log.info("Added header to SMC: shard %s period %s",
                      header.shard_id, header.period)
