"""Observer actor: the default, non-staking shard watcher (the port's copy
of the JAX package's `actors/observer.py`).

Parity: `sharding/observer/service.go` (NewObserver :27). The observer
tails new canonical collations of its shard and replays them: every
canonical collation's transactions run through the phase-1 state
transition (`core/state_processor`), keeping the shard's running account
state and a state root a period.

With `replay_engine="torch"` the replay is one `ops/replay.py::
replay_batch` over the collation on `device` (None: the card), folded back
into the host `ShardState` by `replay_on_device`: the table is the state's
accounts ∪ the touched addresses, ascending
(`state_processor.replay_account_table`), the order `build_replay_inputs`
gives the device, so row i of the outputs is the table's i-th account.
`"python"` is the scalar `state_processor.process`; `"off"` only follows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from gethsharding_tpu_torch import metrics
from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.shard import Shard, ShardError
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.mainchain.client import SMCClient
from gethsharding_tpu_torch.ops import replay
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

_ZERO_COINBASE = Address20(b"\x00" * 20)


def replay_on_device(state: sp.ShardState, txs: Sequence[Transaction],
                     coinbase: Address20, device=None) -> int:
    """Replay one collation's transactions on `device` (the card unless
    'cpu' is asked for) and fold the final table back into `state`.
    Returns the number of transactions applied."""
    inp = replay.build_replay_inputs([txs], [state.accounts], [coinbase],
                                     device=device)
    out = replay.replay_batch(inp)
    table = sp.replay_account_table(txs, state.accounts, coinbase)
    nonces = out.nonces[0].cpu().tolist()
    balances = out.balances[0].cpu().numpy().astype("uint8")
    for i, addr in enumerate(table):
        acct = state.get(addr)
        acct.nonce = int(nonces[i])
        acct.balance = int.from_bytes(bytes(balances[i]), "little")
    return int(out.statuses[0].sum())


class Observer(Service):
    name = "observer"
    supervisable = True

    def __init__(self, client: SMCClient, shard: Shard,
                 replay_engine: str = "python",
                 genesis: Optional[Dict[Address20, sp.AccountState]] = None,
                 device=None):
        if replay_engine not in ("python", "torch", "off"):
            raise ValueError(f"unknown replay engine {replay_engine!r}")
        super().__init__()
        self.client = client
        self.shard = shard
        self.replay_engine = replay_engine
        # where the "torch" engine replays: None is the card
        self.device = device
        # deep-copy account rows: replay mutates them in place, and the
        # caller's genesis mapping must stay pristine
        self.state = sp.ShardState(
            {addr: dataclasses.replace(acct)
             for addr, acct in genesis.items()} if genesis else None)
        self.state_roots: Dict[int, Hash32] = {}
        # canonical secure-MPT roots (statedb.go:562 parity) per period —
        # the commitment a Go node recomputes; state_roots stays the fast
        # flat integrity check shared bit-for-bit with the device kernel
        self.canonical_roots: Dict[int, Hash32] = {}
        self.txs_replayed = 0
        self.txs_rejected = 0
        self.seen_periods = set()
        self._unsubscribe = None
        self.m_replay_latency = metrics.timer("observer/replay_latency")
        self.m_txs_replayed = metrics.counter("observer/txs_replayed")
        self.m_txs_rejected = metrics.counter("observer/txs_rejected")

    def on_start(self) -> None:
        self.log.info("Starting observer service in shard %d",
                      self.shard.shard_id)
        self._unsubscribe = self.client.subscribe_new_head(self._on_head)

    def on_stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()

    def _on_head(self, block) -> None:
        try:
            self._observe_head()
            self.record_success()
        except Exception as exc:
            self.record_failure(f"observe failed: {exc}")

    def _observe_head(self) -> None:
        period = self.client.current_period()
        shard_id = self.shard.shard_id
        if period in self.seen_periods:
            return
        if self.client.last_approved_collation(shard_id) == period:
            try:
                collation = self.shard.canonical_collation(shard_id, period)
            except ShardError:
                # header approved on-chain but body not yet synced locally:
                # do NOT mark the period seen — the next head retries, so
                # a late-arriving body cannot leave a silent gap in the
                # replayed state
                self.log.info(
                    "Canonical header approved for shard %d period %d "
                    "(body not local yet)", shard_id, period,
                )
                return
            self.seen_periods.add(period)
            self.log.info(
                "Observed canonical collation: shard %d period %d txs %d",
                shard_id, period, len(collation.transactions),
            )
            if self.replay_engine != "off":
                self.replay_collation(period, collation)

    # -- the collation replay (state_processor.go Process analog) ----------

    def replay_collation(self, period: int, collation) -> Hash32:
        """Apply the collation's transactions to the shard's running
        state; record and return the post-state root."""
        txs = collation.transactions
        coinbase = collation.header.proposer_address or _ZERO_COINBASE
        with self.m_replay_latency.time():
            if self.replay_engine == "torch" and txs:
                applied = replay_on_device(self.state, txs, coinbase,
                                           device=self.device)
            else:
                # materialize the same account rows the device table holds
                # (zero rows hash into the root; the two engines must
                # agree even when every tx is rejected)
                for addr in sp.replay_account_table(
                        txs, self.state.accounts, coinbase):
                    self.state.get(addr)
                receipts = sp.process(self.state, txs, coinbase)
                applied = sum(r.status for r in receipts)
        self.txs_replayed += applied
        self.txs_rejected += len(txs) - applied
        self.m_txs_replayed.inc(applied)
        self.m_txs_rejected.inc(len(txs) - applied)
        root = self.state.root()
        self.state_roots[period] = root
        canonical = self.state.trie_root()
        self.canonical_roots[period] = canonical
        self.log.info("Replayed collation: shard %d period %d applied %d/%d "
                      "root 0x%s state_root 0x%s", self.shard.shard_id,
                      period, applied, len(txs), bytes(root).hex()[:16],
                      bytes(canonical).hex()[:16])
        return canonical
