"""The observer's device replay (the port's counterpart of
`Observer._replay_on_device` in the JAX package's `actors/observer.py`).

The observer tails its shard's canonical collations and replays each one's
transactions into its running account state. On the device path that is
one `ops/replay.py::replay_batch` over the collation, folded back into the
host `ShardState`: the table is the state's accounts ∪ the touched
addresses, ascending (`state_processor.replay_account_table`), the order
`build_replay_inputs` gives the device, so row i of the outputs is the
table's i-th account. The `Observer` service itself is not part of the
port yet.
"""

from __future__ import annotations

from typing import Sequence

from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.ops import replay
from gethsharding_tpu_torch.utils.hexbytes import Address20


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
