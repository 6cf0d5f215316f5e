"""Resident Miller line tables: the line-table half of the JAX package's
`ResidentPkCache` (`sigbackend/cache.py`).

Committee pubkeys recur period after period, so a committee's aggregate
pubkey, and the line table `ops/bn256.py::precompute_g2_lines` derives
from it, is fixed per `pk_row_key`. `LineTableCache` keeps those tables
in the device's memory under a byte-budgeted LRU: one (88, 3, 2, 25)
int32 tensor (52.8 KB) and one bool per key. A cold row pays one
precompute; a warm audit ships no G2 bytes. A batch memo reuses the
stacked tables whole when an audit repeats the previous audit's key
tuple, the steady state of a notary; a memo hit refreshes its keys in the
LRU as a per-key hit would. Empty rows take a shared zero table
marked infinite, so the audit rejects them.

The backend is shared by every caller thread, so each structure is
guarded by one lock. Keys must determine their row's points (the caller's
contract, as in the reference).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from gethsharding_tpu_torch.ops import bn256 as bn


@dataclass
class LinePlan:
    """One audit's resolution against the cache (`LineTableCache.resolve`).

    steps: per row ("zero",) | ("hit", entry) | ("miss", j); misses: the
    (row, key) of each miss, in order j; memo: the whole stacked (table,
    inf) when the batch memo hit."""

    batch_key: tuple | None
    pk_rows: int
    memo: tuple | None = None
    steps: list = field(default_factory=list)
    misses: list = field(default_factory=list)
    hit_rows: int = 0


class LineTableCache:
    """Per-key line tables on `device` under `budget_bytes` (the
    reference's default: 256 MB)."""

    def __init__(self, device, budget_bytes: int = 256 << 20):
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self.bytes = 0
        self.evictions = 0
        self._lock = threading.Lock()
        self._tables: OrderedDict = OrderedDict()  # key -> (table, inf, nbytes)
        self._memo = None                          # (batch_key, (table, inf))
        self._zero = None                          # (table, inf) of empty rows

    def __len__(self) -> int:
        with self._lock:
            return len(self._tables)

    def resolve(self, rows, keys, bucket: int) -> LinePlan:
        """Host half: claim hits (each moves to the LRU's young end) and
        list the misses, whose pubkey planes alone the caller marshals. A
        pointful row without a key is a miss on every audit."""
        pk_rows = sum(1 for row in rows if row)
        keyed = all(k is not None or not row for row, k in zip(rows, keys))
        plan = LinePlan(batch_key=(tuple(keys), bucket) if keyed else None,
                        pk_rows=pk_rows)
        with self._lock:
            if plan.batch_key is not None and self._memo is not None \
                    and self._memo[0] == plan.batch_key:
                plan.memo = self._memo[1]
                plan.hit_rows = pk_rows
                for row, key in zip(rows, keys):
                    if row and key in self._tables:
                        self._tables.move_to_end(key)
                return plan
            for row, key in zip(rows, keys):
                entry = self._tables.get(key) if row and key is not None \
                    else None
                if not row:
                    plan.steps.append(("zero",))
                elif entry is not None:
                    self._tables.move_to_end(key)
                    plan.steps.append(("hit", entry))
                    plan.hit_rows += 1
                else:
                    plan.steps.append(("miss", len(plan.misses)))
                    plan.misses.append((row, key))
        return plan

    def insert(self, key, table: torch.Tensor, inf: torch.Tensor) -> None:
        """Keep one key's table (88, 3, 2, 25) and infinity flag (), then
        evict from the old end until the budget holds."""
        nbytes = table.numel() * table.element_size() + inf.element_size()
        with self._lock:
            if key in self._tables:
                self._tables.move_to_end(key)
                return
            self._tables[key] = (table, inf, nbytes)
            self.bytes += nbytes
            while self.bytes > self.budget_bytes and self._tables:
                _, old = self._tables.popitem(last=False)
                self.bytes -= old[2]
                self.evictions += 1

    def assemble(self, plan: LinePlan, missed=None):
        """Device half: insert the misses' tables (`missed` = (tables
        (M, 88, 3, 2, 25), inf (M,)) from one precompute over all misses)
        and stack hits, misses and zero rows into the audit's (B, 88, 3,
        2, 25) tables and (B,) flags."""
        if plan.memo is not None:
            return plan.memo
        fresh = []
        if plan.misses:
            tables, infs = missed
            for j, (_, key) in enumerate(plan.misses):
                entry = (tables[j].clone(), infs[j].clone())
                if key is not None:
                    self.insert(key, *entry)
                fresh.append(entry)
        zero = self._zero_row()
        chosen = [zero if step[0] == "zero"
                  else step[1][:2] if step[0] == "hit" else fresh[step[1]]
                  for step in plan.steps]
        out = (torch.stack([t for t, _ in chosen]),
               torch.stack([i for _, i in chosen]))
        if plan.batch_key is not None:
            with self._lock:
                self._memo = (plan.batch_key, out)
        return out

    def _zero_row(self):
        with self._lock:
            if self._zero is None:
                self._zero = (torch.zeros(bn.LINE_TABLE_SHAPE,
                                          dtype=torch.int32,
                                          device=self.device),
                              torch.ones((), dtype=torch.bool,
                                         device=self.device))
            return self._zero
