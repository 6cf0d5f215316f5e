"""Batched collation replay: every shard's transactions applied in order
on the device (BASELINE config 4), `csrc/replay.cu` and its plain PyTorch
version.

The port's counterpart of the JAX package's `ops/replay_jax.py`, with the
same planes, steps and results:

- sender recovery for every transaction of every shard as one batched
  `ops/secp256k1.py::ecrecover_batch`, then pubkey -> address by keccak
  on the device (`pubkeys_to_addresses`);
- each shard's transactions applied in order (`shard_replay`): nonce
  equality, buy gas, intrinsic gas, value transfer, in the TransitionDb
  order of the scalar twin `core/state_processor.py`, with balances as
  32 little-endian 8-bit limbs in int32;
- the final account table committed by keccak on the device
  (`state_root`), byte-identical with `ShardState.root` over the same
  padded table (`scalar_root_with_padding`).

`shard_replay` is the route (`ops/route.py`): `shard_replay_kernel`
(`csrc/replay.cu`, one launch for all shards) for CUDA tensors,
`shard_replay_plain` (the reference's `lax.scan` as a loop over the
transactions, batched over the shards) for CPU tensors and inside
`route.plain_versions()`. The keccaks go through `ops/keccak.py::keccak256`
(`csrc/keccak_fixed.cu` on the card). So on the card `replay_batch` is one
recovery launch, one keccak launch for the addresses, one replay launch
and one keccak launch for the roots, with PyTorch's own ops between.

Shapes: S shards × T transactions × A accounts (host-padded; padding rows
are zero addresses, padding transactions invalid).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.crypto.keccak import keccak256 as host_hash
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops import secp256k1 as secp
from gethsharding_tpu_torch.ops.keccak import keccak256
from gethsharding_tpu_torch.ops.limb import (LIMB_BITS, NLIMBS, const,
                                             ints_to_limbs)
from gethsharding_tpu_torch.utils.hexbytes import Address20, Hash32

KERNEL = _build.Kernel("replay", "gs_replay",
                       "gethsharding_tpu_torch/csrc/replay.cu",
                       "gethsharding_tpu/ops/replay_jax.py:140")
# table rows a shard (replay.cu REPLAY_MAX_ROWS): row indices, A itself
# ("no row") and the kernel's row strides stay inside an int32
MAX_ROWS = 1 << 30

# == uint256 as 32 little-endian 8-bit limbs in int32 ======================


def _carry8(z: torch.Tensor):
    """Exact signed carry over 8-bit limbs: (top carry, canonical limbs);
    `>>` is arithmetic, so a borrow carries as -1."""
    carry = torch.zeros_like(z[..., 0])
    out = []
    for i in range(z.shape[-1]):
        t = z[..., i] + carry
        out.append(t & 0xFF)
        carry = t >> 8
    return carry, torch.stack(out, dim=-1)


def u256_ge(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x >= y on canonical limb tensors (the borrow of x - y)."""
    borrow, _ = _carry8(x - y)
    return borrow >= 0


def u256_mul_u32(x: torch.Tensor, k: torch.Tensor):
    """x · k for non-negative int32 k -> (low 32 limbs, overflowed 2^256).
    k splits into 16-bit halves (the high one of 15 bits), so the limb
    products stay below 2^25."""
    k_lo = (k & 0xFFFF)[..., None]
    k_hi = ((k >> 16) & 0x7FFF)[..., None]
    lo = torch.nn.functional.pad(x * k_lo, (0, 3))
    hi = torch.nn.functional.pad(x * k_hi, (2, 1))   # << 16: two limbs up
    carry, limbs = _carry8(lo + hi)
    overflow = (carry != 0) | (limbs[..., 32:] != 0).any(dim=-1)
    return limbs[..., :32], overflow


# == 12-bit field limbs -> bytes (the address derivation) ==================

_BIT = np.arange(256)
_BIT_LIMB = _BIT // LIMB_BITS
_BIT_OFF = (_BIT % LIMB_BITS).astype(np.int32)
_BYTE_WEIGHTS = (1 << np.arange(8)).astype(np.int32)


def limbs12_to_bytes_be(x: torch.Tensor) -> torch.Tensor:
    """(..., NLIMBS) canonical 12-bit limbs -> (..., 32) uint8 big-endian."""
    dev = x.device
    bits = (x[..., const(_BIT_LIMB, dev)] >> const(_BIT_OFF, dev)) & 1
    by = bits.reshape(bits.shape[:-1] + (32, 8))        # LE byte order
    le = (by * const(_BYTE_WEIGHTS, dev)).sum(dim=-1)
    return le.flip(-1).to(torch.uint8)


def pubkey_bytes(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Recovered pubkey limbs -> (..., 64) uint8 X || Y, big-endian. The
    limbs are canonicalized first, as the reference does for its lazy
    limbs."""
    return torch.cat([limbs12_to_bytes_be(secp.FQ.canon(qx)),
                      limbs12_to_bytes_be(secp.FQ.canon(qy))], dim=-1)


def pubkeys_to_addresses(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Recovered pubkey limbs -> (..., 20) uint8 addresses:
    keccak256(X || Y)[12:], hashed on the device."""
    return keccak256(pubkey_bytes(qx, qy))[..., 12:]


# == replay planes ==========================================================


class ReplayInputs(NamedTuple):
    """Host-marshalled device tensors; leading axis S = shards."""

    # account table (host-sorted ascending by address; fixed rows)
    addrs: torch.Tensor        # (S, A, 20) uint8
    nonces: torch.Tensor       # (S, A) int32
    balances: torch.Tensor     # (S, A, 32) int32, 8-bit limbs little-endian
    table_len: torch.Tensor    # (S,) int32: real rows (the rest padding)
    coinbase_ix: torch.Tensor  # (S,) int32: coinbase row index
    # transactions, in order
    tx_e: torch.Tensor         # (S, T, NLIMBS) sig-hash field limbs
    tx_r: torch.Tensor         # (S, T, NLIMBS)
    tx_s: torch.Tensor         # (S, T, NLIMBS)
    tx_recid: torch.Tensor     # (S, T) int32
    tx_nonce: torch.Tensor     # (S, T) int32
    tx_gas_limit: torch.Tensor  # (S, T) int32
    tx_intrinsic: torch.Tensor  # (S, T) int32: host-counted data gas
    tx_price: torch.Tensor     # (S, T, 32) 8-bit limbs
    tx_value: torch.Tensor     # (S, T, 32)
    tx_to: torch.Tensor        # (S, T, 20) uint8
    tx_valid: torch.Tensor     # (S, T) bool: well-formed, recoverable form


class ReplayOutputs(NamedTuple):
    statuses: torch.Tensor     # (S, T) bool
    gas_used: torch.Tensor     # (S, T) int32
    nonces: torch.Tensor       # (S, A) int32: the final table
    balances: torch.Tensor     # (S, A, 32) int32
    roots: torch.Tensor        # (S, 32) uint8: state commitments


def shard_replay_plain(addrs, nonces, balances, coinbase_ix, senders,
                       sender_ok, tx_nonce, tx_gas_limit, tx_intrinsic,
                       tx_price, tx_value, tx_to, tx_valid):
    """The reference's `_shard_replay` in plain PyTorch: every shard's
    transactions in order, batched over the S shards. Returns (nonces
    (S, A), balances (S, A, 32), statuses (S, T) bool, gas_used (S, T)).
    """
    S, A = nonces.shape
    T = tx_nonce.shape[1]
    ar = torch.arange(S, device=nonces.device)
    # the coinbase index as the reference's scatter takes it: a negative
    # one counts from the end, one still outside the table adds nothing
    cb = torch.where(coinbase_ix < 0, coinbase_ix + A, coinbase_ix).long()
    cb_in = ((cb >= 0) & (cb < A)).to(torch.int32)
    cb = cb.clamp(0, A - 1)
    statuses, gas_used = [], []
    for t in range(T):
        s_match = (addrs == senders[:, t, None]).all(dim=-1)   # (S, A)
        t_match = (addrs == tx_to[:, t, None]).all(dim=-1)
        # the first matching row, or row 0 where none matches
        s_ix = s_match.to(torch.int32).argmax(dim=-1)
        t_ix = t_match.to(torch.int32).argmax(dim=-1)
        price, value = tx_price[:, t], tx_value[:, t]
        gas_limit, intrinsic = tx_gas_limit[:, t], tx_intrinsic[:, t]

        ok = (tx_valid[:, t] & sender_ok[:, t] & s_match.any(dim=-1)
              & t_match.any(dim=-1))
        ok &= nonces[ar, s_ix] == tx_nonce[:, t]
        bal = balances[ar, s_ix]
        gas_cost, over = u256_mul_u32(price, gas_limit)
        # an overflowing cost exceeds any 256-bit balance
        ok &= ~over & u256_ge(bal, gas_cost)
        ok &= intrinsic <= gas_limit
        _, post_buy = _carry8(bal - gas_cost)
        ok &= u256_ge(post_buy, value)
        fee, _ = u256_mul_u32(price, intrinsic)   # <= gas_cost where ok

        # the deltas summed and carried once: the same-row cases
        # (self-transfer, sender or recipient the coinbase) net out as
        # the scalar's updates in turn; credits wrap mod 2^256
        okl = ok.to(torch.int32)
        _, debit = _carry8(fee + value)
        delta = torch.zeros_like(balances)
        delta.index_put_((ar, s_ix), -debit * okl[:, None], accumulate=True)
        delta.index_put_((ar, t_ix), value * okl[:, None], accumulate=True)
        delta.index_put_((ar, cb), fee * (okl * cb_in)[:, None],
                         accumulate=True)
        _, balances = _carry8(balances + delta)
        nonces = nonces.index_put((ar, s_ix), okl, accumulate=True)
        statuses.append(ok)
        gas_used.append(intrinsic * okl)
    if not T:
        return (nonces, balances,
                torch.zeros((S, 0), dtype=torch.bool, device=nonces.device),
                torch.zeros((S, 0), dtype=torch.int32, device=nonces.device))
    return (nonces, balances, torch.stack(statuses, dim=1),
            torch.stack(gas_used, dim=1))


_REPLAY_PLANES = (
    # name, trailing shape (None: the table's A), dtype
    ("addrs", (None, 20), torch.uint8), ("nonces", (None,), torch.int32),
    ("balances", (None, 32), torch.int32), ("coinbase_ix", (), torch.int32),
    ("senders", ("T", 20), torch.uint8), ("sender_ok", ("T",), torch.bool),
    ("tx_nonce", ("T",), torch.int32), ("tx_gas_limit", ("T",), torch.int32),
    ("tx_intrinsic", ("T",), torch.int32),
    ("tx_price", ("T", 32), torch.int32), ("tx_value", ("T", 32), torch.int32),
    ("tx_to", ("T", 20), torch.uint8), ("tx_valid", ("T",), torch.bool))


def shard_replay_kernel(*planes):
    """Launch `csrc/replay.cu` on the 13 planes of `shard_replay_plain`
    as contiguous CUDA tensors (addresses 4-byte aligned, balance, price
    and value rows canonical 8-bit limbs); returns what it returns.
    Raises past the kernel's limit of MAX_ROWS table rows a shard."""
    S, A = planes[1].shape
    T = planes[6].shape[1]
    if not 1 <= A <= MAX_ROWS:
        raise ValueError(f"replay: {A} table rows a shard; the kernel takes "
                         f"1 to {MAX_ROWS}")
    dims = {None: A, "T": T}
    for (name, tail, dtype), t in zip(_REPLAY_PLANES, planes):
        _build.check_tensor(t, (S,) + tuple(dims.get(d, d) for d in tail),
                            name, dtype)
        if dtype == torch.uint8 and t.data_ptr() % 4:
            raise ValueError(f"{name}: the kernel reads 4-byte words; the "
                             f"tensor is not 4-byte aligned")
    dev = planes[0].device
    status = torch.empty((S, T), dtype=torch.bool, device=dev)
    gas_used = torch.empty((S, T), dtype=torch.int32, device=dev)
    nonces = torch.empty((S, A), dtype=torch.int32, device=dev)
    balances = torch.empty((S, A, 32), dtype=torch.int32, device=dev)
    rows = torch.empty((S, T, 2), dtype=torch.int32, device=dev)
    if S:
        KERNEL.launch(*map(_build.ptr, planes), S, T, A,
                      *map(_build.ptr, (status, gas_used, nonces, balances,
                                        rows)))
    return nonces, balances, status, gas_used


def shard_replay(*planes):
    """Every shard's transactions in order: the kernel for CUDA tensors
    (one launch), the plain version for CPU tensors."""
    if route.use_kernel(planes[1]):
        return shard_replay_kernel(*(
            p.to(dtype).contiguous()
            for p, (_, _, dtype) in zip(planes, _REPLAY_PLANES)))
    return shard_replay_plain(*planes)


_NONCE_SHIFTS = np.asarray([24, 16, 8, 0], np.int32)


def state_blob(addrs, nonces, balances) -> torch.Tensor:
    """The committed bytes of each table: the rows addr(20) ||
    nonce_be(8) || balance_be(32), zero padding rows included, as one
    (S, 60·A) uint8 message a shard. The nonce is int32, so the high 4
    of its 8 bytes are zero."""
    S, A = nonces.shape
    lo4 = ((nonces[..., None] >> const(_NONCE_SHIFTS, nonces.device))
           & 0xFF).to(torch.uint8)
    nonce_be = torch.cat([torch.zeros_like(lo4), lo4], dim=-1)
    bal_be = balances.flip(-1).to(torch.uint8)
    return torch.cat([addrs, nonce_be, bal_be], dim=-1).reshape(S, A * 60)


def state_root(addrs, nonces, balances) -> torch.Tensor:
    """keccak256 of each table's `state_blob`: (S, 32) uint8."""
    return keccak256(state_blob(addrs, nonces, balances))


def replay_batch(inp: ReplayInputs) -> ReplayOutputs:
    """The config-4 pipeline: one recovery for all S·T transactions, the
    addresses hashed, every shard's ordered transition, and the state
    commitments. On the card: one launch each of the recovery and the
    replay, two of the keccak, no host sync."""
    s, t = inp.tx_recid.shape
    flat = lambda x: x.reshape((s * t,) + x.shape[2:])
    qx, qy, rec_ok = secp.ecrecover_batch(
        flat(inp.tx_e), flat(inp.tx_r), flat(inp.tx_s), flat(inp.tx_recid),
        flat(inp.tx_valid))
    senders = pubkeys_to_addresses(qx, qy).reshape(s, t, 20)
    nonces, balances, statuses, gas_used = shard_replay(
        inp.addrs, inp.nonces, inp.balances, inp.coinbase_ix, senders,
        rec_ok.reshape(s, t), inp.tx_nonce, inp.tx_gas_limit,
        inp.tx_intrinsic, inp.tx_price, inp.tx_value, inp.tx_to,
        inp.tx_valid)
    return ReplayOutputs(statuses=statuses, gas_used=gas_used, nonces=nonces,
                         balances=balances,
                         roots=state_root(inp.addrs, nonces, balances))


# == host marshal ===========================================================


def _u256_limbs(value: int) -> np.ndarray:
    """The 32 little-endian bytes of value mod 2^256, as int32 limbs."""
    return np.frombuffer((value % (1 << 256)).to_bytes(32, "little"),
                         np.uint8).astype(np.int32)


def build_replay_inputs(
        shard_txs: Sequence[Sequence[Transaction]],
        genesis: Sequence[Dict[Address20, sp.AccountState]],
        coinbases: Sequence[Address20],
        pad_txs: Optional[int] = None, device=None) -> ReplayInputs:
    """Transactions and per-shard genesis accounts -> the replay planes on
    `device` (the card unless 'cpu' is asked for).

    A shard's table is its genesis accounts ∪ every touched address,
    ascending (`state_processor.replay_account_table`, which recovers
    every sender on the host); uneven shards pad with zero account rows
    and invalid transaction rows."""
    dev = resolve_device(device)
    s = len(shard_txs)
    tables: List[List[Address20]] = [
        sp.replay_account_table(txs, gen, coinbase)
        for txs, gen, coinbase in zip(shard_txs, genesis, coinbases)]

    a_max = max(max((len(t) for t in tables), default=1), 1)
    t_max = max(max((len(t) for t in shard_txs), default=1), 1)
    if pad_txs is not None:
        t_max = max(t_max, pad_txs)

    z = np.zeros
    addrs = z((s, a_max, 20), np.uint8)
    nonces = z((s, a_max), np.int32)
    balances = z((s, a_max, 32), np.int32)
    table_len = z(s, np.int32)
    coinbase_ix = z(s, np.int32)
    tx_e = z((s, t_max, NLIMBS), np.int32)
    tx_r = z((s, t_max, NLIMBS), np.int32)
    tx_s = z((s, t_max, NLIMBS), np.int32)
    tx_recid = z((s, t_max), np.int32)
    tx_nonce = z((s, t_max), np.int32)
    tx_gas_limit = z((s, t_max), np.int32)
    tx_intrinsic = z((s, t_max), np.int32)
    tx_price = z((s, t_max, 32), np.int32)
    tx_value = z((s, t_max, 32), np.int32)
    tx_to = z((s, t_max, 20), np.uint8)
    tx_valid = z((s, t_max), bool)

    for i, (txs, gen, coinbase) in enumerate(zip(shard_txs, genesis,
                                                 coinbases)):
        table = tables[i]
        table_len[i] = len(table)
        if table:
            addrs[i, :len(table)] = np.frombuffer(
                b"".join(bytes(a) for a in table), np.uint8).reshape(-1, 20)
        for row, addr in enumerate(table):
            acct = gen.get(addr)
            if acct is not None:
                nonces[i, row] = acct.nonce
                balances[i, row] = _u256_limbs(acct.balance)
            if addr == coinbase:
                coinbase_ix[i] = row
        digests, rs, ss, recs, valids = [], [], [], [], []
        for j, tx in enumerate(txs):
            well_formed = (tx.v in (27, 28) and tx.to is not None
                           and 0 <= tx.nonce < 2 ** 31
                           and 0 <= tx.gas_limit < 2 ** 31
                           and 0 <= tx.gas_price < 2 ** 256
                           and 0 <= tx.value < 2 ** 256)
            digests.append(bytes(tx.sig_hash()))
            rs.append(tx.r % (1 << 256))
            ss.append(tx.s % (1 << 256))
            recs.append((tx.v - 27) & 1)
            valids.append(well_formed)
            if not well_formed:
                continue
            tx_nonce[i, j] = tx.nonce
            tx_gas_limit[i, j] = tx.gas_limit
            tx_intrinsic[i, j] = sp.intrinsic_gas(tx.payload)
            tx_price[i, j] = _u256_limbs(tx.gas_price)
            tx_value[i, j] = _u256_limbs(tx.value)
            tx_to[i, j] = np.frombuffer(bytes(tx.to), np.uint8)
        if txs:
            tx_e[i, :len(txs)] = secp.hashes_to_limbs(digests)
            tx_r[i, :len(txs)] = ints_to_limbs(rs)
            tx_s[i, :len(txs)] = ints_to_limbs(ss)
            tx_recid[i, :len(txs)] = recs
            tx_valid[i, :len(txs)] = valids

    on = lambda a: torch.as_tensor(a, device=dev)
    return ReplayInputs(
        addrs=on(addrs), nonces=on(nonces), balances=on(balances),
        table_len=on(table_len), coinbase_ix=on(coinbase_ix),
        tx_e=on(tx_e), tx_r=on(tx_r), tx_s=on(tx_s), tx_recid=on(tx_recid),
        tx_nonce=on(tx_nonce), tx_gas_limit=on(tx_gas_limit),
        tx_intrinsic=on(tx_intrinsic), tx_price=on(tx_price),
        tx_value=on(tx_value), tx_to=on(tx_to), tx_valid=on(tx_valid))


def canonical_state_roots(inp: ReplayInputs,
                          out: ReplayOutputs) -> List[Hash32]:
    """Host-side canonical secure-MPT roots of the post-replay tables, one
    per shard (`state_processor.state_trie_root`): the root a Go node
    recomputes. Padding rows and emptied accounts drop out."""
    addrs = inp.addrs.cpu().numpy()
    lens = inp.table_len.cpu().numpy()
    nonces = out.nonces.cpu().numpy()
    balances = out.balances.cpu().numpy().astype(np.uint8)
    roots = []
    for s in range(addrs.shape[0]):
        accounts = {}
        for i in range(int(lens[s])):
            nonce = int(nonces[s, i])
            balance = int.from_bytes(bytes(balances[s, i]), "little")
            if nonce or balance:
                accounts[Address20(bytes(addrs[s, i]))] = sp.AccountState(
                    nonce=nonce, balance=balance)
        roots.append(sp.state_trie_root(accounts))
    return roots


def scalar_root_with_padding(state: sp.ShardState, a_total: int) -> Hash32:
    """The scalar twin of the device commitment: the device hashes the
    whole padded table, zero rows included, so the scalar root pads to
    the same width."""
    rows = sorted(state.accounts.items(), key=lambda kv: bytes(kv[0]))
    blob = b"".join(
        bytes(addr) + acct.nonce.to_bytes(8, "big")
        + acct.balance.to_bytes(32, "big")
        for addr, acct in rows)
    blob += b"\x00" * 60 * (a_total - len(rows))
    return Hash32(host_hash(blob))
