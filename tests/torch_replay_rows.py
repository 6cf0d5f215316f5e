"""Replay batches with known outcomes for the port's replay tests, built
with either package's types (the same seeds, so the same transactions):
`batch(sp, Transaction, ecdsa, Address20)` with the JAX package's
`core.state_processor`, `core.types.Transaction`, `crypto.secp256k1` and
`utils.hexbytes.Address20`, or the port's. Imports neither package.

The batch: tests/test_replay.py's three shards (success and every
rejection class: a wrong nonce, a short balance, intrinsic gas above the
limit, a self-transfer, a bad signature, a payment to the coinbase, and an
empty shard), then two hostile shards:

- shard 3, whose coinbase is the sender: a transfer (the fee nets out), a
  payment to the zero address (the zero account is in the table and sorts
  first), a payment to an account at 2^256 - 1 (its balance wraps), v =
  29, to = None, a value of 2^256, a nonce of 2^31, gas prices of 2^255
  and 2^256 - 1 (the cost overflows 2^256), and a self-transfer;
- shard 4: a two-row table (so the shards pad to unequal tables), a
  payment to the coinbase from a fresh account.
"""

import numpy as np

ETH = 10 ** 18
ZERO = bytes(20)
TOP = (1 << 256) - 1


def batch(sp, Transaction, ecdsa, Address20):
    """(shard_txs, genesis, coinbases) of the five shards above."""

    def key(seed: int):
        priv = (seed * 7919 + 13) % ecdsa.N or 1
        return priv, Address20(ecdsa.priv_to_address(priv))

    def tx(priv, nonce, to, value=0, price=1, limit=25000, payload=b""):
        return sp.sign_transaction(
            Transaction(nonce=nonce, gas_price=price, gas_limit=limit, to=to,
                        value=value, payload=payload), priv)

    def resigned(t, **fields):
        body = dict(nonce=t.nonce, gas_price=t.gas_price,
                    gas_limit=t.gas_limit, to=t.to, value=t.value,
                    payload=t.payload, v=t.v, r=t.r, s=t.s)
        body.update(fields)
        return Transaction(**body)

    (pa, a), (pb, b), (pc, c), (pd, d), (pe, e), (_, coin) = [
        key(i) for i in range(1, 7)]
    shard0 = [
        tx(pa, 0, b, value=5 * ETH, payload=b"\x00\x01hello"),   # ok
        tx(pb, 0, c, value=1 * ETH),                             # ok
        tx(pa, 5, b, value=1),               # wrong nonce
        tx(pc, 0, a, value=100 * ETH),       # short balance
        tx(pd, 0, a, value=0, limit=100),    # intrinsic gas > limit
        tx(pa, 1, a, value=2 * ETH),         # self-transfer, ok
    ]
    bad = tx(pe, 0, a, value=1)
    shard1 = [
        resigned(bad, s=(bad.s + 1) % ecdsa.N),     # another signer
        tx(pe, 0, coin, value=3 * ETH),             # pays the coinbase, ok
        tx(pe, 1, b, value=1 * ETH, price=2, payload=b"\x00" * 10),  # ok
    ]
    shard2 = []

    (pf, f), (_, g), (_, w), (pk, k), (_, coin4) = [
        key(i) for i in range(11, 16)]
    zero = Address20(ZERO)
    shard3 = [
        tx(pf, 0, g, value=1),                       # sender = coinbase, ok
        tx(pf, 1, zero, value=3),                    # to the zero row, ok
        tx(pf, 2, w, value=5),                       # wraps w, ok
        resigned(tx(pf, 3, g, value=1), v=29),       # v = 29
        tx(pf, 3, None, value=1),                    # to = None
        tx(pf, 3, g, value=1 << 256),                # value >= 2^256
        tx(pf, 1 << 31, g, value=1),                 # nonce 2^31
        tx(pf, 3, g, value=1, price=1 << 255),       # the cost overflows
        tx(pf, 3, g, value=1, price=TOP),            # the cost overflows
        tx(pf, 3, f, value=7, price=3, payload=b"\x01\x00"),  # self, ok
    ]
    shard4 = [tx(pk, 0, coin4, value=2, price=5)]   # pays the coinbase, ok

    genesis = [
        {a: sp.AccountState(balance=10 * ETH),
         b: sp.AccountState(balance=2 * ETH),
         c: sp.AccountState(balance=1 * ETH),
         d: sp.AccountState(balance=1 * ETH)},
        {e: sp.AccountState(balance=8 * ETH)},
        {a: sp.AccountState(balance=1 * ETH)},
        {f: sp.AccountState(balance=10 * ETH), zero: sp.AccountState(
            balance=7), w: sp.AccountState(nonce=4, balance=TOP - 2)},
        {k: sp.AccountState(balance=1 * ETH)},
    ]
    coinbases = [coin, coin, coin, f, coin4]
    return [shard0, shard1, shard2, shard3, shard4], genesis, coinbases


# the statuses the scalar replay gives the batch, shard by shard
STATUSES = [
    [True, True, False, False, False, True],
    [False, True, True],
    [],
    [True, True, True, False, False, False, False, False, False, True],
    [True],
]


def seeded_planes(seed: int, S: int, T: int, A: int):
    """The 13 planes of `ops/replay.py::shard_replay_plain` as numpy
    arrays, on rows where addresses repeat (a few byte values), so first
    matches, self-transfers and the coinbase as sender or recipient are
    common;
    balances near 2^256 and gas prices with high limbs (overflows);
    negative and out-of-table coinbase indices; invalid and unrecovered
    transactions."""
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 2, (S, A, 20)).astype(np.uint8)
    addrs[:, :, :18] = 0
    nonces = rng.integers(0, 3, (S, A)).astype(np.int32)
    balances = rng.integers(0, 256, (S, A, 32)).astype(np.int32)
    balances[:, :, 12:31] = rng.choice([0, 255], (S, A, 19))
    cb = rng.integers(-A - 1, A + 1, S).astype(np.int32)
    pick = lambda: addrs[np.arange(S)[:, None], rng.integers(0, A, (S, T))]
    price = np.zeros((S, T, 32), np.int32)
    price[:, :, 0] = rng.integers(0, 4, (S, T))
    price[:, :, 31] = np.where(rng.random((S, T)) < 0.15, 128, 0)
    value = rng.integers(0, 256, (S, T, 32)).astype(np.int32)
    value[:, :, 4:31] = 0
    value[:, :, 31] = np.where(rng.random((S, T)) < 0.1, 255, 0)
    return [addrs, nonces, balances, cb, pick(), rng.random((S, T)) < 0.9,
            rng.integers(0, 3, (S, T)).astype(np.int32),
            rng.integers(20_000, 40_000, (S, T)).astype(np.int32),
            rng.integers(21_000, 30_000, (S, T)).astype(np.int32),
            price, value, pick(), rng.random((S, T)) < 0.9]
