"""The port's collation replay (gethsharding_tpu_torch/ops/replay.py,
csrc/replay.cu, csrc/keccak_fixed.cu) and its host copies against the JAX
package's, on the CPU:

1. the host copies: RLP, `Transaction` (encoding, hashes, decoding), the
   trie root and `state_trie_root`, and the scalar state processor
   (receipts, flat and canonical roots, the account table) equal to the
   reference's on the batch of tests/torch_replay_rows.py (every
   rejection class and the hostile rows);
2. `build_replay_inputs` planes equal to the reference's through
   `convert.replay_inputs_from_reference`, and the port's plain
   `replay_batch` equal to the reference's on them: statuses, gas,
   nonces, balances and roots element for element. The fast case holds
   it against the reference's own transition and commitment
   (`jax.vmap(_shard_replay)`, `_state_root`) on the senders the host
   recovers; `-m slow` adds the reference's whole jitted `replay_batch`
   (its recovery ladder compiles for ~1 min). `canonical_state_roots` and
   `scalar_root_with_padding` equal the reference's;
3. the same in the exact 22-limb form, both packages in one fresh
   interpreter with both knobs set (as tests/test_torch_exact.py does);
4. `csrc/replay.cu` and `csrc/keccak_fixed.cu` compiled for the host
   (tests/torch_host_shim.py) against `shard_replay_plain` (on the batch
   and on seeded rows with repeated addresses and sums near 2^256; a
   shard's rows split over blocks and scan chunks, transactions over
   tiles, 140 shards, an unaligned balance table, rows named again and
   again) and `keccak256_fixed` (both routes and the kernel's threshold,
   at the block edges, the threshold ±1 and 245,760 bytes; unaligned
   rows);
5. the observer's fold-back (`actors/observer.py::replay_on_device`) over
   tests/test_replay.py's three collations ends at the roots of the
   reference `Observer(replay_engine="python")` each period (period 1 in
   the fast tier, all three in `-m slow`).

The port's plain recovery runs once for the module, over the batch and the
observer's first collation together (`shared_recovery`).

Everything is bytes and integers, so every comparison is exact."""

import ctypes
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_host_shim
import torch_replay_rows
from gethsharding_tpu.core import state_processor as rsp
from gethsharding_tpu.core.trie import Trie as RTrie
from gethsharding_tpu.core.types import Transaction as RTransaction
from gethsharding_tpu.crypto import secp256k1 as rsecp
from gethsharding_tpu.ops import replay_jax
from gethsharding_tpu.utils import rlp as rrlp
from gethsharding_tpu.utils.hexbytes import Address20 as RAddress20
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.actors.observer import replay_on_device
from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.trie import Trie
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.crypto.keccak import keccak256 as host_keccak
from gethsharding_tpu_torch.ops import keccak, replay
from gethsharding_tpu_torch.ops import secp256k1 as secp
from gethsharding_tpu_torch.utils import rlp
from gethsharding_tpu_torch.utils.hexbytes import Address20

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
OUTPUTS = ("statuses", "gas_used", "nonces", "balances", "roots")


@pytest.fixture(scope="module")
def ref_batch():
    return torch_replay_rows.batch(rsp, RTransaction, rsecp, RAddress20)


@pytest.fixture(scope="module")
def port_batch():
    return torch_replay_rows.batch(sp, Transaction, ecdsa, Address20)


# == 1. the host copies =======================================================


def test_rlp_equals_reference():
    items = [b"", b"\x00", b"\x7f", b"\x80", b"x" * 55, b"y" * 56,
             b"z" * 1024, [], [b"", [b"a", [b"b" * 60]]], 0, 1, 127, 128,
             2 ** 64, 2 ** 256 - 1, True, False, None, "text",
             [[b"c" * 40] * 3]]
    for item in items:
        encoded = rlp.rlp_encode(item)
        assert encoded == rrlp.rlp_encode(item), item
        assert rlp.rlp_decode(encoded) == rrlp.rlp_decode(encoded)
    for bad in (b"", b"\x81\x05", b"\xb8\x05hello", b"\xc1", b"\x80\x00",
                b"\xb9\x00\x40" + b"a" * 64):
        with pytest.raises(rrlp.DecodingError):
            rrlp.rlp_decode(bad)
        with pytest.raises(rlp.DecodingError):
            rlp.rlp_decode(bad)


def test_transactions_equal_reference(ref_batch, port_batch):
    for rtxs, ptxs in zip(ref_batch[0], port_batch[0]):
        for rt, pt in zip(rtxs, ptxs):
            assert pt.encode_rlp() == rt.encode_rlp()
            assert bytes(pt.hash()) == bytes(rt.hash())
            assert bytes(pt.sig_hash()) == bytes(rt.sig_hash())
            assert bytes(pt.sig_hash(chain_id=5)) == \
                bytes(rt.sig_hash(chain_id=5))
            assert Transaction.decode_rlp(pt.encode_rlp()) == pt
    with pytest.raises(rlp.DecodingError):
        Transaction.decode_rlp(rlp.rlp_encode([b""] * 8))
    with pytest.raises(rlp.DecodingError):
        Transaction.decode_rlp(rlp.rlp_encode([b""] * 3 + [b"ab"]
                                              + [b""] * 5))


def test_trie_root_equals_reference():
    rng = random.Random(9)
    for n in (0, 1, 2, 3, 17, 200):
        ref, port = RTrie(), Trie()
        keys = [bytes(rng.randrange(256) for _ in range(rng.choice(
            (1, 2, 32)))) for _ in range(n)]
        keys += [k + b"\x01" for k in keys[:3]]       # shared prefixes
        for key in keys:
            value = bytes(rng.randrange(256) for _ in range(
                rng.choice((1, 5, 40))))
            ref.update(key, value)
            port.update(key, value)
        assert port.root_hash() == ref.root_hash()
    with pytest.raises(ValueError):
        Trie().update(b"k", b"")


def _states(mod, batch):
    """Each shard's state after the scalar replay, with every table row
    made (the device commits to the whole table), and the receipts."""
    out = []
    for txs, gen, coin in zip(*batch):
        state = mod.ShardState({a: mod.AccountState(v.nonce, v.balance)
                                for a, v in gen.items()})
        for addr in mod.replay_account_table(txs, state.accounts, coin):
            state.get(addr)
        out.append((state, mod.process(state, txs, coin)))
    return out


@pytest.fixture(scope="module")
def ref_states(ref_batch):
    return _states(rsp, ref_batch)


@pytest.fixture(scope="module")
def port_states(port_batch):
    return _states(sp, port_batch)


def test_scalar_replay_equals_reference(ref_batch, port_batch, ref_states,
                                        port_states):
    for (rs, rr), (ps, pr), want in zip(ref_states, port_states,
                                        torch_replay_rows.STATUSES):
        assert [r.status == 1 for r in pr] == want
        assert [(r.status, r.gas_used, r.sender) for r in pr] == \
            [(r.status, r.gas_used, r.sender) for r in rr]
        assert bytes(ps.root()) == bytes(rs.root())
        assert bytes(ps.trie_root()) == bytes(rs.trie_root())
    for (rtxs, _, coin), ptxs in zip(zip(*ref_batch), port_batch[0]):
        assert [bytes(a) for a in sp.touched_addresses(ptxs, coin)] == \
            [bytes(a) for a in rsp.touched_addresses(rtxs, coin)]
        for rt, pt in zip(rtxs, ptxs):
            assert sp.intrinsic_gas(pt.payload) == \
                rsp.intrinsic_gas(rt.payload)


# == 2. the batched replay ====================================================


@pytest.fixture(scope="module")
def ref_inputs(ref_batch):
    return replay_jax.build_replay_inputs(*ref_batch)


def _recovery_rows(inp):
    """The five planes `replay_batch` hands `ecrecover_batch`, a row a
    transaction."""
    s, t = inp.tx_recid.shape
    return [x.reshape((s * t,) + x.shape[2:]) for x in (
        inp.tx_e, inp.tx_r, inp.tx_s, inp.tx_recid, inp.tx_valid)]


def _row_keys(planes):
    return [b"".join(p[i].numpy().tobytes() for p in planes)
            for i in range(planes[0].shape[0])]


@pytest.fixture(scope="module")
def shared_recovery(port_batch):
    """The port's plain recovery, run once for the module. Its ladder
    takes ~12 s on the CPU whatever the number of rows, so the batch's
    transactions and the observer's first collation go through one
    `ecrecover_batch` call; from then on `ecrecover_batch` answers a call
    whose rows are all among them from that result (each row's result
    depends on that row alone), and any other call as before."""
    cols, _, proposer, _ = _collations()
    txs, genesis, coinbases = port_batch
    inp = replay.build_replay_inputs(
        list(txs) + [[_port_tx(t) for t in cols[1]]], list(genesis) + [{}],
        list(coinbases) + [Address20(bytes(proposer))], device="cpu")
    real = secp.ecrecover_batch
    rows = _recovery_rows(inp)
    answers = dict(zip(_row_keys(rows), zip(*real(*rows))))

    def recover(*planes):
        keys = _row_keys(planes) if planes[0].dim() == 2 else []
        if not keys or any(k not in answers for k in keys):
            return real(*planes)
        return tuple(torch.stack([answers[k][i] for k in keys])
                     for i in range(3))

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(secp, "ecrecover_batch", recover)
        yield


@pytest.fixture(scope="module")
def port_run(port_batch, shared_recovery):
    inp = replay.build_replay_inputs(*port_batch, device="cpu")
    return inp, replay.replay_batch(inp)


def _host_senders(batch, rin):
    """(S, T, 20) senders and (S, T) sender_ok as the host recovers them:
    what the reference's device recovery gives its transition."""
    valid = np.asarray(rin.tx_valid)
    senders = np.zeros(valid.shape + (20,), np.uint8)
    ok = np.zeros(valid.shape, bool)
    for s, txs in enumerate(batch[0]):
        for j, tx in enumerate(txs):
            addr = rsp.recover_sender(tx)
            if addr is not None:
                senders[s, j] = np.frombuffer(bytes(addr), np.uint8)
                ok[s, j] = valid[s, j]
    return senders, ok


@pytest.fixture(scope="module")
def ref_outputs(ref_batch, ref_inputs):
    """The reference's transition (vmapped over the shards) and state
    commitment on the host's senders."""
    rin = ref_inputs
    senders, ok = _host_senders(ref_batch, rin)
    nonces, balances, statuses, gas = jax.jit(jax.vmap(
        replay_jax._shard_replay))(
        rin.addrs, rin.nonces, rin.balances, rin.coinbase_ix,
        jnp.asarray(senders), jnp.asarray(ok), rin.tx_nonce,
        rin.tx_gas_limit, rin.tx_intrinsic, rin.tx_price, rin.tx_value,
        rin.tx_to, rin.tx_valid)
    roots = jax.jit(replay_jax._state_root)(rin.addrs, nonces, balances)
    return replay_jax.ReplayOutputs(statuses=statuses, gas_used=gas,
                                    nonces=nonces, balances=balances,
                                    roots=roots)


def test_replay_planes_equal_reference(ref_inputs, port_run):
    got = port_run[0]
    want = convert.replay_inputs_from_reference(ref_inputs, device="cpu")
    for name in replay.ReplayInputs._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_replay_batch_equals_reference(ref_outputs, port_run):
    out = port_run[1]
    for name in OUTPUTS:
        assert (getattr(out, name).numpy()
                == np.asarray(getattr(ref_outputs, name))).all(), name
    want = [s + [False] * (out.statuses.shape[1] - len(s))
            for s in torch_replay_rows.STATUSES]
    assert out.statuses.tolist() == want


@pytest.mark.slow
def test_replay_batch_equals_reference_whole(ref_inputs, port_run):
    """The reference's whole jitted `replay_batch` (its recovery ladder
    and address keccak included) on the same planes."""
    want = replay_jax.replay_batch(ref_inputs)
    for name in OUTPUTS:
        assert (getattr(port_run[1], name).numpy()
                == np.asarray(getattr(want, name))).all(), name


def test_roots_equal_reference(ref_inputs, ref_outputs, port_run,
                               ref_states, port_states):
    inp, out = port_run
    assert [bytes(r) for r in replay.canonical_state_roots(inp, out)] == \
        [bytes(r) for r in replay_jax.canonical_state_roots(ref_inputs,
                                                            ref_outputs)]
    a_total = inp.addrs.shape[1]
    for i, ((rs, _), (ps, _)) in enumerate(zip(ref_states, port_states)):
        root = replay.scalar_root_with_padding(ps, a_total)
        assert bytes(root) == bytes(
            replay_jax.scalar_root_with_padding(rs, a_total))
        assert bytes(root) == bytes(out.roots[i].numpy()), i
        assert bytes(replay.canonical_state_roots(inp, out)[i]) == \
            bytes(ps.trie_root()), i


def test_replay_kernel_refusals(port_run):
    inp = port_run[0]
    senders = torch.zeros(inp.tx_to.shape, dtype=torch.uint8)
    planes = [inp.addrs, inp.nonces, inp.balances, inp.coinbase_ix, senders,
              inp.tx_valid, inp.tx_nonce, inp.tx_gas_limit,
              inp.tx_intrinsic, inp.tx_price, inp.tx_value, inp.tx_to,
              inp.tx_valid]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        replay.shard_replay_kernel(*planes)
    huge = list(planes)
    huge[1] = torch.zeros(1, 1, dtype=torch.int32).expand(
        inp.nonces.shape[0], replay.MAX_ROWS + 1)
    with pytest.raises(ValueError, match=str(replay.MAX_ROWS)):
        replay.shard_replay_kernel(*huge)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        keccak.keccak_fixed_kernel(torch.zeros(2, 64, dtype=torch.uint8))


# == 3. the exact 22-limb form ================================================

_EXACT_SCRIPT = r'''
import json, sys
import numpy as np, jax, jax.numpy as jnp, torch
sys.path.insert(0, "tests")
import torch_replay_rows
from gethsharding_tpu.core import state_processor as rsp
from gethsharding_tpu.core.types import Transaction as RTransaction
from gethsharding_tpu.crypto import secp256k1 as rsecp
from gethsharding_tpu.ops import limb as rlimb, replay_jax
from gethsharding_tpu.utils.hexbytes import Address20 as RAddress20
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.core import state_processor as sp
from gethsharding_tpu_torch.core.types import Transaction
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.ops import limb, replay
from gethsharding_tpu_torch.utils.hexbytes import Address20
import test_torch_replay as t

torch.set_num_threads(2)
assert limb.NLIMBS == rlimb.NLIMBS == 22
ref_batch = torch_replay_rows.batch(rsp, RTransaction, rsecp, RAddress20)
port_batch = torch_replay_rows.batch(sp, Transaction, ecdsa, Address20)
rin = replay_jax.build_replay_inputs(*ref_batch)
inp = replay.build_replay_inputs(*port_batch, device="cpu")
out = replay.replay_batch(inp)
want = t.ref_outputs.__wrapped__(ref_batch, rin)
planes = convert.replay_inputs_from_reference(rin, device="cpu")
bad = [n for n in replay.ReplayInputs._fields
       if not torch.equal(getattr(inp, n), getattr(planes, n))]
bad += [n for n in t.OUTPUTS
        if not (getattr(out, n).numpy() == np.asarray(getattr(want, n))).all()]
print("RESULTS " + json.dumps({"width": int(inp.tx_e.shape[-1]),
                               "mismatched": bad}))
'''


@pytest.fixture(scope="module", autouse=True)
def exact_run():
    """The exact form's checks in a fresh interpreter, started with the
    module so that they run beside its other tests."""
    env = dict(os.environ, GETHSHARDING_TORCH_LIMB_FORM="exact",
               GETHSHARDING_TPU_LIMB_FORM="exact", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _EXACT_SCRIPT], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# == 4. the kernels' sources under the host shim ==============================

# A block is one thread under the shim, so either route takes a block a
# message: the warp route's 25 lanes run in turn in that thread. `run`
# launches the kernel (its route on the length); `run_route` runs one
# route's sponge on every row, whatever the length (warp: 1 or 0).
_KECCAK_RUNNER = r"""
extern "C" void run(const unsigned char* data, long long n, long long len,
                    unsigned char* out) {
  for (long long b = 0; b < n; ++b) {
    blockIdx.x = (unsigned)b;
    gs::keccak_fixed_kernel(data, n, len, out);
  }
}
extern "C" void run_route(const unsigned char* data, long long n,
                          long long len, unsigned char* out, int warp) {
  gs::u64 sa[32], sb[32];
  for (long long r = 0; r < n; ++r) {
    if (warp)
      gs::sponge_warp<gs::KF_WARP_UNROLL>(data + r * len, len, out + r * 32,
                                          sa, sb, 0);
    else
      gs::sponge_thread(data + r * len, len, out + r * 32);
  }
}"""

# Blocks s·G + g in order: the last of a shard's G runs its chain.
_REPLAY_RUNNER = r"""
extern "C" void run(const unsigned char* addrs, const int* nonces,
                    const int* balances, const int* coinbase,
                    const unsigned char* senders,
                    const unsigned char* sender_ok, const int* tx_nonce,
                    const int* tx_gas_limit, const int* tx_intrinsic,
                    const int* tx_price, const int* tx_value,
                    const unsigned char* tx_to, const unsigned char* tx_valid,
                    int S, int T, int A, int G, unsigned char* status,
                    int* gas_used, int* nonces_out, int* balances_out,
                    int* part, int* counter) {
  for (int b = 0; b < S * G; ++b) {
    blockIdx.x = (unsigned)b;
    gs::replay_kernel(addrs, nonces, balances, coinbase, senders, sender_ok,
                      tx_nonce, tx_gas_limit, tx_intrinsic, tx_price,
                      tx_value, tx_to, tx_valid, T, A, G, status, gas_used,
                      nonces_out, balances_out, part, counter);
  }
}"""


@pytest.fixture(scope="module")
def host_keccak_kernel(tmp_path_factory):
    return torch_host_shim.build(tmp_path_factory.mktemp("keccak_fixed"),
                                 "keccak_fixed.cu", _KECCAK_RUNNER)


@pytest.fixture(scope="module")
def host_replay_kernel(tmp_path_factory):
    return torch_host_shim.build(tmp_path_factory.mktemp("replay"),
                                 "replay.cu", _REPLAY_RUNNER)


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


# the kernel (its route on the length), then each route's sponge on its own
_ROUTES = (None, "thread", "warp")


def _keccak_on_host(lib, data, route):
    n, length = data.shape
    out = np.full((n, 32), 0xAA, np.uint8)
    if route is None:
        lib.run(_ptr(data), n, length, _ptr(out))
    else:
        lib.run_route(_ptr(data), n, length, _ptr(out), route == "warp")
    return out


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 271, 272, 2_720,
                                    245_760])
def test_keccak_fixed_source_on_host_equals_plain(host_keccak_kernel, length):
    """The kernel and each route's sponge at the block edges (135-137:
    the warp route's threshold -1/0/+1) and the root's length; 3 rows,
    and 1 row at 272 and 2,720 bytes."""
    n = 1 if length in (272, 2_720) else 3
    data = np.random.default_rng(length).integers(
        0, 256, (n, length), dtype=np.uint8)
    want = keccak.keccak256_fixed(torch.as_tensor(data)).numpy()
    assert [bytes(o) for o in want] == [host_keccak(bytes(m)) for m in data]
    for route in _ROUTES:
        got = _keccak_on_host(host_keccak_kernel, data, route)
        assert (got == want).all(), route


def test_keccak_fixed_source_on_host_unaligned_rows(host_keccak_kernel):
    """Rows of 300 and 67 bytes: every row but the first starts off an
    8-byte boundary, so full blocks go in byte by byte, on both routes."""
    for length in (300, 67):
        buf = np.random.default_rng(3).integers(0, 256, 1 + 4 * length,
                                                dtype=np.uint8)
        data = buf[1:].reshape(4, length)
        want = [host_keccak(bytes(m)) for m in data]
        for route in _ROUTES:
            got = _keccak_on_host(host_keccak_kernel, data, route)
            assert [bytes(o) for o in got] == want, (length, route)


def test_keccak_routes_on_the_cpu():
    data = torch.as_tensor(np.random.default_rng(4).integers(
        0, 256, (2, 3, 96), dtype=np.uint8))
    assert torch.equal(keccak.keccak256(data), keccak.keccak256_fixed(data))
    assert keccak.permutations(3, 135) == 3
    assert keccak.permutations(1, 136) == 2
    assert keccak.permutations(1, 245_760) == 1808


def _replay_on_host(lib, planes, blocks=None):
    """The kernel's outputs on numpy planes (the 13 of
    `shard_replay_plain`), `blocks` a shard (default the launcher's
    `split_blocks`); every output is written. One block a shard gets no
    scratch (null `part` and counter), as the launcher passes it."""
    planes = [np.ascontiguousarray(p) for p in planes]
    S, A = planes[1].shape
    T = planes[6].shape[1]
    G = replay.split_blocks(S, A) if blocks is None else blocks
    status = np.full((S, T), 0xAA, np.uint8)
    gas = np.full((S, T), -7, np.int32)
    nonces = np.full((S, A), -7, np.int32)
    balances = np.full((S, A, 32), -7, np.int32)
    part = np.full((S, G, max(T, 1), 2), -7, np.int32)
    counter = np.zeros(S, np.int32)
    scratch = (part, counter) if G > 1 else ()
    lib.run(*map(_ptr, planes), S, T, A, G,
            *map(_ptr, (status, gas, nonces, balances, *scratch)),
            *([None, None] if G == 1 else []))
    assert set(status.ravel().tolist()) <= {0, 1}
    if G > 1 and T:
        assert (counter == G).all()
    return nonces, balances, status.astype(bool), gas


def _assert_replay_on_host(lib, planes, blocks=(None,)):
    """The kernel at each of `blocks` a shard against the plain version
    (run once); returns the plain statuses."""
    want = replay.shard_replay_plain(*map(torch.as_tensor, planes))
    for G in blocks:
        got = _replay_on_host(lib, planes, G)
        for name, g, w in zip(("nonces", "balances", "statuses",
                               "gas_used"), got, want):
            assert (g == w.numpy()).all(), (G, name)
    return want[2]


def test_replay_source_on_host_equals_plain(host_replay_kernel, ref_batch,
                                            port_run):
    inp = port_run[0]
    senders, ok = _host_senders(ref_batch, inp)
    planes = [inp.addrs, inp.nonces, inp.balances, inp.coinbase_ix, senders,
              ok, inp.tx_nonce, inp.tx_gas_limit, inp.tx_intrinsic,
              inp.tx_price, inp.tx_value, inp.tx_to, inp.tx_valid]
    planes = [np.asarray(p) for p in planes]
    _assert_replay_on_host(host_replay_kernel, planes, (None, 2))
    assert _replay_on_host(host_replay_kernel, planes)[2].tolist() == \
        port_run[1].statuses.tolist()


@pytest.mark.parametrize("seed,S,T,A", [(1, 4, 9, 6), (2, 3, 40, 3),
                                        (3, 2, 5, 300), (4, 1, 0, 4)])
def test_replay_source_on_host_seeded_rows(host_replay_kernel, seed, S, T,
                                           A):
    planes = torch_replay_rows.seeded_planes(seed, S, T, A)
    statuses = _assert_replay_on_host(host_replay_kernel, planes)
    if T:
        assert statuses.any() and not statuses.all()


@pytest.mark.parametrize("seed,S,T,A,blocks",
                         torch_replay_rows.SPLIT_CASES)
def test_replay_source_on_host_split_and_tiles(host_replay_kernel, seed, S,
                                               T, A, blocks):
    """A shard's table over several blocks, transactions over several
    tiles, more shards than the card's SMs (blocks: a shard's, and the
    launcher's `split_blocks`)."""
    planes = torch_replay_rows.seeded_planes(seed, S, T, A)
    _assert_replay_on_host(host_replay_kernel, planes, (blocks, None))


def test_replay_source_on_host_unaligned_tables(host_replay_kernel):
    """Balance tables off a 16-byte boundary: the table copy takes its
    4-byte path."""
    planes = torch_replay_rows.seeded_planes(1, 4, 9, 6)
    buf = np.zeros(planes[2].size + 1, np.int32)
    planes[2] = buf[1:].reshape(planes[2].shape)
    planes[2][...] = torch_replay_rows.seeded_planes(1, 4, 9, 6)[2]
    assert planes[2].ctypes.data % 16
    _assert_replay_on_host(host_replay_kernel, planes)


@pytest.mark.parametrize("kind", torch_replay_rows.SAME_ROW_KINDS)
def test_replay_source_on_host_same_rows(host_replay_kernel, kind):
    """Transactions that name the same rows again and again: one row as
    sender, recipient and coinbase at once, and many transfers between
    the same two rows, over two tiles, on one block and on two."""
    planes = torch_replay_rows.same_row_planes(kind)
    statuses = _assert_replay_on_host(host_replay_kernel, planes, (None, 2))
    assert 1 < int(statuses.sum()) < statuses.numel()


# == 5. the observer's fold-back ==============================================


def _collations():
    """tests/test_replay.py's three collations (reference types): two
    transfers and a wrong nonce, a payment with a 40-byte payload, and a
    period whose only transaction is rejected."""
    from gethsharding_tpu.crypto.keccak import keccak256

    priv_a, priv_b = 0xAAA1, 0xBBB2
    a = rsecp.priv_to_address(priv_a)
    b = rsecp.priv_to_address(priv_b)
    proposer = rsecp.priv_to_address(0xCCC3)
    fresh = rsecp.priv_to_address(0xFFF7)
    signed = lambda priv, **kw: rsp.sign_transaction(RTransaction(**kw), priv)
    cols = {
        1: [signed(priv_a, nonce=0, gas_price=3, gas_limit=25000, to=b,
                   value=500, payload=b"one"),
            signed(priv_b, nonce=0, gas_price=1, gas_limit=25000, to=a,
                   value=9, payload=b""),
            signed(priv_b, nonce=7, gas_price=1, gas_limit=25000, to=a,
                   value=9, payload=b"")],
        2: [signed(priv_a, nonce=1, gas_price=2, gas_limit=30000, to=b,
                   value=1, payload=b"x" * 40)],
        3: [signed(priv_b, nonce=42, gas_price=1, gas_limit=25000,
                   to=fresh, value=1, payload=b"")],
    }
    genesis = {a: rsp.AccountState(balance=10**12),
               b: rsp.AccountState(balance=10**9)}
    return cols, genesis, proposer, keccak256


def _port_tx(tx) -> Transaction:
    return Transaction(
        nonce=tx.nonce, gas_price=tx.gas_price, gas_limit=tx.gas_limit,
        to=None if tx.to is None else Address20(bytes(tx.to)),
        value=tx.value, payload=tx.payload, v=tx.v, r=tx.r, s=tx.s)


def _check_fold_back(periods):
    from gethsharding_tpu.actors.observer import Observer
    from gethsharding_tpu.core.shard import Shard
    from gethsharding_tpu.core.types import Collation, CollationHeader
    from gethsharding_tpu.db.kv import MemoryKV
    from gethsharding_tpu.mainchain.client import SMCClient
    from gethsharding_tpu.smc.chain import SimulatedMainchain
    from gethsharding_tpu.utils.hexbytes import Hash32

    cols, genesis, proposer, keccak256 = _collations()
    observer = Observer(client=SMCClient(backend=SimulatedMainchain()),
                        shard=Shard(shard_id=0, shard_db=MemoryKV()),
                        replay_engine="python", genesis=genesis)
    state = sp.ShardState({Address20(bytes(k)): sp.AccountState(
        v.nonce, v.balance) for k, v in genesis.items()})
    coinbase = Address20(bytes(proposer))
    for period in periods:
        header = CollationHeader(
            shard_id=0, chunk_root=Hash32(keccak256(b"r%d" % period)),
            period=period, proposer_address=proposer)
        canonical = observer.replay_collation(
            period, Collation(header=header, transactions=cols[period]))
        applied = replay_on_device(state, [_port_tx(t) for t in cols[period]],
                                   coinbase, device="cpu")
        assert applied == {1: 2, 2: 1, 3: 0}[period]
        assert bytes(state.root()) == bytes(observer.state_roots[period])
        assert bytes(state.trie_root()) == bytes(canonical)


def test_observer_fold_back_equals_python_engine(shared_recovery):
    _check_fold_back([1])


@pytest.mark.slow
def test_observer_fold_back_equals_python_engine_three_periods():
    _check_fold_back([1, 2, 3])


# the exact form's result is read last, so that its interpreter runs beside
# every other test of the module
def test_exact_form_replay_equals_reference(exact_run):
    stdout, stderr = exact_run.communicate(timeout=600)
    lines = [line for line in stdout.splitlines()
             if line.startswith("RESULTS ")]
    assert exact_run.returncode == 0 and lines, stderr[-3000:]
    assert json.loads(lines[-1][len("RESULTS "):]) == {"width": 22,
                                                       "mismatched": []}
