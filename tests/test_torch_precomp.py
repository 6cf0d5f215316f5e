"""The port's precomp audit path (`TorchSigBackend` with `pk_row_keys`,
`sigbackend/cache.py`) against the JAX package's scalar `python`
backend, on the CPU through the plain versions of the kernels:

- cold and warm verdicts on valid, forged, missing-signature, empty,
  swapped and cancelling rows;
- a warm audit ships 0 G2 bytes and hits every non-empty row;
- a keyless audit keeps the recompute path, and a short key list leaves
  the trailing rows uncached;
- eviction churn under a tiny budget keeps every verdict;
- a line table made by the reference crosses into the port's cache.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.crypto import bn256 as ref
from gethsharding_tpu.ops import bn256_jax as k
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.sigbackend import marshal
from gethsharding_tpu_torch.sigbackend.cache import LineTableCache
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend


@pytest.fixture(scope="module")
def period():
    """6 rows × 3 votes: valid, a forged vote, an empty committee, a
    message swapped for another shard's, a missing signature whose
    pubkey is kept, and a committee whose votes and pubkeys cancel (its
    pairing is 1; only the identity check rejects it)."""
    keys = [ref.bls_keygen(b"precomp-port-%d" % j) for j in range(3)]
    msgs = [b"precomp-header-%d" % s for s in range(6)]
    sig_rows = [[ref.bls_sign(m, sk) for sk, _ in keys] for m in msgs]
    pk_rows = [[pk for _, pk in keys] for _ in msgs]
    sig_rows[1][2] = ref.g1_add(sig_rows[1][2], ref.G1_GEN)
    sig_rows[2], pk_rows[2] = [], []
    msgs[3] = msgs[0]
    sig_rows[4][1] = None
    pk_rows[5] = [keys[0][1], ref.g2_neg(keys[0][1])]
    sig_rows[5] = [sig_rows[5][0], ref.g1_neg(sig_rows[5][0])]
    row_keys = [("committee", s) for s in range(6)]
    want = ref_get_backend("python").bls_verify_committees(
        msgs, sig_rows, pk_rows)
    assert want == [True, False, False, False, False, False]
    return msgs, sig_rows, pk_rows, row_keys, want


def test_precomp_cold_and_warm_match_python_backend(period):
    msgs, sig_rows, pk_rows, row_keys, want = period
    backend = TorchSigBackend(device="cpu")
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=row_keys) == want
    cold = backend.last_timing
    assert cold["precomp"] and cold["g2_wire_bytes"] > 0
    assert cold["hit_rows"] == 0 and len(backend.lines) == 5
    future = backend.bls_verify_committees_async(msgs, sig_rows, pk_rows,
                                                 pk_row_keys=row_keys)
    assert future.result() == want and future.done()
    warm = backend.last_timing
    assert warm["precomp"] and warm["g2_wire_bytes"] == 0
    assert warm["hit_rows"] == sum(1 for r in pk_rows if r) == 5
    assert warm["memo"] and not cold["memo"]
    assert warm["bucket"] == 8
    assert set(warm["launches"]) >= {"agg_g1", "conv", "norm", "finalexp"}
    assert not any(warm["launches"].values())   # CPU: the plain versions


def test_short_key_list_and_keyless_audits(period):
    msgs, sig_rows, pk_rows, row_keys, want = period
    backend = TorchSigBackend(device="cpu")
    # trailing rows uncached, not dropped: they precompute every audit
    for _ in range(2):
        assert backend.bls_verify_committees(
            msgs, sig_rows, pk_rows, pk_row_keys=row_keys[:2]) == want
        assert backend.last_timing["precomp"]
        assert backend.last_timing["g2_wire_bytes"] > 0
    assert backend.last_timing["hit_rows"] == 2 and len(backend.lines) == 2
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows) == want
    assert not backend.last_timing["precomp"]
    assert backend.last_timing["hit_rows"] == 0


def test_eviction_churn_keeps_verdicts(period):
    msgs, sig_rows, pk_rows, row_keys, want = period
    backend = TorchSigBackend(device="cpu")
    backend.lines = LineTableCache("cpu", budget_bytes=2000)
    for rnd in range(2):   # fresh keys: every insert evicts at once
        keys = [(rnd,) + key for key in row_keys]
        assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                             pk_row_keys=keys) == want
    assert backend.lines.evictions == 10
    assert backend.lines.bytes <= 2000 and len(backend.lines) == 0


def test_line_cache_lru_order():
    cache = LineTableCache("cpu", budget_bytes=2 * 52_801)
    table = torch.zeros(bn.LINE_TABLE_SHAPE, dtype=torch.int32)
    flag = torch.zeros((), dtype=torch.bool)
    for key in ("a", "b"):
        cache.insert(key, table, flag)
    plan = cache.resolve([[1], [1], [], [1]], ["a", "x", None, None], 4)
    assert [s[0] for s in plan.steps] == ["hit", "miss", "zero", "miss"]
    assert plan.batch_key is None and plan.hit_rows == 1
    cache.insert("c", table, flag)          # "b" is the oldest now
    assert cache.evictions == 1 and len(cache) == 2
    plan = cache.resolve([[1], [1], [1]], ["a", "b", "c"], 4)
    assert [s[0] for s in plan.steps] == ["hit", "miss", "hit"]
    tab, inf = cache.assemble(plan, (table[None] + 1, flag[None]))
    assert tab.shape == (3,) + bn.LINE_TABLE_SHAPE and not inf.any()
    memo = cache.resolve([[1], [1], [1]], ["a", "b", "c"], 4)
    assert memo.memo is not None and memo.hit_rows == 3
    assert marshal.normalize_row_keys(["a"], 3) == ["a", None, None]
    assert marshal.normalize_row_keys(["a", "b"], 1) == ["a"]
    assert marshal.normalize_row_keys(None, 3) is None


def test_memo_hit_refreshes_lru_order():
    """A batch-memo hit keeps its committees young in the LRU, so another
    batch's insert evicts a table the steady batch does not use."""
    cache = LineTableCache("cpu", budget_bytes=3 * 52_801)
    table = torch.zeros(bn.LINE_TABLE_SHAPE, dtype=torch.int32)
    flag = torch.zeros((), dtype=torch.bool)
    rows, keys = [[1], [1]], ["a", "b"]
    plan = cache.resolve(rows, keys, 2)
    cache.assemble(plan, (table[None].expand(2, *table.shape), flag[None]
                          .expand(2)))
    cache.insert("c", table, flag)           # LRU: a, b, c
    assert cache.resolve(rows, keys, 2).memo is not None
    cache.insert("d", table, flag)           # evicts c, not a
    plan = cache.resolve([[1]] * 4, ["a", "b", "c", "d"], 4)
    assert [s[0] for s in plan.steps] == ["hit", "hit", "miss", "hit"]
    assert cache.evictions == 1


def test_reference_line_tables_cross_into_the_port(period):
    """The reference's `precompute_lines` of the port's committee sums,
    carried over by `convert.line_tables_from_reference` (in both limb
    forms), serves the port's warm audit: 0 G2 bytes, same verdicts."""
    msgs, sig_rows, pk_rows, row_keys, want = period
    width = marshal.committee_width(sig_rows, pk_rows)
    gx, gy, gm = bn.g2_committee_to_limbs(pk_rows, width)
    pX, pY, pZ = mk.aggregate_proj(*map(torch.as_tensor, (gx, gy, gm)),
                                   fp2=True)
    tab = np.array(k.precompute_lines(*(jnp.asarray(v.numpy())
                                        for v in (pX, pY, pZ))))
    inf = bn.fp2_is_zero(pZ).numpy()
    assert inf.tolist() == [False, False, True, False, False, True]
    exact = bn.FP.canon(torch.as_tensor(tab)).numpy()[..., :22]
    for form in (tab, exact.astype(np.uint16)):
        tables, flags = convert.line_tables_from_reference(form, inf,
                                                           device="cpu")
        assert tables.dtype == torch.int32 and tables.shape == (6, 88, 3, 2,
                                                                25)
        backend = TorchSigBackend(device="cpu")
        for s, key in enumerate(row_keys):
            if pk_rows[s]:
                backend.lines.insert(key, tables[s], flags[s])
        assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                             pk_row_keys=row_keys) == want
        assert backend.last_timing["g2_wire_bytes"] == 0
        assert backend.last_timing["hit_rows"] == 5
        assert not backend.last_timing["memo"]     # stacked from the LRU
    with pytest.raises(ValueError, match="not a line table"):
        convert.line_tables_from_reference(tab[..., :2, :, :, :], inf)
