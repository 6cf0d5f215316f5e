"""The port's limb arithmetic (gethsharding_tpu_torch/ops/limb.py) against
the JAX package's wide form (gethsharding_tpu/ops/limb.py), limb for limb.

Inputs are made with numpy from a seed and fed to both sides. Integer
arithmetic has no rounding, so every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.ops import limb as ref_limb
from gethsharding_tpu_torch.ops import limb
from gethsharding_tpu_torch.ops.bn256 import FP, P

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

REF_FP = ref_limb.ModArith(P)
MAX_COL = 4 * 25 * 4095 ** 2  # four summed 25-term product columns < 2^30.7


def test_int_limbs_round_trip():
    rng = np.random.default_rng(71)
    vals = [int.from_bytes(rng.bytes(37), "little") >> 4 for _ in range(64)]
    vals += [0, 1, (1 << 300) - 1, P - 1, P]
    arr = limb.ints_to_limbs(vals)
    assert arr.dtype == np.int32 and arr.shape == (len(vals), 25)
    assert (arr == ref_limb.ints_to_limbs(vals, 25)).all()
    assert list(limb.limbs_to_int(arr)) == vals
    assert list(limb.limbs_to_int(torch.as_tensor(arr))) == vals
    for v in vals[:8]:
        assert (limb.int_to_limbs(v) == arr[vals.index(v)]).all()
        assert limb.limbs_to_int(limb.int_to_limbs(v)) == v
    with pytest.raises(ValueError):
        limb.int_to_limbs(1 << 300)
    with pytest.raises(ValueError):
        limb.ints_to_limbs([1 << 300])


def _accumulators(kind: str, rng) -> np.ndarray:
    """(8, 49) int32 column accumulators with value >= 0 and every limb
    inside the |limb| < 2^30.7 bound the callers guarantee."""
    if kind == "products":       # sums of four schoolbook products
        u = rng.integers(0, 1 << 12, (8, 4, 25, 1), dtype=np.int64)
        v = rng.integers(0, 1 << 12, (8, 4, 1, 25), dtype=np.int64)
        prod = (u * v).sum(axis=1)
        cols = np.zeros((8, 49), np.int64)
        for l in range(25):
            cols[:, l:l + 25] += prod[:, l, :]
        return cols.astype(np.int32)
    if kind == "max":            # every column at the bound
        return np.full((8, 49), MAX_COL, np.int32)
    # two products subtracted from two, padded by a multiple of p: the
    # real component of an fp2 product group, with negative columns
    pad = np.zeros(49, np.int64)
    pad[:46] = ref_limb.ModArith(P).pad_mult(547)
    if kind == "pad":            # a multiple of p alone
        return np.broadcast_to(pad, (8, 49)).astype(np.int32)
    hi = rng.integers(MAX_COL // 4, MAX_COL // 2, (8, 49), dtype=np.int64)
    lo = rng.integers(0, MAX_COL // 2, (8, 49), dtype=np.int64)
    lo[:, -3:] = 0               # positive top columns keep the value >= 0
    return (hi - lo + pad).astype(np.int32)


@pytest.mark.parametrize("kind", ["products", "max", "mixed", "pad"])
def test_normalize_matches_reference(kind):
    rng = np.random.default_rng(72)
    z = _accumulators(kind, rng)
    want = np.asarray(REF_FP.normalize(jnp.asarray(z)))
    got = FP.normalize(torch.as_tensor(z)).numpy()
    assert got.dtype == np.int32 and got.shape == (8, 25)
    assert (got == want).all()
    # narrower accumulators (sums of lazy elements) too
    w25 = rng.integers(0, 1 << 14, (8, 25)).astype(np.int32)
    assert (FP.normalize(torch.as_tensor(w25)).numpy()
            == np.asarray(REF_FP.normalize(jnp.asarray(w25)))).all()


def _lazy_values(rng) -> np.ndarray:
    vals = [int.from_bytes(rng.bytes(34), "little") % (1 << 272)
            for _ in range(10)]
    vals += [0, P, 2 * P, P - 1, 1, (1 << 273) - 1]
    return limb.ints_to_limbs(vals)


def test_canon_is_zero_eq_neg_match_reference():
    rng = np.random.default_rng(73)
    x = _lazy_values(rng)
    y = np.roll(x, 1, axis=0)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert (FP.canon(tx).numpy() == np.asarray(REF_FP.canon(jx))).all()
    assert (FP.is_zero(tx).numpy() == np.asarray(REF_FP.is_zero(jx))).all()
    assert FP.is_zero(tx).numpy().sum() == 3          # 0, P, 2P
    assert (FP.eq(tx, ty).numpy() == np.asarray(REF_FP.eq(jx, jy))).all()
    assert (FP.neg(tx).numpy() == np.asarray(REF_FP.neg(jx))).all()
    # quasi-canonical limbs (-1 .. 2^12+64), as the relaxed kernels leave
    q = rng.integers(-1, (1 << 12) + 65, (6, 25)).astype(np.int32)
    q[:, -3:] = rng.integers(0, 8, (6, 3))
    want = np.asarray(REF_FP.canon(REF_FP.normalize(jnp.asarray(q))))
    assert (FP.canon(torch.as_tensor(q)).numpy() == want).all()


def test_canon_edges_match_reference():
    """canon's float64 quotient estimate at the edges of its range, in the
    wide form: p - 1, p, 2p - 1, 2p and the lazy bound 2^273 - 1 (the
    exact form's edges run in tests/test_torch_exact.py)."""
    vals = [P - 1, P, P + 1, 2 * P - 1, 2 * P, (1 << 273) - 1,
            (1 << 273) - P, (1 << 264) - 1]
    x = limb.ints_to_limbs(vals)
    got = FP.canon(torch.as_tensor(x))
    assert (got.numpy() == np.asarray(REF_FP.canon(jnp.asarray(x)))).all()
    assert limb.limbs_to_int(got).tolist() == [v % P for v in vals]
    assert FP.is_zero(torch.as_tensor(x)).tolist() == \
        [False, True, False, False, True, False, False, False]
