"""The port's tower and its two kernels' plain versions against the JAX
package:

1. `ops/conv.py::pair_conv_combine_plain` equals the Pallas kernel
   `ops/pallas_conv.py::pair_conv_combine` run in interpret mode, for
   every combine on the precomp path, with a partial block, leading dims
   and a broadcast constant operand;
2. `ops/norm.py::normalize_plain` equals `pallas_norm.normalize_pallas`
   in interpret mode and the reference's `ModArith.normalize`, on random,
   negative and bound-edge accumulators of every width the fold takes;
3. the tower functions equal `bn256_jax`'s limb for limb where the
   formulation is shared, and `fp2_sqr` (the reference's kernel form
   against its default XLA form) equals it mod p;
4. `precompute_lines` equals the reference's mod p on a shared
   projective input, and `miller_loop_precomp` equals it limb for limb
   on a shared table.

Inputs are made with numpy from a seed and fed to both sides; integer
arithmetic has no rounding, so every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.ops import bn256_jax as k
from gethsharding_tpu.ops import limb as ref_limb
from gethsharding_tpu.ops.pallas_conv import (BLOCK_COLS, comb_terms,
                                              pair_conv_combine)
from gethsharding_tpu.ops.pallas_norm import normalize_pallas
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import conv, norm
from gethsharding_tpu_torch.ops.limb import ints_to_limbs

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

REF_FP = ref_limb.ModArith(bn.P)
COMBS = {"fp2": "_COMB_FP2", "fp2_sqr": "_COMB_FP2_SQR", "fp12": "_COMB",
         "line": "_LCOMB"}
MAX_LIMB = int(2 ** 30.7) - 1


def _canon(rng, shape):
    return rng.integers(0, 1 << 12, shape + (25,)).astype(np.int32)


def _lazy(rng, shape):
    """Lazy elements: canonical limbs, value < 2^272."""
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(34), "little") for _ in range(n)]
    return ints_to_limbs(vals).reshape(shape + (25,))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert (got.numpy() == want).all()


# == 1. the conv kernel's plain version =====================================


@pytest.mark.parametrize("name", list(COMBS) + ["identity"])
def test_plain_conv_equals_pallas_interpret(name):
    comb = (k._mul_many_comb(1) if name == "identity"
            else getattr(bn, COMBS[name]))
    assert (comb == (np.ones((1,) * 5, np.int32) if name == "identity"
                     else getattr(k, COMBS[name]))).all()
    G, A, B, _, _ = comb.shape
    rng = np.random.default_rng(101)
    x, y = _canon(rng, (2, G, A)), _canon(rng, (2, G, B))
    want = pair_conv_combine(jnp.asarray(x), jnp.asarray(y), comb,
                             interpret=True)
    _same(conv.pair_conv_combine_plain(torch.as_tensor(x),
                                       torch.as_tensor(y), comb), want)
    assert conv.comb_terms(comb) == comb_terms(comb)


def test_plain_conv_partial_block_and_leading_dims():
    rng = np.random.default_rng(102)
    x = _canon(rng, (3, BLOCK_COLS // 2 + 1, 1, 2))
    y = _canon(rng, x.shape[:-1])
    want = pair_conv_combine(jnp.asarray(x), jnp.asarray(y), k._COMB_FP2,
                             interpret=True)
    _same(conv.pair_conv_combine(torch.as_tensor(x), torch.as_tensor(y),
                                 bn._COMB_FP2), want)


def test_plain_conv_broadcast_operand():
    rng = np.random.default_rng(103)
    xb = _canon(rng, (4, 2, 6, 3, 2))
    yc = _canon(rng, (6, 3, 2))
    for x, y in ((xb, yc), (yc, xb)):
        want = pair_conv_combine(jnp.asarray(x), jnp.asarray(y), k._LCOMB,
                                 interpret=True)
        _same(conv.pair_conv_combine(torch.as_tensor(x), torch.as_tensor(y),
                                     bn._LCOMB), want)


# == 2. the normalize kernel's plain version ================================


def _accumulators(kind: str, width: int, rng) -> np.ndarray:
    """(8, width) int32 accumulators, value >= 0, |limb| < 2^30.7."""
    if kind == "random":
        return rng.integers(0, 1 << 28, (8, width)).astype(np.int32)
    if kind == "negative":   # differences: negative limbs, the top ones
        hi = rng.integers(MAX_LIMB // 4, MAX_LIMB // 2, (8, width))
        lo = rng.integers(0, MAX_LIMB // 2, (8, width))
        lo[:, -2:] = 0       # positive, so the value stays >= 0
        return (hi - lo).astype(np.int32)
    # bound edge: every limb at ±(2^30.7 - 1), the top one positive
    z = np.where(rng.integers(0, 2, (8, width)) == 1, MAX_LIMB, -MAX_LIMB)
    z[:, -1] = MAX_LIMB
    return z.astype(np.int32)


@pytest.mark.parametrize("width", [25, 26, 49, norm.MAX_WIDTH])
@pytest.mark.parametrize("kind", ["random", "negative", "edge"])
def test_plain_normalize_equals_pallas_and_reference(kind, width):
    z = _accumulators(kind, width, np.random.default_rng(104 + width))
    want = np.asarray(REF_FP.normalize(jnp.asarray(z)))
    assert (np.asarray(normalize_pallas(REF_FP, jnp.asarray(z),
                                        interpret=True)) == want).all()
    _same(norm.normalize_plain(bn.FP, torch.as_tensor(z)), want)
    _same(bn.FP.normalize(torch.as_tensor(z).reshape(2, 4, width)),
          want.reshape(2, 4, 25))


def test_normalize_refuses_too_wide_accumulators():
    with pytest.raises(ValueError, match="too wide"):
        bn.FP.normalize(torch.zeros((2, norm.MAX_WIDTH + 1),
                                    dtype=torch.int32))


# == 3. the tower ===========================================================


def _tower_cases(rng):
    x2, y2 = _lazy(rng, (3, 2)), _lazy(rng, (3, 2))
    s = _lazy(rng, (3,))
    x12, y12 = _lazy(rng, (3, 6, 2)), _lazy(rng, (3, 6, 2))
    line = tuple(_lazy(rng, (3, 2)) for _ in range(3))
    t, j = torch.as_tensor, jnp.asarray
    cases = {
        "fp2_mul": (lambda: k.fp2_mul(j(x2), j(y2)),
                    lambda: bn.fp2_mul(t(x2), t(y2))),
        "fp2_mul_const": (lambda: k.fp2_mul(j(x2), j(k._TWF_X)),
                          lambda: bn.fp2_mul(t(x2), t(bn._TWF_X))),
        "fp2_mul_fp": (lambda: k.fp2_mul_fp(j(x2), j(s)),
                       lambda: bn.fp2_mul_fp(t(x2), t(s))),
        "fp2_mul_xi": (lambda: k.fp2_mul_xi(j(x2)),
                       lambda: bn.fp2_mul_xi(t(x2))),
        "fp2_conj": (lambda: k.fp2_conj(j(x2)), lambda: bn.fp2_conj(t(x2))),
        "fp2_sub": (lambda: k.fp2_sub(j(x2), j(y2)),
                    lambda: bn.fp2_sub(t(x2), t(y2))),
        "fp2_scalar": (lambda: k.fp2_scalar(j(x2), 8),
                       lambda: bn.fp2_scalar(t(x2), 8)),
        "fp12_mul": (lambda: k.fp12_mul(j(x12), j(y12)),
                     lambda: bn.fp12_mul(t(x12), t(y12))),
        "fp12_sqr": (lambda: k.fp12_sqr(j(x12)), lambda: bn.fp12_sqr(t(x12))),
        "fp12_mul_line": (
            lambda: k.fp12_mul_line(j(x12), tuple(map(j, line))),
            lambda: bn.fp12_mul_line(t(x12), t(np.stack(line, axis=-3)))),
        "fp12_conj": (lambda: k.fp12_conj(j(x12)),
                      lambda: bn.fp12_conj(t(x12))),
    }
    for n in (1, 2, 3):
        cases[f"frob{n}"] = (lambda n=n: k.fp12_frobenius(j(x12), n),
                             lambda n=n: bn.fp12_frobenius(t(x12), n))
    return cases, (x2, t, j)


@pytest.mark.parametrize("name", [
    "fp2_mul", "fp2_mul_const", "fp2_mul_fp", "fp2_mul_xi", "fp2_conj",
    "fp2_sub", "fp2_scalar", "fp12_mul", "fp12_sqr", "fp12_mul_line",
    "fp12_conj", "frob1", "frob2", "frob3"])
def test_tower_equals_reference_limb_for_limb(name):
    cases, _ = _tower_cases(np.random.default_rng(105))
    ref_fn, port_fn = cases[name]
    _same(port_fn(), ref_fn())


def test_fp2_sqr_equals_reference_mod_p():
    _, (x2, t, j) = _tower_cases(np.random.default_rng(105))
    got, want = bn.fp2_sqr(t(x2)), k.fp2_sqr(j(x2))
    _same(bn.FP.canon(got), REF_FP.canon(want))
    # the kernel form is the reference's own under its pair-conv kernel
    _same(got, k.FP.normalize(k._pad_to(
        k._pair_conv_combine(j(x2)[..., None, :, :], j(x2)[..., None, :, :],
                             k._COMB_FP2_SQR)[..., 0, :], k._FP2_W)
        + jnp.asarray(k._FP2_PAD)))


def test_tower_tables_equal_reference():
    for name in ("_COMB_FP2", "_COMB_FP2_SQR", "_FP2_PAD", "_COMB", "_LCOMB",
                 "_CONV_J", "_CONV_SEL", "_LINE_J", "_LINE_SEL", "_PAD530",
                 "_PAD266", "FP12_ONE"):
        assert (np.asarray(getattr(bn, name))
                == np.asarray(getattr(k, name))).all(), name
    assert bn._ACC_W == k._ACC_W and bn._FP2_W == k._FP2_W
    for n in (1, 2, 3):
        assert (bn._GAMMA[n] == k._GAMMA[n]).all()
        assert (bn._group_pad(n) == k._group_pad(n)).all()
    assert bn.LINE_TABLE_SHAPE == k.LINE_TABLE_SHAPE == (88, 3, 2, 25)
    assert (bn.generator_line_table() == k.generator_line_table()).all()


# == 4. the precomp family ==================================================


@pytest.fixture(scope="module")
def shared_walk():
    """A projective G2 input (2 rows) and the reference's line table."""
    rng = np.random.default_rng(106)
    pk = tuple(_lazy(rng, (2, 2)) for _ in range(3))
    want = np.array(k.precompute_lines(*map(jnp.asarray, pk)))
    return pk, want


def test_precompute_lines_equals_reference_mod_p(shared_walk):
    pk, want = shared_walk
    got = bn.precompute_lines(*map(torch.as_tensor, pk))
    assert got.shape == (2,) + bn.LINE_TABLE_SHAPE
    _same(bn.FP.canon(got), REF_FP.canon(jnp.asarray(want)))


def test_miller_loop_precomp_equals_reference(shared_walk):
    _, table = shared_walk
    rng = np.random.default_rng(107)
    sig = tuple(_lazy(rng, (2,)) for _ in range(3))
    hx, hy = _lazy(rng, (2,)), _lazy(rng, (2,))
    want = k.miller_loop_precomp(tuple(map(jnp.asarray, sig)),
                                 jnp.asarray(hx), jnp.asarray(hy),
                                 jnp.asarray(table))
    got = bn.miller_loop_precomp(tuple(map(torch.as_tensor, sig)),
                                 torch.as_tensor(hx), torch.as_tensor(hy),
                                 torch.as_tensor(table))
    _same(got, want)
