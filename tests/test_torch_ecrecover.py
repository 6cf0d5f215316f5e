"""The port's secp256k1 recovery (gethsharding_tpu_torch/ops/secp256k1.py,
csrc/secp256k1.cu) and its limb engine against the JAX package's, on the
CPU:

1. `ModArith(P)` and `ModArith(N)` of secp256k1 (p and n just under
   2^256, where bn256's p is ~2^254) against the reference's ModArith,
   limb for limb, in both limb forms: normalize (sums of products,
   accumulators with every column at the 2^30.7 bound, limbs at ±2^30.7,
   lazy values), canon and sub/neg at m - 1, m, 2m - 1, 2^256 - 1 and the
   lazy bound, mul, select, pow_static, inv and the raw "< n" compare.
   Both packages read their limb form at import, so each form's checks
   run in a fresh interpreter with both knobs set, as
   tests/test_torch_exact.py does;
2. `ecrecover_plain` against `secp256k1_jax.ecrecover_batch` (jitted, one
   compile shared by the module) on valid signatures and hostile rows:
   r = 0, r = n, r = p - 1, r = 2^256 - 1, s = 0, s = n, s = 2^256 - 1,
   an r with no curve point, recid 2 and 5, a tampered digest, digests
   0, n and 2^256 - 1, R = G and R = -G, and ladders whose accumulator
   meets its addend (G + R at R = G, R at R = 2G) or its negation (R at
   R = -2G), and a key at infinity;
3. `csrc/secp256k1.cu` compiled for the host with g++ under the shim of
   tests/torch_host_shim.py (one thread runs every lane of a block in
   turn) against `ecrecover_plain` on the same rows, at 25 and 22 limbs,
   and at row counts that leave a warp or a block part full;
4. `TorchSigBackend(device="cpu").ecrecover_addresses` against the
   reference `python` and `jax` backends on the above as wire signatures
   and the probes of ROADMAP.md §C (high s with v flipped, v = 27,
   recid 3, 64- and 66-byte signatures, 0-, 31- and 33-byte digests),
   the empty batch and a 1-row batch.

Inputs come from numpy seeds and the scalar signer; integer arithmetic
has no rounding, so every comparison is exact."""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_host_shim
from gethsharding_tpu.crypto import secp256k1 as ref
from gethsharding_tpu.crypto.keccak import keccak256
from gethsharding_tpu.ops import secp256k1_jax as rk
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu.sigbackend import marshal as ref_marshal
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.ops import secp256k1 as sk
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

# == 1. the limb engine at secp256k1's moduli, in both forms ===============

_LIMB_SCRIPT = r'''
import json, traceback
import numpy as np
import jax.numpy as jnp
import torch

from gethsharding_tpu.ops import limb as rlimb
from gethsharding_tpu.ops import secp256k1_jax as rk
from gethsharding_tpu_torch.ops import limb
from gethsharding_tpu_torch.ops import secp256k1 as sk

NL = limb.NLIMBS
assert NL == rlimb.NLIMBS, (NL, rlimb.NLIMBS)
EDGE = int(2 ** 30.7) - 1
MAX_COL = 4 * NL * 4095 ** 2      # four summed schoolbook columns
results = {}
t, j = torch.as_tensor, jnp.asarray


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert (got == want).all(), np.argwhere(got != want)[:5]


for mod, port, refm in (("p", sk.FQ, rk.FQ), ("n", sk.FN, rk.FN)):
    m = port.p
    assert m == refm.p
    rng = np.random.default_rng(101 if mod == "p" else 103)
    lazy = [int.from_bytes(rng.bytes(40), "little") % (1 << limb.LAZY_BITS)
            for _ in range(8)]
    lazy += [0, 1, m - 1, m, m + 1, 2 * m - 1, 2 * m, (1 << 256) - 1,
             (1 << limb.LAZY_BITS) - 1]
    x = limb.ints_to_limbs(lazy)
    y = np.roll(x, 3, axis=0)

    def accumulators():
        w = 2 * NL - 1
        u = rng.integers(0, 1 << 12, (8, 4, NL, 1), dtype=np.int64)
        v = rng.integers(0, 1 << 12, (8, 4, 1, NL), dtype=np.int64)
        prod = (u * v).sum(axis=1)
        cols = np.zeros((8, w), np.int64)
        for l in range(NL):
            cols[:, l:l + NL] += prod[:, l, :]
        full = np.full((4, w), MAX_COL, np.int64)
        edge = np.where(rng.integers(0, 2, (8, w)) == 1, EDGE, -EDGE)
        edge[:, -1] = EDGE                       # the top keeps value >= 0
        return [cols.astype(np.int32), full.astype(np.int32),
                edge.astype(np.int32), x]

    def check(name, fn):
        try:
            fn()
            results[f"{name}_{mod}"] = None
        except BaseException:
            results[f"{name}_{mod}"] = traceback.format_exc()[-3000:]

    def c_normalize():
        for z in accumulators():
            same(port.normalize(t(z)), refm.normalize(j(z)))

    def c_canon():
        same(port.canon(t(x)), refm.canon(j(x)))
        assert limb.limbs_to_int(port.canon(t(x))).tolist() == \
            [v % m for v in lazy]
        same(port.is_zero(t(x)), refm.is_zero(j(x)))
        same(port.eq(t(x), t(y)), refm.eq(j(x), j(y)))

    def c_sub():
        same(port.sub(t(x), t(y)), refm.sub(j(x), j(y)))

    def c_neg():
        same(port.neg(t(x)), refm.neg(j(x)))

    def c_mul():
        canon = limb.ints_to_limbs([v % (1 << 256) for v in lazy])
        for a, b in ((x, y), (canon, np.roll(canon, 1, axis=0))):
            same(port.mul(t(a), t(b)), refm.mul(j(a), j(b)))

    def c_select():
        cond = rng.integers(0, 2, x.shape[0]).astype(bool)
        same(port.select(t(cond), t(x), t(y)),
             refm.select(j(cond), j(x), j(y)))

    def c_pow_static():
        for e in (0, 1, 6, 0x1F2E3D4C5B6A7988, (m + 1) // 4):
            same(port.pow_static(t(x), e), refm.pow_static(j(x), e))

    def c_inv():
        same(port.inv(t(x)), refm.inv(j(x)))
        got = limb.limbs_to_int(port.canon(port.inv(t(x)))).tolist()
        assert got == [pow(v, m - 2, m) for v in lazy]

    def c_lt_raw():
        raw = limb.ints_to_limbs([v % (1 << 256) for v in lazy]
                                 + [m - 1, m, m + 1])
        bound = limb.int_to_limbs(m)
        got = limb.lt_raw(t(raw), bound)
        assert got.tolist() == [v < m for v in
                                limb.limbs_to_int(raw).tolist()]
        if mod == "n":
            same(got, rk._lt_n(j(raw)))

    for name, fn in (("normalize", c_normalize), ("canon", c_canon),
                     ("sub", c_sub), ("neg", c_neg), ("mul", c_mul),
                     ("select", c_select), ("pow_static", c_pow_static),
                     ("inv", c_inv), ("lt_raw", c_lt_raw)):
        check(name, fn)

print("RESULTS " + json.dumps(results))
'''

LIMB_CHECKS = ("normalize", "canon", "sub", "neg", "mul", "select",
               "pow_static", "inv", "lt_raw")


@pytest.fixture(scope="module")
def limb_results():
    """Each limb form's checks, run once in a fresh interpreter (the two
    side by side)."""
    procs = {}
    for form in ("wide", "exact"):
        env = dict(os.environ, GETHSHARDING_TORCH_LIMB_FORM=form,
                   GETHSHARDING_TPU_LIMB_FORM=form, JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="2",
                   PYTHONPATH=str(REPO))
        procs[form] = subprocess.Popen(
            [sys.executable, "-c", _LIMB_SCRIPT], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for form, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            lines = [l for l in stdout.splitlines()
                     if l.startswith("RESULTS ")]
            assert proc.returncode == 0 and lines, stderr[-3000:]
            out[form] = json.loads(lines[-1][len("RESULTS "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("form", ["wide", "exact"])
@pytest.mark.parametrize("mod", ["p", "n"])
@pytest.mark.parametrize("check", LIMB_CHECKS)
def test_secp_limb_engine_equals_reference(limb_results, form, mod, check):
    assert limb_results[form][f"{check}_{mod}"] is None, \
        limb_results[form][f"{check}_{mod}"]


# == 2. the plain recovery against the reference ladder ======================


def _signed(i: int):
    priv = int.from_bytes(keccak256(b"torch-priv-%d" % i), "big") % ref.N
    msg = keccak256(b"torch-msg-%d" % i)
    return priv, msg, ecdsa.sign(msg, priv)


def _no_curve_point() -> int:
    """The smallest x >= 5 with x^3 + 7 not a square mod p."""
    x = 5
    while pow((x ** 3 + 7) % ref.P, (ref.P - 1) // 2, ref.P) == 1:
        x += 1
    return x


def _digest(e: int) -> bytes:
    return (e % ref.N).to_bytes(32, "big")


def _hostile_rows():
    """(digests, (r, s, recid) per row, label per row): 4 valid
    signatures and the hostile rows, 24 in all. The ladder rows pick
    (u1, u2) = (-e·r^-1, s·r^-1) mod n: with R = G, (3, 1) makes the
    accumulator 2G meet its addend G + R = 2G; with R = ±2G, (2, 1)
    makes it meet R or -R; with R = G, (-5/r, 5/r) sums to infinity."""
    signed = [_signed(i) for i in range(4)]
    msg, sig = signed[0][1], signed[0][2]
    rows = [(m, (s.r, s.s, s.v), "valid") for _, m, s in signed]
    gy_parity = ref.GY & 1
    two_g = ref.point_add((ref.GX, ref.GY), (ref.GX, ref.GY))
    rows += [
        (msg, (0, sig.s, sig.v), "r = 0"),
        (msg, (ref.N, sig.s, sig.v), "r = n"),
        (msg, (ref.P - 1, sig.s, sig.v), "r = p - 1"),
        (msg, ((1 << 256) - 1, sig.s, sig.v), "r = 2^256 - 1"),
        (msg, (sig.r, 0, sig.v), "s = 0"),
        (msg, (sig.r, ref.N, sig.v), "s = n"),
        (msg, (sig.r, (1 << 256) - 1, sig.v), "s = 2^256 - 1"),
        (msg, (_no_curve_point(), sig.s, sig.v), "no curve point"),
        (msg, (sig.r, sig.s, 2), "recid 2"),
        (msg, (sig.r, sig.s, 5), "recid 5"),
        (keccak256(b"tampered"), (sig.r, sig.s, sig.v), "tampered"),
        (bytes(32), (sig.r, sig.s, sig.v), "digest 0"),
        (ref.N.to_bytes(32, "big"), (sig.r, sig.s, sig.v), "digest n"),
        (b"\xff" * 32, (sig.r, sig.s, sig.v), "digest 2^256 - 1"),
        (msg, (ref.GX, 7, gy_parity), "R = G"),
        (msg, (ref.GX, 7, gy_parity ^ 1), "R = -G"),
        (_digest(-3 * ref.GX), (ref.GX, ref.GX, gy_parity),
         "meets G + R"),
        (_digest(-2 * two_g[0]), (two_g[0], two_g[0], two_g[1] & 1),
         "meets R"),
        (_digest(-2 * two_g[0]), (two_g[0], two_g[0], two_g[1] & 1 ^ 1),
         "meets -R"),
        (_digest(5), (ref.GX, 5, gy_parity), "Q at infinity"),
    ]
    return rows


@pytest.fixture(scope="module")
def hostile():
    rows = _hostile_rows()
    e = rk.hashes_to_limbs([m for m, _, _ in rows])
    r = rk.ints_to_limbs([rs[0] for _, rs, _ in rows])
    s = rk.ints_to_limbs([rs[1] for _, rs, _ in rows])
    v = np.array([rs[2] for _, rs, _ in rows], np.int32)
    valid = np.ones(len(rows), bool)
    valid[1] = False                         # a valid signature masked off
    return rows, (e, r, s, v, valid)


@pytest.fixture(scope="module")
def reference_out(hostile):
    """The reference ladder, jitted as the `jax` backend jits it and
    padded to the backend case's bucket (32 rows), so that case reuses
    this compile."""
    rows, planes = hostile
    pad = ref_marshal.bucket_size(len(_hostile_sigs65()[0])) - len(rows)
    padded = [np.concatenate([a, a[:1].repeat(pad, axis=0)]) for a in planes]
    qx, qy, ok = jax.jit(rk.ecrecover_batch)(*map(jnp.asarray, padded))
    return tuple(np.asarray(o)[:len(rows)] for o in
                 (rk.FQ.canon(qx), rk.FQ.canon(qy), ok))


@pytest.fixture(scope="module")
def plain_out(hostile):
    _, planes = hostile
    return tuple(o.numpy() for o in
                 sk.ecrecover_plain(*map(torch.as_tensor, planes)))


def test_plain_recovery_equals_reference(hostile, reference_out, plain_out):
    rows, (e, r, s, v, valid) = hostile
    for got, want in zip(plain_out, reference_out):
        assert got.shape == want.shape and (got == want).all()
    labels = [label for _, _, label in rows]
    ok = plain_out[2].tolist()
    assert [label for label, good in zip(labels, ok) if good] == \
        ["valid", "valid", "valid", "tampered", "digest 0", "digest n",
         "digest 2^256 - 1", "R = G", "R = -G", "meets G + R", "meets R"]
    # the recovered keys are the scalar truth's
    for i, (msg, (rr, ss, vv), _) in enumerate(rows):
        if ok[i]:
            want = ref.recover(msg, ref.Signature(rr, ss, vv))
            assert sk.limbs_to_pubkeys(plain_out[0][i:i + 1],
                                       plain_out[1][i:i + 1],
                                       plain_out[2][i:i + 1]) == [want]


def test_converters_equal_reference():
    sigs = [_signed(i)[2] for i in range(3)]
    digests = [_signed(i)[1] for i in range(3)]
    assert (sk.hashes_to_limbs(digests) == rk.hashes_to_limbs(digests)).all()
    port = sk.sigs_to_limbs(sigs)
    want = rk.sigs_to_limbs([ref.Signature(s.r, s.s, s.v) for s in sigs])
    for a, b in zip(port, want):
        assert a.dtype == b.dtype and (a == b).all()


def test_scalar_crypto_equals_reference():
    """The port's host copy signs and recovers as the reference does."""
    for i in range(3):
        priv, msg, sig = _signed(i)
        want = ref.sign(msg, priv)
        assert (sig.r, sig.s, sig.v) == (want.r, want.s, want.v)
        assert ecdsa.ecrecover_address(msg, sig) == \
            ref.ecrecover_address(msg, want)
        assert ecdsa.Signature.from_bytes65(sig.to_bytes65()) == sig


# == 3. the kernel source, compiled for the host =============================

_RUNNER = r"""
extern "C" void run(const int* e, const int* r, const int* s,
                    const int* recid, const unsigned char* valid, int n,
                    int nl, int* qx, int* qy, unsigned char* ok) {
  for (int b = 0; b * gs::SECP_ROWS < n; ++b) {
    blockIdx.x = b;
    gs::ecrecover_kernel(e, r, s, recid, valid, n, nl, qx, qy, ok);
  }
}"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/secp256k1.cu built for the host (tests/torch_host_shim.py):
    each row's thread runs in turn, a legal schedule of the kernel."""
    return torch_host_shim.build(tmp_path_factory.mktemp("secp_kernel"),
                                 "secp256k1.cu", _RUNNER)


def _on_host(lib, e, r, s, v, valid):
    n, nl = r.shape
    out = [np.zeros((n, nl), np.int32), np.zeros((n, nl), np.int32),
           np.zeros(n, np.uint8)]
    arrs = [np.ascontiguousarray(a) for a in
            (e, r, s, v, valid.astype(np.uint8))]
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.run(*map(ptr, arrs), n, nl, *map(ptr, out))
    return out[0], out[1], out[2].astype(bool)


@pytest.mark.parametrize("nl", [25, 22])
def test_ecrecover_source_on_host_equals_plain(host_kernel, hostile,
                                               plain_out, nl):
    """Every row, hostile ones and R = ±G included, at the wide form's 25
    limbs and the exact form's 22 (the rows' values are below 2^256)."""
    _, (e, r, s, v, valid) = hostile
    got = _on_host(host_kernel, e[:, :nl], r[:, :nl], s[:, :nl], v, valid)
    qx, qy, ok = plain_out
    assert (got[0] == qx[:, :nl]).all() and (got[1] == qy[:, :nl]).all()
    assert (got[2] == ok).all()


@pytest.mark.parametrize("n", [1, 3, 7, 17, 112, 113])
def test_ecrecover_source_on_host_at_row_counts(host_kernel, hostile,
                                                plain_out, n):
    """Row counts that leave a warp (4 rows) or a block (8 rows) part
    full: one row, one less than a warp, one less than a block, two blocks
    and one, and the notary's 112 and 113; the hostile rows repeated
    (each row's outputs are its own, so the plain outputs repeat too)."""
    _, planes = hostile
    take = np.arange(n) % len(planes[0])
    got = _on_host(host_kernel, *(a[take] for a in planes))
    for g, w in zip(got, plain_out):
        assert (g == w[take]).all()


_FIELD_RUNNER = r"""
extern "C" void field(const unsigned* a, const unsigned* b, const int* k,
                      int n, unsigned* out) {
  for (int i = 0; i < n; ++i) {
    gs::Fe x, y;
    for (int j = 0; j < 8; ++j) {
      x.w[j] = a[8 * i + j];
      y.w[j] = b[8 * i + j];
    }
    const gs::Fe r[4] = {gs::fp_mul(x, y), gs::fp_sqr(x),
                         gs::fp_lin(x, (unsigned)k[2 * i], y, k[2 * i + 1]),
                         gs::fp_canon(x)};
    for (int f = 0; f < 4; ++f)
      for (int j = 0; j < 8; ++j) out[32 * i + 8 * f + j] = r[f].w[j];
  }
}"""


def test_field_source_on_host_equals_integers(tmp_path):
    """The kernel's arithmetic mod p against Python integers: fp_mul,
    fp_sqr and fp_lin below 2^256 and congruent, fp_canon below p, on
    every pair of edge values (0, 1, p - 1, p, p + 1, 2^256 - 1, ...) at
    the extreme coefficients and on seeded random pairs."""
    lib = torch_host_shim.build(tmp_path, "secp256k1.cu", _FIELD_RUNNER)
    P = ref.P
    rng = np.random.default_rng(11)
    rand = lambda bits: int.from_bytes(rng.bytes(32), "little") >> (256 - bits)
    edge = [0, 1, 2, P - 1, P, P + 1, 2 * P - (1 << 256) + 5, (1 << 256) - 1,
            (1 << 256) - (1 << 32), 1 << 255, (1 << 32) - 1]
    vals = edge + [rand(256) for _ in range(64)] \
        + [(1 << 256) - 1 - rand(40) for _ in range(16)]
    pairs = [(x, y, 15, k2) for x in edge for y in edge for k2 in (-15, 15)]
    pairs += [(vals[i], vals[j], int(k1), int(k2)) for i, j, k1, k2 in zip(
        rng.integers(0, len(vals), 1000), rng.integers(0, len(vals), 1000),
        rng.integers(0, 16, 1000), rng.integers(-15, 16, 1000))]
    words = lambda v: [(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    a = np.array([words(x) for x, _, _, _ in pairs], np.uint32)
    b = np.array([words(y) for _, y, _, _ in pairs], np.uint32)
    k = np.array([(k1, k2) for _, _, k1, k2 in pairs], np.int32)
    out = np.zeros((len(pairs), 4, 8), np.uint32)
    ptr = lambda arr: ctypes.c_void_p(arr.ctypes.data)
    lib.field(ptr(a), ptr(b), ptr(k), len(pairs), ptr(out))
    for (x, y, k1, k2), got in zip(pairs, out):
        mul, sqr, lin, canon = (sum(int(w) << (32 * j)
                                    for j, w in enumerate(r)) for r in got)
        assert mul % P == x * y % P and sqr % P == x * x % P
        assert lin % P == (k1 * x + k2 * y) % P
        assert canon == x % P


def test_kernel_products_count_the_ladder():
    """The bound's (squares, products) count: the fixed part, then a
    doubling (5 squares, 2 products) and an addition (3 + 8 with addend G
    or R, 4 + 12 with G + R) per step after the top set bit."""
    fsq, fpr = sk.FIXED_PRODUCTS
    assert fsq + fpr == 33 + sum(
        e.bit_length() - 2 + bin(e).count("1")
        for e in ((sk.P + 1) // 4, sk.N - 2, sk.P - 2))
    assert sk.kernel_products(0, 0) == (fsq, fpr)
    assert sk.kernel_products(1, 0) == (fsq, fpr)     # a copy, no work
    assert sk.kernel_products(0b101, 0) == (fsq + 2 * 5 + 3,
                                            fpr + 2 * 2 + 8)
    assert sk.kernel_products(0b11, 0b11) == (fsq + 5 + 4, fpr + 2 + 12)
    assert sk.kernel_multiply_adds(0b11, 0b11) == (
        (fsq + 9) * 100 + (fpr + 14) * 128)


def test_least_products_count_the_function():
    """The bound's least work: r^3, the root's addition chain (253 squares
    and 13 products for (p + 1)/4), the curve check, G + R and the affine
    map, no products for the inverses, then the yardstick's ladder; 74
    multiply-adds a product and 46 a square mod p (the special form's
    fold, 8 + 2), two CIOS products mod n."""
    assert sk.SQRT_CHAIN == (253, 13)
    fsq, fpr = sk.LEAST_FIXED_PRODUCTS
    assert (fsq, fpr) == (1 + 253 + 1 + 3 + 1, 1 + 13 + 8 + 3)
    assert sk.least_products(0, 0) == (fsq, fpr)
    assert sk.least_products(1, 0) == (fsq, fpr)
    assert sk.least_products(0b11, 0b11) == (fsq + 5 + 4, fpr + 2 + 12)
    assert sk.least_multiply_adds(0b11, 0b11) == (
        (fsq + 9) * 46 + (fpr + 14) * 74 + 2 * 128)


def test_least_work_is_below_the_yardstick():
    """Both counts walk the same ladder; the least work is below the
    yardstick on every row, by ~2.4x on a full-width one."""
    rng = np.random.default_rng(11)
    scalars = [(0, 0), (1, 0), (0, sk.N - 1), (sk.N - 1, sk.N - 1)] + [
        sk.ladder_scalars(*(int.from_bytes(rng.bytes(32), "big")
                            for _ in range(3))) for _ in range(8)]
    ysq, ypr = sk.FIXED_PRODUCTS
    lsq, lpr = sk.LEAST_FIXED_PRODUCTS
    for u1, u2 in scalars:
        sq, pr = sk.kernel_products(u1, u2)
        assert sk.least_products(u1, u2) == (sq - ysq + lsq, pr - ypr + lpr)
        assert sk.least_multiply_adds(u1, u2) < sk.kernel_multiply_adds(
            u1, u2)
    ratio = (sk.kernel_multiply_adds(*scalars[-1])
             / sk.least_multiply_adds(*scalars[-1]))
    assert 2.0 < ratio < 3.0


def test_clock_marks_are_in_the_source():
    """scripts/torch_secp_clocks.py reads the stages at SECP_CLOCK(0..6):
    each is in the source once, and the macro is empty unless the source
    is built with SECP_CLOCKS."""
    src = (torch_host_shim.SRC_DIR / "secp256k1.cu").read_text()
    for i in range(7):
        assert src.count(f"SECP_CLOCK({i});") == 1, i
    assert re.search(r"#ifdef SECP_CLOCKS\n__device__ long long g_clk\[8\];",
                     src)


# == 4. the backend ==========================================================


def _hostile_sigs65():
    """(digests, sigs65, labels) of the backend case: the kernel-level
    rows as wire signatures (recid 2 goes to the host fallback, 5 is
    None), then the probes of ROADMAP.md §C on the first valid signature:
    high s with v flipped (the same key), v = 27, recid 3, 64- and
    66-byte signatures, and 0-, 31- and 33-byte digests. 32 rows: bucket
    32, the reference ladder's compile above."""
    digests, sigs, labels = [], [], []
    for msg, (rr, ss, vv), label in _hostile_rows():
        digests.append(msg)
        sigs.append(ref.Signature(rr, ss, vv).to_bytes65())
        labels.append(label)
    _, msg, sig = _signed(0)
    wire = sig.to_bytes65()
    probes = [
        (msg, ref.Signature(sig.r, ref.N - sig.s, sig.v ^ 1).to_bytes65(),
         "high s, v flipped"),
        (msg, wire[:64] + bytes([27]), "v = 27"),
        (msg, wire[:64] + bytes([3]), "recid 3"),
        (msg, wire[:64], "64-byte signature"),
        (msg, wire + b"\x00", "66-byte signature"),
        (b"", wire, "0-byte digest"),
        (msg[:31], wire, "31-byte digest"),
        (msg + b"\x01", wire, "33-byte digest"),
    ]
    for d, sg, label in probes:
        digests.append(d)
        sigs.append(sg)
        labels.append(label)
    return digests, sigs, labels


def test_backend_recovers_as_the_reference_backends():
    digests, sigs, labels = _hostile_sigs65()
    want = ref_get_backend("python").ecrecover_addresses(digests, sigs)
    assert [l for l, a in zip(labels, want) if a is not None] == [
        "valid", "valid", "valid", "valid", "tampered", "digest 0",
        "digest n", "digest 2^256 - 1", "R = G", "R = -G", "meets G + R",
        "meets R", "high s, v flipped", "0-byte digest", "31-byte digest",
        "33-byte digest"]
    assert want[labels.index("high s, v flipped")] == want[0]
    assert ref_get_backend("jax").ecrecover_addresses(digests, sigs) == want
    backend = TorchSigBackend(device="cpu")
    got = backend.ecrecover_addresses(digests, sigs)
    assert [(l, a) for l, a in zip(labels, got)] == \
        [(l, a) for l, a in zip(labels, want)]
    assert all(a is None or isinstance(a, bytes) and len(a) == 20
               for a in got)
    assert backend.last_timing["rows"] == 32
    assert backend.last_timing["bucket"] == 32
    assert backend.last_timing["host_rows"] == 2   # recid 2 and 3


def test_backend_empty_and_one_row_batches():
    backend = TorchSigBackend(device="cpu")
    assert backend.ecrecover_addresses([], []) == []
    _, msg, sig = _signed(7)
    want = ref_get_backend("python").ecrecover_addresses(
        [msg], [sig.to_bytes65()])
    assert want[0] is not None
    assert backend.ecrecover_addresses([msg], [sig.to_bytes65()]) == want
    assert backend.last_timing["bucket"] == 1
