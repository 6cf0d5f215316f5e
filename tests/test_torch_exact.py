"""The port's exact 22-limb form against the JAX package's, limb for limb.

Both packages read their limb form at import, so every case runs in one
fresh interpreter with both knobs set, `GETHSHARDING_TORCH_LIMB_FORM=exact`
for the port and `GETHSHARDING_TPU_LIMB_FORM=exact` for the reference
oracle (as tests/test_knob_combos.py runs the reference's knob
combinations). The script below runs each check there and reports it by
name; each test reads its own check. Inputs are made with numpy from a
seed; integer arithmetic has no rounding, so every comparison is exact.

The checks: the port's exact `normalize_plain` against the reference's
`ModArith.normalize` (its XLA ladder) and `normalize_pallas` in interpret
mode (its Pallas branch) on random and bound-edge accumulators at every
width the audit gives; `canon`, `is_zero`, `eq`, `sub` and `neg` at p - 1,
p, 2p - 1 and the lazy bound; the converters, tables and pads; the audit
kernels' 22-limb boundaries; the recompute audit on
`TorchSigBackend(device="cpu", precomp=False)` against the reference's
`python` backend on the hostile fixture; what the exact form's kernels
refuse (25-limb operands, CPU tensors); the exact form's tower packs and
their widths (planes of 45 columns, xi pad of 23 limbs);
`precompute_g2_lines` and `miller_loop_precomp` against the reference's
exact-form oracles; and the precomp audit on `TorchSigBackend(device=
"cpu")`, cold and warm, against the `python` backend, with no G2 bytes
shipped warm. In the `slow` tier, the Miller product f against the
reference's exact-form oracle."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (22, 25, 43, 49, 52)

_SCRIPT = r'''
import json, sys, traceback
import numpy as np
import jax.numpy as jnp
import torch

from gethsharding_tpu.crypto import bn256 as ref
from gethsharding_tpu.ops import bn256_jax as k
from gethsharding_tpu.ops import limb as rlimb
from gethsharding_tpu.ops import pallas_finalexp as m
from gethsharding_tpu.ops.pallas_norm import normalize_pallas
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.ops import bn256 as pbn
from gethsharding_tpu_torch.ops import _build, conv, limb, norm, tower
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

P = ref.P
REF_FP = k.FP
WIDTHS = (22, 25, 43, 49, 52)
EDGE = int(2 ** 30.7) - 1
t, j = torch.as_tensor, jnp.asarray
results = {}


def check(name):
    def run(fn):
        try:
            fn()
            results[name] = None
        except BaseException:
            results[name] = traceback.format_exc()[-3000:]
        return fn
    return run


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert (got == want).all(), np.argwhere(got != want)[:5]


def accumulators(width, seed):
    """Random rows with negative limbs, bound-edge rows (every limb at
    +-(2^30.7 - 1)), rows of -1 limbs, all with value >= 0."""
    rng = np.random.default_rng(seed)
    z = rng.integers(-EDGE, EDGE + 1, (12, width)).astype(np.int64)
    z[:, -1] = np.abs(z[:, -1]) + (1 << 29)
    z[4:8] = np.where(rng.integers(0, 2, (4, width)) == 1, EDGE, -EDGE)
    z[4:8, -1] = EDGE
    z[8] = EDGE
    z[9] = -1
    z[9, -1] = 1
    z[10] = rng.integers(0, 1 << 12, width)
    z[11] = 0
    return z.astype(np.int32)


@check("forms")
def _():
    assert limb.LIMB_FORM == rlimb.LIMB_FORM == "exact"
    assert (limb.NLIMBS, limb.LAZY_BITS) == (rlimb.NLIMBS, rlimb.LAZY_BITS) \
        == (22, 264)
    assert norm.KERNEL.name == "norm_exact"


for width in WIDTHS:
    @check(f"normalize-{width}")
    def _(width=width):
        z = accumulators(width, 600 + width)
        want = np.asarray(REF_FP.normalize(j(z)))
        assert want.shape == (12, 22)
        same(normalize_pallas(REF_FP, j(z), interpret=True), want)
        same(norm.normalize_plain(pbn.FP, t(z)), want)
        same(pbn.FP.normalize(t(z).reshape(3, 4, width)),
             want.reshape(3, 4, 22))


@check("int-limbs")
def _():
    rng = np.random.default_rng(61)
    vals = [int.from_bytes(rng.bytes(33), "little") for _ in range(40)]
    vals += [0, 1, P - 1, P, (1 << 264) - 1]
    arr = limb.ints_to_limbs(vals)
    assert arr.shape == (len(vals), 22)
    same(arr, rlimb.ints_to_limbs(vals))
    assert list(limb.limbs_to_int(arr)) == vals
    same(limb.int_to_limbs(P - 1), rlimb.int_to_limbs(P - 1))
    for bad in (lambda: limb.int_to_limbs(1 << 264),
                lambda: limb.ints_to_limbs([1 << 264])):
        try:
            bad()
        except ValueError:
            continue
        raise AssertionError("a 265-bit value fit in 22 limbs")


@check("canon-is_zero-eq-sub-neg")
def _():
    rng = np.random.default_rng(62)
    vals = [int.from_bytes(rng.bytes(33), "little") for _ in range(10)]
    vals += [0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, (1 << 264) - 1]
    x = limb.ints_to_limbs(vals)
    y = np.roll(x, 1, axis=0)
    same(pbn.FP.canon(t(x)), REF_FP.canon(j(x)))
    assert limb.limbs_to_int(pbn.FP.canon(t(x))).tolist() == \
        [v % P for v in vals]
    same(pbn.FP.is_zero(t(x)), REF_FP.is_zero(j(x)))
    assert int(pbn.FP.is_zero(t(x)).sum()) == 3       # 0, P, 2P
    same(pbn.FP.eq(t(x), t(y)), REF_FP.eq(j(x), j(y)))
    same(pbn.FP.sub(t(x), t(y)), REF_FP.sub(j(x), j(y)))
    same(pbn.FP.neg(t(x)), REF_FP.neg(j(x)))
    same(pbn.FP.add(t(x), t(y)), REF_FP.add(j(x), j(y)))
    same(pbn.FP.mul(t(x), t(y)), REF_FP.mul(j(x), j(y)))


@check("constants")
def _():
    for name in ("fold_j", "lift", "sub_pad"):
        same(getattr(pbn.FP, name), getattr(REF_FP, name))
    for bits in (529, 264, 547):
        same(pbn.FP.pad_mult(bits), REF_FP.pad_mult(bits))
    for name in ("_PAD530", "_PAD266", "FP12_ONE", "_FP2_PAD", "_GEN_LINES",
                 "_TWF_X", "_B3_G2_LIMBS"):
        same(getattr(pbn, name), getattr(k, name))
    same(pbn._GROUP_PAD[3], k._group_pad(3))
    assert pbn.LINE_TABLE_SHAPE == k.LINE_TABLE_SHAPE == (88, 3, 2, 22)
    bad = convert.mismatched_tables(convert.reference_tables(m, k),
                                    convert.port_tables())
    assert not bad, bad


@check("tower-ops")
def _():
    rng = np.random.default_rng(63)
    lazy = lambda shape: rng.integers(0, 1 << 12, shape + (22,)).astype(
        np.int32)
    x2, y2, x12 = lazy((3, 2)), lazy((3, 2)), lazy((3, 6, 2))
    same(pbn.fp2_sub(t(x2), t(y2)), k.fp2_sub(j(x2), j(y2)))
    same(pbn.fp2_neg(t(x2)), k.fp2_neg(j(x2)))
    same(pbn.fp2_conj(t(x2)), k.fp2_conj(j(x2)))
    same(pbn.fp2_is_zero(t(x2)), k.fp2_is_zero(j(x2)))
    same(pbn.fp12_conj(t(x12)), k.fp12_conj(j(x12)))


def committee(tag, n):
    keys = [ref.bls_keygen(tag + bytes([i])) for i in range(n)]
    return [ref.bls_sign(tag, sk) for sk, _ in keys], [pk for _, pk in keys]


@check("converters")
def _():
    sigs, pks = committee(b"exact-conv", 3)
    rows = [sigs, sigs[:2] + [None], []]
    for got, want in zip(pbn.g1_to_limbs(sigs + [None]),
                         k.g1_to_limbs(sigs + [None])):
        same(got, want)
    for got, want in zip(pbn.g1_committee_to_limbs(rows, 4),
                         k.g1_committee_to_limbs(rows, 4)):
        same(got, want)
    prow = [pks, pks[:1], []]
    for got, want in zip(pbn.g2_committee_to_limbs(prow, 4),
                         k.g2_committee_to_limbs(prow, 4)):
        same(got, want)


def affine(X, Y, Z, fp2):
    """A projective sum (22-limb tensors) as the scalar reference's point."""
    ints = lambda v: limb.limbs_to_int(pbn.FP.canon(v)).tolist()
    if fp2:
        X, Y, Z = ([ref.Fp2(a, b) for a, b in ints(v)] for v in (X, Y, Z))
        out = []
        for x, y, z in zip(X, Y, Z):
            zi = z.inv()
            out.append((x * zi, y * zi))
        return [(px.a, px.b, py.a, py.b) for px, py in out]
    X, Y, Z = (ints(v) for v in (X, Y, Z))
    return [(x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)
            for x, y, z in zip(X, Y, Z)]


@check("kernel-boundaries")
def _():
    sigs, pks = committee(b"exact-agg", 3)
    sx, sy, sm = pbn.g1_committee_to_limbs([sigs, sigs[1:]], 3)
    g1 = mk.aggregate_proj(t(sx), t(sy), t(sm), fp2=False)
    assert all(v.shape == (2, 22) for v in g1)
    want = [ref.g1_add(ref.g1_add(sigs[0], sigs[1]), sigs[2]),
            ref.g1_add(sigs[1], sigs[2])]
    assert affine(*g1, fp2=False) == [(x % P, y % P) for x, y in want]
    gx, gy, gm = pbn.g2_committee_to_limbs([pks, pks[:2]], 3)
    g2 = mk.aggregate_proj(t(gx), t(gy), t(gm), fp2=True)
    assert all(v.shape == (2, 2, 22) for v in g2)
    want = [ref.g2_add(ref.g2_add(pks[0], pks[1]), pks[2]),
            ref.g2_add(pks[0], pks[1])]
    assert affine(*g2, fp2=True) == [(x.a, x.b, y.a, y.b) for x, y in want]


def hostile_workload():
    """4 rows x 4 votes: valid, a forged vote, an empty committee, and a
    row whose message was swapped for another shard's."""
    keys = [ref.bls_keygen(b"exact-%d" % i) for i in range(4)]
    msgs = [b"exact-header-%d" % s for s in range(4)]
    sig_rows = [[ref.bls_sign(msg, sk) for sk, _ in keys] for msg in msgs]
    pk_rows = [[pk for _, pk in keys] for _ in msgs]
    sig_rows[1][2] = ref.g1_add(sig_rows[1][2], ref.G1_GEN)
    sig_rows[2], pk_rows[2] = [], []
    msgs[3] = msgs[0]
    return msgs, sig_rows, pk_rows


@check("audit")
def _():
    msgs, sig_rows, pk_rows = hostile_workload()
    want = ref_get_backend("python").bls_verify_committees(
        msgs, sig_rows, pk_rows)
    assert want == [True, False, False, False]
    backend = TorchSigBackend(device="cpu", precomp=False)
    got = backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                        pk_row_keys=[b"a", b"b", b"c", b"d"])
    assert got == want, got
    timing = backend.last_timing
    assert timing["limb_form"] == "exact" and not timing["precomp"]


@check("refusals")
def _():
    """What the exact form's kernels still refuse: the other form's
    25-limb operands, and CPU tensors (whose route is the plain version),
    before anything launches."""
    before = _build.launch_counts()
    w = torch.zeros((3, 1, 2, 25), dtype=torch.int32)
    for run in (lambda: tower.tower_kernel(pbn._FP2_MUL, w, w),
                lambda: conv.conv_kernel(w, w, pbn._COMB_FP2)):
        try:
            run()
        except ValueError as exc:
            assert "exact limb form takes 22" in str(exc), exc
        else:
            raise AssertionError("a kernel took 25-limb operands")
    u = torch.zeros((3, 1, 2, 22), dtype=torch.int32)
    for run in (lambda: tower.tower_kernel(pbn._FP2_MUL, u, u),
                lambda: conv.conv_kernel(u, u, pbn._COMB_FP2)):
        try:
            run()
        except ValueError as exc:
            assert "CUDA" in str(exc), exc
        else:
            raise AssertionError("a kernel took a CPU tensor")
    assert _build.launch_counts() == before


@check("plan-packs")
def _():
    assert tower.KERNEL.name == "tower_exact" and conv.KERNEL.name == \
        "conv_exact"
    assert (tower.ACC_W, tower.XI_W) == (45, 23)
    assert (pbn._ACC_W, pbn._FP2_W, pbn._PAD266.shape[0]) == (45, 45, 23)
    assert pbn.FP.mul_plan.acc_w == conv.NCOLS == 43
    for plan, pad in ((pbn._FP2_MUL, pbn._FP2_PAD[:, None]),
                      (pbn._FP12_MUL, pbn._GROUP_PAD[3]),
                      (pbn._LINE_MUL, pbn._GROUP_PAD[2])):
        assert plan.acc_w == 45
        C, Gr = pad.shape[:2]
        # [width] fold (33, 22) lift (22) xi pad (23) pads (C, Gr, 45) ...
        at = 1 + 33 * 22 + 22
        xi = plan.pack[at:at + 23]
        same(xi, pbn._PAD266 if plan.kind != tower.FP2
             else np.zeros(23, np.int32))
        pads = plan.pack[at + 23:at + 23 + C * Gr * 45]
        same(pads.reshape(C, Gr, 45), pad)
        assert plan.pack[0] == 45
        assert plan.u_block[-1] == plan.v_block[-1] == plan.out_block[-1] \
            == 22


def lazy(rng, shape):
    """Lazy exact-form elements: canonical limbs, value < 2^264."""
    vals = [int.from_bytes(rng.bytes(33), "little")
            for _ in range(int(np.prod(shape)))]
    return limb.ints_to_limbs(vals).reshape(shape + (22,))


PRECOMP = {}


@check("precomp-tables")
def _():
    """precompute_g2_lines: the committee sums are the scalar reference's
    points, the identity sums are flagged, and the tables equal the
    reference's exact-form `precompute_lines` on the same sums mod p (as
    the wide form's tests/test_torch_tower.py holds them)."""
    _, pks = committee(b"exact-precomp", 3)
    rows = [pks, pks[:2], [], [pks[0], ref.g2_neg(pks[0])]]
    gx, gy, gm = pbn.g2_committee_to_limbs(rows, 3)
    table, inf = pbn.precompute_g2_lines(t(gx), t(gy), t(gm))
    assert table.shape == (4, 88, 3, 2, 22)
    assert inf.tolist() == [False, False, True, True]
    pk = mk.aggregate_proj(t(gx), t(gy), t(gm), fp2=True)
    want_pts = [ref.g2_add(ref.g2_add(pks[0], pks[1]), pks[2]),
                ref.g2_add(pks[0], pks[1])]
    assert affine(*(v[:2] for v in pk), fp2=True) == \
        [(x.a, x.b, y.a, y.b) for x, y in want_pts]
    want = k.precompute_lines(*(j(v.numpy()) for v in pk))
    same(pbn.FP.canon(table), REF_FP.canon(want))
    PRECOMP["table"] = table


@check("miller-precomp")
def _():
    """miller_loop_precomp on an exact-form table against the reference's
    exact-form `miller_loop_precomp`, limb for limb."""
    table = PRECOMP["table"]
    rng = np.random.default_rng(65)
    sig = tuple(lazy(rng, (4,)) for _ in range(3))
    hx, hy = lazy(rng, (4,)), lazy(rng, (4,))
    want = k.miller_loop_precomp(tuple(map(j, sig)), j(hx), j(hy),
                                 j(table.numpy()))
    got = pbn.miller_loop_precomp(tuple(map(t, sig)), t(hx), t(hy), table)
    assert got.shape == (4, 6, 2, 22)
    same(got, want)


@check("precomp-audit")
def _():
    """TorchSigBackend(device="cpu") in the exact form takes the precomp
    path by default: cold and warm verdicts of the reference's `python`
    backend, 22-limb tables in the cache, no G2 bytes on a warm audit."""
    msgs, sig_rows, pk_rows = hostile_workload()
    # tests/test_torch_precomp.py's two more hostile rows: a missing
    # signature whose pubkey is kept, and votes and pubkeys that cancel
    sigs, pks = committee(b"exact-precomp-more", 2)
    msgs += [b"exact-header-4", b"exact-header-5"]
    sig_rows += [[ref.bls_sign(msgs[4], ref.bls_keygen(b"exact-0")[0]),
                  None], [sigs[0], ref.g1_neg(sigs[0])]]
    pk_rows += [[pk_rows[0][0], pk_rows[0][1]], [pks[0], ref.g2_neg(pks[0])]]
    want = ref_get_backend("python").bls_verify_committees(
        msgs, sig_rows, pk_rows)
    assert want == [True, False, False, False, False, False]
    backend = TorchSigBackend(device="cpu")
    assert backend.precomp
    keys = [("exact", s) for s in range(6)]
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=keys) == want
    cold = backend.last_timing
    assert cold["precomp"] and cold["limb_form"] == "exact"
    assert cold["g2_wire_bytes"] > 0 and cold["hit_rows"] == 0
    assert len(backend.lines) == 5
    assert backend.lines.bytes == 5 * (88 * 3 * 2 * 22 * 4 + 1)
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=keys) == want
    warm = backend.last_timing
    assert warm["g2_wire_bytes"] == 0 and warm["hit_rows"] == 5
    assert warm["memo"]


if "--slow" in sys.argv:
    @check("miller-oracle")
    def _():
        sigs, pks = committee(b"exact-miller", 3)
        bad = [sigs[0], sigs[1], ref.g1_add(sigs[2], ref.G1_GEN)]
        hx, hy, _ = pbn.g1_to_limbs([ref.hash_to_g1(b"exact-miller")] * 2)
        sx, sy, sm = pbn.g1_committee_to_limbs([sigs, bad], 3)
        gx, gy, gm = pbn.g2_committee_to_limbs([pks, pks], 3)
        sig = mk.aggregate_proj(t(sx), t(sy), t(sm), fp2=False)
        pk = mk.aggregate_proj(t(gx), t(gy), t(gm), fp2=True)
        got = mk.miller_f(sig, t(hx), t(hy), pk)
        wide = lambda v: np.pad(np.asarray(v),
                                [(0, 0)] * (v.dim() - 1) + [(0, 3)])
        raw = m.run_miller_xla(tuple(map(wide, sig)),
                               (wide(t(hx)), wide(t(hy))),
                               tuple(map(wide, pk)))
        same(got, REF_FP.normalize(jnp.asarray(raw)))
        assert mk.finalexp_is_one(got).tolist() == [True, False]
        assert np.asarray(k.pairing_is_one(j(got.numpy()))).tolist() == \
            [True, False]

print("RESULTS " + json.dumps(results))
'''


def _run_checks(*flags):
    env = {key: val for key, val in os.environ.items()
           if not key.startswith(("GETHSHARDING_TPU_", "GETHSHARDING_TORCH_"))}
    env.update({"GETHSHARDING_TORCH_LIMB_FORM": "exact",
                "GETHSHARDING_TPU_LIMB_FORM": "exact",
                # one thread: the script's arrays are small, and the test
                # workers beside it keep their cores
                "OMP_NUM_THREADS": "1",
                "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                             "intra_op_parallelism_threads=1"})
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, *flags], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULTS ")]
    assert proc.returncode == 0 and lines, (proc.stdout[-2000:],
                                            proc.stderr[-3000:])
    return json.loads(lines[-1][len("RESULTS "):])


@pytest.fixture(scope="module")
def exact_checks():
    return _run_checks()


@pytest.mark.parametrize("name", ["forms"]
                         + [f"normalize-{w}" for w in WIDTHS]
                         + ["int-limbs", "canon-is_zero-eq-sub-neg",
                            "constants", "tower-ops", "converters",
                            "kernel-boundaries", "audit", "refusals",
                            "plan-packs", "precomp-tables", "miller-precomp",
                            "precomp-audit"])
def test_exact_form_matches_reference(exact_checks, name):
    assert name in exact_checks, sorted(exact_checks)
    assert exact_checks[name] is None, exact_checks[name]


@pytest.mark.slow
def test_exact_miller_f_equals_reference_oracle():
    checks = _run_checks("--slow")
    assert checks["miller-oracle"] is None, checks["miller-oracle"]


def test_limb_form_knob_rejects_other_values():
    env = dict(os.environ, GETHSHARDING_TORCH_LIMB_FORM="narrow")
    proc = subprocess.run(
        [sys.executable, "-c", "import gethsharding_tpu_torch.ops.limb"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "GETHSHARDING_TORCH_LIMB_FORM" in proc.stderr
