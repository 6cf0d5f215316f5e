"""The port's audit kernels (gethsharding_tpu_torch/ops/megakernels.py)
against the JAX package's mega-kernels (gethsharding_tpu/ops/
pallas_finalexp.py):

1. every constant table and program is byte-equal to the reference's;
2. the plain helpers equal the reference helpers run as XLA ops on the
   CPU, limb for limb, on random quasi-canonical inputs (exact: integer
   arithmetic has no rounding);
3. the plain committee sums give the scalar reference's points;
4. the CUDA sources (the audit kernels, the tower's conv and normalize
   kernels, and the tower kernel that fuses them into one launch per
   product), compiled for the host with one thread per block, give the
   plain versions' limbs, and the tower kernel the reference's;
5. (slow) the plain Miller program and final exponentiation equal the
   reference's XLA oracles on real committee inputs.

The kernels on the card are held against the plain versions by
tests/test_torch_cuda.py and chip_smoke.py.

Inputs are made with numpy from a seed and fed to both sides. The
reference helpers take the batch on the minor axis; the port's on the
leading one, so the tests move that axis and compare like with like."""

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_host_shim
from gethsharding_tpu.crypto import bn256 as ref
from gethsharding_tpu.ops import bn256_jax as k
from gethsharding_tpu.ops import pallas_finalexp as m
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.ops import _build
from gethsharding_tpu_torch.ops import bn256 as pbn
from gethsharding_tpu_torch.ops import conv, norm, tower
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.ops.limb import limbs_to_int

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

REF_C = m.Consts(*(jnp.asarray(c) for c in m._NP_CONSTS))
PORT_C = mk.consts("cpu")


def _quasi(rng, shape):
    """Quasi-canonical limbs, as the relaxed normalize leaves them."""
    return rng.integers(-1, (1 << 12) + 65, shape + (25,)).astype(np.int32)


def _ref(x):
    """Batch-first numpy -> the reference's batch-on-lanes layout."""
    return jnp.asarray(np.moveaxis(x, 0, -1))


def _back(y):
    return np.moveaxis(np.asarray(y), -1, 0)


def _t(x):
    return torch.as_tensor(x)


def test_tables_byte_equal_to_reference():
    reference = convert.reference_tables(m, k)
    port = convert.port_tables()
    assert set(reference) == set(port)
    assert convert.mismatched_tables(reference, port) == []
    assert mk._PROGRAM.shape == (292, 4)
    assert mk._MILLER_OPS.shape == (88,)
    assert mk._MILLER_LINES.shape == (88, 3, 2, 25)
    assert mk._MILLER_TWF.shape == (4, 2, 25)


def _helper_cases(rng):
    x, y = _quasi(rng, (3, 6, 2)), _quasi(rng, (3, 6, 2))
    A, B, Cc = (_quasi(rng, (3, 2)) for _ in range(3))
    X, Y, Z = (_quasi(rng, (3, 2)) for _ in range(3))
    px, py = _quasi(rng, (3,)), _quasi(rng, (3,))
    cand = tuple(_quasi(rng, (3, 2)) for _ in range(5))
    z = rng.integers(-(1 << 29), 1 << 29, (5, 49)).astype(np.int32)
    z = z + np.pad(m._PAD547, (0, 3)).astype(np.int32)
    z[:, -3:] = np.abs(z[:, -3:])
    a, b = _quasi(rng, (4,)), _quasi(rng, (4,))
    return {
        "normalize": (lambda: m._normalize(_ref(z), REF_C),
                      lambda: mk._normalize(_t(z), PORT_C)),
        "conv": (lambda: m._conv(_ref(a), _ref(b)),
                 lambda: mk._conv(_t(a), _t(b))),
        "mul_xi": (lambda: m._mul_xi(_ref(x), REF_C),
                   lambda: mk._mul_xi(_t(x), PORT_C)),
        "fp12_mul": (lambda: m._fp12_mul(_ref(x), _ref(y), REF_C),
                     lambda: mk._fp12_mul(_t(x), _t(y), PORT_C)),
        "frob1": (lambda: m._frob(_ref(x), jnp.int32(1), REF_C),
                  lambda: mk._frob(_t(x), 1, PORT_C)),
        "frob2": (lambda: m._frob(_ref(x), jnp.int32(2), REF_C),
                  lambda: mk._frob(_t(x), 2, PORT_C)),
        "frob3": (lambda: m._frob(_ref(x), jnp.int32(3), REF_C),
                  lambda: mk._frob(_t(x), 3, PORT_C)),
        "fp12_mul_line": (
            lambda: m._fp12_mul_line(_ref(x), _ref(A), _ref(B), _ref(Cc),
                                     REF_C),
            lambda: mk._fp12_mul_line(_t(x), _t(A), _t(B), _t(Cc), PORT_C)),
        "dbl_step": (
            lambda: m._kernel_dbl_step(_ref(X), _ref(Y), _ref(Z), _ref(px),
                                       _ref(py), REF_C),
            lambda: mk._kernel_dbl_step(_t(X), _t(Y), _t(Z), _t(px),
                                        _t(py), PORT_C)),
        "jadd_step": (
            lambda: m._kernel_jadd_step(_ref(X), _ref(Y), _ref(Z),
                                        tuple(map(_ref, cand)), _ref(px),
                                        _ref(py), REF_C),
            lambda: mk._kernel_jadd_step(_t(X), _t(Y), _t(Z),
                                         tuple(map(_t, cand)), _t(px),
                                         _t(py), PORT_C)),
    }


def _flatten(out):
    if isinstance(out, tuple):
        return [v for part in out for v in _flatten(part)]
    return [out]


@pytest.mark.parametrize("name", ["normalize", "conv", "mul_xi", "fp12_mul",
                                  "frob1", "frob2", "frob3", "fp12_mul_line",
                                  "dbl_step", "jadd_step"])
def test_plain_helper_equals_reference(name):
    ref_fn, port_fn = _helper_cases(np.random.default_rng(81))[name]
    want = [_back(v) for v in _flatten(ref_fn())]
    got = [v.numpy() for v in _flatten(port_fn())]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        assert (g == w).all()
    if name not in ("conv",):   # relaxed outputs stay quasi-canonical
        assert min(g.min() for g in got) >= -1
        assert max(g.max() for g in got) <= (1 << 12) + 64


def _affine(X, Y, Z):
    """Projective limb tensors -> host affine ints (None at Z == 0)."""
    xs, ys, zs = (limbs_to_int(pbn.FP.canon(v).reshape(-1, 25))
                  for v in (X, Y, Z))
    out = []
    for x, y, z in zip(xs, ys, zs):
        if int(z) == 0:
            out.append(None)
        else:
            zi = pow(int(z), -1, ref.P)
            out.append((int(x) * zi % ref.P, int(y) * zi % ref.P))
    return out


def _affine2(X, Y, Z):
    """G2 projective limb tensors -> host affine ref.Fp2 pairs."""
    def ints(v):
        c = limbs_to_int(pbn.FP.canon(v).reshape(-1, 2, 25))
        return [ref.Fp2(int(a), int(b)) for a, b in c]
    out = []
    for x, y, z in zip(ints(X), ints(Y), ints(Z)):
        if z.is_zero():
            out.append(None)
        else:
            zi = z.inv()
            out.append((x * zi, y * zi))
    return out


def _committee(tag: bytes, n: int):
    keys = [ref.bls_keygen(tag + bytes([j])) for j in range(n)]
    return [ref.bls_sign(tag, sk) for sk, _ in keys], [pk for _, pk in keys]


def _agg_rows():
    """A full 5-slot committee, a partly masked one, an empty one."""
    sigs, pks = _committee(b"agg-port", 5)
    sig_rows = [sigs, [sigs[0], None, sigs[2], None, sigs[4]], []]
    return sig_rows, [pks, pks[:3], []]


def test_plain_aggregate_equals_scalar_reference():
    sig_rows, pk_rows = _agg_rows()
    sx, sy, sm = pbn.g1_committee_to_limbs(sig_rows, 5)
    gx, gy, gm = pbn.g2_committee_to_limbs(pk_rows, 5)
    g1 = mk.aggregate_proj(_t(sx), _t(sy), _t(sm), fp2=False)
    g2 = mk.aggregate_proj(_t(gx), _t(gy), _t(gm), fp2=True)
    assert _affine(*g1) == [ref.bls_aggregate_sigs([s for s in r if s])
                            for r in sig_rows]
    assert _affine2(*g2) == [ref.bls_aggregate_pks(r) for r in pk_rows]


@pytest.mark.slow
def test_plain_aggregate_equals_reference_xla_sum():
    """The JAX package's XLA committee sum (eager: ~50 s here) reaches the
    same rational points."""
    sig_rows, _ = _agg_rows()
    sx, sy, sm = pbn.g1_committee_to_limbs(sig_rows, 5)
    g1 = mk.aggregate_proj(_t(sx), _t(sy), _t(sm), fp2=False)
    want = k.aggregate_g1_proj(jnp.asarray(sx), jnp.asarray(sy),
                               jnp.asarray(sm))
    assert _affine(*(_t(np.array(v)) for v in want)) == _affine(*g1)


def test_convert_widens_exact_planes():
    rng = np.random.default_rng(82)
    p22 = rng.integers(0, 1 << 12, (3, 2, 22)).astype(np.uint16)
    got = convert.to_port(p22, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 2, 25)
    assert (got[..., :22].numpy() == p22).all()
    assert (got[..., 22:] == 0).all()
    p25 = rng.integers(0, 1 << 12, (4, 25)).astype(np.int32)
    assert (convert.to_port(p25, device="cpu").numpy() == p25).all()
    with pytest.raises(ValueError):
        convert.to_port(np.zeros((2, 24), np.int32), device="cpu")


# == the CUDA sources, run on the host =====================================
# One block of one thread: every phase's work items run in order in that
# thread and __syncthreads() is a no-op, which is a legal schedule of the
# kernels' block-cooperative loops. Blocks run one after another, so of
# the blocks that meet through a counter the last in order finishes last.
# This checks the kernels' arithmetic and indexing here, where no card
# is; the card itself is checked by the cuda tests below and by
# chip_smoke.py.

_SHIM = torch_host_shim.SHIM

_DRIVERS = {
    "agg": r"""
namespace gs { int smem[1 << 16]; }
extern "C" void run(int fp2, const int* xs, const int* ys, const int* mask,
                    int n, int C, int cp, int ns, int pairs,
                    const int* consts, int* partial, int* counter, int* ox,
                    int* oy, int* oz) {
  for (int b = 0; b < n * ns; ++b) {
    blockIdx.x = b;
    if (fp2)
      gs::agg_kernel<2>(xs, ys, mask, C, cp, ns, pairs, consts, partial,
                        counter, ox, oy, oz);
    else
      gs::agg_kernel<1>(xs, ys, mask, C, cp, ns, pairs, consts, partial,
                        counter, ox, oy, oz);
  }
}""",
    "miller": r"""
namespace gs { int smem[1 << 16]; }
extern "C" void run(const int* sx, const int* sy, const int* sz,
                    const int* hx, const int* hy, const int* pkx,
                    const int* pky, const int* pkz, const int* ops, int nops,
                    const int* lines, const int* twf, const int* consts,
                    int n, int* out) {
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    gs::miller_kernel(sx, sy, sz, hx, hy, pkx, pky, pkz, ops, nops, lines,
                      twf, consts, out);
  }
}""",
    "finalexp": r"""
namespace gs { int smem[1 << 16]; }
extern "C" void run(const int* nd, const int* prog, int nsteps,
                    const int* consts, int n, int* out) {
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    gs::finalexp_kernel(nd, prog, nsteps, consts, out);
  }
}""",
    "norm": r"""
template <gs::NormForm F>
static void run_form(const int* z, long long n, int w, const int* fold,
                     const int* lift, int* out) {
  for (long long b = 0; b * gs::NORM_ROWS < n; ++b) {
    blockIdx.x = b;
    if (w <= 25) gs::norm_kernel<25, F>(z, n, w, fold, lift, out);
    else if (w == 26) gs::norm_kernel<26, F>(z, n, w, fold, lift, out);
    else if (w <= 49) gs::norm_kernel<49, F>(z, n, w, fold, lift, out);
    else gs::norm_kernel<52, F>(z, n, w, fold, lift, out);
  }
}
extern "C" void run(const int* z, long long n, int w, int form,
                    const int* fold, const int* lift, int* out) {
  if (form == gs::NORM_EXACT) run_form<gs::NORM_EXACT>(z, n, w, fold, lift, out);
  else run_form<gs::NORM_WIDE>(z, n, w, fold, lift, out);
}""",
    "conv": r"""
namespace gs { int smem[1 << 16] __attribute__((aligned(16))); }
extern "C" void run(const int* x, const int* y, long long n, int nl, int xv,
                    int yv, int a_dim, int b_dim, const int* plan,
                    int planes, int nterms, int rpb, int ndim,
                    const long long* desc, int* out) {
  const gs::ConvLead lead = gs::conv_lead(ndim, desc);
  for (long long b = 0; b * rpb < n; ++b) {
    blockIdx.x = b;
    if (nl == 22)
      gs::conv_kernel<22>(x, y, n, xv, yv, a_dim, b_dim, plan, planes,
                          nterms, rpb, lead, out);
    else
      gs::conv_kernel<25>(x, y, n, xv, yv, a_dim, b_dim, plan, planes,
                          nterms, rpb, lead, out);
  }
}""",
    "tower": r"""
template <int KIND, gs::NormForm F>
static void run_kind(const int* u, const int* v, long long n,
                     const gs::ConvLead& lead, const int* pack, int nterms,
                     int* out) {
  using S = gs::TowerShape<KIND>;
  for (long long b = 0; b < (n + S::ROWS - 1) / S::ROWS; ++b) {
    blockIdx.x = b;
    gs::tower_kernel<KIND, F>(u, v, n, lead, pack, nterms, out);
  }
}
template <gs::NormForm F>
static void run_form(int kind, const int* u, const int* v, long long n,
                     const gs::ConvLead& lead, const int* pack, int nterms,
                     int* out) {
  switch (kind) {
    case gs::TOWER_FP: run_kind<gs::TOWER_FP, F>(u, v, n, lead, pack, nterms, out); break;
    case gs::TOWER_FP2: run_kind<gs::TOWER_FP2, F>(u, v, n, lead, pack, nterms, out); break;
    case gs::TOWER_FP12: run_kind<gs::TOWER_FP12, F>(u, v, n, lead, pack, nterms, out); break;
    case gs::TOWER_LINE: run_kind<gs::TOWER_LINE, F>(u, v, n, lead, pack, nterms, out); break;
  }
}
extern "C" void run(int kind, int form, const int* u, const int* v,
                    long long n, int ndim, const long long* desc,
                    const int* pack, int nterms, int* out) {
  const gs::ConvLead lead = gs::conv_lead(ndim, desc);
  if (form == gs::NORM_EXACT)
    run_form<gs::NORM_EXACT>(kind, u, v, n, lead, pack, nterms, out);
  else
    run_form<gs::NORM_WIDE>(kind, u, v, n, lead, pack, nterms, out);
}""",
}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    tmp = tmp_path_factory.mktemp("host_kernels")
    (tmp / "shim.h").write_text(_SHIM)

    def compile_one(name):
        src = tmp / f"{name}.cpp"
        src.write_text(f'#include "{_build.SRC_DIR / (name + ".cu")}"\n'
                       + _DRIVERS[name])
        lib = tmp / f"lib{name}.so"
        subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                        "-include", str(tmp / "shim.h"), str(src), "-o",
                        str(lib)], check=True, capture_output=True)
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(_DRIVERS)) as pool:
        return dict(pool.map(compile_one, _DRIVERS))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _canon(rng, shape):
    return torch.as_tensor(rng.integers(0, 1 << 12, shape + (25,))
                           .astype(np.int32))


def _agg_inputs(rng, n, cdim, fp2):
    """Committee planes of quasi-canonical limbs with slots at the edges
    (every limb 4095, 4160 or -1) and a mask of three kinds: row 0 all
    on, row 1 all off, the other rows with holes."""
    point = (n, cdim) + ((2,) if fp2 else ())
    xs, ys = _quasi(rng, point), _quasi(rng, point)
    for j, limb in enumerate((4095, (1 << 12) + 64, -1)):
        xs[:, j::7] = limb
        ys[:, (j + 3)::7] = limb
    mask = rng.integers(0, 2, (n, cdim)).astype(np.int32)
    mask[0], mask[1] = 1, 0
    return _t(xs), _t(ys), _t(mask)


def _agg_on_host(host_kernels, fp2, xs, ys, mask, cp, ns, pairs):
    """The committee-sum source run by the host shim with ns blocks per
    row adding `pairs` pairs at once: (X, Y, Z) and the rows' counters."""
    n, cdim = mask.shape
    point = (2,) if fp2 else ()
    partial = torch.zeros((n, ns, 3) + point + (25,), dtype=torch.int32)
    counter = torch.zeros(n, dtype=torch.int32)
    out = [torch.zeros((n,) + point + (25,), dtype=torch.int32)
           for _ in range(3)]
    host_kernels["agg"].run(int(fp2), _p(xs), _p(ys), _p(mask), n, cdim, cp,
                            ns, pairs, _p(mk._kernel_consts("cpu")),
                            _p(partial), _p(counter), *map(_p, out))
    return out, counter.tolist()


@pytest.mark.parametrize("fp2", [False, True])
@pytest.mark.parametrize("cdim", [1, 3, 5, 17, 144])
def test_agg_source_on_host_equals_plain(host_kernels, fp2, cdim):
    """The committee-sum source on 3 rows at 1 to 144 slots (the audit's
    committee: 256 slots), split as the launcher plans it, limb for
    limb."""
    n = 3
    xs, ys, mask = _agg_inputs(np.random.default_rng(83 + cdim), n, cdim,
                               fp2)
    cp = mk._committee_pad(cdim)
    plan = (ctypes.c_int * 2)()
    host_kernels["agg"].gs_agg_plan(int(fp2), cp, plan)
    ns, pairs = plan
    out, counter = _agg_on_host(host_kernels, fp2, xs, ys, mask, cp, ns,
                                pairs)
    want = mk.run_agg_plain(xs, ys, mask.bool(), fp2=fp2)
    for got, w in zip(out, want):
        assert torch.equal(got, w)
    assert counter == [ns if ns > 1 else 0] * n


@pytest.mark.parametrize("fp2", [False, True])
@pytest.mark.parametrize("cdim,ns,pairs", [
    (144, 4, 3), (144, 256, 1), (17, 4, 3), (17, 32, 1)])
def test_agg_source_on_host_other_splits(host_kernels, fp2, cdim, ns,
                                         pairs):
    """A row split over ns blocks gives the plain version's limbs: block
    s sums the slots of residue s mod ns (in chunks of `pairs`, which
    need not divide a level), writes its partial, counts itself in, and
    the row's last block adds the ns partials over the top levels. At
    ns = cp every block holds one slot and the last one makes the whole
    tree from the partials. 3 rows, a count no split divides."""
    n = 3
    xs, ys, mask = _agg_inputs(np.random.default_rng(93 + cdim), n, cdim,
                               fp2)
    cp = mk._committee_pad(cdim)
    out, counter = _agg_on_host(host_kernels, fp2, xs, ys, mask, cp, ns,
                                pairs)
    want = mk.run_agg_plain(xs, ys, mask.bool(), fp2=fp2)
    for got, w in zip(out, want):
        assert torch.equal(got, w)
    assert counter == [ns] * n


@pytest.mark.parametrize("fp2,cp,ns", [
    (False, 2, 1), (False, 256, 1), (False, 512, 1), (False, 1024, 2),
    (True, 2, 1), (True, 256, 1), (True, 512, 2), (True, 1024, 4)])
def test_agg_plan_takes_the_fewest_blocks_that_fit(host_kernels, fp2, cp,
                                                    ns):
    """One block per row while its shared memory fits in 227 KB (the
    audit's 256 slots), then as few as fit; the pairs a block adds at
    once are 32 (G1) or 16 (G2), at most half its slots."""
    plan = (ctypes.c_int * 2)()
    host_kernels["agg"].gs_agg_plan(int(fp2), cp, plan)
    assert plan[0] == ns
    assert plan[1] == min(16 if fp2 else 32, cp // ns // 2)


def test_miller_source_on_host_equals_plain(host_kernels):
    rng = np.random.default_rng(84)
    n = 2
    sig = tuple(_canon(rng, (n,)) for _ in range(3))
    h = (_canon(rng, (n,)), _canon(rng, (n,)))
    pk = tuple(_canon(rng, (n, 2)) for _ in range(3))
    out = torch.zeros((n, 6, 2, 25), dtype=torch.int32)
    host_kernels["miller"].run(
        *map(_p, sig + h + pk), _p(mk.const(mk._MILLER_OPS, "cpu")),
        len(mk._MILLER_OPS), _p(mk.const(mk._MILLER_LINES, "cpu")),
        _p(mk.const(mk._MILLER_TWF, "cpu")), _p(mk._kernel_consts("cpu")),
        n, _p(out))
    assert torch.equal(out, mk.run_miller_plain(sig, h, pk))


def _host_miller(kernel, sig, h, pk, ops=None):
    """The op stream `ops` (the audit's where None) through the host-
    compiled Miller kernel."""
    ops = torch.as_tensor(mk._miller_ops(ops))
    n = sig[0].shape[0]
    out = torch.zeros((n, 6, 2, 25), dtype=torch.int32)
    kernel.run(*map(_p, sig + h + pk), _p(ops), ops.shape[0],
               _p(mk.const(mk._MILLER_LINES, "cpu")),
               _p(mk.const(mk._MILLER_TWF, "cpu")),
               _p(mk._kernel_consts("cpu")), n, _p(out))
    return out


def _miller_inputs(rng, n):
    return (tuple(_canon(rng, (n,)) for _ in range(3)),
            (_canon(rng, (n,)), _canon(rng, (n,))),
            tuple(_canon(rng, (n, 2)) for _ in range(3)))


# short Miller op streams (0 = DBL, 1-4 = ADD with the candidate +Q, -Q,
# pi Q, -pi^2 Q); step i takes line i of the generator-line table
_MILLER_STREAMS = {
    "dbl": [0], "add_q": [1], "add_neg_q": [2], "add_pi_q": [3],
    "add_neg_pi2_q": [4], "dbl_add_dbl": [0, 1, 0],
}


@pytest.mark.parametrize("name", list(_MILLER_STREAMS))
def test_miller_source_on_host_runs_each_step(host_kernels, name):
    """One doubling, one addition with each candidate, and a doubling, an
    addition and a doubling in turn, through the host-compiled kernel,
    equal the plain loop on the same stream, on 3 rows."""
    sig, h, pk = _miller_inputs(np.random.default_rng(97), 3)
    ops = _MILLER_STREAMS[name]
    assert torch.equal(_host_miller(host_kernels["miller"], sig, h, pk, ops),
                       mk.run_miller_plain(sig, h, pk, ops))


@pytest.mark.parametrize("limb", [-1, 4095, (1 << 12) + 64])
def test_miller_source_on_host_edge_limbs(host_kernels, limb):
    """Every input limb -1, 4095 or at the quasi-canonical maximum 4160,
    on a stream with a doubling and an addition with each candidate."""
    full = lambda shape: torch.full(shape + (25,), limb, dtype=torch.int32)
    sig = tuple(full((3,)) for _ in range(3))
    h = (full((3,)), full((3,)))
    pk = tuple(full((3, 2)) for _ in range(3))
    ops = [0, 1, 0, 2, 3, 4]
    assert torch.equal(_host_miller(host_kernels["miller"], sig, h, pk, ops),
                       mk.run_miller_plain(sig, h, pk, ops))


@pytest.mark.parametrize("ops", [[5], [-1], [0] * 89])
def test_miller_op_streams_are_checked(ops):
    """An op outside 0-4, or a stream longer than the 88-line generator
    table, is refused before any launch, by the plain loop too."""
    fp = torch.zeros((1, 25), dtype=torch.int32)
    fp2 = torch.zeros((1, 2, 25), dtype=torch.int32)
    with pytest.raises(ValueError):
        mk.run_miller_plain((fp, fp, fp), (fp, fp), (fp2, fp2, fp2), ops)
    with pytest.raises(ValueError):
        mk.miller_kernel((fp, fp, fp), (fp, fp), (fp2, fp2, fp2), ops)


def _host_program(kernel, nd, prog):
    """`prog` through the host-compiled final-exponentiation kernel."""
    prog = torch.as_tensor(np.asarray(prog, np.int32))
    out = torch.zeros_like(nd)
    kernel.run(_p(nd), _p(prog), prog.shape[0],
               _p(mk._kernel_consts("cpu")), nd.shape[0], _p(out))
    return out


def test_finalexp_source_on_host_equals_plain(host_kernels):
    rng = np.random.default_rng(85)
    n = 2
    nd = _canon(rng, (n, 2, 6, 2))
    out = _host_program(host_kernels["finalexp"], nd, mk._PROGRAM)
    assert torch.equal(out, mk.run_program_plain(nd))


# short final-exponentiation programs (op, a, b, d) that end in the result
# register 13: 0 = mul, 1 = swap, 2 = frob_b, 3 = copy
_FE_PROGRAMS = {
    "product": [(2, 0, 1, 1), (0, 0, 1, 13)],
    "square": [(0, 0, 0, 13)],
    "dest_is_a": [(2, 0, 1, 1), (0, 0, 1, 0), (3, 0, 0, 13)],
    "dest_is_b": [(2, 0, 1, 1), (0, 0, 1, 1), (3, 1, 0, 13)],
    "frob1": [(2, 0, 1, 13)],
    "frob2": [(2, 0, 2, 13)],
    "frob3_in_place": [(2, 0, 3, 0), (3, 0, 0, 13)],
    "swap": [(1, 0, 0, 4), (0, 0, 4, 13)],
    "copy": [(3, 0, 0, 13)],
    "mixed": [(2, 0, 2, 4), (0, 4, 0, 0), (1, 0, 0, 4), (0, 0, 0, 13),
              (0, 13, 4, 13), (2, 13, 3, 13), (1, 13, 0, 13)],
}


@pytest.mark.parametrize("name", list(_FE_PROGRAMS))
def test_finalexp_source_on_host_runs_each_op(host_kernels, name):
    """Each op of the register machine (product, square, a destination
    that is an operand, Frobenius 1-3, swap, copy) through the host-
    compiled kernel equals the plain loop, on 3 rows."""
    nd = _canon(np.random.default_rng(95), (3, 2, 6, 2))
    prog = _FE_PROGRAMS[name]
    assert torch.equal(_host_program(host_kernels["finalexp"], nd, prog),
                       mk.run_program_plain(nd, prog))


@pytest.mark.parametrize("prog", [[(4, 0, 0, 13)], [(0, 0, 14, 13)],
                                  [(3, -1, 0, 13)], [(2, 0, 0, 13)],
                                  [(2, 0, 4, 13)], [(0, 0, 0)]])
def test_program_rows_are_checked(prog):
    """A program the kernel would run out of its registers or gamma
    table on is refused before any launch, by the plain loop too."""
    nd = torch.zeros((1, 2, 6, 2, 25), dtype=torch.int32)
    with pytest.raises(ValueError):
        mk.run_program_plain(nd, prog)
    with pytest.raises(ValueError):
        mk.finalexp_kernel(nd, prog)


@pytest.mark.parametrize("limb", [-1, (1 << 12) + 64, 0])
def test_finalexp_source_on_host_edge_limbs(host_kernels, limb):
    """All limbs -1, all at the quasi-canonical maximum 4160, all zero."""
    nd = torch.full((3, 2, 6, 2, 25), limb, dtype=torch.int32)
    prog = _FE_PROGRAMS["mixed"]
    assert torch.equal(_host_program(host_kernels["finalexp"], nd, prog),
                       mk.run_program_plain(nd, prog))


@pytest.mark.parametrize("width", [19, 25, 26, 37, 49, norm.MAX_WIDTH])
def test_norm_source_on_host_equals_plain(host_kernels, width):
    rng = np.random.default_rng(86)
    n = 7
    z = rng.integers(-(1 << 30), 1 << 30, (n, width)).astype(np.int32)
    z[:, -1] = np.abs(z[:, -1]) + (1 << 29)    # value >= 0
    z[0] = int(2 ** 30.7) - 1                   # the bound edge
    z = torch.as_tensor(z)
    out = torch.zeros((n, 25), dtype=torch.int32)
    host_kernels["norm"].run(_p(z), ctypes.c_longlong(n), width, 0,
                             _p(mk.const(pbn.FP.fold_j, "cpu")),
                             _p(mk.const(pbn.FP.lift, "cpu")), _p(out))
    assert torch.equal(out, norm.normalize_plain(pbn.FP, z))


def _norm_edge_rows(rng, n, width):
    """n accumulators of `width` limbs, value >= 0: random limbs inside
    |limb| < 2^30.7, then rows at the bound edge (every limb ±(2^30.7 - 1),
    the top positive) and rows of -1 and 0 limbs over a positive top."""
    edge = int(2 ** 30.7) - 1
    z = rng.integers(-edge, edge + 1, (n, width)).astype(np.int32)
    z[:, -1] = np.abs(z[:, -1]) + (1 << 29)    # value >= 0
    z[0] = edge
    z[1] = np.where(rng.integers(0, 2, width) == 1, edge, -edge)
    z[1, -1] = edge
    z[2] = -1
    z[2, -1] = 1
    z[3] = 0
    return torch.as_tensor(z)


@pytest.mark.parametrize("width", [19, 22, 25, 26, 43, 49, norm.MAX_WIDTH])
def test_norm_exact_source_on_host_equals_plain(host_kernels, width):
    z = _norm_edge_rows(np.random.default_rng(87), 9, width)
    out = torch.zeros((9, 22), dtype=torch.int32)
    host_kernels["norm"].run(_p(z), ctypes.c_longlong(9), width, 1,
                             _p(mk.const(pbn.FP.fold_j, "cpu")),
                             _p(mk.const(pbn.FP.lift, "cpu")), _p(out))
    assert torch.equal(out, norm.normalize_plain(pbn.FP, z, form="exact"))


def _host_conv(kernel, x, y, comb, rpb):
    """The conv source on x, y with the wrapper's broadcast plan (each
    operand in place, with its strides over the common lead), `rpb` rows
    per block."""
    G, A, B, C, Gr = comb.shape
    x, y, lead, n, ndim, desc = conv.broadcast_rows(x, y)
    plan = conv.plane_plan(comb)
    nl = x.shape[-1]
    out = torch.zeros(lead + (C, Gr, 2 * nl - 1), dtype=torch.int32)
    kernel.run(_p(x), _p(y), ctypes.c_longlong(n), nl, G * A, G * B, A, B,
               _p(mk.const(plan, "cpu")), C * Gr,
               conv.plan_terms(plan, C * Gr).shape[0], rpb, ndim, desc,
               _p(out))
    return out


@pytest.mark.parametrize("name", ["_COMB_FP2", "_COMB_FP2_SQR", "_COMB",
                                  "_LCOMB", "identity"])
def test_conv_source_on_host_equals_plain(host_kernels, name):
    comb = (np.ones((1,) * 5, np.int32) if name == "identity"
            else getattr(pbn, name))
    G, A, B, C, Gr = comb.shape
    rng = np.random.default_rng(87)
    cases = [   # a partial last block; x broadcast along a middle dim (the
                # Fp12 product's f); a constant y; a constant x; x a view
                # with gaps between its rows
        (_canon(rng, (11, G, A)), _canon(rng, (11, G, B))),
        (_canon(rng, (3, 1, G, A)), _canon(rng, (3, 4, G, B))),
        (_canon(rng, (2, 5, G, A)), _canon(rng, (G, B))),
        (_canon(rng, (G, A)), _canon(rng, (9, G, B))),
        (_canon(rng, (10, 2, G, A))[:, 1], _canon(rng, (10, G, B))),
    ]
    widest = conv.rows_per_block(10 ** 6, C * Gr)   # the most rows a block takes
    for x, y in cases:
        want = conv.pair_conv_combine_plain(x, y, comb)
        for rpb in sorted({1, widest}):
            assert torch.equal(_host_conv(host_kernels["conv"], x, y, comb,
                                          rpb), want)


@pytest.mark.parametrize("name", ["_COMB_FP2", "_COMB_FP2_SQR", "_COMB",
                                  "_LCOMB", "identity"])
def test_plane_plan_covers_every_term_once(name):
    """The per-plane plan of the conv and tower kernels lists each nonzero
    of the combine tensor exactly once, in its plane, with its
    coefficient."""
    comb = (pbn.FP.mul_plan.comb if name == "identity"
            else getattr(pbn, name))
    G, A, B, C, Gr = comb.shape
    plan = conv.plane_plan(comb)
    offsets = plan[:C * Gr + 1]
    terms = conv.plan_terms(plan, C * Gr)
    assert offsets[0] == 0 and offsets[-1] == terms.shape[0]
    assert (np.diff(offsets) >= 0).all()
    rebuilt = np.zeros_like(comb)
    seen = set()
    for p in range(C * Gr):
        for i, a, b, coef in terms[offsets[p]:offsets[p + 1]]:
            key = (i, a, b, p // Gr, p % Gr)
            assert key not in seen and coef != 0
            seen.add(key)
            rebuilt[key] = coef
    assert (rebuilt == comb).all()
    assert len(seen) == np.count_nonzero(comb)


# == the tower kernel (one launch per product), run on the host ==============


def _host_tower(kernel, plan, u, v):
    u, v, n, ndim, desc, out = tower.launch_args(plan, u, v)
    kernel.run(plan.kind, tower._FORM_ARG, _p(u), _p(v),
               ctypes.c_longlong(n), ndim, desc,
               _p(mk.const(plan.pack, "cpu")), plan.nterms, _p(out))
    return out


# each product: (plan, its operands in the kernel's form from the
# function's own x, y, and the function's own shapes of x and y)
_TOWER_PRODUCTS = {
    "fp_mul": (lambda: pbn.FP.mul_plan,
               lambda x, y: (x[..., None, None, :], y[..., None, None, :]),
               (), ()),
    "fp2_mul": (lambda: pbn._FP2_MUL,
                lambda x, y: (x[..., None, :, :], y[..., None, :, :]),
                (2,), (2,)),
    "fp2_sqr": (lambda: pbn._FP2_SQR,
                lambda x, y: (x[..., None, :, :], x[..., None, :, :]),
                (2,), (2,)),
    "fp12_mul": (lambda: pbn._FP12_MUL, lambda x, y: (x, y), (6, 2), (6, 2)),
    "fp12_sqr": (lambda: pbn._FP12_MUL, lambda x, y: (x, x), (6, 2), (6, 2)),
    "fp12_mul_line": (lambda: pbn._LINE_MUL, lambda f, line: (line, f),
                      (6, 2), (3, 2)),
}


def _tower_cases(rng, xs, ys):
    """Random canonical limbs with a partial block of the eight-row Fp
    kind; all-4095 and all-zero limbs; a broadcast constant y; a constant
    x; leading dims with x broadcast along the middle one."""
    full = lambda lead, shape, v: torch.full(lead + shape + (25,), v,
                                             dtype=torch.int32)
    return [
        (_canon(rng, (11,) + xs), _canon(rng, (11,) + ys)),
        (full((3,), xs, 4095), full((3,), ys, 4095)),
        (full((2,), xs, 0), _canon(rng, (2,) + ys)),
        (_canon(rng, (5,) + xs), _canon(rng, ys)),
        (_canon(rng, xs), _canon(rng, (9,) + ys)),
        (_canon(rng, (2, 1) + xs), _canon(rng, (2, 3) + ys)),
    ]


@pytest.mark.parametrize("name", list(_TOWER_PRODUCTS))
def test_tower_source_on_host_equals_plain(host_kernels, name):
    """Each product kind through the tower source (one launch per
    product) gives the plain tower's limbs."""
    plan_of, operands, xs, ys = _TOWER_PRODUCTS[name]
    plan = plan_of()
    for x, y in _tower_cases(np.random.default_rng(88), xs, ys):
        u, v = operands(x, y)
        got = _host_tower(host_kernels["tower"], plan, u, v)
        assert torch.equal(got, plan.plain(u, v)), name


@pytest.mark.parametrize("name", ["fp12_mul", "fp12_mul_line"])
def test_tower_source_on_host_equals_reference(host_kernels, name):
    """The tower source against the JAX package's `fp12_mul` and
    `fp12_mul_line` on lazy inputs, limb for limb."""
    rng = np.random.default_rng(89)
    lazy = lambda shape: pbn.ints_to_limbs(
        [int.from_bytes(rng.bytes(34), "little") for _ in
         range(int(np.prod(shape)))]).reshape(shape + (25,))
    x12 = lazy((3, 6, 2))
    if name == "fp12_mul":
        other = lazy((3, 6, 2))
        want = k.fp12_mul(jnp.asarray(x12), jnp.asarray(other))
        u, v, plan = _t(x12), _t(other), pbn._FP12_MUL
    else:
        other = lazy((3, 3, 2))
        want = k.fp12_mul_line(jnp.asarray(x12),
                               tuple(jnp.asarray(other[:, t]) for t in range(3)))
        u, v, plan = _t(other), _t(x12), pbn._LINE_MUL
    got = _host_tower(host_kernels["tower"], plan, u, v)
    assert (got.numpy() == np.asarray(want)).all()



# == the exact 22-limb form's conv and tower, run on the host ================
# The port reads its limb form at import, so the exact form's plans (their
# packs at the form's widths) exist only in a process started with
# GETHSHARDING_TORCH_LIMB_FORM=exact. The script below runs there on the
# libraries the `host_kernels` fixture compiled (their entry points take the
# form at run time) and reports each check by name.

_EXACT_SCRIPT = r"""
import ctypes, json, sys, traceback
import numpy as np
import torch
from gethsharding_tpu_torch.ops import bn256 as pbn
from gethsharding_tpu_torch.ops import conv, limb, tower
from gethsharding_tpu_torch.ops import megakernels as mk

tower_lib, conv_lib = ctypes.CDLL(sys.argv[1]), ctypes.CDLL(sys.argv[2])
p = lambda t: ctypes.c_void_p(t.data_ptr())
results = {}


def check(name):
    def run(fn):
        try:
            fn()
            results[name] = None
        except BaseException:
            results[name] = traceback.format_exc()[-3000:]
    return run


def host_tower(plan, u, v):
    u, v, n, ndim, desc, out = tower.launch_args(plan, u, v)
    tower_lib.run(plan.kind, tower._FORM_ARG, p(u), p(v),
                  ctypes.c_longlong(n), ndim, desc,
                  p(mk.const(plan.pack, "cpu")), plan.nterms, p(out))
    return out


def host_conv(x, y, comb, rpb):
    G, A, B, C, Gr = comb.shape
    x, y, lead, n, ndim, desc = conv.broadcast_rows(x, y)
    plan = conv.plane_plan(comb)
    out = torch.zeros(lead + (C, Gr, 43), dtype=torch.int32)
    conv_lib.run(p(x), p(y), ctypes.c_longlong(n), 22, G * A, G * B, A, B,
                 p(mk.const(plan, "cpu")), C * Gr,
                 conv.plan_terms(plan, C * Gr).shape[0], rpb, ndim, desc,
                 p(out))
    return out


rng = np.random.default_rng(90)
canon = lambda shape: torch.as_tensor(
    rng.integers(0, 1 << 12, shape + (22,)).astype(np.int32))
full = lambda shape, v: torch.full(shape + (22,), v, dtype=torch.int32)


@check("form")
def _():
    assert limb.LIMB_FORM == "exact" and tower.KERNEL.name == "tower_exact"
    assert (tower.ACC_W, tower.XI_W) == (pbn._ACC_W, pbn._PAD266.shape[0]) \
        == (45, 23)
    assert pbn.FP.mul_plan.acc_w == 43
    assert all(plan.acc_w == 45 for plan in (
        pbn._FP2_MUL, pbn._FP2_SQR, pbn._FP12_MUL, pbn._LINE_MUL))


PRODUCTS = {   # plan, the function's own operand shapes, to kernel form
    "fp_mul": (pbn.FP.mul_plan, (), (),
               lambda x, y: (x[..., None, None, :], y[..., None, None, :])),
    "fp2_mul": (pbn._FP2_MUL, (2,), (2,),
                lambda x, y: (x[..., None, :, :], y[..., None, :, :])),
    "fp2_sqr": (pbn._FP2_SQR, (2,), (2,),
                lambda x, y: (x[..., None, :, :], x[..., None, :, :])),
    "fp12_mul": (pbn._FP12_MUL, (6, 2), (6, 2), lambda x, y: (x, y)),
    "fp12_sqr": (pbn._FP12_MUL, (6, 2), (6, 2), lambda x, y: (x, x)),
    "fp12_mul_line": (pbn._LINE_MUL, (6, 2), (3, 2),
                      lambda f, line: (line, f)),
}
for name, (plan, xs, ys, operands) in PRODUCTS.items():
    @check(f"tower-{name}")
    def _(plan=plan, xs=xs, ys=ys, operands=operands):
        cases = [   # random limbs with a partial block of the eight-row Fp
                    # kind, a broadcast constant either side, a broadcast
                    # middle dim, then -1, 4095 and 4160 limbs
            (canon((11,) + xs), canon((11,) + ys)),
            (canon((5,) + xs), canon(ys)),
            (canon(xs), canon((9,) + ys)),
            (canon((2, 1) + xs), canon((2, 3) + ys)),
            (full((3,) + xs, -1), canon((3,) + ys)),
            (full((3,) + xs, 4095), full((3,) + ys, 4095)),
            (full((3,) + xs, 4160), full((3,) + ys, 4160)),
            (canon((3,) + xs), full((3,) + ys, -1)),
        ]
        for x, y in cases:
            u, v = operands(x, y)
            got = host_tower(plan, u, v)
            assert got.shape[-1] == 22, got.shape
            assert torch.equal(got, plan.plain(u, v))


for name in ("_COMB_FP2", "_COMB_FP2_SQR", "_COMB", "_LCOMB", "identity"):
    @check(f"conv-{name}")
    def _(name=name):
        comb = limb._IDENTITY if name == "identity" else getattr(pbn, name)
        G, A, B, C, Gr = comb.shape
        cases = [(canon((11, G, A)), canon((11, G, B))),
                 (canon((2, 5, G, A)), canon((G, B))),
                 (canon((10, 2, G, A))[:, 1], canon((10, G, B))),
                 (full((3, G, A), 4160), full((3, G, B), -1))]
        for x, y in cases:
            want = conv.pair_conv_combine_plain(x, y, comb)
            assert want.shape[-1] == 43
            for rpb in (1, conv.rows_per_block(10 ** 6, C * Gr)):
                assert torch.equal(host_conv(x, y, comb, rpb), want)

print("RESULTS " + json.dumps(results))
"""

_EXACT_HOST_CHECKS = (["form"] + [f"tower-{n}" for n in _TOWER_PRODUCTS]
                      + [f"conv-{n}" for n in ("_COMB_FP2", "_COMB_FP2_SQR",
                                               "_COMB", "_LCOMB",
                                               "identity")])


@pytest.fixture(scope="module")
def exact_host_checks(host_kernels):
    env = {key: val for key, val in os.environ.items()
           if not key.startswith("GETHSHARDING_TORCH_")}
    env.update(GETHSHARDING_TORCH_LIMB_FORM="exact", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _EXACT_SCRIPT, host_kernels["tower"]._name,
         host_kernels["conv"]._name], env=env, capture_output=True,
        text=True, timeout=600, cwd=Path(__file__).resolve().parents[1])
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULTS ")]
    assert proc.returncode == 0 and lines, (proc.stdout[-2000:],
                                            proc.stderr[-3000:])
    return json.loads(lines[-1][len("RESULTS "):])


@pytest.mark.parametrize("name", _EXACT_HOST_CHECKS)
def test_exact_form_sources_on_host_equal_plain(exact_host_checks, name):
    """The tower source on every product kind and the conv source on every
    combine, in the exact 22-limb form, against the exact form's plain
    tower and conv: random limbs, broadcasts, -1/4095/4160 limbs."""
    assert name in exact_host_checks, sorted(exact_host_checks)
    assert exact_host_checks[name] is None, exact_host_checks[name]


# == slow: whole programs against the reference's XLA oracles ==============


def _committee_workload():
    """Aggregated projective inputs for two shards: one valid, one with a
    tampered signature set (the reference tests' workload)."""
    tag = b"miller-port"
    sigs, pks = _committee(tag, 3)
    bad = [sigs[0], sigs[1], ref.g1_add(sigs[2], ref.G1_GEN)]
    hx, hy, _ = pbn.g1_to_limbs([ref.hash_to_g1(tag)] * 2)
    sx, sy, sm = pbn.g1_committee_to_limbs([sigs, bad], 3)
    gx, gy, gm = pbn.g2_committee_to_limbs([pks, pks], 3)
    sig = mk.aggregate_proj(_t(sx), _t(sy), _t(sm), fp2=False)
    pk = mk.aggregate_proj(_t(gx), _t(gy), _t(gm), fp2=True)
    return sig, (_t(hx), _t(hy)), pk


@pytest.mark.slow
def test_plain_miller_equals_reference_oracle():
    sig, h, pk = _committee_workload()
    want = np.asarray(m.run_miller_xla(
        tuple(v.numpy() for v in sig), tuple(v.numpy() for v in h),
        tuple(v.numpy() for v in pk)))
    got = mk.run_miller_plain(sig, h, pk).numpy()
    assert (got == want).all()
    f = mk.miller_f(sig, *h, pk)
    assert mk.finalexp_is_one(f).tolist() == [True, False]


@pytest.mark.slow
def test_plain_finalexp_equals_reference_oracle():
    sig, h, pk = _committee_workload()
    f = mk.miller_f(sig, *h, pk)
    nd = torch.stack([pbn.fp12_conj(f), pbn.FP.normalize(f)])
    want = np.asarray(m.run_program_xla(jnp.asarray(nd.numpy())))
    got = mk.run_program_plain(nd.transpose(0, 1)).transpose(0, 1).numpy()
    assert (got == want).all()
    assert np.asarray(k.pairing_is_one(jnp.asarray(f.numpy()))).tolist() == \
        mk.finalexp_is_one(f).tolist() == [True, False]
