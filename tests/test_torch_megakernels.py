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
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gethsharding_tpu.crypto import bn256 as ref
from gethsharding_tpu.ops import bn256_jax as k
from gethsharding_tpu.ops import pallas_finalexp as m
from gethsharding_tpu_torch import convert
from gethsharding_tpu_torch.ops import _build
from gethsharding_tpu_torch.ops import bn256 as pbn
from gethsharding_tpu_torch.ops import conv, norm, tower
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.ops.limb import limbs_to_int

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
# kernels' block-cooperative loops. This checks the kernels' arithmetic
# and indexing here, where no card is; the card itself is checked by the
# cuda tests below and by chip_smoke.py.

_SHIM = r"""
struct Dim { unsigned x, y, z; };
static Dim threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static
#define __shared__
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
struct int4 { int x, y, z, w; };
inline void __syncthreads() {}
"""

_DRIVERS = {
    "agg": r"""
namespace gs { int smem[1 << 16]; }
extern "C" void run(int fp2, const int* xs, const int* ys, const int* mask,
                    int n, int C, int cp, const int* consts, int* scratch,
                    int* ox, int* oy, int* oz) {
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    if (fp2) gs::agg_kernel<2>(xs, ys, mask, C, cp, consts, scratch, ox, oy, oz);
    else gs::agg_kernel<1>(xs, ys, mask, C, cp, consts, scratch, ox, oy, oz);
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
extern "C" void run(const int* x, const int* y, long long n, int xw, int yw,
                    int a_dim, int b_dim, const int* plan, int planes,
                    int nterms, int rpb, int ndim, const long long* desc,
                    int* out) {
  const gs::ConvLead lead = gs::conv_lead(ndim, desc);
  for (long long b = 0; b * rpb < n; ++b) {
    blockIdx.x = b;
    gs::conv_kernel(x, y, n, xw, yw, a_dim, b_dim, plan, planes, nterms,
                    rpb, lead, out);
  }
}""",
    "tower": r"""
template <int KIND>
static void run_kind(const int* u, const int* v, long long n,
                     const gs::ConvLead& lead, const int* pack, int nterms,
                     int* out) {
  using S = gs::TowerShape<KIND>;
  for (long long b = 0; b < (n + S::ROWS - 1) / S::ROWS; ++b) {
    blockIdx.x = b;
    gs::tower_kernel<KIND>(u, v, n, lead, pack, nterms, out);
  }
}
extern "C" void run(int kind, const int* u, const int* v, long long n,
                    int ndim, const long long* desc, const int* pack,
                    int nterms, int* out) {
  const gs::ConvLead lead = gs::conv_lead(ndim, desc);
  switch (kind) {
    case gs::TOWER_FP: run_kind<gs::TOWER_FP>(u, v, n, lead, pack, nterms, out); break;
    case gs::TOWER_FP2: run_kind<gs::TOWER_FP2>(u, v, n, lead, pack, nterms, out); break;
    case gs::TOWER_FP12: run_kind<gs::TOWER_FP12>(u, v, n, lead, pack, nterms, out); break;
    case gs::TOWER_LINE: run_kind<gs::TOWER_LINE>(u, v, n, lead, pack, nterms, out); break;
  }
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


@pytest.mark.parametrize("fp2,cdim", [(False, 5), (True, 5), (False, 1),
                                      (True, 3)])
def test_agg_source_on_host_equals_plain(host_kernels, fp2, cdim):
    rng = np.random.default_rng(83)
    n = 3
    point = (2,) if fp2 else ()
    xs, ys = _canon(rng, (n, cdim) + point), _canon(rng, (n, cdim) + point)
    mask = torch.as_tensor(rng.integers(0, 2, (n, cdim)).astype(np.int32))
    mask[0], mask[1] = 1, 0
    cp = mk._committee_pad(cdim)
    scratch = torch.zeros((n, cp, 3) + point + (25,), dtype=torch.int32)
    out = [torch.zeros((n,) + point + (25,), dtype=torch.int32)
           for _ in range(3)]
    host_kernels["agg"].run(int(fp2), _p(xs), _p(ys), _p(mask), n, cdim, cp,
                            _p(mk._kernel_consts("cpu")), _p(scratch),
                            *map(_p, out))
    want = mk.run_agg_plain(xs, ys, mask.bool(), fp2=fp2)
    for got, w in zip(out, want):
        assert torch.equal(got, w)


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
    out = torch.zeros(lead + (C, Gr, 49), dtype=torch.int32)
    kernel.run(_p(x), _p(y), ctypes.c_longlong(n), G * A * 25,
               G * B * 25, A, B, _p(mk.const(plan, "cpu")), C * Gr,
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
    kernel.run(plan.kind, _p(u), _p(v), ctypes.c_longlong(n), ndim, desc,
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
