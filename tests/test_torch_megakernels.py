"""The port's audit kernels (gethsharding_tpu_torch/ops/megakernels.py)
against the JAX package's mega-kernels (gethsharding_tpu/ops/
pallas_finalexp.py):

1. every constant table and program is byte-equal to the reference's;
2. the plain helpers equal the reference helpers run as XLA ops on the
   CPU, limb for limb, on random quasi-canonical inputs (exact: integer
   arithmetic has no rounding);
3. the plain committee sums give the scalar reference's points;
4. the CUDA sources, compiled for the host with one thread per block,
   give the plain versions' limbs;
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

    with ThreadPoolExecutor(3) as pool:
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


def test_finalexp_source_on_host_equals_plain(host_kernels):
    rng = np.random.default_rng(85)
    n = 2
    nd = _canon(rng, (n, 2, 6, 2))
    out = torch.zeros_like(nd)
    host_kernels["finalexp"].run(
        _p(nd), _p(mk.const(mk._PROGRAM, "cpu")), len(mk._PROGRAM),
        _p(mk._kernel_consts("cpu")), n, _p(out))
    want = mk.run_program_plain(nd)
    assert torch.equal(out, want)


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
