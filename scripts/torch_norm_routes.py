"""Time the exact normalize's schedule beside the two that lost.

`csrc/norm.cuh` schedules the exact ladder (two relaxed stages, then
exact carries into 24, 23 and 22 limbs with a fold between each) in
block phases: the rounds, the fold and the second stage, then a tail one
thread a row whose carries go in words of three limbs (36 bits in an
int64), the short folds in registers. This script keeps two other
schedules of the same ladder, which give the same limbs and measured
slower, and builds each from a copy of the sources in which it replaces
`norm_scratch_row` and `norm_exact_rows` of `norm.cuh`:

- warps: each warp runs the whole ladder on its own share of the rows,
  its steps separated by __syncwarp() and one __syncthreads() at the
  end, the same tail one lane a row;
- lanes: the same, with each carry spread over the warp's lanes (three
  relaxed rounds, then a Kogge-Stone prefix of 5 steps over the limbs'
  carry functions), the folds between them as lane steps.

Builds the whole kernel library once per schedule (the copy in
gethsharding_tpu_torch/_build/norm_routes/<name>/csrc/, the library
beside it; `block` is the library of the sources as they are), in the
exact 22-limb form. For each: its exact instances' ptxas registers,
stack frame and spills; `norm_exact` on edge rows at widths 22-52 and on
`norm.carry_edge_rows`, and `tower_exact` on every product kind at 112
rows, each equal to its plain version on the card (tolerance 0), or the
script fails. Then it times, with CUDA events, `norm_exact` at
(1344, 22), (1344, 45) and (112, 23) and `tower_exact` on each product
kind, the schedules in turn forward and then backward. Prints one line
per schedule and shape with the card's name and power limit, and writes
the table to norm_routes.json in gethsharding_tpu_torch/_build/
norm_routes/. Needs an NVIDIA card and nvcc; imports nothing of JAX.

    python3 scripts/torch_norm_routes.py
"""

import json
import os
import re
import shutil
import sys
from pathlib import Path

os.environ["GETHSHARDING_TORCH_LIMB_FORM"] = "exact"   # read at import

import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gethsharding_tpu_torch.ops import _build, limb, norm, route, tower  # noqa: E402
from gethsharding_tpu_torch.ops import bn256 as bn  # noqa: E402

NORM_SHAPES = ((1344, 22), (1344, 45), (112, 23))
ROWS = 112

# the warp-owned schedules' helpers and scratch size, in place of
# norm.cuh's norm_scratch_row; NORM_LANES picks the carries over the lanes
WARP_HELPERS = r"""
constexpr int NORM_XW = NORM_FB + 2;   // widest exact carry, 24 limbs
constexpr int NORM_CARRY_SCRATCH = 3 * NORM_XW;   // ints a row, lanes

// Scratch ints per row of t3: the first stage's WM + 3 (odd); with the
// lanes, the second stage (22), a 24-limb carry out and the carries'
// scratch if more.
template <int WM, NormForm F>
__host__ __device__ constexpr int norm_scratch_row() {
  constexpr int LANES = NORM_FB + NORM_XW + NORM_CARRY_SCRATCH;
  return (F == NORM_EXACT && NORM_LANES && LANES > WM + 3)
             ? LANES
             : (F == NORM_EXACT ? (WM + 3) | 1 : WM + 3);
}

// The rows [begin, end) of a `rows`-row normalize that this thread's warp
// owns (a contiguous share, at most one more than another warp's), and
// the thread's lane among the warp's `lanes`.
struct WarpRows {
  int lane, lanes, begin, end;
};

__device__ __forceinline__ WarpRows warp_rows(int rows) {
  const int warps = (blockDim.x + 31) / 32, w = threadIdx.x / 32;
  return {(int)(threadIdx.x % 32), blockDim.x < 32 ? (int)blockDim.x : 32,
          w * rows / warps, (w + 1) * rows / warps};
}

// The carry function c -> (d + c) >> 12 of a limb d in [-1, 4096] on
// c in {-1, 0, 1}, as three 2-bit fields: field k holds f(k - 1) + 1.
__device__ __forceinline__ int carry_code(int d) {
  int code = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    code |= (((d + k - 1) >> NORM_LB) + 1) << (2 * k);
  return code;
}

// The code of g after f.
__device__ __forceinline__ int carry_compose(int g, int f) {
  int h = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    h |= ((g >> (2 * ((f >> (2 * k)) & 3))) & 3) << (2 * k);
  return h;
}

// The exact carry of the warp's rows of in (row r at in[r·is ..], 22
// limbs) into NOUT canonical limbs at out[r·os ..], over the lanes:
// three relaxed rounds into NOUT limbs (the value mod 2^(12·NOUT) is
// kept, every limb in [-1, 4096], so each limb passes on a carry in
// {-1, 0, 1}), then a Kogge-Stone prefix of the limbs' carry functions
// (distances 1, 2, 4, 8, 16), whose composition below limb j applied to 0
// is the carry into j. Scratch: row r's NORM_CARRY_SCRATCH ints at
// x[r·xs ..], the relaxed limbs and two prefix buffers of 24.
template <int NOUT>
__device__ __forceinline__ void carry_lanes(const WarpRows& wr,
                                            const int* in, int is, int* out,
                                            int os, int* x, int xs) {
  const int n = (wr.end - wr.begin) * NOUT;
  int p = NORM_XW, q = 2 * NORM_XW;   // the prefix buffers' offsets
  for (int i = wr.lane; i < n; i += wr.lanes) {
    const int r = wr.begin + i / NOUT, j = i % NOUT;
    const int v = three_rounds(in + r * is, NORM_FB, j);
    x[r * xs + j] = v;
    x[r * xs + p + j] = carry_code(v);
  }
  __syncwarp();
#pragma unroll
  for (int s = 1; s < NOUT; s *= 2) {
    for (int i = wr.lane; i < n; i += wr.lanes) {
      const int r = wr.begin + i / NOUT, j = i % NOUT;
      const int* f = x + r * xs + p;
      x[r * xs + q + j] = j >= s ? carry_compose(f[j], f[j - s]) : f[j];
    }
    __syncwarp();
    const int t = p;
    p = q;
    q = t;
  }
  for (int i = wr.lane; i < n; i += wr.lanes) {
    const int r = wr.begin + i / NOUT, j = i % NOUT;
    const int c = j ? ((x[r * xs + p + j - 1] >> 2) & 3) - 1 : 0;
    out[r * os + j] = (x[r * xs + j] + c) & NORM_LM;
  }
  __syncwarp();
}
"""

# the warp-owned ladder, in place of norm.cuh's norm_exact_rows
WARP_ROWS = r"""
// The exact ladder on the warp's rows, with norm_rows' arguments. Row r
// keeps its own slot of t3 (S ints at t3[r·S ..]) and of acc through
// every step, so no warp touches another's rows; one block barrier ends
// it.
template <int WM, bool FENCE>
__device__ __forceinline__ void norm_exact_rows(const int* z, int zs, int w,
                                                int rows, int* out, int os,
                                                const int* fold, int* t3,
                                                int* acc) {
  constexpr int W3 = WM + 3, S = norm_scratch_row<WM, NORM_EXACT>();
  const WarpRows wr = warp_rows(rows);
  const int nr = wr.end - wr.begin;
  // the first stage: three rounds into W + 3 limbs, then the fold
  for (int i = wr.lane; i < nr * W3; i += wr.lanes) {
    const int r = wr.begin + i / W3, j = i % W3;
    t3[r * S + j] = three_rounds(z + r * zs, w, j);
  }
  __syncwarp();
  for (int i = wr.lane; i < nr * NORM_FB; i += wr.lanes) {
    const int r = wr.begin + i / NORM_FB, j = i % NORM_FB;
    acc[r * NORM_FB + j] =
        fold_limb<W3, false>(t3 + r * S, j, fold, nullptr);
  }
  __syncwarp();
  for (int i = wr.lane; i < nr * NORM_FB; i += wr.lanes) {
    const int r = wr.begin + i / NORM_FB, j = i % NORM_FB;
    t3[r * S + j] = stage2_limb(acc + r * NORM_FB, j, fold);
  }
  __syncwarp();
  if constexpr (NORM_LANES) {
    // the carries over the lanes, the folds between them; row r's slot:
    // the second stage, a carry's output y, the carries' scratch
    int* y = t3 + NORM_FB;
    int* x = y + NORM_XW;
    carry_lanes<NORM_FB + 2>(wr, t3, S, y, S, x, S);
    for (int i = wr.lane; i < nr * NORM_FB; i += wr.lanes) {
      const int r = wr.begin + i / NORM_FB, j = i % NORM_FB;
      acc[r * NORM_FB + j] =
          fold_limb<NORM_FB + 2, false>(y + r * S, j, fold, nullptr);
    }
    __syncwarp();
    carry_lanes<NORM_FB + 1>(wr, acc, NORM_FB, y, S, x, S);
    for (int i = wr.lane; i < nr * NORM_FB; i += wr.lanes) {
      const int r = wr.begin + i / NORM_FB, j = i % NORM_FB;
      acc[r * NORM_FB + j] =
          fold_limb<NORM_FB + 1, false>(y + r * S, j, fold, nullptr);
    }
    __syncwarp();
    carry_lanes<NORM_FB>(wr, acc, NORM_FB, out, os, x, S);
  } else {
    for (int r = wr.begin + wr.lane; r < wr.end; r += wr.lanes) {
      int o[NORM_FB];
      unsigned long long fw[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) fw[i] = fold_word(fold, i / 8, i % 8);
      exact_tail<FENCE>(t3 + r * S, fw, o);
#pragma unroll
      for (int j = 0; j < NORM_FB; ++j) out[r * os + j] = o[j];
    }
  }
  __syncthreads();
}
"""

# the schedules: None for the sources as they are, else NORM_LANES
ROUTES = {"block": None, "warps": False, "lanes": True}
HOME = (_build.SRC_DIR, _build.BUILD_DIR)
OUT_DIR = _build.BUILD_DIR / "norm_routes"


def replace_definition(src: str, name: str, text: str) -> str:
    """src with the definition of the template function `name` (from its
    `template <` line to its closing brace) replaced by text."""
    found = re.search(r"^template <[^\n]*>\n[^\n]*\b" + name + r"\(", src,
                      re.M)
    if not found:
        chip_smoke.fail(f"norm.cuh has no template function {name}")
    depth, i = 0, src.index("{", found.end())
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            break
    return src[:found.start()] + text.strip() + "\n" + src[i:]


def route_dirs(name: str) -> tuple:
    """(sources, build directory) of a schedule; the copy of the sources
    is written on first use."""
    lanes = ROUTES[name]
    if lanes is None:
        return HOME
    build_dir = OUT_DIR / name
    src_dir = build_dir / "csrc"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    shutil.copytree(HOME[0], src_dir)
    header = src_dir / "norm.cuh"
    src = replace_definition(
        header.read_text(), "norm_scratch_row",
        f"constexpr bool NORM_LANES = {str(lanes).lower()};\n"
        + WARP_HELPERS)
    header.write_text(replace_definition(src, "norm_exact_rows", WARP_ROWS))
    return src_dir, build_dir


def use(dirs: tuple) -> None:
    """Make the library built from `dirs` the one every kernel launches
    from, building it if it is missing or stale."""
    _build.SRC_DIR, _build.BUILD_DIR = dirs
    _build._lib = None
    for kernel in _build.KERNELS.values():
        kernel._fn = None
    _build.library()


def products(gen, dev):
    """Each product kind's plan and 112 rows of canonical operands in the
    kernel's operand form."""
    canon = lambda *shape: torch.randint(0, 1 << 12, (ROWS,) + shape + (22,),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)
    x2, y2, f, g, line = (canon(2), canon(2), canon(6, 2), canon(6, 2),
                          canon(3, 2))
    x1, y1 = canon(), canon()
    return {
        "fp_mul": (bn.FP.mul_plan, x1[:, None, None], y1[:, None, None]),
        "fp2_mul": (bn._FP2_MUL, x2[:, None], y2[:, None]),
        "fp2_sqr": (bn._FP2_SQR, x2[:, None], x2[:, None]),
        "fp12_mul": (bn._FP12_MUL, f, g),
        "fp12_sqr": (bn._FP12_MUL, f, f),
        "fp12_mul_line": (bn._LINE_MUL, line, f),
    }


def check(name, dev, gen, cases):
    """The exact normalize and the exact tower against their plain
    versions under the loaded library; fails on a difference."""
    errs = []
    for w in range(22, norm.MAX_WIDTH + 1):
        z = chip_smoke.edge_rows(gen, dev, 1000, w)
        errs.append(chip_smoke.max_abs_err(
            norm.normalize_kernel(bn.FP, z), norm.normalize_plain(bn.FP, z)))
    crafted = norm.carry_edge_rows(random_rows=2000).to(dev)
    errs.append(chip_smoke.max_abs_err(
        norm.normalize_kernel(bn.FP, crafted),
        norm.normalize_plain(bn.FP, crafted)))
    for plan, u, v in cases.values():
        with route.plain_versions():
            want = plan.plain(u, v)
        errs.append(chip_smoke.max_abs_err(tower.tower_kernel(plan, u, v),
                                           want))
    if max(errs):
        chip_smoke.fail(f"schedule {name} disagrees with the plain versions")


def main() -> int:
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    if limb.LIMB_FORM != "exact":
        chip_smoke.fail("the schedules are timed in the exact limb form")
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    cases = products(gen, dev)
    norms = {shape: chip_smoke.edge_rows(gen, dev, *shape)
             for shape in NORM_SHAPES}
    dirs, table = {}, {}
    for name in ROUTES:
        dirs[name] = route_dirs(name)
        _build.build_log = ""    # a cached build leaves no log of its own
        use(dirs[name])
        ptxas = chip_smoke.exact_ptxas(_build.build_log)
        check(name, dev, gen, cases)
        table[name] = {"ptxas": ptxas, "ms": {}}
        for kernel, regs, stack, stores, loads in ptxas:
            print(f"schedule {name}: ptxas {kernel}: {regs} registers, stack "
                  f"frame {stack} B, spills {stores}/{loads} B", flush=True)
    for name in list(ROUTES) + list(ROUTES)[::-1]:
        use(dirs[name])
        ms = table[name]["ms"]
        for shape, z in norms.items():
            ms.setdefault(f"norm_exact {shape}", []).append(chip_smoke.cuda_ms(
                lambda z=z: norm.normalize_kernel(bn.FP, z), 50))
        for kind, (plan, u, v) in cases.items():
            ms.setdefault(f"tower_exact {kind}", []).append(
                chip_smoke.cuda_ms(lambda p=plan, u=u, v=v:
                                   tower.tower_kernel(p, u, v), 50))
    use(HOME)
    for name in ROUTES:
        for key, values in table[name]["ms"].items():
            print(f"schedule {name}: {key}: "
                  + " ".join(f"{m:.5f}" for m in values)
                  + f" ms per launch [{card}]", flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "norm_routes.json").write_text(json.dumps(
        {"card": card, "rows": ROWS, "routes": table}, indent=1))
    print(f"wrote {OUT_DIR / 'norm_routes.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
