"""Where `csrc/secp256k1.cu` spends its cycles on the card.

Builds the kernel source with SECP_CLOCKS, which turns its SECP_CLOCK(i)
marks into clock64() reads of block 0's first thread, and times
`gs_ecrecover` with CUDA events at the notary vote period's rows
(`chip_smoke.vote_period`, seed 0) and at one row (the txpool's call),
with the cycles of its stages: the prologue (square root and r^-1),
G + R, the ladder (and its steps 191..64 on average) and the affine map.
It also times the field operations in one warp on their own, each a
chain of 64 dependent calls. Fails where a mark is missing from the
source or was not reached. Needs an NVIDIA card and nvcc; imports nothing
of JAX.

    python3 scripts/torch_secp_clocks.py
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa  # noqa: E402
from gethsharding_tpu_torch.crypto.keccak import keccak256  # noqa: E402
from gethsharding_tpu_torch.das import proofs as das  # noqa: E402
from gethsharding_tpu_torch.ops import _build  # noqa: E402
from gethsharding_tpu_torch.sigbackend import marshal  # noqa: E402

STAGES = ("prologue", "G + R", "ladder", "affine map")

MARKS = 7   # SECP_CLOCK(0) .. SECP_CLOCK(6) in the source

FIELD_OPS = r"""
namespace gs {
__global__ void field_ops(const unsigned* in, unsigned* out, int iters,
                          long long* clk) {
  Fe a, b;
  for (int j = 0; j < 8; ++j) {
    a.w[j] = in[16 * threadIdx.x + j];
    b.w[j] = in[16 * threadIdx.x + 8 + j];
  }
  long long t[5];
  t[0] = clock64();
  for (int i = 0; i < iters; ++i) a = fp_mul(a, b);
  t[1] = clock64();
  for (int i = 0; i < iters; ++i) a = fp_sqr(a);
  t[2] = clock64();
  for (int i = 0; i < iters; ++i) a = fp_lin(a, 3, b, -8);
  t[3] = clock64();
  for (int i = 0; i < iters; ++i) a = mont_mul(a, b, SECP_N);
  t[4] = clock64();
  for (int j = 0; j < 8; ++j) out[8 * threadIdx.x + j] = a.w[j];
  if (threadIdx.x == 0)
    for (int j = 0; j < 5; ++j) clk[j] = t[j];
}
}  // namespace gs

extern "C" int field_ops(const unsigned* in, unsigned* out, int iters,
                         long long* clk) {
  gs::field_ops<<<1, 32>>>(in, out, iters, clk);
  return (int)cudaDeviceSynchronize();
}
"""

CLOCKED = r"""
extern "C" int launch(const int* e, const int* r, const int* s,
                      const int* recid, const unsigned char* valid, int n,
                      int nl, int* qx, int* qy, unsigned char* ok) {
  return gs_ecrecover(e, r, s, recid, valid, n, nl, qx, qy, ok, 0);
}

extern "C" int clocked(const int* e, const int* r, const int* s,
                       const int* recid, const unsigned char* valid, int n,
                       int nl, int* qx, int* qy, unsigned char* ok,
                       long long* clk) {
  const long long zero[8] = {0};
  int err = (int)cudaMemcpyToSymbol(gs::g_clk, zero, sizeof zero);
  if (!err) err = gs_ecrecover(e, r, s, recid, valid, n, nl, qx, qy, ok, 0);
  if (!err) err = (int)cudaDeviceSynchronize();
  if (!err) err = (int)cudaMemcpyFromSymbol(clk, gs::g_clk, 8 * 8);
  return err;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    source = _build.SRC_DIR / "secp256k1.cu"
    src = source.read_text()
    missing = [i for i in range(MARKS) if f"SECP_CLOCK({i});" not in src]
    if missing:
        chip_smoke.fail(f"{source} lacks the marks SECP_CLOCK{missing}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "secp_clocks.cu"
    lib_path = _build.BUILD_DIR / "libsecp_clocks.so"
    cu.write_text("#define SECP_CLOCKS\n" + src + FIELD_OPS + CLOCKED)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.SRC_DIR), "-shared", "-o", str(lib_path),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.clocked.argtypes = [P] * 5 + [ctypes.c_int, ctypes.c_int] + [P] * 4
    lib.launch.argtypes = lib.clocked.argtypes[:-1]
    ptr = lambda t: P(t.data_ptr())
    card = chip_smoke.card_line()
    dev = torch.device("cuda")

    lib.field_ops.argtypes = [P, P, ctypes.c_int, P]
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, 16 * 32, dtype=np.uint64)
    inp = torch.as_tensor(words.astype(np.uint32).view(np.int32),
                          device=dev)
    out = torch.zeros(8 * 32, dtype=torch.int32, device=dev)
    clk = torch.zeros(5, dtype=torch.int64, device=dev)
    if lib.field_ops(ptr(inp), ptr(out), 64, ptr(clk)):
        chip_smoke.fail("the field operations did not run")
    c = clk.cpu().tolist()
    ops = ("fp_mul", "fp_sqr", "fp_lin", "mont_mul (mod n)")
    print(f"{source.name}: one warp, cycles per dependent call: "
          + ", ".join(f"{name} {(c[i + 1] - c[i]) / 64:.0f}"
                      for i, name in enumerate(ops)) + f" [{card}]")

    (digests, sigs65, _), _ = chip_smoke.vote_period(ecdsa, das, keccak256,
                                                     0)
    planes, _ = marshal.ecrecover_host_planes(digests, sigs65)
    rec = [torch.as_tensor(a, device=dev) for a in planes]
    qx, qy = torch.empty_like(rec[1]), torch.empty_like(rec[1])
    ok = torch.empty_like(rec[4])
    for n in (rec[0].shape[0], 1):
        marks = torch.zeros(8, dtype=torch.int64)
        args = [*map(ptr, rec), n, rec[1].shape[1], ptr(qx), ptr(qy),
                ptr(ok)]
        if lib.clocked(*args, ptr(marks)):
            chip_smoke.fail("the kernel did not run")
        m = marks.tolist()
        if not all(m[:MARKS]):
            chip_smoke.fail(f"a stage mark was not reached: {m[:MARKS]}")
        ms = chip_smoke.cuda_ms(lambda: lib.launch(*args), 10)
        stages = ", ".join(f"{name} {m[i + 1] - m[i]}"
                           for i, name in enumerate(STAGES))
        print(f"{source.name}: {n} rows, {ms:.4f} ms a launch (CUDA "
              f"events); block 0's cycles: {stages}; "
              f"{(m[6] - m[5]) / 128:.0f} a ladder step; total "
              f"{m[4] - m[0]} [{card}]")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"SM clock {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
