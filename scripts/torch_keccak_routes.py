"""Time other forms of `keccak_fixed.cu`'s warp route against each other.

The kernel keeps one form: a lane a word of the state, 24 rounds
unrolled. This script builds `csrc/keccak_fixed.cu` alone, once per form,
into `gethsharding_tpu_torch/_build/keccak_routes/<n>/` (nvcc, sm_90a,
each with its ptxas line) and times `gs_keccak_fixed` on the warp route
with CUDA events: the state root over 4,096 accounts (one message of
245,760 bytes, 1,808 permutations in turn) and the stress step's roots
(1,024 messages of 180 bytes). Each digest is checked against the host
keccak. The forms:

- a lane a word (25 lanes), the round loop unrolled 24, 8, 2 or 1 times
  (`KF_WARP_UNROLL` set in the copy); unrolled 24 also without the
  kernel's minimum of one block an SM in its launch bounds (`default
  registers`: ptxas picks its register count itself);
- the same with sa column-major (`column_major`: 16-byte parity loads),
  its columns 8 or 10 words apart;
- a lane a row (5 lanes, each five words in registers, chi in the lane):
  its `sponge_warp` below replaces the kernel's in a copy of the source.

Needs an NVIDIA card and nvcc; imports nothing of JAX.

    python3 scripts/torch_keccak_routes.py [--out FILE]
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gethsharding_tpu_torch.crypto.keccak import keccak256  # noqa: E402
from gethsharding_tpu_torch.ops import _build  # noqa: E402

# The lane-a-row form: lane y < 5 keeps row y (words x + 5y) in registers.
# A round stores the row (sa, row-major, 8 words a row), reads the other
# rows for the five column parities, applies theta and rho to its words,
# scatters them to their pi destinations (sb, row-major, 5 words a row),
# reads its new row back and applies chi and iota in the lane. Lanes 5-31
# leave at once; the syncs name lanes 0-4.
ROW_FORM = r"""
template <int UNROLL>
__device__ __forceinline__ void sponge_warp(const unsigned char* m,
                                            long long len, unsigned char* o,
                                            u64* sa, u64* sb, int lane) {
  if (lane >= 5) return;
  const int y = lane;
  const bool aligned = (reinterpret_cast<unsigned long long>(m) & 7) == 0;
  const long long blocks = len / KF_RATE + 1;
  u64 w[5], next[5];
  int rho[5], dst[5];
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    const int l = x + 5 * y;
    rho[x] = KF_RHO[l];
    dst[x] = 5 * ((2 * x + 3 * y) % 5) + y;
    w[x] = 0;
    next[x] = l < KF_RATE_LANES ? block_word(m, len, 0, l, aligned) : 0;
  }
  for (long long b = 0; b < blocks; ++b) {
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const int l = x + 5 * y;
      w[x] ^= next[x];
      next[x] = l < KF_RATE_LANES && b + 1 < blocks
                    ? block_word(m, len, b + 1, l, aligned)
                    : 0;
    }
#pragma unroll (UNROLL)
    for (int round = 0; round < 24; ++round) {
#pragma unroll
      for (int x = 0; x < 5; ++x) sa[8 * y + x] = w[x];
      __syncwarp(0x1f);
      u64 c[5];
#pragma unroll
      for (int x = 0; x < 5; ++x)
        c[x] = xor3(xor3(sa[x], sa[8 + x], sa[16 + x]), sa[24 + x],
                    sa[32 + x]);
#pragma unroll
      for (int x = 0; x < 5; ++x)
        store_rotated(sb + dst[x],
                      xor3(w[x], c[(x + 4) % 5], rotl<1>(c[(x + 1) % 5])),
                      rho[x]);
      __syncwarp(0x1f);
      u64 r[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) r[x] = sb[5 * y + x];
#pragma unroll
      for (int x = 0; x < 5; ++x)
        w[x] = r[x] ^ (~r[(x + 1) % 5] & r[(x + 2) % 5]);
      if (y == 0) w[0] ^= KECCAK_RC[round];
    }
  }
  if (y == 0)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[8 * x + j] = (unsigned char)(w[x] >> (8 * j));
}

"""



def column_major(stride: int):
    """The lane-a-word form with sa column-major, a column `stride` words
    apart (16-byte aligned), its parities read as two 16-byte loads and
    one 8-byte load a column. At 8 words columns 0, 2 and 4 share their
    banks (three-way conflicts); at 10 no two columns do."""
    def patch(src: str) -> str:
        edits = [
            ("      for (int k = 0; k < KF_TRIPS; ++k) sa[idx[k]] = own[k];",
             f"      for (int k = 0; k < KF_TRIPS; ++k) sa[idx[k] < 25 ? "
             f"{stride} * (idx[k] % 5) + idx[k] / 5 : {5 * stride} + "
             f"idx[k] - 25] = own[k];"),
            ("    cl[k] = sa + (x + 4) % 5;",
             f"    cl[k] = sa + {stride} * ((x + 4) % 5);"),
            ("    cr[k] = sa + (x + 1) % 5;",
             f"    cr[k] = sa + {stride} * ((x + 1) % 5);"),
            ("  return xor3(xor3(c[0], c[5], c[10]), c[15], c[20]);",
             "  const ulonglong2 a = reinterpret_cast<const ulonglong2*>(c)"
             "[0];\n  const ulonglong2 b = reinterpret_cast<const "
             "ulonglong2*>(c)[1];\n  return xor3(xor3(a.x, a.y, b.x), b.y, "
             "c[4]);"),
            ("  __shared__ u64 state[KF_WARPS][2][32];",
             "  __shared__ __align__(16) u64 state[KF_WARPS][2][64];")]
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"the source lacks {old!r}")
            src = src.replace(old, new)
        return src
    return patch


def default_registers(src: str) -> str:
    """The kernel's launch bounds without their minimum of blocks."""
    old = "__launch_bounds__(KF_THREADS, 1)"
    if old not in src:
        raise RuntimeError(f"the source lacks {old!r}")
    return src.replace(old, "__launch_bounds__(KF_THREADS)")


FORMS = [("lane a word, unrolled 24 (the kernel)", 24, None),
         ("lane a word, unrolled 24, default registers", 24,
          default_registers),
         ("lane a word, unrolled 8", 8, None),
         ("lane a word, unrolled 2", 2, None),
         ("lane a word, not unrolled", 1, None),
         ("lane a word, columns 8 words apart", 24, column_major(8)),
         ("lane a word, columns 10 words apart", 24, column_major(10)),
         ("lane a row, unrolled 24", 24, ROW_FORM),
         ("lane a row, unrolled 2", 2, ROW_FORM)]
UNROLL = "constexpr int KF_WARP_UNROLL = 24;"


def build_form(i: int, unroll: int, body) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "keccak_routes" / str(i)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for name in ("keccak_fixed.cu", "keccak.cuh"):
        shutil.copy(_build.SRC_DIR / name, out / name)
    src = (out / "keccak_fixed.cu").read_text()
    if UNROLL not in src:
        raise RuntimeError(f"the source lacks {UNROLL!r}")
    src = src.replace(UNROLL, f"constexpr int KF_WARP_UNROLL = {unroll};")
    if callable(body):
        src = body(src)
    elif body is not None:
        start = src.index("template <int UNROLL>\n__device__ __forceinline__"
                          " void sponge_warp")
        end = src.index("// One message on one thread")
        src = src[:start] + body + src[end:]
    (out / "keccak_fixed.cu").write_text(src)
    done = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
         str(out / "keccak_fixed.cu"), "-o", str(out / "lib.so")],
        capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if re.search(r"registers|stack frame", line):
            print(f"    {line.strip()}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.gs_keccak_fixed.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_void_p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_keccak_routes: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    rng = np.random.default_rng(5)
    shapes = {"root over 4,096 accounts": (1, 245_760),
              "stress roots": (1024, 180)}
    data = {k: torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                               device="cuda") for k, s in shapes.items()}
    want = {k: [keccak256(bytes(r)) for r in d.cpu().numpy()]
            for k, d in data.items()}
    results = []
    for i, (name, unroll, body) in enumerate(FORMS):
        print(f"{name}:", flush=True)
        lib = build_form(i, unroll, body)
        row = {"form": name}
        for k, d in data.items():
            n, length = d.shape
            out = torch.zeros((n, 32), dtype=torch.uint8, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                if lib.gs_keccak_fixed(d.data_ptr(), n, length,
                                       out.data_ptr(), stream):
                    raise RuntimeError(f"{name}: launch failed")

            run()
            torch.cuda.synchronize()
            if [bytes(r) for r in out.cpu().numpy()] != want[k]:
                chip_smoke.fail(f"{name}: digests differ at {k}")
            row[k] = chip_smoke.cuda_ms(run, 5 if n == 1 else 20)
        perms = 245_760 // 136 + 1
        row["us_a_permutation"] = row["root over 4,096 accounts"] / perms \
            * 1e3
        print(f"  {row} [{card}]", flush=True)
        results.append(row)
    line = json.dumps({"card": card, "forms": results})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
