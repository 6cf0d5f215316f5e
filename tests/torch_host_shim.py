"""Build one of the port's CUDA sources for the host, for the tests.

g++ compiles `gethsharding_tpu_torch/csrc/<source>` under a shim that
gives every block one thread: each phase's block-stride loop then runs
its items in order in that thread and `__syncthreads()` is a no-op,
which is a legal schedule of the kernels' block-cooperative loops. A
runner appended to the source launches the blocks one after another. This
checks a kernel's arithmetic and indexing where no card is; the card
itself is checked by tests/test_torch_cuda.py and chip_smoke.py. Blocks
that meet through a counter (`atomicAdd`) run in order, so the last in
order finishes last. tests/test_torch_megakernels.py builds the audit
kernels with the same shim and its own runners."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

SRC_DIR = Path(__file__).resolve().parents[1] / "gethsharding_tpu_torch" \
    / "csrc"

SHIM = r"""
struct Dim { unsigned x, y, z; };
static Dim threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct int4 { int x, y, z, w; };
inline void __syncthreads() {}
inline void __threadfence() {}
inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }
template <class T> inline T __ldcg(const T* p) { return *p; }
"""


def build(tmp: Path, source: str, runner: str) -> ctypes.CDLL:
    """`source` (a file of csrc/) with `runner` appended, as a shared
    library in `tmp`; skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the host")
    (tmp / "shim.h").write_text(SHIM)
    src = tmp / (Path(source).stem + ".cpp")
    src.write_text(f'#include "{SRC_DIR / source}"\n' + runner)
    lib = tmp / f"lib{Path(source).stem}.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-include",
                    str(tmp / "shim.h"), str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))
