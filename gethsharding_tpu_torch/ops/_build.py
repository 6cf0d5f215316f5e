"""Build, load and launch the kernels: `csrc/*.cu` -> `_build/libmegakernels.so`.

Each `.cu` file is compiled by its own `nvcc` process for `sm_90a`, all
started together, and the objects are linked into one shared library with
a plain C interface that `ctypes` loads. The library is rebuilt when the
hash of the sources and flags changes; the hash is written beside it. The
sources come from this package's `csrc/` only.

The build runs at the first kernel launch, so a fresh checkout needs no
step of its own. Nothing here runs at import.

`Kernel` binds one entry point (looked up once, at its first launch): it
launches on PyTorch's current stream, raises on a non-zero CUDA error,
and counts its launches. Every `Kernel` made is listed in `KERNELS`, so
a caller can count the launches of a whole run (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from gethsharding_tpu_torch.utils.filelock import build_lock

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libmegakernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points (every pointer and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "gs_agg_g1": [_P, _P, _P, _I, _I, _I, _I] + [_P] * 7,
    "gs_agg_g2": [_P, _P, _P, _I, _I, _I, _I] + [_P] * 7,
    "gs_agg_plan": [_I, _I, _P],
    "gs_miller": [_P] * 9 + [_I, _P, _P, _P, _I, _P, _P],
    "gs_finalexp": [_P, _P, _I, _P, _I, _P, _P],
    "gs_norm": [_P, _L, _I, _I, _P, _P, _P, _P],
    "gs_norm_carry": [_P, _L, _I, _P, _P],
    "gs_norm_tail": [_P, _L, _P, _P, _P],
    "gs_conv": [_P, _P, _L, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "gs_tower": [_I, _I, _P, _P, _L, _I, _P, _P, _I, _P, _P],
    "gs_ecrecover": [_P] * 5 + [_I, _I] + [_P] * 4,
    "gs_das_samples": [_P] * 6 + [_I, _P, _P],
    "gs_keccak_fixed": [_P, _L, _L, _P, _P],
    "gs_replay": [_P] * 13 + [_I] * 4 + [_P] * 7,
}

_lib = None
# first users on several threads (a node's services) build and load once
_lib_lock = threading.Lock()
build_log = ""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the audit kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels if the library is missing or stale; returns
    its path. The compiler's register and shared-memory report of the
    last build is kept in `build_log`. The stamp's check and the build
    run under a lock on `BUILD_DIR` held across processes, so processes
    that start together (a chain process and its actors) build once."""
    global build_log
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    with build_lock(BUILD_DIR):
        if (lib.exists() and stamp.exists()
                and stamp.read_text().strip() == digest):
            return lib
        nvcc = nvcc_path()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs, procs = [], []
            for src in sources():
                obj = Path(tmp) / (src.stem + ".o")
                objs.append(obj)
                procs.append((src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = [], []
            for src, proc in procs:
                out, _ = proc.communicate()
                logs.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
            build_log = "\n".join(logs)
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
            tmp_lib = Path(tmp) / LIB_NAME
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                 *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(
                    f"link failed:\n{link.stdout}{link.stderr}")
            os.replace(tmp_lib, lib)
            stamp.write_text(digest + "\n")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once, whatever the
    number of threads that ask first)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    """cudaGetErrorString for a code returned by an entry point."""
    fn = library().gs_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return f"cudaError {code} ({fn(code).decode()})"


class Kernel:
    """One hand-written CUDA kernel: its C entry point in the built
    library, where its source is, which TPU kernel it replaces, and how
    many times it was launched (one per launch, nowhere else)."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def launch(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.symbol)
        # the current stream's handle, without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with "
                               f"{error_string(err)}")
        with _count_lock:  # backends on several threads launch it
            self.launches += 1


KERNELS: dict = {}
_count_lock = threading.Lock()


def launch_counts() -> dict:
    """Launches so far of every kernel, by name."""
    return {name: k.launches for name, k in KERNELS.items()}


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_tensor(t, shape, name: str, dtype=torch.int32) -> None:
    """What every entry point takes: a contiguous CUDA tensor of the given
    shape and type (int32 unless said)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
