"""Build host C sources of `csrc/` into a shared library that `ctypes`
loads: the compiled keccak (`csrc/keccak.c`), scrypt's ROMix
(`csrc/scrypt.c`) and the bulk trie root (`csrc/mpt.c` with the keccak it
calls).

`build(sources, lib)` compiles `sources` (one path or a list) with the
host C compiler (`$CC`, else `cc`) into one library `lib` when the library
is missing or a source changed (the hash of the sources, in order, is kept
beside it, in `<lib>.sha256`). The check and the build run under
`utils/filelock.py::build_lock` on the library's directory, so processes
that start together build it once; the library is written to a temporary
name first and moved into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence, Union

from gethsharding_tpu_torch.utils.filelock import build_lock

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"


def build(sources: Union[Path, Sequence[Path]], lib: Path) -> Path:
    sources = [sources] if isinstance(sources, Path) else list(sources)
    h = hashlib.sha256()
    for source in sources:
        h.update(source.read_bytes())
    digest = h.hexdigest()
    stamp = lib.with_name(lib.name + ".sha256")
    with build_lock(lib.parent):
        if lib.exists() and stamp.exists() \
                and stamp.read_text().strip() == digest:
            return lib
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            out = Path(tmp) / lib.name
            proc = subprocess.run(
                [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
                 "-o", str(out), *map(str, sources)], capture_output=True,
                text=True, timeout=120)
            if proc.returncode != 0:
                names = " ".join(s.name for s in sources)
                raise subprocess.SubprocessError(
                    f"cc failed on {names}:\n{proc.stderr}")
            os.replace(out, lib)
            stamp.write_text(digest + "\n")
    return lib
