"""A lock between processes around a build directory.

The chain process and the actor processes of a devnet start together,
and each builds the kernels it needs on first use into the package's
`_build/`. `build_lock(directory)` holds an exclusive `fcntl.flock` on
`directory/.build.lock` for the check of a library's stamp and its
build, so one process builds and the others wait and then find the
library current.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path


@contextlib.contextmanager
def build_lock(directory):
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    fd = os.open(directory / ".build.lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
