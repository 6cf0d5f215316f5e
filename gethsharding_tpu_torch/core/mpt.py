"""The bulk Merkle-Patricia root of a list of (key, value) pairs, built in C
(`csrc/mpt.c`, the port's copy of the JAX package's `native/mpt.c`, with
the keccak it calls, `csrc/keccak.c`): the native route of
`derive_sha.derive_sha` (the per-byte chunk roots) and of
`state_processor.state_trie_root`.

The library is built with the host C compiler (`$CC`, else `cc`) on first
use into `_build/libmpt.so` (`crypto/hostlib.py`, under the build lock)
and bound with ctypes. `mpt_root` returns None where the build or the load
failed (logged once) or where a key or a value exceeds the builder's caps
(the JAX package's `native.py` caps), and the caller then builds the root
in the Python trie (`core/trie.py`), which is the twin of this route in
the tests. Values are the logical value bytes: the builder RLP-wraps them
inside the nodes, as the Python trie does.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from typing import Optional, Sequence

from gethsharding_tpu_torch.crypto import hostlib

log = logging.getLogger(__name__)

KEY_CAP = 32     # a secure trie's keccak keys
VAL_CAP = 128    # a state account's RLP is at most 110 bytes

_SOURCES = (hostlib.SRC_DIR / "keccak.c", hostlib.SRC_DIR / "mpt.c")
_LIB = hostlib.BUILD_DIR / "libmpt.so"
_lock = threading.Lock()
_fn = None
_tried = False


def native_available() -> bool:
    """True where `mpt_root` runs the compiled builder."""
    return _native() is not None


def _native():
    """`gs_mpt_root` of the compiled library, built on first use; None,
    logged once, where no C compiler or no load succeeds."""
    global _fn, _tried
    if _tried:
        return _fn
    with _lock:
        if _tried:
            return _fn
        try:
            fn = ctypes.CDLL(str(hostlib.build(_SOURCES, _LIB))).gs_mpt_root
            fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                           ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                           ctypes.c_uint64, ctypes.c_char_p]
            fn.restype = ctypes.c_int
            _fn = fn
        except (OSError, subprocess.SubprocessError) as exc:
            log.warning("native trie root unavailable, building roots in "
                        "Python: %s", exc)
        _tried = True
    return _fn


def mpt_root(keys: Sequence[bytes], values: Sequence[bytes]
             ) -> Optional[bytes]:
    """The trie root over the pairs (a later duplicate key wins, as an
    update does); None where the compiled builder is unavailable or a key
    or a value exceeds the caps."""
    if len(keys) != len(values):
        raise ValueError("keys/values length mismatch")
    if any(len(k) > KEY_CAP for k in keys) \
            or any(len(v) > VAL_CAP for v in values):
        return None
    fn = _native()
    if fn is None:
        return None
    klens, vlens = bytes(map(len, keys)), bytes(map(len, values))
    # each pair padded to the longest key and value: the builder reads
    # them at these strides
    kstride = max(klens, default=0) or 1
    vstride = max(vlens, default=0) or 1
    kbuf = b"".join(bytes(k).ljust(kstride, b"\0") for k in keys)
    vbuf = b"".join(bytes(v).ljust(vstride, b"\0") for v in values)
    out = ctypes.create_string_buffer(32)
    rc = fn(kbuf, kstride, klens, vbuf, vstride, vlens, len(keys), out)
    if rc != 0:
        log.warning("gs_mpt_root failed rc=%d; building the root in Python",
                    rc)
        return None
    return out.raw
