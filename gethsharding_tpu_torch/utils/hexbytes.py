"""Fixed-size byte wrappers: Hash32 and Address20 (the port's copy of the
JAX package's `utils/hexbytes.py`).

Parity with the reference's `common.Hash` / `common.Address`
(`common/types.go`): fixed-length byte values with hex formatting, usable as
dict keys, hashable, and convertible from ints/hex strings.
"""

from __future__ import annotations


def to_hex(data: bytes) -> str:
    return "0x" + data.hex()


class _FixedBytes(bytes):
    SIZE = 0

    def __new__(cls, value=b""):
        if isinstance(value, str):
            raw = bytes.fromhex(value[2:] if value.startswith("0x") else value)
        elif isinstance(value, int):
            raw = value.to_bytes(cls.SIZE, "big")
        else:
            raw = bytes(value)
        if len(raw) > cls.SIZE:
            # keep the low-order bytes, like common.BytesToHash
            raw = raw[-cls.SIZE :]
        raw = raw.rjust(cls.SIZE, b"\x00")
        return super().__new__(cls, raw)

    @property
    def hex_str(self) -> str:
        return to_hex(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}({to_hex(self)})"

    def to_int(self) -> int:
        return int.from_bytes(self, "big")


class Hash32(_FixedBytes):
    SIZE = 32


class Address20(_FixedBytes):
    SIZE = 20


ZERO_HASH = Hash32()
ZERO_ADDRESS = Address20()
