"""Canonical RLP (Recursive Length Prefix) codec (the port's copy of the
JAX package's `utils/rlp.py`).

Byte-compatible with the reference encoder/decoder (`rlp/encode.go`,
`rlp/decode.go` in go-ethereum 1.8.9): every consensus object in the
framework (collation headers, transactions, trie nodes, blob payloads) is
hashed over its RLP encoding, so canonical-form strictness matters.

Model: an RLP *item* is either `bytes` or a `list` of items. Integers are
encoded big-endian with no leading zeros (zero encodes as the empty string),
matching the reference's `uint`/`*big.Int` writers. `None` encodes as the
empty string, matching the reference's nil-pointer rule for byte-array
element types (`rlp/doc.go`: "a nil pointer to an array encodes as an empty
string").
"""

from __future__ import annotations

from typing import Any, List, Tuple, Union

RLPItem = Union[bytes, List["RLPItem"]]


class DecodingError(ValueError):
    """Raised on malformed or non-canonical RLP input."""


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    length_bytes = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(length_bytes)]) + length_bytes


def int_to_big_endian(value: int) -> bytes:
    """Minimal big-endian encoding; 0 -> b'' (canonical RLP integer form)."""
    if value < 0:
        raise ValueError("RLP cannot encode negative integers")
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def big_endian_to_int(data: bytes) -> int:
    return int.from_bytes(data, "big")


def rlp_encode_int(value: int) -> bytes:
    return rlp_encode(int_to_big_endian(value))


def rlp_encode(item: Any) -> bytes:
    """Encode bytes / int / bool / None / str / (nested) sequences."""
    if isinstance(item, (bytes, bytearray, memoryview)):
        data = bytes(item)
        if len(data) == 1 and data[0] < 0x80:
            return data
        return _encode_length(len(data), 0x80) + data
    if isinstance(item, bool):  # before int: bool is an int subclass
        return rlp_encode(b"\x01" if item else b"")
    if isinstance(item, int):
        return rlp_encode(int_to_big_endian(item))
    if item is None:
        return b"\x80"
    if isinstance(item, str):
        return rlp_encode(item.encode("utf-8"))
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(sub) for sub in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode object of type {type(item)!r}")


def _decode_item(data: bytes, pos: int) -> Tuple[RLPItem, int]:
    if pos >= len(data):
        raise DecodingError("unexpected end of input")
    prefix = data[pos]
    if prefix < 0x80:  # single byte, self-encoding
        return bytes([prefix]), pos + 1
    if prefix <= 0xB7:  # short string
        length = prefix - 0x80
        end = pos + 1 + length
        if end > len(data):
            raise DecodingError("string extends past end of input")
        payload = data[pos + 1 : end]
        if length == 1 and payload[0] < 0x80:
            raise DecodingError("non-canonical single byte (should self-encode)")
        return payload, end
    if prefix <= 0xBF:  # long string
        lenlen = prefix - 0xB7
        if pos + 1 + lenlen > len(data):
            raise DecodingError("length bytes extend past end of input")
        length_bytes = data[pos + 1 : pos + 1 + lenlen]
        if length_bytes[0] == 0:
            raise DecodingError("length has leading zero bytes")
        length = big_endian_to_int(length_bytes)
        if length < 56:
            raise DecodingError("long-form length used for short string")
        end = pos + 1 + lenlen + length
        if end > len(data):
            raise DecodingError("string extends past end of input")
        return data[pos + 1 + lenlen : end], end
    if prefix <= 0xF7:  # short list
        length = prefix - 0xC0
        end = pos + 1 + length
        if end > len(data):
            raise DecodingError("list extends past end of input")
        return _decode_list(data, pos + 1, end), end
    # long list
    lenlen = prefix - 0xF7
    if pos + 1 + lenlen > len(data):
        raise DecodingError("length bytes extend past end of input")
    length_bytes = data[pos + 1 : pos + 1 + lenlen]
    if length_bytes[0] == 0:
        raise DecodingError("length has leading zero bytes")
    length = big_endian_to_int(length_bytes)
    if length < 56:
        raise DecodingError("long-form length used for short list")
    end = pos + 1 + lenlen + length
    if end > len(data):
        raise DecodingError("list extends past end of input")
    return _decode_list(data, pos + 1 + lenlen, end), end


def _decode_list(data: bytes, start: int, end: int) -> List[RLPItem]:
    items: List[RLPItem] = []
    pos = start
    while pos < end:
        item, pos = _decode_item(data, pos)
        if pos > end:
            raise DecodingError("element extends past end of list")
        items.append(item)
    return items


def rlp_decode(data: bytes) -> RLPItem:
    """Decode a single RLP item; rejects trailing bytes and non-canonical forms."""
    item, end = _decode_item(bytes(data), 0)
    if end != len(data):
        raise DecodingError(f"trailing bytes after RLP item ({len(data) - end})")
    return item


def decode_int(data: bytes) -> int:
    """Canonical RLP integer from its byte payload (no leading zeros)."""
    if len(data) > 0 and data[0] == 0:
        raise DecodingError("integer has leading zero bytes")
    return big_endian_to_int(data)
