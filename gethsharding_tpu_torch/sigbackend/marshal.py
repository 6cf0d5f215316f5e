"""Host -> limb marshalling for the committee audit: the padding policy
and the fresh-per-period planes. Pure host arithmetic, no device."""

from __future__ import annotations

from typing import Sequence

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.ops import bn256 as bn


def bucket_size(n: int) -> int:
    """The batch padding policy: powers of two up to 8, then quarter-
    power-of-two buckets (…, 64, 80, 96, 112, 128, …), so a 100-shard
    audit pads to 112 rows."""
    if n <= 8:
        size = 1
        while size < n:
            size *= 2
        return size
    size = 8
    while size * 2 < n:
        size *= 2
    quarter = size // 4
    return -(-n // quarter) * quarter


def committee_width(sig_rows: Sequence[Sequence],
                    pk_rows: Sequence[Sequence]) -> int:
    """The committee-axis padding policy: the bucket below 32, the next
    multiple of 16 above (135 -> 144)."""
    width = max([1] + [len(r) for r in sig_rows]
                + [len(r) for r in pk_rows])
    return bucket_size(width) if width <= 32 else -(-width // 16) * 16


def committee_host_planes(messages: Sequence[bytes],
                          sig_rows: Sequence[Sequence],
                          pad: int, width: int) -> dict:
    """Message hashes and signature planes with masks, padded by `pad`
    empty rows: hx, hy (B, 25), hok (B,), sx, sy (B, width, 25), sm
    (B, width)."""
    hashes = [bls.hash_to_g1(bytes(m)) for m in messages] + [None] * pad
    hx, hy, hok = bn.g1_to_limbs(hashes)
    sx, sy, sm = bn.g1_committee_to_limbs(list(sig_rows) + [[]] * pad, width)
    return {"hx": hx, "hy": hy, "hok": hok, "sx": sx, "sy": sy, "sm": sm}
