"""Host -> limb marshalling: the padding policy, the committee audit's
fresh-per-period planes and the row keys of the line-table cache, and the
recovery's signature planes. Pure host arithmetic, no device."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import secp256k1 as secp


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


def normalize_row_keys(pk_row_keys, n_rows: int):
    """Exactly one key per (padded) row: a short list leaves the trailing
    rows uncached (None), a surplus is dropped; None stays None (no
    cache)."""
    if pk_row_keys is None:
        return None
    keys = list(pk_row_keys)[:n_rows]
    return keys + [None] * (n_rows - len(keys))


def ecrecover_host_planes(digests: Sequence[bytes],
                          sigs65: Sequence[bytes]):
    """The recovery's planes (e, r, s, recid, valid), padded to
    `bucket_size`, and the rows left to the host. Only 65-byte signatures
    with v in {0, 1} are valid on the device; v in {2, 3} (r + n
    overflow) is listed for the host, and every other row is a
    placeholder (r = s = 1) with valid False."""
    n = len(digests)
    bucket = bucket_size(n)
    placeholder = ecdsa.Signature(r=1, s=1, v=0)
    sigs, valid, host_rows = [], [], []
    for i, sig in enumerate(sigs65):
        sig = bytes(sig)
        if len(sig) == 65 and sig[64] in (0, 1):
            sigs.append(ecdsa.Signature.from_bytes65(sig))
            valid.append(True)
        else:
            if len(sig) == 65 and sig[64] in (2, 3):
                host_rows.append(i)
            sigs.append(placeholder)
            valid.append(False)
    sigs.extend([placeholder] * (bucket - n))
    valid.extend([False] * (bucket - n))
    e = secp.hashes_to_limbs([bytes(d) for d in digests]
                             + [b"\x00" * 32] * (bucket - n))
    r, s, v = secp.sigs_to_limbs(sigs)
    return (e, r, s, v, np.asarray(valid)), host_rows
