"""`TorchSigBackend`: the notary's committee audit on the card.

One audit is: marshal on the host (hash each message to G1, limb planes
for signatures and pubkeys, padded rows and committee width), one
`torch.as_tensor` per plane onto the device, then four kernel launches on
the current stream (G1 committee sums, G2 committee sums, the Miller
product, the final exponentiation) and a `.cpu()` pull of the verdicts in
`VerdictFuture.result()`.
"""

from __future__ import annotations

import time

import torch

from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.sigbackend import SigBackend, VerdictFuture
from gethsharding_tpu_torch.sigbackend import marshal


def committee_planes(messages, sig_rows, pk_rows):
    """Marshal one audit on the host: the numpy planes of
    `bls_aggregate_verify_committee_batch` in its argument order (hx, hy,
    sigx, sigy, sig_mask, pkx, pky, pk_mask, valid), rows padded to
    `marshal.bucket_size` and the committee to `marshal.committee_width`."""
    pad = marshal.bucket_size(len(messages)) - len(messages)
    width = marshal.committee_width(sig_rows, pk_rows)
    host = marshal.committee_host_planes(messages, sig_rows, pad, width)
    px, py, pm = bn.g2_committee_to_limbs(list(pk_rows) + [[]] * pad, width)
    return (host["hx"], host["hy"], host["sx"], host["sy"], host["sm"], px,
            py, pm, host["hok"])


class TorchSigBackend(SigBackend):
    """The committee audit through the CUDA kernels (`device=None` is the
    card) or, with `device="cpu"`, through their plain versions."""

    name = "torch"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # host seconds of the last audit's marshal and launch staging
        self.last_timing: dict | None = None

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None) -> VerdictFuture:
        # pk_row_keys is accepted for the API's sake: the port has no
        # resident pubkey cache yet, so every audit ships its G2 planes
        n = len(messages)
        if n == 0:
            future = VerdictFuture(lambda: [])
            future.result()
            return future
        t0 = time.perf_counter()
        planes = committee_planes(messages, sig_rows, pk_rows)
        t1 = time.perf_counter()
        out = bn.bls_aggregate_verify_committee_batch(
            *(torch.as_tensor(a, device=self.device) for a in planes))
        self.last_timing = {"marshal_s": t1 - t0,
                            "launch_s": time.perf_counter() - t1,
                            "rows": n, "bucket": planes[0].shape[0],
                            "width": planes[2].shape[1]}
        return VerdictFuture(lambda: [bool(v) for v in out.cpu()[:n].tolist()])
