"""`TorchSigBackend`: the notary's committee audit on the card.

An audit with `pk_row_keys` (the notary always passes them) takes the
fixed-base precomputation path, the reference's default:

1. marshal on the host the message hashes and signature planes, and the
   pubkey planes of the rows whose line table is not resident (misses);
2. one `precompute_g2_lines` over all misses (G2 sums, then the pubkey
   walk) and insert their tables into the `LineTableCache`;
3. stack the tables of hits, misses and empty rows on the device;
4. the G1 sums, `miller_loop_precomp` and the final exponentiation;
5. a `.cpu()` pull of the verdicts in `VerdictFuture.result()`.

A warm audit ships no G2 bytes. An audit without keys takes the recompute
path, as the reference falls back: every pubkey plane shipped, then four
launches (G1 sums, G2 sums, the Miller kernel, the final exponentiation).
Normalizes and tower products between them run in their own kernels.
"""

from __future__ import annotations

import time

import torch

from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import _build
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.sigbackend import SigBackend, VerdictFuture
from gethsharding_tpu_torch.sigbackend import marshal
from gethsharding_tpu_torch.sigbackend.cache import LineTableCache


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
    card) or, with `device="cpu"`, through their plain versions. Line
    tables stay resident in `lines`, a `LineTableCache` under its default
    budget."""

    name = "torch"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.lines = LineTableCache(self.device)
        # host seconds of the last audit's marshal and launch staging, its
        # path, G2 bytes shipped, resident rows, whether the batch memo
        # served them, and kernel launches
        self.last_timing: dict | None = None

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None) -> VerdictFuture:
        n = len(messages)
        if n == 0:
            future = VerdictFuture(lambda: [])
            future.result()
            return future
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = marshal.bucket_size(n)
        keys = marshal.normalize_row_keys(pk_row_keys, bucket)
        if keys is None:
            planes = committee_planes(messages, sig_rows, pk_rows)
            t1 = time.perf_counter()
            out = bn.bls_aggregate_verify_committee_batch(
                *(torch.as_tensor(a, device=self.device) for a in planes))
            g2_bytes = sum(a.nbytes for a in planes[5:8])
            hit_rows, memo, width = 0, False, planes[2].shape[1]
        else:
            out, t1, g2_bytes, hit_rows, memo, width = self._precomp_audit(
                messages, sig_rows, pk_rows, keys, bucket)
        after = _build.launch_counts()
        self.last_timing = {
            "marshal_s": t1 - t0, "launch_s": time.perf_counter() - t1,
            "rows": n, "bucket": bucket, "width": width,
            "precomp": keys is not None, "g2_wire_bytes": int(g2_bytes),
            "hit_rows": hit_rows, "memo": memo,
            "launches": {k: v - before.get(k, 0) for k, v in after.items()}}
        return VerdictFuture(lambda: [bool(v) for v in out.cpu()[:n].tolist()])

    def _precomp_audit(self, messages, sig_rows, pk_rows, keys, bucket):
        pad = bucket - len(messages)
        width = marshal.committee_width(sig_rows, pk_rows)
        host = marshal.committee_host_planes(messages, sig_rows, pad, width)
        plan = self.lines.resolve(list(pk_rows) + [[]] * pad, keys, bucket)
        g2 = ()
        if plan.memo is None and plan.misses:
            g2 = bn.g2_committee_to_limbs([row for row, _ in plan.misses],
                                          width)
        t1 = time.perf_counter()
        dev = lambda a: torch.as_tensor(a, device=self.device)
        missed = bn.precompute_g2_lines(*map(dev, g2)) if g2 else None
        table, inf = self.lines.assemble(plan, missed)
        out = bn.bls_verify_committee_precomp_batch(
            dev(host["hx"]), dev(host["hy"]), dev(host["sx"]),
            dev(host["sy"]), dev(host["sm"]), table, inf, dev(host["hok"]))
        return (out, t1, sum(a.nbytes for a in g2), plan.hit_rows,
                plan.memo is not None, width)
