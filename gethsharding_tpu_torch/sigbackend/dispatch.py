"""`TorchSigBackend`: the notary's committee audit, and the check of
aggregate votes, on the card.

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

`precomp` (default `$GETHSHARDING_TORCH_PRECOMP`, "1"; the port's twin of
the reference's `GETHSHARDING_PRECOMP`) switches the precomp path off:
keyed audits then take the recompute path too. Both paths run in either
limb form (`GETHSHARDING_TORCH_LIMB_FORM`).

`bls_verify_aggregates` checks one host-aggregated vote per message:
hash each message to G1, ship the affine planes, then one Miller launch
and one final exponentiation (`bn.bls_verify_aggregate_batch`).
`das_verify_multiproofs` runs the DAS polynomial multiproofs of a period
on the same two launches, after the host folds each row into its three
pairing points (`das/poly_proofs.py`).

One lock serializes each call's host staging and launches: the serving
tier's watchdog can leave an abandoned dispatch thread inside a call
while a fresh one enters, and the staging planes, the line-table cache
and `last_timing` / `last_wire` are per-call state. The async committee
path pulls its verdicts outside the lock.

The notary's vote phase runs on two more kernels, one launch each:
`ecrecover_addresses` (the proposer signatures of a period,
`ops/secp256k1.py` on `csrc/secp256k1.cu`; the rare recovery ids 2 and 3
are recovered on the host) and `das_verify_samples` (samples × shards,
`das/proofs.py` on `csrc/das.cu`).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.das import poly_proofs
from gethsharding_tpu_torch.das import proofs as das_proofs
from gethsharding_tpu_torch.device import resolve_device
from gethsharding_tpu_torch.ops import _build
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import secp256k1 as secp
from gethsharding_tpu_torch.ops.limb import LIMB_FORM
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


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


class TorchSigBackend(SigBackend):
    """The committee audit through the CUDA kernels (`device=None` is the
    card) or, with `device="cpu"`, through their plain versions. With
    `precomp` (None: `$GETHSHARDING_TORCH_PRECOMP`, default on), keyed
    audits take the precomp path and line tables stay resident in
    `lines`, a `LineTableCache` under its default budget."""

    name = "torch"

    def __init__(self, device=None, precomp=None):
        self.device = resolve_device(device)
        if precomp is None:
            knob = os.environ.get("GETHSHARDING_TORCH_PRECOMP", "1")
            if knob not in ("0", "1"):
                raise ValueError(
                    f"GETHSHARDING_TORCH_PRECOMP={knob!r}: want 0 or 1")
            precomp = knob == "1"
        self.precomp = bool(precomp)
        self.lines = LineTableCache(self.device)
        # host seconds of the last call's marshal and launch staging, its
        # rows and bucket, kernel launches; for the audits also the path
        # and limb form, G2 bytes shipped, resident rows and whether the
        # batch memo served them
        self.last_timing: dict | None = None
        # the planes' bytes of the last `das_verify_samples` or
        # `das_verify_multiproofs`
        self.last_wire: dict | None = None
        # `das_verify_samples`' staging planes, by bucket
        self._sample_staging: dict = {}
        # held over each call's staging and launches (module docstring)
        self._lock = threading.Lock()

    def ecrecover_addresses(self, digests, sigs65):
        """One launch of the recovery kernel over the batch, padded to
        `marshal.bucket_size`. Only v in {0, 1} goes to the device; v in
        {2, 3} (r + n overflow, rare) is recovered on the host, anything
        else is None."""
        if len(digests) == 0:
            return []
        with self._lock:
            return self._ecrecover(digests, sigs65)

    def _ecrecover(self, digests, sigs65):
        n = len(digests)
        before = _build.launch_counts()
        t0 = time.perf_counter()
        planes, host_rows = marshal.ecrecover_host_planes(digests, sigs65)
        bucket = planes[0].shape[0]
        t1 = time.perf_counter()
        qx, qy, ok = secp.ecrecover_batch(
            *(torch.as_tensor(a, device=self.device) for a in planes))
        pubs = secp.limbs_to_pubkeys(qx, qy, ok)[:n]
        out = [ecdsa.pubkey_to_address(p) if p is not None else None
               for p in pubs]
        for i in host_rows:
            try:
                out[i] = ecdsa.ecrecover_address(
                    bytes(digests[i]),
                    ecdsa.Signature.from_bytes65(bytes(sigs65[i])))
            except (ValueError, AssertionError):
                out[i] = None
        self.last_timing = self._timing(before, t0, t1, n, bucket,
                                        host_rows=len(host_rows))
        return out

    def das_verify_samples(self, chunks, indices, proofs, roots):
        """One launch of the sample verifier over the batch, padded to
        `marshal.bucket_size`; malformed rows are folded into the `valid`
        plane on the host (`das_proofs.stage_samples`, into this bucket's
        staging planes). `last_timing` splits the call into the marshal,
        the upload with the kernel (`device_s`) and the readback."""
        with self._lock:
            if len(chunks) == 0:
                self.last_wire = None
                return []
            return self._das_samples(chunks, indices, proofs, roots)

    def _das_samples(self, chunks, indices, proofs, roots):
        n = len(chunks)
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = marshal.bucket_size(n)
        staged, arrays = self.sample_staging(bucket)
        das_proofs.stage_samples(chunks, indices, proofs, roots, arrays)
        sample_bytes = sum(int(a.nbytes) for a in arrays.values())
        self.last_wire = {"op": "das_verify_samples",
                          "wire_bytes": sample_bytes,
                          "sample_wire_bytes": sample_bytes,
                          "rows": n, "bucket": bucket}
        t1 = time.perf_counter()
        out = das_proofs.verify_planes(
            *(staged[k].to(self.device, non_blocking=True)
              for k in das_proofs.PLANES))
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        t2 = time.perf_counter()
        # the readback ends the call's use of the staging planes: the next
        # call may overwrite them
        res = [bool(b) for b in out.cpu()[:n].tolist()]
        self.last_timing = self._timing(before, t0, t1, n, bucket,
                                        device_s=t2 - t1,
                                        readback_s=time.perf_counter() - t2)
        return res

    def sample_staging(self, bucket: int):
        """This bucket's sample planes, kept for reuse: torch tensors
        (pinned on a CUDA backend, so uploads do not block) and numpy
        views of them, by plane name."""
        if bucket not in self._sample_staging:
            pin = self.device.type == "cuda"
            staged = {
                key: torch.empty(shape, dtype=_TORCH_DTYPE[np.dtype(dt)],
                                 pin_memory=pin)
                for key, (shape, dt) in das_proofs.plane_shapes(
                    bucket).items()}
            self._sample_staging[bucket] = (
                staged, {k: t.numpy() for k, t in staged.items()})
        return self._sample_staging[bucket]

    @staticmethod
    def _timing(before, t0, t1, rows, bucket, **extra) -> dict:
        """`last_timing` of a call: marshal and launch host seconds (to the
        result where the call pulled it first), rows, bucket and kernel
        launches, and what else the call reports."""
        after = _build.launch_counts()
        return dict(marshal_s=t1 - t0, launch_s=time.perf_counter() - t1,
                    rows=rows, bucket=bucket,
                    launches={k: c - before.get(k, 0)
                              for k, c in after.items()}, **extra)

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        if len(messages) == 0:
            return []
        with self._lock:
            return self._aggregates(messages, agg_sigs, agg_pks)

    def _aggregates(self, messages, agg_sigs, agg_pks):
        n = len(messages)
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = marshal.bucket_size(n)
        pad = [None] * (bucket - n)
        hashes = [bls.hash_to_g1(bytes(m)) for m in messages]
        hx, hy, hok = bn.g1_to_limbs(hashes + pad)
        sx, sy, sok = bn.g1_to_limbs(list(agg_sigs) + pad)
        pkx, pky, pok = bn.g2_to_limbs(list(agg_pks) + pad)
        valid = hok & sok & pok     # a point at infinity is a rejection
        planes = (hx, hy, sx, sy, pkx, pky, valid)
        t1 = time.perf_counter()
        out = bn.bls_verify_aggregate_batch(
            *(torch.as_tensor(a, device=self.device) for a in planes))
        self.last_timing = self._timing(
            before, t0, t1, n, bucket, width=1, precomp=False,
            limb_form=LIMB_FORM, g2_wire_bytes=int(pkx.nbytes + pky.nbytes),
            hit_rows=0, memo=False)
        return [bool(v) for v in out.cpu()[:n].tolist()]

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        """One Miller and one final-exponentiation launch for the whole
        batch, padded to `marshal.bucket_size`: per row the host folds the
        interpolation and vanishing MSMs into the points A = C − [r(τ)]₁,
        π and Z = [z_S(τ)]₂ (`poly_proofs.marshal_multiproofs`), and
        `bn.bls_verify_aggregate_batch` checks e(A, G2)·e(−π, Z) == 1 with
        π in the hash slot, A in the signature slot and Z in the pubkey
        slot. The MSMs, and the scalar pairing that settles a row with a
        point at infinity, run on the host by design, as in the JAX
        package; they are not a fallback of the kernels. The dev SRS is
        built on the first call of the process (`pcs.dev_srs`), not with
        the backend."""
        with self._lock:
            if len(commitments) == 0:
                self.last_wire = None
                return []
            return self._multiproofs(commitments, index_rows, eval_rows,
                                     proofs, ns)

    def _multiproofs(self, commitments, index_rows, eval_rows, proofs, ns):
        n = len(commitments)
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = marshal.bucket_size(n)
        st = poly_proofs.marshal_multiproofs(commitments, index_rows,
                                             eval_rows, proofs, ns, bucket)
        planes = [st[k] for k in poly_proofs.PLANES]
        wire = sum(int(a.nbytes) for a in planes)
        self.last_wire = {"op": "das_verify_multiproofs", "wire_bytes": wire,
                          "sample_wire_bytes": wire, "rows": n,
                          "bucket": bucket}
        t1 = time.perf_counter()
        out = bn.bls_verify_aggregate_batch(
            *(torch.as_tensor(a, device=self.device) for a in planes))
        res = [bool(v) for v in out.cpu()[:n].tolist()]
        self.last_timing = self._timing(before, t0, t1, n, bucket)
        return res

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None) -> VerdictFuture:
        n = len(messages)
        if n == 0:
            future = VerdictFuture(lambda: [])
            future.result()
            return future
        with self._lock:
            out = self._committees(messages, sig_rows, pk_rows, pk_row_keys)
        return VerdictFuture(lambda: [bool(v) for v in out.cpu()[:n].tolist()])

    def _committees(self, messages, sig_rows, pk_rows, pk_row_keys):
        """Stage and launch one audit; returns the verdict plane on the
        device."""
        n = len(messages)
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = marshal.bucket_size(n)
        keys = marshal.normalize_row_keys(
            pk_row_keys if self.precomp else None, bucket)
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
        self.last_timing = self._timing(
            before, t0, t1, n, bucket, width=width,
            precomp=keys is not None, limb_form=LIMB_FORM,
            g2_wire_bytes=int(g2_bytes), hit_rows=hit_rows, memo=memo)
        return out

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
