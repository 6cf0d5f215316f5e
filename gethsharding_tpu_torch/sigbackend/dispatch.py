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

On a mesh layout (`mesh_devices` > 1, `$GETHSHARDING_TORCH_MESH_DEVICES`,
or a list of devices; `sigbackend/layout.py`) the committee audit is the
reference's one-step mesh audit: the batch pads to a multiple of the
slots, each slot audits its contiguous slab on its own device (keyed
audits from its own line-table cache, `cache.slot_caches`, with the
generator's table placed on every slot; unkeyed audits on the recompute
path), and the vote total is the only value that crosses slots, one
reduction a step (`last_mesh`). `das_verify_multiproofs` splits its rows
over the slots the same way, with no reduction. `ecrecover_addresses`,
`das_verify_samples` and `bls_verify_aggregates` run on slot 0, as the
reference keeps them off its mesh.
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
from gethsharding_tpu_torch.ops import _build
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import secp256k1 as secp
from gethsharding_tpu_torch.ops.limb import LIMB_FORM
from gethsharding_tpu_torch.parallel import mesh as mesh_mod
from gethsharding_tpu_torch.sigbackend import SigBackend, VerdictFuture
from gethsharding_tpu_torch.sigbackend import marshal
from gethsharding_tpu_torch.sigbackend.cache import (LineTableCache,
                                                     slot_caches)
from gethsharding_tpu_torch.sigbackend.layout import (DeviceLayout,
                                                      resolve_slots)


def committee_planes(messages, sig_rows, pk_rows, bucket=None):
    """Marshal one audit on the host: the numpy planes of
    `bls_aggregate_verify_committee_batch` in its argument order (hx, hy,
    sigx, sigy, sig_mask, pkx, pky, pk_mask, valid), rows padded to
    `bucket` (default `marshal.bucket_size`) and the committee to
    `marshal.committee_width`."""
    if bucket is None:
        bucket = marshal.bucket_size(len(messages))
    pad = bucket - len(messages)
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
    `lines`, a `LineTableCache` under its default budget.

    A mesh layout: `device` a list of slots (a device may repeat), or
    `mesh_devices` (None: `$GETHSHARDING_TORCH_MESH_DEVICES`, default 1)
    above 1, which takes that many distinct cards (`device` None) or
    repeats `device`. Then `lines` is None and `line_shards` holds a
    cache a slot; `device` is slot 0."""

    name = "torch"

    def __init__(self, device=None, precomp=None, mesh_devices=None):
        target = resolve_slots(device, mesh_devices)
        if isinstance(target, list):
            self.layout = DeviceLayout(devices=target)
            self.device = self.layout.devices[0]
        else:
            self.layout = DeviceLayout(1)
            self.device = target
        if precomp is None:
            knob = os.environ.get("GETHSHARDING_TORCH_PRECOMP", "1")
            if knob not in ("0", "1"):
                raise ValueError(
                    f"GETHSHARDING_TORCH_PRECOMP={knob!r}: want 0 or 1")
            precomp = knob == "1"
        self.precomp = bool(precomp)
        if self.layout.is_mesh:
            self.lines = None
            self.line_shards = slot_caches(self.layout.devices)
            self._gen_lines = [bn.generator_lines_on(d)
                               for d in self.layout.devices]
        else:
            self.lines = LineTableCache(self.device)
            self.line_shards = None
        # the last mesh call's record (None on one device): op, slots,
        # bucket, width, reductions, path, the slots holding their
        # verdicts, the reduced vote total (set by the result) and each
        # slot's kernel launches
        self.last_mesh: dict | None = None
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
        lay = self.layout
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = lay.mesh_bucket(n) if lay.is_mesh else marshal.bucket_size(n)
        st = poly_proofs.marshal_multiproofs(commitments, index_rows,
                                             eval_rows, proofs, ns, bucket)
        planes = [st[k] for k in poly_proofs.PLANES]
        wire = sum(int(a.nbytes) for a in planes)
        self.last_wire = {"op": "das_verify_multiproofs", "wire_bytes": wire,
                          "sample_wire_bytes": wire, "rows": n,
                          "bucket": bucket}
        t1 = time.perf_counter()
        if lay.is_mesh:
            # per-row work: the rows split over the slots, nothing crosses
            out, _, record = self._on_slots(
                "das_verify_multiproofs", [lay.place(a) for a in planes],
                lambda i, slab: bn.bls_verify_aggregate_batch(*slab))
            record["bucket"] = bucket
        else:
            out = bn.bls_verify_aggregate_batch(
                *(torch.as_tensor(a, device=self.device) for a in planes))
        res = [bool(v) for v in out.cpu()[:n].tolist()]
        self.last_timing = self._timing(before, t0, t1, n, bucket)
        return res

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None) -> VerdictFuture:
        n = len(messages)
        if n == 0:
            self.last_mesh = None
            future = VerdictFuture(lambda: [])
            future.result()
            return future
        with self._lock:
            if self.layout.is_mesh:
                out, votes, record = self._committees_mesh(
                    messages, sig_rows, pk_rows, pk_row_keys)
            else:
                out = self._committees(messages, sig_rows, pk_rows,
                                       pk_row_keys)
        if not self.layout.is_mesh:
            return VerdictFuture(
                lambda: [bool(v) for v in out.cpu()[:n].tolist()])

        def finalize():
            res = [bool(v) for v in out.cpu()[:n].tolist()]
            record["vote_total"] = int(votes.sum())
            return res

        return VerdictFuture(finalize)

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
        plan, g2 = self._line_plan(self.lines, list(pk_rows) + [[]] * pad,
                                   keys, bucket, width)
        t1 = time.perf_counter()
        out = self._precomp_launch(self.lines, self.device, plan, g2,
                                   [host[k] for k in _HOST_PLANES])
        return (out, t1, sum(a.nbytes for a in g2), plan.hit_rows,
                plan.memo is not None, width)

    @staticmethod
    def _line_plan(lines, rows, keys, bucket, width):
        """Host half of a precomp audit on one cache: its plan, and the G2
        planes of its misses (empty where the memo or the LRU serves)."""
        plan = lines.resolve(rows, keys, bucket)
        g2 = ()
        if plan.memo is None and plan.misses:
            g2 = bn.g2_committee_to_limbs([row for row, _ in plan.misses],
                                          width)
        return plan, g2

    @staticmethod
    def _precomp_launch(lines, dev, plan, g2, host, gen_lines=None):
        """Device half: the misses' tables, the stacked tables, then the
        audit on `dev`; `host` the (hx, hy, sx, sy, sm, hok) planes."""
        put = lambda a: torch.as_tensor(a, device=dev)
        missed = bn.precompute_g2_lines(*map(put, g2)) if g2 else None
        table, inf = lines.assemble(plan, missed)
        hx, hy, sx, sy, sm, hok = map(put, host)
        return bn.bls_verify_committee_precomp_batch(
            hx, hy, sx, sy, sm, table, inf, hok, gen_lines)

    def _committees_mesh(self, messages, sig_rows, pk_rows, pk_row_keys):
        """The mesh audit (module docstring): host staging for every slot
        first, then each slot's launches on its slab, then the one
        reduction of the vote total. Returns (verdicts on slot 0, the vote
        total, the `last_mesh` record the result completes)."""
        lay = self.layout
        n = len(messages)
        before = _build.launch_counts()
        t0 = time.perf_counter()
        bucket = lay.mesh_bucket(n)
        rpd = lay.rows_per_device(bucket)
        pad = bucket - n
        width = marshal.committee_width(sig_rows, pk_rows)
        keys = marshal.normalize_row_keys(
            pk_row_keys if self.precomp else None, bucket)
        if keys is None:
            planes = committee_planes(messages, sig_rows, pk_rows, bucket)
            g2_bytes = sum(a.nbytes for a in planes[5:8])
            t1 = time.perf_counter()
            slabs = [lay.place(a) for a in planes]
            step = lambda i, slab: bn.bls_aggregate_verify_committee_batch(
                *slab)
            hit_rows, memo = 0, False
        else:
            host = marshal.committee_host_planes(messages, sig_rows, pad,
                                                 width)
            rows = list(pk_rows) + [[]] * pad
            staged = [self._line_plan(
                lines, rows[i * rpd:(i + 1) * rpd],
                keys[i * rpd:(i + 1) * rpd], rpd, width)
                for i, lines in enumerate(self.line_shards)]
            g2_bytes = sum(a.nbytes for _, g2 in staged for a in g2)
            t1 = time.perf_counter()
            slabs = [lay.place(host[k]) for k in _HOST_PLANES]

            def step(i, slab):
                plan, g2 = staged[i]
                return self._precomp_launch(
                    self.line_shards[i], lay.devices[i], plan, g2, slab,
                    self._gen_lines[i])

            hit_rows = sum(plan.hit_rows for plan, _ in staged)
            memo = all(plan.memo is not None for plan, _ in staged)
        out, votes, record = self._on_slots("bls_verify_committees", slabs,
                                            step, reduce_votes=True)
        record.update(bucket=bucket, width=width, precomp=keys is not None)
        self.last_timing = self._timing(
            before, t0, t1, n, bucket, width=width,
            precomp=keys is not None, limb_form=LIMB_FORM,
            g2_wire_bytes=int(g2_bytes), hit_rows=hit_rows, memo=memo,
            slots=lay.n_devices)
        return out, votes, record

    def _on_slots(self, op, slabs, step, reduce_votes=False):
        """Run `step(i, slot i's planes)` on each slot's device (`slabs`:
        per plane, its per-slot tensors) and join the verdicts on slot 0;
        with `reduce_votes` the slots' vote counts cross in one reduction
        (else the votes are None). Returns (verdicts, votes, the record it
        makes `last_mesh`, each slot's launches among it)."""
        lay = self.layout
        reductions = lay.mesh.reductions
        outs, slot_launches = [], []
        for i, dev in enumerate(lay.devices):
            before = _build.launch_counts()
            with mesh_mod.slot_context(dev):
                outs.append(step(i, [plane[i] for plane in slabs]))
            after = _build.launch_counts()
            slot_launches.append({k: c - before.get(k, 0)
                                  for k, c in after.items()
                                  if c != before.get(k, 0)})
        votes = None
        if reduce_votes:
            votes = mesh_mod.hierarchical_psum(
                [o.to(torch.int32).sum(dtype=torch.int32).reshape(1)
                 for o in outs], lay.mesh)
        record = {"op": op, "n_devices": lay.n_devices,
                  "collectives": lay.mesh.reductions - reductions,
                  "verdict_devices": sum(o.device == d for o, d in
                                         zip(outs, lay.devices)),
                  "vote_total": None, "slot_launches": slot_launches}
        self.last_mesh = record
        return lay.assemble(outs), votes, record


# the host planes a precomp audit ships, in `_precomp_launch`'s order
_HOST_PLANES = ("hx", "hy", "sx", "sy", "sm", "hok")
