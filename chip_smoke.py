"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Drives the notary's committee audit through the port at its real size
(100 shards × 135 votes per period), through the entry point a notary
calls, `TorchSigBackend().bls_verify_committees`:

1. names the card and its power limit (nvidia-smi);
2. builds the CUDA kernels of `gethsharding_tpu_torch/csrc/` (timed);
3. makes a protocol-true period on the host: secret keys sk_j = j+1,
   votes (j+1)·H(m_s) and pubkeys (j+1)·G2 by repeated point addition,
   the committee order rotated per shard, and hostile rows with known
   answers (a forged vote, a missing signature whose pubkey is kept, an
   empty committee, two shards with swapped messages);
4. holds every kernel (G1 and G2 committee sums, Miller product, final
   exponentiation) against its plain PyTorch version on the card, on the
   tensors and shapes the audit gives it: the limbs must be equal;
5. sets every launch count to 0, runs the audit once, and requires one
   launch of each kernel and every verdict equal to the expected list;
   the same batch through the plain versions on the card must agree;
6. times the cold audit of a period whose messages are new (median of 3,
   host clock, hashing included), the warm audit (median of 7, hashes
   cached) and its stages (host marshal, transfer, device path with the
   pull), each kernel and its plain version (CUDA events), and the
   message hashing; each kernel's bound counts the work this period
   needs (m - 1 additions for m votes, one pairing per non-empty row).

Prints a JSON line of per-kernel numbers, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Exits non-zero, with no
result line, where there is no CUDA card or any check fails. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# int32 multiply-adds: 64 per clock per SM on compute capability 9.0 (CUDA
# programming guide's throughput table) × 132 SMs × 1.98 GHz boost clock
INT32_MAD_PER_S = 132 * 64 * 1.98e9

SHARDS = 100
COMMITTEE = 135


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_period(bls, seed: int):
    """One audit period with known verdicts."""
    msgs = [b"period-%d/shard-%d/header" % (seed, s) for s in range(SHARDS)]
    pks, acc = [], None
    for _ in range(COMMITTEE):
        acc = bls.g2_add(acc, bls.G2_GEN)
        pks.append(acc)                         # (j+1)·G2
    sig_rows, pk_rows = [], []
    for s, m in enumerate(msgs):
        h = bls.hash_to_g1(m)
        mults, acc = [], None
        for _ in range(COMMITTEE):
            acc = bls.g1_add(acc, h)
            mults.append(acc)                   # (j+1)·H(m_s)
        order = [(j + s) % COMMITTEE for j in range(COMMITTEE)]
        sig_rows.append([mults[j] for j in order])
        pk_rows.append([pks[j] for j in order])
    want = [True] * SHARDS
    sig_rows[3][7] = bls.g1_add(sig_rows[3][7], bls.G1_GEN)   # forged vote
    want[3] = False
    sig_rows[17][5] = None          # missing signature, pubkey kept
    want[17] = False
    sig_rows[42], pk_rows[42] = [], []                        # empty committee
    want[42] = False
    msgs[60], msgs[61] = msgs[61], msgs[60]                   # swapped messages
    want[60] = want[61] = False
    return msgs, sig_rows, pk_rows, want


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` warm calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of `reps` warm calls; `fn` synchronizes."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def count_multiply_adds(mk, fn) -> int:
    """int32 multiply-adds of one call of the plain version `fn`, which
    does the kernel's arithmetic step for step: 625 per 25×25 schoolbook
    convolution, 22 per folded limb of every normalize."""
    count = [0]
    conv, norm = mk._conv, mk._normalize

    def conv_counted(u, v):
        out = conv(u, v)
        count[0] += out[..., 0].numel() * mk.KNL * mk.KNL
        return out

    def norm_counted(z, C):
        count[0] += z[..., 0].numel() * (z.shape[-1] + 2 - mk.KFOLD_BASE) \
            * mk.KFOLD_BASE
        return norm(z, C)

    mk._conv, mk._normalize = conv_counted, norm_counted
    try:
        fn()
    finally:
        mk._conv, mk._normalize = conv, norm
    return count[0]


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max().item())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")

    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.ops import _build
    from gethsharding_tpu_torch.ops import bn256 as bn
    from gethsharding_tpu_torch.ops import megakernels as mk
    from gethsharding_tpu_torch.sigbackend.dispatch import (TorchSigBackend,
                                                         committee_planes)

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for line in _build.build_log.splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    t0 = time.perf_counter()
    msgs, sig_rows, pk_rows, want = make_period(bls, args.seed)
    print(f"period: {SHARDS} shards × {COMMITTEE} votes, made in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)

    # -- every kernel against its plain version, at the audit's tensors --
    dev = torch.device("cuda")
    planes = committee_planes(msgs, sig_rows, pk_rows)
    on_card = [torch.as_tensor(a, device=dev) for a in planes]
    hx, hy, sx, sy, sm, gx, gy, gm, _ = on_card
    n = hx.shape[0]
    sm32, gm32 = sm.to(torch.int32), gm.to(torch.int32)

    agg1 = lambda: mk.agg_kernel(sx, sy, sm32, fp2=False)
    agg1_p = lambda: mk.run_agg_plain(sx, sy, sm, fp2=False)
    agg2 = lambda: mk.agg_kernel(gx, gy, gm32, fp2=True)
    agg2_p = lambda: mk.run_agg_plain(gx, gy, gm, fp2=True)
    sig = tuple(bn.FP.normalize(v) for v in agg1())
    pk = tuple(bn.FP.normalize(v) for v in agg2())
    h = (hx, hy)
    mil = lambda: mk.miller_kernel(sig, h, pk)
    mil_p = lambda: mk.run_miller_plain(sig, h, pk)
    f = bn.FP.normalize(mil())
    nd = torch.stack([bn.fp12_conj(f), bn.FP.normalize(f)], dim=1)
    fe = lambda: mk.finalexp_kernel(nd)
    fe_p = lambda: mk.run_program_plain(nd)

    # The bound counts the work this period needs, not the padded launch:
    # a row of m votes needs m - 1 additions (the kernels walk a 256-slot
    # tree), and only the real rows with both sums non-empty need a
    # pairing (the launches also cover the 12 pad rows and the empty one).
    adds_g1 = int((sm.sum(dim=1) - 1).clamp(min=0).sum().item())
    adds_g2 = int((gm.sum(dim=1) - 1).clamp(min=0).sum().item())
    paired = int((sm.any(dim=1) & gm.any(dim=1))[:SHARDS].sum().item())
    one_add = lambda xs, ys, m, fp2: lambda: mk.run_agg_plain(
        xs[:1, :2], ys[:1, :2], torch.ones_like(m[:1, :2]), fp2=fp2)
    row = lambda t: t[:1]
    g1_pt, g2_pt = mk.KNL * 4, 2 * mk.KNL * 4      # bytes of one point plane
    cases = {   # kernel, plain, (plain work unit, units), bytes moved
        "agg_g1": (agg1, agg1_p, (one_add(sx, sy, sm, False), adds_g1),
                   int(sm.sum().item()) * 2 * g1_pt + 3 * SHARDS * g1_pt),
        "agg_g2": (agg2, agg2_p, (one_add(gx, gy, gm, True), adds_g2),
                   int(gm.sum().item()) * 2 * g2_pt + 3 * SHARDS * g2_pt),
        "miller": (mil, mil_p, (lambda: mk.run_miller_plain(
                       tuple(map(row, sig)), tuple(map(row, h)),
                       tuple(map(row, pk))), paired),
                   paired * (nbytes(*sig, *h, *pk) // n + 6 * g2_pt)
                   + mk._MILLER_LINES.nbytes),
        "finalexp": (fe, fe_p, (lambda: mk.run_program_plain(nd[:1]),
                                paired),
                     paired * 2 * nbytes(nd) // n + mk._PROGRAM.nbytes),
    }
    results = {}
    for name, (kern, plain, (unit, units), moved) in cases.items():
        got = kern()
        want_limbs = plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want_limbs)
        print(f"kernel {name}: max |kernel - plain| over limbs = {err}",
              flush=True)
        if err != 0:
            fail(f"{name} disagrees with its plain version")
        macs = count_multiply_adds(mk, unit) * units
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = macs / INT32_MAD_PER_S * 1e3
        results[name] = {"max_abs_err": err, "multiply_adds": macs,
                         "units": units, "bytes": moved,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "operations" if t_ops >= t_bytes
                         else "bytes"}
    verdict_k = mk.finalexp_is_one(f)
    verdict_p = mk.finalexp_is_one(f, plain=True)
    if not torch.equal(verdict_k, verdict_p):
        fail("finalexp verdicts differ from the plain version")

    # -- the main path, counted --------------------------------------------
    backend = TorchSigBackend()
    for k in mk.KERNELS.values():
        k.launches = 0
    got = backend.bls_verify_committees(msgs, sig_rows, pk_rows)
    launches = {name: k.launches for name, k in mk.KERNELS.items()}
    print(f"main path: launches per audit {launches}")
    if any(v != 1 for v in launches.values()):
        fail(f"the audit did not launch each kernel once: {launches}")
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        fail(f"verdicts differ from the expected list at rows {bad}")
    plain_got = bn.bls_aggregate_verify_committee_batch(*on_card, plain=True)
    if plain_got.cpu()[:SHARDS].tolist() != got:
        fail("the plain versions on the card give other verdicts")
    print(f"main path: {sum(got)} of {SHARDS} rows verified, hostile rows "
          f"3, 17, 42, 60, 61 rejected; plain versions agree")

    # -- times ---------------------------------------------------------------
    audit_s, marshal_s = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        backend.bls_verify_committees(msgs, sig_rows, pk_rows)
        audit_s.append(time.perf_counter() - t0)
        marshal_s.append(backend.last_timing["marshal_s"])
    cold_s = []     # a real period's messages are new: hashing included
    for _ in range(3):
        bls.hash_to_g1.cache_clear()
        t0 = time.perf_counter()
        backend.bls_verify_committees(msgs, sig_rows, pk_rows)
        cold_s.append(time.perf_counter() - t0)

    def transfer():
        out = [torch.as_tensor(p, device=dev) for p in planes]
        torch.cuda.synchronize()
        return out

    transfer_ms = host_ms(transfer, 5)
    device_ms = host_ms(
        lambda: bn.bls_aggregate_verify_committee_batch(*on_card).cpu(), 5)
    bls.hash_to_g1.cache_clear()
    t0 = time.perf_counter()
    for m in msgs:
        bls.hash_to_g1(m)
    hash_ms = (time.perf_counter() - t0) * 1e3 / len(msgs)
    kernels = []
    for name, (kern, plain, _, _) in cases.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 1)
        r = results[name]
        k = mk.KERNELS[name]
        print(f"time {name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['multiply_adds']} int32 multiply-adds over {r['units']} "
              f"needed units, {r['bytes']} B) [{card}]")
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    kernel_ms = sum(k["ms"] for k in kernels)
    votes = SHARDS * COMMITTEE
    warm_ms = statistics.median(audit_s) * 1e3
    cold_ms = statistics.median(cold_s) * 1e3
    print(f"time audit, cold period (messages hashed, {SHARDS} shards × "
          f"{COMMITTEE} votes): median {cold_ms:.1f} ms of {len(cold_s)}, "
          f"{votes / cold_ms * 1e3:.0f} votes/s [{card}]")
    print(f"time audit, warm (hashes cached; excludes hashing): median "
          f"{warm_ms:.1f} ms of {len(audit_s)}, {votes / warm_ms * 1e3:.0f} "
          f"votes/s; stages: host marshal "
          f"{statistics.median(marshal_s) * 1e3:.1f} ms, transfer "
          f"{transfer_ms:.2f} ms, device path with pull {device_ms:.2f} ms "
          f"(kernels {kernel_ms:.2f} ms, limb glue and pull "
          f"{device_ms - kernel_ms:.2f} ms); hash_to_g1 {hash_ms:.3f} ms per "
          f"message (host) [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
