"""Time `csrc/das.cu` at other block shapes on the card.

Builds the sample kernel's source once per variant, with its constants
DAS_BLOCK_SAMPLES (most rows a block), DAS_THREADS (threads a block) and
DAS_ROUND_UNROLL (keccak rounds a trip of the round loop) replaced, and
with a fourth value 0, with every block taking DAS_BLOCK_SAMPLES rows
where the launch would pick ceil(rows / SMs) of them; each built by its
own nvcc process (all started together). It runs every variant on
the planes of the notary vote period of `chip_smoke.vote_period` (seed
0: 1,607 samples in the bucket of 1,792) and on its first 160 rows (a
10-shard period's samples). Each variant's verdicts must equal the plain
version's on the card (tolerance 0). Prints per variant its ptxas
registers, stack frame and spills, and its milliseconds per launch (CUDA
events, launches queued behind a sleep of the card) in two passes, the
variants in turn forward and then backward, with its share of the bound
over the valid rows as `chip_smoke.py` counts it. Writes the table to
das_sweep.json beside the variants' builds in
gethsharding_tpu_torch/_build/das_sweep/. Needs an NVIDIA card and
nvcc; imports nothing of JAX.

    python3 scripts/torch_das_sweep.py [S,T,U[,0] ...]
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa  # noqa: E402
from gethsharding_tpu_torch.crypto.keccak import keccak256  # noqa: E402
from gethsharding_tpu_torch.das import proofs as das  # noqa: E402
from gethsharding_tpu_torch.ops import _build, route  # noqa: E402
from gethsharding_tpu_torch.sigbackend import marshal  # noqa: E402

DEFAULT = ("8,256,2", "12,256,2", "13,256,2", "13,256,1", "13,256,4",
           "14,256,2", "13,128,2", "13,512,2", "13,256,2,0")
PICK = "const int per_block = gs::das_block_rows(n, sms);"
SMALL = 160
NAMES = ("DAS_BLOCK_SAMPLES", "DAS_THREADS", "DAS_ROUND_UNROLL")


def variant_source(src: str, values) -> str:
    if len(values) > 3 and not values[3]:
        if PICK not in src:
            chip_smoke.fail("das.cu does not pick the rows a block at launch")
        src = src.replace(PICK, "const int per_block = gs::DAS_BLOCK_SAMPLES;")
    for name, value in zip(NAMES, values):
        src, count = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
        if count != 1:
            chip_smoke.fail(f"das.cu has no constant {name}")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    variants = [tuple(int(v) for v in arg.split(","))
                for arg in (sys.argv[1:] or DEFAULT)]
    src = (_build.SRC_DIR / "das.cu").read_text()
    out_dir = _build.BUILD_DIR / "das_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for values in variants:
        tag = "_".join(map(str, values))
        cu, lib = out_dir / f"das_{tag}.cu", out_dir / f"libdas_{tag}.so"
        cu.write_text(variant_source(src, values))
        procs.append((values, lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    card = chip_smoke.card_line()
    print(card, flush=True)
    _, (chunks, indices, proofs, roots, _) = chip_smoke.vote_period(
        ecdsa, das, keccak256, 0)
    n = len(chunks)
    st = das.marshal_samples(chunks, indices, proofs, roots,
                             marshal.bucket_size(n))
    dev = torch.device("cuda")
    planes = [torch.as_tensor(st[k], device=dev) for k in das.PLANES]
    with route.plain_versions():
        want = das.verify_planes(*planes)
    depths = st["levels"].sum(axis=1)
    perms = sum(das.sample_permutations(int(d)) for d in depths[st["valid"]])
    row_bytes = sum(int(st[k][0].nbytes) for k in das.PLANES[:-1])
    bound = chip_smoke.bound(perms * das.PERMUTATION_OPS,
                             int(st["valid"].sum()) * row_bytes
                             + 2 * planes[0].shape[0])
    P = ctypes.c_void_p
    small = [t[:SMALL].contiguous() for t in planes]
    rows, launchers = [], []
    for values, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            chip_smoke.fail(f"nvcc failed on variant {values}:\n{log}")
        fn = ctypes.CDLL(str(lib)).gs_das_samples
        fn.argtypes = [P] * 6 + [ctypes.c_int, P, P]
        fn.restype = ctypes.c_int
        pair = []
        for ins, expect in ((planes, want), (small, want[:SMALL])):
            got = torch.empty_like(ins[-1])
            args = [P(t.data_ptr()) for t in ins] + [ins[0].shape[0],
                                                      P(got.data_ptr()), None]

            def launch(fn=fn, args=args, values=values):
                err = fn(*args)
                if err:
                    chip_smoke.fail(f"variant {values}: launch error {err}")
            launch()
            torch.cuda.synchronize()
            if not torch.equal(got, expect):
                chip_smoke.fail(f"variant {values} disagrees with the plain "
                                f"version at {ins[0].shape[0]} rows")
            pair.append(launch)
        report = [r[1:] for r in chip_smoke.ptxas_report(log)
                  if r[0] == "das_kernel"]
        regs, stack, stores, loads = report[0] if report else (None,) * 4
        rows.append({"samples": values[0], "threads": values[1],
                     "unroll": values[2], "fixed": len(values) > 3,
                     "registers": regs, "stack": stack,
                     "spill_stores": stores, "spill_loads": loads, "ms": [],
                     "small_ms": []})
        launchers.append(pair)
    for order in (range(len(rows)), reversed(range(len(rows)))):
        for i in order:
            rows[i]["ms"].append(chip_smoke.cuda_ms(launchers[i][0], 20))
            rows[i]["small_ms"].append(chip_smoke.cuda_ms(launchers[i][1],
                                                          20))
    print(f"das.cu variants on the vote period's {planes[0].shape[0]} rows "
          f"({int(st['valid'].sum())} valid); bound {bound['bound_ms']:.6f} "
          f"ms ({bound['bound_by']}) [{card}]")
    for r in rows:
        print(f"  S={r['samples']:3d}{' fixed' * r['fixed']} "
              f"T={r['threads']:4d} U={r['unroll']}  "
              f"ptxas {r['registers']} registers, stack {r['stack']} B, "
              f"spills {r['spill_stores']}/{r['spill_loads']} B  ms "
              + " ".join(f"{m:.4f}" for m in r["ms"])
              + f"  {bound['bound_ms'] / min(r['ms']):.1%} of bound;  "
              f"{SMALL} rows ms "
              + " ".join(f"{m:.4f}" for m in r["small_ms"]), flush=True)
    (out_dir / "das_sweep.json").write_text(json.dumps(
        {"card": card, "rows": planes[0].shape[0],
         "bound_ms": bound["bound_ms"], "variants": rows}, indent=1))
    print(f"wrote {out_dir / 'das_sweep.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
