"""Time the replay path's two kernels on the card, for one checkout.

Builds the kernels of `<root>/gethsharding_tpu_torch` (default: this
checkout; a parent's `git archive` unpacked into a git-ignored directory
times the parent beside it) and times with CUDA events, at the tensors
`replay_batch` hands them (`chip_smoke.replay_path_planes`):

- `keccak_fixed` on config 4's addresses (64 × 64 B) and its root (one
  message of 60 × 2 B), and on the root of the same collation over 4,096
  accounts (245,760 B, 1,808 permutations in turn); on the stress step's
  shapes (1,024 × 64 B addresses, 2,048 × 96 B sampling rows, 1,024 ×
  180 B roots, random bytes);
- `replay` at config 4 (2 rows), over 4,096 accounts, and at the stress
  step's 1,024 shards of 1 transaction over 3 rows (seeded rows).

With `--sweep` (a checkout whose `keccak_fixed.cu` has two routes) it
also times each route of `keccak_fixed` on its own over messages of 1 to
8 permutations at 1 to 16,384 rows, where the routes cross: each from a
copy of the source whose `KF_WARP_MIN_LEN` sends every length to that
route (`scripts/torch_keccak_routes.py::build_form`). Prints
the card's name and power limit and one JSON line, also written to
`--out`. Needs an NVIDIA card and nvcc; imports nothing of JAX.

    python3 scripts/torch_replay_kernels.py [--root DIR] [--sweep] [--out F]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_replay_kernels: needs an NVIDIA card", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(REPO / "tests")]
    import chip_smoke as cs
    import torch_replay_rows
    from gethsharding_tpu_torch.core import state_processor as sp
    from gethsharding_tpu_torch.core.types import Transaction
    from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
    from gethsharding_tpu_torch.ops import _build, keccak, replay
    from gethsharding_tpu_torch.ops import secp256k1 as secp
    from gethsharding_tpu_torch.utils.hexbytes import Address20

    card = cs.card_line()
    t0 = time.perf_counter()
    _build.build()
    print(f"root {root}: build {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    for name, regs, stack, stores, loads in cs.ptxas_report(
            _build.build_log):
        if name in ("keccak_fixed_kernel", "replay_kernel"):
            print(f"  ptxas {name}: {regs} registers, stack {stack} B, "
                  f"spills {stores}/{loads} B", flush=True)

    dev = torch.device("cuda")
    txs, genesis, coinbase = cs.config4_collation(sp, Transaction, ecdsa,
                                                  Address20)
    rng = np.random.default_rng(0)
    big = dict(genesis)
    while len(big) < cs.REPLAY_ACCOUNTS - 1:
        addr = Address20(rng.bytes(20))
        if addr != coinbase:
            big[addr] = sp.AccountState(
                nonce=int(rng.integers(0, 1000)),
                balance=int(rng.integers(1, 2 ** 62)) * 10 ** 6)
    result = {"root": str(root), "card": card}
    for label, gen in (("config 4", genesis),
                       ("4,096 accounts", big)):
        inp = replay.build_replay_inputs([txs], [gen], [coinbase],
                                         device=dev)
        pub, planes, rows = cs.replay_path_planes(replay, secp, inp)
        result[label] = {
            "keccak_addresses_ms": cs.cuda_ms(
                lambda: keccak.keccak_fixed_kernel(pub), 20),
            "keccak_root_ms": cs.cuda_ms(
                lambda: keccak.keccak_fixed_kernel(rows), 5),
            "root_bytes": rows.shape[1],
            "replay_ms": cs.cuda_ms(
                lambda: replay.shard_replay_kernel(*planes), 20)}
        print(f"{label}: {result[label]}", flush=True)
    stress = {}
    gen = torch.Generator().manual_seed(1)
    for n, length in ((1024, 64), (2048, 96), (1024, 180)):
        msgs = torch.randint(0, 256, (n, length), dtype=torch.uint8,
                             generator=gen).to(dev)
        stress[f"keccak {n} x {length} B"] = cs.cuda_ms(
            lambda: keccak.keccak_fixed_kernel(msgs), 20)
    planes = [torch.as_tensor(p, device=dev)
              for p in torch_replay_rows.seeded_planes(6, 1024, 1, 3)]
    stress["replay 1024 x 1 over 3 rows"] = cs.cuda_ms(
        lambda: replay.shard_replay_kernel(*planes), 20)
    result["stress shapes"] = stress
    print(f"stress shapes: {stress}", flush=True)

    if args.sweep:
        import torch_keccak_routes

        threshold = "constexpr int KF_WARP_MIN_LEN = 136;"

        def every_length_on(value):
            def patch(src):
                if threshold not in src:
                    raise RuntimeError(f"the source lacks {threshold!r}")
                return src.replace(threshold, "constexpr int "
                                   f"KF_WARP_MIN_LEN = {value};")
            return patch

        libs = {name: torch_keccak_routes.build_form(
                    f"sweep_{name}", 24, every_length_on(value))
                for name, value in (("thread", 0x7FFFFFFF), ("warp", 0))}
        stream = torch.cuda.current_stream().cuda_stream
        sweep = []
        for perms in (1, 2, 3, 4, 8):
            length = 136 * perms - 1
            for n in (1, 64, 1024, 4096, 16384):
                msgs = torch.randint(0, 256, (n, length), dtype=torch.uint8,
                                     generator=gen).to(dev)
                want = keccak.keccak_fixed_kernel(msgs)
                row = {"perms": perms, "n": n}
                for name, lib in libs.items():
                    out = torch.zeros_like(want)

                    def run():
                        if lib.gs_keccak_fixed(msgs.data_ptr(), n, length,
                                               out.data_ptr(), stream):
                            cs.fail(f"sweep: the {name} route's launch "
                                    f"failed")

                    row[name] = cs.cuda_ms(run, 10)
                    if not torch.equal(out, want):
                        cs.fail(f"sweep: the {name} route's digests differ")
                sweep.append(row)
                print(f"sweep: {row}", flush=True)
        result["sweep"] = sweep
        lat = cs.chain_latencies()
        result["latencies"] = lat
        print(f"latencies: {lat}", flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
