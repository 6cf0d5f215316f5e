"""Where `csrc/replay.cu` spends its cycles on the card, phase by phase.

Builds a copy of the source alone (nvcc, sm_90a, into
`gethsharding_tpu_torch/_build/replay_clocks/`) with clock64() reads of
thread 0 at the phase boundaries of a one-block shard: the table copy,
the tile's staging (addresses and the transactions' products), the
address scan, the rows of the tile's references, one slot a row, the
gather, the chain and the write-back. Runs it on the planes
`replay_batch` hands the kernel (`chip_smoke.replay_path_planes`) for
config 4 (2 rows) and for the same collation over 4,096 accounts on one
block a shard, prints each phase's cycles and the launch's time (CUDA
events), and the 4,096-account launch at the launcher's own split for
comparison. Fails where a mark is not found in the source. Needs an
NVIDIA card and nvcc; imports nothing of JAX.

    python3 scripts/torch_replay_clocks.py
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gethsharding_tpu_torch.core import state_processor as sp  # noqa: E402
from gethsharding_tpu_torch.core.types import Transaction  # noqa: E402
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa  # noqa: E402
from gethsharding_tpu_torch.ops import _build, replay  # noqa: E402
from gethsharding_tpu_torch.ops import secp256k1 as secp  # noqa: E402
from gethsharding_tpu_torch.utils.hexbytes import Address20  # noqa: E402

PHASES = ("copy", "staging", "scan", "rows", "slots", "gather", "chain",
          "write-back")

# (text in the source, the same text with a mark before or after it)
MARKS = [
    ("  // 1. this block's rows into the outputs",
     "  MARK(0)\n  // 1. this block's rows into the outputs"),
    ("  if (T == 0) return;\n",
     "  __syncthreads();\n  MARK(1)\n  if (T == 0) return;\n"),
    ("    const int pairs = 2 * n;\n",
     "    __syncthreads();\n    MARK(2)\n    const int pairs = 2 * n;\n"),
    ("    if (G == 1) {\n      chain_tile(",
     "    MARK(3)\n    if (G == 1) {\n      chain_tile("),
    ("  if (threadIdx.x == 0) sm.row[2 * n] = cb;\n  __syncthreads();\n",
     "  if (threadIdx.x == 0) sm.row[2 * n] = cb;\n  __syncthreads();\n"
     "  MARK(4)\n"),
    ("    sm.slot[j] = slot;\n  }\n  __syncthreads();\n",
     "    sm.slot[j] = slot;\n  }\n  __syncthreads();\n  MARK(5)\n"),
    ("    if (w == 0) sm.nonce[j] = __ldcg(nonces_out + tab + r);\n  }\n"
     "  __syncthreads();\n",
     "    if (w == 0) sm.nonce[j] = __ldcg(nonces_out + tab + r);\n  }\n"
     "  __syncthreads();\n  MARK(6)\n"),
    ("  // the slots back as canonical limbs",
     "  MARK(7)\n  // the slots back as canonical limbs"),
    ("    if (w == 0) nonces_out[tab + r] = sm.nonce[j];\n  }\n"
     "  __syncthreads();\n}",
     "    if (w == 0) nonces_out[tab + r] = sm.nonce[j];\n  }\n"
     "  __syncthreads();\n  MARK(8)\n}"),
]


def build():
    src = (_build.SRC_DIR / "replay.cu").read_text()
    src = src.replace(
        "namespace gs {\n",
        "namespace gs {\n__device__ long long replay_clk[9];\n"
        "#define MARK(i) if (threadIdx.x == 0) replay_clk[i] = clock64();\n",
        1)
    for old, new in MARKS:
        if old not in src:
            chip_smoke.fail(f"the source lacks {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "replay_clocks"
    out.mkdir(parents=True, exist_ok=True)
    (out / "replay.cu").write_text(src + r"""
extern "C" int gs_replay_clocks(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, gs::replay_clk,
                                   sizeof(long long) * 9);
}
""")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                    str(out / "replay.cu"), "-o", str(out / "lib.so")],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.gs_replay.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 7
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_replay_clocks: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    lib = build()
    dev = torch.device("cuda")
    txs, genesis, coinbase = chip_smoke.config4_collation(
        sp, Transaction, ecdsa, Address20)
    rng = np.random.default_rng(0)
    big = dict(genesis)
    while len(big) < chip_smoke.REPLAY_ACCOUNTS - 1:
        addr = Address20(rng.bytes(20))
        if addr != coinbase:
            big[addr] = sp.AccountState(nonce=int(rng.integers(0, 1000)),
                                        balance=int(rng.integers(1, 2 ** 62)))
    for label, gen, blocks in (("config 4", genesis, 1),
                               ("4,096 accounts, one block", big, 1),
                               ("4,096 accounts, the launcher's split", big,
                                None)):
        inp = replay.build_replay_inputs([txs], [gen], [coinbase],
                                         device=dev)
        _, planes, _ = chip_smoke.replay_path_planes(replay, secp, inp)
        S, A = planes[1].shape
        T = planes[6].shape[1]
        G = replay.split_blocks(S, A) if blocks is None else blocks
        outs = [torch.empty((S, T), dtype=torch.bool, device=dev),
                torch.empty((S, T), dtype=torch.int32, device=dev),
                torch.empty((S, A), dtype=torch.int32, device=dev),
                torch.empty((S, A, 32), dtype=torch.int32, device=dev),
                torch.empty((S, G, T, 2), dtype=torch.int32, device=dev)]
        counter = torch.zeros(S, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            counter.zero_()
            if lib.gs_replay(*(p.data_ptr() for p in planes), S, T, A, G,
                             *(o.data_ptr() for o in outs),
                             counter.data_ptr(), stream):
                chip_smoke.fail(f"{label}: the launch failed")

        run()
        torch.cuda.synchronize()
        want = replay.shard_replay_kernel(*planes)
        if not all(torch.equal(a, b) for a, b in zip(
                want, (outs[2], outs[3], outs[0], outs[1]))):
            chip_smoke.fail(f"{label}: the clocked build differs")
        ms = chip_smoke.cuda_ms(run, 20)
        line = f"replay clocks ({label}, {T} transactions, {A} rows, {G} " \
               f"block(s) a shard): {ms:.4f} ms a launch with the " \
               f"counter's reset"
        if G == 1:
            clk = (ctypes.c_longlong * 9)()
            lib.gs_replay_clocks(clk)
            cycles = np.diff(list(clk)).tolist()
            line += "; cycles " + ", ".join(
                f"{p} {c}" for p, c in zip(PHASES, cycles)) + \
                f"; {cycles[6] / T:.0f} a transaction of the chain"
        print(f"{line} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
