"""Where the exact normalize spends its cycles on the card.

Builds the kernels with NORM_CLOCKS (into
gethsharding_tpu_torch/_build/norm_clocks/), which turns the NORM_CLOCK
marks of `csrc/norm.cuh`'s exact ladder into clock64() reads of block 0's
first thread, printed when each normalize ends: the cycles of its four
block phases (the first stage's rounds, its tiled fold, the second
stage, the tail of three word carries). Launches once each, in the exact
22-limb form: `norm_exact` at (1344, 22) and (1344, 45), and
`tower_exact` at 112 rows of an Fp2, a line and an Fp12 product (one
row of the xi·v, planes and merge normalizes each), and prints a line
per normalize with the card's name and power limit. Fails where a launch
printed no line. The marks' own reads cost a few cycles a phase. Needs an
NVIDIA card and nvcc; imports nothing of JAX.

    python3 scripts/torch_norm_clocks.py
"""

import os
import sys
import tempfile
from pathlib import Path

os.environ["GETHSHARDING_TORCH_LIMB_FORM"] = "exact"   # read at import

import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gethsharding_tpu_torch.ops import _build, norm, tower  # noqa: E402
from gethsharding_tpu_torch.ops import bn256 as bn  # noqa: E402

PHASES = ("rounds", "fold", "second stage", "tail")


def printed(fn) -> list:
    """The NORM_CLOCKS lines that the kernels launched by fn print."""
    with tempfile.TemporaryFile() as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        text = f.read().decode()
    return [line.split()[1:] for line in text.splitlines()
            if line.startswith("NORM_CLOCKS ")]


def main() -> int:
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    card = chip_smoke.card_line()
    # the library with the marks, built on the first launch below
    _build.BUILD_DIR = _build.BUILD_DIR / "norm_clocks"
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ["-DNORM_CLOCKS"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    canon = lambda *shape: torch.randint(0, 1 << 12, (112,) + shape + (22,),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)
    f, line, x = canon(6, 2), canon(3, 2), canon(1, 2)
    launches = {
        "norm_exact (1344, 22)": lambda: norm.normalize_kernel(
            bn.FP, chip_smoke.edge_rows(gen, dev, 1344, 22)),
        "norm_exact (1344, 45)": lambda: norm.normalize_kernel(
            bn.FP, chip_smoke.edge_rows(gen, dev, 1344, 45)),
        "tower_exact fp2_mul": lambda: tower.tower_kernel(bn._FP2_MUL, x, x),
        "tower_exact fp12_mul_line": lambda: tower.tower_kernel(
            bn._LINE_MUL, line, f),
        "tower_exact fp12_mul": lambda: tower.tower_kernel(bn._FP12_MUL, f, f),
    }
    for name, fn in launches.items():
        printed(fn)              # warm: the first launch loads the module
        rows = printed(fn)
        if not rows:
            chip_smoke.fail(f"{name} printed no clocks")
        for rows_, width, *cycles in rows:
            print(f"{name}: normalize of {rows_} rows, width <= {width}: "
                  + ", ".join(f"{p} {c}" for p, c in zip(PHASES, cycles))
                  + f" cycles (block 0) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
