"""Sample rows of mixed proof depths and validity, for the tests of the
sample kernel (`csrc/das.cu`) under the host shim and on the card.
Imports nothing of JAX.

The kernel verifies `block_samples()` rows a block, so the row counts
that matter are those that leave a block part full, and blocks that mix
proofs of different depths, hostile rows and rows the host rejected."""

import functools
import re

import numpy as np

from gethsharding_tpu_torch.das import proofs
from gethsharding_tpu_torch.ops import _build

# chunks of the four trees: depths 0, 2, 3 and 8
TREE_CHUNKS = (1, 3, 8, 255)


def block_samples() -> int:
    """DAS_BLOCK_SAMPLES of the kernel source: the rows of one block."""
    src = (_build.SRC_DIR / "das.cu").read_text()
    return int(re.search(r"constexpr int DAS_BLOCK_SAMPLES = (\d+);",
                         src).group(1))


@functools.lru_cache(maxsize=None)
def _trees():
    """Per tree, (chunk, index, proof, root) of its first and last leaf;
    its other leaves are seeded 32-byte values (the verifier cannot tell
    them from chunk keys)."""
    rng = np.random.default_rng(29)
    trees = []
    for count in TREE_CHUNKS:
        picked = sorted({0, count - 1})
        data = {i: rng.integers(0, 256, proofs.DAS_CHUNK_SIZE,
                                dtype=np.uint8).tobytes() for i in picked}
        leaves = [rng.bytes(32) for _ in range(count)]
        for i in picked:
            leaves[i] = proofs.chunk_leaf(data[i])
        levels = proofs.merkle_levels(leaves)
        trees.append([(data[i], i, proofs.merkle_proof(levels, i),
                       levels[-1][0]) for i in picked])
    return trees


def mixed_rows(n: int):
    """n rows, row i from i alone: a sample of tree i % 4 (depths 0, 2, 3
    and 8 in turn, so every block mixes them); every third row hostile in
    turn: a flipped chunk byte, a wrong root (both well formed, False on
    the card), a 4095-byte chunk and an index outside the proven tree
    (both rejected on the host). (chunks, indices, proofs, roots)."""
    trees = _trees()
    rows = []
    for i in range(n):
        tree = trees[i % len(trees)]
        chunk, index, proof, root = tree[(i // len(trees)) % len(tree)]
        if i % 3 == 2:
            kind = (i // 3) % 4
            if kind == 0:
                chunk = bytes([chunk[7] ^ 0x40]).join(
                    (chunk[:7], chunk[8:]))
            elif kind == 1:
                root = bytes([root[0] ^ 1]) + root[1:]
            elif kind == 2:
                chunk = chunk[:-1]
            else:
                index += 1 << len(proof)
        rows.append((chunk, index, proof, root))
    return tuple(map(list, zip(*rows)))
