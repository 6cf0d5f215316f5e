"""DAS sample proofs: the scalar truth, the fixed-shape planes, and the
batched verifier on `csrc/das.cu` with its plain PyTorch version.

The port's copy of the JAX package's `das/proofs.py`. A blob's DAS root
is the root of a binary keccak merkle tree whose leaves are the chunks'
netstore addresses, `chunk_key(4096, chunk) = keccak256(span_le8 ||
bmt_root(chunk))`. A sample proof for chunk i is its sibling path from
leaf i to the root (at most 8 siblings: a blob has at most 255 chunks).

- `verify_sample(s)` is the scalar truth, on the host keccak;
- `marshal_samples` turns rows into fixed (bucket, ...) planes, every
  malformed row (wrong chunk size, bad index, an over-deep or ragged
  proof, a wrong-size root) folded into `valid`, so the batched verifier
  only computes the well-formed case and its verdicts equal the scalar
  ones bit for bit; `stage_samples` writes the same planes into arrays
  the caller keeps (the backend's reused staging planes);
- `verify_planes` is the route (`ops/route.py`): one launch of the
  kernel for CUDA tensors, `verify_planes_plain` (the reference's
  `_build_batch_fn`, on `ops/keccak.py`) for CPU tensors and inside
  `route.plain_versions()`.

Per sample the verifier recomputes the chunk's BMT (128 leaf keccaks and
7 pair levels), derives the netstore key (one keccak), and folds the
path (one keccak per proof level): 264 keccak-f permutations at depth 8.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.das.erasure import DAS_CHUNK_SIZE
from gethsharding_tpu_torch.ops import _build, route
from gethsharding_tpu_torch.ops.keccak import keccak256_fixed
from gethsharding_tpu_torch.ops.limb import const
from gethsharding_tpu_torch.storage.bmt import SEGMENT_COUNT, SEGMENT_SIZE
from gethsharding_tpu_torch.storage.chunker import chunk_key

# n <= erasure.MAX_TOTAL_CHUNKS = 255 -> a padded tree of <= 256 leaves;
# longer proofs are invalid by protocol
MAX_PROOF_DEPTH = 8
BMT_LEVELS = SEGMENT_COUNT.bit_length() - 1   # 128 segments -> 7

ZERO_LEAF = b"\x00" * 32

_SPAN_PREFIX = struct.pack("<Q", DAS_CHUNK_SIZE)
_SPAN = np.frombuffer(_SPAN_PREFIX, dtype=np.uint8).copy()

KERNEL = _build.Kernel("das_samples", "gs_das_samples",
                       "gethsharding_tpu_torch/csrc/das.cu",
                       "gethsharding_tpu/das/proofs.py:177")


def chunk_leaf(chunk: bytes) -> bytes:
    """A DAS tree leaf: the netstore address of one full-size chunk."""
    return chunk_key(DAS_CHUNK_SIZE, chunk)


# -- the commitment tree ----------------------------------------------------


def merkle_levels(leaves: Sequence[bytes]) -> List[List[bytes]]:
    """All levels of the commitment tree, leaves padded to a power of
    two with ZERO_LEAF (levels[0] = padded leaves, levels[-1][0] =
    root)."""
    level = [bytes(leaf) for leaf in leaves] or [ZERO_LEAF]
    size = 1
    while size < len(level):
        size *= 2
    level = level + [ZERO_LEAF] * (size - len(level))
    levels = [level]
    while len(level) > 1:
        level = [keccak256(level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
        levels.append(level)
    return levels


def merkle_root(leaves: Sequence[bytes]) -> bytes:
    return merkle_levels(leaves)[-1][0]


def merkle_proof(levels: List[List[bytes]], index: int) -> Tuple[bytes, ...]:
    """Sibling path leaf -> root for leaf `index` of a `merkle_levels`
    tree (empty for the single-leaf tree)."""
    if not 0 <= index < len(levels[0]):
        raise ValueError(f"leaf {index} out of range")
    path = []
    for level in levels[:-1]:
        path.append(level[index ^ 1])
        index >>= 1
    return tuple(path)


# -- scalar verification (the truth the batched verifier is held to) ---------


def verify_sample(root: bytes, index: int, chunk: bytes,
                  proof: Sequence[bytes]) -> bool:
    """One sample verdict on the host keccak; malformed rows are False."""
    root = bytes(root)
    chunk = bytes(chunk)
    try:
        index = int(index)
    except (TypeError, ValueError):
        return False
    if len(root) != 32 or len(chunk) != DAS_CHUNK_SIZE:
        return False
    if index < 0 or len(proof) > MAX_PROOF_DEPTH:
        return False
    if index >> len(proof):
        return False  # the claimed index lies outside the proven tree
    siblings = [bytes(s) for s in proof]
    if any(len(s) != 32 for s in siblings):
        return False
    node = chunk_leaf(chunk)
    for level, sibling in enumerate(siblings):
        if (index >> level) & 1:
            node = keccak256(sibling + node)
        else:
            node = keccak256(node + sibling)
    return node == root


def verify_samples(chunks: Sequence[bytes], indices: Sequence[int],
                   proofs: Sequence[Sequence[bytes]],
                   roots: Sequence[bytes]) -> List[bool]:
    return [verify_sample(root, index, chunk, proof)
            for chunk, index, proof, root
            in zip(chunks, indices, proofs, roots)]


# -- fixed-shape planes for the batched verifier ------------------------------


PLANES = ("chunks", "sibs", "bits", "levels", "roots", "valid")

_ZERO_CHUNK = bytes(DAS_CHUNK_SIZE)
_ZERO_SIBS = [bytes(32 * k) for k in range(MAX_PROOF_DEPTH + 1)]
_LEVELS = np.arange(MAX_PROOF_DEPTH)
_SIBLING_SIZE = {32}


def plane_shapes(bucket: int) -> dict:
    """(shape, numpy dtype) of each sample plane at `bucket` rows."""
    return {"chunks": ((bucket, DAS_CHUNK_SIZE), np.uint8),
            "sibs": ((bucket, MAX_PROOF_DEPTH, 32), np.uint8),
            "bits": ((bucket, MAX_PROOF_DEPTH), np.bool_),
            "levels": ((bucket, MAX_PROOF_DEPTH), np.bool_),
            "roots": ((bucket, 32), np.uint8),
            "valid": ((bucket,), np.bool_)}


def stage_samples(chunks: Sequence[bytes], indices: Sequence[int],
                  proofs: Sequence[Sequence[bytes]], roots: Sequence[bytes],
                  planes: dict) -> int:
    """Write the rows into `planes` (numpy arrays of `plane_shapes`,
    possibly holding an earlier call's rows): every byte of them, so they
    equal `marshal_samples`' planes. One Python pass checks the rows as
    the scalar path does; then each plane is one copy of a `b"".join`.
    Returns the row count."""
    n, bucket = len(chunks), planes["valid"].shape[0]
    if n > bucket:
        raise ValueError(f"{n} rows do not fit a bucket of {bucket}")
    chunk_parts, sib_parts, root_parts = [], [], []
    index_of, depth_of, rejected = [], [], []
    add_chunk, add_sibs, add_root = (chunk_parts.append, sib_parts.extend,
                                     root_parts.append)
    add_index, add_depth = index_of.append, depth_of.append
    for b in range(n):
        chunk = bytes(chunks[b])
        root = bytes(roots[b])
        proof = list(map(bytes, proofs[b]))
        try:
            index = int(indices[b])
        except (TypeError, ValueError):
            index = -1
        depth = len(proof)
        if (index < 0 or len(chunk) != DAS_CHUNK_SIZE or len(root) != 32
                or depth > MAX_PROOF_DEPTH or index >> depth
                or not set(map(len, proof)) <= _SIBLING_SIZE):
            rejected.append(b)
            chunk, root, proof, index, depth = _ZERO_CHUNK, ZERO_LEAF, [], 0, 0
        add_chunk(chunk)
        proof.append(_ZERO_SIBS[MAX_PROOF_DEPTH - depth])
        add_sibs(proof)
        add_root(root)
        add_index(index)
        add_depth(depth)
    for key, parts in (("chunks", chunk_parts), ("sibs", sib_parts),
                       ("roots", root_parts)):
        plane = planes[key].reshape(bucket, -1)
        plane[:n] = np.frombuffer(b"".join(parts), np.uint8).reshape(
            n, plane.shape[1])
        plane[n:] = 0
    levels = _LEVELS < np.asarray(depth_of, np.int64).reshape(n, 1)
    planes["levels"][:n] = levels
    planes["bits"][:n] = ((np.asarray(index_of, np.int64).reshape(n, 1)
                           >> _LEVELS) & 1).astype(bool) & levels
    planes["valid"][:n] = True
    planes["valid"][rejected] = False
    for key in ("levels", "bits", "valid"):
        planes[key][n:] = False
    return n


def marshal_samples(chunks: Sequence[bytes], indices: Sequence[int],
                    proofs: Sequence[Sequence[bytes]],
                    roots: Sequence[bytes], bucket: int) -> dict:
    """Rows -> fresh (bucket, ...) uint8 / bool planes: chunks (B, 4096),
    sibs (B, 8, 32), bits and levels (B, 8), roots (B, 32), valid (B,).
    Every scalar-path rejection becomes valid[b] = False here."""
    planes = {key: np.empty(shape, dtype)
              for key, (shape, dtype) in plane_shapes(bucket).items()}
    planes["rows"] = stage_samples(chunks, indices, proofs, roots, planes)
    return planes


def verify_planes_plain(chunks, sibs, bits, levels, roots, valid):
    """The reference's `_build_batch_fn` verifier in plain PyTorch: the
    BMT of each full chunk (128 leaf keccaks, then 7 balanced pair
    levels), the netstore key keccak(span_le8 || bmt_root), the path fold
    (masked levels pass the node through), and the root comparison
    ANDed with `valid`. Returns (B,) bool."""
    B = chunks.shape[0]
    nodes = keccak256_fixed(chunks.reshape(B, SEGMENT_COUNT, SEGMENT_SIZE))
    for _ in range(BMT_LEVELS):
        nodes = keccak256_fixed(torch.cat([nodes[:, 0::2], nodes[:, 1::2]],
                                          dim=-1))
    span = const(_SPAN, chunks.device).expand(B, 8)
    node = keccak256_fixed(torch.cat([span, nodes[:, 0]], dim=-1))
    for level in range(MAX_PROOF_DEPTH):
        sib = sibs[:, level]
        msg = torch.where(bits[:, level, None],
                          torch.cat([sib, node], dim=-1),
                          torch.cat([node, sib], dim=-1))
        node = torch.where(levels[:, level, None], keccak256_fixed(msg),
                           node)
    return valid & (node == roots).all(dim=-1)


def verify_planes_kernel(chunks, sibs, bits, levels, roots, valid):
    """Launch `csrc/das.cu` on the `marshal_samples` planes as contiguous
    CUDA tensors (uint8 chunks (B, 4096), sibs (B, 8, 32), roots (B, 32);
    bool bits and levels (B, 8), valid (B,)); returns (B,) bool, equal to
    `verify_planes_plain`."""
    n = chunks.shape[0]
    for name, t, shape, dtype in (
            ("chunks", chunks, (n, DAS_CHUNK_SIZE), torch.uint8),
            ("sibs", sibs, (n, MAX_PROOF_DEPTH, 32), torch.uint8),
            ("bits", bits, (n, MAX_PROOF_DEPTH), torch.bool),
            ("levels", levels, (n, MAX_PROOF_DEPTH), torch.bool),
            ("roots", roots, (n, 32), torch.uint8),
            ("valid", valid, (n,), torch.bool)):
        _build.check_tensor(t, shape, name, dtype)
        if t.data_ptr() % 8:
            raise ValueError(f"{name}: the kernel reads 8-byte lanes; the "
                             f"tensor is not 8-byte aligned")
    out = torch.empty_like(valid)
    if n:
        KERNEL.launch(*map(_build.ptr, (chunks, sibs, bits, levels, roots,
                                        valid)), n, _build.ptr(out))
    return out


def verify_planes(chunks, sibs, bits, levels, roots, valid):
    """The batched sample verifier on the `marshal_samples` planes as
    tensors: the kernel for CUDA tensors (one launch), the plain version
    for CPU tensors. Returns (B,) bool."""
    planes = (chunks, sibs, bits, levels, roots, valid)
    if route.use_kernel(chunks):
        return verify_planes_kernel(*(p.contiguous() for p in planes))
    return verify_planes_plain(*planes)


# -- the kernel's work, for its bound ----------------------------------------

# keccak-f permutations of one sample: 128 leaves, 127 pair nodes, the key
# and one per proof level
def sample_permutations(depth: int) -> int:
    return SEGMENT_COUNT + (SEGMENT_COUNT - 1) + 1 + depth


# 32-bit operations one keccak-f[1600] round needs on this card, whose
# LOP3 computes any logic function of three words, on the two 32-bit
# halves of each 64-bit lane: theta's five column parities two LOP3 each
# and a ^ c[x-1] ^ rot(c[x+1]) one per lane, chi's b ^ (~b1 & b2) one per
# lane, iota one XOR; each 64-bit rotation (theta 5, rho 24; no offset is
# 32) two funnel shifts
ROUND_OPS = 2 * (2 * 5 + 25 + 25 + 1) + 2 * (5 + 24)
PERMUTATION_OPS = 24 * ROUND_OPS
