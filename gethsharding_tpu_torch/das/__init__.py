"""Data-availability sampling (the port's copy of the JAX package's
`das/`): the notary's availability vote from k sampled chunk proofs, or
one polynomial multiproof, checked in one batched call on the card instead
of a whole-body download.

- ``erasure``     — systematic Reed–Solomon extension of bodies over
  GF(2^8), chunk-aligned to the 4096-byte storage chunk, with
  decode-from-any-k recovery;
- ``sampler``     — seeded deterministic per-(notary, shard, period)
  sample indices and the soundness accounting behind k;
- ``proofs``      — the DAS commitment tree, the scalar sample verdict,
  and the batched verifier on `csrc/das.cu` (`das_verify_samples`);
- ``pcs`` / ``poly_proofs`` — the polynomial commitments and the
  multiproof planes of `das_verify_multiproofs` (the Miller and
  final-exponentiation kernels);
- ``service``     — `DASService`: proposers extend and publish, sampled
  notaries (`--da-mode sampled`) fetch only k chunks with their proofs,
  or one multiproof (`--da-proofs poly`).
"""

from gethsharding_tpu_torch.das.erasure import (  # noqa: F401
    DAS_CHUNK_SIZE,
    ErasureError,
    ExtendedBody,
    MAX_TOTAL_CHUNKS,
    extend_body,
    recover_body,
    rs_decode,
    rs_encode,
)
from gethsharding_tpu_torch.das.proofs import (  # noqa: F401
    MAX_PROOF_DEPTH,
    chunk_leaf,
    merkle_levels,
    merkle_proof,
    merkle_root,
    verify_sample,
)
from gethsharding_tpu_torch.das.sampler import (  # noqa: F401
    detection_probability,
    sample_indices,
    sample_seed,
    soundness_table,
)

__all__ = [
    "DAS_CHUNK_SIZE",
    "ErasureError",
    "ExtendedBody",
    "MAX_PROOF_DEPTH",
    "MAX_TOTAL_CHUNKS",
    "chunk_leaf",
    "detection_probability",
    "extend_body",
    "merkle_levels",
    "merkle_proof",
    "merkle_root",
    "recover_body",
    "rs_decode",
    "rs_encode",
    "sample_indices",
    "sample_seed",
    "soundness_table",
    "verify_sample",
]
