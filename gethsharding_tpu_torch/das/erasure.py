"""The DAS chunk constants: the port's copy of the two the sample
verifier needs from the JAX package's `das/erasure.py` (the erasure code
itself is not copied)."""

from gethsharding_tpu_torch.storage.chunker import CHUNK_SIZE

DAS_CHUNK_SIZE = CHUNK_SIZE  # 4096: DAS chunks are storage chunks
# the erasure code's cap on chunks per blob, which bounds commitment
# trees to 256 leaves (depth 8)
MAX_TOTAL_CHUNKS = 255
