"""Signature backends of the port: the five methods of the JAX package's
`SigBackend` API (proposer-signature recovery, committee audits,
aggregate votes, DAS samples and DAS polynomial multiproofs), and the
registry: `get_backend(name)` (the process's one backend of a name) on
`build_backend(name, device)` (a new one on a device, as a node builds
its own):

- ``torch``: `TorchSigBackend`, the kernels on the CUDA card (default);
- ``python``: `PythonSigBackend`, the scalar host implementations, always
  available: the failover breaker's fallback and the soundness
  spot-checker's reference;
- ``serving-torch`` / ``serving-python``: either behind the coalescing
  serving tier (`serving/`);
- ``failover-<name>``: any of the above as the primary behind a circuit
  breaker over the ``python`` backend (`resilience/breaker.py`).

- ``marshal.py``: host -> limb planes, the padding policy, row keys.
- ``cache.py``: `LineTableCache`, the resident line tables of the
  precomp path.
- ``dispatch.py``: `TorchSigBackend`, the precomp audit (with keys), the
  four-launch recompute audit (without), the aggregate-vote check and
  the multiproofs on its two kernels, the batched secp256k1 recovery and
  the DAS sample verifier (one launch each).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa


class VerdictFuture:
    """Handle on an in-flight committee verification: the kernels are
    queued on the card's stream when it is made, and `result()` pulls the
    verdicts to the host."""

    __slots__ = ("_finalize", "_value", "_done")

    def __init__(self, finalize):
        self._finalize = finalize
        self._value = None
        self._done = False

    def result(self, timeout=None):
        if not self._done:
            self._value = self._finalize()
            self._done = True
            self._finalize = None  # drop the staged tensors
        return self._value

    def done(self) -> bool:
        return self._done


class SigBackend:
    """Batch signature operations of the notary and its callers."""

    name = "abstract"

    def ecrecover_addresses(self, digests: Sequence[bytes],
                            sigs65: Sequence[bytes]) -> List[Optional[bytes]]:
        """Recover the signer address per (32-byte digest, 65-byte
        [R || S || V]) pair; None where the signature is invalid (a
        malformed row is None, never an exception)."""
        raise NotImplementedError

    def bls_verify_aggregates(
            self,
            messages: Sequence[bytes],
            agg_sigs: Sequence[bls.G1Point],
            agg_pks: Sequence[bls.G2Point]) -> List[bool]:
        """Verify one aggregate committee vote per message: the aggregate
        signature against the aggregate pubkey. A signature or pubkey at
        infinity (None) is a rejection."""
        raise NotImplementedError

    def bls_verify_committees(
            self,
            messages: Sequence[bytes],
            sig_rows: Sequence[Sequence[bls.G1Point]],
            pk_rows: Sequence[Sequence[bls.G2Point]],
            pk_row_keys: Optional[Sequence] = None) -> List[bool]:
        """Aggregate each row's vote signatures and voter pubkeys and
        verify the aggregate against the row's message. Empty rows are
        rejections. `pk_row_keys` (one hashable per row) may let a backend
        cache the pubkey rows."""
        return self.bls_verify_committees_async(
            messages, sig_rows, pk_rows, pk_row_keys).result()

    def bls_verify_committees_async(
            self,
            messages: Sequence[bytes],
            sig_rows: Sequence[Sequence[bls.G1Point]],
            pk_rows: Sequence[Sequence[bls.G2Point]],
            pk_row_keys: Optional[Sequence] = None) -> VerdictFuture:
        """`bls_verify_committees` returning a verdict future: the work is
        launched before this returns, so the caller can marshal the next
        batch while it runs."""
        raise NotImplementedError

    def das_verify_samples(
            self,
            chunks: Sequence[bytes],
            indices: Sequence[int],
            proofs: Sequence[Sequence[bytes]],
            roots: Sequence[bytes]) -> List[bool]:
        """Verify one DAS sample per row: does `chunks[i]` sit at leaf
        `indices[i]` of the commitment tree rooted at `roots[i]`, per the
        sibling path `proofs[i]`? (das/proofs.py defines the leaf as the
        chunk's netstore address, so the per-row work is a full BMT
        recompute and a path fold.) Malformed rows (wrong chunk size, bad
        index, over-deep or ragged proofs) are False, never an
        exception: a hostile sample response costs a verdict, not a
        batch."""
        raise NotImplementedError

    def das_verify_multiproofs(
            self,
            commitments: Sequence[bytes],
            index_rows: Sequence[Sequence[int]],
            eval_rows: Sequence[Sequence[int]],
            proofs: Sequence[bytes],
            ns: Sequence[int]) -> List[bool]:
        """Verify one DAS polynomial multiproof per row: does the 64-byte
        G1 point `proofs[i]` open the 64-byte commitment `commitments[i]`
        to the claimed chunk-value evaluations `eval_rows[i]` at the
        sampled index set `index_rows[i]`, over a degree-<ns[i]
        evaluation domain? (das/pcs.py defines the scheme; one row is one
        sampled collation, the proof constant-size however many chunks
        the row samples.) Malformed rows (bad shapes, undecodable or
        off-curve points, duplicate or out-of-domain indices) are False,
        never an exception."""
        raise NotImplementedError


class PythonSigBackend(SigBackend):
    """The scalar host implementations (the JAX package's
    `PythonSigBackend`): the breaker's fallback and the spot-checker's
    reference, never on the default path."""

    name = "python"

    def ecrecover_addresses(self, digests, sigs65):
        out: List[Optional[bytes]] = []
        for digest, sig in zip(digests, sigs65):
            try:
                signature = ecdsa.Signature.from_bytes65(bytes(sig))
                out.append(ecdsa.ecrecover_address(bytes(digest), signature))
            except (ValueError, AssertionError):
                out.append(None)
        return out

    def bls_verify_aggregates(self, messages, agg_sigs, agg_pks):
        return [bls.bls_verify(bytes(m), s, pk)
                for m, s, pk in zip(messages, agg_sigs, agg_pks)]

    def bls_verify_committees(self, messages, sig_rows, pk_rows,
                              pk_row_keys=None):
        return [bls.bls_verify_aggregate(
                    bytes(m), bls.bls_aggregate_sigs(sigs), list(pks))
                for m, sigs, pks in zip(messages, sig_rows, pk_rows)]

    def bls_verify_committees_async(self, messages, sig_rows, pk_rows,
                                    pk_row_keys=None):
        """Computed now: a resolved future."""
        out = self.bls_verify_committees(messages, sig_rows, pk_rows)
        future = VerdictFuture(lambda: out)
        future.result()
        return future

    def das_verify_samples(self, chunks, indices, proofs, roots):
        # lazy: the DAS modules are not needed by every scalar caller
        from gethsharding_tpu_torch.das.proofs import verify_samples

        return verify_samples(chunks, indices, proofs, roots)

    def das_verify_multiproofs(self, commitments, index_rows, eval_rows,
                               proofs, ns):
        from gethsharding_tpu_torch.das.poly_proofs import verify_multiproofs

        return verify_multiproofs(commitments, index_rows, eval_rows,
                                  proofs, ns)


# the names `build_backend` and `get_backend` take
BACKEND_NAMES = ("torch", "python", "serving-torch", "serving-python",
                 "failover-torch", "failover-python",
                 "failover-serving-torch", "failover-serving-python")


def build_backend(name: str, device=None, part=None) -> SigBackend:
    """A new backend of registry name `name`: 'torch' on `device` (None:
    the CUDA card, or `$GETHSHARDING_TORCH_MESH_DEVICES` cards; a list of
    devices: a mesh of those slots, `sigbackend/layout.py`), 'python',
    'serving-<inner>' (the coalescing tier over `part(inner)`) or
    'failover-<primary>' (a breaker over `part(primary)` with
    `part('python')` as its fallback). `part` makes the named inner layer:
    by default a new one on `device`; `get_backend` passes itself, so that
    its wrappers wrap its own backends (imported only when asked for)."""
    if name not in BACKEND_NAMES:
        raise ValueError(
            f"unknown sigbackend {name!r}; choose from {sorted(BACKEND_NAMES)}")
    if part is None:
        part = lambda inner: build_backend(inner, device)
    if name == "torch":
        from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

        return TorchSigBackend(device=device)
    if name == "python":
        return PythonSigBackend()
    if name.startswith("serving-"):
        from gethsharding_tpu_torch.serving.backend import ServingSigBackend

        return ServingSigBackend(part(name[len("serving-"):]))
    from gethsharding_tpu_torch.resilience.breaker import FailoverSigBackend

    return FailoverSigBackend(part(name[len("failover-"):]), part("python"))


_cache: dict = {}


def get_backend(name: str = "torch") -> SigBackend:
    """The process's backend of that name, built on first use (see
    `build_backend`; 'torch' on the CUDA card)."""
    if name not in _cache:
        _cache[name] = build_backend(name, part=get_backend)
    return _cache[name]
