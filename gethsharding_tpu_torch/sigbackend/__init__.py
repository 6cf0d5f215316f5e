"""Signature backends of the port: the BLS subset of the JAX package's
`SigBackend` API (committee audits and aggregate votes), with the
`torch` backend behind `get_backend("torch")`.

- ``marshal.py``: host -> limb planes, the padding policy, row keys.
- ``cache.py``: `LineTableCache`, the resident line tables of the
  precomp path.
- ``dispatch.py``: `TorchSigBackend`, the precomp audit (with keys), the
  four-launch recompute audit (without) and the aggregate-vote check.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from gethsharding_tpu_torch.crypto import bn256 as bls


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
    """Batch BLS signature operations of the notary and its callers."""

    name = "abstract"

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


def _torch_factory() -> SigBackend:
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    return TorchSigBackend()


_BACKENDS = {"torch": _torch_factory}
_cache: dict = {}


def get_backend(name: str = "torch") -> SigBackend:
    """Backend registry of the port: 'torch' (the audit kernels on the
    CUDA card)."""
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown sigbackend {name!r}; choose from {sorted(_BACKENDS)}")
    if name not in _cache:
        _cache[name] = _BACKENDS[name]()
    return _cache[name]
