"""DASService: the actor-facing face of data-availability sampling (the
port's copy of the JAX package's `das/service.py`).

One Service, three roles, fronting the chunk plane as
`storage/netstore.py` does:

- **publisher** (proposer side): `publish()` erasure-extends a freshly
  created collation body, files every extended chunk into the local
  chunk store under its content address (so parity chunks are ordinary
  netstore chunks any peer can pull), builds the commitment tree, and
  signs the commitment with the node key — the binding between the
  on-chain chunk_root and the off-chain DAS root is the proposer's
  signature, the same key that signed the header. In poly mode the
  chunk values' polynomial commitment (`pcs.py`) rides the same digest;
- **server**: answers `DASCommitmentRequest` / `DASampleRequest` /
  `DASMultiproofRequest` from peers out of the published state (chunk +
  sibling path per sampled index, or the chunks + one multiproof);
- **fetcher** (notary side): `fetch_commitment()`, `fetch_samples()` and
  `fetch_multiproof()` broadcast, poll, and retry under the resilience
  policy executor (each attempt re-broadcasts — a lost frame costs a
  capped backoff, not the availability verdict). `collect_rows()` is the
  notary's one-stop: commitment + deterministic sample indices
  (`sampler.py`) + fetched (chunk, proof) rows shaped for ONE batched
  `das_verify_samples` call across shards; `collect_poly_row()` is its
  `--da-proofs poly` form, one row of `das_verify_multiproofs`.
  `prefetch_commitments()` fires the commitment broadcasts for a whole
  candidate set up front so the per-shard fetches find parked responses
  instead of paying a round trip each.

Trust model: sample verdicts prove the sampled chunks are consistent with
the PROPOSER-SIGNED das_root; a proposer that commits to a das_root
inconsistent with its on-chain chunk_root is detected by any full node
that reconstructs (`sampler.py` documents the withholding side). Only
solicited responses are accepted, and a sample or multiproof response is
admitted only after its proof VERIFIES against what was requested (the
netstore content-verified-delivery rule), so a hostile peer can waste a
request — or a counter — but can neither grow state it was not asked for
nor shadow an honest peer's answer with garbage. Commitment responses,
which can only be validated against the on-chain record the fetcher
holds, are parked in a small per-key list for the same reason: a forged
frame arriving first must not evict the genuine one.

`chaos` (a `resilience/chaos.py` `ChaosSchedule`, or None) fires the
``das.*`` seams of `CHAOS_SEAMS`: ``das.parity_publish`` once per publish,
the three fetch seams once per fetch attempt, so an injected fault (a
`ConnectionError`) rides the fetch's retry ladder like a lost frame.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from gethsharding_tpu_torch import metrics, tracing
from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.das import pcs
from gethsharding_tpu_torch.das.erasure import (DAS_CHUNK_SIZE,
                                                MAX_TOTAL_CHUNKS,
                                                extend_body)
from gethsharding_tpu_torch.das.poly_proofs import verify_multiproof
from gethsharding_tpu_torch.das.proofs import (MAX_PROOF_DEPTH, chunk_leaf,
                                               merkle_levels, merkle_proof,
                                               verify_sample)
from gethsharding_tpu_torch.das.sampler import sample_indices, sample_seed
from gethsharding_tpu_torch.p2p.messages import (DASCommitmentRequest,
                                                 DASCommitmentResponse,
                                                 DASMultiproofRequest,
                                                 DASMultiproofResponse,
                                                 DASampleRequest,
                                                 DASampleResponse)
from gethsharding_tpu_torch.resilience.errors import (FetchAborted,
                                                      TransientError)
from gethsharding_tpu_torch.resilience.policy import (DEFAULT_RETRYABLE,
                                                      POLL_MISS,
                                                      RetryExecutor,
                                                      RetryPolicy,
                                                      poll_probe)
from gethsharding_tpu_torch.storage.chunker import ChunkStore

# the chaos seams of this service (the node CLI's `--chaos` wires them for
# `--da-mode sampled`)
CHAOS_SEAMS = ("das.commitment_fetch", "das.sample_fetch",
               "das.parity_publish", "das.multiproof_fetch")

# the supported --da-proofs modes: merkle sibling paths or one
# constant-size polynomial multiproof per sampled collation (das/pcs.py)
PROOF_MODES = ("merkle", "poly")

# per-request index cap at the serving side: an unauthenticated request
# stream must not turn one frame into unbounded proof work
MAX_SAMPLE_INDICES = 64

# commitment responses parked per (shard, period) while the fetcher
# polls: >1 so a forged frame cannot shadow the genuine one, small so
# a flooding peer cannot grow state
MAX_PARKED_COMMITMENTS = 4

_COMMIT_DOMAIN = b"gethsharding-das-commit:"


class _CommitmentMiss(TransientError):
    """No peer delivered the commitment within one fetch attempt."""


class _SampleMiss(TransientError):
    """Sampled chunks still missing after one fetch attempt."""


class _MultiproofMiss(TransientError):
    """No verified multiproof response within one fetch attempt."""


@dataclass(frozen=True)
class DASCommitment:
    """The proposer's published extension commitment for one
    (shard, period) collation."""

    shard_id: int
    period: int
    chunk_root: bytes
    das_root: bytes
    k: int
    n: int
    body_len: int
    # 64-byte G1 polynomial commitment (das/pcs.py) in --da-proofs=poly
    # mode; empty in merkle-only mode. Signed into the same digest, and
    # the digest of a merkle-only commitment is BIT-IDENTICAL to the
    # pre-poly wire format (appending zero bytes appends nothing).
    poly_commitment: bytes = b""
    signature: bytes = b""

    def digest(self) -> bytes:
        return commitment_digest(self.shard_id, self.period,
                                 self.chunk_root, self.das_root,
                                 self.k, self.n, self.body_len,
                                 self.poly_commitment)


def commitment_digest(shard_id: int, period: int, chunk_root: bytes,
                      das_root: bytes, k: int, n: int, body_len: int,
                      poly_commitment: bytes = b"") -> bytes:
    """What the proposer signs: every field of the commitment, bound to
    the on-chain chunk_root, under a DAS domain tag."""
    return keccak256(_COMMIT_DOMAIN
                     + int(shard_id).to_bytes(8, "big")
                     + int(period).to_bytes(8, "big")
                     + bytes(chunk_root) + bytes(das_root)
                     + int(k).to_bytes(2, "big")
                     + int(n).to_bytes(2, "big")
                     + int(body_len).to_bytes(8, "big")
                     + bytes(poly_commitment))


def _poly_commitment_ok(poly_commitment: bytes) -> bool:
    """Empty (merkle-only publisher) or a decodable on-curve 64-byte G1
    point — a commitment carrying undecodable poly bytes is rejected
    outright, before it can poison a multiproof fetch."""
    if not poly_commitment:
        return True
    try:
        pcs.g1_from_bytes(poly_commitment)
    except (TypeError, ValueError):
        return False
    return True


def verify_commitment(commitment: DASCommitment, proposer) -> bool:
    """The proposer's signature must recover to the record's proposer —
    the same authorship check the header signature carries."""
    try:
        sig = ecdsa.Signature.from_bytes65(bytes(commitment.signature))
        recovered = ecdsa.ecrecover_address(commitment.digest(), sig)
    except ValueError:
        return False
    return recovered == proposer


class DASService(Service):
    """Publish / serve / fetch DAS commitments and sampled chunks."""

    name = "das"
    supervisable = True

    def __init__(self, client=None, p2p=None,
                 store: Optional[ChunkStore] = None,
                 parity_ratio: float = 0.5,
                 samples: int = 16,
                 chaos=None,
                 poll_interval: float = 0.02,
                 fetch_timeout: float = 3.0,
                 fetch_attempts: int = 3,
                 proof_mode: str = "merkle"):
        super().__init__()
        if proof_mode not in PROOF_MODES:
            raise ValueError(f"unknown DAS proof mode {proof_mode!r}; "
                             f"choose from {PROOF_MODES}")
        self.client = client
        self.p2p = p2p
        self.proof_mode = proof_mode
        # the parity-publish sink: extended chunks are filed here under
        # their content address, so a node that ALSO runs a NetStore on
        # the same store serves them over the ordinary chunk protocol
        self.store = store if store is not None else ChunkStore()
        self.parity_ratio = parity_ratio
        self.samples = samples
        self.chaos = chaos
        self.poll_interval = poll_interval
        self.fetch_timeout = fetch_timeout
        self._attempt_timeout = fetch_timeout / max(1, fetch_attempts)
        # the default transient set, which holds this layer's own miss
        # signals (TransientError) and a chaos InjectedFault
        # (ConnectionError): a lost frame costs a capped backoff
        self._fetch_retry = RetryExecutor(
            "das", RetryPolicy(attempts=max(1, fetch_attempts),
                               base_s=poll_interval, cap_s=0.25,
                               deadline_s=fetch_timeout,
                               retryable=DEFAULT_RETRYABLE))
        # published state (server side)
        self._blobs: Dict[bytes, tuple] = {}   # das_root -> (xb, levels)
        self._poly: Dict[bytes, list] = {}     # das_root -> chunk values
        self._commitments: Dict[Tuple[int, int], DASCommitment] = {}
        # fetched state (fetcher side); solicited-only admission
        self._want_commitments: set = set()    # (shard, period)
        self._want_samples: set = set()        # (das_root, index)
        # (das_root, indices) -> (poly_commitment, n) while a
        # multiproof fetch is in flight — the pump verifies responses
        # against exactly what was solicited
        self._want_multi: Dict[tuple, tuple] = {}
        self._recv_commitments: Dict[tuple, list] = {}
        self._recv_samples: Dict[tuple, tuple] = {}
        self._recv_multi: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        self._subs = []
        # counters (the /status `das` namespace + Prometheus rows)
        self.m_published = metrics.counter("das/published")
        self.m_samples_served = metrics.counter("das/samples_served")
        self.m_samples_fetched = metrics.counter("das/samples_fetched")
        self.m_sample_wire_bytes = metrics.counter("das/sample_wire_bytes")
        self.m_samples_verified = metrics.counter("das/samples_verified")
        self.m_sample_failures = metrics.counter("das/sample_failures")
        self.m_commitments_rejected = metrics.counter(
            "das/commitments_rejected")
        self.m_samples_rejected = metrics.counter("das/samples_rejected")
        self.m_multiproofs_served = metrics.counter(
            "das/multiproofs_served")
        self.m_multiproofs_fetched = metrics.counter(
            "das/multiproofs_fetched")
        self.m_multiproofs_rejected = metrics.counter(
            "das/multiproofs_rejected")
        self.bytes_fetched = 0

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if self.p2p is None:
            return  # local-only: publish/serve in-process (tests, RPC)
        self.p2p.start()
        handlers = ((DASCommitmentRequest, self._on_commitment_request),
                    (DASampleRequest, self._on_sample_request),
                    (DASCommitmentResponse, self._on_commitment_response),
                    (DASampleResponse, self._on_sample_response),
                    (DASMultiproofRequest, self._on_multiproof_request),
                    (DASMultiproofResponse, self._on_multiproof_response))
        for kind, handler in handlers:
            sub = self.p2p.subscribe(kind)
            self._subs.append(sub)
            self.spawn(self._pump(sub, handler),
                       name=f"das-{kind.__name__}")

    def on_stop(self) -> None:
        for sub in self._subs:
            sub.unsubscribe()
        self._subs = []

    def _pump(self, sub, handler):
        def loop() -> None:
            while not self.stopped():
                try:
                    msg = sub.get(timeout=self.poll_interval)
                except Exception:
                    continue
                try:
                    handler(msg)
                except Exception as exc:  # noqa: BLE001 - hostile frames
                    # must cost a counter, never the pump thread
                    self.record_error(f"das handler failed: {exc}")
        return loop

    def _fire(self, seam: str) -> None:
        if self.chaos is not None:
            self.chaos.fire(seam)

    # -- publisher side ----------------------------------------------------

    def publish(self, shard_id: int, period: int, chunk_root,
                body: bytes) -> DASCommitment:
        """Extend `body`, file every extended chunk into the chunk
        store (parity chunks become ordinary netstore chunks), build
        and sign the commitment, and start serving both. The proposer
        calls this right after `save_collation`."""
        with tracing.span("das/publish", shard=shard_id, period=period):
            self._fire("das.parity_publish")
            xb = extend_body(bytes(body), parity_ratio=self.parity_ratio)
            levels = merkle_levels([chunk_leaf(c) for c in xb.chunks])
            das_root = levels[-1][0]
            for chunk in xb.chunks:
                self.store.put_chunk(DAS_CHUNK_SIZE, chunk)
            poly_commitment = b""
            values = None
            if self.proof_mode == "poly":
                # the chunk values ARE the polynomial's evaluations;
                # the 64-byte commitment rides the same signed digest
                values = [pcs.chunk_value(c) for c in xb.chunks]
                poly_commitment = pcs.g1_to_bytes(pcs.commit(values))
            digest = commitment_digest(shard_id, period, bytes(chunk_root),
                                       das_root, xb.k, xb.n, xb.body_len,
                                       poly_commitment)
            signature = (self.client.sign(digest)
                         if self.client is not None else b"")
            commitment = DASCommitment(
                shard_id=shard_id, period=period,
                chunk_root=bytes(chunk_root), das_root=das_root,
                k=xb.k, n=xb.n, body_len=xb.body_len,
                poly_commitment=poly_commitment, signature=signature)
            with self._lock:
                self._blobs[das_root] = (xb, levels)
                if values is not None:
                    self._poly[das_root] = values
                self._commitments[(shard_id, period)] = commitment
            self.m_published.inc()
            return commitment

    def commitment(self, shard_id: int,
                   period: int) -> Optional[DASCommitment]:
        with self._lock:
            return self._commitments.get((shard_id, period))

    # -- server side -------------------------------------------------------

    def _on_commitment_request(self, msg) -> None:
        req: DASCommitmentRequest = msg.data
        commitment = self.commitment(int(req.shard_id), int(req.period))
        if commitment is None:
            return  # not ours to serve; another peer may hold it
        self.p2p.send(DASCommitmentResponse(
            shard_id=commitment.shard_id, period=commitment.period,
            chunk_root=commitment.chunk_root,
            das_root=commitment.das_root, k=commitment.k,
            n=commitment.n, body_len=commitment.body_len,
            poly_commitment=commitment.poly_commitment,
            signature=commitment.signature), msg.peer)

    def _on_sample_request(self, msg) -> None:
        req: DASampleRequest = msg.data
        with self._lock:
            blob = self._blobs.get(bytes(req.das_root))
        if blob is None:
            return
        xb, levels = blob
        for index in list(req.indices)[:MAX_SAMPLE_INDICES]:
            index = int(index)
            if not 0 <= index < xb.n:
                continue
            self.p2p.send(DASampleResponse(
                das_root=bytes(req.das_root), index=index,
                chunk=xb.chunks[index],
                proof=merkle_proof(levels, index)), msg.peer)
            self.m_samples_served.inc()

    def _on_multiproof_request(self, msg) -> None:
        req: DASMultiproofRequest = msg.data
        root = bytes(req.das_root)
        with self._lock:
            blob = self._blobs.get(root)
            values = self._poly.get(root)
        if blob is None or values is None:
            return  # not ours to serve, or published merkle-only
        xb, _levels = blob
        indices = tuple(int(i) for i in
                        list(req.indices)[:MAX_SAMPLE_INDICES])
        if (not indices or len(set(indices)) != len(indices)
                or any(not 0 <= i < xb.n for i in indices)):
            return  # malformed request costs the requester its answer
        proof, _evals = pcs.open_multi(values, indices)
        self.p2p.send(DASMultiproofResponse(
            das_root=root, indices=indices,
            chunks=tuple(xb.chunks[i] for i in indices),
            proof=pcs.g1_to_bytes(proof)), msg.peer)
        self.m_multiproofs_served.inc()

    # -- fetcher side ------------------------------------------------------

    def _on_commitment_response(self, msg) -> None:
        # parked raw until the fetcher validates it against the record
        # — only the fetcher knows the expected proposer/chunk_root.
        # A bounded LIST per key, not a slot: a forged frame that wins
        # the race must not evict the honest one behind it.
        resp: DASCommitmentResponse = msg.data
        key = (int(resp.shard_id), int(resp.period))
        with self._lock:
            if key not in self._want_commitments:
                return  # unsolicited
            parked = self._recv_commitments.setdefault(key, [])
            if len(parked) < MAX_PARKED_COMMITMENTS:
                parked.append(resp)

    def _on_sample_response(self, msg) -> None:
        resp: DASampleResponse = msg.data
        key = (bytes(resp.das_root), int(resp.index))
        with self._lock:
            if key not in self._want_samples or key in self._recv_samples:
                return  # unsolicited, or already answered
        chunk = bytes(resp.chunk)
        proof = tuple(bytes(s) for s in resp.proof)
        if (len(chunk) > DAS_CHUNK_SIZE or len(proof) > MAX_PROOF_DEPTH
                or not verify_sample(key[0], key[1], chunk, proof)):
            # content-verified delivery (the netstore admission rule):
            # a garbage frame is dropped HERE — outside the lock, the
            # proof check is ~129 keccaks — so it can never occupy the
            # slot an honest peer's answer needs. The verdict the
            # batched op later computes for admitted rows is therefore
            # True by construction for delivered samples; False rows
            # come from withheld (never-delivered) indices.
            self.m_samples_rejected.inc()
            return
        with self._lock:
            if (key not in self._want_samples
                    or key in self._recv_samples):
                return  # answered while we were verifying (first wins)
            self._recv_samples[key] = (chunk, proof)
        self.m_samples_fetched.inc()
        self.m_sample_wire_bytes.inc(len(chunk) + 32 * len(proof) + 40)
        self.bytes_fetched += len(chunk) + 32 * len(proof) + 40

    def _on_multiproof_response(self, msg) -> None:
        resp: DASMultiproofResponse = msg.data
        root = bytes(resp.das_root)
        indices = tuple(int(i) for i in resp.indices)
        key = (root, indices)
        with self._lock:
            want = self._want_multi.get(key)
            if want is None or key in self._recv_multi:
                return  # unsolicited, or already answered
        poly_commitment, n = want
        chunks = tuple(bytes(c) for c in resp.chunks)
        proof = bytes(resp.proof)
        # content-verified delivery, multiproof edition: the response
        # is admitted only if the single proof OPENS the solicited poly
        # commitment to the delivered chunks' derived values. The check
        # is the scalar PCS verifier — one host pairing per admitted
        # response, the same cost class as a scalar bls_verify — so a
        # garbage frame can never occupy the slot an honest answer
        # needs (first VERIFIED wins).
        if (len(chunks) != len(indices)
                or any(len(c) != DAS_CHUNK_SIZE for c in chunks)
                or not verify_multiproof(
                    poly_commitment, indices,
                    [pcs.chunk_value(c) for c in chunks], proof, n)):
            self.m_multiproofs_rejected.inc()
            return
        with self._lock:
            if key not in self._want_multi or key in self._recv_multi:
                return  # answered while we were verifying (first wins)
            self._recv_multi[key] = (chunks, proof)
        self.m_multiproofs_fetched.inc()
        wire = sum(len(c) for c in chunks) + len(proof) + 40
        self.m_sample_wire_bytes.inc(wire)
        self.bytes_fetched += wire

    def fetch_commitment(self, shard_id: int, period: int, chunk_root,
                         proposer) -> Optional[DASCommitment]:
        """The validated commitment for (shard, period): local first,
        then the network under the retry policy. A response only
        lands if its chunk_root matches the ON-CHAIN record, its shape
        is sane, and its signature recovers to the record's proposer."""
        key = (int(shard_id), int(period))
        local = self.commitment(shard_id, period)
        if local is not None:
            with self._lock:  # clear any prefetch leftovers for the key
                self._want_commitments.discard(key)
                self._recv_commitments.pop(key, None)
            return local
        if self.p2p is None or self.stopped():
            return None
        expected_root = bytes(chunk_root)

        def take() -> DASCommitment:
            with self._lock:
                parked = self._recv_commitments.pop(key, None)
            if not parked:
                raise _CommitmentMiss("no response yet")
            # validate every parked response; the FIRST VALID one wins,
            # so a forged frame that won the race costs nothing
            rejected = 0
            for resp in parked:
                commitment = DASCommitment(
                    shard_id=key[0], period=key[1],
                    chunk_root=bytes(resp.chunk_root),
                    das_root=bytes(resp.das_root), k=int(resp.k),
                    n=int(resp.n), body_len=int(resp.body_len),
                    poly_commitment=bytes(
                        getattr(resp, "poly_commitment", b"")),
                    signature=bytes(resp.signature))
                if (commitment.chunk_root != expected_root
                        or not 1 <= commitment.k <= commitment.n
                        or commitment.n > MAX_TOTAL_CHUNKS
                        or not 0 <= commitment.body_len
                        <= commitment.k * DAS_CHUNK_SIZE
                        or not _poly_commitment_ok(
                            commitment.poly_commitment)
                        or not verify_commitment(commitment, proposer)):
                    rejected += 1
                    continue
                if rejected:
                    self.m_commitments_rejected.inc(rejected)
                with self._lock:
                    self._commitments[key] = commitment
                return commitment
            self.m_commitments_rejected.inc(rejected)
            self.record_error(
                f"rejected DAS commitment for shard {shard_id} "
                f"period {period}: binding/signature check failed")
            raise _CommitmentMiss("rejected response")

        def attempt() -> DASCommitment:
            self._fire("das.commitment_fetch")
            self.p2p.broadcast(DASCommitmentRequest(shard_id=key[0],
                                                    period=key[1]))
            got = poll_probe(
                take, self.wait, interval_s=self.poll_interval,
                polls=max(1, int(self._attempt_timeout
                                 / self.poll_interval)),
                not_ready=(_CommitmentMiss,))
            if got is POLL_MISS:
                raise _CommitmentMiss(
                    f"DAS commitment for shard {shard_id} period "
                    f"{period} not delivered")
            return got

        with self._lock:
            self._want_commitments.add(key)
        try:
            return self._fetch_retry.call(attempt)
        except (TransientError, FetchAborted, ConnectionError,
                TimeoutError, OSError):
            return None
        finally:
            with self._lock:
                self._want_commitments.discard(key)
                self._recv_commitments.pop(key, None)

    def prefetch_commitments(self, pairs) -> None:
        """Fire-and-forget commitment requests for many (shard, period)
        pairs at once: registers the want keys and broadcasts, so the
        responses park while the caller does other work and the later
        per-pair `fetch_commitment` finds them without paying a round
        trip each — the sampled notary's analog of the full-fetch
        path's overlapped body prefetch. Never blocks, never raises."""
        if self.p2p is None or self.stopped():
            return
        wanted = []
        with self._lock:
            for shard_id, period in pairs:
                key = (int(shard_id), int(period))
                if key not in self._commitments:
                    self._want_commitments.add(key)
                    wanted.append(key)
        for key in wanted:
            try:
                self.p2p.broadcast(DASCommitmentRequest(shard_id=key[0],
                                                        period=key[1]))
            except Exception:  # noqa: BLE001 - best-effort warmup only
                return

    def fetch_samples(self, commitment: DASCommitment,
                      indices) -> Dict[int, tuple]:
        """(chunk, proof) per requested index, fetched from peers under
        the retry policy (each attempt re-broadcasts the still-missing
        subset). Missing entries mean no peer answered in time — the
        caller scores them as failed samples."""
        indices = [int(i) for i in indices]
        root = bytes(commitment.das_root)
        # locally published blobs answer without a network round trip
        with self._lock:
            blob = self._blobs.get(root)
        if blob is not None:
            xb, levels = blob
            return {i: (xb.chunks[i], merkle_proof(levels, i))
                    for i in indices if 0 <= i < xb.n}
        if self.p2p is None or self.stopped() or not indices:
            return {}
        keys = {(root, i) for i in indices}

        def missing() -> list:
            with self._lock:
                return [i for i in indices
                        if (root, i) not in self._recv_samples]

        def complete() -> bool:
            if missing():
                raise _SampleMiss("samples still missing")
            return True

        def attempt() -> None:
            self._fire("das.sample_fetch")
            still = missing()
            if not still:
                return
            self.p2p.broadcast(DASampleRequest(das_root=root,
                                               indices=tuple(still)))
            got = poll_probe(
                complete, self.wait, interval_s=self.poll_interval,
                polls=max(1, int(self._attempt_timeout
                                 / self.poll_interval)),
                not_ready=(_SampleMiss,))
            if got is POLL_MISS:
                raise _SampleMiss(
                    f"{len(missing())} of {len(indices)} DAS samples "
                    f"not delivered")

        with self._lock:
            self._want_samples.update(keys)
        try:
            self._fetch_retry.call(attempt)
        except (TransientError, FetchAborted, ConnectionError,
                TimeoutError, OSError):
            pass  # partial results are still results: caller scores them
        finally:
            with self._lock:
                self._want_samples.difference_update(keys)
                out = {i: self._recv_samples.pop((root, i))
                       for i in indices
                       if (root, i) in self._recv_samples}
        return out

    def fetch_multiproof(self, commitment: DASCommitment,
                         indices) -> Optional[tuple]:
        """(chunks, proof) for the sampled `indices` under one
        constant-size multiproof, fetched from peers under the retry
        policy. Responses are verified against the commitment's poly
        commitment BEFORE admission (content-verified delivery), so a
        returned tuple is already proven; None means no peer delivered
        a verifying answer in time."""
        indices = tuple(int(i) for i in indices)
        if not indices:
            return None
        root = bytes(commitment.das_root)
        # locally published blobs answer without a network round trip
        with self._lock:
            blob = self._blobs.get(root)
            values = self._poly.get(root)
        if blob is not None and values is not None:
            xb, _levels = blob
            if any(not 0 <= i < xb.n for i in indices):
                return None
            proof, _evals = pcs.open_multi(values, indices)
            return (tuple(xb.chunks[i] for i in indices),
                    pcs.g1_to_bytes(proof))
        if (self.p2p is None or self.stopped()
                or not commitment.poly_commitment):
            return None
        key = (root, indices)

        def take() -> tuple:
            with self._lock:
                got = self._recv_multi.get(key)
            if got is None:
                raise _MultiproofMiss("no verified response yet")
            return got

        def attempt() -> tuple:
            self._fire("das.multiproof_fetch")
            self.p2p.broadcast(DASMultiproofRequest(das_root=root,
                                                    indices=indices))
            got = poll_probe(
                take, self.wait, interval_s=self.poll_interval,
                polls=max(1, int(self._attempt_timeout
                                 / self.poll_interval)),
                not_ready=(_MultiproofMiss,))
            if got is POLL_MISS:
                raise _MultiproofMiss(
                    f"DAS multiproof for {len(indices)} indices "
                    f"not delivered")
            return got

        with self._lock:
            self._want_multi[key] = (bytes(commitment.poly_commitment),
                                     int(commitment.n))
        try:
            return self._fetch_retry.call(attempt)
        except (TransientError, FetchAborted, ConnectionError,
                TimeoutError, OSError):
            return None
        finally:
            with self._lock:
                self._want_multi.pop(key, None)
                self._recv_multi.pop(key, None)

    # -- the notary-side one-stop ------------------------------------------

    def collect_rows(self, shard_id: int, period: int, record,
                     account) -> Optional[dict]:
        """Everything one (shard, period) availability check needs, as
        rows for the batched `das_verify_samples` op: the validated
        commitment, the notary's deterministic sample indices, and the
        fetched (chunk, proof) per index — a missing sample becomes a
        synthesized invalid row so it SCORES as a failed check instead
        of silently shrinking k. None = no commitment (unavailable)."""
        with tracing.span("das/collect", shard=shard_id, period=period):
            commitment = self.fetch_commitment(
                shard_id, period, record.chunk_root, record.proposer)
            if commitment is None:
                return None
            indices = sample_indices(
                sample_seed(bytes(account), shard_id, period,
                            commitment.das_root),
                self.samples, commitment.n)
            got = self.fetch_samples(commitment, indices)
            chunks, proofs = [], []
            for i in indices:
                chunk, proof = got.get(i, (b"", ()))
                chunks.append(chunk)
                proofs.append(proof)
            return {"chunks": chunks, "indices": indices,
                    "proofs": proofs,
                    "roots": [commitment.das_root] * len(indices),
                    "commitment": commitment}

    def collect_poly_row(self, shard_id: int, period: int, record,
                         account) -> Optional[dict]:
        """The --da-proofs=poly analog of `collect_rows`: ONE row of
        the batched `das_verify_multiproofs` op per (shard, period) —
        the validated commitment, the notary's deterministic sample
        indices, the chunk-derived evaluations, and the single
        constant-size proof. A failed fetch (or a merkle-only
        commitment) becomes a synthesized invalid row (empty proof)
        so it SCORES as a failed check. None = no commitment."""
        with tracing.span("das/collect_poly", shard=shard_id,
                          period=period):
            commitment = self.fetch_commitment(
                shard_id, period, record.chunk_root, record.proposer)
            if commitment is None:
                return None
            indices = sample_indices(
                sample_seed(bytes(account), shard_id, period,
                            commitment.das_root),
                self.samples, commitment.n)
            got = self.fetch_multiproof(commitment, indices)
            if got is None:
                chunks: tuple = ()
                evals = [0] * len(indices)
                proof = b""
            else:
                chunks, proof = got
                evals = [pcs.chunk_value(c) for c in chunks]
            return {"poly_commitment": commitment.poly_commitment,
                    "indices": list(indices), "evals": evals,
                    "proof": proof, "n": commitment.n,
                    "chunks": chunks, "commitment": commitment}

    def note_verdicts(self, verdicts) -> int:
        """Score one batch's verdicts into the das counters; returns
        the number of failures."""
        ok = sum(1 for v in verdicts if v)
        bad = len(list(verdicts)) - ok
        if ok:
            self.m_samples_verified.inc(ok)
        if bad:
            self.m_sample_failures.inc(bad)
        return bad

    # -- RPC / light-client serving ----------------------------------------

    def get_sample(self, shard_id: int, period: int,
                   index: int) -> Optional[dict]:
        """One locally held sample (the `shard_getSample` body), or
        None when this node never published/held the blob."""
        commitment = self.commitment(shard_id, period)
        if commitment is None:
            return None
        with self._lock:
            blob = self._blobs.get(bytes(commitment.das_root))
        if blob is None or not 0 <= int(index) < commitment.n:
            return None
        xb, levels = blob
        index = int(index)
        return {"commitment": commitment, "index": index,
                "chunk": xb.chunks[index],
                "proof": merkle_proof(levels, index)}

    def get_multiproof(self, shard_id: int, period: int,
                       indices) -> Optional[dict]:
        """The locally held multiproof plane (the `shard_getSample`
        poly body): all requested chunks + ONE 64-byte proof. None
        when this node never published the blob in poly mode or any
        index is out of range."""
        commitment = self.commitment(shard_id, period)
        if commitment is None:
            return None
        indices = tuple(int(i) for i in
                        list(indices)[:MAX_SAMPLE_INDICES])
        if (not indices or len(set(indices)) != len(indices)
                or any(not 0 <= i < commitment.n for i in indices)):
            return None
        with self._lock:
            blob = self._blobs.get(bytes(commitment.das_root))
            values = self._poly.get(bytes(commitment.das_root))
        if blob is None or values is None:
            return None
        xb, _levels = blob
        proof, _evals = pcs.open_multi(values, indices)
        self.m_multiproofs_served.inc()
        return {"commitment": commitment, "indices": list(indices),
                "chunks": [xb.chunks[i] for i in indices],
                "proof": pcs.g1_to_bytes(proof)}

    def da_status(self, shard_id: int, period: int) -> dict:
        """The `shard_daStatus` body: is a commitment known for the
        pair, and what shape is the extension?"""
        commitment = self.commitment(shard_id, period)
        if commitment is None:
            return {"known": False, "shard_id": shard_id,
                    "period": period}
        with self._lock:
            holds_blob = bytes(commitment.das_root) in self._blobs
        return {"known": True, "shard_id": shard_id, "period": period,
                "das_root": commitment.das_root.hex(),
                "chunk_root": bytes(commitment.chunk_root).hex(),
                "k": commitment.k, "n": commitment.n,
                "body_len": commitment.body_len,
                "holds_blob": holds_blob,
                "proof_mode": self.proof_mode,
                "poly_commitment": commitment.poly_commitment.hex(),
                "default_samples": self.samples}
