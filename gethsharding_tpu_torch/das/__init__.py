"""Data-availability sampling: the sample proofs and their batched
verifier (`proofs.py`, on `csrc/das.cu`), and the polynomial multiproofs
(`pcs.py`, the commitments and the scalar verdict; `poly_proofs.py`, the
batch's pairing planes)."""
