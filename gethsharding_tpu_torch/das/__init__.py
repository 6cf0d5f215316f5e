"""Data-availability sampling: the sample proofs and their batched
verifier (`proofs.py`, on `csrc/das.cu`)."""
