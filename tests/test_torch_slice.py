"""The port's committee audit as a whole (gethsharding_tpu_torch
.sigbackend) against the JAX package's scalar `python` backend, plus the
port's boundaries: its entry points default to CUDA, its host hash runs
the compiled keccak, its knobs are its own, and it imports neither JAX
nor the JAX package."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gethsharding_tpu.crypto import bn256 as ref
from gethsharding_tpu.sigbackend import get_backend as ref_get_backend
from gethsharding_tpu.sigbackend import marshal as ref_marshal
from gethsharding_tpu_torch import sigbackend
from gethsharding_tpu_torch.sigbackend import marshal
from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

# Two intra-op threads: the suite runs several test files at once, one
# process each, and the default (a thread per core) makes them fight.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _workload():
    """4 rows × 4 votes: valid, a forged vote, an empty committee, and a
    row whose message was swapped for another shard's."""
    keys = [ref.bls_keygen(b"slice-%d" % j) for j in range(4)]
    msgs = [b"slice-header-%d" % s for s in range(4)]
    sig_rows = [[ref.bls_sign(m, sk) for sk, _ in keys] for m in msgs]
    pk_rows = [[pk for _, pk in keys] for _ in msgs]
    sig_rows[1][2] = ref.g1_add(sig_rows[1][2], ref.G1_GEN)
    sig_rows[2], pk_rows[2] = [], []
    msgs[3] = msgs[0]
    return msgs, sig_rows, pk_rows


def test_host_crypto_matches_reference():
    from gethsharding_tpu.crypto import keccak as ref_keccak
    from gethsharding_tpu_torch.crypto import bn256 as port_bls
    from gethsharding_tpu_torch.crypto import keccak

    assert keccak.keccak256(b"").hex().startswith("c5d24601")
    for data in (b"abc", bytes(range(200)), b"x" * 136):
        assert keccak.keccak256(data) == ref_keccak.keccak256_py(data)
    for m in (b"", b"header-7", bytes(64)):
        assert port_bls.hash_to_g1(m) == ref.hash_to_g1(m)
    got = port_bls.g2_mul(5, port_bls.G2_GEN)
    want = ref.g2_mul(5, ref.G2_GEN)
    assert [(c.a, c.b) for c in got] == [(c.a, c.b) for c in want]
    assert port_bls.OPT_ATE_NAF == ref.OPT_ATE_NAF


def test_cpu_audit_matches_python_backend():
    msgs, sig_rows, pk_rows = _workload()
    want = ref_get_backend("python").bls_verify_committees(
        msgs, sig_rows, pk_rows)
    assert want == [True, False, False, False]
    backend = TorchSigBackend(device="cpu")
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=[b"a", b"b"]) == want
    future = backend.bls_verify_committees_async(msgs, sig_rows, pk_rows)
    assert future.result() == want and future.done()
    assert backend.last_timing["bucket"] == 4
    assert backend.bls_verify_committees([], [], []) == []


def test_keccak_takes_the_native_path(monkeypatch):
    """With a C compiler, the port's keccak256 runs its compiled copy of
    the C keccak, and equals its pure-Python twin and the reference's on
    the official KAT messages and on hash_to_g1's inputs."""
    from gethsharding_tpu.crypto import keccak as ref_keccak
    from gethsharding_tpu_torch.crypto import bn256 as port_bls
    from gethsharding_tpu_torch.crypto import keccak

    assert shutil.which(os.environ.get("CC", "cc")), "no C compiler"
    assert keccak.native_available()
    kats = json.loads((REPO / "tests/testdata/keccak_kats_sha3.json")
                      .read_text())
    msgs = [bytes.fromhex(c["message"])[: c["len"]] for c in kats["SHA3-256"]]
    for msg, case in zip(msgs, kats["SHA3-256"]):
        # the twin's sponge with NIST padding gives the official digest
        assert keccak._sponge(msg, keccak.RATE_BYTES, 32, 0x06).hex() == \
            case["digest"]
    inputs = msgs + [m + c.to_bytes(4, "big") for m in
                     (b"", b"header-7", b"period-0/shard-3/header")
                     for c in range(4)]
    digests = [keccak.keccak256(m) for m in inputs]
    inputs += digests                  # hash_to_g1's parity hashes
    digests += [keccak.keccak256(d) for d in digests]

    def no_python(data):
        raise AssertionError("keccak256 took the pure-Python path")

    monkeypatch.setattr(keccak, "keccak256_py", no_python)
    assert [keccak.keccak256(m) for m in inputs] == digests
    monkeypatch.undo()
    assert digests == [keccak.keccak256_py(m) for m in inputs] \
        == [ref_keccak.keccak256_py(m) for m in inputs]
    port_bls.hash_to_g1.cache_clear()
    for m in (b"m-0", b"header-7", bytes(64)):
        assert port_bls.hash_to_g1(m) == ref.hash_to_g1(m)


def test_precomp_off_sends_keyed_audits_to_recompute(monkeypatch):
    msgs, sig_rows, pk_rows = _workload()
    monkeypatch.setenv("GETHSHARDING_TORCH_PRECOMP", "0")
    backend = TorchSigBackend(device="cpu")
    assert not backend.precomp
    got = backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                        pk_row_keys=[b"a", b"b", b"c", b"d"])
    assert got == [True, False, False, False]
    timing = backend.last_timing
    assert not timing["precomp"] and timing["limb_form"] == "wide"
    assert timing["g2_wire_bytes"] > 0 and len(backend.lines) == 0
    monkeypatch.setenv("GETHSHARDING_TORCH_PRECOMP", "yes")
    with pytest.raises(ValueError, match="GETHSHARDING_TORCH_PRECOMP"):
        TorchSigBackend(device="cpu")
    assert TorchSigBackend(device="cpu", precomp=True).precomp


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert TorchSigBackend().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSigBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        sigbackend.get_backend("torch")
    with pytest.raises(ValueError, match="unknown sigbackend"):
        sigbackend.get_backend("jax")


@pytest.mark.parametrize("n", [1, 3, 8, 9, 65, 100, 135, 300])
def test_padding_policy_matches_reference(n):
    assert marshal.bucket_size(n) == ref_marshal.bucket_size(n)
    rows = [[None] * n, [None] * (n // 2)]
    assert marshal.committee_width(rows, rows[:1]) == \
        ref_marshal.committee_width(rows, rows[:1])


def test_port_imports_neither_jax_nor_reference():
    modules = sorted(
        "gethsharding_tpu_torch." + ".".join(p.with_suffix("").relative_to(
            REPO / "gethsharding_tpu_torch").parts)
        for p in (REPO / "gethsharding_tpu_torch").rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gethsharding_tpu' or m.startswith('gethsharding_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 12
