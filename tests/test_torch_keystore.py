"""The port's keystore (`gethsharding_tpu_torch/mainchain/keystore.py`)
held against the JAX package's, on the CPU, at light scrypt costs:

1. AES-128-CTR: the port's pure-Python AES equals the FIPS-197 vector and
   the reference's `_aes128_ctr` (the `cryptography` package) byte for
   byte, on lengths 0-100 and counters that wrap;
2. key files cross-decrypt between the two packages, both ways, for the
   scrypt and pbkdf2 KDFs, and the Web3 Secret Storage light vectors
   (30- and 31-byte keys) decrypt;
3. scrypt: a parameter set OpenSSL refuses (N >= 2^(16 r)) runs ROMix in
   the port's `csrc/scrypt.c` and equals the reference's
   `native.scrypt_romix` and `scrypt_kdf`; where OpenSSL accepts, the
   composition equals `hashlib.scrypt`;
4. the node identity: `Keystore.load_or_create` across restarts, a wrong
   password, a datadir written by one package read by the other, and a
   `ShardNode` with `password` keeping its address;
5. the build lock: two processes build `csrc/keccak.c` into one empty
   directory at once, and both load a library whose digest is right.
"""

import hashlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from gethsharding_tpu import native
from gethsharding_tpu.mainchain import keystore as ref
from gethsharding_tpu_torch.crypto import secp256k1
from gethsharding_tpu_torch.mainchain import keystore as port

REPO = Path(__file__).resolve().parents[1]
LIGHT = {"scrypt_n": port.LIGHT_SCRYPT_N, "scrypt_p": 1}


# == 1. AES-128-CTR ===========================================================

def test_aes_block_fips197_vector():
    """FIPS-197 appendix C.1: AES-128 of 00112233...ff under key
    000102...0f."""
    keys = port._expand_key(bytes(range(16)))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert port._encrypt_block(keys, block).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 32, 33, 100])
def test_aes128_ctr_equals_reference(length):
    rng = random.Random(length)
    for iv in (rng.randbytes(16), b"\xff" * 16, b"\xff" * 15 + b"\xfe"):
        key, data = rng.randbytes(16), rng.randbytes(length)
        got = port._aes128_ctr(key, iv, data)
        assert got == ref._aes128_ctr(key, iv, data)
        assert port._aes128_ctr(key, iv, got) == data


# == 2. key files across packages ============================================

@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_scrypt_key_files_cross_decrypt(direction):
    priv = 0x1F2E3D4C5B6A798800112233445566778899AABBCCDDEEFF0011223344556677
    enc, dec = (port, ref) if direction == "port->ref" else (ref, port)
    obj = enc.encrypt_key(priv, "cross-pw", **LIGHT)
    obj = json.loads(json.dumps(obj))            # through the file format
    assert dec.decrypt_key(obj, "cross-pw") == priv
    assert obj["address"] == bytes(secp256k1.priv_to_address(priv)).hex()
    with pytest.raises(dec.KeystoreError, match="could not decrypt"):
        dec.decrypt_key(obj, "wrong")


def test_pbkdf2_key_file_decrypts_in_both():
    priv, password = 0xABCDEF, "pbkdf2-pw"
    salt, iv = b"\x11" * 32, b"\x22" * 16
    derived = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 1024, 32)
    ciphertext = ref._aes128_ctr(derived[:16], iv, priv.to_bytes(32, "big"))
    obj = {"address": bytes(secp256k1.priv_to_address(priv)).hex(),
           "crypto": {"cipher": "aes-128-ctr",
                      "ciphertext": ciphertext.hex(),
                      "cipherparams": {"iv": iv.hex()}, "kdf": "pbkdf2",
                      "kdfparams": {"c": 1024, "dklen": 32,
                                    "prf": "hmac-sha256",
                                    "salt": salt.hex()},
                      "mac": ref.keccak256(derived[16:32]
                                           + ciphertext).hex()},
           "id": "x", "version": 3}
    assert port.decrypt_key(obj, password) == ref.decrypt_key(obj, password)
    assert port.decrypt_key(obj, password) == priv


@pytest.mark.parametrize("name", ["31_byte_key", "30_byte_key"])
def test_light_v3_vectors(name):
    vectors = json.loads((REPO / "tests" / "testdata"
                          / "keystore_v3_vectors.json").read_text())
    case = vectors[name]
    assert port.decrypt_key(case["json"], case["password"]) == \
        int(case["priv"], 16)


def test_unsupported_files_refused_like_reference():
    obj = port.encrypt_key(5, "pw", **LIGHT)
    for key, value, match in (("version", 4, "version"),
                              ("cipher", "aes-256-gcm", "cipher"),
                              ("kdf", "argon2", "kdf")):
        bad = json.loads(json.dumps(obj))
        if key == "version":
            bad[key] = value
        else:
            bad["crypto"][key] = value
        for pkg in (port, ref):
            with pytest.raises(pkg.KeystoreError, match=match):
                pkg.decrypt_key(bad, "pw")


# == 3. scrypt ================================================================

def test_romix_beyond_openssl_equals_reference_native():
    """n = 2^16 at r = 1 is past OpenSSL's N < 2^(16 r) bound: hashlib
    refuses it, and the KDF runs `csrc/scrypt.c`'s ROMix."""
    n, r, p = 1 << 16, 1, 2
    with pytest.raises(ValueError):
        hashlib.scrypt(b"pw", salt=b"salt", n=n, r=r, p=p, dklen=32,
                       maxmem=2**31 - 1)
    blocks = random.Random(3).randbytes(p * 128 * r)
    assert port.scrypt_romix(blocks, p, n, r) == \
        native.scrypt_romix(blocks, p, n, r)
    assert port.scrypt_kdf(b"pw", b"salt", n, r, p, 32) == \
        ref.scrypt_kdf(b"pw", b"salt", n, r, p, 32)
    with pytest.raises(ValueError, match="non-pow2"):
        port.scrypt_romix(blocks, p, 1000, r)


@pytest.mark.parametrize("n,r,p", [(1024, 8, 1), (4096, 8, 2), (256, 1, 3)])
def test_romix_composition_equals_openssl(n, r, p):
    blocks = hashlib.pbkdf2_hmac("sha256", b"pw", b"s", 1, p * 128 * r)
    mixed = port.scrypt_romix(blocks, p, n, r)
    assert hashlib.pbkdf2_hmac("sha256", b"pw", mixed, 1, 32) == \
        hashlib.scrypt(b"pw", salt=b"s", n=n, r=r, p=p, dklen=32)
    assert port.scrypt_kdf(b"pw", b"s", n, r, p, 32) == \
        hashlib.scrypt(b"pw", salt=b"s", n=n, r=r, p=p, dklen=32)


# == 4. the node identity =====================================================

def test_load_or_create_keeps_the_address(tmp_path):
    store = port.Keystore(tmp_path / "keystore", **LIGHT)
    first = store.load_or_create("pw")
    again = port.Keystore(tmp_path / "keystore", **LIGHT).load_or_create("pw")
    assert first == again
    (stored,) = store.accounts()
    assert bytes(stored.address) == bytes(secp256k1.priv_to_address(first))
    assert oct(stored.path.stat().st_mode & 0o777) == "0o600"
    with pytest.raises(port.KeystoreError, match="could not decrypt"):
        store.load_or_create("not-pw")
    with pytest.raises(port.KeystoreError, match="no key file"):
        store.unlock(port.Address20(b"\x01" * 20), "pw")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_keystore_directory_crosses_packages(tmp_path, writer):
    mods = {"port": port, "ref": ref}
    other = "ref" if writer == "port" else "port"
    w = mods[writer].Keystore(tmp_path / "ks", scrypt_n=port.LIGHT_SCRYPT_N,
                              scrypt_p=1)
    priv = w.load_or_create("devnet")
    r = mods[other].Keystore(tmp_path / "ks", scrypt_n=port.LIGHT_SCRYPT_N,
                             scrypt_p=1)
    assert r.load_or_create("devnet") == priv
    assert [bytes(a.address) for a in r.accounts()] == \
        [bytes(a.address) for a in w.accounts()]


def test_node_with_password_keeps_its_account(tmp_path, monkeypatch):
    """`ShardNode(data_dir=..., password=...)`: the node's account comes
    from `<datadir>/keystore` and survives a restart, as the reference's
    node's does (`node/backend.py:174-184`)."""
    from gethsharding_tpu_torch.node.backend import ShardNode
    from gethsharding_tpu_torch.smc.chain import SimulatedMainchain

    # the node's keystore at the light cost (its default is geth's
    # standard n = 262,144, 256 MiB a derivation)
    monkeypatch.setattr(port.Keystore.__init__, "__kwdefaults__",
                        {"scrypt_n": port.LIGHT_SCRYPT_N, "scrypt_p": 1})
    kw = dict(actor="observer", data_dir=str(tmp_path), in_memory_db=False,
              password="pw", sig_backend="python", device="cpu")
    accounts = []
    for _ in range(2):
        node = ShardNode(backend=SimulatedMainchain(), **kw)
        accounts.append(bytes(node.client.account()))
        node.stop()
    assert accounts[0] == accounts[1]
    (stored,) = port.Keystore(tmp_path / "keystore").accounts()
    assert bytes(stored.address) == accounts[0]


# == 5. the build lock ========================================================

def test_two_processes_build_keccak_at_once(tmp_path):
    """Both processes wait on the lock, one compiles, and each loads a
    library that hashes right; the stamp is the source's digest."""
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from gethsharding_tpu_torch.crypto import hostlib\n"
        "lib = hostlib.build(hostlib.SRC_DIR / 'keccak.c',\n"
        "                    Path(sys.argv[1]) / 'libkeccak.so')\n"
        "fn = ctypes.CDLL(str(lib)).gs_keccak256\n"
        "fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]\n"
        "out = ctypes.create_string_buffer(32)\n"
        "fn(b'', 0, out)\n"
        "print(out.raw.hex())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.strip() == ("c5d2460186f7233c927e7db2dcc703c0"
                               "e500b653ca82273b7bfad8045d85a470")
    source = REPO / "gethsharding_tpu_torch" / "csrc" / "keccak.c"
    stamp = (tmp_path / "libkeccak.so.sha256").read_text().strip()
    assert stamp == hashlib.sha256(source.read_bytes()).hexdigest()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ".build.lock", "libkeccak.so", "libkeccak.so.sha256"]
    assert os.access(tmp_path / "libkeccak.so", os.R_OK)
