"""Encrypted on-disk keystore: scrypt + AES-128-CTR JSON key files (the
port's copy of the JAX package's `mainchain/keystore.py`).

Parity target: `accounts/keystore` (geth Web3 Secret Storage version 3 —
`keystore.go:79`, `passphrase.go` EncryptKey/DecryptKey) as consumed by the
sharding client's unlock flow (`sharding/mainchain/smc_client.go:218`).
Files written here use the same JSON schema, KDF, cipher, and keccak-based
MAC as geth's, so keys round-trip between the two implementations and
between the two packages. The default scrypt cost is geth's "standard"
profile (n=262144, r=8, p=1); tests use light parameters for speed.

Two parts are the port's own, so that a key file opens on a host with
only the standard library: AES-128-CTR is a pure-Python AES (`_aes128_ctr`:
a key file encrypts 32 bytes), and the scrypt parameter sets OpenSSL
refuses run their ROMix in `csrc/scrypt.c`, built with the host C
compiler on first use (`crypto/hostlib.py`) and bound with ctypes.

Identity persistence: `Keystore.load_or_create` gives a node a stable
address across restarts from `<datadir>/keystore` + a password (the
`--datadir`/`--password` flow in `node/cli.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import secrets
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List

from gethsharding_tpu_torch.crypto import hostlib, secp256k1
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.utils.hexbytes import Address20

STANDARD_SCRYPT_N = 262144
STANDARD_SCRYPT_P = 1
LIGHT_SCRYPT_N = 4096
LIGHT_SCRYPT_P = 6
SCRYPT_R = 8
SCRYPT_DKLEN = 32


class KeystoreError(Exception):
    pass


# -- scrypt ----------------------------------------------------------------

_ROMIX_SOURCE = hostlib.SRC_DIR / "scrypt.c"
_ROMIX_LIB = hostlib.BUILD_DIR / "libscrypt.so"
_romix_lock = threading.Lock()
_romix_fn = None


def _romix():
    """`gs_scrypt_romix` of the compiled `csrc/scrypt.c`, built on first
    use."""
    global _romix_fn
    with _romix_lock:
        if _romix_fn is None:
            fn = ctypes.CDLL(str(hostlib.build(
                _ROMIX_SOURCE, _ROMIX_LIB))).gs_scrypt_romix
            fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_uint32, ctypes.c_uint32]
            fn.restype = ctypes.c_int
            _romix_fn = fn
    return _romix_fn


def scrypt_romix(blocks: bytes, p: int, n: int, r: int) -> bytes:
    """RFC 7914 ROMix over `p` consecutive 128*r-byte blocks, in
    `csrc/scrypt.c`."""
    if len(blocks) != p * 128 * r or n <= 0 or n & (n - 1):
        raise ValueError("scrypt_romix: bad block length or non-pow2 N")
    buf = ctypes.create_string_buffer(bytes(blocks), len(blocks))
    if _romix()(buf, p, n, r) != 0:
        raise KeystoreError("scrypt ROMix could not allocate its table")
    return buf.raw


def scrypt_kdf(password: bytes, salt: bytes, n: int, r: int, p: int,
               dklen: int) -> bytes:
    """scrypt that accepts every parameter set geth's Go scrypt does.

    OpenSSL (hashlib.scrypt) enforces the RFC's N < 2^(128*r/8) bound,
    rejecting the Web3 Secret Storage wiki/light profile (n=262144, r=1,
    p=8) — real key files use it, and geth reads them. For those
    parameter sets the outer PBKDF2-SHA256 layers run here and the
    memory-hard ROMix runs in `csrc/scrypt.c`."""
    try:
        return hashlib.scrypt(password, salt=salt, n=n, r=r, p=p,
                              dklen=dklen, maxmem=2**31 - 1)
    except ValueError:
        pass  # OpenSSL parameter bound: take the RFC 7914 composition
    blocks = hashlib.pbkdf2_hmac("sha256", password, salt, 1, p * 128 * r)
    mixed = scrypt_romix(blocks, p, n, r)
    return hashlib.pbkdf2_hmac("sha256", password, mixed, 1, dklen)


# -- AES-128-CTR -------------------------------------------------------------


def _aes_sbox() -> bytes:
    """The AES S-box: the inverse in GF(2^8) (mod x^8+x^4+x^3+x+1, by the
    powers of the generator 3) followed by the affine map (FIPS-197
    §5.1.1)."""
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x ^= ((x << 1) ^ 0x11B) if x & 0x80 else x << 1   # x *= 3
    box = bytearray(256)
    for x in range(256):
        inv = exp[(255 - log[x]) % 255] if x else 0
        s = inv
        for shift in range(1, 5):
            s ^= ((inv << shift) | (inv >> (8 - shift))) & 0xFF
        box[x] = s ^ 0x63
    return bytes(box)


_SBOX = _aes_sbox()
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


def _expand_key(key16: bytes) -> List[List[int]]:
    """The 11 round keys of AES-128, each 16 bytes in column order."""
    words = [list(key16[i:i + 4]) for i in range(0, 16, 4)]
    for i in range(4, 44):
        t = list(words[i - 1])
        if i % 4 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= _RCON[i // 4 - 1]
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(11)]


def _encrypt_block(round_keys: List[List[int]], block: bytes) -> bytes:
    """One AES-128 block encryption (state in column order: byte 4c + r
    is row r of column c)."""
    s = [a ^ b for a, b in zip(block, round_keys[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]
        # ShiftRows: row r rotates left by r columns
        s = [s[4 * ((c + r) % 4) + r] for c in range(4) for r in range(4)]
        if rnd != 10:
            mixed = []
            for c in range(4):
                a = s[4 * c:4 * c + 4]
                total = a[0] ^ a[1] ^ a[2] ^ a[3]
                mixed += [a[r] ^ total ^ _xtime(a[r] ^ a[(r + 1) % 4])
                          for r in range(4)]
            s = mixed
        s = [a ^ b for a, b in zip(s, round_keys[rnd])]
    return bytes(s)


def _aes128_ctr(key16: bytes, iv16: bytes, data: bytes) -> bytes:
    """AES-128 in CTR mode with a 128-bit big-endian counter starting at
    `iv16` (the mode Web3 Secret Storage names, as the `cryptography`
    package's `modes.CTR` runs it); encryption and decryption are one
    function."""
    round_keys = _expand_key(bytes(key16))
    counter = int.from_bytes(iv16, "big")
    out = bytearray()
    for off in range(0, len(data), 16):
        pad = _encrypt_block(round_keys, counter.to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(data[off:off + 16], pad))
        counter = (counter + 1) % (1 << 128)
    return bytes(out)


# -- key files ---------------------------------------------------------------


def encrypt_key(priv: int, password: str, *, scrypt_n: int = STANDARD_SCRYPT_N,
                scrypt_p: int = STANDARD_SCRYPT_P) -> dict:
    """Private key -> Web3 Secret Storage v3 JSON object."""
    salt = secrets.token_bytes(32)
    derived = scrypt_kdf(password.encode(), salt=salt, n=scrypt_n,
                         r=SCRYPT_R, p=scrypt_p, dklen=SCRYPT_DKLEN)
    iv = secrets.token_bytes(16)
    ciphertext = _aes128_ctr(derived[:16], iv, priv.to_bytes(32, "big"))
    mac = keccak256(derived[16:32] + ciphertext)
    address = bytes(secp256k1.priv_to_address(priv))
    return {
        "address": address.hex(),
        "crypto": {
            "cipher": "aes-128-ctr",
            "ciphertext": ciphertext.hex(),
            "cipherparams": {"iv": iv.hex()},
            "kdf": "scrypt",
            "kdfparams": {
                "dklen": SCRYPT_DKLEN,
                "n": scrypt_n,
                "p": scrypt_p,
                "r": SCRYPT_R,
                "salt": salt.hex(),
            },
            "mac": mac.hex(),
        },
        "id": "-".join(secrets.token_hex(n) for n in (4, 2, 2, 2, 6)),
        "version": 3,
    }


def decrypt_key(obj: dict, password: str) -> int:
    """Web3 Secret Storage JSON -> private key int. Raises KeystoreError on
    a wrong password (MAC mismatch) or unsupported parameters."""
    if obj.get("version") != 3:
        raise KeystoreError(f"unsupported keystore version {obj.get('version')}")
    crypto = obj["crypto"]
    if crypto.get("cipher") != "aes-128-ctr":
        raise KeystoreError(f"unsupported cipher {crypto.get('cipher')}")
    ciphertext = bytes.fromhex(crypto["ciphertext"])
    iv = bytes.fromhex(crypto["cipherparams"]["iv"])
    kdf = crypto.get("kdf")
    params = crypto["kdfparams"]
    if kdf == "scrypt":
        derived = scrypt_kdf(password.encode(),
                             salt=bytes.fromhex(params["salt"]),
                             n=params["n"], r=params["r"], p=params["p"],
                             dklen=params["dklen"])
    elif kdf == "pbkdf2":
        if params.get("prf") != "hmac-sha256":
            raise KeystoreError(f"unsupported prf {params.get('prf')}")
        derived = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(params["salt"]),
            params["c"], params["dklen"])
    else:
        raise KeystoreError(f"unsupported kdf {kdf}")
    mac = keccak256(derived[16:32] + ciphertext)
    if mac.hex() != crypto["mac"]:
        raise KeystoreError("could not decrypt key with given password")
    priv = int.from_bytes(_aes128_ctr(derived[:16], iv, ciphertext), "big")
    if not 1 <= priv < secp256k1.N:
        raise KeystoreError("decrypted key is out of range")
    return priv


@dataclass
class StoredAccount:
    address: Address20
    path: Path


class Keystore:
    """Directory of V3 key files (the `<datadir>/keystore` convention)."""

    def __init__(self, directory: os.PathLike | str, *,
                 scrypt_n: int = STANDARD_SCRYPT_N,
                 scrypt_p: int = STANDARD_SCRYPT_P):
        self.directory = Path(directory)
        self.scrypt_n = scrypt_n
        self.scrypt_p = scrypt_p

    def accounts(self) -> List[StoredAccount]:
        """Stored accounts, sorted by file name (creation order for files
        written by `store`, mirroring geth's URL ordering)."""
        out = []
        if not self.directory.is_dir():
            return out
        for path in sorted(self.directory.iterdir()):
            if not path.is_file():
                continue
            try:
                obj = json.loads(path.read_text())
                addr = Address20(bytes.fromhex(obj["address"]))
            except (ValueError, KeyError, json.JSONDecodeError):
                continue
            out.append(StoredAccount(address=addr, path=path))
        return out

    def store(self, priv: int, password: str) -> StoredAccount:
        """Encrypt and write a key file (UTC--<timestamp>--<address>)."""
        obj = encrypt_key(priv, password, scrypt_n=self.scrypt_n,
                          scrypt_p=self.scrypt_p)
        self.directory.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y-%m-%dT%H-%M-%S", time.gmtime())
        path = self.directory / f"UTC--{stamp}--{obj['address']}"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(obj, indent=2))
        os.replace(tmp, path)  # atomic: no torn key files on crash
        try:
            os.chmod(path, 0o600)
        except OSError:
            pass
        return StoredAccount(
            address=Address20(bytes.fromhex(obj["address"])), path=path)

    def unlock(self, address: Address20, password: str) -> int:
        """Decrypt the key file for `address`; KeystoreError if absent or
        the password is wrong."""
        for stored in self.accounts():
            if stored.address == address:
                return decrypt_key(json.loads(stored.path.read_text()),
                                   password)
        raise KeystoreError(f"no key file for {address.hex_str}")

    def load_or_create(self, password: str) -> int:
        """The node-identity flow: decrypt the first stored key, or create
        one if the keystore is empty. A restarted node keeps its address."""
        stored = self.accounts()
        if stored:
            return self.unlock(stored[0].address, password)
        priv = secrets.randbelow(secp256k1.N - 1) + 1
        self.store(priv, password)
        return priv
