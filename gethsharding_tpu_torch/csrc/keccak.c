/* keccak.c — Keccak-f[1600] + Ethereum-flavoured keccak-256, on the host.
 *
 * The port's own copy of the JAX package's native/keccak.c (the port
 * imports nothing of that package). crypto/keccak.py builds it with the
 * host C compiler on first use into _build/ and binds it with ctypes;
 * hash_to_g1's try-and-increment hashes every message through it.
 * Multi-rate padding with the 0x01 domain byte (Ethereum keccak, NOT
 * NIST SHA3-256). A host-side C file, not a CUDA kernel: ops/_build.py
 * compiles only the *.cu sources.
 *
 * Exports:
 *   gs_keccak256(in, len, out32)
 *   gs_keccak256_batch(in, n, stride, len, out)  -- n messages of equal
 *       length `len`, laid out every `stride` bytes; out = n*32 bytes.
 */

#include <stdint.h>
#include <string.h>

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                             27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
static const int PILN[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                             15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};

void gs_keccak_f1600(uint64_t st[25]) {
  uint64_t bc[5], t;
  for (int round = 0; round < 24; round++) {
    /* theta */
    for (int i = 0; i < 5; i++)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; i++) {
      t = bc[(i + 4) % 5] ^ ROTL64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    /* rho + pi */
    t = st[1];
    for (int i = 0; i < 24; i++) {
      int j = PILN[i];
      uint64_t tmp = st[j];
      st[j] = ROTL64(t, ROTC[i]);
      t = tmp;
    }
    /* chi */
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; i++) bc[i] = st[j + i];
      for (int i = 0; i < 5; i++)
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
    }
    /* iota */
    st[0] ^= RC[round];
  }
}

void gs_keccak256(const uint8_t *in, uint64_t len, uint8_t *out32) {
  uint64_t st[25];
  uint8_t block[136];
  memset(st, 0, sizeof(st));
  while (len >= 136) {
    for (int i = 0; i < 17; i++) {
      uint64_t lane;
      memcpy(&lane, in + 8 * i, 8); /* little-endian hosts */
      st[i] ^= lane;
    }
    gs_keccak_f1600(st);
    in += 136;
    len -= 136;
  }
  memset(block, 0, sizeof(block));
  memcpy(block, in, len);
  block[len] = 0x01;   /* Ethereum keccak domain padding */
  block[135] |= 0x80;
  for (int i = 0; i < 17; i++) {
    uint64_t lane;
    memcpy(&lane, block + 8 * i, 8);
    st[i] ^= lane;
  }
  gs_keccak_f1600(st);
  memcpy(out32, st, 32);
}

void gs_keccak256_batch(const uint8_t *in, uint64_t n, uint64_t stride,
                        uint64_t len, uint8_t *out) {
  for (uint64_t i = 0; i < n; i++)
    gs_keccak256(in + i * stride, len, out + 32 * i);
}
