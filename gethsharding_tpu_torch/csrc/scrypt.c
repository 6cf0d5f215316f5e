/* scrypt ROMix (RFC 7914) — the sequential-memory-hard core (the port's
 * copy of the JAX package's native/scrypt.c, built by crypto/hostlib.py).
 *
 * Why this exists: OpenSSL (hashlib.scrypt) enforces N < 2^(128*r/8),
 * which rejects the Ethereum Web3 Secret Storage "light/wiki" profile
 * (n=262144, r=1, p=8) that geth's Go scrypt accepts — so real key
 * files exist that the OpenSSL path cannot decrypt. The outer PBKDF2
 * layers stay in Python (hashlib); only ROMix lives here.
 *
 * Layout contract: `blocks` is p consecutive 128*r-byte blocks (the
 * PBKDF2 output B), transformed in place. Little-endian host assumed
 * (matches every other native module in this tree).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define R32(x, n) (((x) << (n)) | ((x) >> (32 - (n))))

static void salsa8(uint32_t B[16]) {
    uint32_t x[16];
    memcpy(x, B, 64);
    for (int i = 0; i < 4; i++) {
        x[ 4] ^= R32(x[ 0] + x[12], 7);  x[ 8] ^= R32(x[ 4] + x[ 0], 9);
        x[12] ^= R32(x[ 8] + x[ 4], 13); x[ 0] ^= R32(x[12] + x[ 8], 18);
        x[ 9] ^= R32(x[ 5] + x[ 1], 7);  x[13] ^= R32(x[ 9] + x[ 5], 9);
        x[ 1] ^= R32(x[13] + x[ 9], 13); x[ 5] ^= R32(x[ 1] + x[13], 18);
        x[14] ^= R32(x[10] + x[ 6], 7);  x[ 2] ^= R32(x[14] + x[10], 9);
        x[ 6] ^= R32(x[ 2] + x[14], 13); x[10] ^= R32(x[ 6] + x[ 2], 18);
        x[ 3] ^= R32(x[15] + x[11], 7);  x[ 7] ^= R32(x[ 3] + x[15], 9);
        x[11] ^= R32(x[ 7] + x[ 3], 13); x[15] ^= R32(x[11] + x[ 7], 18);
        x[ 1] ^= R32(x[ 0] + x[ 3], 7);  x[ 2] ^= R32(x[ 1] + x[ 0], 9);
        x[ 3] ^= R32(x[ 2] + x[ 1], 13); x[ 0] ^= R32(x[ 3] + x[ 2], 18);
        x[ 6] ^= R32(x[ 5] + x[ 4], 7);  x[ 7] ^= R32(x[ 6] + x[ 5], 9);
        x[ 4] ^= R32(x[ 7] + x[ 6], 13); x[ 5] ^= R32(x[ 4] + x[ 7], 18);
        x[11] ^= R32(x[10] + x[ 9], 7);  x[ 8] ^= R32(x[11] + x[10], 9);
        x[ 9] ^= R32(x[ 8] + x[11], 13); x[10] ^= R32(x[ 9] + x[ 8], 18);
        x[12] ^= R32(x[15] + x[14], 7);  x[13] ^= R32(x[12] + x[15], 9);
        x[14] ^= R32(x[13] + x[12], 13); x[15] ^= R32(x[14] + x[13], 18);
    }
    for (int i = 0; i < 16; i++) B[i] += x[i];
}

/* BlockMix: B (2r 64-byte sub-blocks) -> Y, with the even/odd shuffle. */
static void blockmix(const uint32_t *B, uint32_t *Y, uint32_t r) {
    uint32_t X[16];
    memcpy(X, &B[(2 * r - 1) * 16], 64);
    for (uint32_t i = 0; i < 2 * r; i++) {
        for (int k = 0; k < 16; k++) X[k] ^= B[i * 16 + k];
        salsa8(X);
        /* Y layout: even sub-blocks first, then odd */
        uint32_t dst = (i / 2) + (i & 1) * r;
        memcpy(&Y[dst * 16], X, 64);
    }
}

/* ROMix over p blocks of 128*r bytes each, in place. Returns 0, or -1
 * when the V table cannot be allocated. */
int gs_scrypt_romix(uint8_t *blocks, uint64_t p, uint32_t N, uint32_t r) {
    size_t words = 32 * (size_t)r;            /* uint32s per block */
    uint32_t *V = malloc((size_t)N * words * 4);
    uint32_t *X = malloc(words * 4);
    uint32_t *Y = malloc(words * 4);
    if (!V || !X || !Y) { free(V); free(X); free(Y); return -1; }
    for (uint64_t b = 0; b < p; b++) {
        memcpy(X, blocks + b * words * 4, words * 4);
        for (uint32_t i = 0; i < N; i++) {
            memcpy(&V[(size_t)i * words], X, words * 4);
            blockmix(X, Y, r);
            uint32_t *t = X; X = Y; Y = t;
        }
        for (uint32_t i = 0; i < N; i++) {
            uint32_t j = X[(2 * r - 1) * 16] & (N - 1); /* N is a pow2 */
            const uint32_t *Vj = &V[(size_t)j * words];
            for (size_t k = 0; k < words; k++) X[k] ^= Vj[k];
            blockmix(X, Y, r);
            uint32_t *t = X; X = Y; Y = t;
        }
        memcpy(blocks + b * words * 4, X, words * 4);
    }
    free(V); free(X); free(Y);
    return 0;
}
