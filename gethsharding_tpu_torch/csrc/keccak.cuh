// Keccak-256 device code shared by the port's kernels: the keccak-f[1600]
// permutation on 25 64-bit lanes in registers, and a one-block sponge of up
// to 8 words. `das.cu` (the DAS samples) and `keccak_fixed.cu` (the batched
// fixed-length hash) include it.
//
// What bounds a permutation on this card: 32-bit logical operations, 4,320
// a permutation (24 rounds of 180: LOP3 takes any three-input logic
// function, so chi and theta's folded XOR are one per 32-bit half, a
// five-way parity two; a 64-bit rotation is two funnel shifts). Every lane
// index is static, so the state stays in registers. UNROLL is the rounds a
// trip of the round loop (the includer's choice: code size against issue).

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

typedef unsigned long long u64;

static __constant__ u64 KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

template <int S>
__device__ __forceinline__ u64 rotl(u64 v) {
  return (v << S) | (v >> (64 - S));
}

// a ^ b ^ c in one three-input LOP3 per 32-bit half. Written as C, the
// compiler shares theta's b ^ c between a column's five lanes and spends
// an extra XOR on it per half: 60 operations where 50 do.
__device__ __forceinline__ u64 xor3(u64 a, u64 b, u64 c) {
#ifdef __CUDA_ARCH__
  unsigned lo, hi;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;"
      : "=r"(lo)
      : "r"((unsigned)a), "r"((unsigned)b), "r"((unsigned)c));
  asm("lop3.b32 %0, %1, %2, %3, 0x96;"
      : "=r"(hi)
      : "r"((unsigned)(a >> 32)), "r"((unsigned)(b >> 32)),
        "r"((unsigned)(c >> 32)));
  return ((u64)hi << 32) | lo;
#else
  return a ^ b ^ c;
#endif
}

// one rho-pi step: lane J takes the carried lane rotated by S
#define GS_RHO_PI(J, S) \
  {                     \
    const u64 next = a[J]; \
    a[J] = rotl<S>(carry); \
    carry = next;       \
  }

template <int UNROLL>
__device__ __forceinline__ void keccak_f1600(u64 (&a)[25]) {
#pragma unroll (UNROLL)
  for (int round = 0; round < 24; ++round) {
    u64 c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    // theta: each lane takes both parities in one three-input XOR
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const u64 left = c[(x + 4) % 5], right = rotl<1>(c[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[y + x] = xor3(a[y + x], left, right);
    }
    // rho and pi along the cycle of lanes that starts at lane 1
    u64 carry = a[1];
    GS_RHO_PI(10, 1) GS_RHO_PI(7, 3) GS_RHO_PI(11, 6) GS_RHO_PI(17, 10)
    GS_RHO_PI(18, 15) GS_RHO_PI(3, 21) GS_RHO_PI(5, 28) GS_RHO_PI(16, 36)
    GS_RHO_PI(8, 45) GS_RHO_PI(21, 55) GS_RHO_PI(24, 2) GS_RHO_PI(4, 14)
    GS_RHO_PI(15, 27) GS_RHO_PI(23, 41) GS_RHO_PI(19, 56) GS_RHO_PI(13, 8)
    GS_RHO_PI(12, 25) GS_RHO_PI(2, 43) GS_RHO_PI(20, 62) GS_RHO_PI(14, 18)
    GS_RHO_PI(22, 39) GS_RHO_PI(9, 61) GS_RHO_PI(6, 20) GS_RHO_PI(1, 44)
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      u64 b[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) b[x] = a[y + x];
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[x] ^ (~b[(x + 1) % 5] & b[(x + 2) % 5]);
    }
    a[0] ^= KECCAK_RC[round];
  }
}
#undef GS_RHO_PI

// keccak-256 of the first `words` (4, 5 or 8) little-endian 64-bit words
// of m, one block, into out. The length picks the padding by selects, so
// every index into the sponge is static.
template <int UNROLL>
__device__ __forceinline__ void keccak_msg(const u64 (&m)[8], int words,
                                           u64 (&out)[4]) {
  u64 a[25];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (i < words ? m[i] : 0ull) ^ (i == words ? 0x01ull : 0ull);
  a[8] = words == 8 ? 0x01ull : 0ull;
#pragma unroll
  for (int i = 9; i < 25; ++i) a[i] = 0;
  a[16] = 0x8000000000000000ull;
  keccak_f1600<UNROLL>(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = a[i];
}

}  // namespace gs
