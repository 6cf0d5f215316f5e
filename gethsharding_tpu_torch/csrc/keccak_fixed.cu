// Batched keccak-256 over fixed-length messages: (n, len) bytes in, (n, 32)
// digests out, one launch.
//
// Replaces no Pallas kernel: the JAX package hashes fixed-length rows with
// `keccak256_fixed` (gethsharding_tpu/ops/keccak_jax.py:123), an XLA
// computation, whose plain PyTorch twin here is ops/keccak.py
// `keccak256_fixed`. The replay and the vote batch run it three ways:
// sender addresses (n = shards × transactions, len 64), committee sampling
// (n = vote attempts, len 96) and the state roots (n = shards, len = 60 ×
// accounts, 245,760 bytes at 4,096 accounts: 1,808 permutations in turn).
//
// What bounds it on this card: for many short messages, the permutations'
// 32-bit logical operations (keccak.cuh: 4,320 a permutation); for a long
// message, its permutations in turn, each 24 rounds of a dependent path
// (chip_smoke.py step 12 holds the root against that chain bound). One
// kernel, two routes, chosen on `len` (KF_WARP_MIN_LEN):
//
//   thread route (len < KF_WARP_MIN_LEN): a thread a message, its sponge in
//     registers (`keccak_f1600` of keccak.cuh), full blocks absorbed as
//     8-byte lanes where the message is 8-byte aligned and byte by byte
//     otherwise, the last block padded by selects (Ethereum's 0x01 ...
//     0x80), so every lane index is static: ~4,400 instructions a
//     permutation on one thread's chain.
//   warp route (len >= KF_WARP_MIN_LEN): a warp a message. Lane l = x + 5y
//     of the first 25 owns word l of the state in a register. A round is
//     three phases over a double-buffered state in shared memory (sa, sb),
//     `__syncwarp()` between them: each lane stores its word in sa; each
//     reads the ten words of columns x - 1 and x + 1 (row-major, so the
//     five words of a column fall in five bank pairs of their own: no
//     bank conflict), forms their parities, applies theta and its own rho
//     rotation and stores the word at its pi destination in sb, the two
//     32-bit halves each where a rotation by 32 puts it (no select); each
//     takes chi from its two row neighbours in sb and iota as a lane-0
//     mask. That is two shared-memory round trips and 7 dependent
//     operations a round, with no branch: lanes 25 to 31 run the same
//     code on slots no other lane reads. The 24 rounds are unrolled (the
//     round constants become immediates). The 17 lanes of the rate load
//     the next block's word while the permutation runs, so the message's
//     loads are off the chain.
//
// Every per-lane value is indexed by a static trip k of KF_TRIPS: one trip
// of 32 lanes on the card; 25 trips of one lane in a host build that runs
// a block as one thread (tests/torch_host_shim.py). No phase writes what
// it reads, so that one thread running the lanes in order is a legal
// schedule.

#include "keccak.cuh"

namespace gs {

constexpr int KF_THREADS = 128;       // threads a block: messages or warps
constexpr int KF_ROUND_UNROLL = 2;    // keccak rounds a trip, thread route
constexpr int KF_WARP_UNROLL = 24;    // ... warp route: the constants inline
constexpr int KF_RATE = 136;          // bytes a block absorbs
constexpr int KF_RATE_LANES = KF_RATE / 8;
// the shortest message the warp route takes, in bytes: from two
// permutations on
constexpr int KF_WARP_MIN_LEN = 136;
#ifdef __CUDA_ARCH__
constexpr int KF_LANES = 32;          // the lanes a warp route runs on
#else
constexpr int KF_LANES = 1;           // a host build: one thread, in turn
#endif
constexpr int KF_TRIPS = (25 + KF_LANES - 1) / KF_LANES;
constexpr int KF_WARPS = KF_THREADS / KF_LANES;

// rho: the rotation of lane x + 5y
static __constant__ int KF_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                                      20, 3,  10, 43, 25, 39, 41, 45, 15,
                                      21, 8,  18, 2,  61, 56, 14};

__device__ __forceinline__ u64 load_lane_bytes(const unsigned char* p) {
  u64 w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) w |= (u64)p[j] << (8 * j);
  return w;
}

// *p = v rotated left by s in [0, 63], s a run-time value. On the card
// the 32-bit halves are rotated by s mod 32 and stored each at the half
// where a rotation by 32 puts it, so no select is on the chain.
__device__ __forceinline__ void store_rotated(u64* p, u64 v, int s) {
#ifdef __CUDA_ARCH__
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  unsigned* q = reinterpret_cast<unsigned*>(p);
  const int swap = (s >> 5) & 1;
  q[swap] = __funnelshift_l(hi, lo, s);
  q[1 - swap] = __funnelshift_l(lo, hi, s);
#else
  *p = s ? (v << s) | (v >> (64 - s)) : v;
#endif
}

// Word l (< 17) of block b of the message m, the padding included: the
// last block holds the tail, 0x01, zeros and 0x80 in its last byte.
__device__ __forceinline__ u64 block_word(const unsigned char* m,
                                          long long len, long long b, int l,
                                          bool aligned) {
  const long long full = len / KF_RATE;
  const unsigned char* p = m + b * KF_RATE + 8 * l;
  if (b < full)
    return aligned ? *reinterpret_cast<const u64*>(p) : load_lane_bytes(p);
  const int rem = (int)(len - full * KF_RATE);
  u64 w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 8 * l + j;
    unsigned byte = k < rem ? p[j] : (k == rem ? 0x01u : 0u);
    if (k == KF_RATE - 1) byte |= 0x80u;
    w |= (u64)byte << (8 * j);
  }
  return w;
}

// The parity of the column whose top word is at c
__device__ __forceinline__ u64 column_parity(const u64* c) {
  return xor3(xor3(c[0], c[5], c[10]), c[15], c[20]);
}

// One message on one warp (lanes `lane`, lane + KF_LANES, ...), its state
// double-buffered in the warp's sa and sb (32 words each, word x + 5y at
// x + 5y: a column's five words fall in five bank pairs of their own, so
// the parities' loads have no bank conflict). Lanes 25 to 31 of a warp
// run the same code on slots 25 to 31, which no other lane reads, so the
// round has no branch.
template <int UNROLL>
__device__ __forceinline__ void sponge_warp(const unsigned char* m,
                                            long long len, unsigned char* o,
                                            u64* sa, u64* sb, int lane) {
  const bool aligned = (reinterpret_cast<unsigned long long>(m) & 7) == 0;
  const long long blocks = len / KF_RATE + 1;
  int idx[KF_TRIPS], rho[KF_TRIPS], dst[KF_TRIPS], n1[KF_TRIPS],
      n2[KF_TRIPS];
  const u64 *cl[KF_TRIPS], *cr[KF_TRIPS];
  u64 own[KF_TRIPS], next[KF_TRIPS], iota[KF_TRIPS];
#pragma unroll
  for (int k = 0; k < KF_TRIPS; ++k) {
    const int l = lane + KF_LANES * k;
    const int x = l % 5, y = l / 5;
    const bool real = l < 25;
    idx[k] = l;
    rho[k] = real ? KF_RHO[l] : 0;
    dst[k] = real ? y + 5 * ((2 * x + 3 * y) % 5) : l;  // pi, into sb
    n1[k] = real ? (x + 1) % 5 + 5 * y : l;            // chi's row
    n2[k] = real ? (x + 2) % 5 + 5 * y : l;
    cl[k] = sa + (x + 4) % 5;                          // theta's columns
    cr[k] = sa + (x + 1) % 5;
    iota[k] = l == 0 ? ~0ull : 0ull;
    own[k] = 0;
    next[k] = l < KF_RATE_LANES ? block_word(m, len, 0, l, aligned) : 0;
  }
  for (long long b = 0; b < blocks; ++b) {
#pragma unroll
    for (int k = 0; k < KF_TRIPS; ++k) {
      own[k] ^= next[k];
      // the next block's word, loaded now and absorbed after the rounds
      next[k] = idx[k] < KF_RATE_LANES && b + 1 < blocks
                    ? block_word(m, len, b + 1, idx[k], aligned)
                    : 0;
    }
#pragma unroll (UNROLL)
    for (int round = 0; round < 24; ++round) {
#pragma unroll
      for (int k = 0; k < KF_TRIPS; ++k) sa[idx[k]] = own[k];
      __syncwarp();
      // theta with the parities of columns x - 1 and x + 1, rho, pi
#pragma unroll
      for (int k = 0; k < KF_TRIPS; ++k)
        store_rotated(sb + dst[k],
                      xor3(own[k], column_parity(cl[k]),
                           rotl<1>(column_parity(cr[k]))),
                      rho[k]);
      __syncwarp();
      // chi along the row, iota on lane 0
#pragma unroll
      for (int k = 0; k < KF_TRIPS; ++k)
        own[k] = sb[idx[k]] ^ (~sb[n1[k]] & sb[n2[k]]) ^
                 (KECCAK_RC[round] & iota[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < KF_TRIPS; ++k)
    if (idx[k] < 4)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[8 * idx[k] + j] = (unsigned char)(own[k] >> (8 * j));
}

// One message on one thread, its sponge in registers.
__device__ __forceinline__ void sponge_thread(const unsigned char* m,
                                              long long len,
                                              unsigned char* o) {
  const bool aligned = (reinterpret_cast<unsigned long long>(m) & 7) == 0;
  u64 a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  const long long full = len / KF_RATE;
  for (long long b = 0; b < full; ++b) {
    const unsigned char* p = m + b * KF_RATE;
    if (aligned) {
      const u64* w = reinterpret_cast<const u64*>(p);
#pragma unroll
      for (int i = 0; i < KF_RATE_LANES; ++i) a[i] ^= w[i];
    } else {
#pragma unroll
      for (int i = 0; i < KF_RATE_LANES; ++i)
        a[i] ^= load_lane_bytes(p + 8 * i);
    }
    keccak_f1600<KF_ROUND_UNROLL>(a);
  }
  // the last block: the message's tail, 0x01, zeros, 0x80 in its last byte
  const int rem = (int)(len - full * KF_RATE);
  const unsigned char* p = m + full * KF_RATE;
#pragma unroll
  for (int i = 0; i < KF_RATE_LANES; ++i) {
    u64 w = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * i + j;
      unsigned byte = k < rem ? p[k] : (k == rem ? 0x01u : 0u);
      if (k == KF_RATE - 1) byte |= 0x80u;
      w |= (u64)byte << (8 * j);
    }
    a[i] ^= w;
  }
  keccak_f1600<KF_ROUND_UNROLL>(a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[8 * i + j] = (unsigned char)(a[i] >> (8 * j));
}

// data (n, len) bytes, row-major; out (n, 32) bytes. Messages of at least
// KF_WARP_MIN_LEN bytes take a warp each (blockDim.x / KF_LANES a block),
// shorter ones a thread each (blockDim.x a block). The launch bounds ask
// for one block an SM at least, so that ptxas spends registers on the
// warp route's unrolled rounds: at its own count (94 registers) the
// root's rounds took ~1.5 times as long (scripts/torch_keccak_routes.py,
// the form "default registers").
__global__ void __launch_bounds__(KF_THREADS, 1)
    keccak_fixed_kernel(const unsigned char* data, long long n,
                        long long len, unsigned char* out) {
  if (len < KF_WARP_MIN_LEN) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row < n) sponge_thread(data + row * len, len, out + row * 32);
    return;
  }
  __shared__ u64 state[KF_WARPS][2][32];   // a warp's sa and sb
  const int warp = threadIdx.x / KF_LANES, lane = threadIdx.x % KF_LANES;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / KF_LANES) + warp;
  if (row >= n) return;   // the whole warp: row is the same on its lanes
  sponge_warp<KF_WARP_UNROLL>(data + row * len, len, out + row * 32,
                              state[warp][0], state[warp][1], lane);
}

}  // namespace gs

#ifdef __CUDACC__
// n messages of len bytes each at data, digests into out (n, 32).
// Returns the first CUDA error of the launch, 0 if none.
extern "C" int gs_keccak_fixed(const unsigned char* data, long long n,
                               long long len, unsigned char* out,
                               cudaStream_t stream) {
  if (n < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // a block holds KF_THREADS messages, or a message a 32-lane warp
  const long long per_block =
      len < gs::KF_WARP_MIN_LEN ? gs::KF_THREADS : gs::KF_THREADS / 32;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gs::keccak_fixed_kernel<<<(unsigned)blocks, gs::KF_THREADS, 0, stream>>>(
      data, n, len, out);
  return (int)cudaGetLastError();
}
#endif
