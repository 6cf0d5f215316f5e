// DAS sample verification: up to DAS_BLOCK_SAMPLES samples a block, their
// tree levels and path folds packed into the block's warps together.
//
// Computes what the batched sample verifier `_build_batch_fn` of
// gethsharding_tpu/das/proofs.py (:177, an XLA computation over
// ops/keccak_jax.py there, not a Pallas kernel) computes, and what its
// plain twin `verify_planes_plain` (das/proofs.py) computes: per sample,
// the BMT root of its 4096-byte chunk (128 keccaks of the 32-byte
// segments, then 7 levels of keccak(left || right)), the netstore key
// keccak(span_le8 || bmt_root), the fold of the masked proof levels
// (keccak(node || sibling), or keccak(sibling || node) where the index
// bit is set), and the verdict: the folded node equals the root, ANDed
// with `valid`. Every message (32, 40 or 64 bytes) is one 136-byte block
// with Ethereum's 0x01 ... 0x80 padding.
//
// What bounds it on this card: 32-bit logical operations. A sample is
// 264 keccak-f[1600] permutations at depth 8 (128 + 127 + 1 + 8), 4,320
// 32-bit operations each (24 rounds of 180: LOP3 takes any three-input
// logic function, so chi and theta's folded XOR are one per 32-bit half,
// a five-way parity two; a 64-bit rotation is two funnel shifts), against
// ~4.4 KB of input. A warp's instruction takes the same scheduler time
// whatever share of its lanes is busy, so the design keeps warps full.
//
// The design. Thread per sponge: each item of work is one sponge whose
// 25 lanes stay in registers, every message index is static (the padding
// goes in by selects), so nothing of it spills to local memory. A block
// takes `per_block` consecutive rows. Its first thread lists the
// rows with `valid` set and writes out = 0 for the others, which are
// never hashed (the bucket's pad rows and the host's rejections); a block
// with none left returns. Every phase is then one block-stride loop over
// the (sample, node) items of all the listed rows, so the narrow levels
// of a block's samples share warps where one sample alone would leave a
// warp 1/32 to 1/2 busy. The launch gives a block ceil(n / SMs) rows, at
// most DAS_BLOCK_SAMPLES: a large batch runs in one wave of full blocks,
// a small one spreads over the SMs.
//
// The phases:
//
//   1. leaf pairs, 64 items a sample: keccak of segments 2i and 2i + 1
//      and of the two leaves, into node slot i (3 permutations);
//   2. five pair levels (32, 16, 8, 4, 2 items a sample): item i of the
//      level of stride s hashes slots 2is and (2i + 1)s into slot 2is,
//      in place;
//   3. the tail, 1 item a sample: the BMT root from slots 0 and 32, the
//      netstore key, the path fold level by level (masked levels pass
//      the node through), and the verdict (up to 10 permutations).
//
// A barrier ends each phase. No item reads a slot that another item of
// its phase writes, so one thread running the block in order (the host
// shim of the tests) is a legal schedule; the kernel uses no warp
// shuffle.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

typedef unsigned long long u64;

constexpr int DAS_BLOCK_SAMPLES = 13;  // most rows a block verifies together
constexpr int DAS_THREADS = 256;       // threads a block
constexpr int DAS_ROUND_UNROLL = 2;    // keccak rounds a trip of the loop
constexpr int DAS_SEGMENTS = 128;
constexpr int DAS_PAIRS = DAS_SEGMENTS / 2;   // node slots a sample
constexpr int DAS_PAIR_LEVELS = 5;     // widths 32 .. 2 in shared memory
constexpr int DAS_DEPTH = 8;           // proof levels
constexpr int DAS_CHUNK = 4096;
constexpr u64 DAS_SPAN = 4096;         // the chunk's span, little-endian u64

static __constant__ u64 DAS_RC[24] = {
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

__device__ __forceinline__ void keccak_f1600(u64 (&a)[25]) {
#pragma unroll (DAS_ROUND_UNROLL)
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
    a[0] ^= DAS_RC[round];
  }
}
#undef GS_RHO_PI

// keccak-256 of the first `words` (4, 5 or 8) little-endian 64-bit words
// of m, one block, into out. The length picks the padding by selects, so
// every index into the sponge is static.
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
  keccak_f1600(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = a[i];
}

// rows a block takes for n rows on `sms` SMs
inline int das_block_rows(int n, int sms) {
  const int rows = sms > 0 ? (n + sms - 1) / sms : DAS_BLOCK_SAMPLES;
  return rows < 1 ? 1 : rows > DAS_BLOCK_SAMPLES ? DAS_BLOCK_SAMPLES : rows;
}

__device__ __forceinline__ void load4(u64 (&dst)[4], const u64* src) {
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = src[j];
}

// chunks (n, 4096), sibs (n, 8, 32), roots (n, 32): bytes; bits, levels
// (n, 8), valid (n,), out (n,): 0/1 bytes. Block b verifies rows
// b * per_block onwards, per_block <= DAS_BLOCK_SAMPLES.
__global__ void __launch_bounds__(DAS_THREADS)
    das_kernel(const unsigned char* chunks, const unsigned char* sibs,
               const unsigned char* bits, const unsigned char* levels,
               const unsigned char* roots, const unsigned char* valid, int n,
               int per_block, unsigned char* out) {
  __shared__ u64 nodes[DAS_BLOCK_SAMPLES][DAS_PAIRS][4];
  __shared__ int rows[DAS_BLOCK_SAMPLES];
  __shared__ int listed;
  const int first = blockIdx.x * per_block;
  if (threadIdx.x == 0) {
    int k = 0;
    for (int s = 0; s < per_block && first + s < n; ++s) {
      if (valid[first + s])
        rows[k++] = first + s;
      else
        out[first + s] = 0;
    }
    listed = k;
  }
  __syncthreads();
  const int k = listed;
  if (k == 0) return;

  // 1. leaf pairs: two segments' keccaks, then their pair
  for (int it = threadIdx.x; it < k * DAS_PAIRS; it += blockDim.x) {
    const int s = it / DAS_PAIRS, i = it % DAS_PAIRS;
    const u64* seg = reinterpret_cast<const u64*>(
                         chunks + (long long)rows[s] * DAS_CHUNK) + 8 * i;
    u64 left[4], h[4];
#pragma unroll 1
    for (int step = 0; step < 3; ++step) {
      u64 m[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m[j] = step == 2 ? left[j] : seg[4 * step + j];
        m[4 + j] = step == 2 ? h[j] : 0ull;
      }
      keccak_msg(m, step == 2 ? 8 : 4, h);
      if (step == 0) load4(left, h);
    }
    load4(nodes[s][i], h);
  }

  // 2. the pair levels, in place: slot 2is takes (2is, (2i + 1)s)
  for (int level = 0; level < DAS_PAIR_LEVELS; ++level) {
    __syncthreads();
    const int shift = 5 - level, stride = 1 << level;   // 32 items down to 2
    for (int it = threadIdx.x; it < k << shift; it += blockDim.x) {
      const int s = it >> shift, at = (it & ((1 << shift) - 1)) * 2 * stride;
      u64 m[8], h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m[j] = nodes[s][at][j];
        m[4 + j] = nodes[s][at + stride][j];
      }
      keccak_msg(m, 8, h);
      load4(nodes[s][at], h);
    }
  }
  __syncthreads();

  // 3. the tail: the BMT root, the netstore key, the path fold, the verdict
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    const long long row = rows[s];
    u64 node[4];
#pragma unroll 1
    for (int step = 0; step < 2 + DAS_DEPTH; ++step) {
      u64 m[8];
      int words = 8;
      if (step == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = nodes[s][0][j];
          m[4 + j] = nodes[s][DAS_PAIRS / 2][j];
        }
      } else if (step == 1) {
        m[0] = DAS_SPAN;
#pragma unroll
        for (int j = 0; j < 4; ++j) m[1 + j] = node[j];
        m[5] = m[6] = m[7] = 0;
        words = 5;
      } else {
        const long long at = row * DAS_DEPTH + (step - 2);
        if (!levels[at]) continue;
        const u64* sib = reinterpret_cast<const u64*>(sibs + at * 32);
        const bool right = bits[at] != 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const u64 sj = sib[j];
          m[j] = right ? sj : node[j];
          m[4 + j] = right ? node[j] : sj;
        }
      }
      keccak_msg(m, words, node);
    }
    const u64* root = reinterpret_cast<const u64*>(roots + row * 32);
    u64 diff = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) diff |= node[j] ^ root[j];
    out[row] = diff == 0;
  }
}

}  // namespace gs

#ifdef __CUDACC__
// the planes of das/proofs.py `marshal_samples` for n samples, each
// 8-byte aligned; out (n,) bool. Returns the first CUDA error of the
// launch, 0 if none.
extern "C" int gs_das_samples(const unsigned char* chunks,
                              const unsigned char* sibs,
                              const unsigned char* bits,
                              const unsigned char* levels,
                              const unsigned char* roots,
                              const unsigned char* valid, int n,
                              unsigned char* out, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int per_block = gs::das_block_rows(n, sms);
  gs::das_kernel<<<(n + per_block - 1) / per_block, gs::DAS_THREADS, 0,
                   stream>>>(chunks, sibs, bits, levels, roots, valid, n,
                             per_block, out);
  return (int)cudaGetLastError();
}
#endif
