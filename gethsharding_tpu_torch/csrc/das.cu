// DAS sample verification, one 128-thread block per sample.
//
// Computes what the batched sample verifier `_build_batch_fn` of
// gethsharding_tpu/das/proofs.py (:188, an XLA computation over
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
// ~4.4 KB of input.
//
// The design: the simplest that is right. Each thread keeps one sponge's
// 25 lanes in registers: thread i hashes segment i into shared memory,
// then each of the 7 levels halves the threads that hash, with a barrier
// between levels and two node buffers in turn, so no level writes what
// it reads. One thread derives the key and folds the path. Every phase
// is a block-stride loop that no item of the same phase reads back, so
// one thread running the block (the host shim of the tests) is a legal
// schedule. The levels above the leaves leave most of the block idle, and
// the key and the fold (9 permutations) run on one thread; a block per
// sample keeps 1,600 samples in one wave on 132 SMs.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

typedef unsigned long long u64;

constexpr int DAS_THREADS = 128;   // one per 32-byte segment
constexpr int DAS_SEGMENTS = 128;
constexpr int DAS_DEPTH = 8;       // proof levels
constexpr int DAS_CHUNK = 4096;
constexpr u64 DAS_SPAN = 4096;     // the chunk's span, little-endian u64

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

// one rho-pi step: lane J takes the carried lane rotated by S
#define GS_RHO_PI(J, S) \
  {                     \
    const u64 next = a[J]; \
    a[J] = rotl<S>(carry); \
    carry = next;       \
  }

__device__ __forceinline__ void keccak_f1600(u64* a) {
  for (int round = 0; round < 24; ++round) {
    u64 c[5], d[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
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

// keccak-256 of `words` little-endian 64-bit words (a message of at most
// 16 words, one block) into out[0..3]
__device__ __forceinline__ void keccak_words(const u64* msg, int words,
                                             u64* out) {
  u64 a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  for (int i = 0; i < words; ++i) a[i] = msg[i];
  a[words] ^= 0x01ull;
  a[16] ^= 0x8000000000000000ull;
  keccak_f1600(a);
  for (int i = 0; i < 4; ++i) out[i] = a[i];
}

// chunks (n, 4096), sibs (n, 8, 32), roots (n, 32): bytes; bits, levels
// (n, 8), valid (n,), out (n,): 0/1 bytes. Block b verifies sample b.
__global__ void __launch_bounds__(DAS_THREADS)
    das_kernel(const unsigned char* chunks, const unsigned char* sibs,
               const unsigned char* bits, const unsigned char* levels,
               const unsigned char* roots, const unsigned char* valid,
               unsigned char* out) {
  __shared__ u64 nodes[2][DAS_SEGMENTS][4];
  const long long row = blockIdx.x;
  const u64* chunk =
      reinterpret_cast<const u64*>(chunks + row * DAS_CHUNK);
  for (int i = threadIdx.x; i < DAS_SEGMENTS; i += blockDim.x)
    keccak_words(chunk + 4 * i, 4, nodes[0][i]);
  __syncthreads();
  int src = 0;
  for (int width = DAS_SEGMENTS / 2; width >= 1; width /= 2) {
    for (int i = threadIdx.x; i < width; i += blockDim.x)
      keccak_words(nodes[src][2 * i], 8, nodes[src ^ 1][i]);
    __syncthreads();
    src ^= 1;
  }
  if (threadIdx.x != 0) return;
  u64 msg[8], node[4];
  msg[0] = DAS_SPAN;
  for (int j = 0; j < 4; ++j) msg[1 + j] = nodes[src][0][j];
  keccak_words(msg, 5, node);
  for (int level = 0; level < DAS_DEPTH; ++level) {
    const long long at = row * DAS_DEPTH + level;
    if (!levels[at]) continue;
    const u64* sib = reinterpret_cast<const u64*>(sibs + at * 32);
    const int right = bits[at] != 0;
    for (int j = 0; j < 4; ++j) {
      msg[j + 4 * right] = node[j];
      msg[j + 4 * (1 - right)] = sib[j];
    }
    keccak_words(msg, 8, node);
  }
  const u64* root = reinterpret_cast<const u64*>(roots + row * 32);
  u64 diff = 0;
  for (int j = 0; j < 4; ++j) diff |= node[j] ^ root[j];
  out[row] = (valid[row] != 0) && diff == 0;
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
  gs::das_kernel<<<n, gs::DAS_THREADS, 0, stream>>>(chunks, sibs, bits,
                                                    levels, roots, valid,
                                                    out);
  return (int)cudaGetLastError();
}
#endif
