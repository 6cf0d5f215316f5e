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
// What bounds it on this card: the permutations' 32-bit logical operations
// (keccak.cuh: 4,320 a permutation). The design is the simple one: a thread
// a message, its sponge in registers (`keccak_f1600` of keccak.cuh), full
// blocks absorbed as 8-byte lanes where the message is 8-byte aligned and
// byte by byte otherwise, the last block padded by selects (Ethereum's
// 0x01 ... 0x80), so every lane index is static. A long message is one
// thread's chain of permutations: its time is the sponge's latency, not the
// card's rate.

#include "keccak.cuh"

namespace gs {

constexpr int KF_THREADS = 128;       // threads a block, a message each
constexpr int KF_ROUND_UNROLL = 2;    // keccak rounds a trip of the loop
constexpr int KF_RATE = 136;          // bytes a block absorbs
constexpr int KF_RATE_LANES = KF_RATE / 8;

__device__ __forceinline__ u64 load_lane_bytes(const unsigned char* p) {
  u64 w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) w |= (u64)p[j] << (8 * j);
  return w;
}

// data (n, len) bytes, row-major; out (n, 32) bytes
__global__ void __launch_bounds__(KF_THREADS)
    keccak_fixed_kernel(const unsigned char* data, long long n,
                        long long len, unsigned char* out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const unsigned char* m = data + row * len;
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
  unsigned char* o = out + row * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[8 * i + j] = (unsigned char)(a[i] >> (8 * j));
}

}  // namespace gs

#ifdef __CUDACC__
// n messages of len bytes each at data, digests into out (n, 32). Returns
// the first CUDA error of the launch, 0 if none.
extern "C" int gs_keccak_fixed(const unsigned char* data, long long n,
                               long long len, unsigned char* out,
                               cudaStream_t stream) {
  if (n < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + gs::KF_THREADS - 1) / gs::KF_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gs::keccak_fixed_kernel<<<(unsigned)blocks, gs::KF_THREADS, 0, stream>>>(
      data, n, len, out);
  return (int)cudaGetLastError();
}
#endif
