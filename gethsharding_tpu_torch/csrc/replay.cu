// Collation replay: every shard's transactions applied in order to its
// account table, one block a shard, one launch.
//
// Replaces no Pallas kernel: it is the in-order transition `_shard_replay`
// of gethsharding_tpu/ops/replay_jax.py (:140), a `lax.scan` over the
// transactions `vmap`'d over the shards there (XLA), whose plain PyTorch
// twin is ops/replay.py `shard_replay_plain`. Per transaction: the first
// table row whose address is the sender and the first that is the
// recipient, then geth's checks in TransitionDb order (nonce equality,
// buy gas: balance >= price × gas limit with an overflowing cost above
// every balance, intrinsic gas <= gas limit, post-buy balance >= value),
// and, where all hold, the nonce bump and the three balance updates mod
// 2^256 (sender - (fee + value), recipient + value, coinbase + fee, fee =
// price × intrinsic gas). Updates mod 2^256 commute, so applying them one
// after another on the same row nets out exactly as the reference's summed
// delta carried once.
//
// What bounds it on this card: bytes, ~0.3 µs at 4,096 rows (the tables in
// and out and the transaction planes once), against a chain of dependent
// transactions. The design is the simple one:
//
//   1. the block copies its table to the outputs, each balance row
//      canonical mod 2^256 (the reference carries the whole table at every
//      step), and sets each transaction's two row slots to A (no row);
//   2. the block's threads scan the address rows, a thread holding a row's
//      five words against every transaction's sender and recipient, and
//      keep the first match with atomicMin;
//   3. one thread applies the transactions in order: uint256 values in
//      8 × 32-bit words with 64-bit carries, written back as canonical
//      8-bit limbs.
//
// The table stays in device memory (the outputs): any A up to
// REPLAY_MAX_ROWS runs. No item of a phase reads what another item of
// that phase writes but through atomicMin, so one thread running the block
// in order (the host shim of the tests) is a legal schedule.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int REPLAY_THREADS = 256;          // threads a block (a shard)
// table rows a shard: row indices, A itself ("no row") and the row
// loops' strides stay inside an int
constexpr int REPLAY_MAX_ROWS = 1 << 30;
constexpr int U256_LIMBS = 32;               // 8-bit limbs of a uint256
constexpr int U256_WORDS = 8;

// 32 little-endian 8-bit limbs (int32, any sign) -> their value mod 2^256
// as 8 little-endian 32-bit words
__device__ __forceinline__ void load_u256(const int* limbs,
                                          u32 (&w)[U256_WORDS]) {
  long long carry = 0;
#pragma unroll
  for (int j = 0; j < U256_WORDS; ++j) {
    long long acc = carry;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += (long long)limbs[4 * j + k] << (8 * k);
    w[j] = (u32)acc;
    carry = acc >> 32;   // arithmetic: a borrow carries as -1
  }
}

__device__ __forceinline__ void store_u256(int* limbs,
                                           const u32 (&w)[U256_WORDS]) {
#pragma unroll
  for (int j = 0; j < U256_WORDS; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) limbs[4 * j + k] = (w[j] >> (8 * k)) & 0xFF;
}

__device__ __forceinline__ bool u256_ge(const u32 (&x)[U256_WORDS],
                                        const u32 (&y)[U256_WORDS]) {
#pragma unroll
  for (int j = U256_WORDS - 1; j >= 0; --j)
    if (x[j] != y[j]) return x[j] > y[j];
  return true;
}

// d = x + y (sign +1) or x - y (sign -1), mod 2^256
__device__ __forceinline__ void u256_addsub(const u32 (&x)[U256_WORDS],
                                            const u32 (&y)[U256_WORDS],
                                            bool sub, u32 (&d)[U256_WORDS]) {
  long long carry = 0;
#pragma unroll
  for (int j = 0; j < U256_WORDS; ++j) {
    const long long t = (long long)x[j] + (sub ? -(long long)y[j]
                                               : (long long)y[j]) + carry;
    d[j] = (u32)t;
    carry = t >> 32;
  }
}

// d = x · k mod 2^256; returns whether the product reached 2^256. k is
// taken as the reference's u256_mul_u32 takes it: its low 31 bits.
__device__ __forceinline__ bool u256_mul_u32(const u32 (&x)[U256_WORDS],
                                             int k, u32 (&d)[U256_WORDS]) {
  const u64 kk = (u32)k & 0x7FFFFFFFu;
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < U256_WORDS; ++j) {
    const u64 t = (u64)x[j] * kk + carry;
    d[j] = (u32)t;
    carry = t >> 32;
  }
  return carry != 0;
}

__device__ __forceinline__ void addr_words(const unsigned char* a,
                                           u32 (&w)[5]) {
  const u32* p = reinterpret_cast<const u32*>(a);
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = p[i];
}

__device__ __forceinline__ bool addr_eq(const u32 (&w)[5],
                                        const unsigned char* a) {
  const u32* p = reinterpret_cast<const u32*>(a);
  return w[0] == p[0] && w[1] == p[1] && w[2] == p[2] && w[3] == p[3] &&
         w[4] == p[4];
}

// row += delta (or -= delta) mod 2^256, in place on its canonical limbs
__device__ __forceinline__ void row_update(int* row,
                                           const u32 (&delta)[U256_WORDS],
                                           bool sub) {
  u32 w[U256_WORDS], d[U256_WORDS];
  load_u256(row, w);
  u256_addsub(w, delta, sub, d);
  store_u256(row, d);
}

// Tables: addrs (S, A, 20) bytes, 4-byte aligned; nonces (S, A);
// balances (S, A, 32) limbs; coinbase (S,). Transactions: senders (S, T,
// 20) bytes; sender_ok (S, T) bool; nonce, gas_limit, intrinsic (S, T);
// price, value (S, T, 32) limbs; to (S, T, 20) bytes; valid (S, T) bool.
// Outputs: status (S, T) bool, gas_used (S, T), nonces_out (S, A),
// balances_out (S, A, 32); rows (S, T, 2) is scratch.
__global__ void __launch_bounds__(REPLAY_THREADS)
    replay_kernel(const unsigned char* addrs, const int* nonces,
                  const int* balances, const int* coinbase,
                  const unsigned char* senders, const unsigned char* sender_ok,
                  const int* tx_nonce, const int* tx_gas_limit,
                  const int* tx_intrinsic, const int* tx_price,
                  const int* tx_value, const unsigned char* tx_to,
                  const unsigned char* tx_valid, int T, int A,
                  unsigned char* status, int* gas_used, int* nonces_out,
                  int* balances_out, int* rows) {
  const long long s = blockIdx.x;
  const long long tab = s * A, txs = s * T;

  // 1. the table into the outputs, the row slots to "none"
  for (int r = threadIdx.x; r < A; r += blockDim.x) {
    nonces_out[tab + r] = nonces[tab + r];
    const int* src = balances + (tab + r) * U256_LIMBS;
    int* dst = balances_out + (tab + r) * U256_LIMBS;
    if (T > 0) {
      u32 w[U256_WORDS];
      load_u256(src, w);
      store_u256(dst, w);
    } else {
      for (int k = 0; k < U256_LIMBS; ++k) dst[k] = src[k];
    }
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    rows[2 * (txs + t)] = A;
    rows[2 * (txs + t) + 1] = A;
  }
  __syncthreads();

  // 2. each transaction's first sender row and first recipient row
  for (int r = threadIdx.x; r < A; r += blockDim.x) {
    u32 w[5];
    addr_words(addrs + (tab + r) * 20, w);
    for (int t = 0; t < T; ++t) {
      if (addr_eq(w, senders + (txs + t) * 20))
        atomicMin(&rows[2 * (txs + t)], r);
      if (addr_eq(w, tx_to + (txs + t) * 20))
        atomicMin(&rows[2 * (txs + t) + 1], r);
    }
  }
  __syncthreads();

  // 3. the transactions in order, on one thread
  if (threadIdx.x != 0) return;
  int cb = coinbase[s];
  if (cb < 0) cb += A;     // a negative index counts from the end
  const bool cb_in = cb >= 0 && cb < A;
  for (int t = 0; t < T; ++t) {
    const long long x = txs + t;
    const int si = rows[2 * x], ti = rows[2 * x + 1];
    bool ok = tx_valid[x] && sender_ok[x] && si < A && ti < A;
    u32 bal[U256_WORDS], price[U256_WORDS], value[U256_WORDS];
    u32 cost[U256_WORDS], post[U256_WORDS], fee[U256_WORDS];
    int* srow = balances_out + (tab + (si < A ? si : 0)) * U256_LIMBS;
    load_u256(srow, bal);
    load_u256(tx_price + x * U256_LIMBS, price);
    load_u256(tx_value + x * U256_LIMBS, value);
    ok = ok && nonces_out[tab + (si < A ? si : 0)] == tx_nonce[x];
    const bool over = u256_mul_u32(price, tx_gas_limit[x], cost);
    ok = ok && !over && u256_ge(bal, cost);
    ok = ok && tx_intrinsic[x] <= tx_gas_limit[x];
    u256_addsub(bal, cost, true, post);
    ok = ok && u256_ge(post, value);
    u256_mul_u32(price, tx_intrinsic[x], fee);
    status[x] = ok;
    gas_used[x] = ok ? tx_intrinsic[x] : 0;
    if (!ok) continue;
    u32 debit[U256_WORDS];
    u256_addsub(fee, value, false, debit);
    row_update(srow, debit, true);
    row_update(balances_out + (tab + ti) * U256_LIMBS, value, false);
    if (cb_in) row_update(balances_out + (tab + cb) * U256_LIMBS, fee, false);
    nonces_out[tab + si] = (int)((u32)nonces_out[tab + si] + 1u);
  }
}

}  // namespace gs

#ifdef __CUDACC__
// S shards of T transactions over tables of A rows (see replay_kernel);
// rows (S, T, 2) int32 scratch. Returns the first CUDA error of the
// launch, 0 if none.
extern "C" int gs_replay(const unsigned char* addrs, const int* nonces,
                         const int* balances, const int* coinbase,
                         const unsigned char* senders,
                         const unsigned char* sender_ok, const int* tx_nonce,
                         const int* tx_gas_limit, const int* tx_intrinsic,
                         const int* tx_price, const int* tx_value,
                         const unsigned char* tx_to,
                         const unsigned char* tx_valid, int S, int T, int A,
                         unsigned char* status, int* gas_used,
                         int* nonces_out, int* balances_out, int* rows,
                         cudaStream_t stream) {
  if (S < 0 || T < 0 || A < 1 || A > gs::REPLAY_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  gs::replay_kernel<<<S, gs::REPLAY_THREADS, 0, stream>>>(
      addrs, nonces, balances, coinbase, senders, sender_ok, tx_nonce,
      tx_gas_limit, tx_intrinsic, tx_price, tx_value, tx_to, tx_valid, T, A,
      status, gas_used, nonces_out, balances_out, rows);
  return (int)cudaGetLastError();
}
#endif
