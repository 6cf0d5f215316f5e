// Collation replay: every shard's transactions applied in order to its
// account table, one launch.
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
// What bounds it on this card: bytes (the tables in and out and the
// transaction planes once), against the chain of dependent transactions:
// each reads the rows the one before may have written (chip_smoke.py
// step 12 holds it against that chain bound). The design keeps the chain
// on shared memory and registers, and spreads the rest:
//
//   1. a shard's table is split over G blocks (ops/replay.py
//      `split_blocks`: several where the shards are fewer than the SMs);
//      each copies its rows to the outputs, each balance canonical mod
//      2^256 (the reference carries the whole table at every step);
//   2. a tile of REPLAY_TILE transactions at a time: their sender and
//      recipient words staged in shared memory, the block's rows too, a
//      chunk of REPLAY_ROW_CHUNK at a time; an item a (transaction, side,
//      slice of the chunk) keeps the first row of its slice that matches
//      with no branch, then one shared atomicMin (so no thread waits on a
//      run of atomics where one row matches many transactions). With one
//      block a shard the tile's chain (3.) follows at once; with several,
//      each writes the tile's first rows to its part of `part`;
//   3. the blocks of a shard meet through a counter (`atomicAdd` after
//      `__threadfence`, as agg.cu's split rows do) and the last to finish
//      runs the chain, a tile at a time: each transaction's products and
//      row-free checks in parallel, the rows the tile touches (senders,
//      recipients, the coinbase) gathered into shared slots as 8 × 32-bit
//      words, one slot a row (the first reference to it), one thread's
//      checks and updates in turn on the slots with carry chains, and the
//      slots written back as canonical 8-bit limbs.
//
// Any A up to REPLAY_MAX_ROWS and any T runs. No item of a phase reads
// what another item of that phase writes but through atomicMin, and the
// blocks of a shard meet only through the counter, so one thread running
// the blocks in order (the host shim of the tests) is a legal schedule.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int REPLAY_THREADS = 256;          // threads a block
// table rows a shard: row indices, A itself ("no row") and the row
// loops' strides stay inside an int
constexpr int REPLAY_MAX_ROWS = 1 << 30;
constexpr int REPLAY_TILE = 64;              // transactions a tile
constexpr int REPLAY_ROW_CHUNK = 256;        // table rows a scan chunk
// the rows a tile names: a sender and a recipient a transaction, and the
// coinbase (after them)
constexpr int REPLAY_REFS = 2 * REPLAY_TILE + 1;
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

// d = x - y mod 2^256 (d may be x or y); returns 1 where x < y, the
// borrow out. One carry chain on the card.
__device__ __forceinline__ u32 u256_sub(const u32 (&x)[U256_WORDS],
                                        const u32 (&y)[U256_WORDS],
                                        u32 (&d)[U256_WORDS]) {
#ifdef __CUDA_ARCH__
  u32 borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(borrow)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]),
        "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]));
  return borrow & 1;
#else
  long long carry = 0;
  for (int j = 0; j < U256_WORDS; ++j) {
    const long long t = (long long)x[j] - (long long)y[j] + carry;
    d[j] = (u32)t;
    carry = t >> 32;
  }
  return carry != 0;
#endif
}

// d = x + y mod 2^256 (d may be x or y)
__device__ __forceinline__ void u256_add(const u32 (&x)[U256_WORDS],
                                         const u32 (&y)[U256_WORDS],
                                         u32 (&d)[U256_WORDS]) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]),
        "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]));
#else
  unsigned long long carry = 0;
  for (int j = 0; j < U256_WORDS; ++j) {
    const unsigned long long t = (unsigned long long)x[j] + y[j] + carry;
    d[j] = (u32)t;
    carry = t >> 32;
  }
#endif
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

// 8 words in shared memory, as two 16-byte accesses
__device__ __forceinline__ void ld8(const uint4* p, u32 (&w)[U256_WORDS]) {
  const uint4 a = p[0], b = p[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void st8(uint4* p, const u32 (&w)[U256_WORDS]) {
  p[0] = uint4{w[0], w[1], w[2], w[3]};
  p[1] = uint4{w[4], w[5], w[6], w[7]};
}

// What a block keeps in shared memory: a tile of transactions (their
// address words for the scan, their first rows, their products and
// checks) and the rows the tile touches, one slot a row.
struct __align__(16) ReplayShared {
  uint4 cost[REPLAY_TILE][2];      // price × gas limit
  uint4 value[REPLAY_TILE][2];
  uint4 debit[REPLAY_TILE][2];     // fee + value
  uint4 fee[REPLAY_TILE][2];       // price × intrinsic gas
  uint4 bal[REPLAY_REFS][2];       // the slots' balances
  u32 words[10][REPLAY_TILE];      // sender words 0-4, recipient 5-9
  uint4 row_head[REPLAY_ROW_CHUNK];  // a chunk of the block's address
  u32 row_tail[REPLAY_ROW_CHUNK];    // rows: words 0-3, word 4
  int first[2][REPLAY_TILE];       // the first sender / recipient row
  int nonce[REPLAY_REFS];          // the slots' nonces
  int row[REPLAY_REFS];            // the row of each reference, or -1
  int slot[REPLAY_REFS];           // the slot of each reference
  int tx_nonce[REPLAY_TILE];
  int gas[REPLAY_TILE];            // intrinsic gas, used where applied
  int live[REPLAY_TILE];           // the checks that need no row held
  int last;                        // this block runs the chain
};

// The planes of transaction x into tile slot t: the two products, the
// debit, and the checks that need no table row.
__device__ __forceinline__ void tile_transaction(
    ReplayShared& sm, int t, long long x, const unsigned char* sender_ok,
    const int* tx_nonce, const int* tx_gas_limit, const int* tx_intrinsic,
    const int* tx_price, const int* tx_value, const unsigned char* tx_valid) {
  u32 price[U256_WORDS], value[U256_WORDS], cost[U256_WORDS],
      fee[U256_WORDS], debit[U256_WORDS];
  load_u256(tx_price + x * U256_LIMBS, price);
  load_u256(tx_value + x * U256_LIMBS, value);
  const int limit = tx_gas_limit[x], intrinsic = tx_intrinsic[x];
  const bool over = u256_mul_u32(price, limit, cost);
  u256_mul_u32(price, intrinsic, fee);
  u256_add(fee, value, debit);
  st8(sm.cost[t], cost);
  st8(sm.value[t], value);
  st8(sm.debit[t], debit);
  st8(sm.fee[t], fee);
  sm.tx_nonce[t] = tx_nonce[x];
  sm.gas[t] = intrinsic;
  sm.live[t] = tx_valid[x] && sender_ok[x] && !over && intrinsic <= limit;
}

// The tile's n transactions (first rows and planes in `sm`) applied in
// order: the rows they touch into slots, one thread's chain, the slots
// back as canonical limbs. Every thread of the block calls it.
__device__ __forceinline__ void chain_tile(ReplayShared& sm, int n, int A,
                                           int cb, long long tab,
                                           long long x0,
                                           unsigned char* status,
                                           int* gas_used, int* nonces_out,
                                           int* balances_out) {
  const int refs = 2 * n + 1;      // the coinbase last
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int si = sm.first[0][t], ti = sm.first[1][t];
    const bool live = sm.live[t] && si < A && ti < A;
    sm.live[t] = live;
    sm.row[2 * t] = live ? si : -1;
    sm.row[2 * t + 1] = live ? ti : -1;
  }
  if (threadIdx.x == 0) sm.row[2 * n] = cb;
  __syncthreads();
  // one slot a row: the first reference to it
  for (int j = threadIdx.x; j < refs; j += blockDim.x) {
    const int r = sm.row[j];
    int slot = j;
    if (r >= 0)
      for (int i = 0; i < j; ++i)
        if (sm.row[i] == r) {
          slot = i;
          break;
        }
    sm.slot[j] = slot;
  }
  __syncthreads();
  // the slots' rows, canonical since phase 1 or an earlier tile
  for (int e = threadIdx.x; e < refs * U256_WORDS; e += blockDim.x) {
    const int j = e / U256_WORDS, w = e % U256_WORDS;
    const int r = sm.row[j];
    if (r < 0 || sm.slot[j] != j) continue;
    const int* src = balances_out + (tab + r) * U256_LIMBS + 4 * w;
    reinterpret_cast<u32*>(sm.bal[j])[w] =
        (u32)__ldcg(src) | (u32)__ldcg(src + 1) << 8 |
        (u32)__ldcg(src + 2) << 16 | (u32)__ldcg(src + 3) << 24;
    if (w == 0) sm.nonce[j] = __ldcg(nonces_out + tab + r);
  }
  __syncthreads();
  // the transactions in order, on one thread
  if (threadIdx.x == 0) {
    const int c = sm.slot[2 * n];
    for (int t = 0; t < n; ++t) {
      const int si = sm.slot[2 * t], ti = sm.slot[2 * t + 1];
      u32 bs[U256_WORDS], cost[U256_WORDS], value[U256_WORDS],
          debit[U256_WORDS], post[U256_WORDS], rest[U256_WORDS];
      ld8(sm.bal[si], bs);
      ld8(sm.cost[t], cost);
      ld8(sm.value[t], value);
      ld8(sm.debit[t], debit);
      const u32 short_cost = u256_sub(bs, cost, post);
      const u32 short_value = u256_sub(post, value, rest);
      const bool ok = sm.live[t] && sm.nonce[si] == sm.tx_nonce[t] &&
                      !(short_cost | short_value);
      status[x0 + t] = ok;
      gas_used[x0 + t] = ok ? sm.gas[t] : 0;
      if (!ok) continue;
      u32 br[U256_WORDS];
      u256_sub(bs, debit, bs);
      if (ti == si) {
#pragma unroll
        for (int k = 0; k < U256_WORDS; ++k) br[k] = bs[k];
      } else {
        ld8(sm.bal[ti], br);
      }
      u256_add(br, value, br);
      st8(sm.bal[si], bs);
      st8(sm.bal[ti], br);
      if (sm.row[2 * n] >= 0) {   // the coinbase, after both
        u32 bc[U256_WORDS], fee[U256_WORDS];
        ld8(sm.bal[c], bc);
        ld8(sm.fee[t], fee);
        u256_add(bc, fee, bc);
        st8(sm.bal[c], bc);
      }
      sm.nonce[si] = (int)((u32)sm.nonce[si] + 1u);
    }
  }
  __syncthreads();
  // the slots back as canonical limbs
  for (int e = threadIdx.x; e < refs * U256_WORDS; e += blockDim.x) {
    const int j = e / U256_WORDS, w = e % U256_WORDS;
    const int r = sm.row[j];
    if (r < 0 || sm.slot[j] != j) continue;
    const u32 v = reinterpret_cast<const u32*>(sm.bal[j])[w];
    int* dst = balances_out + (tab + r) * U256_LIMBS + 4 * w;
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = (v >> (8 * k)) & 0xFF;
    if (w == 0) nonces_out[tab + r] = sm.nonce[j];
  }
  __syncthreads();
}

// Tables: addrs (S, A, 20) bytes, 4-byte aligned; nonces (S, A);
// balances (S, A, 32) limbs; coinbase (S,). Transactions: senders (S, T,
// 20) bytes; sender_ok (S, T) bool; nonce, gas_limit, intrinsic (S, T);
// price, value (S, T, 32) limbs; to (S, T, 20) bytes; valid (S, T) bool.
// Outputs: status (S, T) bool, gas_used (S, T), nonces_out (S, A),
// balances_out (S, A, 32). Where G > 1, scratch: part (S, G, T, 2), the
// first matches each block found, and counter (S,), zero. Block s·G + g
// holds rows [g·chunk, (g + 1)·chunk) of shard s; one block a shard runs
// each tile's chain right after its scan.
__global__ void __launch_bounds__(REPLAY_THREADS)
    replay_kernel(const unsigned char* addrs, const int* nonces,
                  const int* balances, const int* coinbase,
                  const unsigned char* senders, const unsigned char* sender_ok,
                  const int* tx_nonce, const int* tx_gas_limit,
                  const int* tx_intrinsic, const int* tx_price,
                  const int* tx_value, const unsigned char* tx_to,
                  const unsigned char* tx_valid, int T, int A, int G,
                  unsigned char* status, int* gas_used, int* nonces_out,
                  int* balances_out, int* part, int* counter) {
  __shared__ ReplayShared sm;
  const long long s = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const long long tab = s * A, txs = s * T;
  const int chunk = (int)((A + (long long)G - 1) / G);
  const int r0 = (int)((long long)g * chunk < A ? (long long)g * chunk : A);
  const int r1 = A - r0 < chunk ? A : r0 + chunk;
  int cb = coinbase[s];
  if (cb < 0) cb += A;     // a negative index counts from the end
  if (cb < 0 || cb >= A) cb = -1;

  // 1. this block's rows into the outputs, a row's limbs as 16-byte
  // accesses where both tables are 16-byte aligned
  const bool wide = ((reinterpret_cast<unsigned long long>(balances) |
                      reinterpret_cast<unsigned long long>(balances_out)) &
                     15) == 0;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    nonces_out[tab + r] = nonces[tab + r];
    const int* src = balances + (tab + r) * U256_LIMBS;
    int* dst = balances_out + (tab + r) * U256_LIMBS;
    int limbs[U256_LIMBS];
    if (wide) {
#pragma unroll
      for (int k = 0; k < U256_LIMBS; k += 4)
        *reinterpret_cast<int4*>(limbs + k) =
            *reinterpret_cast<const int4*>(src + k);
    } else {
#pragma unroll
      for (int k = 0; k < U256_LIMBS; ++k) limbs[k] = src[k];
    }
    if (T > 0) {
      u32 w[U256_WORDS];
      load_u256(limbs, w);
      store_u256(limbs, w);
    }
    if (wide) {
#pragma unroll
      for (int k = 0; k < U256_LIMBS; k += 4)
        *reinterpret_cast<int4*>(dst + k) =
            *reinterpret_cast<const int4*>(limbs + k);
    } else {
#pragma unroll
      for (int k = 0; k < U256_LIMBS; ++k) dst[k] = limbs[k];
    }
  }
  if (T == 0) return;

  // 2. each transaction's first sender and recipient row among this
  // block's rows, a tile at a time (one block a shard: its chain too)
  for (int t0 = 0; t0 < T; t0 += REPLAY_TILE) {
    const int n = T - t0 < REPLAY_TILE ? T - t0 : REPLAY_TILE;
    for (int e = threadIdx.x; e < 10 * n; e += blockDim.x) {
      const int t = e % n, w = e / n;
      const unsigned char* a = (w < 5 ? senders : tx_to) + (txs + t0 + t) * 20;
      sm.words[w][t] = reinterpret_cast<const u32*>(a)[w % 5];
    }
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      sm.first[0][t] = sm.first[1][t] = A;
      if (G == 1)
        tile_transaction(sm, t, txs + t0 + t, sender_ok, tx_nonce,
                         tx_gas_limit, tx_intrinsic, tx_price, tx_value,
                         tx_valid);
    }
    // the block's rows a chunk at a time in shared memory; an item a
    // (transaction, side, slice of the chunk) keeps the first row of its
    // slice that matches, then one atomicMin
    const int pairs = 2 * n;
    const int slices = blockDim.x > pairs ? blockDim.x / pairs : 1;
    for (int c0 = r0; c0 < r1; c0 += REPLAY_ROW_CHUNK) {
      const int rows =
          r1 - c0 < REPLAY_ROW_CHUNK ? r1 - c0 : REPLAY_ROW_CHUNK;
      __syncthreads();
      for (int e = threadIdx.x; e < 5 * rows; e += blockDim.x) {
        const int r = e / 5, w = e % 5;
        const u32 v = reinterpret_cast<const u32*>(
            addrs + (tab + c0 + r) * 20)[w];
        if (w < 4)
          reinterpret_cast<u32*>(&sm.row_head[r])[w] = v;
        else
          sm.row_tail[r] = v;
      }
      __syncthreads();
      const int per = (rows + slices - 1) / slices;
      for (int e = threadIdx.x; e < pairs * slices; e += blockDim.x) {
        const int t = (e % pairs) >> 1, side = e & 1, sl = e / pairs;
        const u32* w = &sm.words[5 * side][t];
        const u32 w0 = w[0], w1 = w[REPLAY_TILE], w2 = w[2 * REPLAY_TILE],
                  w3 = w[3 * REPLAY_TILE], w4 = w[4 * REPLAY_TILE];
        const int a = sl * per, b = rows - a < per ? rows : a + per;
        int found = REPLAY_ROW_CHUNK;
        for (int r = b - 1; r >= a; --r) {   // no branch: lanes differ
          const uint4 h = sm.row_head[r];
          const u32 diff = (h.x ^ w0) | (h.y ^ w1) | (h.z ^ w2) |
                           (h.w ^ w3) | (sm.row_tail[r] ^ w4);
          found = diff ? found : r;
        }
        if (found < REPLAY_ROW_CHUNK)
          atomicMin(&sm.first[side][t], c0 + found);
      }
    }
    __syncthreads();
    if (G == 1) {
      chain_tile(sm, n, A, cb, tab, txs + t0, status, gas_used, nonces_out,
                 balances_out);
      continue;
    }
    int* my_part = part + ((s * G + g) * T + t0) * 2;
    for (int e = threadIdx.x; e < 2 * n; e += blockDim.x)
      my_part[e] = sm.first[e % 2][e / 2];
    __syncthreads();
  }
  if (G == 1) return;

  // 3. the shard's last block to finish runs the chain
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm.last = atomicAdd(counter + s, 1) == G - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const int* shard_part = part + s * G * (long long)T * 2;
  for (int t0 = 0; t0 < T; t0 += REPLAY_TILE) {
    const int n = T - t0 < REPLAY_TILE ? T - t0 : REPLAY_TILE;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      int si = A, ti = A;
      for (int h = 0; h < G; ++h) {
        const int* q = shard_part + ((long long)h * T + t0 + t) * 2;
        const int a = __ldcg(q), b = __ldcg(q + 1);
        si = a < si ? a : si;
        ti = b < ti ? b : ti;
      }
      sm.first[0][t] = si;
      sm.first[1][t] = ti;
      tile_transaction(sm, t, txs + t0 + t, sender_ok, tx_nonce,
                       tx_gas_limit, tx_intrinsic, tx_price, tx_value,
                       tx_valid);
    }
    __syncthreads();
    chain_tile(sm, n, A, cb, tab, txs + t0, status, gas_used, nonces_out,
               balances_out);
  }
}

}  // namespace gs

#ifdef __CUDACC__
// S shards of T transactions over tables of A rows, G blocks a shard (see
// replay_kernel); where G > 1, part (S, G, T, 2) int32 scratch and counter
// (S,) int32 zeros (both unread, and may be null, at G = 1). Returns the
// first CUDA error of the launch, 0 if none.
extern "C" int gs_replay(const unsigned char* addrs, const int* nonces,
                         const int* balances, const int* coinbase,
                         const unsigned char* senders,
                         const unsigned char* sender_ok, const int* tx_nonce,
                         const int* tx_gas_limit, const int* tx_intrinsic,
                         const int* tx_price, const int* tx_value,
                         const unsigned char* tx_to,
                         const unsigned char* tx_valid, int S, int T, int A,
                         int G, unsigned char* status, int* gas_used,
                         int* nonces_out, int* balances_out, int* part,
                         int* counter, cudaStream_t stream) {
  if (S < 0 || T < 0 || A < 1 || A > gs::REPLAY_MAX_ROWS || G < 1 ||
      G > A || (long long)S * G > 0x7fffffffLL ||
      (G > 1 && ((T > 0 && !part) || !counter)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  gs::replay_kernel<<<S * G, gs::REPLAY_THREADS, 0, stream>>>(
      addrs, nonces, balances, coinbase, senders, sender_ok, tx_nonce,
      tx_gas_limit, tx_intrinsic, tx_price, tx_value, tx_to, tx_valid, T, A,
      G, status, gas_used, nonces_out, balances_out, part, counter);
  return (int)cudaGetLastError();
}
#endif
