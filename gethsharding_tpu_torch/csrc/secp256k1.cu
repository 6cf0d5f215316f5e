// secp256k1 public-key recovery: a group of 8 lanes per row, 4 rows per
// warp and two warps per block, every product's operands in registers.
//
// Computes what `ecrecover_batch` of gethsharding_tpu/ops/secp256k1_jax.py
// (:136, an XLA computation there, not a Pallas kernel) computes, and what
// its plain twin `ecrecover_plain` (ops/secp256k1.py) computes on 12-bit
// limbs: for each row, with R = lift_x(r) of parity recid,
//   Q = u1·G + u2·R,  u1 = -e·r^-1 mod n,  u2 = s·r^-1 mod n,
// as affine (qx, qy) at canonical values (0 where Q is infinity), and `ok`:
// valid, R on the curve, r and s in [1, n-1] as raw integers, recid in
// {0, 1}, Q not infinity. The outputs are the plain version's on every
// row, hostile ones included: the same Jacobian formulas up to polynomial
// identities (dbl-2009-l with 2((X + B)^2 - A - C) = 4·X·B; the chord's
// R^2 - H^3 - 2V and V - X3 from the products H^2·(U2 + U1) and
// H^2·(U2 + 2·U1)), the same cases (P = Q doubles, P = -Q is infinity,
// an infinity operand gives the other one), the same inverses (inv(0) =
// 0, as the reference's Fermat powers give it) and the same parity rule.
// Two freedoms change no output: G + R at R = G is 2G in affine form (a
// Jacobian point is a class, and the affine result is the class's), and
// a point at infinity keeps any X and Y (nothing reads them once Z is 0).
//
// What bounds it on this card: 32 x 32 -> 64-bit multiply-adds. Its bound
// (ops/secp256k1.py::least_multiply_adds) counts the least the function
// needs: 74 a product and 46 a square mod p on the special form, the
// root's addition chain, no products for either inverse, the ladder from
// the top set bit. The fixed yardstick beside it (`kernel_products`
// there: CIOS, 128 a product, 100 a square, Fermat inverses) over-counts
// by ~2.4x. Its bytes (three 25-limb rows in, two out) are negligible.
//
// The design:
// - The field mod p: 8 x 32-bit words in the plain domain, weakly
//   reduced (below 2^256, not always below p). A product sums each word
//   product's halves into 16 columns (a square its cross products once,
//   doubled), folds the high columns by 2^256 = 2^32 + 977 (mod p) and
//   carries once; a linear form k1·a + k2·b with small coefficients (a
//   negative one through 2p - b) is signed word columns carried once.
//   Values come below p only to compare and to leave.
// - The ladder, MSB to LSB over all 256 bits for every row: a step is a
//   doubling and a general Jacobian addition of the addend the row's two
//   bits pick (G, R or G + R, each with its Z^2 and Z^3 kept), 22
//   products and 6 linear forms in 6 phases of independent work. In a
//   phase each of the row's 8 lanes runs one instruction (SecpIns):
//   d = (ka1·a1 + ka2·a2)·(kb1·b1 + kb2·b2), the operands read from the
//   row's slots in shared memory, the product made in registers. Every
//   lane runs the same code on other slots, so a phase's products take
//   the time of one. A row's accumulator and addend are virtual slots
//   mapped per row (`map`), so the 4 rows of a warp run the same
//   instructions whatever their bits and cases; the last phase of a step
//   decides the next map from the zero flags of ZD, H, R and the addend's
//   Z. A step where P = Q (R = ±G rows) runs three more phases for the
//   warp: the doubling of the accumulator.
// - A block is two warps. Before the ladder, the first runs the square
//   root (p + 1)/4 of the block's rows by its addition chain (253 squares
//   and 13 products) while the second runs r^-1 mod n by the binary
//   extended Euclid (shifts and subtractions where a Fermat power takes
//   ~330 Montgomery products) and u1, u2 by CIOS Montgomery products.
//   The last inverse mod p, p - 2, shares the root's chain (255 squares
//   and 15 products).
// - No stack: point code and arithmetic are inline, every register array
//   is indexed at compile time (limb loops unrolled to 25 with the row's
//   limb count as a predicate), and run-time indices go to shared memory.
// What the card measured (PERF.md §6): a lone warp's product takes ~840
// cycles, set by its ~340 instructions; splitting a product over lanes
// through shared memory added more phases and syncs than it saved.
// Every phase is a block-stride loop over (row, lane) items ending in
// __syncwarp() (the prologue in __syncthreads()); no item of a phase
// reads what another item of the same phase writes, so one thread running
// every item in order is a legal schedule too (tests/torch_host_shim.py).
// SECP_CLOCK(i) marks the stages for scripts/torch_secp_clocks.py, which
// builds the source with SECP_CLOCKS; elsewhere it is empty.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

#ifdef SECP_CLOCKS
__device__ long long g_clk[8];
#define SECP_CLOCK(i)                                          \
  do {                                                         \
    __syncwarp();                                              \
    if (threadIdx.x == 0 && blockIdx.x == 0) g_clk[i] = clock64(); \
  } while (0)
#else
#define SECP_CLOCK(i) \
  do {                \
  } while (0)
#endif

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int SECP_LANES = 8;                          // lanes per row
constexpr int SECP_WARP_ROWS = 4;                      // rows per warp
constexpr int SECP_WARPS = 2;                          // warps per block
constexpr int SECP_ROWS = SECP_WARP_ROWS * SECP_WARPS;  // rows per block
constexpr int SECP_THREADS = SECP_LANES * SECP_ROWS;
constexpr int SECP_IN_WORDS = 10;  // 32-bit words of a row of <= 25 limbs
constexpr int SECP_MAX_LIMBS = 25;

struct Fe {
  u32 w[8];   // little-endian words
};

// == the field mod p = 2^256 - 2^32 - 977 ====================================

constexpr u32 P_LOW = 977u;   // 2^256 = 2^32 + P_LOW (mod p)

static __constant__ Fe SECP_P = {
    {0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
     0xffffffffu, 0xffffffffu, 0xffffffffu}};
// the low 8 words of 2p (its ninth word is 1)
static __constant__ u32 SECP_P2W[8] = {
    0xfffff85eu, 0xfffffffdu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};

// r + top·2^256 with top below 2^37, folded below 2^256
__device__ __forceinline__ void fp_fold(Fe& r, u64 top) {
  u64 c = (u64)r.w[0] + top * P_LOW;
  r.w[0] = (u32)c;
  c = (c >> 32) + r.w[1] + top;
  r.w[1] = (u32)c;
  c >>= 32;
#pragma unroll
  for (int j = 2; j < 8; ++j) {
    c += r.w[j];
    r.w[j] = (u32)c;
    c >>= 32;
  }
  // A carry out leaves a value below 2^70: add 2^256 mod p once more, which
  // carries no further than word 2.
  const u32 w = (u32)c;
  c = (u64)r.w[0] + w * P_LOW;
  r.w[0] = (u32)c;
  c = (c >> 32) + r.w[1] + w;
  r.w[1] = (u32)c;
  r.w[2] += (u32)(c >> 32);
}

// The value of 16 columns col[k]·2^(32k) (each below 2^36, unpropagated)
// mod p, below 2^256: the high columns fold by 2^256 = 2^32 + 977 first,
// so that one carry pass over 9 columns (each below 2^47) follows.
__device__ __forceinline__ Fe fp_cols(const u64 (&col)[16]) {
  Fe r;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += col[j] + col[j + 8] * P_LOW + (j > 0 ? col[j + 7] : 0);
    r.w[j] = (u32)c;
    c >>= 32;
  }
  fp_fold(r, c + col[15]);
  return r;
}

// t (16 words, below 2^512) mod p, below 2^256
__device__ __forceinline__ Fe fp_reduce(const u32 (&t)[16]) {
  u64 col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) col[k] = t[k];
  return fp_cols(col);
}

// a·b mod p of a, b below 2^256: every word product's low half summed
// into its column and its high half into the next, so that the column
// sums are independent chains and one carry pass ends the product
__device__ __forceinline__ Fe fp_mul(const Fe& a, const Fe& b) {
  u64 col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) col[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const u64 p = (u64)a.w[i] * b.w[j];
      col[i + j] += (u32)p;
      col[i + j + 1] += p >> 32;
    }
  }
  return fp_cols(col);
}

// a^2 mod p: the 28 cross products once, doubled, plus the 8 squares
__device__ __forceinline__ Fe fp_sqr(const Fe& a) {
  u64 col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) col[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      const u64 p = (u64)a.w[i] * a.w[j];
      col[i + j] += (u32)p;
      col[i + j + 1] += p >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) col[k] <<= 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const u64 p = (u64)a.w[i] * a.w[i];
    col[2 * i] += (u32)p;
    col[2 * i + 1] += p >> 32;
  }
  return fp_cols(col);
}

// k1·a + k2·b mod p for 0 <= k1 <= 15, -15 <= k2 <= 15 and a, b below
// 2^256, below 2^256; a negative k2 adds |k2|·(2p - b), a positive value,
// as signed word columns with one carry pass
__device__ __forceinline__ Fe fp_lin(const Fe& a, u32 k1, const Fe& b,
                                     int k2) {
  const bool neg = k2 < 0;
  const long long kb = k2;                    // b's coefficient
  const u64 kp = neg ? (u64)(-k2) : 0;        // 2p's coefficient
  Fe r;
  long long c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (long long)((u64)a.w[j] * k1) + (long long)b.w[j] * kb +
         (long long)((u64)SECP_P2W[j] * kp);
    r.w[j] = (u32)c;
    c >>= 32;   // arithmetic: the running sum may be negative
  }
  // 2p's ninth word is 1; the whole value is not negative
  fp_fold(r, (u64)(c + (long long)kp));
  return r;
}

// a ≡ 0 (mod p) for a below 2^256: a is 0 or p
__device__ __forceinline__ bool fp_is_zero(const Fe& a) {
  u32 z = 0, e = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    z |= a.w[j];
    e |= a.w[j] ^ SECP_P.w[j];
  }
  return z == 0 || e == 0;
}

// a mod p, below p: a >= p exactly when a + 2^32 + 977 carries out of
// 2^256, and then that sum less 2^256 is a - p
__device__ __forceinline__ Fe fp_canon(const Fe& a) {
  Fe s;
  u64 c = (u64)a.w[0] + P_LOW;
  s.w[0] = (u32)c;
  c = (c >> 32) + a.w[1] + 1;
  s.w[1] = (u32)c;
  c >>= 32;
#pragma unroll
  for (int j = 2; j < 8; ++j) {
    c += a.w[j];
    s.w[j] = (u32)c;
    c >>= 32;
  }
  return c ? s : a;
}

__device__ __forceinline__ Fe fp_sqr_n(Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fp_sqr(x);
  return x;
}

// The shared head of the two fixed powers mod p: x2 = x^3, x3 = x^7,
// x22 = x^(2^22 - 1) and x223 = x^(2^223 - 1).
__device__ __forceinline__ void fp_chain(const Fe& x, Fe& x2, Fe& x3,
                                         Fe& x22, Fe& x223) {
  x2 = fp_mul(fp_sqr(x), x);
  x3 = fp_mul(fp_sqr(x2), x);
  const Fe x6 = fp_mul(fp_sqr_n(x3, 3), x3);
  const Fe x9 = fp_mul(fp_sqr_n(x6, 3), x3);
  const Fe x11 = fp_mul(fp_sqr_n(x9, 2), x2);
  x22 = fp_mul(fp_sqr_n(x11, 11), x11);
  const Fe x44 = fp_mul(fp_sqr_n(x22, 22), x22);
  const Fe x88 = fp_mul(fp_sqr_n(x44, 44), x44);
  const Fe x176 = fp_mul(fp_sqr_n(x88, 88), x88);
  const Fe x220 = fp_mul(fp_sqr_n(x176, 44), x44);
  x223 = fp_mul(fp_sqr_n(x220, 3), x3);
}

// x^((p + 1) / 4): the square root where x is a square (p = 3 mod 4)
__device__ __forceinline__ Fe fp_sqrt(const Fe& x) {
  Fe x2, x3, x22, x223;
  fp_chain(x, x2, x3, x22, x223);
  Fe t = fp_mul(fp_sqr_n(x223, 23), x22);
  t = fp_mul(fp_sqr_n(t, 6), x2);
  return fp_sqr_n(t, 2);
}

// x^(p - 2): the Fermat inverse, 0 for x = 0. The same code on every
// lane, where a binary extended Euclid's loops would part the rows of a
// warp (measured slower at the notary's rows, PERF.md §6).
__device__ __forceinline__ Fe fp_inv(const Fe& x) {
  Fe x2, x3, x22, x223;
  fp_chain(x, x2, x3, x22, x223);
  Fe t = fp_mul(fp_sqr_n(x223, 23), x22);
  t = fp_mul(fp_sqr_n(t, 5), x);
  t = fp_mul(fp_sqr_n(t, 3), x2);
  return fp_mul(fp_sqr_n(t, 2), x);
}

// == the scalars mod n: CIOS Montgomery products (R = 2^256) ================

struct SecpMod {
  Fe m;       // the modulus
  u32 inv;    // -m^-1 mod 2^32
  Fe r2;      // R^2 mod m
  Fe r3;      // R^3 mod m
};

static __constant__ SecpMod SECP_N = {
    {{0xd0364141u, 0xbfd25e8cu, 0xaf48a03bu, 0xbaaedce6u, 0xfffffffeu,
      0xffffffffu, 0xffffffffu, 0xffffffffu}},
    0x5588b13fu,
    {{0x67d7d140u, 0x896cf214u, 0x0e7cf878u, 0x741496c2u, 0x5bcd07c6u,
      0xe697f5e4u, 0x81c69bc5u, 0x9d671cd5u}},
    {{0xe9ff41edu, 0x7bc0cfe0u, 0x44d4322cu, 0x00176484u, 0xf1d0b2dau,
      0xb1b31347u, 0x18ef116du, 0x555d800cu}}};

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  u32 acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.w[j];
  return acc == 0;
}

// a - b over 8 words; returns the borrow out (0 or 1)
__device__ __forceinline__ u32 fe_sub_raw(Fe& d, const Fe& a, const Fe& b) {
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 t = (u64)a.w[j] - b.w[j] - borrow;
    d.w[j] = (u32)t;
    borrow = (u32)(t >> 63);
  }
  return borrow;
}

// the value top·2^256 + a, below 2m, reduced below m
__device__ __forceinline__ Fe fe_reduce_once(const Fe& a, u32 top,
                                             const SecpMod& M) {
  Fe d;
  const u32 borrow = fe_sub_raw(d, a, M.m);
  return (top != 0 || borrow == 0) ? d : a;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const SecpMod& M) {
  Fe s;
  u32 carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 t = (u64)a.w[j] + b.w[j] + carry;
    s.w[j] = (u32)t;
    carry = (u32)(t >> 32);
  }
  return fe_reduce_once(s, carry, M);
}

// a - b mod m of a, b < m
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const Fe& m) {
  Fe d;
  const u32 borrow = fe_sub_raw(d, a, b);
  u32 carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 t = (u64)d.w[j] + (borrow ? m.w[j] : 0u) + carry;
    d.w[j] = (u32)t;
    carry = (u32)(t >> 32);
  }
  return d;
}

// Montgomery product a·b·R^-1 mod m (CIOS) of a, b < m; the result is < m.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b,
                                       const SecpMod& M) {
  u32 t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const u64 s = (u64)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;
    t[9] = (u32)(s >> 32);
    const u32 q = t[0] * M.inv;
    s = (u64)q * M.m.w[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (u64)q * M.m.w[j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = t[9] + (u32)(s >> 32);
  }
  Fe lo;
#pragma unroll
  for (int j = 0; j < 8; ++j) lo.w[j] = t[j];
  return fe_reduce_once(lo, t[8], M);
}

// a value below 2^320 (words lo·2^0 + hi·2^256, hi < 2^64) in Montgomery
// form mod m: lo·R + hi·R^2, through two products
__device__ __forceinline__ Fe to_mont(const u32 (&w)[SECP_IN_WORDS],
                                      const SecpMod& M) {
  Fe lo, hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lo.w[j] = w[j];
    hi.w[j] = 0;
  }
  hi.w[0] = w[8];
  hi.w[1] = w[9];
  lo = fe_reduce_once(lo, 0, M);   // lo < 2^256 < 2m
  return fe_add(mont_mul(lo, M.r2, M), mont_mul(hi, M.r3, M), M);
}

__device__ __forceinline__ Fe from_mont(const Fe& a, const SecpMod& M) {
  const Fe unit = {{1, 0, 0, 0, 0, 0, 0, 0}};
  return mont_mul(a, unit, M);
}

__device__ __forceinline__ bool fe_is_one(const Fe& a) {
  u32 acc = a.w[0] ^ 1u;
#pragma unroll
  for (int j = 1; j < 8; ++j) acc |= a.w[j];
  return acc == 0;
}

__device__ __forceinline__ void fe_shr1(Fe& u) {
#pragma unroll
  for (int j = 0; j < 7; ++j) u.w[j] = (u.w[j] >> 1) | (u.w[j + 1] << 31);
  u.w[7] >>= 1;
}

// x/2 mod m for x < m, m odd: (x + m)/2 where x is odd, a 257-bit sum
__device__ __forceinline__ void half_mod(Fe& x, const Fe& m) {
  const bool odd = x.w[0] & 1;
  u32 t[8];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (u64)x.w[j] + (odd ? m.w[j] : 0u);
    t[j] = (u32)c;
    c >>= 32;
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) x.w[j] = (t[j] >> 1) | (t[j + 1] << 31);
  x.w[7] = (t[7] >> 1) | ((u32)c << 31);
}

// a^-1 mod m for a < m and a prime m, 0 for a = 0 (as the Fermat inverse
// gives it), by the binary extended Euclid: a few hundred shifts and
// subtractions. Invariants: x1·a = u and x2·a = v (mod m), gcd(u, v) = 1.
__device__ __forceinline__ Fe inv_mod(const Fe& a, const Fe& m) {
  Fe u = a, v = m;
  Fe x1 = {{1, 0, 0, 0, 0, 0, 0, 0}}, x2 = {{0, 0, 0, 0, 0, 0, 0, 0}};
  if (fe_is_zero(a)) return x2;
  while (!fe_is_one(u) && !fe_is_one(v)) {
    while (!(u.w[0] & 1)) {
      fe_shr1(u);
      half_mod(x1, m);
    }
    while (!(v.w[0] & 1)) {
      fe_shr1(v);
      half_mod(x2, m);
    }
    Fe d;
    if (!fe_sub_raw(d, u, v)) {
      u = d;
      x1 = fe_sub(x1, x2, m);
    } else {
      fe_sub_raw(v, v, u);
      x2 = fe_sub(x2, x1, m);
    }
  }
  return fe_is_one(u) ? x1 : x2;
}

// raw value of the words below n?
__device__ __forceinline__ bool lt_n(const u32 (&w)[SECP_IN_WORDS]) {
  if (w[8] | w[9]) return false;
  Fe a, d;
#pragma unroll
  for (int j = 0; j < 8; ++j) a.w[j] = w[j];
  return fe_sub_raw(d, a, SECP_N.m) != 0;
}

// == rows in and out ==========================================================

// a row of canonical 12-bit limbs (value < 2^(12·nl), nl <= 25) as words
__device__ __forceinline__ void limbs_to_words(const int* x, int nl,
                                               u32 (&w)[SECP_IN_WORDS]) {
#pragma unroll
  for (int k = 0; k < SECP_IN_WORDS; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < SECP_MAX_LIMBS; ++i) {
    const u32 limb = i < nl ? (u32)x[i] & 0xFFFu : 0u;
    const int bit = 12 * i, k = bit >> 5, off = bit & 31;
    w[k] |= limb << off;
    if (off > 20) w[k + 1] |= limb >> (32 - off);
  }
}

// canonical words (value < 2^256) as nl canonical limbs
__device__ __forceinline__ void words_to_limbs(const Fe& a, int nl,
                                               int* out) {
#pragma unroll
  for (int i = 0; i < SECP_MAX_LIMBS; ++i) {
    const int bit = 12 * i, k = bit >> 5, off = bit & 31;
    u32 v = k < 8 ? a.w[k] >> off : 0;
    if (off > 20 && k + 1 < 8) v |= a.w[k + 1] << (32 - off);
    if (i < nl) out[i] = (int)(v & 0xFFFu);
  }
}

// == the row machine ==========================================================

// Slots of a row. The first NVIRT are virtual, mapped per row and step
// (`map`): the accumulator (X, Y = Y1 - Y2, Z) and the step's addend.
enum : int {
  V_X, V_Y1, V_Y2, V_Z, V_AX, V_AY, V_AZ, V_AZZ, V_AZZZ, NVIRT,
  S_ONE = NVIRT, S_ZERO,
  S_G,                        // G: x, y, 1, 1, 1
  S_R = S_G + 5,              // R: x, y, 1, 1, 1
  S_GR = S_R + 5,             // G + R: X, Y, Z, Z^2, Z^3
  S_G2X = S_GR + 5, S_G2Y,    // 2G, affine
  // the step's values (dbl-2009-l, then the chord)
  T_A, T_B, T_YZ,
  T_C, T_XB, T_F, T_ZZ, T_ZA, T_ZD,
  T_M, T_XD, T_U2, T_ZZZ, T_U1,
  T_S2, T_S1, T_HH, T_Z3, T_HS, T_YD,
  T_RR, T_HHH, T_W, T_VW, T_RS,
  T_X3, T_P1, T_P2,
  T_Z3S, T_Z3C,               // G + R's Z^2 and Z^3
  // the doubling where P = Q
  T_QA, T_QB, T_QYZ, T_QC, T_QXB, T_QF, T_QZD, T_QM, T_QXD, T_Q8C,
  T_ZI2, T_ZI3,               // the last inverse's square and cube
  SECP_SLOTS
};

// One lane's instruction of a phase: d = (ka1·a1 + ka2·a2)·(kb1·b1 +
// kb2·b2) mod p; k1 holds ka1 | kb1 << 4. d = SECP_NOP: the lane idles.
struct SecpIns {
  unsigned char d, a1, a2, b1, b2, k1;
  signed char ka2, kb2;
};
constexpr unsigned char SECP_NOP = 255;

#define SECP_INS_(d, a1, ka1, a2, ka2, b1, kb1, b2, kb2)                     \
  {d, a1, a2, b1, b2, (unsigned char)((ka1) | (kb1) << 4), ka2, kb2}
#define SECP_INS(...) SECP_INS_(__VA_ARGS__)
#define ONE_OF(x) x, 1, S_ZERO, 0     // the slot x as a linear form
#define SCALED(k, x) x, k, S_ZERO, 0  // k·x
#define NOP_INS {SECP_NOP, 0, 0, 0, 0, 0, 0, 0}

// The programs, 8 lanes a phase: the ladder step's 6 phases (dbl-2009-l
// on the accumulator D = 2·acc, then D + addend), G + R's 3 (G and R have
// Z = 1: U1 = Gx, U2 = Rx, S1 = Gy, S2 = Ry, Z3 = H) and the 3 of the
// doubling of D where D = addend.
constexpr int SECP_STEP = 0, SECP_GR = 6, SECP_DBL = 9, SECP_PROGS = 12;
static __constant__ SecpIns SECP_PROG[SECP_PROGS][SECP_LANES] = {
    // A = X^2, B = Y^2, YZ = Y·Z
    {SECP_INS(T_A, ONE_OF(V_X), ONE_OF(V_X)),
     SECP_INS(T_B, V_Y1, 1, V_Y2, -1, V_Y1, 1, V_Y2, -1),
     SECP_INS(T_YZ, V_Y1, 1, V_Y2, -1, ONE_OF(V_Z)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // C = B^2, XB = X·B, F = (3A)^2, ZD = 2YZ (D's Z), ZZ = ZD^2,
    // ZA = ZD·Z2
    {SECP_INS(T_C, ONE_OF(T_B), ONE_OF(T_B)),
     SECP_INS(T_XB, ONE_OF(V_X), ONE_OF(T_B)),
     SECP_INS(T_F, SCALED(3, T_A), SCALED(3, T_A)),
     SECP_INS(T_ZZ, SCALED(2, T_YZ), SCALED(2, T_YZ)),
     SECP_INS(T_ZA, SCALED(2, T_YZ), ONE_OF(V_AZ)),
     SECP_INS(T_ZD, SCALED(2, T_YZ), ONE_OF(S_ONE)),
     NOP_INS, NOP_INS},
    // M = 3A·(D' - XD) with D' = 4XB, XD = F - 8XB (D's X), U2 = X2·ZZ,
    // ZZZ = ZD^3, U1 = XD·Z2^2
    {SECP_INS(T_M, SCALED(3, T_A), T_XB, 12, T_F, -1),
     SECP_INS(T_XD, T_F, 1, T_XB, -8, ONE_OF(S_ONE)),
     SECP_INS(T_U2, ONE_OF(V_AX), ONE_OF(T_ZZ)),
     SECP_INS(T_ZZZ, ONE_OF(T_ZD), ONE_OF(T_ZZ)),
     SECP_INS(T_U1, T_F, 1, T_XB, -8, ONE_OF(V_AZZ)),
     NOP_INS, NOP_INS, NOP_INS},
    // S2 = Y2·ZZZ, S1 = YD·Z2^3 with YD = M - 8C (D's Y), HH = H^2,
    // Z3 = ZA·H, HS = H, YD, with H = U2 - U1
    {SECP_INS(T_S2, ONE_OF(V_AY), ONE_OF(T_ZZZ)),
     SECP_INS(T_S1, T_M, 1, T_C, -8, ONE_OF(V_AZZZ)),
     SECP_INS(T_HH, T_U2, 1, T_U1, -1, T_U2, 1, T_U1, -1),
     SECP_INS(T_Z3, ONE_OF(T_ZA), T_U2, 1, T_U1, -1),
     SECP_INS(T_HS, T_U2, 1, T_U1, -1, ONE_OF(S_ONE)),
     SECP_INS(T_YD, T_M, 1, T_C, -8, ONE_OF(S_ONE)),
     NOP_INS, NOP_INS},
    // RR = R^2, HHH = H^3, W = HH·(U2 + U1) = HHH + 2V,
    // VW = HH·(U2 + 2U1) = V + W, RS = R, with R = S2 - S1
    {SECP_INS(T_RR, T_S2, 1, T_S1, -1, T_S2, 1, T_S1, -1),
     SECP_INS(T_HHH, ONE_OF(T_HS), ONE_OF(T_HH)),
     SECP_INS(T_W, ONE_OF(T_HH), T_U2, 1, T_U1, 1),
     SECP_INS(T_VW, ONE_OF(T_HH), T_U2, 1, T_U1, 2),
     SECP_INS(T_RS, T_S2, 1, T_S1, -1, ONE_OF(S_ONE)),
     NOP_INS, NOP_INS, NOP_INS},
    // X3 = RR - W, P1 = R·(V - X3), P2 = S1·HHH: Y3 = P1 - P2
    {SECP_INS(T_X3, T_RR, 1, T_W, -1, ONE_OF(S_ONE)),
     SECP_INS(T_P1, ONE_OF(T_RS), T_VW, 1, T_RR, -1),
     SECP_INS(T_P2, ONE_OF(T_S1), ONE_OF(T_HHH)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // G + R: HH, H, R, RR with H = Rx - Gx, R = Ry - Gy
    {SECP_INS(T_HH, S_R, 1, S_G, -1, S_R, 1, S_G, -1),
     SECP_INS(T_HS, S_R, 1, S_G, -1, ONE_OF(S_ONE)),
     SECP_INS(T_RS, S_R + 1, 1, S_G + 1, -1, ONE_OF(S_ONE)),
     SECP_INS(T_RR, S_R + 1, 1, S_G + 1, -1, S_R + 1, 1, S_G + 1, -1),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // HHH, W = HH·(Rx + Gx), VW = HH·(Rx + 2Gx), Z3S = H^2
    {SECP_INS(T_HHH, ONE_OF(T_HS), ONE_OF(T_HH)),
     SECP_INS(T_W, ONE_OF(T_HH), S_R, 1, S_G, 1),
     SECP_INS(T_VW, ONE_OF(T_HH), S_R, 1, S_G, 2),
     SECP_INS(T_Z3S, ONE_OF(T_HS), ONE_OF(T_HS)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // X3, P1, P2 = Gy·HHH, Z3C = H^3
    {SECP_INS(T_X3, T_RR, 1, T_W, -1, ONE_OF(S_ONE)),
     SECP_INS(T_P1, ONE_OF(T_RS), T_VW, 1, T_RR, -1),
     SECP_INS(T_P2, ONE_OF(S_G + 1), ONE_OF(T_HHH)),
     SECP_INS(T_Z3C, ONE_OF(T_HS), ONE_OF(T_Z3S)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // 2D: QA = XD^2, QB = YD^2, QYZ = YD·ZD
    {SECP_INS(T_QA, ONE_OF(T_XD), ONE_OF(T_XD)),
     SECP_INS(T_QB, ONE_OF(T_YD), ONE_OF(T_YD)),
     SECP_INS(T_QYZ, ONE_OF(T_YD), ONE_OF(T_ZD)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // QC = QB^2, QXB = XD·QB, QF = (3QA)^2, QZD = 2QYZ
    {SECP_INS(T_QC, ONE_OF(T_QB), ONE_OF(T_QB)),
     SECP_INS(T_QXB, ONE_OF(T_XD), ONE_OF(T_QB)),
     SECP_INS(T_QF, SCALED(3, T_QA), SCALED(3, T_QA)),
     SECP_INS(T_QZD, SCALED(2, T_QYZ), ONE_OF(S_ONE)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS},
    // QM = 3QA·(12QXB - QF), QXD = QF - 8QXB, Q8C = 8QC: 2D's Y is
    // QM - Q8C
    {SECP_INS(T_QM, SCALED(3, T_QA), T_QXB, 12, T_QF, -1),
     SECP_INS(T_QXD, T_QF, 1, T_QXB, -8, ONE_OF(S_ONE)),
     SECP_INS(T_Q8C, SCALED(8, T_QC), ONE_OF(S_ONE)),
     NOP_INS, NOP_INS, NOP_INS, NOP_INS, NOP_INS},
};

#undef SECP_INS_
#undef SECP_INS
#undef ONE_OF
#undef SCALED
#undef NOP_INS

// the generator, 2G and b = 7
static __constant__ Fe SECP_GX = {
    {0x16f81798u, 0x59f2815bu, 0x2dce28d9u, 0x029bfcdbu, 0xce870b07u,
     0x55a06295u, 0xf9dcbbacu, 0x79be667eu}};
static __constant__ Fe SECP_GY = {
    {0xfb10d4b8u, 0x9c47d08fu, 0xa6855419u, 0xfd17b448u, 0x0e1108a8u,
     0x5da4fbfcu, 0x26a3c465u, 0x483ada77u}};
static __constant__ Fe SECP_G2X = {
    {0x5c709ee5u, 0xabac09b9u, 0x8cef3ca7u, 0x5c778e4bu, 0x95c07cd8u,
     0x3045406eu, 0x41ed7d6du, 0xc6047f94u}};
static __constant__ Fe SECP_G2Y = {
    {0x50cfe52au, 0x236431a9u, 0x3266d0e1u, 0xf7f63265u, 0x466ceaeeu,
     0xa3c58419u, 0xa63dc339u, 0x1ae168feu}};

// A block's rows in shared memory.
struct __align__(16) SecpShared {
  uint4 f[SECP_ROWS][SECP_SLOTS][2];           // the slots' words
  SecpIns prog[SECP_PROGS][SECP_LANES];
  u32 u[SECP_ROWS][2][8];                      // u1, u2 (canonical words)
  unsigned char zf[SECP_ROWS][SECP_SLOTS];     // slot ≡ 0 (mod p)
  unsigned char map[SECP_ROWS][2][NVIRT];      // by step parity
  unsigned char on_curve[SECP_ROWS], rs_ok[SECP_ROWS];
  int need[SECP_WARPS][2];   // a row of the warp doubles where P = Q
};

__device__ __forceinline__ Fe ld(const uint4* p) {
  const uint4 a = p[0], b = p[1];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void st(uint4* p, const Fe& v) {
  p[0] = uint4{v.w[0], v.w[1], v.w[2], v.w[3]};
  p[1] = uint4{v.w[4], v.w[5], v.w[6], v.w[7]};
}

__device__ __forceinline__ void put(SecpShared& S, int q, int slot,
                                    const Fe& v) {
  st(S.f[q][slot], v);
  S.zf[q][slot] = fp_is_zero(v);
}

__device__ __forceinline__ int bit_of(const u32* k, int i) {
  return (k[i >> 5] >> (i & 31)) & 1;
}

// the addend of step k in the map m: G, R or G + R by the row's bits (G
// where neither is set: its sum is not kept)
__device__ __forceinline__ void map_addend(const SecpShared& S, int q, int k,
                                           unsigned char* m) {
  const int t1 = bit_of(S.u[q][0], k), t2 = bit_of(S.u[q][1], k);
  const int base = t1 && t2 ? S_GR : (t2 && !t1 ? S_R : S_G);
#pragma unroll
  for (int j = 0; j < 5; ++j) m[V_AX + j] = (unsigned char)(base + j);
}

__device__ __forceinline__ void map_acc(unsigned char* m, int x, int y1,
                                        int y2, int z) {
  m[V_X] = (unsigned char)x;
  m[V_Y1] = (unsigned char)y1;
  m[V_Y2] = (unsigned char)y2;
  m[V_Z] = (unsigned char)z;
}

// The end of step k for row q (its last phase): the accumulator for step
// k - 1, by the cases of the plain version's `_pt_add` on D and the
// addend, and that step's addend.
__device__ __forceinline__ void secp_decide(SecpShared& S, int q, int k) {
  const unsigned char* m = S.map[q][k & 1];
  unsigned char* nx = S.map[q][(k + 1) & 1];
  const bool add = bit_of(S.u[q][0], k) | bit_of(S.u[q][1], k);
  const bool inf1 = S.zf[q][T_ZD], inf2 = S.zf[q][m[V_AZ]];
  const bool hz = S.zf[q][T_HS], rz = S.zf[q][T_RS];
  if (!add || (!inf1 && inf2)) {
    map_acc(nx, T_XD, T_YD, S_ZERO, T_ZD);
  } else if (inf1) {
    map_acc(nx, m[V_AX], m[V_AY], S_ZERO, m[V_AZ]);
  } else if (hz && rz) {
    map_acc(nx, T_QXD, T_QM, T_Q8C, T_QZD);
    S.need[q / SECP_WARP_ROWS][k & 1] = 1;
  } else if (hz) {
    map_acc(nx, S_ONE, S_ONE, S_ZERO, S_ZERO);
  } else {
    map_acc(nx, T_X3, T_P1, T_P2, T_Z3);
  }
  if (k > 0) map_addend(S, q, k - 1, nx);
}

// One phase of program `prog` for the block's `rows` rows, virtual slots
// through the maps of parity `cur`: lane i of a row runs instruction i.
// `reset` >= 0 clears each warp's need flag of that parity; `k` >= 0 ends
// step k (secp_decide on each row's lane 0).
__device__ __forceinline__ void secp_phase(SecpShared& S, int rows, int prog,
                                           int cur, int reset, int k) {
  for (int it = threadIdx.x; it < SECP_THREADS; it += blockDim.x) {
    const int q = it / SECP_LANES, lane = it % SECP_LANES;
    if (it % 32 == 0 && reset >= 0) S.need[it / 32][reset] = 0;
    if (q >= rows) continue;
    if (k >= 0 && lane == 0) secp_decide(S, q, k);
    const SecpIns in = S.prog[prog][lane];
    if (in.d == SECP_NOP) continue;
    const unsigned char* m = S.map[q][cur];
    const auto slot = [&](int s) { return S.f[q][s < NVIRT ? m[s] : s]; };
    const Fe a = fp_lin(ld(slot(in.a1)), in.k1 & 15u, ld(slot(in.a2)),
                        in.ka2);
    const Fe b = fp_lin(ld(slot(in.b1)), (u32)in.k1 >> 4, ld(slot(in.b2)),
                        in.kb2);
    put(S, q, in.d, fp_mul(a, b));
  }
  __syncwarp();
}

// e, r, s (n, nl) canonical limbs; recid (n,); valid (n,) 0/1; qx, qy
// (n, nl); ok (n,) 0/1. SECP_ROWS rows a block, SECP_LANES lanes a row.
__global__ void __launch_bounds__(SECP_THREADS)
    ecrecover_kernel(const int* e, const int* r, const int* s,
                     const int* recid, const unsigned char* valid, int n,
                     int nl, int* qx, int* qy, unsigned char* ok) {
  __shared__ SecpShared S;
  const int row0 = blockIdx.x * SECP_ROWS;
  const int rows = n - row0 < SECP_ROWS ? n - row0 : SECP_ROWS;
  const Fe zero = {{0, 0, 0, 0, 0, 0, 0, 0}};

  SECP_CLOCK(0);
  // The block's rows: R = lift_x(r) on the first warp, u1 and u2 on the
  // second, so that the two chains run side by side; then the constants.
  for (int it = threadIdx.x; it < SECP_THREADS; it += blockDim.x) {
    for (int i = it; i < SECP_PROGS * SECP_LANES; i += SECP_THREADS)
      S.prog[i / SECP_LANES][i % SECP_LANES] =
          SECP_PROG[i / SECP_LANES][i % SECP_LANES];
    if (it % 32 == 0) S.need[it / 32][0] = S.need[it / 32][1] = 0;
    // job 0: R (first warp), 1: u1 and u2 (second warp), 2: the constants
    const int i = it % 32, q = i % SECP_ROWS;
    const int job = it / 32 == 1 ? (i < SECP_ROWS ? 1 : 3)
                    : i < SECP_ROWS ? 0 : i < 2 * SECP_ROWS ? 2 : 3;
    if (job == 3 || q >= rows) continue;
    const long long row = row0 + q;
    if (job == 0) {
      // y = (r^3 + 7)^((p+1)/4), the parity chosen by recid
      u32 w[SECP_IN_WORDS];
      limbs_to_words(r + row * nl, nl, w);
      u32 t[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) t[j] = j < SECP_IN_WORDS ? w[j] : 0u;
      const Fe rx = fp_reduce(t);
      const Fe seven = {{7, 0, 0, 0, 0, 0, 0, 0}};
      const Fe y_sq = fp_lin(fp_mul(fp_sqr(rx), rx), 1, seven, 1);
      Fe ry = fp_canon(fp_sqrt(y_sq));
      S.on_curve[q] = fp_is_zero(fp_lin(fp_sqr(ry), 1, y_sq, -1));
      if ((int)(ry.w[0] & 1) != (recid[row] & 1))
        ry = fp_canon(fp_lin(ry, 0, ry, -1));
      put(S, q, S_R, rx);
      put(S, q, S_R + 1, ry);
    } else if (job == 1) {
      // u1 = -e·r^-1, u2 = s·r^-1 mod n
      u32 rw[SECP_IN_WORDS], sw[SECP_IN_WORDS], ew[SECP_IN_WORDS];
      limbs_to_words(r + row * nl, nl, rw);
      limbs_to_words(s + row * nl, nl, sw);
      limbs_to_words(e + row * nl, nl, ew);
      const Fe rn = to_mont(rw, SECP_N);
      const Fe sn = to_mont(sw, SECP_N);
      const Fe en = to_mont(ew, SECP_N);
      // r^-1 by the binary extended Euclid on r mod n, into the domain
      const Fe rinv = mont_mul(inv_mod(from_mont(rn, SECP_N), SECP_N.m),
                               SECP_N.r2, SECP_N);
      const Fe u1 = from_mont(
          mont_mul(fe_sub(zero, en, SECP_N.m), rinv, SECP_N), SECP_N);
      const Fe u2 = from_mont(mont_mul(sn, rinv, SECP_N), SECP_N);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        S.u[q][0][j] = u1.w[j];
        S.u[q][1][j] = u2.w[j];
      }
      S.rs_ok[q] = !fe_is_zero(rn) && lt_n(rw) && !fe_is_zero(sn) &&
                   lt_n(sw);
    } else {
      const Fe one = {{1, 0, 0, 0, 0, 0, 0, 0}};
      put(S, q, S_ONE, one);
      put(S, q, S_ZERO, zero);
      put(S, q, S_G, SECP_GX);
      put(S, q, S_G + 1, SECP_GY);
      put(S, q, S_G2X, SECP_G2X);
      put(S, q, S_G2Y, SECP_G2Y);
#pragma unroll
      for (int j = 2; j < 5; ++j) {
        put(S, q, S_G + j, one);
        put(S, q, S_R + j, one);
      }
    }
  }
  __syncthreads();

  SECP_CLOCK(1);
  // G + R, by the cases of `_pt_add`: R = G gives 2G, R = -G infinity
  for (int p = SECP_GR; p < SECP_DBL; ++p) secp_phase(S, rows, p, 1, -1, -1);
  for (int it = threadIdx.x; it < SECP_THREADS; it += blockDim.x) {
    const int q = it / SECP_LANES, lane = it % SECP_LANES;
    if (q >= rows) continue;
    const bool hz = S.zf[q][T_HS], rz = S.zf[q][T_RS];
    if (lane < 5) {   // the lane-th of X, Y, Z, Z^2, Z^3
      int s1, s2 = S_ZERO, k2 = 0;
      if (hz && rz) {
        s1 = lane == 0 ? S_G2X : lane == 1 ? S_G2Y : S_ONE;
      } else if (hz) {
        s1 = lane < 2 ? S_ONE : S_ZERO;
      } else {
        s1 = lane == 0 ? T_X3 : lane == 1 ? T_P1 : lane == 2 ? T_HS
             : lane == 3 ? T_Z3S : T_Z3C;
        if (lane == 1) {
          s2 = T_P2;
          k2 = -1;
        }
      }
      put(S, q, S_GR + lane,
          fp_lin(ld(S.f[q][s1]), 1, ld(S.f[q][s2]), k2));
    } else if (lane == 5) {   // step 255: the accumulator at infinity
      unsigned char* m = S.map[q][1];
      map_acc(m, S_ONE, S_ONE, S_ZERO, S_ZERO);
      map_addend(S, q, 255, m);
    }
  }
  __syncwarp();

  SECP_CLOCK(2);
  // the ladder, MSB to LSB: acc = 2·acc + {0, G, R, G + R}
  for (int k = 255; k >= 0; --k) {
    const int cur = k & 1;
    if (k == 191) SECP_CLOCK(5);
    if (k == 63) SECP_CLOCK(6);
#pragma unroll 1
    for (int p = 0; p < 6; ++p)
      secp_phase(S, rows, SECP_STEP + p, cur, p == 2 ? (k + 1) & 1 : -1,
                 p == 5 ? k : -1);
    bool need = false;   // the same for every thread of a warp
    for (int w = threadIdx.x / 32; w < SECP_WARPS; w += (blockDim.x + 31) / 32)
      need |= S.need[w][cur] != 0;
    if (need) {
#pragma unroll 1
      for (int p = SECP_DBL; p < SECP_PROGS; ++p)
        secp_phase(S, rows, p, cur, -1, -1);
    }
  }

  SECP_CLOCK(3);
  // affine: x = X/Z^2, y = Y/Z^3 (0 at infinity: inv(0) = 0)
  for (int it = threadIdx.x; it < SECP_THREADS; it += blockDim.x) {
    const int q = it / SECP_LANES, lane = it % SECP_LANES;
    if (q >= rows || lane != 0) continue;
    const Fe zinv = fp_inv(ld(S.f[q][S.map[q][1][V_Z]]));
    const Fe zinv2 = fp_sqr(zinv);
    st(S.f[q][T_ZI2], zinv2);
    st(S.f[q][T_ZI3], fp_mul(zinv, zinv2));
  }
  __syncwarp();
  for (int it = threadIdx.x; it < SECP_THREADS; it += blockDim.x) {
    const int q = it / SECP_LANES, lane = it % SECP_LANES;
    if (q >= rows) continue;
    const long long row = row0 + q;
    const unsigned char* m = S.map[q][1];
    if (lane == 0) {
      const Fe x = fp_canon(fp_mul(ld(S.f[q][m[V_X]]), ld(S.f[q][T_ZI2])));
      words_to_limbs(x, nl, qx + row * nl);
    } else if (lane == 1) {
      const Fe y = fp_lin(ld(S.f[q][m[V_Y1]]), 1, ld(S.f[q][m[V_Y2]]), -1);
      words_to_limbs(fp_canon(fp_mul(y, ld(S.f[q][T_ZI3]))), nl,
                     qy + row * nl);
    } else if (lane == 2) {
      const int v = recid[row];
      ok[row] = valid[row] != 0 && S.on_curve[q] && S.rs_ok[q] && v >= 0 &&
                v < 2 && !S.zf[q][m[V_Z]];
    }
  }
  SECP_CLOCK(4);
}

}  // namespace gs

#ifdef __CUDACC__
// e, r, s (n, nl) int32 canonical limbs, nl 22 or 25; recid (n,) int32;
// valid (n,) bool; qx, qy (n, nl) int32; ok (n,) bool. Returns the first
// CUDA error of the launch, 0 if none.
extern "C" int gs_ecrecover(const int* e, const int* r, const int* s,
                            const int* recid, const unsigned char* valid,
                            int n, int nl, int* qx, int* qy,
                            unsigned char* ok, cudaStream_t stream) {
  if (n < 0 || (nl != 22 && nl != 25)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + gs::SECP_ROWS - 1) / gs::SECP_ROWS;
  gs::ecrecover_kernel<<<blocks, gs::SECP_THREADS, 0, stream>>>(
      e, r, s, recid, valid, n, nl, qx, qy, ok);
  return (int)cudaGetLastError();
}
#endif
