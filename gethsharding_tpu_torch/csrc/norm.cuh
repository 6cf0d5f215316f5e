// ModArith.normalize in both lazy forms, as block-cooperative device code
// over accumulator rows held in shared memory.
//
// The steps are those of `normalize_plain` (ops/norm.py):
// - wide: three relaxed carry rounds into W + 3 limbs, the fold of the
//   limbs >= 22 through the (33, 22) rows 2^(12(22+k)) mod p, + lift, and
//   one exact carry into 25 canonical limbs;
// - exact (the TPU kernel's branch at ops/pallas_norm.py:83-91): three
//   relaxed rounds into W + 3 limbs and a fold; three relaxed rounds on 3
//   more zero limbs and a fold; exact carries into 24, then 23 limbs, each
//   followed by a fold; an exact carry into the 22 output limbs. No lift:
//   limbs a relaxed round left at -1 carry as borrows.
// Every step is the same integer arithmetic on the same int32 values (no
// sum leaves int32, and `>>` is arithmetic, so negative limbs borrow as
// they do there), so the limbs are the plain version's. An exact carry
// into more limbs than it reads hands the running carry to the limbs
// above, and drops the carry off its top limb, as the plain version does.
//
// How the work spreads over a block. Both forms compute:
// - the rounds, one lane per limb: a round is elementwise given the
//   previous values, z_i <- (z_i & 0xFFF) + (z_{i-1} >> 12), so limb i
//   after three rounds depends only on the input limbs i-3..i, and each
//   lane computes its limb from those four in registers;
// - each fold, one lane per output limb j < 22: (lift_j +) z_j + the sum
//   over the high limbs h of z_{22+h} · fold[h][j].
// Wide: three phases (rounds, fold with lift, one exact carry with one
// thread per row), each a block-stride loop over all of the block's rows
// ending in __syncthreads().
// Exact: four such phases. The first stage's rounds; its fold, in tiles
// of 2 rows × 2 limbs a thread (half the shared-memory loads of a thread
// a limb, which bound that phase); the second stage, its rounds fused into
// its fold (lane j makes the rounds at j and at the three high limbs
// itself); then the tail, one thread per row, so the rows' serial chains
// share the fewest warps (36 rows: 2 of a 512-thread block's 16). The
// tail runs in registers: carry into 24, fold of limbs 22-23, carry into
// 23, fold of limb 22, carry into 22, each carry walked in words of three
// limbs (36 bits in an int64: 8 serial steps where a limb ripple takes
// 22-24; the word carry the plain `limb.carry` uses), the first two
// leaving the low words uncarried, the folds adding the fold rows as
// words (exact_tail). An exact carry into
// N limbs is a function of the value alone: the canonical 12-bit digits
// of (sum a_j 2^(12j)) mod 2^(12N) with floor semantics (arithmetic
// shifts, negative limbs borrow, the carry off the top dropped). The
// digits of a residue are unique, so any exact method gives the limb
// ripple's limbs; the words are one.
// Two other schedules of the exact ladder gave the same limbs and
// measured slower on the H100 (PERF.md; scripts/torch_norm_routes.py
// builds them from its own copy): each warp running the whole ladder on
// its own share of the rows with __syncwarp() between its steps and one
// __syncthreads() at the end, and the same with each exact carry spread
// over the warp's lanes (three relaxed rounds take every limb into
// [-1, 4096], then a Kogge-Stone prefix of 5 steps over the limbs' carry
// functions resolves the rest).
// Each phase's items read only what an earlier phase wrote, the loops
// stride by the block's width, and nothing uses warp shuffles, so one
// thread running every item in order is a legal schedule too.
#pragma once

// NORM_CLOCK(i) marks the phases of the exact ladder for
// scripts/torch_norm_clocks.py, which builds with NORM_CLOCKS: block 0's
// first thread reads the clock at each mark and prints the phases'
// cycles when the normalize ends. Elsewhere they are empty.
#ifdef NORM_CLOCKS
#include <cstdio>
#define NORM_CLOCK(i) const long long norm_clock_##i = clock64()
#define NORM_CLOCK_REPORT()                                                 \
  if (threadIdx.x == 0 && blockIdx.x == 0)                                  \
  printf("NORM_CLOCKS %d %d %lld %lld %lld %lld\n", rows, WM,              \
         norm_clock_1 - norm_clock_0, norm_clock_2 - norm_clock_1,          \
         norm_clock_3 - norm_clock_2, norm_clock_4 - norm_clock_3)
#else
#define NORM_CLOCK(i)
#define NORM_CLOCK_REPORT()
#endif

namespace gs {

constexpr int NORM_NL = 25;        // output limbs of the wide form
constexpr int NORM_FB = 22;        // fold base
constexpr int NORM_FR = 33;        // fold rows
constexpr int NORM_LB = 12;        // bits per limb
constexpr int NORM_LM = (1 << NORM_LB) - 1;
constexpr int NORM_WMAX = NORM_FB + NORM_FR - 3;  // widest accumulator, 52
// row stride of the second stage's limbs for the tail (odd: the tail's
// threads read them without bank conflicts)
constexpr int NORM_TS = NORM_FB + 1;

// One relaxed round at one limb: its low bits plus the carry from below.
__device__ __forceinline__ int relax(int x, int below) {
  return (x & NORM_LM) + (below >> NORM_LB);
}

// Limb i (0 <= i < w + 3) of row z (width w) after three relaxed rounds.
__device__ __forceinline__ int three_rounds(const int* z, int w, int i) {
  int a[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int j = i - 3 + d;
    a[d] = (j >= 0 && j < w) ? z[j] : 0;
  }
  const int b0 = relax(a[1], a[0]), b1 = relax(a[2], a[1]),
            b2 = relax(a[3], a[2]);            // round 1 at i-2, i-1, i
  return relax(relax(b2, b1), relax(b1, b0));  // rounds 2 and 3
}

// Limb j < 22 of the fold of row x (NV limbs): x_j (0 past NV), + lift_j
// where LIFTED, + the NV - 22 high limbs through the fold rows.
template <int NV, bool LIFTED>
__device__ __forceinline__ int fold_limb(const int* x, int j,
                                         const int* fold, const int* lift) {
  constexpr int NH = NV > NORM_FB ? NV - NORM_FB : 0;
  int s = (j < NV ? x[j] : 0);
  if constexpr (LIFTED) s += lift[j];
#pragma unroll
  for (int h = 0; h < NH; ++h) s += x[NORM_FB + h] * fold[h * NORM_FB + j];
  return s;
}

// The lazy forms (`limb.LIMB_FORM`), as the `form` argument of gs_norm.
enum NormForm { NORM_WIDE = 0, NORM_EXACT = 1 };

// -- the wide form: block-stride phases ------------------------------------

// Limb i < NOUT of each of `rows` rows after three relaxed rounds: row r
// is z[r·zs ..] (width w, zero above), its limbs go to t[r·ts ..].
template <int NOUT>
__device__ __forceinline__ void rounds_rows(const int* z, int zs, int w,
                                            int rows, int* t, int ts) {
  for (int i = threadIdx.x; i < rows * NOUT; i += blockDim.x) {
    const int r = i / NOUT, j = i - r * NOUT;
    t[r * ts + j] = three_rounds(z + r * zs, w, j);
  }
  __syncthreads();
}

// The fold of each row v[r·vs ..] of NV limbs onto 22 (fold_limb). Row
// r's 22 limbs go to acc[r·22 ..].
template <int NV, bool LIFTED>
__device__ __forceinline__ void fold_rows(const int* v, int vs, int rows,
                                          const int* fold, const int* lift,
                                          int* acc) {
  for (int t = threadIdx.x; t < rows * NORM_FB; t += blockDim.x) {
    const int r = t / NORM_FB, j = t - r * NORM_FB;
    acc[t] = fold_limb<NV, LIFTED>(v + r * vs, j, fold, lift);
  }
  __syncthreads();
}

// The exact carry of each row acc[r·22 ..] into NOUT >= 22 canonical
// limbs at out[r·os ..]; the carry off the top limb is dropped.
template <int NOUT>
__device__ __forceinline__ void carry_rows(const int* acc, int rows,
                                           int* out, int os) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    int a[NORM_FB];
#pragma unroll
    for (int j = 0; j < NORM_FB; ++j) a[j] = acc[r * NORM_FB + j];
    int* o = out + r * os;
    int c = 0;
#pragma unroll
    for (int j = 0; j < NORM_FB; ++j) {
      const int x = a[j] + c;
      o[j] = x & NORM_LM;
      c = x >> NORM_LB;
    }
#pragma unroll
    for (int j = NORM_FB; j < NOUT; ++j) {
      o[j] = c & NORM_LM;
      c >>= NORM_LB;
    }
  }
  __syncthreads();
}

// -- the exact form ---------------------------------------------------------

// A row of limbs as its eight 36-bit words: word k = l_3k + l_3k+1·2^12
// + l_3k+2·2^24 over the n limbs (zero above).
__device__ __forceinline__ void limbs_to_words(const int* l, int n,
                                               long long* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    long long s = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (3 * k + d < n) s += (long long)l[3 * k + d] * (1LL << (NORM_LB * d));
    w[k] = s;
  }
}

// The exact carry of words w (|w| < 2^62) into NOUT (22..24) limbs, in
// place: each word becomes its 36 canonical bits, the top word its
// NOUT - 21 limbs, and the carry off the top is dropped. 8 serial steps.
template <int NOUT>
__device__ __forceinline__ void carry_word_row(long long* w) {
  constexpr long long MASK = (1LL << (3 * NORM_LB)) - 1;
  constexpr long long TOP = (1LL << (NORM_LB * (NOUT - 21))) - 1;
  long long c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long x = w[k] + c;
    w[k] = x & (k < 7 ? MASK : TOP);
    c = x >> (3 * NORM_LB);
  }
}

// Limb j of canonical words w.
__device__ __forceinline__ int word_limb(const long long* w, int j) {
  return (int)(w[j / 3] >> (NORM_LB * (j % 3))) & NORM_LM;
}

// Limb j < 22 of the second stage of row a (22 limbs): three rounds on 3
// more zero limbs, then the fold of those 3, the high limbs' rounds made
// here too (the same ints as rounds into 25 limbs, then fold_limb<25>).
__device__ __forceinline__ int stage2_limb(const int* a, int j,
                                           const int* fold) {
  int s = three_rounds(a, NORM_FB, j);
#pragma unroll
  for (int h = 0; h < 3; ++h)
    s += three_rounds(a, NORM_FB, NORM_FB + h) * fold[h * NORM_FB + j];
  return s;
}

// Word k of fold row h: fold[h][3k] + fold[h][3k+1]·2^12 +
// fold[h][3k+2]·2^24 (limbs past 21 zero). The tail reads rows 0 and 1 as
// fw[h·8 + k].
__device__ __forceinline__ unsigned long long fold_word(const int* fold,
                                                       int h, int k) {
  unsigned long long s = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (3 * k + d < NORM_FB)
      s += (unsigned long long)(unsigned)fold[h * NORM_FB + 3 * k + d]
           << (NORM_LB * d);
  return s;
}

// The exact carry of words w into NOUT (23 or 24) limbs as the ladder's
// tail runs it: only its limbs 22..NOUT-1 go to top, and the words are
// left as V mod 2^264, uncarried. With c7 the carry of the low seven
// words into word 7 and x7 = w7 + c7, V is (the low words' canonical
// bits) + x7·2^252, so V mod 2^264 is the low words as they are plus
// ((x7 & 0xFFF) - c7)·2^252, and limbs 22.. of V mod 2^(12·NOUT) are the
// next bits of x7 (floor semantics). 7 serial steps, no low word written.
template <int NOUT>
__device__ __forceinline__ void carry_top(long long* w, unsigned* top) {
  long long c = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) c = (w[k] + c) >> (3 * NORM_LB);
  const long long x7 = w[7] + c;
#pragma unroll
  for (int j = 0; j < NOUT - NORM_FB; ++j)
    top[j] = (unsigned)(x7 >> (NORM_LB * (j + 1))) & NORM_LM;
  w[7] = (x7 & NORM_LM) - c;
}

// The ladder's tail on one row v (22 limbs), in registers on 36-bit
// words, fold rows 0 and 1 as words fw: carry into 24, fold of limbs
// 22-23, carry into 23, fold of limb 22, carry into 22; its 22 limbs go
// to o. The first two carries only feed the fold their top limbs
// (carry_top), so only the last writes canonical words. The same limbs
// as the plain version's ladder: each step there is a function of the
// value alone. FENCE: the fold words load after the first carry, not
// early, which keeps their 16 registers out of that carry's span (the
// tower kernel's 256-thread Fp kind spills without it; norm_kernel is
// faster without it).
template <bool FENCE>
__device__ __forceinline__ void exact_tail(const int* v,
                                           const unsigned long long* fw,
                                           int* o) {
  int a[NORM_FB];
#pragma unroll
  for (int j = 0; j < NORM_FB; ++j) a[j] = v[j];
  long long w[8];
  limbs_to_words(a, NORM_FB, w);
  // 12-bit limbs times 36-bit words: unsigned, so a product is one
  // 32 × 32 -> 64 multiply and one multiply-add into its high word
  unsigned y[2];
  carry_top<NORM_FB + 2>(w, y);
  if constexpr (FENCE) asm volatile("" ::: "memory");
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] += (long long)(y[0] * fw[k] + y[1] * fw[8 + k]);
  carry_top<NORM_FB + 1>(w, y);
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] += (long long)(y[0] * fw[k]);
  carry_word_row<NORM_FB>(w);
#pragma unroll
  for (int j = 0; j < NORM_FB; ++j) o[j] = word_limb(w, j);
}

// Scratch ints per row that norm_rows<WM, F> needs in t3: WM + 3, made
// odd in the exact form (its tiled fold).
template <int WM, NormForm F>
__host__ __device__ constexpr int norm_scratch_row() {
  return F == NORM_EXACT ? (WM + 3) | 1 : WM + 3;
}

// The fold of `rows` rows v[r·vs ..] (NV limbs, no lift) onto 22, in
// tiles of 2 rows × 2 limbs a thread: per high limb 2 + 2 loads for 4
// multiply-adds, where a thread a limb makes 2 loads for 1. With vs odd
// the rows of a warp's tiles fall in distinct banks.
template <int NV>
__device__ __forceinline__ void fold_rows_tiled(const int* v, int vs,
                                                int rows, const int* fold,
                                                int* acc) {
  constexpr int NH = NV - NORM_FB, Q = NORM_FB / 2;
  for (int t = threadIdx.x; t < (rows + 1) / 2 * Q; t += blockDim.x) {
    const int p = t / Q, j = 2 * (t - p * Q);
    const int r0 = 2 * p, r1 = r0 + 1 < rows ? r0 + 1 : r0;
    const int* x0 = v + r0 * vs;
    const int* x1 = v + r1 * vs;
    int s00 = x0[j], s01 = x0[j + 1], s10 = x1[j], s11 = x1[j + 1];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int a0 = x0[NORM_FB + h], a1 = x1[NORM_FB + h];
      const int f0 = fold[h * NORM_FB + j], f1 = fold[h * NORM_FB + j + 1];
      s00 += a0 * f0;
      s01 += a0 * f1;
      s10 += a1 * f0;
      s11 += a1 * f1;
    }
    acc[r0 * NORM_FB + j] = s00;
    acc[r0 * NORM_FB + j + 1] = s01;
    acc[r1 * NORM_FB + j] = s10;        // r1 == r0: the same values
    acc[r1 * NORM_FB + j + 1] = s11;
  }
  __syncthreads();
}

// The exact ladder in block phases, with norm_rows' arguments: the first
// stage's rounds, its fold in tiles, the second stage, each a
// block-stride loop over all rows' limbs; then the tail, one thread a
// row (exact_tail<FENCE>).
template <int WM, bool FENCE>
__device__ __forceinline__ void norm_exact_rows(const int* z, int zs, int w,
                                                int rows, int* out, int os,
                                                const int* fold, int* t3,
                                                int* acc) {
  constexpr int W3 = WM + 3;
  constexpr int S1 = W3 | 1;   // odd: a warp's tiles read distinct banks
  __shared__ unsigned long long s_fw[16];
  NORM_CLOCK(0);
  for (int i = blockDim.x - 1 - threadIdx.x; i < 16; i += blockDim.x)
    s_fw[i] = fold_word(fold, i / 8, i % 8);   // by the least busy threads
  rounds_rows<W3>(z, zs, w, rows, t3, S1);
  NORM_CLOCK(1);
  fold_rows_tiled<W3>(t3, S1, rows, fold, acc);
  NORM_CLOCK(2);
  for (int t = threadIdx.x; t < rows * NORM_FB; t += blockDim.x) {
    const int r = t / NORM_FB, j = t - r * NORM_FB;
    t3[r * NORM_TS + j] = stage2_limb(acc + r * NORM_FB, j, fold);
  }
  __syncthreads();
  NORM_CLOCK(3);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    int o[NORM_FB];
    exact_tail<FENCE>(t3 + r * NORM_TS, s_fw, o);
#pragma unroll
    for (int j = 0; j < NORM_FB; ++j) out[r * os + j] = o[j];
  }
  __syncthreads();
  NORM_CLOCK(4);
  NORM_CLOCK_REPORT();
}

// Normalize `rows` accumulators: row r is z[r·zs ..], width w <= WM <=
// 52, |limb| < 2^30.7, value >= 0. Row r's 25 (wide) or 22 (exact) limbs
// go to out[r·os ..]. The loops run over the compile-time width WM, so
// they unroll; limbs past w are zero, which gives the same limbs as width
// w (a zero limb stays zero through the rounds and folds nothing). fold
// (its first WM + 3 - 22 rows are read) and lift: shared memory.
// Scratch: t3 rows·norm_scratch_row<WM, F>() ints, acc rows·22 ints. out
// must not overlap z or the scratch. Ends in __syncthreads(). TAIL_FENCE:
// the exact tail's (exact_tail), read in the exact form only.
template <int WM, NormForm F = NORM_WIDE, bool TAIL_FENCE = false>
__device__ __forceinline__ void norm_rows(const int* z, int zs, int w,
                                          int rows, int* out, int os,
                                          const int* fold, const int* lift,
                                          int* t3, int* acc) {
  static_assert(WM >= 1 && WM <= NORM_WMAX, "width out of range");
  static_assert(F == NORM_WIDE || WM >= NORM_FB,
                "the exact ladder folds limbs 22 and up");
  constexpr int W3 = WM + 3;
  if constexpr (F == NORM_WIDE) {
    rounds_rows<W3>(z, zs, w, rows, t3, W3);
    // the carry off the top limb is zero (value < 2^273)
    fold_rows<W3, true>(t3, W3, rows, fold, lift, acc);
    carry_rows<NORM_NL>(acc, rows, out, os);
  } else {
    norm_exact_rows<WM, TAIL_FENCE>(z, zs, w, rows, out, os, fold, t3,
                                     acc);
  }
}

}  // namespace gs
