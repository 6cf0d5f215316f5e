// The final exponentiation's Fp12 steps (product, Frobenius map) with
// their normalizes spread over lanes, as block-cooperative device code;
// the committee sums of csrc/agg.cu run their phases on the same helpers
// (a 25-limb normalize in one phase, fe_normalize25; Fp products and
// split schoolbooks, fe_products; rows that an input binds once per item,
// fe_row; outputs through a row functor, in int16 there).
//
// Each step computes what the plain versions `_fp12_mul` / `_frob` of
// ops/megakernels.py (and, for the product, field.cuh's `fp12_mul`)
// compute, the same int32 values at every normalize's input, so it
// returns the same limbs; only the schedule and the multiplication
// differ:
// - the columns of an Fp12 product's Fp2 products a·b come from three
//   schoolbook products instead of four (Karatsuba): P = a0 ⊛ b0,
//   Q = a1 ⊛ b1, R = (a0 + a1) ⊛ (b0 + b1), component 0 = P - Q and
//   component 1 = R - P - Q; the Frobenius map's 12 keep the four
//   products. A column is an exact integer below 2^30.7 in magnitude
//   whatever the order of its terms, so the accumulators are those of
//   the plain version. A work item is one whole 25 × 25 schoolbook with
//   both operands in registers and every index a compile-time constant,
//   so a multiply-add is one instruction and every item runs the same
//   code;
// - a relaxed normalize (two rounds, fold, lift, three rounds) is spread
//   over (row, chunk of limbs) lanes. A round is elementwise given the
//   previous values, z_i <- (z_i & 0xFFF) + (z_{i-1} >> 12), except that
//   the top limb keeps its own carry, so limb i after k rounds depends
//   only on the limbs i-k..i: a lane computes a chunk of consecutive
//   limbs from a window of k more inputs in registers. The fold of a
//   49-column row is a lane per two limbs j with their fold columns in
//   registers; the fold of a 25-limb row reads its five fold rows from
//   the constant bank at compile-time indices;
// - phases that only read each other's windows are fused: the fold and
//   three last rounds of a 25-limb normalize are one phase; a group
//   merge reads the three last rounds of the two partial sums it adds
//   and does the first two rounds of its own normalize in the same lane,
//   so the partial sums are never stored; the second merge folds the
//   first one's output in the lane too; the rounds that read the columns
//   add the schoolbook products and the pad. A product is 8 phases, a
//   Frobenius map 6.
// Lanes that run compile-time variants (a chunk of limbs) run them
// chunk-major with the rows padded to whole warps, so the lanes of a warp
// run the same code. Every phase is a block-stride loop ending in
// __syncthreads(), and no item of a phase reads what another item of the
// same phase writes, so one thread running every item in order is a
// legal schedule too.
#pragma once

#include <type_traits>

#include "field.cuh"

namespace gs {

constexpr int FE_THREADS = 512;   // threads per block of the final exp
constexpr int FE_FRAC = 2;        // numerator and denominator
constexpr int FE_ROWS12 = FE_FRAC * 12;  // Fp rows of a step's operand
constexpr int FE_ROWS36 = FE_FRAC * 36;  // a product's accumulators
constexpr int FE_Z1 = NL + 2;     // width of a 25-limb normalize's rounds
constexpr int FE_Z2 = NC + 2;     // width of a 49-column normalize's rounds
constexpr int FE_FOLD_SLOTS = 23; // row slots of a 49-column fold
// limbs per lane in the phases of rounds (chunk widths)
constexpr int FE_CW_Z1 = 7;       // two rounds of a 25-limb normalize
constexpr int FE_CW_Z2 = 11;      // two rounds of a 49-column normalize
constexpr int FE_CW_OUT = 5;      // fold and three rounds into 25 limbs
constexpr int FE_CW_MERGE = 7;    // group merges

// Scratch of one block, in shared memory (ints).
struct FeScratch {
  int* xi;    // 24 rows of 25: xi·y, or the Frobenius input
  int* zero;  // one row of 25 zeros
  int* part;  // 3 × 72 rows of 49: the schoolbook products' columns
  int* t2;    // 72 rows of up to 51: after two rounds
  int* acc;   // 72 rows of 22: folded columns
  int* t2m;   // 24 rows of 27: the first merge after two rounds
};

constexpr int FE_SCRATCH_INTS = FE_ROWS12 * NL + NL + 3 * FE_ROWS36 * NC +
                                FE_ROWS36 * FE_Z2 + FE_ROWS36 * FB +
                                FE_ROWS12 * FE_Z1;

// The first fold rows (those a 25-limb normalize reads) and the lift of
// the constant pack (C_FOLD, C_LIFT) in the constant bank, one copy per
// source file that includes this header. On the card the launcher copies
// them there before each launch; compiled for the host, the kernel
// copies them itself.
static __constant__ int fe_fold_c[(FE_Z1 - FB) * FB];
static __constant__ int fe_lift_c[NL];

__device__ __forceinline__ void fe_host_consts(const int* consts) {
#ifndef __CUDACC__
  for (int i = 0; i < (FE_Z1 - FB) * FB; ++i)
    fe_fold_c[i] = consts[C_FOLD + i];
  for (int i = 0; i < NL; ++i) fe_lift_c[i] = consts[C_LIFT + i];
#else
  (void)consts;
#endif
}

template <int V>
struct FeInt {
  static constexpr int value = V;
};

// f(FeInt<k>{}) for a runtime k < N: one compile-time body per k.
template <int N, class F>
__device__ __forceinline__ void fe_dispatch(int k, F f) {
  if constexpr (N > 1) {
    if (k == N - 1) {
      f(FeInt<N - 1>{});
      return;
    }
    fe_dispatch<N - 1>(k, f);
  } else {
    f(FeInt<0>{});
  }
}

// A phase over G groups × `rows` rows, group-major with the rows padded
// to whole warps: f(FeInt<group>, r), the group a compile-time constant
// that the lanes of a warp share.
template <int G, class F>
__device__ __forceinline__ void fe_phase(int rows, F f) {
  const int rp = (rows + 31) & ~31;
  for (int t = threadIdx.x; t < G * rp; t += blockDim.x) {
    const int g = t / rp, r = t - g * rp;
    if (r < rows) fe_dispatch<G>(g, [&](auto gc) { f(gc, r); });
  }
  __syncthreads();
}

// a[d] holds limb LO + d of a row (zero below limb 0). K relaxed rounds
// in place: afterwards a[d] is that limb after K rounds for d >= K
// (entries below are stale). Limb TOP keeps its own carry; entries past
// it are not limbs of the row, and nothing below them reads them.
template <int K, int LO, int TOP, int N>
__device__ __forceinline__ void window_rounds(int (&a)[N]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int d = N - 1; d > r; --d) {
      const int v = a[d];
      a[d] = (LO + d == TOP ? v : (v & LM)) + (a[d - 1] >> LB);
    }
  }
}

// Folded limb l of a 25-limb row after two rounds (v: its 27 limbs; hi:
// its limbs 22..26): z_l + lift_l + the sum over h of z_{22+h} ·
// fold[h][l] below 22, the lift alone from 22 to 24, zero outside the
// row.
__device__ __forceinline__ int folded_limb(const int* v,
                                           const int (&hi)[FE_Z1 - FB],
                                           int l) {
  if (l < 0 || l >= NL) return 0;
  if (l >= FB) return fe_lift_c[l];
  int s = v[l] + fe_lift_c[l];
#pragma unroll
  for (int h = 0; h < FE_Z1 - FB; ++h) s += hi[h] * fe_fold_c[h * FB + l];
  return s;
}

// Limb l of a row already folded (22 stored limbs): the lift above them,
// zero outside the row.
__device__ __forceinline__ int acc_limb(const int* acc, int l) {
  if (l < 0 || l >= NL) return 0;
  return l < FB ? acc[l] : fe_lift_c[l];
}

// The limbs of row r as a function of the limb: `in` either binds a row,
// in(r) returning that function (its per-row work then runs once per
// item), or gives a limb, in(r, l).
template <class In>
__device__ __forceinline__ auto fe_row(In& in, int r) {
  if constexpr (std::is_invocable_v<In&, int, int>)
    return [&in, r](int l) { return in(r, l); };
  else
    return in(r);
}

// Phase: the first two rounds of normalize<W> on rows of W limbs,
// fe_row(in, r), into t2 (row r at t2 + r·(W + 2)). A lane computes CW
// consecutive limbs of a row from a window of CW + 2 inputs.
template <int W, int CW, class In>
__device__ __forceinline__ void fe_two_rounds(int rows, In in, int* t2) {
  constexpr int Z = W + 2, NCH = (Z + CW - 1) / CW;
  fe_phase<NCH>(rows, [&](auto chunk, int r) {
    constexpr int L0 = decltype(chunk)::value * CW, LO = L0 - 2;
    auto row = fe_row(in, r);
    int a[CW + 2];
#pragma unroll
    for (int d = 0; d < CW + 2; ++d) {
      const int l = LO + d;
      a[d] = (l >= 0 && l < W) ? row(l) : 0;
    }
    window_rounds<2, LO, Z - 1>(a);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < Z) t2[r * Z + L0 + d] = a[2 + d];
  });
}

// Phase: the fold of normalize<W> over rows after two rounds (row r at
// t2 + r·(W + 2)) into acc (row r at acc + r·22; the lift above 22 is
// added by the readers). A lane keeps two limbs j, j + 1 with their fold
// columns in registers and walks every FE_FOLD_SLOTS-th row, so each
// high limb it loads serves two multiply-adds.
template <int W>
__device__ __forceinline__ void fe_fold(int rows, const int* t2, int* acc,
                                        const int* T) {
  constexpr int Z = W + 2, NH = Z - FB, JP = FB / 2;
  static_assert(NH <= FR, "accumulator too wide");
  for (int t = threadIdx.x; t < JP * FE_FOLD_SLOTS; t += blockDim.x) {
    const int j = 2 * (t % JP);
    int F0[NH], F1[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      F0[h] = T[C_FOLD + h * FB + j];
      F1[h] = T[C_FOLD + h * FB + j + 1];
    }
    const int lift0 = T[C_LIFT + j], lift1 = T[C_LIFT + j + 1];
    for (int r = t / JP; r < rows; r += FE_FOLD_SLOTS) {
      const int* v = t2 + r * Z;
      int s0 = v[j] + lift0, s1 = v[j + 1] + lift1;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int z = v[FB + h];
        s0 += z * F0[h];
        s1 += z * F1[h];
      }
      acc[r * FB + j] = s0;
      acc[r * FB + j + 1] = s1;
    }
  }
  __syncthreads();
}

// Output rows of a phase: row r at base + r·25.
struct FeRows {
  int* base;
  __device__ __forceinline__ int* operator()(int r) const {
    return base + r * NL;
  }
};

// Phase: the fold and the three last rounds of normalize<25> over rows
// after two rounds (row r at t2 + r·27) into out(r). A lane computes CW
// limbs of a row, folding the CW + 3 limbs they need itself.
template <int CW, class Out>
__device__ __forceinline__ void fe_fold_three(int rows, const int* t2,
                                              Out out) {
  constexpr int NCH = (NL + CW - 1) / CW;
  fe_phase<NCH>(rows, [&](auto chunk, int r) {
    constexpr int L0 = decltype(chunk)::value * CW, LO = L0 - 3;
    const int* v = t2 + r * FE_Z1;
    int hi[FE_Z1 - FB];
#pragma unroll
    for (int h = 0; h < FE_Z1 - FB; ++h) hi[h] = v[FB + h];
    int a[CW + 3];
#pragma unroll
    for (int d = 0; d < CW + 3; ++d) a[d] = folded_limb(v, hi, LO + d);
    window_rounds<3, LO, NL - 1>(a);
    auto* o = out(r);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < NL) o[L0 + d] = a[3 + d];
  });
}

// Phase: the three last rounds of folded rows (row r at acc + r·22) into
// out(r), CW limbs per lane.
template <int CW, class Out>
__device__ __forceinline__ void fe_three_rounds(int rows, const int* acc,
                                                Out out) {
  constexpr int NCH = (NL + CW - 1) / CW;
  fe_phase<NCH>(rows, [&](auto chunk, int r) {
    constexpr int L0 = decltype(chunk)::value * CW, LO = L0 - 3;
    int a[CW + 3];
#pragma unroll
    for (int d = 0; d < CW + 3; ++d) a[d] = acc_limb(acc + r * FB, LO + d);
    window_rounds<3, LO, NL - 1>(a);
    auto* o = out(r);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < NL) o[L0 + d] = a[3 + d];
  });
}

// The combination of a merge: limb l of row r from the two operands'
// limbs, a + b by default.
struct FeAdd {
  __device__ __forceinline__ int operator()(int, int, int a, int b) const {
    return a + b;
  }
};

// Phase: normalize<25> of rows fe_row(in, r) into out(r),
// all in one phase: a lane computes CW output limbs of a row through both
// rounds, the fold and the three last rounds in registers, from the input
// limbs of its window (L0 - 5 .. L0 + CW) and the five that the fold's
// high limbs come from (20 .. 24).
template <int CW, class In, class Out>
__device__ __forceinline__ void fe_normalize25(int rows, In in, Out out) {
  constexpr int NCH = (NL + CW - 1) / CW, NH = FE_Z1 - FB;
  fe_phase<NCH>(rows, [&](auto chunk, int r) {
    constexpr int L0 = decltype(chunk)::value * CW, LO = L0 - 5;
    auto row = fe_row(in, r);
    int h[NH + 2];  // limbs 20..26, then 22..26 after two rounds
#pragma unroll
    for (int d = 0; d < NH + 2; ++d)
      h[d] = FB - 2 + d < NL ? row(FB - 2 + d) : 0;
    window_rounds<2, FB - 2, FE_Z1 - 1>(h);
    int a[CW + 5];
#pragma unroll
    for (int d = 0; d < CW + 5; ++d) {
      const int l = LO + d;
      a[d] = (l >= 0 && l < NL) ? row(l) : 0;
    }
    window_rounds<2, LO, FE_Z1 - 1>(a);
    int f[CW + 3];  // folded limbs L0 - 3 ..
#pragma unroll
    for (int d = 0; d < CW + 3; ++d) {
      const int l = L0 - 3 + d;
      if (l < 0 || l >= NL) {
        f[d] = 0;
      } else if (l >= FB) {
        f[d] = fe_lift_c[l];
      } else {
        int s = a[d + 2] + fe_lift_c[l];
#pragma unroll
        for (int k = 0; k < NH; ++k) s += h[k + 2] * fe_fold_c[k * FB + l];
        f[d] = s;
      }
    }
    window_rounds<3, L0 - 3, NL - 1>(f);
    auto* o = out(r);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < NL) o[L0 + d] = f[3 + d];
  });
}

// Phase: a group merge, the first two rounds of normalize<25> of the sum
// (or of comb(r, l, p_l, q_l)) of two normalized rows into t2 (row r at
// t2 + r·27). Each operand is given before its three last rounds: q(r) a
// folded row (22 limbs); p(r) the same, or, where P_T2, a row after two
// rounds (27 limbs) that the lane folds itself. A lane takes CW limbs:
// it needs the sum at CW + 2 limbs, so each operand's three rounds run
// over a window of CW + 5.
template <int CW, bool P_T2, class P, class Q, class Comb = FeAdd>
__device__ __forceinline__ void fe_merge(int rows, P p, Q q, int* t2,
                                         Comb comb = Comb()) {
  constexpr int NCH = (FE_Z1 + CW - 1) / CW, N = CW + 5;
  fe_phase<NCH>(rows, [&](auto chunk, int r) {
    constexpr int L0 = decltype(chunk)::value * CW, LO = L0 - 5;
    const int* pv = p(r);
    const int* qv = q(r);
    int a[N], b[N];
    if constexpr (P_T2) {
      int hi[FE_Z1 - FB];
#pragma unroll
      for (int h = 0; h < FE_Z1 - FB; ++h) hi[h] = pv[FB + h];
#pragma unroll
      for (int d = 0; d < N; ++d) a[d] = folded_limb(pv, hi, LO + d);
    } else {
#pragma unroll
      for (int d = 0; d < N; ++d) a[d] = acc_limb(pv, LO + d);
    }
#pragma unroll
    for (int d = 0; d < N; ++d) b[d] = acc_limb(qv, LO + d);
    window_rounds<3, LO, NL - 1>(a);
    window_rounds<3, LO, NL - 1>(b);
    int m[CW + 2];
#pragma unroll
    for (int d = 0; d < CW + 2; ++d) {
      const int l = LO + 3 + d;
      m[d] = (l >= 0 && l < NL) ? comb(r, l, a[d + 3], b[d + 3]) : 0;
    }
    window_rounds<2, LO + 3, FE_Z1 - 1>(m);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < FE_Z1) t2[r * FE_Z1 + L0 + d] = m[d + 2];
  });
}

// The 49 schoolbook columns of U ⊛ V into lo (0..24) and hi (25..48):
// column q takes U[l]·V[q - l] for l <= q, column q + 25 the products
// U[l]·V[q + 25 - l] for l > q. Every index is a compile-time constant,
// so a multiply-add is one instruction on registers.
__device__ __forceinline__ void fe_schoolbook(const int (&U)[NL],
                                              const int (&V)[NL],
                                              int (&lo)[NL],
                                              int (&hi)[NL - 1]) {
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    int a = 0, b = 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (l <= q)
        a += U[l] * V[q - l];
      else
        b += U[l] * V[q + NL - l];
    }
    lo[q] = a;
    if (q < NL - 1) hi[q] = b;
  }
}

// Columns [Q0, Q1) of U ⊛ V into z[Q0..Q1), U and V limb l given by
// u(l), v(l): only the limbs those columns use are loaded, every index a
// compile-time constant.
template <int Q0, int Q1, class UF, class VF>
__device__ __forceinline__ void fe_schoolbook_cols(UF u, VF v, int* z) {
  constexpr int L0 = Q0 > NL - 1 ? Q0 - (NL - 1) : 0;
  constexpr int L1 = Q1 - 1 < NL - 1 ? Q1 - 1 : NL - 1;
  constexpr int N = L1 - L0 + 1;
  int U[N], V[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    U[i] = u(L0 + i);
    V[i] = v(L0 + i);
  }
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    int acc = 0;
#pragma unroll
    for (int l = L0; l <= L1; ++l)
      if (q - l >= L0 && q - l <= L1) acc += U[l - L0] * V[q - l - L0];
    z[q] = acc;
  }
}

// Column boundaries of a schoolbook split into S parts of about equal
// multiply-adds (column q has min(q + 1, 49 - q) terms).
template <int S>
struct FeSplit;
template <>
struct FeSplit<2> {
  static constexpr int q[3] = {0, NL, NC};
};

// fe_products with every schoolbook split into S work items of a column
// range each (FeSplit<S>), so an item holds fewer operands and
// accumulators in registers; items run part-major, rows padded to warps.
template <int NP, int S, class T = int, class AB>
__device__ __forceinline__ void fe_products_split(int rows, AB ab,
                                                  int* part) {
  fe_phase<NP * S>(rows, [&](auto g, int r) {
    constexpr int p = decltype(g)::value / S, s = decltype(g)::value % S;
    const T* a;
    const T* b;
    ab(r, a, b);
    // Karatsuba (NP = 3): a0, a1, a0 + a1; four products: a_{p/2} b_{p%2}
    auto u = [&](int l) {
      if constexpr (NP == 3)
        return p == 2 ? a[l] + a[NL + l] : a[p * NL + l];
      else
        return a[(p >> 1) * NL + l];
    };
    auto v = [&](int l) {
      if constexpr (NP == 3)
        return p == 2 ? b[l] + b[NL + l] : b[p * NL + l];
      else
        return b[(p & 1) * NL + l];
    };
    fe_schoolbook_cols<FeSplit<S>::q[s], FeSplit<S>::q[s + 1]>(
        u, v, part + (p * rows + r) * NC);
  });
}

// Phase: the schoolbook products of NP-fold products a·b, one product
// row r each, into part + (p·rows + r)·49; ab(r, a, b) gives the
// operands. A work item is one schoolbook of one row: a whole 25 × 25
// schoolbook, both operands in registers. NP = 1: an Fp product. NP = 3:
// an Fp2 product by Karatsuba, the three products P = a0 ⊛ b0,
// Q = a1 ⊛ b1 and R = (a0 + a1) ⊛ (b0 + b1) (p = 0, 1, 2; P and Q add a
// zero row, so every item runs the same code); a·b's columns are then
// P - Q and R - P - Q, the exact columns of the plain version's four
// products (R's columns stay below 25 · 8320^2 < 2^31 for quasi-canonical
// limbs). NP = 4: an Fp2 product as the four products a_c ⊛ b_d
// (p = 2c + d), for the Frobenius map's 12 rows: its phase runs on two
// warps either way, so Karatsuba's extra operand loads and additions
// would cost more than the fourth product saves. T is the type the
// operands are stored in; S > 1 splits every schoolbook (S = 2 only).
template <int NP, int S = 1, class T = int, class AB>
__device__ __forceinline__ void fe_products(int rows, AB ab, int* part,
                                            const T* zero) {
  static_assert(NP == 1 || NP == 3 || NP == 4, "1, 3 or 4 products");
  if constexpr (S > 1) {
    fe_products_split<NP, S, T>(rows, ab, part);
    return;
  }
  for (int t = threadIdx.x; t < NP * rows; t += blockDim.x) {
    const int p = t / rows, r = t - p * rows;
    const T* a;
    const T* b;
    ab(r, a, b);
    int U[NL], V[NL];
    if constexpr (NP == 3) {
      const T* u = p == 1 ? a + NL : a;
      const T* v = p == 1 ? b + NL : b;
      const T* u2 = p == 2 ? a + NL : zero;
      const T* v2 = p == 2 ? b + NL : zero;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        U[l] = u[l] + u2[l];
        V[l] = v[l] + v2[l];
      }
    } else {
      const T* u = a + (p >> 1) * NL;
      const T* v = b + (p & 1) * NL;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        U[l] = u[l];
        V[l] = v[l];
      }
    }
    int lo[NL], hi[NL - 1];
    fe_schoolbook(U, V, lo, hi);
    int* z = part + t * NC;
#pragma unroll
    for (int q = 0; q < NL; ++q) z[q] = lo[q];
#pragma unroll
    for (int q = 0; q < NL - 1; ++q) z[NL + q] = hi[q];
  }
  __syncthreads();
}

// Component c of the product of row r (the products of `fe_products<NP>`
// in `part`, `rows` rows each) as a function of the column, for NP = 1
// (c = 0), 3 or 4.
template <int NP>
__device__ __forceinline__ auto fe_column_row(const int* part, int rows,
                                              int r, int c) {
  const int* P = part + r * NC;
  const int* Q = P + rows * NC;
  const int* R = Q + rows * NC;
  const int* S = R + rows * NC;
  return [=](int l) {
    if constexpr (NP == 1)
      return P[l];
    else if constexpr (NP == 3)
      return c == 0 ? P[l] - Q[l] : R[l] - P[l] - Q[l];
    else
      return c == 0 ? P[l] - S[l] : Q[l] + R[l];
  };
}

// Column l of component c of the Fp2 product of row r, read directly
// (NP = 3 or 4): the final exponentiation's product reads two per limb,
// and defining this through fe_column_row made its product step 3%
// slower on the H100 (chip_smoke.py's per-step time).
template <int NP>
__device__ __forceinline__ int fe_column(const int* part, int rows, int r,
                                         int c, int l) {
  if constexpr (NP == 3) {
    const int P = part[r * NC + l], Q = part[(rows + r) * NC + l];
    return c == 0 ? P - Q : part[(2 * rows + r) * NC + l] - P - Q;
  } else {
    return c == 0 ? part[r * NC + l] - part[(3 * rows + r) * NC + l]
                  : part[(rows + r) * NC + l] + part[(2 * rows + r) * NC + l];
  }
}

// out = x·y for both fractions (x, y, out: 2 · 300 ints); `out` may
// alias x or y. As `fp12_mul`: xi·y; per (fraction, k, component, group
// of two i) the padded cyclic-convolution columns; their normalize; the
// merges (g0 + g1), then (that + g2), each normalized.
static __device__ void fe_mul(const int* x, const int* y, int* out,
                              FeScratch S, const int* T) {
  fe_two_rounds<NL, FE_CW_Z1>(FE_ROWS12, [&](int r, int l) {
    const int* a = y + (r & ~1) * NL;
    return (r & 1) == 0 ? a[l] * 9 - a[NL + l] + T[C_NEG + l]
                        : a[l] + a[NL + l] * 9;
  }, S.t2);
  fe_fold_three<FE_CW_OUT>(FE_ROWS12, S.t2, FeRows{S.xi});
  // product row r = ((f·6 + k)·3 + g)·2 + ii: x_i times its operand of
  // y or xi·y for i = 2g + ii; accumulator ((f·6 + k)·2 + c)·3 + g adds
  // the rows of ii = 0, 1, and the pad to component 0
  fe_products<3>(FE_ROWS36, [&](int r, const int*& a, const int*& b) {
    const int ii = r % 2, g = (r / 2) % 3, k = (r / 6) % 6, f = r / 36;
    const int i = 2 * g + ii;
    a = x + f * FP12 + i * 2 * NL;
    b = (i <= k ? y : S.xi) + f * FP12 + ((k - i + 6) % 6) * 2 * NL;
  }, S.part, S.zero);
  fe_two_rounds<NC, FE_CW_Z2>(FE_ROWS36, [&](int r, int l) {
    const int g = r % 3, c = (r / 3) % 2, fk = r / 6;
    const int row = (fk * 3 + g) * 2;
    return (c == 0 ? T[C_PAD + l] : 0) +
           fe_column<3>(S.part, FE_ROWS36, row, c, l) +
           fe_column<3>(S.part, FE_ROWS36, row + 1, c, l);
  }, S.t2);
  fe_fold<NC>(FE_ROWS36, S.t2, S.acc, T);
  fe_merge<FE_CW_MERGE, false>(FE_ROWS12, [&](int r) { return S.acc + 3 * r * FB; },
                     [&](int r) { return S.acc + (3 * r + 1) * FB; }, S.t2m);
  fe_merge<FE_CW_MERGE, true>(FE_ROWS12, [&](int r) { return S.t2m + r * FE_Z1; },
                    [&](int r) { return S.acc + (3 * r + 2) * FB; }, S.t2);
  fe_fold_three<FE_CW_OUT>(FE_ROWS12, S.t2, FeRows{out});
}

// out = x^(p^np), np in {1, 2, 3}, for both fractions; `out` may alias
// x. As `_frob`: conjugate when np is odd, normalize, then multiply
// coefficient k by gamma_{np,k} (padded columns, one normalize).
static __device__ void fe_frob(const int* x, int np, int* out, FeScratch S,
                               const int* T) {
  const bool odd = (np % 2) == 1;
  fe_two_rounds<NL, FE_CW_Z1>(FE_ROWS12, [&](int r, int l) {
    const int v = x[r * NL + l];
    return odd && (r & 1) ? T[C_NEG + l] - v : v;
  }, S.t2);
  fe_fold_three<FE_CW_OUT>(FE_ROWS12, S.t2, FeRows{S.xi});
  const int* gamma = T + C_GAMMA + (np - 1) * FP12;
  // product row r = f·6 + k: coefficient k times gamma_k; accumulator
  // 2r + c, padded in component 0
  fe_products<4>(FE_ROWS12 / 2, [&](int r, const int*& a,
                                     const int*& b) {
    a = S.xi + r * 2 * NL;
    b = gamma + (r % 6) * 2 * NL;
  }, S.part, S.zero);
  fe_two_rounds<NC, FE_CW_Z2>(FE_ROWS12, [&](int r, int l) {
    const int c = r % 2;
    return (c == 0 ? T[C_PAD + l] : 0) +
           fe_column<4>(S.part, FE_ROWS12 / 2, r / 2, c, l);
  }, S.t2);
  fe_fold<NC>(FE_ROWS12, S.t2, S.acc, T);
  fe_three_rounds<FE_CW_OUT>(FE_ROWS12, S.acc, FeRows{out});
}

}  // namespace gs
