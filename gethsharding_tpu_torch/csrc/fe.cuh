// Block-cooperative device code for Fp12 steps and their normalizes,
// spread over lanes: the final exponentiation's steps (product, Frobenius
// map), the Miller product's square and sparse line products (FeMul over
// any count of fractions, FeMulLine) and the committee sums of
// csrc/agg.cu run their phases on these helpers (a 25-limb normalize in
// one phase, fe_normalize25; Fp products and split schoolbooks,
// fe_products; rows that an input binds once per item, fe_row; outputs
// through a row functor, in int16 there).
//
// Each step computes what the plain versions `_fp12_mul`,
// `_fp12_mul_line` and `_frob` of ops/megakernels.py compute, the same
// int32 values at every normalize's input, so it returns the same limbs;
// only the schedule and the multiplication differ:
// - the columns of an Fp12 product's Fp2 products a·b come from three
//   schoolbook products instead of four (Karatsuba): P = a0 ⊛ b0,
//   Q = a1 ⊛ b1, R = (a0 + a1) ⊛ (b0 + b1), component 0 = P - Q and
//   component 1 = R - P - Q; the Frobenius map's 12 keep the four
//   products. A column is an exact integer below 2^30.7 in magnitude
//   whatever the order of its terms, so the accumulators are those of
//   the plain version. A work item is one whole 25 × 25 schoolbook with
//   both operands in registers and every index a compile-time constant,
//   so a multiply-add is one instruction and every item runs the same
//   code (a kernel may split it through its School);
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
//   Frobenius map 6, a sparse line product 5 after xi·f.
// Lanes that run compile-time variants (a chunk of limbs) run them
// chunk-major with the rows padded to whole warps, so the lanes of a warp
// run the same code; with run-time chunks (RT) one copy of the code
// serves every chunk and the lanes pack densely. Every phase is a
// block-stride loop ending in __syncthreads() (fe_run; a phase's parts
// may come from independent work), and no item of a phase reads what
// another item of the same phase writes, so one thread running every
// item in order is a legal schedule too.
#pragma once

#include <type_traits>

#include "field.cuh"

namespace gs {

constexpr int FE_THREADS = 512;   // threads per block of the fe.cuh kernels
constexpr int FE_Z1 = NL + 2;     // width of a 25-limb normalize's rounds
constexpr int FE_Z2 = NC + 2;     // width of a 49-column normalize's rounds
constexpr int FE_FOLD_SLOTS = 23; // row slots of a 49-column fold
// limbs per lane in the phases of rounds (chunk widths)
constexpr int FE_CW_Z1 = 7;       // two rounds of a 25-limb normalize
constexpr int FE_CW_Z2 = 11;      // two rounds of a 49-column normalize
constexpr int FE_CW_OUT = 5;      // fold and three rounds into 25 limbs
constexpr int FE_CW_MERGE = 7;    // group merges

// Scratch of one block's Fp12 products over NF fractions, in shared
// memory (ints): a product x·y has 12·NF rows of operand and 36·NF
// accumulators.
struct FeScratch {
  int* xi;    // 12·NF rows of 25: xi·y, or the Frobenius input
  int* zero;  // one row of 25 zeros
  int* part;  // 3 × 36·NF rows of 49: the schoolbook products' columns
  int* t2;    // 36·NF rows of up to 51: after two rounds
  int* acc;   // 36·NF rows of 22: folded columns
  int* t2m;   // 12·NF rows of 27: the first merge after two rounds
};

template <int NF>
__host__ __device__ constexpr int fe_scratch_ints() {
  return 12 * NF * NL + NL + 3 * 36 * NF * NC + 36 * NF * FE_Z2 +
         36 * NF * FB + 12 * NF * FE_Z1;
}

// Lays the scratch of NF fractions out from `base`; returns its end.
template <int NF>
__device__ __forceinline__ int* fe_scratch(int* base, FeScratch& S) {
  S.xi = base;
  S.zero = S.xi + 12 * NF * NL;
  S.part = S.zero + NL;
  S.t2 = S.part + 3 * 36 * NF * NC;
  S.acc = S.t2 + 36 * NF * FE_Z2;
  S.t2m = S.acc + 36 * NF * FB;
  return S.t2m + 12 * NF * FE_Z1;
}

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

// Linear operations of a register machine (csrc/agg.cu, csrc/miller.cu):
// d = normalize(a·ka + b·kb + negpad·kn), the coefficients by the op.
enum Op : unsigned char {
  ADD,  // d = a + b
  SUB,  // d = a - b (+ negpad)
  NEG,  // d = -a (+ negpad)
  SCL,  // d = b·a, b a small constant
  CPY,  // d = normalize(a)
  CNJ,  // d = conj(a): (a0, -a1)
};

struct Ins {
  unsigned char op, a, b, d;
};

template <int V>
struct FeInt {
  static constexpr int value = V;
  __device__ __forceinline__ constexpr operator int() const { return V; }
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

// A part of a phase: n work items, f(u) runs item u < n. n is a multiple
// of 32 wherever another part may follow, so that a warp runs one part.
template <class F>
struct FePart {
  int n;
  F f;
};

template <class F>
__device__ __forceinline__ FePart<F> fe_part(int n, F f) {
  return {n, f};
}

template <class P, class... Ps>
__device__ __forceinline__ void fe_item(int u, const P& p, const Ps&... ps) {
  if constexpr (sizeof...(Ps) == 0) {
    p.f(u);
  } else {
    if (u < p.n)
      p.f(u);
    else
      fe_item(u - p.n, ps...);
  }
}

// One phase: the items of every part in one block-stride loop, then a
// barrier. Parts that share a phase must not read what another writes.
template <class... Ps>
__device__ __forceinline__ void fe_run(const Ps&... ps) {
  const int n = (ps.n + ...);
  for (int t = threadIdx.x; t < n; t += blockDim.x) fe_item(t, ps...);
  __syncthreads();
}

// A part over G groups × `rows` rows, group-major: f(FeInt<group>, r),
// the group a compile-time constant, with the rows padded to whole warps
// so that the lanes of a warp share it and each group runs its own copy
// of the code; with RT, f(group, r), the group an int: one copy of the
// code serves every group, and the items pack densely, so a phase of
// few rows takes few warps and few shared-memory wavefronts.
template <int G, bool RT = false, class F>
__device__ __forceinline__ auto fe_rows(int rows, F f) {
  if constexpr (RT) {
    const int items = G * rows;
    return fe_part((items + 31) & ~31, [=](int t) {
      if (t >= items) return;
      const int g = t / rows;
      f(g, t - g * rows);
    });
  } else {
    const int rp = (rows + 31) & ~31;
    return fe_part(G * rp, [=](int t) {
      const int g = t / rp, r = t - g * rp;
      if (r < rows) fe_dispatch<G>(g, [&](auto gc) { f(gc, r); });
    });
  }
}

// a[d] holds limb lo + d of a row (zero below limb 0). K relaxed rounds
// in place: afterwards a[d] is that limb after K rounds for d >= K
// (entries below are stale). Limb `top` keeps its own carry; entries past
// it are not limbs of the row, and nothing below them reads them. Where
// lo and top are constants after inlining, the comparisons fold away.
template <int K, int N>
__device__ __forceinline__ void fe_window_rounds(int (&a)[N], int lo,
                                                 int top) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int d = N - 1; d > r; --d) {
      const int v = a[d];
      a[d] = (lo + d == top ? v : (v & LM)) + (a[d - 1] >> LB);
    }
  }
}

// Where a lane-spread phase reads the fold rows and the lift: the
// constant bank, at compile-time indices; or, with RT (a chunk of limbs
// chosen at run time), the block's shared copy T of the constant pack,
// since the constant bank serializes loads at run-time indices.
template <bool RT>
struct FeK {
  const int* T;
  __device__ __forceinline__ int lift(int l) const {
    if constexpr (RT)
      return T[C_LIFT + l];
    else
      return fe_lift_c[l];
  }
  __device__ __forceinline__ int fold(int h, int l) const {
    if constexpr (RT)
      return T[C_FOLD + h * FB + l];
    else
      return fe_fold_c[h * FB + l];
  }
};

// Folded limb l of a 25-limb row after two rounds (v: its 27 limbs; hi:
// its limbs 22..26): z_l + lift_l + the sum over h of z_{22+h} ·
// fold[h][l] below 22, the lift alone from 22 to 24, zero outside the
// row.
template <bool RT>
__device__ __forceinline__ int folded_limb(const int* v,
                                           const int (&hi)[FE_Z1 - FB],
                                           int l, FeK<RT> K) {
  if (l < 0 || l >= NL) return 0;
  if (l >= FB) return K.lift(l);
  int s = v[l] + K.lift(l);
#pragma unroll
  for (int h = 0; h < FE_Z1 - FB; ++h) s += hi[h] * K.fold(h, l);
  return s;
}

// Limb l of a row already folded (22 stored limbs): the lift above them,
// zero outside the row.
template <bool RT>
__device__ __forceinline__ int acc_limb(const int* acc, int l, FeK<RT> K) {
  if (l < 0 || l >= NL) return 0;
  return l < FB ? acc[l] : K.lift(l);
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

// Each phase helper below comes in two forms: `fe_x_part(...)` returns
// the phase as a part, so that independent work can share its barrier
// (fe_run(part, part, ...)); `fe_x(...)` runs it as a phase of its own.

// The first two rounds of normalize<W> on rows of W limbs, fe_row(in, r),
// into t2 (row r at t2 + r·(W + 2)). A lane computes CW consecutive limbs
// of a row from a window of CW + 2 inputs.
template <int W, int CW, bool RT = false, class In>
__device__ __forceinline__ auto fe_two_rounds_part(int rows, In in, int* t2) {
  constexpr int Z = W + 2, NCH = (Z + CW - 1) / CW;
  return fe_rows<NCH, RT>(rows, [=](auto chunk, int r) {
    const int L0 = int(chunk) * CW, LO = L0 - 2;
    auto row = fe_row(in, r);
    int a[CW + 2];
#pragma unroll
    for (int d = 0; d < CW + 2; ++d) {
      const int l = LO + d;
      a[d] = (l >= 0 && l < W) ? row(l) : 0;
    }
    fe_window_rounds<2>(a, LO, Z - 1);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < Z) t2[r * Z + L0 + d] = a[2 + d];
  });
}

template <int W, int CW, class In>
__device__ __forceinline__ void fe_two_rounds(int rows, In in, int* t2) {
  fe_run(fe_two_rounds_part<W, CW>(rows, in, t2));
}

// The fold of normalize<W> over rows after two rounds (row r at
// t2 + r·(W + 2)) into acc (row r at acc + r·22; the lift above 22 is
// added by the readers). A lane keeps two limbs j, j + 1 with their fold
// columns in registers and walks every FE_FOLD_SLOTS-th row, so each
// high limb it loads serves two multiply-adds.
template <int W>
__device__ __forceinline__ auto fe_fold_part(int rows, const int* t2,
                                             int* acc, const int* T) {
  constexpr int Z = W + 2, NH = Z - FB, JP = FB / 2;
  static_assert(NH <= FR, "accumulator too wide");
  const int lanes = JP * (rows < FE_FOLD_SLOTS ? rows : FE_FOLD_SLOTS);
  return fe_part((lanes + 31) & ~31, [=](int t) {
    if (t >= lanes) return;
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
  });
}

template <int W>
__device__ __forceinline__ void fe_fold(int rows, const int* t2, int* acc,
                                        const int* T) {
  fe_run(fe_fold_part<W>(rows, t2, acc, T));
}

// Output rows of a phase: row r at base + r·25.
struct FeRows {
  int* base;
  __device__ __forceinline__ int* operator()(int r) const {
    return base + r * NL;
  }
};

// The fold and the three last rounds of normalize<25> over rows after two
// rounds (row r at t2 + r·27) into out(r). A lane computes CW limbs of a
// row, folding the CW + 3 limbs they need itself.
template <int CW, bool RT = false, class Out>
__device__ __forceinline__ auto fe_fold_three_part(int rows, const int* t2,
                                                   Out out,
                                                   const int* T = nullptr) {
  constexpr int NCH = (NL + CW - 1) / CW;
  const FeK<RT> K{T};
  return fe_rows<NCH, RT>(rows, [=](auto chunk, int r) {
    const int L0 = int(chunk) * CW, LO = L0 - 3;
    const int* v = t2 + r * FE_Z1;
    int hi[FE_Z1 - FB];
#pragma unroll
    for (int h = 0; h < FE_Z1 - FB; ++h) hi[h] = v[FB + h];
    int a[CW + 3];
#pragma unroll
    for (int d = 0; d < CW + 3; ++d) a[d] = folded_limb(v, hi, LO + d, K);
    fe_window_rounds<3>(a, LO, NL - 1);
    auto* o = out(r);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < NL) o[L0 + d] = a[3 + d];
  });
}

template <int CW, class Out>
__device__ __forceinline__ void fe_fold_three(int rows, const int* t2,
                                              Out out) {
  fe_run(fe_fold_three_part<CW>(rows, t2, out));
}

// The three last rounds of folded rows (row r at acc + r·22) into out(r),
// CW limbs per lane.
template <int CW, bool RT = false, class Out>
__device__ __forceinline__ auto fe_three_rounds_part(int rows, const int* acc,
                                                     Out out,
                                                     const int* T = nullptr) {
  constexpr int NCH = (NL + CW - 1) / CW;
  const FeK<RT> K{T};
  return fe_rows<NCH, RT>(rows, [=](auto chunk, int r) {
    const int L0 = int(chunk) * CW, LO = L0 - 3;
    int a[CW + 3];
#pragma unroll
    for (int d = 0; d < CW + 3; ++d) a[d] = acc_limb(acc + r * FB, LO + d, K);
    fe_window_rounds<3>(a, LO, NL - 1);
    auto* o = out(r);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < NL) o[L0 + d] = a[3 + d];
  });
}

template <int CW, class Out>
__device__ __forceinline__ void fe_three_rounds(int rows, const int* acc,
                                                Out out) {
  fe_run(fe_three_rounds_part<CW>(rows, acc, out));
}

// The combination of a merge: limb l of row r from the two operands'
// limbs, a + b by default.
struct FeAdd {
  __device__ __forceinline__ int operator()(int, int, int a, int b) const {
    return a + b;
  }
};

// normalize<25> of rows fe_row(in, r) into out(r), all in one phase: a
// lane computes CW output limbs of a row through both rounds, the fold
// and the three last rounds in registers, from the input limbs of its
// window (L0 - 5 .. L0 + CW) and the five that the fold's high limbs come
// from (20 .. 24).
template <int CW, bool RT = false, class In, class Out>
__device__ __forceinline__ auto fe_normalize25_part(int rows, In in,
                                                    Out out,
                                                    const int* T = nullptr) {
  constexpr int NCH = (NL + CW - 1) / CW, NH = FE_Z1 - FB;
  const FeK<RT> K{T};
  return fe_rows<NCH, RT>(rows, [=](auto chunk, int r) {
    const int L0 = int(chunk) * CW, LO = L0 - 5;
    auto row = fe_row(in, r);
    int h[NH + 2];  // limbs 20..26, then 22..26 after two rounds
#pragma unroll
    for (int d = 0; d < NH + 2; ++d)
      h[d] = FB - 2 + d < NL ? row(FB - 2 + d) : 0;
    fe_window_rounds<2>(h, FB - 2, FE_Z1 - 1);
    int a[CW + 5];
#pragma unroll
    for (int d = 0; d < CW + 5; ++d) {
      const int l = LO + d;
      a[d] = (l >= 0 && l < NL) ? row(l) : 0;
    }
    fe_window_rounds<2>(a, LO, FE_Z1 - 1);
    int f[CW + 3];  // folded limbs L0 - 3 ..
#pragma unroll
    for (int d = 0; d < CW + 3; ++d) {
      const int l = L0 - 3 + d;
      if (l < 0 || l >= NL) {
        f[d] = 0;
      } else if (l >= FB) {
        f[d] = K.lift(l);
      } else {
        int s = a[d + 2] + K.lift(l);
#pragma unroll
        for (int k = 0; k < NH; ++k) s += h[k + 2] * K.fold(k, l);
        f[d] = s;
      }
    }
    fe_window_rounds<3>(f, L0 - 3, NL - 1);
    auto* o = out(r);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < NL) o[L0 + d] = f[3 + d];
  });
}

template <int CW, class In, class Out>
__device__ __forceinline__ void fe_normalize25(int rows, In in, Out out) {
  fe_run(fe_normalize25_part<CW>(rows, in, out));
}

// A group merge, the first two rounds of normalize<25> of the sum (or of
// comb(r, l, p_l, q_l)) of two normalized rows into t2 (row r at
// t2 + r·27). Each operand is given before its three last rounds: q(r) a
// folded row (22 limbs); p(r) the same, or, where P_T2, a row after two
// rounds (27 limbs) that the lane folds itself. A lane takes CW limbs:
// it needs the sum at CW + 2 limbs, so each operand's three rounds run
// over a window of CW + 5.
template <int CW, bool P_T2, bool RT = false, class P, class Q,
          class Comb = FeAdd>
__device__ __forceinline__ auto fe_merge_part(int rows, P p, Q q, int* t2,
                                              Comb comb = Comb(),
                                              const int* T = nullptr) {
  constexpr int NCH = (FE_Z1 + CW - 1) / CW, N = CW + 5;
  const FeK<RT> K{T};
  return fe_rows<NCH, RT>(rows, [=](auto chunk, int r) {
    const int L0 = int(chunk) * CW, LO = L0 - 5;
    const int* pv = p(r);
    const int* qv = q(r);
    int a[N], b[N];
    if constexpr (P_T2) {
      int hi[FE_Z1 - FB];
#pragma unroll
      for (int h = 0; h < FE_Z1 - FB; ++h) hi[h] = pv[FB + h];
#pragma unroll
      for (int d = 0; d < N; ++d) a[d] = folded_limb(pv, hi, LO + d, K);
    } else {
#pragma unroll
      for (int d = 0; d < N; ++d) a[d] = acc_limb(pv, LO + d, K);
    }
#pragma unroll
    for (int d = 0; d < N; ++d) b[d] = acc_limb(qv, LO + d, K);
    fe_window_rounds<3>(a, LO, NL - 1);
    fe_window_rounds<3>(b, LO, NL - 1);
    int m[CW + 2];
#pragma unroll
    for (int d = 0; d < CW + 2; ++d) {
      const int l = LO + 3 + d;
      m[d] = (l >= 0 && l < NL) ? comb(r, l, a[d + 3], b[d + 3]) : 0;
    }
    fe_window_rounds<2>(m, LO + 3, FE_Z1 - 1);
#pragma unroll
    for (int d = 0; d < CW; ++d)
      if (L0 + d < FE_Z1) t2[r * FE_Z1 + L0 + d] = m[d + 2];
  });
}

template <int CW, bool P_T2, class P, class Q, class Comb = FeAdd>
__device__ __forceinline__ void fe_merge(int rows, P p, Q q, int* t2,
                                         Comb comb = Comb()) {
  fe_run(fe_merge_part<CW, P_T2>(rows, p, q, t2, comb));
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

// U ⊛ V into z (49 columns).
__device__ __forceinline__ void fe_store_schoolbook(const int (&U)[NL],
                                                    const int (&V)[NL],
                                                    int* z) {
  int lo[NL], hi[NL - 1];
  fe_schoolbook(U, V, lo, hi);
#pragma unroll
  for (int q = 0; q < NL; ++q) z[q] = lo[q];
#pragma unroll
  for (int q = 0; q < NL - 1; ++q) z[NL + q] = hi[q];
}

// (u + u2) ⊛ (v + v2), u2 and v2 a row or zeros, into z (49 columns).
template <class T>
__device__ __forceinline__ void fe_schoolbook_rows(const T* u, const T* u2,
                                                   const T* v, const T* v2,
                                                   int* z) {
  int U[NL], V[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    U[l] = u[l] + u2[l];
    V[l] = v[l] + v2[l];
  }
  fe_store_schoolbook(U, V, z);
}

// A product item's schoolbook, (u + u2) ⊛ (v + v2) into z, inline. A
// kernel that runs products from many phases passes its own, one
// non-inlined copy, to keep its code small.
// A School may also split a Karatsuba item into PARTS items, part<k>
// computing its share of the columns; the parts run as warp-uniform
// groups, so one product's work spreads over more warps.
struct FeSchool {
  static constexpr int PARTS = 1;
  template <class T>
  __device__ __forceinline__ void operator()(const T* u, const T* u2,
                                             const T* v, const T* v2,
                                             int* z) const {
    fe_schoolbook_rows(u, u2, v, v2, z);
  }
};

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
__device__ __forceinline__ auto fe_products_split_part(int rows, AB ab,
                                                       int* part) {
  return fe_rows<NP * S>(rows, [=](auto g, int r) {
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

// The schoolbook products of NP-fold products a·b, one product row r
// each, into part + (p·rows + r)·49; ab(r, a, b) gives the operands. A
// work item is one schoolbook of one row: a whole 25 × 25 schoolbook,
// both operands in registers. NP = 1: an Fp product. NP = 3: an Fp2
// product by Karatsuba, the three products P = a0 ⊛ b0, Q = a1 ⊛ b1 and
// R = (a0 + a1) ⊛ (b0 + b1) (p = 0, 1, 2; P and Q add a zero row, so
// every item runs the same code); a·b's columns are then P - Q and
// R - P - Q, the exact columns of the plain version's four products (R's
// columns stay below 25 · 8320^2 < 2^31 for quasi-canonical limbs).
// NP = 4: an Fp2 product as the four products a_c ⊛ b_d (p = 2c + d),
// for the Frobenius map's 12 rows: its phase runs on two warps either
// way, so Karatsuba's extra operand loads and additions would cost more
// than the fourth product saves. T is the type the operands are stored
// in; S > 1 splits every schoolbook (S = 2 only); `school` runs a
// Karatsuba item's schoolbook.
template <int NP, int S = 1, class T = int, class AB, class School = FeSchool>
__device__ __forceinline__ auto fe_products_part(int rows, AB ab, int* part,
                                                 const T* zero,
                                                 School school = School()) {
  static_assert(NP == 1 || NP == 3 || NP == 4, "1, 3 or 4 products");
  if constexpr (S > 1) {
    return fe_products_split_part<NP, S, T>(rows, ab, part);
  } else {
    constexpr int K = School::PARTS;
    const int items = NP * rows, ip = (items + 31) & ~31;
    return fe_part(K * ip, [=](int w) {
      const int k = K == 1 ? 0 : w / ip, t = w - k * ip;
      if (t >= items) return;
      const int p = t / rows, r = t - p * rows;
      const T* a;
      const T* b;
      ab(r, a, b);
      if constexpr (NP == 3) {
        const T* u = p == 1 ? a + NL : a;
        const T* u2 = p == 2 ? a + NL : zero;
        const T* v = p == 1 ? b + NL : b;
        const T* v2 = p == 2 ? b + NL : zero;
        if constexpr (K == 1)
          school(u, u2, v, v2, part + t * NC);
        else
          fe_dispatch<K>(k, [&](auto kc) {
            school.template part<decltype(kc)::value>(u, u2, v, v2,
                                                      part + t * NC);
          });
      } else {
        const T* u = a + (p >> 1) * NL;
        const T* v = b + (p & 1) * NL;
        int U[NL], V[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          U[l] = u[l];
          V[l] = v[l];
        }
        fe_store_schoolbook(U, V, part + t * NC);
      }
    });
  }
}

template <int NP, int S = 1, class T = int, class AB>
__device__ __forceinline__ void fe_products(int rows, AB ab, int* part,
                                            const T* zero) {
  fe_run(fe_products_part<NP, S, T>(rows, ab, part, zero));
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

// out = x·y over NF consecutive Fp12 values (x, y, out: NF · 300 ints),
// the plain `_fp12_mul` for each; `out` may alias x or y. As the plain
// version: xi·y; per (fraction, k, component, group of two i) the padded
// cyclic-convolution columns; their normalize; the merges (g0 + g1), then
// (that + g2), each normalized. Stage K (0..7) is one phase, as a part:
// the Miller kernel runs its square's stages beside other work.
// How the Fp12 stages below are built: the defaults are the final
// exponentiation's (a copy of each phase's code per chunk of limbs, whole
// schoolbook items, FE_CW_* limbs per lane); a kernel with many kinds of
// phase takes run-time chunks (RT), its own School (one that may split an
// item into parts) and its own chunk widths.
struct FeOpts {
  static constexpr bool RT = false;
  using School = FeSchool;
  // limbs per lane of the phases of rounds
  static constexpr int CW_Z1 = FE_CW_Z1, CW_Z2 = FE_CW_Z2,
                       CW_OUT = FE_CW_OUT, CW_MERGE = FE_CW_MERGE;
};

template <int NF, class O = FeOpts>
struct FeMul {
  static constexpr int STAGES = 8, R12 = 12 * NF, R36 = 36 * NF;
  const int* x;
  const int* y;
  int* out;
  FeScratch S;
  const int* T;
  static constexpr bool RT = O::RT;

  template <int K>
  __device__ __forceinline__ auto part() const {
    const int* x = this->x;
    const int* y = this->y;
    const int* T = this->T;
    const FeScratch S = this->S;
    if constexpr (K == 0) {
      return fe_two_rounds_part<NL, O::CW_Z1, RT>(R12, [=](int r, int l) {
        const int* a = y + (r & ~1) * NL;
        return (r & 1) == 0 ? a[l] * 9 - a[NL + l] + T[C_NEG + l]
                            : a[l] + a[NL + l] * 9;
      }, S.t2);
    } else if constexpr (K == 1) {
      return fe_fold_three_part<O::CW_OUT, RT>(R12, S.t2, FeRows{S.xi}, T);
    } else if constexpr (K == 2) {
      // product row r = ((f·6 + k)·3 + g)·2 + ii: x_i times its operand of
      // y or xi·y for i = 2g + ii; accumulator ((f·6 + k)·2 + c)·3 + g
      // adds the rows of ii = 0, 1, and the pad to component 0
      return fe_products_part<3>(R36, [=](int r, const int*& a,
                                          const int*& b) {
        const int ii = r % 2, g = (r / 2) % 3, k = (r / 6) % 6, f = r / 36;
        const int i = 2 * g + ii;
        a = x + f * FP12 + i * 2 * NL;
        b = (i <= k ? y : S.xi) + f * FP12 + ((k - i + 6) % 6) * 2 * NL;
      }, S.part, S.zero, typename O::School());
    } else if constexpr (K == 3) {
      return fe_two_rounds_part<NC, O::CW_Z2, RT>(R36, [=](int r, int l) {
        const int g = r % 3, c = (r / 3) % 2, fk = r / 6;
        const int row = (fk * 3 + g) * 2;
        return (c == 0 ? T[C_PAD + l] : 0) +
               fe_column<3>(S.part, R36, row, c, l) +
               fe_column<3>(S.part, R36, row + 1, c, l);
      }, S.t2);
    } else if constexpr (K == 4) {
      return fe_fold_part<NC>(R36, S.t2, S.acc, T);
    } else if constexpr (K == 5) {
      return fe_merge_part<O::CW_MERGE, false, RT>(
          R12, [=](int r) { return S.acc + 3 * r * FB; },
          [=](int r) { return S.acc + (3 * r + 1) * FB; }, S.t2m, FeAdd(), T);
    } else if constexpr (K == 6) {
      return fe_merge_part<O::CW_MERGE, true, RT>(
          R12, [=](int r) { return S.t2m + r * FE_Z1; },
          [=](int r) { return S.acc + (3 * r + 2) * FB; }, S.t2, FeAdd(), T);
    } else {
      return fe_fold_three_part<O::CW_OUT, RT>(R12, S.t2, FeRows{out}, T);
    }
  }
};

template <int NF>
__device__ void fe_mul(const int* x, const int* y, int* out,
                                       FeScratch S, const int* T) {
  const FeMul<NF> m{x, y, out, S, T};
  fe_run(m.template part<0>());
  fe_run(m.template part<1>());
  fe_run(m.template part<2>());
  fe_run(m.template part<3>());
  fe_run(m.template part<4>());
  fe_run(m.template part<5>());
  fe_run(m.template part<6>());
  fe_run(m.template part<7>());
}

// out = f · (A + B·w + C·w^3) for one Fp12 value, the sparse line
// product `_fp12_mul_line`; the line's three Fp2 terms lie at line,
// line + 50, line + 100, and S.xi holds xi·f, normalized as the plain
// `_mul_xi` does (the caller's phase, which may share a barrier with
// other work). `out` may alias f. As the plain version: per (k,
// component, group) the padded columns of the line terms times f's
// coefficients (group 0: A and B, group 1: C), each Fp2 product from
// three schoolbooks (Karatsuba); their normalize; one merge (g0 + g1).
// Stage K (0..4) is one phase, as a part; S holds the scratch of one
// fraction (fe_scratch<1>).
template <class O = FeOpts>
struct FeMulLine {
  static constexpr int STAGES = 5;
  const int* f;
  const int* line;
  int* out;
  FeScratch S;
  const int* T;
  static constexpr bool RT = O::RT;

  template <int K>
  __device__ __forceinline__ auto part() const {
    const int* f = this->f;
    const int* line = this->line;
    const int* T = this->T;
    const FeScratch S = this->S;
    if constexpr (K == 0) {
      // product row r = k·3 + t: term t (w-degree 0, 1, 3) times the
      // operand of f or xi·f
      return fe_products_part<3>(18, [=](int r, const int*& a,
                                         const int*& b) {
        const int t = r % 3, k = r / 3, d = t == 2 ? 3 : t;
        a = line + t * 2 * NL;
        b = (k >= d ? f : S.xi) + ((k - d + 6) % 6) * 2 * NL;
      }, S.part, S.zero, typename O::School());
    } else if constexpr (K == 1) {
      // accumulator (k·2 + c)·2 + g
      return fe_two_rounds_part<NC, O::CW_Z2, RT>(24, [=](int r) {
        const int g = r % 2, c = (r / 2) % 2, k = r / 4;
        const int p0 = k * 3 + 2 * g;
        const int* pad = T + C_PAD;
        const int kp = c == 0;
        return [=](int l) {
          int v = pad[l] * kp + fe_column<3>(S.part, 18, p0, c, l);
          if (g == 0) v += fe_column<3>(S.part, 18, p0 + 1, c, l);
          return v;
        };
      }, S.t2);
    } else if constexpr (K == 2) {
      return fe_fold_part<NC>(24, S.t2, S.acc, T);
    } else if constexpr (K == 3) {
      return fe_merge_part<O::CW_MERGE, false, RT>(
          12, [=](int m) { return S.acc + 2 * m * FB; },
          [=](int m) { return S.acc + (2 * m + 1) * FB; }, S.t2, FeAdd(), T);
    } else {
      return fe_fold_three_part<O::CW_OUT, RT>(12, S.t2, FeRows{out}, T);
    }
  }
};

// out = x^(p^np), np in {1, 2, 3}, for NF fractions; `out` may alias x.
// As `_frob`: conjugate when np is odd, normalize, then multiply
// coefficient k by gamma_{np,k} (padded columns, one normalize).
template <int NF>
__device__ void fe_frob(const int* x, int np, int* out, FeScratch S,
                        const int* T) {
  constexpr int R12 = 12 * NF;
  const bool odd = (np % 2) == 1;
  fe_two_rounds<NL, FE_CW_Z1>(R12, [&](int r, int l) {
    const int v = x[r * NL + l];
    return odd && (r & 1) ? T[C_NEG + l] - v : v;
  }, S.t2);
  fe_fold_three<FE_CW_OUT>(R12, S.t2, FeRows{S.xi});
  const int* gamma = T + C_GAMMA + (np - 1) * FP12;
  // product row r = f·6 + k: coefficient k times gamma_k; accumulator
  // 2r + c, padded in component 0
  fe_products<4>(R12 / 2, [&](int r, const int*& a, const int*& b) {
    a = S.xi + r * 2 * NL;
    b = gamma + (r % 6) * 2 * NL;
  }, S.part, S.zero);
  fe_two_rounds<NC, FE_CW_Z2>(R12, [&](int r, int l) {
    const int c = r % 2;
    return (c == 0 ? T[C_PAD + l] : 0) +
           fe_column<4>(S.part, R12 / 2, r / 2, c, l);
  }, S.t2);
  fe_fold<NC>(R12, S.t2, S.acc, T);
  fe_three_rounds<FE_CW_OUT>(R12, S.acc, FeRows{out});
}

}  // namespace gs
