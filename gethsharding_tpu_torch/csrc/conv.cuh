// The tower's fused schoolbook columns and combine, as block-cooperative
// device code: the broadcast walk of the batch rows, the staging of
// operand rows into shared memory, and one balanced work item of a
// product plane.
//
// A product plane (c, g) of one batch row is
//
//   acc[c, g, n] = sum over the plane's terms (i, a, b, coef)
//                  of coef · sum_{l+m=n} x[i, a, l] · y[i, b, m],
//
// n = 0..48. The terms come from a plan made on the host (ops/conv.py
// `plane_plan`): the combine tensor's nonzeros sorted by plane, with an
// offset per plane, so a column visits only its own plane's terms.
// Column n of a 25 × 25 schoolbook product has min(n, 48 - n) + 1
// products; columns q and q + 25 (q < 24), or column 24 alone, make a
// balanced pair of 25 multiply-adds, and a work item takes one or five
// such pairs, so every item of a plane does the same work.
// Each accumulator sums at most four 25-term columns of products of
// canonical limbs plus a pad (the reference's range contract), so no
// partial sum leaves int32 and the sum is the same integer in any order.
#pragma once

#include <stdint.h>

namespace gs {

constexpr int CONV_NL = 25;                // limbs per operand
constexpr int CONV_NC = 2 * CONV_NL - 1;   // product columns
constexpr int CONV_MAX_DIMS = 6;           // leading dims after coalescing
constexpr int PLAN_TERM = 4;               // ints per term: i, a, b, coef

// The batch rows' leading dims, outermost first, with each operand's
// element stride (0 on a broadcast dim). Passed by value.
struct ConvLead {
  int ndim;
  int size[CONV_MAX_DIMS];
  long long xs[CONV_MAX_DIMS];
  long long ys[CONV_MAX_DIMS];
};

// desc: ndim triples (size, x stride, y stride), outermost first.
inline ConvLead conv_lead(int ndim, const long long* desc) {
  ConvLead lead{};
  lead.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    lead.size[d] = (int)desc[3 * d];
    lead.xs[d] = desc[3 * d + 1];
    lead.ys[d] = desc[3 * d + 2];
  }
  return lead;
}

// Element offsets of batch row `row` in x and y (row-major over the lead;
// the outermost dim takes what is left, so one dim needs no division).
// Row indices fit in 32 bits: 2^31 rows of output would not fit on the
// card. The loop is unrolled over the most dims, so `lead` is read at
// fixed indices where it lies (a kernel parameter), never copied to the
// stack.
__device__ __forceinline__ void lead_offsets(const ConvLead& lead, int row,
                                             long long& ox, long long& oy) {
  ox = 0;
  oy = 0;
#pragma unroll
  for (int d = CONV_MAX_DIMS - 1; d > 0; --d) {
    if (d < lead.ndim) {
      const int c = row % lead.size[d];
      row /= lead.size[d];
      ox += c * lead.xs[d];
      oy += c * lead.ys[d];
    }
  }
  if (lead.ndim > 0) {
    ox += row * lead.xs[0];
    oy += row * lead.ys[0];
  }
}

// Copy n ints from device memory into shared memory, block-cooperatively:
// 16-byte loads and stores where both ends are 16-byte aligned, else one
// int at a time (still coalesced).
__device__ __forceinline__ void stage_ints(int* dst,
                                           const int* __restrict__ src,
                                           int n) {
  int i0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int n4 = n >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Stage `rows` operand rows of `width` ints at src + off[r] into dst
// (row r at dst + r·stride): one span when the rows lie back to back in
// device memory and in shared memory, else row by row.
__device__ __forceinline__ void stage_rows(int* dst, int stride,
                                           const int* __restrict__ src,
                                           const long long* off, int rows,
                                           int width) {
  bool span = stride == width;
  for (int r = 1; r < rows && span; ++r) span = off[r] == off[0] + r * width;
  if (span) {
    stage_ints(dst, src + off[0], rows * width);
  } else {
    for (int r = 0; r < rows; ++r)
      stage_ints(dst + r * stride, src + off[r], width);
  }
}

// Columns q = j + (25 / NP)·s and q + 25 (s < NP; q = 24 has no column
// 49) of u ⊛ v, added times coef to lo[s] and hi[s]: NP balanced pairs,
// 25·NP multiply-adds, NP in {1, 5}; u[l] meets v[(q - l) mod 25], in
// column q where l <= q, else in column q + 25. For five pairs u and v
// go into registers once, v rotated by j (V[m] = v[(j + m) mod 25]), so
// every register index is a compile-time constant and the item reads 50
// ints of shared memory for its 125 multiply-adds: a fifth of the loads
// per multiply-add, where shared memory bounds the conv. One pair keeps
// each item short where the chain of phases bounds it.
template <int NP>
__device__ __forceinline__ void conv_pairs(const int* u, const int* v, int j,
                                           int coef, int (&lo)[NP],
                                           int (&hi)[NP]) {
  static_assert(CONV_NL % NP == 0, "pairs must tile the 25 columns");
  constexpr int STEP = CONV_NL / NP;
  if constexpr (NP == 1) {   // one pair: each operand limb is read once
    int a = 0, b = 0;
#pragma unroll
    for (int l = 0; l < CONV_NL; ++l) {
      const int m = j - l;
      const int prod = u[l] * v[m >= 0 ? m : m + CONV_NL];
      if (m >= 0)
        a += prod;
      else
        b += prod;
    }
    lo[0] += coef * a;
    hi[0] += coef * b;
  } else {
    int U[CONV_NL], V[CONV_NL];
#pragma unroll
    for (int l = 0; l < CONV_NL; ++l) {
      U[l] = u[l];
      const int m = j + l;
      V[l] = v[m < CONV_NL ? m : m - CONV_NL];
    }
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      int a = 0, b = 0;
#pragma unroll
      for (int l = 0; l < CONV_NL; ++l) {
        const int prod = U[l] * V[(STEP * s - l + CONV_NL) % CONV_NL];
        if (l <= j + STEP * s)
          a += prod;
        else
          b += prod;
      }
      lo[s] += coef * a;
      hi[s] += coef * b;
    }
  }
}

// Work item j (< 25 / NP) of one plane, padded: pad (49) or null for
// none; the plane's terms (i, a, b, coef) [e0, e1) with u_at(i, a) and
// v_at(i, b) giving the operand rows; its columns go to z (49).
template <int NP, class UAt, class VAt>
__device__ __forceinline__ void plane_item(const int* terms, int e0, int e1,
                                           UAt u_at, VAt v_at, int j,
                                           const int* pad, int* z) {
  constexpr int STEP = CONV_NL / NP;
  int lo[NP], hi[NP];
#pragma unroll
  for (int s = 0; s < NP; ++s) {
    const int q = j + STEP * s;
    lo[s] = pad ? pad[q] : 0;
    hi[s] = pad && q < CONV_NL - 1 ? pad[q + CONV_NL] : 0;
  }
  for (int e = e0; e < e1; ++e) {
    const int* tk = terms + e * PLAN_TERM;
    conv_pairs<NP>(u_at(tk[0], tk[1]), v_at(tk[0], tk[2]), j, tk[3], lo, hi);
  }
#pragma unroll
  for (int s = 0; s < NP; ++s) {
    const int q = j + STEP * s;
    z[q] = lo[s];
    if (q < CONV_NL - 1) z[q + CONV_NL] = hi[s];
  }
}

}  // namespace gs
