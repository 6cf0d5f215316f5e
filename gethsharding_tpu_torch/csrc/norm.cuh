// ModArith.normalize in the wide exact form, as block-cooperative device
// code over accumulator rows held in shared memory.
//
// The steps are those of `normalize_plain` (ops/norm.py): three relaxed
// carry rounds into W + 3 limbs, the fold of the limbs >= 22 through the
// (33, 22) rows 2^(12(22+k)) mod p, + lift, and one exact carry into 25
// canonical limbs. Every step is the same integer arithmetic on the same
// int32 values (no sum leaves int32, and `>>` is arithmetic, so negative
// limbs borrow as they do there), so the limbs are the plain version's.
//
// How the work spreads over a block:
// - the rounds, one lane per limb: a round is elementwise given the
//   previous values, z_i <- (z_i & 0xFFF) + (z_{i-1} >> 12), so limb i
//   after three rounds depends only on the input limbs i-3..i, and each
//   lane computes its limb from those four in registers;
// - the fold, one lane per output limb j < 22: lift_j + z_j + the sum
//   over the high limbs h of z_{22+h} · fold[h][j];
// - the exact carry, one lane per row: the serial 25-step ripple.
// Every phase is a block-stride loop ending in __syncthreads(), and no
// item of a phase reads what another item of the same phase writes, so
// one thread running every item in order is a legal schedule too.
#pragma once

namespace gs {

constexpr int NORM_NL = 25;        // output limbs
constexpr int NORM_FB = 22;        // fold base
constexpr int NORM_FR = 33;        // fold rows
constexpr int NORM_LB = 12;        // bits per limb
constexpr int NORM_LM = (1 << NORM_LB) - 1;
constexpr int NORM_WMAX = NORM_FB + NORM_FR - 3;  // widest accumulator, 52

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

// Normalize `rows` accumulators: row r is z[r·zs ..], width w <= WM <=
// 52, |limb| < 2^30.7, value >= 0. Row r's 25 limbs go to out[r·os ..].
// The loops run over the compile-time width WM, so they unroll; limbs
// past w are zero, which gives the same limbs as width w (a zero limb
// stays zero through the rounds and folds nothing). fold (its first
// WM + 3 - 22 rows are read) and lift: shared memory. Scratch: t3
// rows·(WM + 3) ints, acc rows·22 ints. out must not overlap z or the
// scratch.
template <int WM>
__device__ __forceinline__ void norm_rows(const int* z, int zs, int w,
                                          int rows, int* out, int os,
                                          const int* fold, const int* lift,
                                          int* t3, int* acc) {
  static_assert(WM >= 1 && WM <= NORM_WMAX, "width out of range");
  constexpr int W3 = WM + 3;
  constexpr int NH = W3 > NORM_FB ? W3 - NORM_FB : 0;
  for (int t = threadIdx.x; t < rows * W3; t += blockDim.x) {
    const int r = t / W3;
    t3[t] = three_rounds(z + r * zs, w, t - r * W3);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < rows * NORM_FB; t += blockDim.x) {
    const int r = t / NORM_FB, j = t - r * NORM_FB;
    const int* v = t3 + r * W3;
    int s = (j < W3 ? v[j] : 0) + lift[j];
#pragma unroll
    for (int h = 0; h < NH; ++h) s += v[NORM_FB + h] * fold[h * NORM_FB + j];
    acc[t] = s;
  }
  __syncthreads();
  // the exact carry; the carry off the top limb is zero (value < 2^273)
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
    for (int j = NORM_FB; j < NORM_NL; ++j) {
      o[j] = c & NORM_LM;
      c >>= NORM_LB;
    }
  }
  __syncthreads();
}

}  // namespace gs
