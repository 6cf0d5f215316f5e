// ModArith.normalize in the wide form, one thread per accumulator row.
//
// Replaces the TPU kernel `normalize_pallas` of
// gethsharding_tpu/ops/pallas_norm.py (its pallas_call at :104), in its
// wide form: three relaxed carry rounds into W + 3 limbs, the fold of the
// limbs >= 22 through the (33, 22) rows 2^(12(22+k)) mod p, + lift, and
// one exact carry into 25 canonical limbs. The result equals
// `normalize_plain` of ops/norm.py limb for limb: every step is the same
// integer arithmetic on the same int32 values (no sum leaves int32, and
// `>>` is arithmetic, so the negative limbs of a difference borrow as
// they do there). The TPU kernel's exact 22-limb branch is not here.
//
// What bounds it on this card: bytes. A row reads W <= 52 ints and writes
// 25; its fold is at most 33 × 22 multiply-adds, which the card does in
// less time than it moves the row. At the tower's shapes (hundreds to a
// few thousand rows per launch) the launch itself costs more than either.
// The design: a block of 128 threads stages its 128 rows through shared
// memory, so loads and stores of consecutive rows coalesce; each thread
// then keeps its row in registers (the loops are unrolled over a
// compile-time maximum width, and limbs past the row's width are zero,
// which a relaxed round and the fold pass through unchanged), and the
// fold rows and the lift come from shared memory.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

constexpr int NORM_NL = 25;       // output limbs
constexpr int NORM_FB = 22;       // fold base
constexpr int NORM_FR = 33;       // fold rows
constexpr int NORM_LB = 12;       // bits per limb
constexpr int NORM_LM = (1 << NORM_LB) - 1;
constexpr int NORM_THREADS = 128;  // rows per block
constexpr int NORM_WMAX = NORM_FB + NORM_FR - 3;  // widest accumulator, 52

// z: (n, w) int32 accumulators, w <= WM; fold: (33, 22); lift: (22,);
// out: (n, 25).
template <int WM>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_kernel(const int* __restrict__ z, int n, int w,
                const int* __restrict__ fold, const int* __restrict__ lift,
                int* __restrict__ out) {
  static_assert(WM >= NORM_NL && WM <= NORM_WMAX, "width out of range");
  constexpr int Z = WM + 3;
  __shared__ int s_fold[NORM_FR * NORM_FB];
  __shared__ int s_lift[NORM_FB];
  __shared__ int s_io[NORM_THREADS * WM];

  const long r0 = (long)blockIdx.x * blockDim.x;
  const int rows = n - r0 < (long)blockDim.x ? (int)(n - r0) : blockDim.x;
  for (int i = threadIdx.x; i < NORM_FR * NORM_FB; i += blockDim.x)
    s_fold[i] = fold[i];
  for (int i = threadIdx.x; i < NORM_FB; i += blockDim.x) s_lift[i] = lift[i];
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x)
    s_io[i] = z[r0 * w + i];
  __syncthreads();

  const int t = threadIdx.x;
  int v[Z];
#pragma unroll
  for (int j = 0; j < Z; ++j) v[j] = (t < rows && j < w) ? s_io[t * w + j] : 0;
  __syncthreads();  // every row is read before s_io takes the results

  // three relaxed rounds; the top limb of a round is zero or a carry
  // that the next limb up never sends on, so nothing is dropped
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < Z; ++j) {
      const int x = v[j];
      v[j] = (x & NORM_LM) + c;
      c = x >> NORM_LB;
    }
  }
  int acc[NORM_NL];
#pragma unroll
  for (int j = 0; j < NORM_FB; ++j) acc[j] = v[j] + s_lift[j];
#pragma unroll
  for (int j = NORM_FB; j < NORM_NL; ++j) acc[j] = 0;
#pragma unroll
  for (int h = 0; h < Z - NORM_FB; ++h) {
    const int x = v[NORM_FB + h];
#pragma unroll
    for (int j = 0; j < NORM_FB; ++j) acc[j] += x * s_fold[h * NORM_FB + j];
  }
  int c = 0;  // exact carry; the carry off the top limb is zero (< 2^273)
#pragma unroll
  for (int j = 0; j < NORM_NL; ++j) {
    const int x = acc[j] + c;
    acc[j] = x & NORM_LM;
    c = x >> NORM_LB;
  }
  if (t < rows) {
#pragma unroll
    for (int j = 0; j < NORM_NL; ++j) s_io[t * NORM_NL + j] = acc[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * NORM_NL; i += blockDim.x)
    out[r0 * NORM_NL + i] = s_io[i];
}

}  // namespace gs

#ifdef __CUDACC__
// The narrowest instantiation that holds a row of width w: the tower's
// accumulators are 25 (sums), 26 (differences) or 49 (products) wide.
extern "C" int gs_norm(const int* z, int n, int w, const int* fold,
                       const int* lift, int* out, cudaStream_t stream) {
  const int blocks = (n + gs::NORM_THREADS - 1) / gs::NORM_THREADS;
  if (w <= 25)
    gs::norm_kernel<25><<<blocks, gs::NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  else if (w == 26)
    gs::norm_kernel<26><<<blocks, gs::NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  else if (w <= 49)
    gs::norm_kernel<49><<<blocks, gs::NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  else
    gs::norm_kernel<52><<<blocks, gs::NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  return (int)cudaGetLastError();
}
#endif
