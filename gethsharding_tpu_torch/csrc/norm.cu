// ModArith.normalize in the wide form over a batch of accumulator rows.
//
// Replaces the TPU kernel `normalize_pallas` of
// gethsharding_tpu/ops/pallas_norm.py (its pallas_call at :104), in its
// wide form: three relaxed carry rounds into W + 3 limbs, the fold of the
// limbs >= 22 through the (33, 22) rows 2^(12(22+k)) mod p, + lift, and
// one exact carry into 25 canonical limbs (csrc/norm.cuh, which the tower
// kernel shares). The result equals `normalize_plain` of ops/norm.py limb
// for limb. The TPU kernel's exact 22-limb branch is not here.
//
// What bounds it on this card: bytes. A row reads W <= 52 ints and writes
// 25; its fold is at most 30 × 22 multiply-adds, which the card does in
// less time than it moves the row. At the tower's shapes (hundreds to a
// few thousand rows per launch) latency costs more than either, so the
// design spreads each row over lanes: a block of 128 threads takes 4
// rows, one lane per limb in the rounds and the fold (norm.cuh), so a
// 1,344-row launch is 336 blocks over the 132 SMs and no thread walks a
// row's fold alone. Loads and stores of the block's rows are coalesced
// through shared memory.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "conv.cuh"
#include "norm.cuh"

namespace gs {

constexpr int NORM_THREADS = 128;
constexpr int NORM_ROWS = 4;       // rows per block

// z: (n, w) int32 accumulators, 1 <= w <= WM; fold: (33, 22); lift:
// (22,); out: (n, 25).
template <int WM>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_kernel(const int* __restrict__ z, long long n, int w,
                const int* __restrict__ fold, const int* __restrict__ lift,
                int* __restrict__ out) {
  __shared__ int s_z[NORM_ROWS * WM];
  __shared__ int s_t3[NORM_ROWS * (WM + 3)];
  __shared__ int s_acc[NORM_ROWS * NORM_FB];
  __shared__ __align__(16) int s_fold[NORM_FR * NORM_FB];
  __shared__ int s_lift[NORM_FB];
  __shared__ int s_out[NORM_ROWS * NORM_NL];

  const long long r0 = (long long)blockIdx.x * NORM_ROWS;
  const int rows = n - r0 < NORM_ROWS ? (int)(n - r0) : NORM_ROWS;
  constexpr int NFOLD = WM + 3 > NORM_FB ? (WM + 3 - NORM_FB) * NORM_FB : 0;
  stage_ints(s_fold, fold, NFOLD);
  for (int i = threadIdx.x; i < NORM_FB; i += blockDim.x) s_lift[i] = lift[i];
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x)
    s_z[i] = z[r0 * w + i];
  __syncthreads();
  norm_rows<WM>(s_z, w, w, rows, s_out, NORM_NL, s_fold, s_lift, s_t3, s_acc);
  for (int i = threadIdx.x; i < rows * NORM_NL; i += blockDim.x)
    out[r0 * NORM_NL + i] = s_out[i];
}

}  // namespace gs

#ifdef __CUDACC__
// The narrowest instantiation that holds a row of width w: the tower's
// accumulators are 25 (sums), 26 (differences) or 49 (products) wide.
extern "C" int gs_norm(const int* z, long long n, int w, const int* fold,
                       const int* lift, int* out, cudaStream_t stream) {
  if (w < 1 || w > gs::NORM_WMAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + gs::NORM_ROWS - 1) / gs::NORM_ROWS);
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
