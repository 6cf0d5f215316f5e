// ModArith.normalize in both lazy forms over a batch of accumulator rows.
//
// Replaces the TPU kernel `normalize_pallas` of
// gethsharding_tpu/ops/pallas_norm.py (its pallas_call at :104), in both
// of its branches (csrc/norm.cuh, whose wide form the tower kernel
// shares):
// - wide: three relaxed carry rounds into W + 3 limbs, the fold of the
//   limbs >= 22 through the (33, 22) rows 2^(12(22+k)) mod p, + lift, and
//   one exact carry into 25 canonical limbs;
// - exact (its branch at :83-91): two relaxed stages, each three rounds
//   and a fold, then three exact carries into 24, 23 and 22 limbs with a
//   fold between each, into 22 canonical limbs.
// The result equals `normalize_plain` of ops/norm.py limb for limb, in the
// form the `form` argument names.
//
// What bounds it on this card: bytes. A row reads W <= 52 ints and writes
// 25 or 22; its folds are at most 30 × 22 multiply-adds (36 × 22 in the
// exact form), which the card does in less time than it moves the row.
// At the audit's shapes (hundreds to a few thousand rows per launch)
// latency costs more than either, so the design spreads each row over
// lanes: a block of 128 threads takes 4 rows, one lane per limb in the
// rounds and the folds (norm.cuh), so a 1,344-row launch is 336 blocks
// over the 132 SMs and no thread walks a row's fold alone. Each exact
// carry is a serial ripple, one lane per row: the exact form's three of
// them are its deepest chain, which is why the TPU round preferred the
// wide form's single carry where latency counted. Loads and stores of the
// block's rows are coalesced through shared memory.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "conv.cuh"
#include "norm.cuh"

namespace gs {

constexpr int NORM_THREADS = 128;
constexpr int NORM_ROWS = 4;       // rows per block

// z: (n, w) int32 accumulators, 1 <= w <= WM; fold: (33, 22); lift:
// (22,), read in the wide form only; out: (n, 25) wide, (n, 22) exact.
template <int WM, NormForm F>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_kernel(const int* __restrict__ z, long long n, int w,
                const int* __restrict__ fold, const int* __restrict__ lift,
                int* __restrict__ out) {
  constexpr int OUT = F == NORM_EXACT ? NORM_FB : NORM_NL;
  __shared__ int s_z[NORM_ROWS * WM];
  __shared__ int s_t3[NORM_ROWS * (WM + 3)];
  __shared__ int s_acc[NORM_ROWS * NORM_FB];
  __shared__ __align__(16) int s_fold[NORM_FR * NORM_FB];
  __shared__ int s_lift[NORM_FB];
  __shared__ int s_out[NORM_ROWS * OUT];

  const long long r0 = (long long)blockIdx.x * NORM_ROWS;
  const int rows = n - r0 < NORM_ROWS ? (int)(n - r0) : NORM_ROWS;
  // the exact form's later folds read the first 3 rows, within these
  constexpr int NFOLD = WM + 3 > NORM_FB ? (WM + 3 - NORM_FB) * NORM_FB : 0;
  stage_ints(s_fold, fold, NFOLD);
  for (int i = threadIdx.x; i < NORM_FB; i += blockDim.x) s_lift[i] = lift[i];
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x)
    s_z[i] = z[r0 * w + i];
  __syncthreads();
  norm_rows<WM, F>(s_z, w, w, rows, s_out, OUT, s_fold, s_lift, s_t3, s_acc);
  for (int i = threadIdx.x; i < rows * OUT; i += blockDim.x)
    out[r0 * OUT + i] = s_out[i];
}

}  // namespace gs

#ifdef __CUDACC__
namespace gs {

// The narrowest instantiation that holds a row of width w: the audit's
// accumulators are 22-26 (sums and differences) or 43-49 (products) wide.
template <NormForm F>
int launch_norm(const int* z, long long n, int w, const int* fold,
                const int* lift, int* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + NORM_ROWS - 1) / NORM_ROWS);
  if (w <= 25)
    norm_kernel<25, F><<<blocks, NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  else if (w == 26)
    norm_kernel<26, F><<<blocks, NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  else if (w <= 49)
    norm_kernel<49, F><<<blocks, NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  else
    norm_kernel<52, F><<<blocks, NORM_THREADS, 0, stream>>>(
        z, n, w, fold, lift, out);
  return (int)cudaGetLastError();
}

}  // namespace gs

// form: gs::NormForm (0 wide, 1 exact).
extern "C" int gs_norm(const int* z, long long n, int w, int form,
                       const int* fold, const int* lift, int* out,
                       cudaStream_t stream) {
  if (w < 1 || w > gs::NORM_WMAX) return (int)cudaErrorInvalidValue;
  if (form == gs::NORM_WIDE)
    return gs::launch_norm<gs::NORM_WIDE>(z, n, w, fold, lift, out, stream);
  if (form == gs::NORM_EXACT)
    return gs::launch_norm<gs::NORM_EXACT>(z, n, w, fold, lift, out, stream);
  return (int)cudaErrorInvalidValue;
}
#endif
