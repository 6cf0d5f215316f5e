// Fused schoolbook columns and static combine of the tower's products.
//
// Replaces the TPU kernel `pair_conv_combine` of
// gethsharding_tpu/ops/pallas_conv.py (its pallas_call at :113): for each
// batch row and each output (c, g, n),
//
//   out[c, g, n] = sum over the combine's nonzero terms (i, a, b, c, g, k)
//                  of k · sum_{l+m=n} x[i, a, l] · y[i, b, m],
//
// with x (G, A, 25) and y (G, B, 25) limb planes per row and the output
// (C, Gr, 49) raw column accumulators that the caller pads and
// normalizes. The combine comes as a per-plane plan of its nonzero terms
// (ops/conv.py `plane_plan`), so one kernel serves every combine, and the
// result equals `pair_conv_combine_plain` limb for limb (csrc/conv.cuh).
// The tower kernel (csrc/tower.cu) runs the same device code with the
// pads and normalizes fused behind it; this entry is the counterpart of
// `pair_conv_combine` for any combine table.
//
// The batch rows are the common broadcast of the two operands' leading
// dims, walked in row-major order through each operand's own element
// stride per leading dim (0 where it is broadcast), so a broadcast operand
// is read in place and never copied out to every row. Each row's (G, A,
// 25) or (G, B, 25) block is contiguous.
//
// What bounds it on this card: neither by much. Per row an Fp12 product
// needs 24 × 625 int32 multiply-adds against ~2.6 KB read and written;
// at a few hundred rows per launch latency costs more than either. The
// design: a block of 128 threads stages `rpb` rows of x and y and the
// plan in shared memory (16-byte loads where aligned; the host picks rpb
// so that the path's 112 to 672 rows spread over all SMs), then gives
// each thread one balanced work item (row, plane, five column pairs)
// that visits only its plane's terms, with its operand rows in
// registers, so shared memory serves 50 loads per 125 multiply-adds.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "conv.cuh"

namespace gs {

constexpr int CONV_THREADS = 128;
constexpr int CONV_MAX_ROWS = 8;   // rows per block, at most
constexpr int CONV_PAIRS = 5;      // column pairs per work item
constexpr int CONV_ITEMS = CONV_NL / CONV_PAIRS;   // work items per plane

// x, y: the operands' first elements; n rows; xw = G·A·25, yw = G·B·25;
// plan: (planes + 1) offsets, then (nterms, 4) terms (i, a, b, coef)
// sorted by plane c·Gr + g; out: (n, planes·49). Dynamic shared memory:
// rpb·(xw + yw) ints, each part rounded up to 4 ints, the plan, then the
// block's rpb·planes·49 output columns, stored to out in one coalesced
// pass.
__global__ void __launch_bounds__(CONV_THREADS)
    conv_kernel(const int* __restrict__ x, const int* __restrict__ y,
                long long n, int xw, int yw, int a_dim, int b_dim,
                const int* __restrict__ plan, int planes, int nterms,
                int rpb, ConvLead lead, int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ long long row_off[2 * CONV_MAX_ROWS];   // x, then y offsets
  int* sx = smem;
  int* sy = sx + ((rpb * xw + 3) & ~3);
  int* sp = sy + ((rpb * yw + 3) & ~3);
  int* s_out = sp + planes + 1 + PLAN_TERM * nterms;   // rpb·planes·49

  const long long r0 = (long long)blockIdx.x * rpb;
  const int rows = n - r0 < rpb ? (int)(n - r0) : rpb;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    lead_offsets(lead, (int)(r0 + r), row_off[r], row_off[CONV_MAX_ROWS + r]);
  for (int i = threadIdx.x; i < planes + 1 + PLAN_TERM * nterms;
       i += blockDim.x)
    sp[i] = plan[i];
  __syncthreads();
  stage_rows(sx, xw, x, row_off, rows, xw);
  stage_rows(sy, yw, y, row_off + CONV_MAX_ROWS, rows, yw);
  __syncthreads();

  const int* terms = sp + planes + 1;
  const int ow = planes * CONV_NC;
  for (int t = threadIdx.x; t < rows * planes * CONV_ITEMS; t += blockDim.x) {
    const int r = t / (planes * CONV_ITEMS);
    const int rem = t - r * planes * CONV_ITEMS;
    const int p = rem / CONV_ITEMS, j = rem - p * CONV_ITEMS;
    const int* xr = sx + r * xw;
    const int* yr = sy + r * yw;
    plane_item<CONV_PAIRS>(
        terms, sp[p], sp[p + 1],
        [&](int i, int a) { return xr + (i * a_dim + a) * CONV_NL; },
        [&](int i, int b) { return yr + (i * b_dim + b) * CONV_NL; }, j,
        nullptr, s_out + t / CONV_ITEMS * CONV_NC);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * ow; i += blockDim.x)
    out[r0 * ow + i] = s_out[i];
}

}  // namespace gs

#ifdef __CUDACC__
extern "C" int gs_conv(const int* x, const int* y, long long n, int xw,
                       int yw, int a_dim, int b_dim, const int* plan,
                       int planes, int nterms, int rpb, int ndim,
                       const long long* lead_desc, int* out,
                       cudaStream_t stream) {
  if (ndim < 0 || ndim > gs::CONV_MAX_DIMS || rpb < 1 ||
      rpb > gs::CONV_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const gs::ConvLead lead = gs::conv_lead(ndim, lead_desc);
  const long long blocks = (n + rpb - 1) / rpb;
  const int smem = (((rpb * xw + 3) & ~3) + ((rpb * yw + 3) & ~3) + planes +
                    1 + gs::PLAN_TERM * nterms + rpb * planes * gs::CONV_NC) *
                   (int)sizeof(int);
  gs::conv_kernel<<<(unsigned)blocks, gs::CONV_THREADS, smem, stream>>>(
      x, y, n, xw, yw, a_dim, b_dim, plan, planes, nterms, rpb, lead, out);
  return (int)cudaGetLastError();
}
#endif
