// Fused schoolbook columns and static combine of the tower's products.
//
// Replaces the TPU kernel `pair_conv_combine` of
// gethsharding_tpu/ops/pallas_conv.py (its pallas_call at :113): for each
// batch row and each output (c, g, n),
//
//   out[c, g, n] = sum over the combine's nonzero terms (i, a, b, c, g, k)
//                  of k · sum_{l+m=n} x[i, a, l] · y[i, b, m],
//
// with x (G, A, nl) and y (G, B, nl) limb planes per row and the output
// (C, Gr, 2·nl - 1) raw column accumulators that the caller pads and
// normalizes; nl is the limb form's operand width, 25 (wide) or 22
// (exact), as the TPU kernel takes any (its `nl` parameter). The combine comes as a per-plane plan of its nonzero terms
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
// nl) or (G, B, nl) block is contiguous. A 22-limb row is staged into
// 25-limb slots of shared memory with zero top limbs (conv.cuh
// `stage_slots`): no widened copy goes through device memory, and the
// zero limbs add nothing to columns 0..42, the only ones stored.
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

// x, y: the operands' first elements; n rows of G·A and G·B limb vectors
// of NL limbs (xv = G·A, yv = G·B); plan: (planes + 1) offsets, then
// (nterms, 4) terms (i, a, b, coef) sorted by plane c·Gr + g; out: (n,
// planes·(2·NL - 1)). Dynamic shared memory: rpb·25·(xv + yv) ints, each
// part rounded up to 4 ints, the plan, then the block's rpb·planes·49
// output columns, stored to out in one coalesced pass.
template <int NL>
__global__ void __launch_bounds__(CONV_THREADS)
    conv_kernel(const int* __restrict__ x, const int* __restrict__ y,
                long long n, int xv, int yv, int a_dim, int b_dim,
                const int* __restrict__ plan, int planes, int nterms,
                int rpb, ConvLead lead, int* __restrict__ out) {
  constexpr int OC = 2 * NL - 1;         // stored columns per plane
  const int xw = xv * CONV_NL, yw = yv * CONV_NL;   // shared row widths
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
  stage_slots<NL>(sx, x, row_off, rows, xv);
  stage_slots<NL>(sy, y, row_off + CONV_MAX_ROWS, rows, yv);
  __syncthreads();

  const int* terms = sp + planes + 1;
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
  for (int i = threadIdx.x; i < rows * planes * OC; i += blockDim.x) {
    const int rp = i / OC, c = i - rp * OC;
    out[r0 * planes * OC + i] = s_out[rp * CONV_NC + c];
  }
}

}  // namespace gs

#ifdef __CUDACC__
// nl: operand limbs, 25 (wide form) or 22 (exact form); xv = G·A and
// yv = G·B limb vectors per row.
extern "C" int gs_conv(const int* x, const int* y, long long n, int nl,
                       int xv, int yv, int a_dim, int b_dim, const int* plan,
                       int planes, int nterms, int rpb, int ndim,
                       const long long* lead_desc, int* out,
                       cudaStream_t stream) {
  if (ndim < 0 || ndim > gs::CONV_MAX_DIMS || rpb < 1 ||
      rpb > gs::CONV_MAX_ROWS || (nl != 25 && nl != 22))
    return (int)cudaErrorInvalidValue;
  const gs::ConvLead lead = gs::conv_lead(ndim, lead_desc);
  const long long blocks = (n + rpb - 1) / rpb;
  const int smem = (((rpb * xv * gs::CONV_NL + 3) & ~3) +
                    ((rpb * yv * gs::CONV_NL + 3) & ~3) + planes + 1 +
                    gs::PLAN_TERM * nterms + rpb * planes * gs::CONV_NC) *
                   (int)sizeof(int);
  if (nl == 25)
    gs::conv_kernel<25><<<(unsigned)blocks, gs::CONV_THREADS, smem, stream>>>(
        x, y, n, xv, yv, a_dim, b_dim, plan, planes, nterms, rpb, lead, out);
  else
    gs::conv_kernel<22><<<(unsigned)blocks, gs::CONV_THREADS, smem, stream>>>(
        x, y, n, xv, yv, a_dim, b_dim, plan, planes, nterms, rpb, lead, out);
  return (int)cudaGetLastError();
}
#endif
