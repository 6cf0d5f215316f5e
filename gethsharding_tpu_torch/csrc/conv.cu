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
// normalizes. The combine comes as a small int32 table of its nonzero
// terms (ops/conv.py `term_table`), so one kernel serves every combine.
// Each accumulator sums at most four 25-term columns of products of
// canonical limbs (the reference's range contract), so every sum stays
// below 2^30.7 and is the same integer in any order: the result equals
// `pair_conv_combine_plain` limb for limb.
//
// The batch rows are the common broadcast of the two operands' leading
// dims, walked in row-major order. Each operand comes with its own
// element stride per leading dim, 0 where it is broadcast (a constant, or
// the f of an Fp12 product against its six outputs), so a broadcast
// operand is read in place and never copied out to every row. Each
// row's (G, A, 25) or (G, B, 25) block is contiguous.
//
// What bounds it on this card: neither by much. Per row an Fp12 product
// needs 24 × 625 int32 multiply-adds against ~2.6 KB read and written
// (the broadcast f counted once), ~0.9 ns at the card's multiply-add
// peak and ~0.8 ns at its memory rate; at a few hundred rows per launch
// the launch and the serial column loops cost more than either. The
// design: a block of 256 threads stages 8 rows of x and y (at most 4.8 KB
// each for an Fp12 product) and the term table in shared memory with
// coalesced loads, then gives each thread one output column (row, c, g,
// n) at a time: neighbouring threads write neighbouring columns, and each
// column walks its terms in registers.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

constexpr int CONV_NL = 25;        // limbs per operand
constexpr int CONV_NC = 2 * CONV_NL - 1;  // product columns
constexpr int CONV_THREADS = 256;
constexpr int CONV_ROWS = 8;       // batch rows per block
constexpr int CONV_TERM = 6;       // ints per term: i, a, b, c, g, coef
constexpr int CONV_MAX_DIMS = 6;   // leading dims after coalescing

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

// x, y: the operands' first elements; n = the product of lead.size;
// xw = G·A·25, yw = G·B·25; terms: (nterms, 6); out: (n, planes·49) with
// planes = C·Gr.
__global__ void __launch_bounds__(CONV_THREADS)
    conv_kernel(const int* __restrict__ x, const int* __restrict__ y, int n,
                int xw, int yw, int a_dim, int b_dim, int g_dim,
                const int* __restrict__ terms, int nterms, int planes,
                ConvLead lead, int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ long long row_off[2 * CONV_ROWS];   // x, then y offsets
  int* sx = smem;
  int* sy = sx + CONV_ROWS * xw;
  int* st = sy + CONV_ROWS * yw;

  const long r0 = (long)blockIdx.x * CONV_ROWS;
  const int rows = n - r0 < CONV_ROWS ? (int)(n - r0) : CONV_ROWS;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    long long rest = r0 + r, ox = 0, oy = 0;
    for (int d = lead.ndim - 1; d >= 0; --d) {
      const long long c = rest % lead.size[d];
      rest /= lead.size[d];
      ox += c * lead.xs[d];
      oy += c * lead.ys[d];
    }
    row_off[r] = ox;
    row_off[CONV_ROWS + r] = oy;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * xw; i += blockDim.x) {
    const int r = i / xw;
    sx[i] = x[row_off[r] + (i - r * xw)];
  }
  for (int i = threadIdx.x; i < rows * yw; i += blockDim.x) {
    const int r = i / yw;
    sy[i] = y[row_off[CONV_ROWS + r] + (i - r * yw)];
  }
  for (int i = threadIdx.x; i < nterms * CONV_TERM; i += blockDim.x)
    st[i] = terms[i];
  __syncthreads();

  const int ow = planes * CONV_NC;
  for (int o = threadIdx.x; o < rows * ow; o += blockDim.x) {
    const int r = o / ow;
    const int rem = o - r * ow;
    const int p = rem / CONV_NC;
    const int col = rem - p * CONV_NC;
    const int lo = col > CONV_NL - 1 ? col - (CONV_NL - 1) : 0;
    const int hi = col < CONV_NL - 1 ? col : CONV_NL - 1;
    int acc = 0;
    for (int k = 0; k < nterms; ++k) {
      const int* tk = st + k * CONV_TERM;
      if (tk[3] * g_dim + tk[4] != p) continue;
      const int* u = sx + r * xw + (tk[0] * a_dim + tk[1]) * CONV_NL;
      const int* v = sy + r * yw + (tk[0] * b_dim + tk[2]) * CONV_NL;
      int s = 0;
      for (int l = lo; l <= hi; ++l) s += u[l] * v[col - l];
      acc += tk[5] * s;
    }
    out[r0 * ow + o] = acc;
  }
}

}  // namespace gs

#ifdef __CUDACC__
extern "C" int gs_conv(const int* x, const int* y, int n, int xw, int yw,
                       int a_dim, int b_dim, int g_dim, const int* terms,
                       int nterms, int planes, int ndim,
                       const long long* lead_desc, int* out,
                       cudaStream_t stream) {
  if (ndim < 0 || ndim > gs::CONV_MAX_DIMS) return (int)cudaErrorInvalidValue;
  const gs::ConvLead lead = gs::conv_lead(ndim, lead_desc);
  const int blocks = (n + gs::CONV_ROWS - 1) / gs::CONV_ROWS;
  const int smem = (gs::CONV_ROWS * (xw + yw) + gs::CONV_TERM * nterms) *
                   (int)sizeof(int);
  gs::conv_kernel<<<blocks, gs::CONV_THREADS, smem, stream>>>(
      x, y, n, xw, yw, a_dim, b_dim, g_dim, terms, nterms, planes, lead, out);
  return (int)cudaGetLastError();
}
#endif
