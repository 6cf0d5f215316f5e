// One launch per tower product: the schoolbook planes, their pads, every
// normalize and the group merges of an Fp, Fp2, Fp12 or sparse line
// product, in one block-cooperative pass with every intermediate in
// shared memory.
//
// Built from the device code of the two TPU kernels the tower runs on:
// `pair_conv_combine` (gethsharding_tpu/ops/pallas_conv.py:113, here
// csrc/conv.cuh) and `normalize_pallas` (ops/pallas_norm.py:104, wide
// form, csrc/norm.cuh). Each product does, per batch row, exactly the
// steps of its plain route in ops/bn256.py and ops/limb.py, with the
// port's own pad and combine constants (passed in from Python, in the
// layout `ops/tower.py` packs), so it gives the same limbs:
//
//   kind  product                   steps per row
//   FP    ModArith.mul              conv (identity) -> normalize
//   FP2   fp2_mul, fp2_sqr          conv -> + _FP2_PAD -> normalize
//   FP12  fp12_mul, fp12_sqr        xi·y (9a - b + _PAD266, a + 9b) ->
//                                   normalize; conv of the 24 planes with
//                                   the cyclic operand selection ->
//                                   + _GROUP_PAD[3] -> normalize; merge
//                                   groups 0 + 1 -> normalize; + group 2
//                                   -> normalize
//   LINE  fp12_mul_line             the same with the line's 12 planes,
//                                   _GROUP_PAD[2] and one merge
//
// The cyclic selection (output k takes operand j = (k - i) mod 6 of y,
// or of xi·y on wrap-around) is read through the (k, i) index tables of
// the pack, from shared memory, and never gathered into a copy.
//
// What bounds it on this card: latency. An Fp12 product needs ~90,000
// int32 multiply-adds and ~3.6 KB in and out per row, a fraction of a
// microsecond at the card's peaks even at 112 rows; what costs is the
// chain of dependent phases (four normalizes deep) and, before this
// kernel, one launch per conv and per normalize with PyTorch glue between.
// The design: one block of 512 threads per row for the Fp12 kinds (xi·v
// made once for the six outputs), one or eight rows per block for the
// Fp2 and Fp kinds; each phase spreads over the block's lanes (balanced
// column pairs per lane in the conv: five per lane, with the operand
// rows in registers, for the Fp12 kinds, whose conv is bound by
// shared-memory loads, one for the others; a limb per lane in the
// normalize).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "conv.cuh"
#include "norm.cuh"

namespace gs {

enum TowerKind { TOWER_FP = 0, TOWER_FP2 = 1, TOWER_FP12 = 2, TOWER_LINE = 3 };

// G, A, B: the operand planes (u: G × A; v: G × B, or the Fp12 6 × 2 for
// K > 1); C, GR: output components and accumulation groups per output;
// K: outputs per row; ROWS: batch rows per block; NP: column pairs per
// conv work item (conv.cuh); THREADS: enough that the widest phase takes
// a few passes.
template <int KIND> struct TowerShape;
template <> struct TowerShape<TOWER_FP> {
  static constexpr int G = 1, A = 1, B = 1, C = 1, GR = 1, K = 1, ROWS = 8,
                       NP = 1, THREADS = 256;
};
template <> struct TowerShape<TOWER_FP2> {
  static constexpr int G = 1, A = 2, B = 2, C = 2, GR = 1, K = 1, ROWS = 1,
                       NP = 1, THREADS = 64;
};
template <> struct TowerShape<TOWER_FP12> {
  static constexpr int G = 6, A = 2, B = 2, C = 2, GR = 3, K = 6, ROWS = 1,
                       NP = 5, THREADS = 512;
};
template <> struct TowerShape<TOWER_LINE> {
  static constexpr int G = 3, A = 2, B = 2, C = 2, GR = 2, K = 6, ROWS = 1,
                       NP = 5, THREADS = 512;
};

// The pack (ops/tower.py `Plan`): fold (33, 22), lift (22), the xi pad
// (25), the plane pads (C·GR, 49), the selection and index tables (K, G)
// each, the plan's plane offsets (C·GR + 1), then its terms (n, 4).
template <int KIND> struct TowerPack {
  using S = TowerShape<KIND>;
  static constexpr int PL = S::C * S::GR;
  static constexpr int FOLD = 0;
  static constexpr int LIFT = FOLD + NORM_FR * NORM_FB;
  static constexpr int XIPAD = LIFT + NORM_FB;
  static constexpr int PAD = XIPAD + CONV_NL;
  static constexpr int SEL = PAD + PL * CONV_NC;
  static constexpr int IDX = SEL + S::K * S::G;
  static constexpr int OFF = IDX + S::K * S::G;
  static constexpr int TERMS = OFF + PL + 1;
  static constexpr int MAX_TERMS = S::G * S::A * S::B * PL;
  static constexpr int MAX = TERMS + PLAN_TERM * MAX_TERMS;
};

// u, v: the operands' first elements (u (G, A, 25) per row; v (G, B, 25),
// or (6, 2, 25) for K > 1); n rows, walked through `lead`; pack: above;
// out: (n, K, C, 25).
template <int KIND>
__global__ void __launch_bounds__(TowerShape<KIND>::THREADS)
    tower_kernel(const int* __restrict__ u, const int* __restrict__ v,
                 long long n, ConvLead lead, const int* __restrict__ pack,
                 int nterms, int* __restrict__ out) {
  using S = TowerShape<KIND>;
  using P = TowerPack<KIND>;
  constexpr bool XI = S::K > 1;
  constexpr int NL = CONV_NL, NC = CONV_NC;
  constexpr int UW = S::G * S::A * NL;
  constexpr int VW = XI ? 12 * NL : S::G * S::B * NL;
  constexpr int PL = P::PL;
  constexpr int RK = S::ROWS * S::K;            // (row, k) pairs per block
  constexpr int NACC = RK * PL;                 // accumulator rows
  constexpr int NXI = XI ? S::ROWS * 12 : 0;    // xi rows
  constexpr int OUTW = S::C * NL;               // ints per (row, k)
  constexpr int NMAX = NACC > NXI ? NACC : NXI;  // rows of a normalize
  constexpr int NZ = NACC * NC > NXI * NL ? NACC * NC : NXI * NL;
  constexpr int NT3 = NACC * (NC + 3) > NMAX * (NL + 3) ? NACC * (NC + 3)
                                                        : NMAX * (NL + 3);
  __shared__ __align__(16) int s_u[S::ROWS * UW];
  __shared__ __align__(16) int s_v[S::ROWS * VW];
  __shared__ int s_xi[XI ? S::ROWS * VW : 1];
  __shared__ __align__(16) int s_pack[P::MAX];
  __shared__ int s_z[NZ];
  __shared__ int s_t3[NT3];
  __shared__ int s_f[NMAX * NORM_FB];
  __shared__ int s_parts[NACC * NL];
  __shared__ int s_cur[RK * OUTW];

  __shared__ long long s_off[2 * S::ROWS];     // u, then v offsets

  const long long r0 = (long long)blockIdx.x * S::ROWS;
  const int rows = n - r0 < S::ROWS ? (int)(n - r0) : S::ROWS;
  stage_ints(s_pack, pack, P::TERMS + PLAN_TERM * nterms);
  if constexpr (S::ROWS == 1) {
    // one row: every thread walks the lead itself, so the operands load
    // in the same phase as the pack
    long long ou, ov;
    lead_offsets(lead, (int)r0, ou, ov);
    stage_ints(s_u, u + ou, UW);
    stage_ints(s_v, v + ov, VW);
  } else {
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      lead_offsets(lead, (int)(r0 + r), s_off[r], s_off[S::ROWS + r]);
    __syncthreads();
    stage_rows(s_u, UW, u, s_off, rows, UW);
    stage_rows(s_v, VW, v, s_off + S::ROWS, rows, VW);
  }
  __syncthreads();
  const int* fold = s_pack + P::FOLD;
  const int* lift = s_pack + P::LIFT;
  const int* off = s_pack + P::OFF;
  const int* terms = s_pack + P::TERMS;

  if (XI) {  // xi·v: (9a - b + pad) + (a + 9b)i per coefficient
    const int* xipad = s_pack + P::XIPAD;
    for (int t = threadIdx.x; t < rows * VW; t += blockDim.x) {
      const int r = t / VW, rem = t - r * VW;
      const int row = rem / NL, l = rem - row * NL;
      const int c = row & 1;
      const int* a = s_v + r * VW + (row - c) * NL;
      s_z[t] = c == 0 ? a[l] * 9 - a[NL + l] + xipad[l] : a[l] + a[NL + l] * 9;
    }
    __syncthreads();
    norm_rows<NL>(s_z, NL, NL, rows * 12, s_xi, NL, fold, lift, s_t3, s_f);
  }

  // the planes of each output k, padded: NP column pairs per lane
  constexpr int ITEMS = NL / S::NP;            // work items per plane
  for (int t = threadIdx.x; t < rows * S::K * PL * ITEMS; t += blockDim.x) {
    const int rkp = t / ITEMS, j = t - rkp * ITEMS;
    const int rk = rkp / PL, p = rkp - rk * PL;
    const int r = rk / S::K, k = rk - r * S::K;
    const int* sel = s_pack + P::SEL + k * S::G;
    const int* idx = s_pack + P::IDX + k * S::G;
    const int* ur = s_u + r * UW;
    const int* vr = s_v + r * VW;
    const int* xr = XI ? s_xi + r * VW : vr;     // xi·v, Fp12 kinds only
    plane_item<S::NP>(
        terms, off[p], off[p + 1],
        [&](int i, int a) { return ur + (i * S::A + a) * NL; },
        [&](int i, int b) {
          return (sel[i] ? xr : vr) + (idx[i] * S::B + b) * NL;
        },
        j, s_pack + P::PAD + p * NC, s_z + rkp * NC);
  }
  __syncthreads();
  const int nrk = rows * S::K;
  norm_rows<NC>(s_z, NC, NC, nrk * PL, S::GR == 1 ? s_cur : s_parts, NL,
                fold, lift, s_t3, s_f);

  // merge the groups in order: ((g0 + g1) -> normalize) + g2 -> normalize
  for (int g = 1; g < S::GR; ++g) {
    for (int t = threadIdx.x; t < nrk * S::C * NL; t += blockDim.x) {
      const int rc = t / NL, l = t - rc * NL;
      const int prev = g == 1 ? s_parts[rc * S::GR * NL + l] : s_cur[t];
      s_z[t] = prev + s_parts[(rc * S::GR + g) * NL + l];
    }
    __syncthreads();
    norm_rows<NL>(s_z, NL, NL, nrk * S::C, s_cur, NL, fold, lift, s_t3,
                  s_f);
  }

  // the block's rows lie back to back in out
  for (int t = threadIdx.x; t < nrk * OUTW; t += blockDim.x)
    out[r0 * S::K * OUTW + t] = s_cur[t];
}

}  // namespace gs

#ifdef __CUDACC__
namespace gs {

template <int KIND>
int launch_tower(const int* u, const int* v, long long n, ConvLead lead,
                 const int* pack, int nterms, int* out, cudaStream_t stream) {
  using S = TowerShape<KIND>;
  if (nterms < 0 || nterms > TowerPack<KIND>::MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + S::ROWS - 1) / S::ROWS;
  tower_kernel<KIND><<<(unsigned)blocks, S::THREADS, 0, stream>>>(
      u, v, n, lead, pack, nterms, out);
  return (int)cudaGetLastError();
}

}  // namespace gs

extern "C" int gs_tower(int kind, const int* u, const int* v, long long n,
                        int ndim, const long long* lead_desc, const int* pack,
                        int nterms, int* out, cudaStream_t stream) {
  if (ndim < 0 || ndim > gs::CONV_MAX_DIMS) return (int)cudaErrorInvalidValue;
  const gs::ConvLead lead = gs::conv_lead(ndim, lead_desc);
  switch (kind) {
    case gs::TOWER_FP:
      return gs::launch_tower<gs::TOWER_FP>(u, v, n, lead, pack, nterms, out,
                                            stream);
    case gs::TOWER_FP2:
      return gs::launch_tower<gs::TOWER_FP2>(u, v, n, lead, pack, nterms,
                                             out, stream);
    case gs::TOWER_FP12:
      return gs::launch_tower<gs::TOWER_FP12>(u, v, n, lead, pack, nterms,
                                              out, stream);
    case gs::TOWER_LINE:
      return gs::launch_tower<gs::TOWER_LINE>(u, v, n, lead, pack, nterms,
                                              out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif
