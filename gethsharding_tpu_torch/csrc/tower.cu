// One launch per tower product: the schoolbook planes, their pads, every
// normalize and the group merges of an Fp, Fp2, Fp12 or sparse line
// product, in one block-cooperative pass with every intermediate in
// shared memory.
//
// Built from the device code of the two TPU kernels the tower runs on:
// `pair_conv_combine` (gethsharding_tpu/ops/pallas_conv.py:113, here
// csrc/conv.cuh) and `normalize_pallas` (ops/pallas_norm.py:104 and its
// exact branch at :83, csrc/norm.cuh), in either limb form: the wide
// form's 25-limb operands or the exact form's 22 (a run-time `form`
// argument picks the template instance). Each product does, per batch
// row, exactly the steps of its plain route in ops/bn256.py and
// ops/limb.py, with the port's own pad and combine constants (passed in
// from Python, in the layout `ops/tower.py` packs), so it gives the same
// limbs:
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
// Every normalize sees the plain route's int32 accumulator at the plain
// route's width, in the form's normalize (`norm_rows<W, F>`):
//
//   form   operand  conv cols  planes (pad width)    xi·y   merges
//   wide   25       49         49 (Fp, Fp2, Fp12)    25     25
//   exact  22       43         43 (Fp), 45 (others)  23     22
//
// In the exact form the pads are two columns wider than the conv and
// xi's pad (_PAD266) one limb wider than an operand, so the accumulators
// are the pad's width; the plane width of each product comes in the pack.
// The 22-limb operands are staged into 25-limb slots of shared memory
// with zero top limbs (conv.cuh `stage_slots`), so the conv runs its
// 25-limb device code and its columns 43..48 are zero.
//
// The cyclic selection (output k takes operand j = (k - i) mod 6 of y,
// or of xi·y on wrap-around) is read through the (k, i) index tables of
// the pack, from shared memory, and never gathered into a copy.
//
// What bounds it on this card: latency. An Fp12 product needs ~90,000
// int32 multiply-adds and ~3.6 KB in and out per row, a fraction of a
// microsecond at the card's peaks even at 112 rows; what costs is the
// chain of dependent phases (four normalizes deep; the exact form's
// normalize is a longer ladder) and, before this kernel, one launch per
// conv and per normalize with PyTorch glue between. The design: one
// block of 512 threads per row for the Fp12 kinds (xi·v made once for
// the six outputs), one or eight rows per block for the Fp2 and Fp
// kinds; each phase spreads over the block's lanes (balanced column
// pairs per lane in the conv: five per lane, with the operand rows in
// registers, for the Fp12 kinds, whose conv is bound by shared-memory
// loads, one for the others; a limb per lane in the normalize).

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

// The limb form's widths (ops/tower.py `ACC_W`, `XI_W`): NL operand and
// output limbs; ACCW the widest plane accumulator (the pad stride of the
// pack); XIW the xi·y accumulator (max(NL, limbs of _PAD266)).
template <NormForm F> struct TowerForm;
template <> struct TowerForm<NORM_WIDE> {
  static constexpr int NL = 25, ACCW = 49, XIW = 25;
};
template <> struct TowerForm<NORM_EXACT> {
  static constexpr int NL = 22, ACCW = 45, XIW = 23;
};

// The pack (ops/tower.py `Plan`): the plane accumulators' width (one int,
// 2·NL - 1 <= width <= ACCW), fold (33, 22), lift (22), the xi pad (XIW),
// the plane pads (C·GR, ACCW), the selection and index tables (K, G)
// each, the plan's plane offsets (C·GR + 1), then its terms (n, 4).
template <int KIND, NormForm F> struct TowerPack {
  using S = TowerShape<KIND>;
  using W = TowerForm<F>;
  static constexpr int PL = S::C * S::GR;
  static constexpr int ACCW_AT = 0;
  static constexpr int FOLD = 1;
  static constexpr int LIFT = FOLD + NORM_FR * NORM_FB;
  static constexpr int XIPAD = LIFT + NORM_FB;
  static constexpr int PAD = XIPAD + W::XIW;
  static constexpr int SEL = PAD + PL * W::ACCW;
  static constexpr int IDX = SEL + S::K * S::G;
  static constexpr int OFF = IDX + S::K * S::G;
  static constexpr int TERMS = OFF + PL + 1;
  static constexpr int MAX_TERMS = S::G * S::A * S::B * PL;
  static constexpr int MAX = TERMS + PLAN_TERM * MAX_TERMS;
};

__host__ __device__ constexpr int tower_max(int a, int b) {
  return a > b ? a : b;
}

// u, v: the operands' first elements (u (G, A, NL) per row; v (G, B, NL),
// or (6, 2, NL) for K > 1); n rows, walked through `lead`; pack: above;
// out: (n, K, C, NL). In shared memory every limb vector takes a 25-limb
// slot (CONV_NL), its limbs above NL zero.
template <int KIND, NormForm F>
__global__ void __launch_bounds__(TowerShape<KIND>::THREADS)
    tower_kernel(const int* __restrict__ u, const int* __restrict__ v,
                 long long n, ConvLead lead, const int* __restrict__ pack,
                 int nterms, int* __restrict__ out) {
  using S = TowerShape<KIND>;
  using P = TowerPack<KIND, F>;
  using W = TowerForm<F>;
  constexpr bool XI = S::K > 1;
  constexpr int SL = CONV_NL, NC = CONV_NC;    // shared slot, conv columns
  constexpr int NL = W::NL, ACCW = W::ACCW, XIW = W::XIW;
  constexpr int UV = S::G * S::A;              // u's limb vectors per row
  constexpr int VV = XI ? 12 : S::G * S::B;    // v's
  constexpr int UW = UV * SL, VW = VV * SL;    // shared ints per row
  constexpr int PL = P::PL;
  constexpr int RK = S::ROWS * S::K;            // (row, k) pairs per block
  constexpr int NACC = RK * PL;                 // accumulator rows
  constexpr int NXI = XI ? S::ROWS * 12 : 0;    // xi rows
  constexpr int OUTW = S::C * NL;               // ints per (row, k)
  constexpr int NMAX = tower_max(NACC, NXI);    // rows of a normalize
  constexpr int NZ = tower_max(NACC * NC, NXI * XIW);
  constexpr int NT3 = tower_max(tower_max(NACC * (ACCW + 3),
                                          NXI * (XIW + 3)),
                                NACC * (NL + 3));
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
    stage_slots<NL>(s_u, u, &ou, 1, UV);
    stage_slots<NL>(s_v, v, &ov, 1, VV);
  } else {
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      lead_offsets(lead, (int)(r0 + r), s_off[r], s_off[S::ROWS + r]);
    __syncthreads();
    stage_slots<NL>(s_u, u, s_off, rows, UV);
    stage_slots<NL>(s_v, v, s_off + S::ROWS, rows, VV);
  }
  if constexpr (XI && NL < SL) {   // xi·v's slots: zero above NL limbs
    for (int t = threadIdx.x; t < rows * 12 * (SL - NL); t += blockDim.x)
      s_xi[t / (SL - NL) * SL + NL + t % (SL - NL)] = 0;
  }
  __syncthreads();
  const int* fold = s_pack + P::FOLD;
  const int* lift = s_pack + P::LIFT;
  const int* off = s_pack + P::OFF;
  const int* terms = s_pack + P::TERMS;
  const int accw = s_pack[P::ACCW_AT];         // the planes' width

  if constexpr (XI) {  // xi·v: (9a - b + pad) + (a + 9b)i per coefficient
    const int* xipad = s_pack + P::XIPAD;
    for (int t = threadIdx.x; t < rows * 12 * XIW; t += blockDim.x) {
      const int rowc = t / XIW, l = t - rowc * XIW;
      const int r = rowc / 12, row = rowc - r * 12;
      const int c = row & 1;
      const int* a = s_v + r * VW + (row - c) * SL;
      s_z[t] = c == 0 ? a[l] * 9 - a[SL + l] + xipad[l] : a[l] + a[SL + l] * 9;
    }
    __syncthreads();
    norm_rows<XIW, F>(s_z, XIW, XIW, rows * 12, s_xi, SL, fold, lift, s_t3,
                      s_f);
  }

  // the planes of each output k, padded: NP column pairs per lane
  constexpr int ITEMS = SL / S::NP;            // work items per plane
  for (int t = threadIdx.x; t < rows * S::K * PL * ITEMS; t += blockDim.x) {
    const int rkp = t / ITEMS, j = t - rkp * ITEMS;
    const int rk = rkp / PL, p = rkp - rk * PL;
    const int r = rk / S::K, k = rk - r * S::K;
    const int* sel = s_pack + P::SEL + k * S::G;
    const int* idx = s_pack + P::IDX + k * S::G;
    const int* ur = s_u + r * UW;
    const int* vr = s_v + r * VW;
    const int* xr = XI ? s_xi + r * VW : vr;     // xi·v, Fp12 kinds only
    plane_item<S::NP, ACCW>(
        terms, off[p], off[p + 1],
        [&](int i, int a) { return ur + (i * S::A + a) * SL; },
        [&](int i, int b) {
          return (sel[i] ? xr : vr) + (idx[i] * S::B + b) * SL;
        },
        j, s_pack + P::PAD + p * ACCW, s_z + rkp * NC);
  }
  __syncthreads();
  const int nrk = rows * S::K;
  norm_rows<ACCW, F>(s_z, NC, accw, nrk * PL, S::GR == 1 ? s_cur : s_parts,
                     NL, fold, lift, s_t3, s_f);

  // merge the groups in order: ((g0 + g1) -> normalize) + g2 -> normalize
  for (int g = 1; g < S::GR; ++g) {
    for (int t = threadIdx.x; t < nrk * S::C * NL; t += blockDim.x) {
      const int rc = t / NL, l = t - rc * NL;
      const int prev = g == 1 ? s_parts[rc * S::GR * NL + l] : s_cur[t];
      s_z[t] = prev + s_parts[(rc * S::GR + g) * NL + l];
    }
    __syncthreads();
    norm_rows<NL, F>(s_z, NL, NL, nrk * S::C, s_cur, NL, fold, lift, s_t3,
                     s_f);
  }

  // the block's rows lie back to back in out
  for (int t = threadIdx.x; t < nrk * OUTW; t += blockDim.x)
    out[r0 * S::K * OUTW + t] = s_cur[t];
}

}  // namespace gs

#ifdef __CUDACC__
namespace gs {

template <int KIND, NormForm F>
int launch_tower(const int* u, const int* v, long long n, ConvLead lead,
                 const int* pack, int nterms, int* out, cudaStream_t stream) {
  using S = TowerShape<KIND>;
  if (nterms < 0 || nterms > TowerPack<KIND, F>::MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + S::ROWS - 1) / S::ROWS;
  tower_kernel<KIND, F><<<(unsigned)blocks, S::THREADS, 0, stream>>>(
      u, v, n, lead, pack, nterms, out);
  return (int)cudaGetLastError();
}

template <NormForm F>
int launch_kind(int kind, const int* u, const int* v, long long n,
                ConvLead lead, const int* pack, int nterms, int* out,
                cudaStream_t stream) {
  switch (kind) {
    case TOWER_FP:
      return launch_tower<TOWER_FP, F>(u, v, n, lead, pack, nterms, out,
                                       stream);
    case TOWER_FP2:
      return launch_tower<TOWER_FP2, F>(u, v, n, lead, pack, nterms, out,
                                        stream);
    case TOWER_FP12:
      return launch_tower<TOWER_FP12, F>(u, v, n, lead, pack, nterms, out,
                                         stream);
    case TOWER_LINE:
      return launch_tower<TOWER_LINE, F>(u, v, n, lead, pack, nterms, out,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gs

// form: gs::NormForm (0 wide, 1 exact), the limb form of the operands,
// the pack and the output.
extern "C" int gs_tower(int kind, int form, const int* u, const int* v,
                        long long n, int ndim, const long long* lead_desc,
                        const int* pack, int nterms, int* out,
                        cudaStream_t stream) {
  if (ndim < 0 || ndim > gs::CONV_MAX_DIMS) return (int)cudaErrorInvalidValue;
  const gs::ConvLead lead = gs::conv_lead(ndim, lead_desc);
  if (form == gs::NORM_WIDE)
    return gs::launch_kind<gs::NORM_WIDE>(kind, u, v, n, lead, pack, nterms,
                                          out, stream);
  if (form == gs::NORM_EXACT)
    return gs::launch_kind<gs::NORM_EXACT>(kind, u, v, n, lead, pack, nterms,
                                           out, stream);
  return (int)cudaErrorInvalidValue;
}
#endif
