// Masked committee sums of vote signatures (G1) and voter pubkeys (G2),
// one block per batch row.
//
// Replaces the TPU kernel `aggregate_proj` of
// gethsharding_tpu/ops/pallas_finalexp.py (its pallas_call at :1062): the
// committee, padded to a power of two with identity slots, is summed by a
// halving tree of Renes-Costello-Batina complete projective additions
// (a = 0; 3·b = 9 on G1, 3·b' on the twist for G2). Two instantiations of
// one kernel: NCOMP = 1 (Fp, G1) and NCOMP = 2 (Fp2, G2).
//
// What bounds it on this card: int32 multiply-adds. A 256-slot G2 tree is
// 255 additions of 12 fp2 products and ~17 normalizes each (~10 M
// multiply-adds per row) against 29 KB of input per row. The design: the
// point stack of each row lives in a global scratch tensor (256 G2 points
// and their temporaries do not fit in shared memory), each tree level is
// walked in chunks of 16 / NCOMP pairs whose RCB16 formulas run as the
// register machine of field.cuh in shared memory, and __syncthreads()
// separates chunks and levels. The scratch stays in L2 (150 KB per row).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

namespace gs {

enum AReg : unsigned char {
  X1, Y1, Z1, X2, Y2, Z2, A1, A2, B1, B2, C1, C2, T0, T1, T2, M3, M4, M5,
  S01, S12, S02, U0, T2B, T3, T4, T5, T0B, ZS, T1B, YB, P1, P2, P3, P4, P5,
  P6, B3R, A_NREG
};

// RCB16 algorithm 7 as phases; the sum lands in (X1, Y1, Z1). The two
// multiplications by 3·b are products with the B3R register on G2 and
// SCL 9 on G1.
__constant__ Ins G2_INS[] = {
    {ADD, X1, Y1, A1}, {ADD, X2, Y2, A2}, {ADD, Y1, Z1, B1},
    {ADD, Y2, Z2, B2}, {ADD, X1, Z1, C1}, {ADD, X2, Z2, C2},
    {MUL, X1, X2, T0}, {MUL, Y1, Y2, T1}, {MUL, Z1, Z2, T2},
    {MUL, A1, A2, M3}, {MUL, B1, B2, M4}, {MUL, C1, C2, M5},
    {ADD, T0, T1, S01}, {ADD, T1, T2, S12}, {ADD, T0, T2, S02},
    {ADD, T0, T0, U0},
    {MUL, T2, B3R, T2B},
    {SUB, M3, S01, T3}, {SUB, M4, S12, T4}, {SUB, M5, S02, T5},
    {ADD, U0, T0, T0B}, {ADD, T1, T2B, ZS}, {SUB, T1, T2B, T1B},
    {MUL, T5, B3R, YB},
    {MUL, T3, T1B, P1}, {MUL, T4, YB, P2}, {MUL, T1B, ZS, P3},
    {MUL, T0B, YB, P4}, {MUL, ZS, T4, P5}, {MUL, T0B, T3, P6},
    {SUB, P1, P2, X1}, {ADD, P3, P4, Y1}, {ADD, P5, P6, Z1},
};
__constant__ Phase G2_PH[] = {{0, 0, 6},  {1, 6, 6},  {0, 12, 4},
                              {1, 16, 1}, {0, 17, 6}, {1, 23, 1},
                              {1, 24, 6}, {0, 30, 3}};

__constant__ Ins G1_INS[] = {
    {ADD, X1, Y1, A1}, {ADD, X2, Y2, A2}, {ADD, Y1, Z1, B1},
    {ADD, Y2, Z2, B2}, {ADD, X1, Z1, C1}, {ADD, X2, Z2, C2},
    {MUL, X1, X2, T0}, {MUL, Y1, Y2, T1}, {MUL, Z1, Z2, T2},
    {MUL, A1, A2, M3}, {MUL, B1, B2, M4}, {MUL, C1, C2, M5},
    {ADD, T0, T1, S01}, {ADD, T1, T2, S12}, {ADD, T0, T2, S02},
    {ADD, T0, T0, U0}, {SCL, T2, 9, T2B},
    {SUB, M3, S01, T3}, {SUB, M4, S12, T4}, {SUB, M5, S02, T5},
    {ADD, U0, T0, T0B}, {ADD, T1, T2B, ZS}, {SUB, T1, T2B, T1B},
    {SCL, T5, 9, YB},
    {MUL, T3, T1B, P1}, {MUL, T4, YB, P2}, {MUL, T1B, ZS, P3},
    {MUL, T0B, YB, P4}, {MUL, ZS, T4, P5}, {MUL, T0B, T3, P6},
    {SUB, P1, P2, X1}, {ADD, P3, P4, Y1}, {ADD, P5, P6, Z1},
};
__constant__ Phase G1_PH[] = {{0, 0, 6},  {1, 6, 6},  {0, 12, 5},
                              {0, 17, 6}, {0, 23, 1}, {1, 24, 6},
                              {0, 30, 3}};

template <int NCOMP>
struct AggShape {
  static constexpr int E = NCOMP * NL;    // ints per coordinate
  static constexpr int CH = 16 / NCOMP;   // pairs per chunk
  static constexpr int SMEM_INTS = C_TOTAL + A_NREG * CH * E + 6 * CH * E / NL * NC;
};

template <int NCOMP>
__global__ void __launch_bounds__(THREADS)
    agg_kernel(const int* __restrict__ xs, const int* __restrict__ ys,
               const int* __restrict__ mask, int C, int cp,
               const int* __restrict__ consts, int* __restrict__ scratch,
               int* __restrict__ ox, int* __restrict__ oy,
               int* __restrict__ oz) {
  constexpr int E = AggShape<NCOMP>::E, CH = AggShape<NCOMP>::CH;
  const Ins* ins = NCOMP == 2 ? G2_INS : G1_INS;
  const Phase* ph = NCOMP == 2 ? G2_PH : G1_PH;
  const int nph = NCOMP == 2 ? 8 : 7;
  extern __shared__ int smem[];
  int* T = smem;
  RegFile<NCOMP> R{T + C_TOTAL, CH};
  int* col = R.base + A_NREG * CH * E;

  load_consts(T, consts);
  const long b = blockIdx.x;
  const int* X = xs + b * C * E;
  const int* Y = ys + b * C * E;
  const int* M = mask + b * C;
  int* S = scratch + b * cp * 3 * E;  // stack [slot][coordinate][E]
  // masked-off and padding slots are the identity (0 : 1 : 0)
  for (int e = threadIdx.x; e < cp * 3 * E; e += blockDim.x) {
    const int slot = e / (3 * E), coord = (e / E) % 3, i = e % E;
    const bool on = slot < C && M[slot] != 0;
    int v;
    if (coord == 0)
      v = on ? X[slot * E + i] : 0;
    else if (coord == 1)
      v = on ? Y[slot * E + i] : i == 0;
    else
      v = on ? i == 0 : 0;
    S[e] = v;
  }
  __syncthreads();

  for (int size = cp; size > 1; size >>= 1) {
    const int half = size >> 1;
    for (int c0 = 0; c0 < half; c0 += CH) {
      const int nl = half - c0 < CH ? half - c0 : CH;
      for (int e = threadIdx.x; e < nl * 6 * E; e += blockDim.x) {
        const int l = e / (6 * E), q = (e / E) % 6, i = e % E;
        const int slot = c0 + l + (q >= 3 ? half : 0);
        R.at(q, l, 0)[i] = S[(slot * 3 + q % 3) * E + i];
        if (NCOMP == 2 && q == 0) R.at(B3R, l, 0)[i] = T[C_B3 + i];
      }
      __syncthreads();
      run_phases<NCOMP>(ph, nph, ins, R, nl, col, T);
      for (int e = threadIdx.x; e < nl * 3 * E; e += blockDim.x) {
        const int l = e / (3 * E), q = (e / E) % 3, i = e % E;
        S[((c0 + l) * 3 + q) * E + i] = R.at(q, l, 0)[i];
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    ox[b * E + i] = S[i];
    oy[b * E + i] = S[E + i];
    oz[b * E + i] = S[2 * E + i];
  }
}

}  // namespace gs

#ifdef __CUDACC__
template <int NCOMP>
static int launch_agg(const int* xs, const int* ys, const int* mask, int n,
                      int C, int cp, const int* consts, int* scratch, int* ox,
                      int* oy, int* oz, cudaStream_t stream) {
  const int smem = gs::AggShape<NCOMP>::SMEM_INTS * (int)sizeof(int);
  cudaFuncSetAttribute(gs::agg_kernel<NCOMP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gs::agg_kernel<NCOMP><<<n, gs::THREADS, smem, stream>>>(
      xs, ys, mask, C, cp, consts, scratch, ox, oy, oz);
  return (int)cudaGetLastError();
}

// G1: xs, ys (n, C, 25); G2: xs, ys (n, C, 2, 25); mask (n, C); scratch
// (n, cp, 3, [2,] 25); ox, oy, oz (n, [2,] 25); all int32. cp is the
// committee padded to a power of two >= 2. Returns cudaGetLastError().
extern "C" int gs_agg_g1(const int* xs, const int* ys, const int* mask, int n,
                         int C, int cp, const int* consts, int* scratch,
                         int* ox, int* oy, int* oz, cudaStream_t stream) {
  return launch_agg<1>(xs, ys, mask, n, C, cp, consts, scratch, ox, oy, oz,
                       stream);
}

extern "C" int gs_agg_g2(const int* xs, const int* ys, const int* mask, int n,
                         int C, int cp, const int* consts, int* scratch,
                         int* ox, int* oy, int* oz, cudaStream_t stream) {
  return launch_agg<2>(xs, ys, mask, n, C, cp, consts, scratch, ox, oy, oz,
                       stream);
}
#endif
