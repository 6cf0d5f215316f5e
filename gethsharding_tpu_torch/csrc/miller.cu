// Projective shared-accumulator optimal-ate Miller product of the BLS
// committee check, e(sig, G2)·e(-H, pk), one block per batch row.
//
// Replaces the TPU kernel `miller_f` of
// gethsharding_tpu/ops/pallas_finalexp.py (its pallas_call at :873): the
// 88-step DBL / ADD walk of the aggregate pubkey on the twist, four add
// candidates [+Q, -Q, pi Q, -pi^2 Q] made inside the kernel, and per step
// the precomputed G2-generator line evaluated at the aggregate signature.
//
// What bounds it on this card: int32 multiply-adds in a long dependent
// chain. Each step is ~20 fp2 products and ~20 normalizes in ~11
// dependent phases, one fp12 square on doubling steps and two sparse line
// products; the bytes (1.4 KB in, 1.2 KB out per row, and the 52.8 KB
// generator-line table read once per block from L2) are negligible. The
// design: the point walk runs as a small register machine (`Ins` phases of
// field.cuh) whose phases group the step's independent fp2 operations, so
// the 256 threads of the block work on all of a phase's columns at once;
// the state, candidates and temporaries stay in shared memory.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

namespace gs {

// registers: Fp values use component 0 of a two-component register
enum MReg : unsigned char {
  SX, SY, SZ, HX, HY, PKX, PKY, PKZ, TW0, TW1, TW2, TW3,
  CJX, CJY, ZCJ, NPKY, HYN, Q1X, Q1Y, Q2X, Q2Y, ZZ0, ZZC, Q2NY, ZN0, ZN2,
  C0X, C0Y, C0ZZZ, C1Y, C2X, C2Y, C2ZZZ, C3X, C3Y,
  X, Y, Z, LC0, LC1, LC2, G0, G1, G2, CX, CY, CZ, CZZ, CZZZ, L0, L1, L2,
  // doubling temporaries
  DA, DBQ, DZZ, DYZ, DXB, DE, DZ3, DB2, DCQ, DT, DF, DCPY, DEZZ, DEX, DTA,
  DCPX, DC8, DTAC, DD, DD2, DX3, DDX, DEDX, DY3,
  // addition temporaries
  JZ1Z1, JU1, JS1, JZ1Z2, JX1Y2, JX2Y1, JU2, JZ1C, JX1Y2Z1, JX2Y1Z2, JH, JS2,
  JHH, JZ3, JR, JV, JHHH, JRR, JNR, JV2, JT, JX3, JVX, JRVX, JS1H, JY3,
  M_NREG
};

// the four add candidates as (x·z, y·z^2, z, z^2, z^3) registers; equal
// products (e.g. pkz^2 for +Q, -Q and -pi^2 Q) are computed once
__constant__ unsigned char CAND[4][5] = {
    {C0X, C0Y, ZN0, ZZ0, C0ZZZ},
    {C0X, C1Y, ZN0, ZZ0, C0ZZZ},
    {C2X, C2Y, ZN2, ZZC, C2ZZZ},
    {C3X, C3Y, ZN0, ZZ0, C0ZZZ},
};

// preamble: candidates, the walk's start (X, Y, Z) = (C0X, C0Y, ZN0), -hy
__constant__ Ins PRE_INS[] = {
    {CNJ, PKX, 0, CJX}, {CNJ, PKY, 0, CJY}, {CNJ, PKZ, 0, ZCJ},
    {NEG, PKY, 0, NPKY}, {NEG, HY, 0, HYN}, {CPY, PKZ, 0, ZN0},
    {MUL, CJX, TW0, Q1X}, {MUL, CJY, TW1, Q1Y}, {MUL, PKX, TW2, Q2X},
    {MUL, PKY, TW3, Q2Y}, {MUL, PKZ, PKZ, ZZ0}, {MUL, ZCJ, ZCJ, ZZC},
    {MUL, PKX, PKZ, C0X},
    {NEG, Q2Y, 0, Q2NY}, {CPY, ZCJ, 0, ZN2},
    {MUL, PKY, ZZ0, C0Y}, {MUL, PKZ, ZZ0, C0ZZZ}, {MUL, NPKY, ZZ0, C1Y},
    {MUL, Q1X, ZCJ, C2X}, {MUL, Q1Y, ZZC, C2Y}, {MUL, ZCJ, ZZC, C2ZZZ},
    {MUL, Q2X, PKZ, C3X}, {MUL, Q2NY, ZZ0, C3Y},
};
__constant__ Phase PRE_PH[] = {{0, 0, 6}, {1, 6, 7}, {0, 13, 2}, {1, 15, 8}};

// the generator line at the signature: (c_py·sy, c_px·sx, c_const·sz)
__constant__ Ins GEN_INS[] = {
    {MFP, LC0, SY, G0}, {MFP, LC1, SX, G1}, {MFP, LC2, SZ, G2}};
__constant__ Phase GEN_PH[] = {{1, 0, 3}};

// tangent step at (px, py) = (hx, -hy); line (L0, L1, L2), T' = (DX3,
// DY3, DZ3)
__constant__ Ins DBL_INS[] = {
    {MUL, X, X, DA}, {MUL, Y, Y, DBQ}, {MUL, Z, Z, DZZ}, {MUL, Y, Z, DYZ},
    {ADD, X, DBQ, DXB}, {SCL, DA, 3, DE}, {SCL, DYZ, 2, DZ3},
    {SCL, DBQ, 2, DB2},
    {MUL, DBQ, DBQ, DCQ}, {MUL, DXB, DXB, DT}, {MUL, DE, DE, DF},
    {MUL, DZ3, DZZ, DCPY}, {MUL, DE, DZZ, DEZZ}, {MUL, DE, X, DEX},
    {SUB, DT, DA, DTA}, {NEG, DEZZ, 0, DCPX}, {SUB, DEX, DB2, L2},
    {SCL, DCQ, 8, DC8},
    {SUB, DTA, DCQ, DTAC},
    {SCL, DTAC, 2, DD},
    {SCL, DD, 2, DD2},
    {SUB, DF, DD2, DX3},
    {SUB, DD, DX3, DDX},
    {MUL, DE, DDX, DEDX}, {MFP, DCPY, HYN, L0}, {MFP, DCPX, HX, L1},
    {SUB, DEDX, DC8, DY3},
};
__constant__ Phase DBL_PH[] = {{1, 0, 4},  {0, 4, 4},  {1, 8, 6},
                               {0, 14, 4}, {0, 18, 1}, {0, 19, 1},
                               {0, 20, 1}, {0, 21, 1}, {0, 22, 1},
                               {1, 23, 3}, {0, 26, 1}};

// chord step with the candidate in (CX, CY, CZ, CZZ, CZZZ); T' = (JX3,
// JY3, JZ3)
__constant__ Ins ADD_INS[] = {
    {MUL, Z, Z, JZ1Z1}, {MUL, X, CZZ, JU1}, {MUL, Y, CZZZ, JS1},
    {MUL, Z, CZ, JZ1Z2}, {MUL, X, CY, JX1Y2}, {MUL, CX, Y, JX2Y1},
    {MUL, CX, JZ1Z1, JU2}, {MUL, Z, JZ1Z1, JZ1C}, {MUL, JX1Y2, Z, JX1Y2Z1},
    {MUL, JX2Y1, CZ, JX2Y1Z2},
    {SUB, JU2, JU1, JH}, {SUB, JX1Y2Z1, JX2Y1Z2, L2},
    {MUL, CY, JZ1C, JS2}, {MUL, JH, JH, JHH}, {MUL, JZ1Z2, JH, JZ3},
    {SUB, JS2, JS1, JR},
    {MUL, JU1, JHH, JV}, {MUL, JH, JHH, JHHH}, {MUL, JR, JR, JRR},
    {MFP, JZ3, HYN, L0},
    {NEG, JR, 0, JNR}, {SCL, JV, 2, JV2}, {SUB, JRR, JHHH, JT},
    {SUB, JT, JV2, JX3},
    {SUB, JV, JX3, JVX},
    {MUL, JR, JVX, JRVX}, {MUL, JS1, JHHH, JS1H}, {MFP, JNR, HX, L1},
    {SUB, JRVX, JS1H, JY3},
};
__constant__ Phase ADD_PH[] = {{1, 0, 6},  {1, 6, 4},  {0, 10, 2},
                               {1, 12, 3}, {0, 15, 1}, {1, 16, 4},
                               {0, 20, 3}, {0, 23, 1}, {0, 24, 1},
                               {1, 25, 3}, {0, 28, 1}};

constexpr int FP2 = 2 * NL;
constexpr int M_SMEM_INTS =
    C_TOTAL + M_NREG * FP2 + FP12 + FP12 + 36 * NC + 36 * NL + 12 * NL;

__device__ __forceinline__ void set_state(RegFile<2> R, int x, int y, int z) {
  for (int i = threadIdx.x; i < FP2; i += blockDim.x) {
    R.at(X, 0, 0)[i] = R.at(x, 0, 0)[i];
    R.at(Y, 0, 0)[i] = R.at(y, 0, 0)[i];
    R.at(Z, 0, 0)[i] = R.at(z, 0, 0)[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    miller_kernel(const int* __restrict__ sx, const int* __restrict__ sy,
                  const int* __restrict__ sz, const int* __restrict__ hx,
                  const int* __restrict__ hy, const int* __restrict__ pkx,
                  const int* __restrict__ pky, const int* __restrict__ pkz,
                  const int* __restrict__ ops, int nops,
                  const int* __restrict__ lines, const int* __restrict__ twf,
                  const int* __restrict__ consts, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* T = smem;
  RegFile<2> R{T + C_TOTAL, 1};
  int* f = R.base + M_NREG * FP2;
  Fp12Scratch S;
  S.xi = f + FP12;
  S.col = S.xi + FP12;
  S.parts = S.col + 36 * NC;
  S.merged = S.parts + 36 * NL;

  load_consts(T, consts);
  const long b = blockIdx.x;
  for (int i = threadIdx.x; i < M_NREG * FP2; i += blockDim.x) R.base[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < NL; i += blockDim.x) {
    R.at(SX, 0, 0)[i] = sx[b * NL + i];
    R.at(SY, 0, 0)[i] = sy[b * NL + i];
    R.at(SZ, 0, 0)[i] = sz[b * NL + i];
    R.at(HX, 0, 0)[i] = hx[b * NL + i];
    R.at(HY, 0, 0)[i] = hy[b * NL + i];
  }
  for (int i = threadIdx.x; i < FP2; i += blockDim.x) {
    R.at(PKX, 0, 0)[i] = pkx[b * FP2 + i];
    R.at(PKY, 0, 0)[i] = pky[b * FP2 + i];
    R.at(PKZ, 0, 0)[i] = pkz[b * FP2 + i];
  }
  for (int i = threadIdx.x; i < 4 * FP2; i += blockDim.x)
    R.at(TW0, 0, 0)[i] = twf[i];
  for (int i = threadIdx.x; i < FP12; i += blockDim.x) f[i] = i == 0;
  __syncthreads();

  run_phases<2>(PRE_PH, 4, PRE_INS, R, 1, S.col, T);
  set_state(R, C0X, C0Y, ZN0);

  for (int s = 0; s < nops; ++s) {
    const int op = ops[s];
    copy_ints(R.at(LC0, 0, 0), lines + (long)s * 3 * FP2, 3 * FP2);
    run_phases<2>(GEN_PH, 1, GEN_INS, R, 1, S.col, T);
    if (op == 0) {
      run_phases<2>(DBL_PH, 11, DBL_INS, R, 1, S.col, T);
      fp12_mul(f, f, f, 1, S, T);
      set_state(R, DX3, DY3, DZ3);
    } else {
      for (int i = threadIdx.x; i < 5 * FP2; i += blockDim.x)
        R.at(CX, 0, 0)[i] = R.at(CAND[op - 1][i / FP2], 0, 0)[i % FP2];
      __syncthreads();
      run_phases<2>(ADD_PH, 11, ADD_INS, R, 1, S.col, T);
      set_state(R, JX3, JY3, JZ3);
    }
    fp12_mul_line(f, R.at(G0, 0, 0), R.at(G1, 0, 0), R.at(G2, 0, 0), f, S,
                  T);
    fp12_mul_line(f, R.at(L0, 0, 0), R.at(L1, 0, 0), R.at(L2, 0, 0), f, S,
                  T);
  }

  for (int i = threadIdx.x; i < FP12; i += blockDim.x)
    out[b * FP12 + i] = f[i];
}

}  // namespace gs

#ifdef __CUDACC__
// sx, sy, sz, hx, hy: (n, 25); pkx, pky, pkz: (n, 2, 25); ops: (nops,);
// lines: (nops, 3, 2, 25); twf: (4, 2, 25); out: (n, 6, 2, 25); all int32.
// Returns cudaGetLastError() after the launch.
extern "C" int gs_miller(const int* sx, const int* sy, const int* sz,
                         const int* hx, const int* hy, const int* pkx,
                         const int* pky, const int* pkz, const int* ops,
                         int nops, const int* lines, const int* twf,
                         const int* consts, int n, int* out,
                         cudaStream_t stream) {
  const int smem = gs::M_SMEM_INTS * (int)sizeof(int);
  cudaFuncSetAttribute(gs::miller_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gs::miller_kernel<<<n, gs::THREADS, smem, stream>>>(
      sx, sy, sz, hx, hy, pkx, pky, pkz, ops, nops, lines, twf, consts, out);
  return (int)cudaGetLastError();
}
#endif
