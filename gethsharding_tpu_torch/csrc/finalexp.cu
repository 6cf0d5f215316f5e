// Final exponentiation == 1? for the committee audit, one block per batch
// row.
//
// Replaces the TPU kernel `finalexp_is_one` of
// gethsharding_tpu/ops/pallas_finalexp.py (its pallas_call at :488): the
// whole inversion-free, fraction-stacked final exponentiation (easy part,
// three x^u NAF ladders, the Devegili-Scott-Dahab hard part) as a register
// machine driven by a 292-step program of mul / swap / frobenius / copy
// over 14 fp12 registers, each holding a numerator and a denominator.
//
// What bounds it on this card: int32 multiply-adds, not bytes. The input
// and output are 2.4 KB per row, but each of the 273 fp12 products is
// 2 × 108 schoolbook convolutions of 25 × 25 limbs (135k multiply-adds,
// Karatsuba) plus 120 normalizes (~54k multiply-adds in their folds),
// and the steps are strictly sequential. At 64 int32 multiply-adds per
// clock an SM needs about 0.41 ms for one row's ~52M, so with one row per
// SM the 99 rows that need a pairing can reach at most 99 / 132 of the
// card's bound.
//
// The design: one block of FE_THREADS (512) threads per row keeps the
// register file (33.6 KB), xi and all scratch in shared memory, so no
// step touches device memory (the few fold and lift constants that the
// 25-limb folds read at compile-time indices sit in the constant bank).
// A step is a few barrier phases, each spread over every (row, chunk of
// limbs), (row, pair of limbs) or schoolbook item of both fractions
// (csrc/fe.cuh): the columns of an Fp12 product's Fp2 products from
// three schoolbooks (Karatsuba) instead of four, each a work item with
// its operands in registers; every normalize as lane-parallel rounds and folds; the group
// merges fused into the rounds around them. A product is 8 phases, a
// Frobenius map 6. The phases are short and few warps have work in most
// of them, so the kernel is bound by the latency of its phase chain and
// by the multiply-add issue rate of the schoolbook phase, not by the
// card's multiply-add peak.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "fe.cuh"

namespace gs {

constexpr int FE_FRAC = 2;  // numerator and denominator
constexpr int FE_REGS = 14;
constexpr int FE_RESULT = 13;
constexpr int FRAC = FE_FRAC * FP12;  // ints per fraction-stacked register

constexpr int FE_SMEM_INTS =
    C_TOTAL + FE_REGS * FRAC + fe_scratch_ints<FE_FRAC>();

__global__ void __launch_bounds__(FE_THREADS)
    finalexp_kernel(const int* __restrict__ nd, const int* __restrict__ prog,
                    int nsteps, const int* __restrict__ consts,
                    int* __restrict__ out) {
  extern __shared__ int smem[];
  int* T = smem;
  int* regs = T + C_TOTAL;
  FeScratch S;
  fe_scratch<FE_FRAC>(regs + FE_REGS * FRAC, S);

  load_consts(T, consts);
  fe_host_consts(consts);
  const int* in = nd + (long)blockIdx.x * FRAC;
  for (int i = threadIdx.x; i < FE_REGS * FRAC; i += blockDim.x)
    regs[i] = i < FRAC ? in[i] : 0;
  for (int i = threadIdx.x; i < NL; i += blockDim.x) S.zero[i] = 0;
  __syncthreads();

  for (int s = 0; s < nsteps; ++s) {
    const int op = prog[4 * s], a = prog[4 * s + 1], b = prog[4 * s + 2];
    int* ra = regs + a * FRAC;
    int* rd = regs + prog[4 * s + 3] * FRAC;
    if (op == 0) {
      fe_mul<FE_FRAC>(ra, regs + b * FRAC, rd, S, T);
    } else if (op == 1) {  // swap numerator and denominator
      for (int i = threadIdx.x; i < FP12; i += blockDim.x) {
        const int num = ra[i], den = ra[FP12 + i];
        rd[i] = den;
        rd[FP12 + i] = num;
      }
      __syncthreads();
    } else if (op == 2) {
      fe_frob<FE_FRAC>(ra, b, rd, S, T);
    } else {
      copy_ints(rd, ra, FRAC);
    }
  }

  int* dst = out + (long)blockIdx.x * FRAC;
  for (int i = threadIdx.x; i < FRAC; i += blockDim.x)
    dst[i] = regs[FE_RESULT * FRAC + i];
}

}  // namespace gs

#ifdef __CUDACC__
// nd, out: (n, 2, 6, 2, 25) int32; prog: (nsteps, 4) int32; consts: the
// constant pack. Returns cudaGetLastError() after the launch.
extern "C" int gs_finalexp(const int* nd, const int* prog, int nsteps,
                           const int* consts, int n, int* out,
                           cudaStream_t stream) {
  const int smem = gs::FE_SMEM_INTS * (int)sizeof(int);
  cudaMemcpyToSymbolAsync(gs::fe_fold_c, consts + gs::C_FOLD,
                          sizeof(gs::fe_fold_c), 0, cudaMemcpyDeviceToDevice,
                          stream);
  cudaMemcpyToSymbolAsync(gs::fe_lift_c, consts + gs::C_LIFT,
                          sizeof(gs::fe_lift_c), 0, cudaMemcpyDeviceToDevice,
                          stream);
  cudaFuncSetAttribute(gs::finalexp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gs::finalexp_kernel<<<n, gs::FE_THREADS, smem, stream>>>(nd, prog, nsteps,
                                                           consts, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
