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
// and output are 2.4 KB per row, but each of the ~290 fp12 products is
// 2 × 144 schoolbook convolutions of 25 × 25 limbs (180k multiply-adds)
// plus 120 normalizes, and the steps are strictly sequential. The design:
// one block of 256 threads per row keeps the register file (33.6 KB) and
// all temporaries in shared memory, so no step touches device memory;
// the threads of a block split each product over (fraction, k, component,
// group, column). With 112 rows this is one wave on 132 SMs; latency per
// step, not throughput, sets the time.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

namespace gs {

constexpr int FE_REGS = 14;
constexpr int FE_RESULT = 13;
constexpr int FRAC = 2 * FP12;  // ints per fraction-stacked register

constexpr int FE_SMEM_INTS =
    C_TOTAL + FE_REGS * FRAC + 2 * FP12 + 2 * 36 * NC + 2 * 36 * NL +
    2 * 12 * NL;

__global__ void __launch_bounds__(THREADS)
    finalexp_kernel(const int* __restrict__ nd, const int* __restrict__ prog,
                    int nsteps, const int* __restrict__ consts,
                    int* __restrict__ out) {
  extern __shared__ int smem[];
  int* T = smem;
  int* regs = T + C_TOTAL;
  Fp12Scratch S;
  S.xi = regs + FE_REGS * FRAC;
  S.col = S.xi + 2 * FP12;
  S.parts = S.col + 2 * 36 * NC;
  S.merged = S.parts + 2 * 36 * NL;

  load_consts(T, consts);
  const int* in = nd + (long)blockIdx.x * FRAC;
  for (int i = threadIdx.x; i < FE_REGS * FRAC; i += blockDim.x)
    regs[i] = i < FRAC ? in[i] : 0;
  __syncthreads();

  for (int s = 0; s < nsteps; ++s) {
    const int op = prog[4 * s], a = prog[4 * s + 1], b = prog[4 * s + 2];
    int* ra = regs + a * FRAC;
    int* rd = regs + prog[4 * s + 3] * FRAC;
    if (op == 0) {
      fp12_mul(ra, regs + b * FRAC, rd, 2, S, T);
    } else if (op == 1) {  // swap numerator and denominator
      for (int i = threadIdx.x; i < FP12; i += blockDim.x) {
        const int num = ra[i], den = ra[FP12 + i];
        rd[i] = den;
        rd[FP12 + i] = num;
      }
      __syncthreads();
    } else if (op == 2) {
      fp12_frob(ra, b, rd, 2, S, T);
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
  cudaFuncSetAttribute(gs::finalexp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gs::finalexp_kernel<<<n, gs::THREADS, smem, stream>>>(nd, prog, nsteps,
                                                        consts, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
