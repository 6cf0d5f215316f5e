// bn256 field constants of the audit kernels (csrc/agg.cu,
// csrc/miller.cu, csrc/finalexp.cu): the limb layout of the wide relaxed
// form and the constant pack that every block copies into shared memory.
//
// A field element is 25 little-endian 12-bit limbs in int32 (the wide
// relaxed form of ops/megakernels.py). Products go through 49-column
// schoolbook convolutions; a relaxed normalize folds any column
// accumulator back to quasi-canonical limbs in [-1, 2^12 + 64] with the
// same two rounds, fold, lift and three rounds as the plain version.
// Column sums stay below 2^30.7 for quasi-canonical inputs (never more
// than 100 products of |limb| <= 4160 in one accumulator), so int32 never
// overflows. The device code that computes on these limbs is csrc/fe.cuh.
#pragma once

namespace gs {

constexpr int NL = 25;        // limbs per Fp element
constexpr int NC = 2 * NL - 1;  // schoolbook product columns
constexpr int FB = 22;        // fold base: limbs >= FB fold back under p
constexpr int FR = 33;        // fold rows
constexpr int LB = 12;        // bits per limb
constexpr int LM = (1 << LB) - 1;
constexpr int FP2 = 2 * NL;   // ints per Fp2 value
constexpr int FP12 = 6 * FP2;  // ints per Fp12 value, w-basis [6][2][25]

// The constant pack (ops/megakernels.py `_CONST_PACK`), copied into
// shared memory at the start of every block.
constexpr int C_FOLD = 0;                  // [33][22] 2^(12(22+k)) mod p
constexpr int C_LIFT = C_FOLD + FR * FB;   // [25] relaxed lift
constexpr int C_PAD = C_LIFT + NL;         // [49] pad547
constexpr int C_NEG = C_PAD + NC;          // [25] negpad (pad274)
constexpr int C_GAMMA = C_NEG + NL;        // [3][6][2][25] Frobenius gammas
constexpr int C_B3 = C_GAMMA + 3 * 6 * 2 * NL;  // [2][25] 3·b' of the twist
constexpr int C_TOTAL = C_B3 + 2 * NL;     // 1775

// Every function is called by all threads of a block.
__device__ __forceinline__ void load_consts(int* T, const int* src) {
  for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) T[i] = src[i];
}

__device__ __forceinline__ void copy_ints(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

}  // namespace gs
