// bn256 field arithmetic for the audit kernels: 25-limb relaxed Fp, Fp2
// and Fp12 as block-cooperative device functions.
//
// A field element is 25 little-endian 12-bit limbs in int32 (the wide
// relaxed form of ops/megakernels.py). Products go through 49-column
// schoolbook convolutions; `normalize` folds any column accumulator back
// to quasi-canonical limbs in [-1, 2^12 + 64] with the same two rounds,
// fold, lift and three rounds as the plain version, so every function
// here returns the plain version's limbs exactly. Column sums stay below
// 2^30.7 for quasi-canonical inputs (never more than 100 products of
// |limb| <= 4160 in one accumulator), so int32 never overflows.
//
// Every function is called by all threads of a block: work items are
// spread over threadIdx.x with a stride of blockDim.x, and a phase ends
// with __syncthreads(). Nothing a thread writes in a phase is read by
// another thread in the same phase.
#pragma once

namespace gs {

constexpr int NL = 25;        // limbs per Fp element
constexpr int NC = 2 * NL - 1;  // schoolbook product columns
constexpr int FB = 22;        // fold base: limbs >= FB fold back under p
constexpr int FR = 33;        // fold rows
constexpr int LB = 12;        // bits per limb
constexpr int LM = (1 << LB) - 1;
constexpr int THREADS = 256;  // threads per block of every audit kernel

// The constant pack (ops/megakernels.py `_CONST_PACK`), copied into
// shared memory at the start of every block.
constexpr int C_FOLD = 0;                  // [33][22] 2^(12(22+k)) mod p
constexpr int C_LIFT = C_FOLD + FR * FB;   // [25] relaxed lift
constexpr int C_PAD = C_LIFT + NL;         // [49] pad547
constexpr int C_NEG = C_PAD + NC;          // [25] negpad (pad274)
constexpr int C_GAMMA = C_NEG + NL;        // [3][6][2][25] Frobenius gammas
constexpr int C_B3 = C_GAMMA + 3 * 6 * 2 * NL;  // [2][25] 3·b' of the twist
constexpr int C_TOTAL = C_B3 + 2 * NL;     // 1775

__device__ __forceinline__ void load_consts(int* T, const int* src) {
  for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) T[i] = src[i];
}

__device__ __forceinline__ void copy_ints(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// One width-preserving relaxed carry round; the top limb keeps its own
// carry, so the value is preserved exactly. `>>` on int is arithmetic.
template <int W>
__device__ __forceinline__ void carry_round(int (&z)[W]) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int v = z[i];
    z[i] = (v & LM) + carry;
    carry = v >> LB;
  }
  z[W - 1] += carry * (1 << LB);
}

// Relaxed normalize of one accumulator row (|limb| < 2^30.7, value >= 0)
// into 25 quasi-canonical limbs at `out`, value preserved mod p.
template <int W>
__device__ __forceinline__ void normalize(const int (&in)[W], int* out,
                                          const int* T) {
  constexpr int Z = W + 2;
  static_assert(Z - FB <= FR, "accumulator too wide");
  int z[Z];
#pragma unroll
  for (int i = 0; i < W; ++i) z[i] = in[i];
  z[W] = 0;
  z[W + 1] = 0;
  carry_round(z);
  carry_round(z);
  int acc[NL];
#pragma unroll
  for (int j = 0; j < FB; ++j) acc[j] = z[j] + T[C_LIFT + j];
#pragma unroll
  for (int j = FB; j < NL; ++j) acc[j] = T[C_LIFT + j];
#pragma unroll
  for (int h = 0; h < Z - FB; ++h) {
    const int v = z[FB + h];
#pragma unroll
    for (int j = 0; j < FB; ++j) acc[j] += v * T[C_FOLD + h * FB + j];
  }
  carry_round(acc);
  carry_round(acc);
  carry_round(acc);
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = acc[j];
}

// Normalize a 49-column row held in memory.
__device__ __forceinline__ void normalize_cols(const int* cols, int* out,
                                               const int* T) {
  int z[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) z[i] = cols[i];
  normalize<NC>(z, out, T);
}

// Schoolbook column n of u·v, and of u0·v0 ∓ u1·v1.
__device__ __forceinline__ int conv_col(const int* u, const int* v, int n) {
  const int lo = n > NL - 1 ? n - (NL - 1) : 0;
  const int hi = n < NL - 1 ? n : NL - 1;
  int acc = 0;
  for (int l = lo; l <= hi; ++l) acc += u[l] * v[n - l];
  return acc;
}

__device__ __forceinline__ int conv_col_sub(const int* u0, const int* v0,
                                            const int* u1, const int* v1,
                                            int n) {
  const int lo = n > NL - 1 ? n - (NL - 1) : 0;
  const int hi = n < NL - 1 ? n : NL - 1;
  int acc = 0;
  for (int l = lo; l <= hi; ++l) acc += u0[l] * v0[n - l] - u1[l] * v1[n - l];
  return acc;
}

__device__ __forceinline__ int conv_col_add(const int* u0, const int* v0,
                                            const int* u1, const int* v1,
                                            int n) {
  const int lo = n > NL - 1 ? n - (NL - 1) : 0;
  const int hi = n < NL - 1 ? n : NL - 1;
  int acc = 0;
  for (int l = lo; l <= hi; ++l) acc += u0[l] * v0[n - l] + u1[l] * v1[n - l];
  return acc;
}

// Column n of the fp2 product a·b with the real row padded:
// c = 0: a0·b0 - a1·b1 + pad547; c = 1: a0·b1 + a1·b0.
__device__ __forceinline__ int fp2_mul_col(const int* a, const int* b, int c,
                                           int n, const int* T) {
  if (c == 0) return T[C_PAD + n] + conv_col_sub(a, b, a + NL, b + NL, n);
  return conv_col_add(a, b + NL, a + NL, b, n);
}

// == a register machine for independent Fp / Fp2 operations ==============
// Registers hold NCOMP components of 25 limbs, for `lanes` independent
// lanes; register r of lane l, component c sits at
// base + ((r * lanes + l) * NCOMP + c) * NL. A phase is a list of
// instructions that do not read each other's results; all of a phase's
// (instruction, lane, component) work items run in parallel.

enum Op : unsigned char {
  ADD,  // d = a + b
  SUB,  // d = a - b
  NEG,  // d = -a
  SCL,  // d = b·a, b a small constant
  CPY,  // d = normalize(a)
  CNJ,  // d = conj(a): (a0, -a1)
  MUL,  // d = a·b (Fp, or Fp2 when NCOMP == 2)
  MFP,  // d = a·b0: Fp2 times the Fp held in b's first component
};

struct Ins {
  unsigned char op, a, b, d;
};

struct Phase {
  unsigned char mul, start, count;  // mul: 0 linear phase, 1 product phase
};

template <int NCOMP>
struct RegFile {
  int* base;
  int lanes;
  __device__ __forceinline__ int* at(int r, int l, int c) const {
    return base + ((r * lanes + l) * NCOMP + c) * NL;
  }
};

template <int NCOMP>
__device__ void run_linear(const Ins* ins, int nins, RegFile<NCOMP> R,
                           int nlanes, const int* T) {
  const int per = nlanes * NCOMP;
  for (int t = threadIdx.x; t < nins * per; t += blockDim.x) {
    const Ins I = ins[t / per];
    const int l = (t % per) / NCOMP, c = t % NCOMP;
    const int* a = R.at(I.a, l, c);
    const int* b = R.at(I.b, l, c);
    const int* neg = T + C_NEG;
    int z[NL];
    switch (I.op) {
      case ADD:
#pragma unroll
        for (int i = 0; i < NL; ++i) z[i] = a[i] + b[i];
        break;
      case SUB:
#pragma unroll
        for (int i = 0; i < NL; ++i) z[i] = a[i] - b[i] + neg[i];
        break;
      case NEG:
#pragma unroll
        for (int i = 0; i < NL; ++i) z[i] = neg[i] - a[i];
        break;
      case SCL:
#pragma unroll
        for (int i = 0; i < NL; ++i) z[i] = a[i] * I.b;
        break;
      case CNJ:
        if (c == 1) {
#pragma unroll
          for (int i = 0; i < NL; ++i) z[i] = neg[i] - a[i];
          break;
        }
        // fall through: the real component is copied
      default:  // CPY
#pragma unroll
        for (int i = 0; i < NL; ++i) z[i] = a[i];
        break;
    }
    normalize<NL>(z, R.at(I.d, l, c), T);
  }
  __syncthreads();
}

// Products: columns into `col` (nins · nlanes · NCOMP rows of 49), then one
// normalize per row into the destination registers.
template <int NCOMP>
__device__ void run_products(const Ins* ins, int nins, RegFile<NCOMP> R,
                             int nlanes, int* col, const int* T) {
  const int rows = nins * nlanes * NCOMP;
  for (int t = threadIdx.x; t < rows * NC; t += blockDim.x) {
    const int n = t % NC, row = t / NC;
    const int c = row % NCOMP, l = (row / NCOMP) % nlanes;
    const Ins I = ins[row / (NCOMP * nlanes)];
    int acc;
    if (NCOMP == 1) {
      acc = conv_col(R.at(I.a, l, 0), R.at(I.b, l, 0), n);
    } else if (I.op == MFP) {
      acc = conv_col(R.at(I.a, l, c), R.at(I.b, l, 0), n);
    } else {
      acc = fp2_mul_col(R.at(I.a, l, 0), R.at(I.b, l, 0), c, n, T);
    }
    col[t] = acc;
  }
  __syncthreads();
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const int c = row % NCOMP, l = (row / NCOMP) % nlanes;
    const Ins I = ins[row / (NCOMP * nlanes)];
    normalize_cols(col + row * NC, R.at(I.d, l, c), T);
  }
  __syncthreads();
}

template <int NCOMP>
__device__ void run_phases(const Phase* ph, int nph, const Ins* ins,
                           RegFile<NCOMP> R, int nlanes, int* col,
                           const int* T) {
  for (int p = 0; p < nph; ++p) {
    const Phase P = ph[p];
    if (P.mul)
      run_products<NCOMP>(ins + P.start, P.count, R, nlanes, col, T);
    else
      run_linear<NCOMP>(ins + P.start, P.count, R, nlanes, T);
  }
}

// == Fp12 in the w-basis: [6][2][25], w^6 = xi = 9 + i ====================
// `nfrac` consecutive fp12 values (the final exponentiation carries a
// numerator and a denominator) go through each function together.

constexpr int FP12 = 6 * 2 * NL;  // ints per fp12 value

struct Fp12Scratch {
  int* xi;      // nfrac · 300: xi·y
  int* col;     // nfrac · 36 · 49 column accumulators
  int* parts;   // nfrac · 36 · 25 normalized group sums
  int* merged;  // nfrac · 12 · 25
};

// xi-multiple of every Fp2 coefficient: (9a - b) + (a + 9b)i.
__device__ __forceinline__ void fp12_mul_xi(const int* y, int* out, int nfrac,
                                            const int* T) {
  for (int r = threadIdx.x; r < nfrac * 12; r += blockDim.x) {
    const int c = r % 2;
    const int* a = y + (r - c) * NL;
    const int* b = a + NL;
    int z[NL];
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) z[i] = a[i] * 9 - b[i] + T[C_NEG + i];
    } else {
#pragma unroll
      for (int i = 0; i < NL; ++i) z[i] = a[i] + b[i] * 9;
    }
    normalize<NL>(z, out + r * NL, T);
  }
  __syncthreads();
}

// out = x·y: cyclic convolution with xi on wrap-around, accumulated per
// (k, component, group of two i), padded, normalized, then the three
// groups merged in two steps. `out` may alias x or y.
static __device__ void fp12_mul(const int* x, const int* y, int* out, int nfrac,
                         Fp12Scratch S, const int* T) {
  fp12_mul_xi(y, S.xi, nfrac, T);
  for (int t = threadIdx.x; t < nfrac * 36 * NC; t += blockDim.x) {
    const int n = t % NC, r = t / NC;
    const int g = r % 3, c = (r / 3) % 2, k = (r / 6) % 6, f = r / 36;
    const int* xf = x + f * FP12;
    const int* yf = y + f * FP12;
    const int* xif = S.xi + f * FP12;
    int acc = c == 0 ? T[C_PAD + n] : 0;
    for (int i = 2 * g; i < 2 * g + 2; ++i) {
      const int j = (k - i + 6) % 6;
      const int* op = (i <= k ? yf : xif) + j * 2 * NL;
      const int* xi = xf + i * 2 * NL;
      acc += c == 0 ? conv_col_sub(xi, op, xi + NL, op + NL, n)
                    : conv_col_add(xi, op + NL, xi + NL, op, n);
    }
    S.col[t] = acc;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nfrac * 36; r += blockDim.x)
    normalize_cols(S.col + r * NC, S.parts + r * NL, T);
  __syncthreads();
  for (int r = threadIdx.x; r < nfrac * 12; r += blockDim.x) {
    const int* p = S.parts + r * 3 * NL;
    int z[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) z[i] = p[i] + p[NL + i];
    normalize<NL>(z, S.merged + r * NL, T);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nfrac * 12; r += blockDim.x) {
    const int* p = S.parts + r * 3 * NL;
    const int* m = S.merged + r * NL;
    int z[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) z[i] = m[i] + p[2 * NL + i];
    normalize<NL>(z, out + r * NL, T);
  }
  __syncthreads();
}

// out = f · (A + B·w + C·w^3) for one fp12 value; A, B, C are Fp2.
// Group 0 accumulates the A and B terms, group 1 the C term.
static __device__ void fp12_mul_line(const int* f, const int* A, const int* B,
                              const int* Cl, int* out, Fp12Scratch S,
                              const int* T) {
  fp12_mul_xi(f, S.xi, 1, T);
  for (int t = threadIdx.x; t < 24 * NC; t += blockDim.x) {
    const int n = t % NC, r = t / NC;
    const int g = r % 2, c = (r / 2) % 2, k = r / 4;
    int acc = c == 0 ? T[C_PAD + n] : 0;
    for (int tt = 2 * g; tt < (g == 0 ? 2 : 3); ++tt) {
      const int d = tt == 2 ? 3 : tt;                // w-degree of the term
      const int* L = tt == 0 ? A : (tt == 1 ? B : Cl);
      const int* op = (k >= d ? f : S.xi) + ((k - d + 6) % 6) * 2 * NL;
      acc += c == 0 ? conv_col_sub(L, op, L + NL, op + NL, n)
                    : conv_col_add(L, op + NL, L + NL, op, n);
    }
    S.col[t] = acc;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < 24; r += blockDim.x)
    normalize_cols(S.col + r * NC, S.parts + r * NL, T);
  __syncthreads();
  for (int r = threadIdx.x; r < 12; r += blockDim.x) {
    const int* p = S.parts + r * 2 * NL;
    int z[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) z[i] = p[i] + p[NL + i];
    normalize<NL>(z, out + r * NL, T);
  }
  __syncthreads();
}

}  // namespace gs
