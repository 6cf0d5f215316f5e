// Masked committee sums of vote signatures (G1) and voter pubkeys (G2).
//
// Replaces the TPU kernel `aggregate_proj` of
// gethsharding_tpu/ops/pallas_finalexp.py (its pallas_call at :1062): the
// committee, padded to a power of two cp with identity slots (0 : 1 : 0),
// is summed by a halving tree of Renes-Costello-Batina complete
// projective additions (a = 0; 3·b = 9 on G1, 3·b' on the twist for G2):
// at every level slot i takes slot i + half. Two instantiations of one
// kernel: NCOMP = 1 (Fp, G1) and NCOMP = 2 (Fp2, G2). It returns the
// plain version's limbs (`run_agg_plain`), not only its points: an
// addition of the identity changes the representative, so every identity
// slot is added and the tree keeps its shape, and every normalize sees
// the plain version's int32 inputs.
//
// What bounds it on this card: int32 multiply-adds and the instructions
// around them; its bytes are negligible. A G1 addition is 12 schoolbook
// products of 25 × 25 limbs and 33 normalizes (~17.5k multiply-adds), a
// G2 addition 14 Fp2 products at three schoolbooks each (Karatsuba) and
// 66 normalizes (~48k), against 300 or 600 bytes of input per slot; a
// 256-slot row makes 255 additions, in a chain 8 levels deep.
//
// The design:
// - a block adds up to `pairs` pairs of a tree level at once, each
//   addition a chain of barrier phases over (operation, pair, component)
//   rows on fe.cuh's device code: every normalize spread over (row, chunk
//   of limbs) lanes (a 25-limb normalize in one phase, rounds, fold and
//   rounds in each lane's window), every schoolbook a work item with its
//   operands in registers (G1: two items of a column range each; G2:
//   Karatsuba), and the last products' normalizes merged into the sums of
//   the output coordinates. A G1 addition is 13 phases, a G2 addition 20;
// - every input of a phase binds its row once per item (fe_row), so the
//   addressing runs once per item and not once per limb;
// - the stack and the pair's temporaries (11 registers; the two stack
//   slots a pair has read serve as six more) stay in shared memory as
//   int16, since every value they hold is an input limb or a relaxed
//   normalize's output in [-1, 2^12 + 64]; only the columns and the rows
//   between rounds are int32. No phase writes a location it reads;
// - a row can be split over ns blocks without changing the tree: while
//   half >= ns, slots i and i + half agree mod ns, so the slots of
//   residue s form a subtree that block s of the row sums alone; it
//   writes its partial sum to device memory, and the last block of the
//   row to finish (a counter per row, `atomicAdd` after `__threadfence`)
//   adds the ns partials over the top log2(ns) levels of the same tree.
//   `agg_plan` takes the fewest blocks whose shared memory fits: the
//   audit's 256-slot rows take one 512-thread block each (many pairs a
//   phase keep its lanes busy; smaller blocks and chunks measured slower
//   on the card), a 512-slot G2 row two.
// Every phase is a block-stride loop that no item of the same phase reads
// back, and blocks only meet through the counter, so one thread running
// the blocks in order (the host shim of the tests) is a legal schedule.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "fe.cuh"

namespace gs {

constexpr int AGG_THREADS = 512;      // threads per block
constexpr int AGG_REGS = 11;          // Fp / Fp2 registers of a pair
constexpr int AGG_CONSTS = C_GAMMA;   // the constant pack up to its gammas
constexpr int AGG_SMEM_MAX = 232448;  // shared bytes a block may take
// limbs per lane in the phases of rounds
constexpr int AGG_CW_N25 = 13;    // 25-limb normalizes
constexpr int AGG_CW_Z2 = 26;     // two rounds of a product's columns
constexpr int AGG_CW_OUT = 13;    // fold and three rounds into 25 limbs
constexpr int AGG_CW_MERGE = 14;  // the merges into the coordinates

// Per instantiation: schoolbook items per product (column ranges, G1)
// and the pairs a block adds at once.
template <int NCOMP>
struct AggTune;
template <>
struct AggTune<1> {
  static constexpr int SPLIT = 2, PAIRS = 32;
};
template <>
struct AggTune<2> {
  static constexpr int SPLIT = 1, PAIRS = 16;
};

// The RCB16 addition (algorithm 7) over 17 locations of each pair:
// registers 0..10, then (11..16) the coordinates of its two stack slots,
// dead once P1 has read them. L1 (from the stack): 0..5 = X1+Y1, X2+Y2,
// Y1+Z1, Y2+Z2, X1+Z1, X2+Z2. P1: 0..2 = X1·X2, Y1·Y2, Z1·Z2 (t0, t1,
// t2); 3..5 = 0·1, 2·3, 4·5. Then the linear phases below (SCL: times
// the small constant in b), with t2·3b and t5·3b products on G2. They
// read registers only, and no phase writes a location it reads (t5 takes
// the one register L3 does not read). P2: the six products of AGG_P2,
// merged two by two into X = p0 - p1, Y = p2 + p3, Z = p4 + p5.
__constant__ Ins AGG_L2[] = {  // s01, s12, s02, t0 + t0, then G1's 9·t2
    {ADD, 0, 1, 6}, {ADD, 1, 2, 7}, {ADD, 0, 2, 8}, {ADD, 0, 0, 9},
    {SCL, 2, 9, 10}};
__constant__ Ins AGG_L3[] = {  // t3, t4, t5, 3·t0, zs, t1 - 3b·t2
    {SUB, 3, 6, 11}, {SUB, 4, 7, 12}, {SUB, 5, 8, 2},
    {ADD, 9, 0, 14}, {ADD, 1, 10, 15}, {SUB, 1, 10, 16}};
__constant__ Ins AGG_YB[] = {{SCL, 2, 9, 0}};  // G1: yb = 9·t5
__constant__ unsigned char AGG_P2[6][2] = {
    {11, 16}, {12, 0}, {16, 15}, {14, 0}, {15, 12}, {14, 11}};

// Every value the stack and the registers hold is an input limb or a
// relaxed normalize's output, in [-1, 2^12 + 64]: they are stored as
// int16, which halves the shared memory a pair takes.
using Limb = short;

// One block's shared memory: the constants it keeps (fold, lift, pad547,
// negpad), the last-block flag, the schoolbook columns (the folded rows
// of a product, 22 limbs each, reuse them once read) and the rows after
// two rounds in int32; the stack, the registers, a zero row and 3·b' of
// the twist in int16.
template <int NCOMP>
struct Agg {
  static constexpr int E = NCOMP * NL;            // limbs per coordinate
  static constexpr int ES = E + (NCOMP == 1);     // its stride: odd words
  static constexpr int NP = NCOMP == 2 ? 3 : 1;   // schoolbooks per product
  const int* T;      // the constants
  int* part;         // schoolbook columns, then folded rows
  int* t2;           // rows after two rounds
  Limb* pts;         // the stack: coordinate k of slot s at (3s + k)·ES
  Limb* regs;        // register k of pair p at (k·pairs + p)·ES
  const Limb* zero;  // 25 zeros
  const Limb* b3;    // 3·b' of the twist (2 × 25)
  int pairs;

  __device__ __forceinline__ Limb* pt(int s, int k) const {
    return pts + (3 * s + k) * ES;
  }
  __device__ __forceinline__ Limb* reg(int k, int p) const {
    return regs + (k * pairs + p) * ES;
  }
  // location k of pair p of the chunk at c0 of a level of `half` pairs
  __device__ __forceinline__ Limb* loc(int k, int p, int c0, int half) const {
    return k < AGG_REGS ? reg(k, p)
                        : pt(c0 + p + (k >= AGG_REGS + 3 ? half : 0),
                             (k - AGG_REGS) % 3);
  }
};

// Shared int32 words, and bytes in all, of a block that holds `slots`
// points and adds `pairs` pairs at once.
template <int NCOMP>
__host__ __device__ constexpr int agg_smem_words(int pairs) {
  return AGG_CONSTS + 1 + 6 * pairs * Agg<NCOMP>::NP * NC +
         6 * pairs * NCOMP * FE_Z2;
}
template <int NCOMP>
__host__ __device__ constexpr int agg_smem_bytes(int slots, int pairs) {
  return 4 * agg_smem_words<NCOMP>(pairs) +
         2 * ((slots * 3 + pairs * AGG_REGS) * Agg<NCOMP>::ES + 3 * NL);
}

// The pairs a block of `sub` slots adds at once, and the shared bytes it
// takes when a row is split over ns blocks.
template <int NCOMP>
__host__ __device__ constexpr int agg_pairs(int sub) {
  return sub / 2 < AggTune<NCOMP>::PAIRS ? (sub > 1 ? sub / 2 : 1)
                                         : AggTune<NCOMP>::PAIRS;
}
template <int NCOMP>
__host__ __device__ constexpr int agg_split_bytes(int cp, int ns) {
  return agg_smem_bytes<NCOMP>(cp / ns > ns ? cp / ns : ns,
                               agg_pairs<NCOMP>(cp / ns));
}

// How a row of cp slots is summed: ns blocks (a power of two dividing
// cp, the fewest whose shared memory fits) and pairs added at once.
template <int NCOMP>
void agg_plan(int cp, int* ns, int* pairs) {
  int n = 1;
  while (agg_split_bytes<NCOMP>(cp, n) > AGG_SMEM_MAX && n < cp) n *= 2;
  *ns = n;
  *pairs = agg_pairs<NCOMP>(cp / n);
}

// Linear operations `ins` (ADD, SUB, SCL) of np pairs, from registers to
// locations: row (operation, pair, component), each one normalize.
template <int NOPS, int NCOMP>
__device__ void agg_linear(const Agg<NCOMP>& A, const Ins* ins, int c0,
                           int half, int np) {
  fe_normalize25<AGG_CW_N25>(NOPS * np * NCOMP, [&](int r) {
    // every operation as a·ka + b·kb + negpad·kn, exact in int32
    const int c = r % NCOMP, p = (r / NCOMP) % np;
    const Ins I = ins[r / (NCOMP * np)];
    const Limb* a = A.reg(I.a, p) + c * NL;
    const Limb* b = A.reg(I.op == SCL ? I.a : I.b, p) + c * NL;
    const int* neg = A.T + C_NEG;
    const int ka = I.op == SCL ? I.b : 1;
    const int kb = I.op == ADD ? 1 : (I.op == SUB ? -1 : 0);
    const int kn = I.op == SUB;
    return [=](int l) { return a[l] * ka + b[l] * kb + neg[l] * kn; };
  }, [&](int r) {
    const int c = r % NCOMP, p = (r / NCOMP) % np;
    return A.loc(ins[r / (NCOMP * np)].d, p, c0, half) + c * NL;
  });
}

// The products a·b of `nprod` rows (ab(r, a, b) gives the operands) up to
// their folded rows in A.part: schoolbooks, columns (padded in G2's real
// component, as the plain Fp2 product) after two rounds, fold.
template <int NCOMP, class AB>
__device__ void agg_columns(const Agg<NCOMP>& A, int nprod, AB ab) {
  constexpr int NP = Agg<NCOMP>::NP;
  fe_products<NP, AggTune<NCOMP>::SPLIT, Limb>(nprod, ab, A.part, A.zero);
  fe_two_rounds<NC, AGG_CW_Z2>(nprod * NCOMP, [&](int r) {
    const int c = r % NCOMP;
    const int* pad = A.T + C_PAD;
    const int kp = NCOMP == 2 && c == 0;
    auto col = fe_column_row<NP>(A.part, nprod, r / NCOMP, c);
    return [=](int l) { return pad[l] * kp + col(l); };
  }, A.t2);
  fe_fold<NC>(nprod * NCOMP, A.t2, A.part, A.T);
}

// G2: location d = location a · 3b' for np pairs.
__device__ void agg_b3(const Agg<2>& A, int a, int d, int c0, int half,
                       int np) {
  agg_columns(A, np, [&](int r, const Limb*& u, const Limb*& v) {
    u = A.loc(a, r, c0, half);
    v = A.b3;
  });
  fe_three_rounds<AGG_CW_OUT>(2 * np, A.part, [&](int r) {
    return A.loc(d, r / 2, c0, half) + (r % 2) * NL;
  });
}

// Pair p of a level: slot c0 + p += slot c0 + p + half, for np pairs.
// Rows run operation-major: (operation, pair, component), so the lanes
// of a warp read locations ES apart.
template <int NCOMP>
__device__ void agg_add(const Agg<NCOMP>& A, int c0, int half, int np) {
  // L1: operation o even: the first point, odd: the second
  fe_normalize25<AGG_CW_N25>(6 * np * NCOMP, [&](int r) {
    const int c = r % NCOMP, p = (r / NCOMP) % np, o = r / (NCOMP * np);
    const int s = c0 + p + ((o & 1) ? half : 0), k = o >> 1;
    const Limb* u = A.pt(s, k == 1 ? 1 : 0) + c * NL;
    const Limb* v = A.pt(s, k == 0 ? 1 : 2) + c * NL;
    return [=](int l) { return u[l] + v[l]; };
  }, [&](int r) {
    const int c = r % NCOMP, p = (r / NCOMP) % np;
    return A.reg(r / (NCOMP * np), p) + c * NL;
  });
  // P1: product q of pair p is row q·np + p
  agg_columns(A, 6 * np, [&](int r, const Limb*& u, const Limb*& v) {
    const int q = r / np, p = r - q * np;
    if (q < 3) {
      u = A.pt(c0 + p, q);
      v = A.pt(c0 + p + half, q);
    } else {
      u = A.reg(2 * (q - 3), p);
      v = A.reg(2 * (q - 3) + 1, p);
    }
  });
  fe_three_rounds<AGG_CW_OUT>(6 * np * NCOMP, A.part, [&](int r) {
    const int c = r % NCOMP, pr = r / NCOMP;
    return A.reg(pr / np, pr % np) + c * NL;
  });
  if constexpr (NCOMP == 1) {
    agg_linear<5>(A, AGG_L2, c0, half, np);
    agg_linear<6>(A, AGG_L3, c0, half, np);
    agg_linear<1>(A, AGG_YB, c0, half, np);
  } else {
    agg_linear<4>(A, AGG_L2, c0, half, np);
    agg_b3(A, 2, 10, c0, half, np);
    agg_linear<6>(A, AGG_L3, c0, half, np);
    agg_b3(A, 2, 0, c0, half, np);
  }
  // P2, its normalizes merged into the coordinates: merge row (k, p, c)
  // takes the folded rows of products 2k and 2k + 1
  agg_columns(A, 6 * np, [&](int r, const Limb*& u, const Limb*& v) {
    const int q = r / np, p = r - q * np;
    u = A.loc(AGG_P2[q][0], p, c0, half);
    v = A.loc(AGG_P2[q][1], p, c0, half);
  });
  auto folded = [&](int m, int odd) {
    const int c = m % NCOMP, pr = m / NCOMP;
    const int k = pr / np, p = pr % np;
    return A.part + (((2 * k + odd) * np + p) * NCOMP + c) * FB;
  };
  fe_merge<AGG_CW_MERGE, false>(
      3 * np * NCOMP, [&](int m) { return folded(m, 0); },
      [&](int m) { return folded(m, 1); }, A.t2,
      [&](int m, int l, int a, int b) {
        return m < np * NCOMP ? a - b + A.T[C_NEG + l] : a + b;
      });
  fe_fold_three<AGG_CW_OUT>(3 * np * NCOMP, A.t2, [&](int m) {
    const int c = m % NCOMP, pr = m / NCOMP;
    return A.pt(c0 + pr % np, pr / np) + c * NL;
  });
}

// The halving tree over stack slots 0..size-1; the sum lands in slot 0.
template <int NCOMP>
__device__ void agg_tree(const Agg<NCOMP>& A, int size) {
  for (; size > 1; size >>= 1) {
    const int half = size >> 1;
    for (int c0 = 0; c0 < half; c0 += A.pairs)
      agg_add(A, c0, half, half - c0 < A.pairs ? half - c0 : A.pairs);
  }
}

// Block (row, s) of ns per row sums the slots s, s + ns, s + 2·ns, ...;
// the row's last block to finish sums the ns partials.
template <int NCOMP>
__global__ void __launch_bounds__(AGG_THREADS)
    agg_kernel(const int* __restrict__ xs, const int* __restrict__ ys,
               const int* __restrict__ mask, int C, int cp, int ns,
               int pairs, const int* __restrict__ consts,
               int* __restrict__ partial, int* __restrict__ counter,
               int* __restrict__ ox, int* __restrict__ oy,
               int* __restrict__ oz) {
  constexpr int E = Agg<NCOMP>::E, ES = Agg<NCOMP>::ES,
                NP = Agg<NCOMP>::NP;
  extern __shared__ int smem[];
  const int sub = cp / ns, slots = sub > ns ? sub : ns;
  Agg<NCOMP> A;
  A.T = smem;
  int* last = smem + AGG_CONSTS;
  A.part = last + 1;
  A.t2 = A.part + 6 * pairs * NP * NC;
  A.pts = reinterpret_cast<Limb*>(smem + agg_smem_words<NCOMP>(pairs));
  A.regs = A.pts + slots * 3 * ES;
  Limb* zero = A.regs + pairs * AGG_REGS * ES;
  A.zero = zero;
  A.b3 = zero + NL;
  A.pairs = pairs;

  for (int i = threadIdx.x; i < AGG_CONSTS; i += blockDim.x)
    smem[i] = consts[i];
  for (int i = threadIdx.x; i < 3 * NL; i += blockDim.x)
    zero[i] = i < NL ? 0 : consts[C_B3 + i - NL];
  fe_host_consts(consts);
  const long row = blockIdx.x / ns;
  const int s = blockIdx.x % ns;
  const int* X = xs + row * C * E;
  const int* Y = ys + row * C * E;
  const int* M = mask + row * C;
  // masked-off and padding slots are the identity (0 : 1 : 0)
  for (int e = threadIdx.x; e < sub * 3 * E; e += blockDim.x) {
    const int j = e / (3 * E), k = (e / E) % 3, i = e % E;
    const int g = s + ns * j;
    const bool on = g < C && M[g] != 0;
    int v;
    if (k == 0)
      v = on ? X[g * E + i] : 0;
    else if (k == 1)
      v = on ? Y[g * E + i] : i == 0;
    else
      v = on ? i == 0 : 0;
    A.pt(j, k)[i] = v;
  }
  __syncthreads();
  agg_tree(A, sub);

  if (ns > 1) {
    int* P = partial + row * ns * 3 * E;
    for (int e = threadIdx.x; e < 3 * E; e += blockDim.x)
      P[s * 3 * E + e] = A.pt(0, e / E)[e % E];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(counter + row, 1) == ns - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int e = threadIdx.x; e < ns * 3 * E; e += blockDim.x)
      A.pt(e / (3 * E), (e / E) % 3)[e % E] = __ldcg(P + e);
    __syncthreads();
    agg_tree(A, ns);
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    ox[row * E + i] = A.pt(0, 0)[i];
    oy[row * E + i] = A.pt(0, 1)[i];
    oz[row * E + i] = A.pt(0, 2)[i];
  }
}

}  // namespace gs

// The launch plan of a row of cp slots: out[0] blocks per row, out[1]
// pairs a block adds at once. Returns 0.
extern "C" int gs_agg_plan(int fp2, int cp, int* out) {
  if (fp2)
    gs::agg_plan<2>(cp, out, out + 1);
  else
    gs::agg_plan<1>(cp, out, out + 1);
  return 0;
}

#ifdef __CUDACC__
template <int NCOMP>
static int launch_agg(const int* xs, const int* ys, const int* mask, int n,
                      int C, int cp, int ns, const int* consts, int* partial,
                      int* counter, int* ox, int* oy, int* oz,
                      cudaStream_t stream) {
  if (ns < 1 || cp % ns != 0 || (ns > 1 && (!partial || !counter)))
    return (int)cudaErrorInvalidValue;
  const int pairs = gs::agg_pairs<NCOMP>(cp / ns);
  const int smem = gs::agg_split_bytes<NCOMP>(cp, ns);
  if (smem > gs::AGG_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      gs::fe_fold_c, consts + gs::C_FOLD, sizeof(gs::fe_fold_c), 0,
      cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(gs::fe_lift_c, consts + gs::C_LIFT,
                                  sizeof(gs::fe_lift_c), 0,
                                  cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gs::agg_kernel<NCOMP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  gs::agg_kernel<NCOMP><<<n * ns, gs::AGG_THREADS, smem, stream>>>(
      xs, ys, mask, C, cp, ns, pairs, consts, partial, counter, ox, oy, oz);
  return (int)cudaGetLastError();
}

// G1: xs, ys (n, C, 25); G2: xs, ys (n, C, 2, 25); mask (n, C); cp the
// committee padded to a power of two >= 2, ns (a power of two dividing
// cp, as gs_agg_plan gives it) blocks per row; partial
// (n, ns, 3, [2,] 25) and counter (n,), zero, both null when ns is 1;
// ox, oy, oz (n, [2,] 25); all int32. Returns the first CUDA error of
// the launch, 0 if none.
extern "C" int gs_agg_g1(const int* xs, const int* ys, const int* mask, int n,
                         int C, int cp, int ns, const int* consts,
                         int* partial, int* counter, int* ox, int* oy,
                         int* oz, cudaStream_t stream) {
  return launch_agg<1>(xs, ys, mask, n, C, cp, ns, consts, partial, counter,
                       ox, oy, oz, stream);
}

extern "C" int gs_agg_g2(const int* xs, const int* ys, const int* mask, int n,
                         int C, int cp, int ns, const int* consts,
                         int* partial, int* counter, int* ox, int* oy,
                         int* oz, cudaStream_t stream) {
  return launch_agg<2>(xs, ys, mask, n, C, cp, ns, consts, partial, counter,
                       ox, oy, oz, stream);
}
#endif
