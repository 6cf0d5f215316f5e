// Projective shared-accumulator optimal-ate Miller product of the BLS
// committee check, e(sig, G2)·e(-H, pk), one block per batch row.
//
// Replaces the TPU kernel `miller_f` of
// gethsharding_tpu/ops/pallas_finalexp.py (its pallas_call at :873): the
// 88-step DBL / ADD walk of the aggregate pubkey on the twist, driven by
// an op stream (0 = DBL, 1-4 = ADD with the candidate [+Q, -Q, pi Q,
// -pi^2 Q] made in the preamble), and per step the precomputed
// G2-generator line evaluated at the aggregate signature. It returns the
// plain version's limbs (`run_miller_plain` of ops/megakernels.py): every
// normalize sees the plain version's int32 inputs, so only the schedule
// and the way columns are summed differ from it.
//
// What bounds it on this card: the latency of a long chain of dependent
// barrier phases, not bytes or multiply-adds. A step is ~20 Fp2 products
// and ~20 normalizes of the point walk, the Fp12 square on doubling steps
// and two sparse line products (~160-250k multiply-adds a row), in strict
// order from step to step; each phase's items are short chains of shared
// loads and integer operations on few warps. The bytes (1.4 KB in, 1.2 KB
// out per row, the 52.8 KB line table read once per block from L2) are
// negligible.
//
// The design, on csrc/fe.cuh's device code, one block of FE_THREADS (512)
// threads per row, everything in shared memory (~88 KB):
// - the walk's Fp2 products are Karatsuba's three schoolbooks, an Fp2 × Fp
//   product two, each schoolbook three items of a column range (operand
//   scanning: independent multiply-adds); a product's 49 columns are
//   normalized in three phases (two rounds, fold, three rounds) and a
//   linear operation (ADD, SUB, NEG, SCL, CPY, CNJ) in one
//   (fe_normalize25), every normalize spread over (row, chunk of limbs)
//   lanes; the Fp12 square (FeMul<1>) and the sparse line products
//   (FeMulLine) are the same kinds of phase;
// - within a step the walk (ending in line1 and the new X, Y, Z), the
//   generator line's three Fp2 × Fp products and the Fp12 chain (xi·f,
//   f², f·gen) share no value, so their stages run in the same phases
//   (one block-stride loop over the union of their items, each part in
//   whole warps); only f·line1 needs both, and its stages run beside the
//   walk's last ones. A doubling step is 20 phases, an addition step 26;
// - the schedule is a table (M_PRE, M_DBL, M_ADD): one loop runs every
//   phase from one call site, and every stage's code is inlined there
//   once, with the chunk of limbs a lane takes chosen at run time (fe.cuh's
//   RT), so the code stays small; the instructions are resolved into
//   shared-memory offsets and coefficients once per block, and each step's
//   last phase leaves the next step its generator line and add candidate
//   in fixed registers, so a lane's operands cost it one shared load;
// - the walk updates X, Y, Z in place: each is written after its last
//   read, and no phase writes a location that the same phase reads.
// Every phase is a block-stride loop ending in __syncthreads(), so one
// thread running every item in order is a legal schedule too (the host
// shim of the tests).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "fe.cuh"

namespace gs {

constexpr int M_CW_N25 = 2;  // limbs per lane of a linear operation

// registers (Fp2; an Fp value uses component 0)
enum MReg : unsigned char {
  SX, SY, SZ, HX, HY, HYN,
  PKX, PKY, PKZ, TW0, TW1, TW2, TW3,
  // preamble: the candidates' parts
  CJX, CJY, ZCJ, NPKY, Q1X, Q1Y, Q2X, Q2Y, Q2NY, ZN0, ZN2, ZZ0, ZZC,
  C0X, C0Y, C0ZZZ, C1Y, C2X, C2Y, C2ZZZ, C3X, C3Y,
  // the walk's point, the generator line at the signature, line1
  X, Y, Z, G0, G1, G2, L0, L1, L2,
  // doubling temporaries
  DA, DBQ, DZZ, DYZ, DXB, DE, DB2, DCQ, DT, DF, DCPY, DEZZ, DEX, DTA, DCPX,
  DC8, DTAC, DD, DD2, DDX, DEDX,
  // addition temporaries
  JZ1Z1, JU1, JS1, JZ1Z2, JX1Y2, JX2Y1, JU2, JZ1C, JX1Y2Z1, JX2Y1Z2, JH,
  JS2, JHH, JR, JNR, JV, JHHH, JRR, JV2, JT, JVX, JRVX, JS1H,
  // the step's add candidate (x·z, y·z^2, z, z^2, z^3) and generator-line
  // constants, copied there by the step before
  CX, CY, CZ, CZZ, CZZZ, LC0, LC1, LC2,
  M_NREG
};

// the four add candidates; equal parts (e.g. pkz^2 for +Q, -Q and
// -pi^2 Q) are computed once
__constant__ unsigned char CAND[4][5] = {
    {C0X, C0Y, ZN0, ZZ0, C0ZZZ},
    {C0X, C1Y, ZN0, ZZ0, C0ZZZ},
    {C2X, C2Y, ZN2, ZZC, C2ZZZ},
    {C3X, C3Y, ZN0, ZZ0, C0ZZZ},
};

// Product batches: MULs (d = a·b, Fp2) first, then MFPs (d = a·b, b an
// Fp); the op field is unused. Linear phases: (op, a, b, d) as fe.cuh's
// Op, b the constant of SCL.

// preamble (`_miller_candidates`, and -hy)
__constant__ Ins PRE_L1[] = {
    {CNJ, PKX, 0, CJX}, {CNJ, PKY, 0, CJY}, {CNJ, PKZ, 0, ZCJ},
    {NEG, PKY, 0, NPKY}, {NEG, HY, 0, HYN}, {CPY, PKZ, 0, ZN0}};
__constant__ Ins PRE_P1[] = {  // 7 MUL
    {0, CJX, TW0, Q1X}, {0, CJY, TW1, Q1Y}, {0, PKX, TW2, Q2X},
    {0, PKY, TW3, Q2Y}, {0, PKZ, PKZ, ZZ0}, {0, ZCJ, ZCJ, ZZC},
    {0, PKX, PKZ, C0X}};
__constant__ Ins PRE_L2[] = {{NEG, Q2Y, 0, Q2NY}, {CPY, ZCJ, 0, ZN2}};
__constant__ Ins PRE_P2[] = {  // 8 MUL
    {0, PKY, ZZ0, C0Y}, {0, PKZ, ZZ0, C0ZZZ}, {0, NPKY, ZZ0, C1Y},
    {0, Q1X, ZCJ, C2X}, {0, Q1Y, ZZC, C2Y}, {0, ZCJ, ZZC, C2ZZZ},
    {0, Q2X, PKZ, C3X}, {0, Q2NY, ZZ0, C3Y}};

// tangent step (`_kernel_dbl_step`) at (px, py) = (hx, -hy)
__constant__ Ins D_P1[] = {  // 4 MUL, 3 MFP (the generator line)
    {0, X, X, DA}, {0, Y, Y, DBQ}, {0, Z, Z, DZZ}, {0, Y, Z, DYZ},
    {0, LC0, SY, G0}, {0, LC1, SX, G1}, {0, LC2, SZ, G2}};
__constant__ Ins D_N1[] = {
    {ADD, X, DBQ, DXB}, {SCL, DA, 3, DE}, {SCL, DYZ, 2, Z},
    {SCL, DBQ, 2, DB2}};
__constant__ Ins D_P2[] = {  // 6 MUL
    {0, DBQ, DBQ, DCQ}, {0, DXB, DXB, DT}, {0, DE, DE, DF},
    {0, Z, DZZ, DCPY}, {0, DE, DZZ, DEZZ}, {0, DE, X, DEX}};
__constant__ Ins D_N2[] = {
    {SUB, DT, DA, DTA}, {NEG, DEZZ, 0, DCPX}, {SUB, DEX, DB2, L2},
    {SCL, DCQ, 8, DC8}};
__constant__ Ins D_B[] = {{0, DCPY, HYN, L0}, {0, DCPX, HX, L1}};  // 2 MFP
__constant__ Ins D_N3[] = {{SUB, DTA, DCQ, DTAC}};
__constant__ Ins D_N4[] = {{SCL, DTAC, 2, DD}};
__constant__ Ins D_N5[] = {{SCL, DD, 2, DD2}};
__constant__ Ins D_N6[] = {{SUB, DF, DD2, X}};
__constant__ Ins D_N7[] = {{SUB, DD, X, DDX}};
__constant__ Ins D_P3[] = {{0, DE, DDX, DEDX}};  // 1 MUL
__constant__ Ins D_N8[] = {{SUB, DEDX, DC8, Y}};

// chord step (`_kernel_jadd_step`) with the candidate (CX .. CZZZ)
__constant__ Ins A_P1[] = {  // 6 MUL, 3 MFP (the generator line)
    {0, Z, Z, JZ1Z1}, {0, X, CZZ, JU1}, {0, Y, CZZZ, JS1},
    {0, Z, CZ, JZ1Z2}, {0, X, CY, JX1Y2}, {0, CX, Y, JX2Y1},
    {0, LC0, SY, G0}, {0, LC1, SX, G1}, {0, LC2, SZ, G2}};
__constant__ Ins A_P2[] = {  // 4 MUL
    {0, CX, JZ1Z1, JU2}, {0, Z, JZ1Z1, JZ1C}, {0, JX1Y2, Z, JX1Y2Z1},
    {0, JX2Y1, CZ, JX2Y1Z2}};
__constant__ Ins A_N1[] = {{SUB, JU2, JU1, JH}, {SUB, JX1Y2Z1, JX2Y1Z2, L2}};
__constant__ Ins A_P3[] = {  // 3 MUL
    {0, CY, JZ1C, JS2}, {0, JH, JH, JHH}, {0, JZ1Z2, JH, Z}};
__constant__ Ins A_N2[] = {{SUB, JS2, JS1, JR}};
__constant__ Ins A_P4[] = {  // 3 MUL, 1 MFP
    {0, JU1, JHH, JV}, {0, JH, JHH, JHHH}, {0, JR, JR, JRR},
    {0, Z, HYN, L0}};
__constant__ Ins A_N3[] = {{NEG, JR, 0, JNR}};
__constant__ Ins A_B[] = {{0, JNR, HX, L1}};  // 1 MFP
__constant__ Ins A_N4[] = {{SCL, JV, 2, JV2}, {SUB, JRR, JHHH, JT}};
__constant__ Ins A_N5[] = {{SUB, JT, JV2, X}};
__constant__ Ins A_N6[] = {{SUB, JV, X, JVX}};
__constant__ Ins A_P5[] = {{0, JR, JVX, JRVX}, {0, JS1, JHHH, JS1H}};
__constant__ Ins A_N7[] = {{SUB, JRVX, JS1H, Y}};

// Product batches (nmul Fp2 products, then nmfp Fp2 × Fp products) and
// linear phases (nmul operations), each with its slot of scratch (0, or
// 1 for a second batch in flight): (Ins array, nmul, nmfp, slot).
#define M_BATCHES(X)                                                     \
  X(PRE_L1, 6, 0, 0) X(PRE_P1, 7, 0, 0) X(PRE_L2, 2, 0, 0)               \
  X(PRE_P2, 8, 0, 0) X(D_P1, 4, 3, 0) X(D_N1, 4, 0, 0) X(D_P2, 6, 0, 0)  \
  X(D_N2, 4, 0, 0) X(D_B, 0, 2, 1) X(D_N3, 1, 0, 0) X(D_N4, 1, 0, 0)     \
  X(D_N5, 1, 0, 0) X(D_N6, 1, 0, 0) X(D_N7, 1, 0, 0) X(D_P3, 1, 0, 0)    \
  X(D_N8, 1, 0, 0) X(A_P1, 6, 3, 0) X(A_P2, 4, 0, 0) X(A_N1, 2, 0, 0)    \
  X(A_P3, 3, 0, 0) X(A_N2, 1, 0, 0) X(A_P4, 3, 1, 0) X(A_N3, 1, 0, 0)    \
  X(A_B, 0, 1, 1) X(A_N4, 2, 0, 0) X(A_N5, 1, 0, 0) X(A_N6, 1, 0, 0)     \
  X(A_P5, 2, 0, 0) X(A_N7, 1, 0, 0)

#define M_ID(name, nmul, nmfp, slot) B_##name,
enum MBatchId : unsigned char { M_BATCHES(M_ID) M_NBATCH };
#undef M_ID

// Every batch's instructions, copied into shared memory at the start of
// the block (a lane's row reads its instruction from there), and where
// each batch's start.
#define M_SIZE(name, nmul, nmfp, slot) nmul + nmfp,
constexpr int M_BATCH_SIZE[] = {M_BATCHES(M_SIZE)};
#undef M_SIZE

__host__ __device__ constexpr int m_batch_at(int id) {
  return id == 0 ? 0 : m_batch_at(id - 1) + M_BATCH_SIZE[id - 1];
}
constexpr int M_NINS = m_batch_at(M_NBATCH);

#define M_CHECK(name, nmul, nmfp, slot)                      \
  static_assert(sizeof(name) == sizeof(Ins) * (nmul + nmfp), \
                "the batch table miscounts " #name);
M_BATCHES(M_CHECK)
#undef M_CHECK

// (nmul, nmfp, slot, first instruction) of each batch
struct MBatchDesc {
  unsigned char nmul, nmfp, slot, at;
};
#define M_DESC(name, nmul, nmfp, slot) \
  {nmul, nmfp, slot, (unsigned char)m_batch_at(B_##name)},
__constant__ MBatchDesc M_BATCH[] = {M_BATCHES(M_DESC)};
#undef M_DESC

// What a part of a phase runs: a stage of a walk batch (its products,
// two rounds, fold, three rounds) or a linear phase, xi·f into the Fp12
// scratch, or a stage of the square (FeMul<1>, stages 2..7), of f·gen or
// of f·line1 (FeMulLine, stages 0..4).
enum MKind : unsigned char {
  K_NONE, K_PROD, K_R2, K_FOLD, K_R3, K_LIN, K_XI, K_SQ, K_GEN, K_LN,
  K_NEXT,  // the next step's line and candidate into LC0.. and CX..
  K_START  // the walk starts at +Q: (X, Y, Z) = (x·z, y·z^2, z)
};

struct MStage {
  unsigned char kind, arg;  // arg: the batch id, or the Fp12 stage
};

struct MPhase {
  MStage s0, s1, s2;
};

#define W(k, b) {K_##k, B_##b}
#define F(k, stage) {K_##k, stage}
#define XI {K_XI, 0}
#define NEXT {K_NEXT, 0}
#define NONE {K_NONE, 0}

__constant__ MPhase M_PRE[] = {
    {W(LIN, PRE_L1), NONE, NONE},  {W(PROD, PRE_P1), NONE, NONE},
    {W(R2, PRE_P1), NONE, NONE},   {W(FOLD, PRE_P1), NONE, NONE},
    {W(R3, PRE_P1), NONE, NONE},   {W(LIN, PRE_L2), NONE, NONE},
    {W(PROD, PRE_P2), NONE, NONE}, {W(R2, PRE_P2), NONE, NONE},
    {W(FOLD, PRE_P2), NONE, NONE}, {W(R3, PRE_P2), NONE, NONE},
    {{K_START, 0}, NEXT, NONE}};

// a doubling step: the walk beside xi·f, f², xi·f², f·gen and xi·f; then
// f·line1 beside the walk's end, and the next step's operands. f =
// ((f²)·gen)·line1 as `_miller_body`.
__constant__ MPhase M_DBL[] = {
    {W(PROD, D_P1), XI, NONE},
    {W(R2, D_P1), F(SQ, 2), NONE},
    {W(FOLD, D_P1), F(SQ, 3), NONE},
    {W(R3, D_P1), F(SQ, 4), NONE},
    {W(LIN, D_N1), F(SQ, 5), NONE},
    {W(PROD, D_P2), F(SQ, 6), NONE},
    {W(R2, D_P2), F(SQ, 7), NONE},
    {W(FOLD, D_P2), XI, NONE},
    {W(R3, D_P2), F(GEN, 0), NONE},
    {W(LIN, D_N2), F(GEN, 1), NONE},
    {W(LIN, D_N3), W(PROD, D_B), F(GEN, 2)},
    {W(LIN, D_N4), W(R2, D_B), F(GEN, 3)},
    {W(LIN, D_N5), W(FOLD, D_B), F(GEN, 4)},
    {W(LIN, D_N6), W(R3, D_B), XI},
    {W(LIN, D_N7), NONE, NONE},
    {W(PROD, D_P3), F(LN, 0), NONE},
    {W(R2, D_P3), F(LN, 1), NONE},
    {W(FOLD, D_P3), F(LN, 2), NONE},
    {W(R3, D_P3), F(LN, 3), NONE},
    {W(LIN, D_N8), F(LN, 4), NEXT}};

// an addition step: the walk beside xi·f, f·gen and xi·f; line1's L1
// from a second batch in flight; f·line1 beside the walk's end
__constant__ MPhase M_ADD[] = {
    {W(PROD, A_P1), XI, NONE},
    {W(R2, A_P1), NONE, NONE},
    {W(FOLD, A_P1), NONE, NONE},
    {W(R3, A_P1), NONE, NONE},
    {W(PROD, A_P2), F(GEN, 0), NONE},
    {W(R2, A_P2), F(GEN, 1), NONE},
    {W(FOLD, A_P2), F(GEN, 2), NONE},
    {W(R3, A_P2), F(GEN, 3), NONE},
    {W(LIN, A_N1), F(GEN, 4), NONE},
    {W(PROD, A_P3), XI, NONE},
    {W(R2, A_P3), NONE, NONE},
    {W(FOLD, A_P3), NONE, NONE},
    {W(R3, A_P3), NONE, NONE},
    {W(LIN, A_N2), NONE, NONE},
    {W(PROD, A_P4), W(LIN, A_N3), NONE},
    {W(R2, A_P4), W(PROD, A_B), NONE},
    {W(FOLD, A_P4), W(R2, A_B), NONE},
    {W(R3, A_P4), W(FOLD, A_B), NONE},
    {W(LIN, A_N4), W(R3, A_B), NONE},
    {W(LIN, A_N5), F(LN, 0), NONE},
    {W(LIN, A_N6), F(LN, 1), NONE},
    {W(PROD, A_P5), F(LN, 2), NONE},
    {W(R2, A_P5), F(LN, 3), NONE},
    {W(FOLD, A_P5), F(LN, 4), NONE},
    {W(R3, A_P5), NONE, NONE},
    {W(LIN, A_N7), NEXT, NONE}};

#undef W
#undef F
#undef XI
#undef NEXT
#undef NONE

constexpr int M_PRE_PHASES = sizeof(M_PRE) / sizeof(MPhase);
constexpr int M_DBL_PHASES = sizeof(M_DBL) / sizeof(MPhase);
constexpr int M_ADD_PHASES = sizeof(M_ADD) / sizeof(MPhase);

// the largest product batch: columns (3 per MUL, 2 per MFP) and rows
constexpr int M_SLOT_COLS = 24;
constexpr int M_SLOT_ROWS = 18;
constexpr int M_SLOT_INTS =
    M_SLOT_COLS * NC + M_SLOT_ROWS * FE_Z2 + M_SLOT_ROWS * FB;
// shared memory: constants, registers, f, the Fp12 scratch, two slots,
// the resolved instructions, the batch table, the phases
constexpr int M_REGS_AT = C_TOTAL;
constexpr int M_F_AT = M_REGS_AT + M_NREG * FP2;
constexpr int M_SCRATCH_AT = M_F_AT + FP12;
constexpr int M_SLOTS_AT = M_SCRATCH_AT + fe_scratch_ints<1>();
constexpr int M_INS_AT = M_SLOTS_AT + 2 * M_SLOT_INTS;
constexpr int M_BATCH_AT = M_INS_AT + 3 * M_NINS;  // an MIns is 3 ints
constexpr int M_RUN_AT = M_BATCH_AT + M_NBATCH;    // an MBatchDesc is one
constexpr int M_PHASES = M_PRE_PHASES + M_DBL_PHASES + M_ADD_PHASES;
constexpr int M_SMEM_INTS = M_RUN_AT + 3 * M_PHASES;  // an MRun is 3 ints

// An instruction resolved for the block: its operands and destination
// as offsets into shared memory, and, for a linear operation, the
// coefficients (ka, kb, kn) of a·ka + b·kb + negpad·kn for components 0
// and 1.
struct MIns {
  short a, b, d;
  signed char k[6];
};
static_assert(sizeof(MIns) == 3 * sizeof(int), "an MIns is three ints");
static_assert(M_SMEM_INTS < 32768, "offsets fit a short");

// A phase as the block runs it, in shared memory: its stages and the
// items of each, counted once per block.
struct MRun {
  MStage s0, s1, s2;
  unsigned short n0, n1, n2;
};
static_assert(sizeof(MRun) == 3 * sizeof(int), "an MRun is three ints");

extern __shared__ int smem[];

// Scratch of a product batch in flight: columns, rows after two rounds,
// folded rows. Two batches of the walk may be in flight at once.
struct MSlot {
  int* part;
  int* t2;
  int* acc;
};

__device__ __forceinline__ MSlot m_slot(int k) {
  int* base = smem + M_SLOTS_AT + k * M_SLOT_INTS;
  return {base, base + M_SLOT_COLS * NC,
          base + M_SLOT_COLS * NC + M_SLOT_ROWS * FE_Z2};
}

// A product batch: nmul Fp2 products, then nmfp Fp2 × Fp products (a
// linear phase: nmul operations), its resolved instructions and scratch.
struct MBatch {
  const MIns* ins;
  int nmul, nmfp;
  MSlot s;
};

__device__ __forceinline__ MBatch m_batch(int id) {
  const MBatchDesc d = reinterpret_cast<const MBatchDesc*>(smem + M_BATCH_AT)[id];
  return {reinterpret_cast<const MIns*>(smem + M_INS_AT) + d.at, d.nmul,
          d.nmfp, m_slot(d.slot)};
}

// Instruction I resolved: register offsets, and the coefficients of a
// linear operation (ADD a + b, SUB a - b + negpad, NEG negpad - a, SCL
// a·b, CPY a, CNJ (a0, negpad - a1)).
__device__ __forceinline__ MIns m_resolve(Ins I) {
  const int b = I.op == ADD || I.op == SUB ? I.b : I.a;
  MIns m{short(M_REGS_AT + I.a * FP2), short(M_REGS_AT + b * FP2),
         short(M_REGS_AT + I.d * FP2), {1, 0, 0, 1, 0, 0}};
  for (int c = 0; c < 2; ++c) {
    signed char* k = m.k + 3 * c;
    if (I.op == ADD) {
      k[1] = 1;
    } else if (I.op == SUB) {
      k[1] = -1;
      k[2] = 1;
    } else if (I.op == NEG || (I.op == CNJ && c == 1)) {
      k[0] = -1;
      k[2] = 1;
    } else if (I.op == SCL) {
      k[0] = (signed char)I.b;
    }
  }
  return m;
}

// A product item's schoolbook (u + u2) ⊛ (v + v2) in M_PARTS items of
// about equal multiply-adds, part k the columns [M_COLS[k], M_COLS[k+1])
// (column q has min(q + 1, 49 - q) terms): a phase of few products then
// spreads them over more warps, each with a third of the multiply-adds
// to issue (2, 3, 4 and 6 parts measured on the H100: 3 and 2 fastest).
constexpr int M_PARTS = 3;
constexpr int M_COLS[M_PARTS + 1] = {0, 20, 29, NC};

// The one copy of part K: operand scanning (limb l of u updates every
// open column of the part at once, independent multiply-adds, where a
// column at a time is a chain of dependent ones), every operand a row of
// the block's shared memory given by its offset.
template <int K>
__device__ __noinline__ void m_school(int u, int u2, int v, int v2, int z) {
  constexpr int Q0 = M_COLS[K], Q1 = M_COLS[K + 1];
  int V[NL], acc[Q1 - Q0];
#pragma unroll
  for (int j = 0; j < NL; ++j) V[j] = smem[v + j] + smem[v2 + j];
#pragma unroll
  for (int q = 0; q < Q1 - Q0; ++q) acc[q] = 0;
#pragma unroll
  for (int l = 0; l < NL && l < Q1; ++l) {
    if (l + NL - 1 < Q0) continue;
    const int ul = smem[u + l] + smem[u2 + l];
#pragma unroll
    for (int j = 0; j < NL; ++j)
      if (l + j >= Q0 && l + j < Q1) acc[l + j - Q0] += ul * V[j];
  }
#pragma unroll
  for (int q = 0; q < Q1 - Q0; ++q) smem[z + Q0 + q] = acc[q];
}

struct MSchool {
  static constexpr int PARTS = M_PARTS;
  template <int K>
  __device__ __forceinline__ void part(const int* u, const int* u2,
                                       const int* v, const int* v2,
                                       int* z) const {
    m_school<K>(int(u - smem), int(u2 - smem), int(v - smem),
                int(v2 - smem), int(z - smem));
  }
};

// How Miller's Fp12 stages are built: run-time chunks, narrow ones (the
// widths measured fastest on the H100), schoolbooks in M_PARTS parts.
struct MOpts {
  static constexpr bool RT = true;
  using School = MSchool;
  static constexpr int CW_Z1 = FE_CW_Z1, CW_Z2 = 4, CW_OUT = 2,
                       CW_MERGE = 3;
};

// Stage P: the schoolbooks, into B.s.part, each in M_PARTS parts (the
// part a warp-uniform group). Item t of an Fp2 product r is Karatsuba's
// product p (column row t = p·nmul + r); item t of an Fp2 × Fp product
// is component p of a times b (column row t as well).
__device__ __forceinline__ auto m_products(MBatch B) {
  const int items = 3 * B.nmul + 2 * B.nmfp, ip = (items + 31) & ~31;
  const int zero = M_SCRATCH_AT + 12 * NL;  // fe_scratch<1>'s zero row
  return fe_part(M_PARTS * ip, [=](int w) {
    int k = 0, t = w;
#pragma unroll
    for (int i = 1; i < M_PARTS; ++i)
      if (t >= ip) {
        t -= ip;
        ++k;
      }
    if (t >= items) return;
    int u, u2 = zero, v, v2 = zero;
    if (t < 3 * B.nmul) {
      const int p = (t >= B.nmul) + (t >= 2 * B.nmul);
      const MIns I = B.ins[t - p * B.nmul];
      u = I.a + (p == 1) * NL;
      v = I.b + (p == 1) * NL;
      if (p == 2) {
        u2 = I.a + NL;
        v2 = I.b + NL;
      }
    } else {
      const int x = t - 3 * B.nmul, p = x >= B.nmfp;
      const MIns I = B.ins[B.nmul + x - p * B.nmfp];
      u = I.a + p * NL;
      v = I.b;  // the Fp operand
    }
    const int z = int(B.s.part - smem) + t * NC;
    fe_dispatch<M_PARTS>(k, [&](auto kc) {
      m_school<decltype(kc)::value>(u, u2, v, v2, z);
    });
  });
}

// Stage R2: row (product i, component c): an Fp2 product's columns
// P - Q + pad547 (c = 0) or R - P - Q (c = 1), as the plain `_fp2_mul`
// pads them; an Fp2 × Fp product's columns as they are (`_fp2_mul_fp`).
__device__ __forceinline__ auto m_two_rounds(MBatch B) {
  return fe_two_rounds_part<NC, MOpts::CW_Z2, true>(
      2 * (B.nmul + B.nmfp), [=](int r) {
        const int c = r & 1, i = r >> 1;
        const int* pad = smem + C_PAD;
        const int* P = B.s.part + i * NC;
        const int* Q = P + B.nmul * NC;
        const int* Rk = Q + B.nmul * NC;
        const int* a = P;  // the sum a + kb·b + kc·q + kp·pad
        const int* b = Q;
        int kb = -1, kc = 0, kp = 1;
        if (i >= B.nmul) {
          a = B.s.part + (3 * B.nmul + c * B.nmfp + i - B.nmul) * NC;
          b = a;
          kb = kp = 0;
        } else if (c == 1) {
          a = Rk;
          b = P;
          kc = -1;
          kp = 0;
        }
        return [=](int l) {
          return a[l] + b[l] * kb + Q[l] * kc + pad[l] * kp;
        };
      },
      B.s.t2);
}

__device__ __forceinline__ auto m_fold(MBatch B) {
  return fe_fold_part<NC>(2 * (B.nmul + B.nmfp), B.s.t2, B.s.acc, smem);
}

// Stage R3: the three last rounds into the destination registers.
__device__ __forceinline__ auto m_three_rounds(MBatch B) {
  return fe_three_rounds_part<MOpts::CW_OUT, true>(
      2 * (B.nmul + B.nmfp), B.s.acc,
      [=](int r) { return smem + B.ins[r >> 1].d + (r & 1) * NL; }, smem);
}

// A linear phase, row (operation, component): each one normalize of
// a·ka + b·kb + negpad·kn, the plain version's int32 input. With `xi`,
// the 12 rows of xi·f into the Fp12 scratch: (9a - b + negpad, a + 9b)
// as `_mul_xi`.
__device__ __forceinline__ auto m_linear(MBatch B, bool xi) {
  const int* f = smem + M_F_AT;
  int* xif = smem + M_SCRATCH_AT;  // fe_scratch<1>'s xi rows
  auto in = [=](int r) {
    const int c = r & 1;
    const int* a;
    const int* b;
    int ka, kb, kn;
    if (xi) {
      a = f + (r & ~1) * NL;
      b = a + NL;
      ka = c ? 1 : 9;
      kb = c ? 9 : -1;
      kn = !c;
    } else {
      const MIns I = B.ins[r >> 1];
      a = smem + I.a + c * NL;
      b = smem + I.b + c * NL;
      ka = I.k[3 * c];
      kb = I.k[3 * c + 1];
      kn = I.k[3 * c + 2];
    }
    const int* neg = smem + C_NEG;
    return [=](int l) { return a[l] * ka + b[l] * kb + neg[l] * kn; };
  };
  auto out = [=](int r) {
    return xi ? xif + r * NL : smem + B.ins[r >> 1].d + (r & 1) * NL;
  };
  return fe_normalize25_part<M_CW_N25, true>(xi ? 12 : 2 * B.nmul, in, out,
                                             smem);
}

// The next step's operands: its generator line into LC0.., and, for an
// addition, its candidate into CX.. (the candidates stay put from the
// preamble on). `line` is null and `op` 0 where nothing follows.
struct MStep {
  const int* line;
  int op;
};

__device__ __forceinline__ auto m_next(MStep next) {
  constexpr int LINE = 3 * FP2, CAND5 = 5 * FP2;
  int* R = smem + M_REGS_AT;
  return fe_part((LINE + CAND5 + 31) & ~31, [=](int t) {
    if (t < LINE) {
      if (next.line) R[LC0 * FP2 + t] = next.line[t];
    } else if (t < LINE + CAND5 && next.op > 0) {
      const int k = (t - LINE) / FP2, j = t - LINE - k * FP2;
      R[(CX + k) * FP2 + j] = R[CAND[next.op - 1][k] * FP2 + j];
    }
  });
}

// Runs fn(part) on the part of stage st.
template <class Fn>
__device__ __forceinline__ void m_with_part(MStage st, MStep next, Fn fn) {
  int* f = smem + M_F_AT;
  FeScratch S;
  fe_scratch<1>(smem + M_SCRATCH_AT, S);
  const MBatch B = m_batch(st.arg);
  const FeMul<1, MOpts> sq{f, f, f, S, smem};
  const FeMulLine<MOpts> ln{
      f, smem + M_REGS_AT + (st.kind == K_GEN ? G0 : L0) * FP2, f, S, smem};
  switch (st.kind) {
    case K_PROD: fn(m_products(B)); break;
    case K_R2: fn(m_two_rounds(B)); break;
    case K_FOLD: fn(m_fold(B)); break;
    case K_R3: fn(m_three_rounds(B)); break;
    case K_LIN: fn(m_linear(B, false)); break;
    case K_XI: fn(m_linear(B, true)); break;
    case K_SQ:
      switch (st.arg) {
        case 2: fn(sq.part<2>()); break;
        case 3: fn(sq.part<3>()); break;
        case 4: fn(sq.part<4>()); break;
        case 5: fn(sq.part<5>()); break;
        case 6: fn(sq.part<6>()); break;
        default: fn(sq.part<7>()); break;
      }
      break;
    case K_GEN:
    case K_LN:
      switch (st.arg) {
        case 0: fn(ln.part<0>()); break;
        case 1: fn(ln.part<1>()); break;
        case 2: fn(ln.part<2>()); break;
        case 3: fn(ln.part<3>()); break;
        default: fn(ln.part<4>()); break;
      }
      break;
    case K_NEXT: fn(m_next(next)); break;
    case K_START: {
      int* R = smem + M_REGS_AT;
      fn(fe_part((3 * FP2 + 31) & ~31, [=](int t) {
        const int k = t / FP2;
        if (t < 3 * FP2)
          R[X * FP2 + t] = R[(k == 0 ? C0X : k == 1 ? C0Y : ZN0) * FP2 +
                             t - k * FP2];
      }));
      break;
    }
    default: break;
  }
}

__device__ __forceinline__ int m_items(MStage st) {
  int n = 0;
  m_with_part(st, MStep{nullptr, 0}, [&](const auto& part) { n = part.n; });
  return n;
}

// One phase: its parts' items in one block-stride loop, then a barrier.
// Every stage's item code is inlined here once: the kernel runs all its
// phases from this one site, so its code stays small.
__device__ __forceinline__ void m_phase(const MRun& P, MStep next) {
  const int n0 = P.n0, n01 = P.n0 + P.n1, n = n01 + P.n2;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    MStage st = P.s2;
    int u = t - n01;
    if (t < n0) {
      st = P.s0;
      u = t;
    } else if (t < n01) {
      st = P.s1;
      u = t - n0;
    }
    m_with_part(st, next, [&](const auto& part) { part.f(u); });
  }
  __syncthreads();
}

__global__ void __launch_bounds__(FE_THREADS)
    miller_kernel(const int* __restrict__ sx, const int* __restrict__ sy,
                  const int* __restrict__ sz, const int* __restrict__ hx,
                  const int* __restrict__ hy, const int* __restrict__ pkx,
                  const int* __restrict__ pky, const int* __restrict__ pkz,
                  const int* __restrict__ ops, int nops,
                  const int* __restrict__ lines, const int* __restrict__ twf,
                  const int* __restrict__ consts, int* __restrict__ out) {
  int* R = smem + M_REGS_AT;
  int* f = smem + M_F_AT;
  load_consts(smem, consts);
  fe_host_consts(consts);
  const long b = blockIdx.x;
  for (int i = threadIdx.x; i < M_NREG * FP2; i += blockDim.x) {
    const int reg = i / FP2, k = i % FP2;
    const int* fp[] = {sx, sy, sz, hx, hy};
    const int* fp2[] = {pkx, pky, pkz};
    int v = 0;
    if (reg <= HY)
      v = k < NL ? fp[reg][b * NL + k] : 0;
    else if (reg >= PKX && reg <= PKZ)
      v = fp2[reg - PKX][b * FP2 + k];
    else if (reg >= TW0 && reg <= TW3)
      v = twf[(reg - TW0) * FP2 + k];
    R[i] = v;
  }
  for (int i = threadIdx.x; i < FP12; i += blockDim.x) f[i] = i == 0;
  int* zero = smem + M_SCRATCH_AT + 12 * NL;  // fe_scratch<1>'s zero row
  for (int i = threadIdx.x; i < NL; i += blockDim.x) zero[i] = 0;
  MIns* ins = reinterpret_cast<MIns*>(smem + M_INS_AT);
#define M_COPY(name, nmul, nmfp, slot)                         \
  {                                                             \
    constexpr int at = m_batch_at(B_##name);                    \
    for (int i = threadIdx.x; i < nmul + nmfp; i += blockDim.x) \
      ins[at + i] = m_resolve(name[i]);                         \
  }
  M_BATCHES(M_COPY)
#undef M_COPY
  for (int i = threadIdx.x; i < M_NBATCH; i += blockDim.x)
    reinterpret_cast<MBatchDesc*>(smem + M_BATCH_AT)[i] = M_BATCH[i];
  __syncthreads();  // the counts below read the batch table
  MRun* run = reinterpret_cast<MRun*>(smem + M_RUN_AT);
  for (int i = threadIdx.x; i < M_PHASES; i += blockDim.x) {
    const MPhase P =
        i < M_PRE_PHASES
            ? M_PRE[i]
            : (i < M_PRE_PHASES + M_DBL_PHASES ? M_DBL[i - M_PRE_PHASES]
                                               : M_ADD[i - M_PRE_PHASES -
                                                       M_DBL_PHASES]);
    run[i] = {P.s0, P.s1, P.s2, (unsigned short)m_items(P.s0),
              (unsigned short)m_items(P.s1), (unsigned short)m_items(P.s2)};
  }
  __syncthreads();

  // the preamble's phases, then each step's, from one call site: step -1
  // is the preamble, and the step before each step leaves it its operands
  MStep next{nops > 0 ? lines : nullptr, nops > 0 ? ops[0] : 0};
  for (int s = -1, p = 0, op = -1;;) {
    const int at = op < 0 ? 0 : (op == 0 ? M_PRE_PHASES
                                         : M_PRE_PHASES + M_DBL_PHASES);
    m_phase(run[at + p], next);
    const int nph =
        op < 0 ? M_PRE_PHASES : (op == 0 ? M_DBL_PHASES : M_ADD_PHASES);
    if (++p < nph) continue;
    p = 0;
    if (++s == nops) break;
    op = ops[s];
    next = s + 1 < nops ? MStep{lines + (long)(s + 1) * 3 * FP2, ops[s + 1]}
                        : MStep{nullptr, 0};
  }

  for (int i = threadIdx.x; i < FP12; i += blockDim.x)
    out[b * FP12 + i] = f[i];
}

}  // namespace gs

#ifdef __CUDACC__
// sx, sy, sz, hx, hy: (n, 25); pkx, pky, pkz: (n, 2, 25); ops: (nops,),
// each 0 (DBL) or 1-4 (ADD with that candidate); lines: (nops, 3, 2, 25),
// the generator line of each step; twf: (4, 2, 25); out: (n, 6, 2, 25);
// all int32. Returns the first CUDA error of the launch, 0 if none.
extern "C" int gs_miller(const int* sx, const int* sy, const int* sz,
                         const int* hx, const int* hy, const int* pkx,
                         const int* pky, const int* pkz, const int* ops,
                         int nops, const int* lines, const int* twf,
                         const int* consts, int n, int* out,
                         cudaStream_t stream) {
  const int smem = gs::M_SMEM_INTS * (int)sizeof(int);
  cudaError_t err = cudaMemcpyToSymbolAsync(
      gs::fe_fold_c, consts + gs::C_FOLD, sizeof(gs::fe_fold_c), 0,
      cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(gs::fe_lift_c, consts + gs::C_LIFT,
                                  sizeof(gs::fe_lift_c), 0,
                                  cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gs::miller_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  gs::miller_kernel<<<n, gs::FE_THREADS, smem, stream>>>(
      sx, sy, sz, hx, hy, pkx, pky, pkz, ops, nops, lines, twf, consts, out);
  return (int)cudaGetLastError();
}
#endif
