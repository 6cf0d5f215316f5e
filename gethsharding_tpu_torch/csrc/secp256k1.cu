// secp256k1 public-key recovery, one row per thread.
//
// Computes what `ecrecover_batch` of gethsharding_tpu/ops/secp256k1_jax.py
// (:136, an XLA computation there, not a Pallas kernel) computes, and what
// its plain twin `ecrecover_plain` (ops/secp256k1.py) computes on 12-bit
// limbs: for each row, with R = lift_x(r) of parity recid,
//   Q = u1·G + u2·R,  u1 = -e·r^-1 mod n,  u2 = s·r^-1 mod n,
// as affine (qx, qy) at canonical values (0 where Q is infinity), and `ok`:
// valid, R on the curve, r and s in [1, n-1] as raw integers, recid in
// {0, 1}, Q not infinity. Every value is the same residue as the plain
// version's: the same Jacobian formulas (dbl-2009-l; the chord with P = Q
// doubling and P = -Q going to infinity; infinity operands passing
// through), the same Fermat inverses (inv(0) = 0) and the same parity
// rule, so the canonical outputs are equal on every row, hostile ones
// included. Where the reference computes a point at infinity in full,
// this kernel skips work whose result nothing reads (the doubling of an
// accumulator at infinity; X and Y once Z is 0).
//
// What bounds it on this card: 32 x 32 -> 64-bit multiply-adds, 128 per
// Montgomery product (64 for the product, 64 for the reduction) and 100
// per square (36 for the square), about 1,500 products in the three
// fixed-exponent powers (the square root and the inverses mod n and mod
// p; most of them squares) and 7 per doubling (5 squares) plus 11 or 16
// per addition of the 256-step ladder; its bytes (three 25-limb rows in,
// two out) are negligible. This kernel squares with its general product.
//
// The design: the simplest that is right. One thread per row holds its
// values as 8 x 32-bit words in Montgomery form (R = 2^256); one CIOS
// product serves p and n; the ladder runs from the top set bit with the
// addend chosen per row from {G, R, G + R}; rows of a warp diverge where
// their bits differ. At the notary's 100 rows (112 padded) it fills a
// fraction of a few SMs: it is latency-bound on each thread's serial
// chain of products. A warp per row, spreading a product's words over
// lanes as fe.cuh does for bn256, is the redesign this leaves to later.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace gs {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int SECP_THREADS = 64;   // rows per block
constexpr int SECP_IN_WORDS = 10;  // 32-bit words of a row of <= 25 limbs

struct Fe {
  u32 w[8];   // little-endian words
};

struct SecpMod {
  Fe m;       // the modulus
  u32 inv;    // -m^-1 mod 2^32
  Fe r2;      // R^2 mod m
  Fe r3;      // R^3 mod m
  Fe one;     // R mod m: 1 in Montgomery form
};

static __constant__ SecpMod SECP_P = {
    {{0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
      0xffffffffu, 0xffffffffu, 0xffffffffu}},
    0xd2253531u,
    {{0x000e90a1u, 0x000007a2u, 0x00000001u, 0, 0, 0, 0, 0}},
    {{0x3795f671u, 0x002bb1e3u, 0x00000b73u, 0x00000001u, 0, 0, 0, 0}},
    {{0x000003d1u, 0x00000001u, 0, 0, 0, 0, 0, 0}}};

static __constant__ SecpMod SECP_N = {
    {{0xd0364141u, 0xbfd25e8cu, 0xaf48a03bu, 0xbaaedce6u, 0xfffffffeu,
      0xffffffffu, 0xffffffffu, 0xffffffffu}},
    0x5588b13fu,
    {{0x67d7d140u, 0x896cf214u, 0x0e7cf878u, 0x741496c2u, 0x5bcd07c6u,
      0xe697f5e4u, 0x81c69bc5u, 0x9d671cd5u}},
    {{0xe9ff41edu, 0x7bc0cfe0u, 0x44d4322cu, 0x00176484u, 0xf1d0b2dau,
      0xb1b31347u, 0x18ef116du, 0x555d800cu}},
    {{0x2fc9bebfu, 0x402da173u, 0x50b75fc4u, 0x45512319u, 0x00000001u, 0, 0,
      0}}};

// fixed exponents: (p + 1) / 4 (square root, p = 3 mod 4), p - 2, n - 2
static __constant__ Fe SECP_SQRT_E = {
    {0xbfffff0cu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
     0xffffffffu, 0xffffffffu, 0x3fffffffu}};
static __constant__ Fe SECP_INVP_E = {
    {0xfffffc2du, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
     0xffffffffu, 0xffffffffu, 0xffffffffu}};
static __constant__ Fe SECP_INVN_E = {
    {0xd036413fu, 0xbfd25e8cu, 0xaf48a03bu, 0xbaaedce6u, 0xfffffffeu,
     0xffffffffu, 0xffffffffu, 0xffffffffu}};

// the generator and b = 7, in Montgomery form mod p
static __constant__ Fe SECP_GX = {
    {0x487e2097u, 0xd7362e5au, 0x29bc66dbu, 0x231e2953u, 0x33fd129cu,
     0x979f48c0u, 0xe9089f48u, 0x9981e643u}};
static __constant__ Fe SECP_GY = {
    {0xd3dbabe2u, 0xb15ea6d2u, 0x1f1dc64du, 0x8dfc5d5du, 0xac19c136u,
     0x70b6b59au, 0xd4a582d6u, 0xcf3f851fu}};
static __constant__ Fe SECP_B7 = {{0x00001ab7u, 0x00000007u, 0, 0, 0, 0, 0,
                                   0}};

// -- words ------------------------------------------------------------------

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  u32 acc = 0;
  for (int j = 0; j < 8; ++j) acc |= a.w[j];
  return acc == 0;
}

__device__ __forceinline__ bool fe_equal(const Fe& a, const Fe& b) {
  u32 acc = 0;
  for (int j = 0; j < 8; ++j) acc |= a.w[j] ^ b.w[j];
  return acc == 0;
}

// a - b over 8 words; returns the borrow out (0 or 1)
__device__ __forceinline__ u32 fe_sub_raw(Fe& d, const Fe& a, const Fe& b) {
  u32 borrow = 0;
  for (int j = 0; j < 8; ++j) {
    const u64 t = (u64)a.w[j] - b.w[j] - borrow;
    d.w[j] = (u32)t;
    borrow = (u32)(t >> 63);
  }
  return borrow;
}

// the value top·2^256 + a, below 2m, reduced below m
__device__ __forceinline__ Fe fe_reduce_once(const Fe& a, u32 top,
                                             const SecpMod& M) {
  Fe d;
  const u32 borrow = fe_sub_raw(d, a, M.m);
  return (top != 0 || borrow == 0) ? d : a;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const SecpMod& M) {
  Fe s;
  u32 carry = 0;
  for (int j = 0; j < 8; ++j) {
    const u64 t = (u64)a.w[j] + b.w[j] + carry;
    s.w[j] = (u32)t;
    carry = (u32)(t >> 32);
  }
  return fe_reduce_once(s, carry, M);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const SecpMod& M) {
  Fe d;
  if (fe_sub_raw(d, a, b)) {
    u32 carry = 0;
    for (int j = 0; j < 8; ++j) {
      const u64 t = (u64)d.w[j] + M.m.w[j] + carry;
      d.w[j] = (u32)t;
      carry = (u32)(t >> 32);
    }
  }
  return d;
}

// Montgomery product a·b·R^-1 mod m (CIOS) of a, b < m; the result is < m.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b,
                                       const SecpMod& M) {
  u32 t[10];
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const u64 s = (u64)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;
    t[9] = (u32)(s >> 32);
    const u32 q = t[0] * M.inv;
    s = (u64)q * M.m.w[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (u64)q * M.m.w[j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = t[9] + (u32)(s >> 32);
  }
  Fe lo;
  for (int j = 0; j < 8; ++j) lo.w[j] = t[j];
  return fe_reduce_once(lo, t[8], M);
}

// x^E for a fixed exponent E > 0: square-and-multiply from its top bit.
// 0^E = 0, so the Fermat inverse of 0 is 0, as in the reference.
__device__ __forceinline__ Fe fe_pow(const Fe& x, const Fe& E,
                                     const SecpMod& M) {
  int top = 255;
  while (top > 0 && !((E.w[top >> 5] >> (top & 31)) & 1)) --top;
  Fe r = x;
  for (int i = top - 1; i >= 0; --i) {
    r = mont_mul(r, r, M);
    if ((E.w[i >> 5] >> (i & 31)) & 1) r = mont_mul(r, x, M);
  }
  return r;
}

// a row of canonical 12-bit limbs (value < 2^(12·nl), nl <= 25) as words
__device__ __forceinline__ void limbs_to_words(const int* x, int nl,
                                               u32* w) {
  for (int k = 0; k < SECP_IN_WORDS; ++k) w[k] = 0;
  for (int i = 0; i < nl; ++i) {
    const u32 limb = (u32)x[i] & 0xFFFu;
    const int bit = 12 * i, k = bit >> 5, off = bit & 31;
    w[k] |= limb << off;
    if (off > 20) w[k + 1] |= limb >> (32 - off);
  }
}

// canonical words (value < 2^256) as nl canonical limbs
__device__ __forceinline__ void words_to_limbs(const Fe& a, int nl,
                                               int* out) {
  for (int i = 0; i < nl; ++i) {
    const int bit = 12 * i, k = bit >> 5, off = bit & 31;
    u32 v = k < 8 ? a.w[k] >> off : 0;
    if (off > 20 && k + 1 < 8) v |= a.w[k + 1] << (32 - off);
    out[i] = (int)(v & 0xFFFu);
  }
}

// a value below 2^320 (words lo·2^0 + hi·2^256, hi < 2^64) in Montgomery
// form mod m: lo·R + hi·R^2, through two products
__device__ __forceinline__ Fe to_mont(const u32* w, const SecpMod& M) {
  Fe lo, hi;
  for (int j = 0; j < 8; ++j) {
    lo.w[j] = w[j];
    hi.w[j] = 0;
  }
  hi.w[0] = w[8];
  hi.w[1] = w[9];
  lo = fe_reduce_once(lo, 0, M);   // lo < 2^256 < 2m
  return fe_add(mont_mul(lo, M.r2, M), mont_mul(hi, M.r3, M), M);
}

__device__ __forceinline__ Fe from_mont(const Fe& a, const SecpMod& M) {
  Fe unit = {{1, 0, 0, 0, 0, 0, 0, 0}};
  return mont_mul(a, unit, M);
}

// raw value of the words below n?
__device__ __forceinline__ bool lt_n(const u32* w) {
  if (w[8] | w[9]) return false;
  Fe a, d;
  for (int j = 0; j < 8; ++j) a.w[j] = w[j];
  return fe_sub_raw(d, a, SECP_N.m) != 0;
}

// -- Jacobian points over y^2 = x^3 + 7 (Montgomery form mod p) --------------

struct Pt {
  Fe x, y, z;   // infinity: z = 0
};

__device__ __forceinline__ Fe mp(const Fe& a, const Fe& b) {
  return mont_mul(a, b, SECP_P);
}
__device__ __forceinline__ Fe ap(const Fe& a, const Fe& b) {
  return fe_add(a, b, SECP_P);
}
__device__ __forceinline__ Fe sp(const Fe& a, const Fe& b) {
  return fe_sub(a, b, SECP_P);
}

// dbl-2009-l (a = 0): 7 products
__device__ __noinline__ Pt pt_double(const Pt& a) {
  const Fe A = mp(a.x, a.x);
  const Fe B = mp(a.y, a.y);
  const Fe C = mp(B, B);
  Fe t = ap(a.x, B);
  t = mp(t, t);
  Fe D = sp(sp(t, A), C);
  D = ap(D, D);                                // 4XY^2
  const Fe E = ap(ap(A, A), A);
  const Fe F = mp(E, E);
  Pt o;
  o.x = sp(F, ap(D, D));
  Fe C8 = ap(C, C);
  C8 = ap(C8, C8);
  C8 = ap(C8, C8);
  o.y = sp(mp(E, sp(D, o.x)), C8);
  o.z = mp(a.y, a.z);
  o.z = ap(o.z, o.z);
  return o;
}

// a + b, b_affine where b.z is 1: 11 products, else 16; P = Q doubles,
// P = -Q is infinity, an infinity operand gives the other one
__device__ __noinline__ Pt pt_add(const Pt& a, const Pt& b, bool b_affine) {
  if (fe_is_zero(a.z)) return b;
  if (fe_is_zero(b.z)) return a;
  const Fe Z1Z1 = mp(a.z, a.z);
  Fe U1 = a.x, S1 = a.y;
  if (!b_affine) {
    const Fe Z2Z2 = mp(b.z, b.z);
    U1 = mp(a.x, Z2Z2);
    S1 = mp(a.y, mp(b.z, Z2Z2));
  }
  const Fe U2 = mp(b.x, Z1Z1);
  const Fe S2 = mp(b.y, mp(a.z, Z1Z1));
  const Fe H = sp(U2, U1);
  const Fe R = sp(S2, S1);
  if (fe_is_zero(H)) {
    if (fe_is_zero(R)) return pt_double(a);
    Pt inf;                  // X and Y at infinity are never read
    inf.x = SECP_P.one;
    inf.y = SECP_P.one;
    inf.z = Fe{{0, 0, 0, 0, 0, 0, 0, 0}};
    return inf;
  }
  const Fe HH = mp(H, H);
  const Fe HHH = mp(H, HH);
  const Fe V = mp(U1, HH);
  Pt o;
  o.x = sp(sp(mp(R, R), HHH), ap(V, V));
  o.y = sp(mp(R, sp(V, o.x)), mp(S1, HHH));
  o.z = b_affine ? mp(a.z, H) : mp(mp(a.z, b.z), H);
  return o;
}

__device__ __forceinline__ int bit_of(const Fe& k, int i) {
  return (k.w[i >> 5] >> (i & 31)) & 1;
}

// e, r, s (n, nl) canonical limbs; recid (n,); valid (n,) 0/1; qx, qy
// (n, nl); ok (n,) 0/1. One thread per row.
__global__ void __launch_bounds__(SECP_THREADS)
    ecrecover_kernel(const int* e, const int* r, const int* s,
                     const int* recid, const unsigned char* valid, int n,
                     int nl, int* qx, int* qy, unsigned char* ok) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  u32 rw[SECP_IN_WORDS], ew[SECP_IN_WORDS], sw[SECP_IN_WORDS];
  limbs_to_words(r + (long long)row * nl, nl, rw);
  limbs_to_words(e + (long long)row * nl, nl, ew);
  limbs_to_words(s + (long long)row * nl, nl, sw);
  const int v = recid[row];

  // R = lift_x(r): y = (r^3 + 7)^((p+1)/4), the parity chosen by recid
  const Fe rx = to_mont(rw, SECP_P);
  const Fe y_sq = ap(mp(mp(rx, rx), rx), SECP_B7);
  Fe ry = fe_pow(y_sq, SECP_SQRT_E, SECP_P);
  const bool on_curve = fe_equal(mp(ry, ry), y_sq);
  if ((int)(from_mont(ry, SECP_P).w[0] & 1) != (v & 1))
    ry = sp(Fe{{0, 0, 0, 0, 0, 0, 0, 0}}, ry);

  // u1 = -e·r^-1, u2 = s·r^-1 mod n
  const Fe rn = to_mont(rw, SECP_N);
  const Fe sn = to_mont(sw, SECP_N);
  const Fe rinv = fe_pow(rn, SECP_INVN_E, SECP_N);
  const Fe en = to_mont(ew, SECP_N);
  const Fe zero = {{0, 0, 0, 0, 0, 0, 0, 0}};
  const Fe u1 = from_mont(
      mont_mul(fe_sub(zero, en, SECP_N), rinv, SECP_N), SECP_N);
  const Fe u2 = from_mont(mont_mul(sn, rinv, SECP_N), SECP_N);

  Pt G, Rp;
  G.x = SECP_GX;
  G.y = SECP_GY;
  G.z = SECP_P.one;
  Rp.x = rx;
  Rp.y = ry;
  Rp.z = SECP_P.one;
  const Pt GR = pt_add(G, Rp, true);

  // the Shamir ladder, MSB to LSB: acc = 2·acc + {0, G, R, G + R}
  Pt acc;
  acc.x = SECP_P.one;
  acc.y = SECP_P.one;
  acc.z = zero;
  for (int i = 255; i >= 0; --i) {
    if (!fe_is_zero(acc.z)) acc = pt_double(acc);
    const int t1 = bit_of(u1, i), t2 = bit_of(u2, i);
    if (t1 && t2)
      acc = pt_add(acc, GR, false);
    else if (t1)
      acc = pt_add(acc, G, true);
    else if (t2)
      acc = pt_add(acc, Rp, true);
  }

  // affine: x = X/Z^2, y = Y/Z^3 (0 at infinity: inv(0) = 0)
  const Fe zinv = fe_pow(acc.z, SECP_INVP_E, SECP_P);
  const Fe zinv2 = mp(zinv, zinv);
  const Fe x = from_mont(mp(acc.x, zinv2), SECP_P);
  const Fe y = from_mont(mp(acc.y, mp(zinv, zinv2)), SECP_P);
  words_to_limbs(x, nl, qx + (long long)row * nl);
  words_to_limbs(y, nl, qy + (long long)row * nl);

  const bool r_ok = !fe_is_zero(rn) && lt_n(rw);
  const bool s_ok = !fe_is_zero(sn) && lt_n(sw);
  ok[row] = (valid[row] != 0) && on_curve && r_ok && s_ok && v >= 0 &&
            v < 2 && !fe_is_zero(acc.z);
}

}  // namespace gs

#ifdef __CUDACC__
// e, r, s (n, nl) int32 canonical limbs, nl 22 or 25; recid (n,) int32;
// valid (n,) bool; qx, qy (n, nl) int32; ok (n,) bool. Returns the first
// CUDA error of the launch, 0 if none.
extern "C" int gs_ecrecover(const int* e, const int* r, const int* s,
                            const int* recid, const unsigned char* valid,
                            int n, int nl, int* qx, int* qy,
                            unsigned char* ok, cudaStream_t stream) {
  if (n < 0 || (nl != 22 && nl != 25)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + gs::SECP_THREADS - 1) / gs::SECP_THREADS;
  gs::ecrecover_kernel<<<blocks, gs::SECP_THREADS, 0, stream>>>(
      e, r, s, recid, valid, n, nl, qx, qy, ok);
  return (int)cudaGetLastError();
}
#endif
