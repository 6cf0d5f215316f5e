/* mpt.c — bulk Merkle-Patricia-trie root construction, on the host.
 *
 * The port's own copy of the JAX package's native/mpt.c (the port imports
 * nothing of that package). core/mpt.py builds it together with
 * csrc/keccak.c, whose gs_keccak256 it calls, into one library with the
 * host C compiler on first use, and binds it with ctypes. A host-side C
 * file, not a CUDA kernel: ops/_build.py compiles only the *.cu sources.
 * One change from that copy: the sort's context is thread-local.
 *
 * The answer to the per-byte DeriveSha scalability trap: a collation's
 * chunk root inserts one entry per BODY BYTE into a trie
 * (sharding/collation.go CalculateChunkRoot -> core/types/derive_sha.go),
 * fine in Go, minutes in Python for a 1 MiB body. This builds the same
 * root bottom-up from a sorted entry list in one pass: yellow-paper node
 * encodings (leaf/extension 2-item lists with hex-prefix paths, 17-item
 * branches, >=32-byte nodes referenced by keccak), byte-identical with
 * core/trie.py (held against it by tests/test_torch_trie.py).
 *
 * Scope: insert-only tries with small keys/values (caps below) — exactly
 * the DeriveSha and state-trie shapes. Duplicate keys keep the last value
 * (update semantics).
 *
 * Export:
 *   int gs_mpt_root(keys, key_stride, key_lens, vals, val_stride,
 *                   val_lens, n, out32)
 *     -> 0 on success, nonzero on cap violations.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

void gs_keccak256(const uint8_t *in, uint64_t len, uint8_t *out32);

#define KEY_CAP 32      /* max key bytes -> max 64 nibbles (secure-trie keccak keys) */
#define VAL_CAP 128     /* max value bytes (state-account RLP <= 110) */
#define MAX_NIB (2 * KEY_CAP)
/* worst node: branch of 16 embedded children (<32B each) + value + header */
#define NODE_BUF 1024

typedef struct {
  const uint8_t *nib;  /* n * MAX_NIB */
  const uint8_t *nlen; /* nibble path length per entry */
  const uint8_t *val;  /* n * VAL_CAP (RLP-encoded values) */
  const uint8_t *vlen;
  const uint32_t *idx; /* sorted order */
} Ctx;

/* ---- RLP helpers ---- */

static uint64_t rlp_str(const uint8_t *data, uint64_t len, uint8_t *out) {
  if (len == 1 && data[0] < 0x80) {
    out[0] = data[0];
    return 1;
  }
  if (len <= 55) {
    out[0] = 0x80 + (uint8_t)len;
    memcpy(out + 1, data, len);
    return len + 1;
  }
  /* long form (56..255 bytes — VAL_CAP bounds the inputs) */
  out[0] = 0xb8;
  out[1] = (uint8_t)len;
  memcpy(out + 2, data, len);
  return len + 2;
}

static uint64_t rlp_list_wrap(uint8_t *payload, uint64_t plen, uint8_t *out) {
  if (plen <= 55) {
    out[0] = 0xc0 + (uint8_t)plen;
    memcpy(out + 1, payload, plen);
    return plen + 1;
  }
  uint64_t l = plen;
  int lenlen = 0;
  uint8_t lenbytes[8];
  while (l) {
    lenbytes[lenlen++] = (uint8_t)(l & 0xFF);
    l >>= 8;
  }
  out[0] = 0xf7 + (uint8_t)lenlen;
  for (int i = 0; i < lenlen; i++) out[1 + i] = lenbytes[lenlen - 1 - i];
  memcpy(out + 1 + lenlen, payload, plen);
  return 1 + lenlen + plen;
}

/* hex-prefix encode path[0..len) with leaf flag; returns byte length */
static uint64_t hp_encode(const uint8_t *path, uint64_t len, int leaf,
                          uint8_t *out) {
  uint8_t flag = leaf ? 2 : 0;
  uint64_t olen = 0;
  if (len % 2 == 1) {
    out[0] = (uint8_t)(((flag + 1) << 4) | path[0]);
    path++;
    len--;
    olen = 1;
  } else {
    out[0] = (uint8_t)(flag << 4);
    olen = 1;
  }
  for (uint64_t i = 0; i < len; i += 2)
    out[olen++] = (uint8_t)((path[i] << 4) | path[i + 1]);
  return olen;
}

/* ---- recursive build ---- */

static int node_build(const Ctx *ctx, uint64_t lo, uint64_t hi, uint64_t depth,
                      uint8_t *out, uint64_t *olen);

/* child reference into parent payload: raw rlp if <32 else keccak string */
static int child_ref(const Ctx *ctx, uint64_t lo, uint64_t hi, uint64_t depth,
                     uint8_t *out, uint64_t *olen) {
  uint8_t buf[NODE_BUF];
  uint64_t blen;
  int rc = node_build(ctx, lo, hi, depth, buf, &blen);
  if (rc) return rc;
  if (blen < 32) {
    memcpy(out, buf, blen);
    *olen = blen;
  } else {
    uint8_t h[32];
    gs_keccak256(buf, blen, h);
    *olen = rlp_str(h, 32, out);
  }
  return 0;
}

static int node_build(const Ctx *ctx, uint64_t lo, uint64_t hi, uint64_t depth,
                      uint8_t *out, uint64_t *olen) {
  uint8_t payload[NODE_BUF];
  uint64_t plen = 0;
  const uint8_t *nib0 = ctx->nib + (uint64_t)ctx->idx[lo] * MAX_NIB;
  uint64_t len0 = ctx->nlen[ctx->idx[lo]];

  if (hi - lo == 1) { /* leaf */
    uint8_t hp[KEY_CAP + 1];
    uint64_t hplen = hp_encode(nib0 + depth, len0 - depth, 1, hp);
    plen += rlp_str(hp, hplen, payload + plen);
    const uint8_t *val = ctx->val + (uint64_t)ctx->idx[lo] * VAL_CAP;
    uint64_t vlen = ctx->vlen[ctx->idx[lo]];
    plen += rlp_str(val, vlen, payload + plen);
    *olen = rlp_list_wrap(payload, plen, out);
    return 0;
  }

  /* common prefix below depth across the (sorted) range: compare the
   * first and last paths; an exhausted first path forces a branch */
  const uint8_t *nibL = ctx->nib + (uint64_t)ctx->idx[hi - 1] * MAX_NIB;
  uint64_t lenL = ctx->nlen[ctx->idx[hi - 1]];
  uint64_t common = 0;
  uint64_t maxc = (len0 < lenL ? len0 : lenL) - depth;
  if (len0 > depth) {
    while (common < maxc && nib0[depth + common] == nibL[depth + common])
      common++;
  }

  if (common > 0) { /* extension */
    uint8_t hp[KEY_CAP + 1];
    uint64_t hplen = hp_encode(nib0 + depth, common, 0, hp);
    plen += rlp_str(hp, hplen, payload + plen);
    uint64_t clen;
    int rc = child_ref(ctx, lo, hi, depth + common, payload + plen, &clen);
    if (rc) return rc;
    plen += clen;
    *olen = rlp_list_wrap(payload, plen, out);
    return 0;
  }

  /* branch: value slot if the first entry's path is exhausted */
  uint64_t vstart = lo;
  const uint8_t *bval = NULL;
  uint64_t bvlen = 0;
  if (len0 == depth) {
    bval = ctx->val + (uint64_t)ctx->idx[lo] * VAL_CAP;
    bvlen = ctx->vlen[ctx->idx[lo]];
    vstart = lo + 1;
  }
  uint64_t pos = vstart;
  for (int nibble = 0; nibble < 16; nibble++) {
    uint64_t start = pos;
    while (pos < hi) {
      const uint8_t *p = ctx->nib + (uint64_t)ctx->idx[pos] * MAX_NIB;
      if (p[depth] != (uint8_t)nibble) break;
      pos++;
    }
    if (pos == start) {
      payload[plen++] = 0x80; /* empty child */
    } else {
      uint64_t clen;
      int rc = child_ref(ctx, start, pos, depth + 1, payload + plen, &clen);
      if (rc) return rc;
      plen += clen;
    }
  }
  if (bval != NULL) {
    plen += rlp_str(bval, bvlen, payload + plen);
  } else {
    payload[plen++] = 0x80;
  }
  if (pos != hi) return 2; /* unsorted input */
  *olen = rlp_list_wrap(payload, plen, out);
  return 0;
}

/* ---- sorting ---- */

/* thread-local: ctypes releases the interpreter lock around the call,
 * so nodes of one process build roots on several threads at once */
static _Thread_local const Ctx *g_sort_ctx;

static int cmp_entries(const void *a, const void *b) {
  uint32_t ia = *(const uint32_t *)a, ib = *(const uint32_t *)b;
  const uint8_t *pa = g_sort_ctx->nib + (uint64_t)ia * MAX_NIB;
  const uint8_t *pb = g_sort_ctx->nib + (uint64_t)ib * MAX_NIB;
  uint64_t la = g_sort_ctx->nlen[ia], lb = g_sort_ctx->nlen[ib];
  uint64_t n = la < lb ? la : lb;
  int c = memcmp(pa, pb, n);
  if (c) return c;
  if (la != lb) return la < lb ? -1 : 1;
  /* equal keys: later original index wins (stable "last update") */
  return ia < ib ? -1 : 1;
}

int gs_mpt_root(const uint8_t *keys, uint64_t key_stride,
                const uint8_t *key_lens, const uint8_t *vals,
                uint64_t val_stride, const uint8_t *val_lens, uint64_t n,
                uint8_t *out32) {
  if (n == 0) {
    uint8_t empty = 0x80; /* rlp(b"") */
    gs_keccak256(&empty, 1, out32);
    return 0;
  }
  uint8_t *nib = malloc(n * MAX_NIB);
  uint8_t *nlen = malloc(n);
  uint8_t *val = malloc(n * VAL_CAP);
  uint8_t *vlen = malloc(n);
  uint32_t *idx = malloc(n * sizeof(uint32_t));
  if (!nib || !nlen || !val || !vlen || !idx) {
    free(nib); free(nlen); free(val); free(vlen); free(idx);
    return 3;
  }
  int rc = 0;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t kl = key_lens[i], vl = val_lens[i];
    if (kl > KEY_CAP || vl > VAL_CAP) {
      rc = 1;
      goto done;
    }
    const uint8_t *k = keys + i * key_stride;
    for (uint64_t j = 0; j < kl; j++) {
      nib[i * MAX_NIB + 2 * j] = k[j] >> 4;
      nib[i * MAX_NIB + 2 * j + 1] = k[j] & 0x0F;
    }
    nlen[i] = (uint8_t)(2 * kl);
    memcpy(val + i * VAL_CAP, vals + i * val_stride, vl);
    vlen[i] = (uint8_t)vl;
    idx[i] = (uint32_t)i;
  }
  Ctx ctx = {nib, nlen, val, vlen, idx};
  g_sort_ctx = &ctx;
  qsort(idx, n, sizeof(uint32_t), cmp_entries);
  /* dedupe equal paths: keep the last (highest original index) */
  uint64_t w = 0;
  for (uint64_t i = 0; i < n; i++) {
    if (w > 0) {
      uint32_t prev = idx[w - 1], cur = idx[i];
      if (nlen[prev] == nlen[cur] &&
          memcmp(nib + (uint64_t)prev * MAX_NIB,
                 nib + (uint64_t)cur * MAX_NIB, nlen[prev]) == 0) {
        idx[w - 1] = cur; /* later update wins */
        continue;
      }
    }
    idx[w++] = idx[i];
  }
  {
    uint8_t buf[NODE_BUF];
    uint64_t blen;
    rc = node_build(&ctx, 0, w, 0, buf, &blen);
    if (rc == 0) gs_keccak256(buf, blen, out32); /* root always hashed */
  }
done:
  free(nib); free(nlen); free(val); free(vlen); free(idx);
  return rc;
}
