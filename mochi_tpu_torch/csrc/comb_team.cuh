// Known-signer comb verify of one signature by a team of lanes: the
// arithmetic of comb.cu.  Counterpart of the reference package's
// comb.verify_comb_prepared (impl="chain"): the same verdict for every
// input, computed as
//
//   Q = sum_w  [s_w 16^w]B  +  [h_w 16^w](-A)        w = 0..63
//
// with both terms read from precomputed Niels tables (the signer's rows
// from the registry's table, the basepoint's from the constant comb:
// comb25519.cuh's layout), then R's RFC 8032 decode and the projective
// compare X_Q == x_R Z_Q, Y_Q == y_R Z_Q.
//
// Why a team.  Done by one thread, the verify is one chain of 1,173 field
// operations (128 mixed additions of 7 multiplies, R's decode of 274
// operations, the compare's 2), so a small launch runs one warp a scheduler
// on few SMs.  None of it needs to be serial: both tables are fixed-base,
// so the 128 additions are independent terms of one sum, and R's decode
// does not depend on Q.  Here MOCHI_CT_TEAM lanes share a signature:
//
//   1. Lane r sums its windows [ct_first(r), ct_first(r + 1)) of both tables
//      into a partial point (2 mixed additions a window, its digits recoded
//      on the fly, the carry into its first window from the windows below)
//      and stores it whole in the team's scratch.  The last lane first
//      decodes R and stores x_R, y_R and the decode's verdict; it takes
//      MOCHI_CT_DECODE_WINDOWS windows, the others share the rest, so that
//      every lane does about the same work.
//   2. The team adds the partial points by a tree (ge_to_cached + ge_add:
//      level k adds partial r + 2^k into partial r), then lane 0 compares
//      the sum with R.
//
// On the card (comb.cu) a lane's role is its warp: a block is one warp per
// role, and lane l of every warp works on the block's signature l.  A
// role's code then runs whole warps and no warp diverges (diverged lanes of
// one warp run in turn, so a decoder lane beside adder lanes in one warp
// would cost the warp both).  The decode is the one chain that cannot be
// split (274 dependent operations) and sets the floor of a small launch;
// its lane takes fewer windows so that it ends about when the others do.
// Nothing is computed twice.
//
// Bounds (fe25519.cuh): every point coordinate is TIGHT (an fe_mul output
// or a constant); a table coordinate entering fe_mul is canonical or
// negated canonical, within LOOSE (comb25519.cuh); a team addition's
// operands are the sums ge_to_cached and ge_add form (at most three TIGHT
// terms).  tests/test_torch_kernel_host.py fuzzes the partial sums and the
// team's sum against Python integers at those maxima.
//
// The twin.  The verify is written once, over a lane policy LN: on the card
// (ct_block_lanes, comb.cu) each thread plays one role and sync() is the
// block's barrier; on the host (ct_serial_lanes) one thread plays every
// role in turn and sync() does nothing.  So the g++ build in the tests runs
// every team piece of the kernel's source.
#pragma once

#include "comb25519.cuh"

// Lanes a signature, and the windows of the last one, which also decodes
// R.  PERF.md has the choices measured.
#define MOCHI_CT_TEAM 4
#define MOCHI_CT_DECODE_WINDOWS 7

// A member function for both compilers (MOCHI_HD is `static` on the host).
#if defined(__CUDACC__)
#define MOCHI_CT_MEMBER __host__ __device__ __forceinline__
#else
#define MOCHI_CT_MEMBER inline
#endif

// One signature's scratch: 40 MOCHI_CT_TEAM + 21 int32 words (odd, so
// that the 32 signatures of a block read a given word from 32 different
// banks).
struct ct_area {
  int32_t part[MOCHI_CT_TEAM][4][10];  // each lane's partial X, Y, Z, T
  int32_t rpt[2][10];                  // x_R, y_R
  int32_t ok;                          // the decode's verdict
};

// One thread plays every role: the serial twin.
struct ct_serial_lanes {
  static constexpr int N = MOCHI_CT_TEAM;
  MOCHI_CT_MEMBER int role(int j) const { return j; }
  MOCHI_CT_MEMBER void sync() const {}
};

// The kernel's lanes: role r is warp r of the block; every thread of the
// block calls every sync() together.
struct ct_block_lanes {
  static constexpr int N = 1;
  int r;
  MOCHI_CT_MEMBER int role(int) const { return r; }
  MOCHI_CT_MEMBER void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};

MOCHI_HD void ct_store(int32_t (*p)[10], const ge_p3* q) {
  for (int i = 0; i < 10; ++i) {
    p[0][i] = q->X.v[i];
    p[1][i] = q->Y.v[i];
    p[2][i] = q->Z.v[i];
    p[3][i] = q->T.v[i];
  }
}

MOCHI_HD void ct_load(ge_p3* q, const int32_t (*p)[10]) {
  for (int i = 0; i < 10; ++i) {
    q->X.v[i] = p[0][i];
    q->Y.v[i] = p[1][i];
    q->Z.v[i] = p[2][i];
    q->T.v[i] = p[3][i];
  }
}

// The signed digit of window w of 32 little-endian bytes, `*c` the carry
// into it (updated): one step of recode_signed4.
MOCHI_HD int ct_digit(const uint8_t* bytes, int w, int* c) {
  const int nib = (MOCHI_LDG(&bytes[w >> 1]) >> ((w & 1) * 4)) & 15;
  const int t = nib + *c;
  *c = t > 8;
  return t - 16 * *c;
}

// First window of lane r (r <= MOCHI_CT_TEAM): the last lane's
// MOCHI_CT_DECODE_WINDOWS at the top, the rest split evenly below.
MOCHI_HD int ct_first(int r) {
  const int shared = MOCHI_COMB_WINDOWS - MOCHI_CT_DECODE_WINDOWS;
  return r < MOCHI_CT_TEAM ? r * shared / (MOCHI_CT_TEAM - 1) : MOCHI_COMB_WINDOWS;
}

// The sum of windows [w0, w1) of the signer's rows (row index clipped by
// comb_row) and of the basepoint comb, from the identity: each window's
// signer entry, then its basepoint entry, by ge_madd.  The digits are
// recoded on the fly, the carry into window w0 from the windows below.
// comb_tree.cuh's lanes sum their windows with it too.
MOCHI_HD void ct_windows(ge_p3* q, int w0, int w1, const int32_t* table, int64_t rows, int key_idx,
                         const uint8_t* s_bytes, const uint8_t* h_bytes, const int32_t* bcomb) {
  int cs = 0, ch = 0;
  for (int w = 0; w < w0; ++w) {
    ct_digit(s_bytes, w, &cs);
    ct_digit(h_bytes, w, &ch);
  }
  ge_identity(q);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int w = w0; w < w1; ++w) {
    const int dh = ct_digit(h_bytes, w, &ch), ds = ct_digit(s_bytes, w, &cs);
    const int mh = dh < 0 ? -dh : dh, ms = ds < 0 ? -ds : ds;
    ge_niels n;
    comb_load_niels(&n, table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB_ENTRY_INTS, dh < 0);
    ge_madd(q, q, &n);
    comb_load_niels(&n, bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB_ENTRY_INTS, ds < 0);
    ge_madd(q, q, &n);
  }
}

// Lane r's partial sum: windows [ct_first(r), ct_first(r + 1)).
MOCHI_HD void ct_partial(ge_p3* q, int r, const int32_t* table, int64_t rows, int key_idx,
                         const uint8_t* s_bytes, const uint8_t* h_bytes, const int32_t* bcomb) {
  ct_windows(q, ct_first(r), ct_first(r + 1), table, rows, key_idx, s_bytes, h_bytes, bcomb);
}

// Step 1: R's decode on the last lane, then every lane's partial sum, into
// the scratch.
template <class LN>
MOCHI_HD void ct_terms(const LN& ln, ct_area* a, const int32_t* table, int64_t rows, int key_idx,
                       const int32_t* y_r, int sign_r, const uint8_t* s_bytes, const uint8_t* h_bytes,
                       const int32_t* bcomb) {
  for (int j = 0; j < LN::N; ++j) {
    const int r = ln.role(j);
    ge_p3 p;
    if (r == MOCHI_CT_TEAM - 1) {
      a->ok = ge_decode(&p, y_r, 1, sign_r);
      for (int i = 0; i < 10; ++i) {
        a->rpt[0][i] = p.X.v[i];
        a->rpt[1][i] = p.Y.v[i];
      }
    }
    ct_partial(&p, r, table, rows, key_idx, s_bytes, h_bytes, bcomb);
    ct_store(a->part[r], &p);
  }
}

// Step 2's sum: partial 0 becomes the sum of all the partials, a tree of
// ge_add (level k: partial r + 2^k into partial r, for r a multiple of
// 2^(k+1)).  Needs ct_terms and a sync() first.
template <class LN>
MOCHI_HD void ct_sum(const LN& ln, ct_area* a) {
  for (int step = 1; step < MOCHI_CT_TEAM; step *= 2) {
    for (int j = 0; j < LN::N; ++j) {
      const int r = ln.role(j);
      if (r % (2 * step) == 0 && r + step < MOCHI_CT_TEAM) {
        ge_p3 p, q;
        ge_cached c;
        ct_load(&p, a->part[r]);
        ct_load(&q, a->part[r + step]);
        ge_to_cached(&c, &q);
        ge_add(&p, &p, &c);
        ct_store(a->part[r], &p);
      }
    }
    ln.sync();
  }
}

// The whole comb verify of one signature: 1 valid, 0 not, as role 0 sees it
// (the other roles return 0).  y_r: 17 contiguous limbs of 15 bits; table:
// `rows` entries; bcomb: the 576 entries of the basepoint comb.
template <class LN>
MOCHI_HD int ct_verify(const LN& ln, ct_area* a, const int32_t* table, int64_t rows, int key_idx,
                       const int32_t* y_r, int sign_r, const uint8_t* s_bytes, const uint8_t* h_bytes,
                       const int32_t* bcomb) {
  ct_terms(ln, a, table, rows, key_idx, y_r, sign_r, s_bytes, h_bytes, bcomb);
  ln.sync();
  ct_sum(ln, a);
  int ok = 0;
  for (int j = 0; j < LN::N; ++j) {
    if (ln.role(j) != 0) continue;
    ge_p3 q;
    fe xr, yr, t;
    ct_load(&q, a->part[0]);
    for (int i = 0; i < 10; ++i) {
      xr.v[i] = a->rpt[0][i];
      yr.v[i] = a->rpt[1][i];
    }
    fe_mul(&t, &xr, &q.Z);
    const int eq_x = fe_eq(&q.X, &t);
    fe_mul(&t, &yr, &q.Z);
    const int eq_y = fe_eq(&q.Y, &t);
    ok = a->ok & eq_x & eq_y;
  }
  return ok;
}
