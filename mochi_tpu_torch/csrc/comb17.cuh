// Known-signer comb verify of one signature over the 17 x 15-bit field of
// fe17.cuh.  Counterpart of the reference package's comb chain
// (crypto/comb.py::_verify_comb_jit, impl="chain", :477-509) traced under
// MOCHI_SKEW_IMPL=mxu, where every multiply and squaring is _mul_mxu.
//
// The chain is comb25519.cuh's: Q = sum over the 64 windows of the signer's
// entry [h_w 16^w](-A) and the basepoint's [s_w 16^w]B, each a Niels mixed
// addition (ge_madd), then R's decode and the projective compare.  What
// differs is the field.  Entries are the registry's own 17 x 15-bit rows,
// (y+x | y-x | 2dxy) as 3 x 17 int32 = 204 bytes, read as they are (no
// radix conversion), and fe_mul / fe_sq are fe17.cuh's tensor-core column
// reduction, which every lane of the warp calls together.  So nothing here
// branches on a lane's data around a multiply: the row gather only computes
// an address (loads need no convergence) and a negative digit's negation is
// ge_niels_signed's branchless select.
//
// Two forms.  comb_mxu.cu (and comb_tree_mxu.cu, whose tree loads its rows
// here) defines MOCHI_FE17_TEAM: every multiply is
// fe17_team.cuh's team multiply (four lanes a signature, each running all
// of this code alike), ge_madd hands its multiplies over in pairs
// (ge25519.cuh), and the compare's two go to one fe_mul2, so a signature
// makes 128 x 4 + 275 + 1 = 788 team calls (R's decode stays one multiply
// a call).  Without the define (the g++ SHIM17) it compiles the serial
// multiply, one multiply a call: 1,173 a signature.
//
// Bounds.  Table limbs are canonical, in [0, 2^15).  A negated 2dxy is
// fe_neg's 2p - x after one carry pass, limbs in [0, LOOSE]; fe_mul takes
// limbs in [0, LOOSE], so both kinds of entry are in range, and every
// coordinate of Q is an fe_mul output (<= LOOSE).
// tests/test_torch_kernel_host.py fuzzes ge_madd<fe17> with negated entries
// at the limb maximum against the formula on Python integers.
#pragma once

#include "fe17.cuh"
#include "comb25519.cuh"  // comb_row, MOCHI_COMB_*, MOCHI_LDG, recode_signed4

#define MOCHI_COMB17_ENTRY_INTS 51

// One 17 x 15 table entry -> Niels point, negated when `neg`.
MOCHI_HD void comb17_load_niels(ge_niels_t<fe17>* n, const int32_t* e, int neg) {
  ge_niels_t<fe17> raw;
  for (int i = 0; i < 17; ++i) {
    raw.ypx.v[i] = MOCHI_LDG(&e[i]);
    raw.ymx.v[i] = MOCHI_LDG(&e[17 + i]);
    raw.xy2d.v[i] = MOCHI_LDG(&e[34 + i]);
  }
  ge_niels_signed(n, &raw, neg);
}

// The whole comb verify of one signature: 1 valid, 0 not.  table: `rows`
// entries of 51 int32 (the registry's rows); bcomb: the 576 entries of the
// basepoint comb in the same layout; y_r: 17 contiguous limbs of 15 bits.
// The row index is clipped into the table as comb_row says.
MOCHI_HD int comb17_verify_one(const int32_t* table, int64_t rows, int key_idx,
                               const int32_t* y_r, int sign_r,
                               const uint8_t* s_bytes, const uint8_t* h_bytes,
                               const int32_t* bcomb) {
  int8_t s_dig[64], h_dig[64];
  recode_signed4(s_dig, s_bytes);
  recode_signed4(h_dig, h_bytes);
  ge_p3_t<fe17> q;
  ge_identity(&q);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int w = 0; w < MOCHI_COMB_WINDOWS; ++w) {
    const int dh = h_dig[w], ds = s_dig[w];
    const int mh = dh < 0 ? -dh : dh, ms = ds < 0 ? -ds : ds;
    ge_niels_t<fe17> n;
    comb17_load_niels(&n, table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB17_ENTRY_INTS, dh < 0);
    ge_madd(&q, &q, &n);
    comb17_load_niels(&n, bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB17_ENTRY_INTS, ds < 0);
    ge_madd(&q, &q, &n);
  }
  ge_p3_t<fe17> r;
  const int ok_r = ge_decode(&r, y_r, 1, sign_r);
  fe17 t;
#if defined(MOCHI_FE17_TEAM)
  fe17 u;
  fe_mul2(&t, &r.X, &q.Z, &u, &r.Y, &q.Z);
  const int eq_x = fe_eq(&q.X, &t);
  const int eq_y = fe_eq(&q.Y, &u);
#else
  fe_mul(&t, &r.X, &q.Z);
  const int eq_x = fe_eq(&q.X, &t);
  fe_mul(&t, &r.Y, &q.Z);
  const int eq_y = fe_eq(&q.Y, &t);
#endif
  return ok_r & eq_x & eq_y;
}
