// The comb's tree accumulation (MOCHI_COMB_IMPL=tree) for one signature in
// the 17 x 15-bit field of fe17.cuh, whose multiply is the integer
// tensor-core column reduction.  Counterpart of the reference package's
// comb.verify_comb_prepared with impl="tree" and its _tree_accumulate
// (crypto/comb.py:354, :428-472) traced under MOCHI_SKEW_IMPL=mxu, where
// every multiply is crypto/field.py:330 _mul_mxu.
//
// The tree is comb_tree.cuh's: the same 128 window points (the signer's 64
// rows T[key][w][|h_w|] and the basepoint comb's 64 rows B[w][|s_w|], each a
// Niels entry negated by its digit's sign), level 1 pairing signer window w
// with basepoint window w as a leaf conversion plus a mixed addition
// (ge_madd), levels 2-7 adding point i to point i + P/2 with the complete
// addition (ge_to_cached + ge_add).  What differs is the field: entries are
// the registry's own 17 x 15 rows (comb17_load_niels, the branchless
// negation), and fe_mul is the warp-wide tensor-core multiply on the card,
// so nothing here branches on a lane's data around a multiply.
//
// Leaf bounds.  Entry limbs are canonical, in [0, 2^15), and a negated
// 2dxy is fe_neg's 2p - x, limbs in [0, LOOSE].  fe17's fe_add and fe_sub
// carry once (fe17.cuh), so ypx + ymx (limbs <= 2^16 - 2 before the carry)
// and ypx - ymx leave them <= LOOSE, within fe_mul's bound: unlike
// comb_tree.cuh, the leaf needs no carry of its own.  The outputs are
// fe_mul outputs (<= LOOSE) and z = 1, as ge_madd and ge_add require of a
// point.  tests/test_torch_kernel_host.py fuzzes the leaf with every entry
// limb at 2^15 - 1, negated and not, against Python integers.
#pragma once

#include "comb17.cuh"

#define MOCHI_TREE17_POINTS 128
// Per-signature record the prepare pass writes for the accumulate pass:
// R's affine x and y (17 limbs each), R's decode verdict, then the 64 s
// digits and the 64 h digits as int8 (32 int32 words).
#define MOCHI_TREE17_RECORD_INTS 67
#define MOCHI_TREE17_RECORD_OK 34
#define MOCHI_TREE17_RECORD_DIGITS 35

// (p + 1) / 2 and 1 / (2d) mod p, canonical.
MOCHI_HD void fe17_const_inv2(fe17* h) {
  for (int i = 0; i < 17; ++i) h->v[i] = 32767;
  h->v[0] = 32759;
  h->v[16] = 16383;
}

MOCHI_HD void fe17_const_inv2d(fe17* h) {
  const int32_t c[17] = {31768, 19913, 25837, 6019,  8561,  10133,
                         21256, 22389, 13061, 14799, 10651, 22660,
                         6488,  23780, 17050, 8116,  24648};
  for (int i = 0; i < 17; ++i) h->v[i] = c[i];
}

// One 17 x 15 table entry (negated when `neg`) -> the extended point
// (x, y, 1, xy): 3 multiplies (see the leaf bounds above).
MOCHI_HD void comb_tree17_leaf(ge_p3_t<fe17>* r, const int32_t* e, int neg) {
  ge_niels_t<fe17> n;
  comb17_load_niels(&n, e, neg);
  fe17 c, t;
  fe17_const_inv2(&c);
  fe_sub(&t, &n.ypx, &n.ymx);
  fe_mul(&r->X, &t, &c);
  fe_add(&t, &n.ypx, &n.ymx);
  fe_mul(&r->Y, &t, &c);
  fe17_const_inv2d(&c);
  fe_mul(&r->T, &n.xy2d, &c);
  fe_1(&r->Z);
}

// Level 1: signer entry + basepoint entry (10 multiplies).
MOCHI_HD void comb_tree17_pair(ge_p3_t<fe17>* r, const int32_t* s_entry, int s_neg,
                               const int32_t* b_entry, int b_neg) {
  ge_niels_t<fe17> n;
  comb_tree17_leaf(r, s_entry, s_neg);
  comb17_load_niels(&n, b_entry, b_neg);
  ge_madd(r, r, &n);
}

// Level 1 for window w of one signature: signer `key_idx`'s row for the
// digit dh (clipped into the table as comb_row clips) and the basepoint
// comb's row for the digit ds.
MOCHI_HD void comb_tree17_window(ge_p3_t<fe17>* r, const int32_t* table, int64_t rows,
                                 int key_idx, const int32_t* bcomb, int w, int dh,
                                 int ds) {
  const int mh = dh < 0 ? -dh : dh, ms = ds < 0 ? -ds : ds;
  comb_tree17_pair(r, table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB17_ENTRY_INTS,
                   dh < 0,
                   bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB17_ENTRY_INTS,
                   ds < 0);
}

// Levels 2-7: r = p + q with the complete addition (9 multiplies).  r may
// alias p.
MOCHI_HD void comb_tree17_add(ge_p3_t<fe17>* r, const ge_p3_t<fe17>* p,
                              const ge_p3_t<fe17>* q) {
  ge_cached_t<fe17> c;
  ge_to_cached(&c, q);
  ge_add(r, p, &c);
}

// The tree over 128 leaf entries of 51 int32 (leaf i negated when neg[i]),
// in the reference's order: leaves [0, 64) the signer's windows, [64, 128)
// the basepoint's.  Level 1 pairs leaf w with leaf w + 64, every later
// level point i with point i + P/2: the pairing comb_tree_mxu.cu runs
// across the 32 lanes of a warp.  This serial form is the host build's.
MOCHI_HD void comb_tree17_sum_serial(ge_p3_t<fe17>* q, const int32_t* entries,
                                     const int8_t* neg) {
  ge_p3_t<fe17> pts[MOCHI_TREE17_POINTS / 2];
  for (int w = 0; w < MOCHI_TREE17_POINTS / 2; ++w)
    comb_tree17_pair(&pts[w], entries + w * MOCHI_COMB17_ENTRY_INTS, neg[w],
                     entries + (w + 64) * MOCHI_COMB17_ENTRY_INTS, neg[w + 64]);
  for (int half = MOCHI_TREE17_POINTS / 4; half >= 1; half >>= 1)
    for (int i = 0; i < half; ++i) comb_tree17_add(&pts[i], &pts[i], &pts[i + half]);
  *q = pts[0];
}

// The prepare pass of one signature: R's RFC 8032 decode (ge_decode over
// fe17: 275 multiplies) and both scalars' signed recoding, into the
// MOCHI_TREE17_RECORD_INTS record `rec`.
MOCHI_HD void comb_tree17_prepare(int32_t* rec, const int32_t* y_r, int sign_r,
                                  const uint8_t* s_bytes, const uint8_t* h_bytes) {
  ge_p3_t<fe17> r;
  const int ok = ge_decode(&r, y_r, 1, sign_r);
  for (int k = 0; k < 17; ++k) {
    rec[k] = r.X.v[k];
    rec[17 + k] = r.Y.v[k];
  }
  rec[MOCHI_TREE17_RECORD_OK] = ok;
  int8_t* dig = (int8_t*)(rec + MOCHI_TREE17_RECORD_DIGITS);
  recode_signed4(dig, s_bytes);
  recode_signed4(dig + 64, h_bytes);
}

// R's decode verdict AND the projective compare of the sum q with R's
// affine (x, y) from the record: 2 multiplies.
MOCHI_HD int comb_tree17_finish(const ge_p3_t<fe17>* q, const int32_t* rec) {
  fe17 rx, ry, t;
  for (int k = 0; k < 17; ++k) {
    rx.v[k] = rec[k];
    ry.v[k] = rec[17 + k];
  }
  fe_mul(&t, &rx, &q->Z);
  const int eq_x = fe_eq(&q->X, &t);
  fe_mul(&t, &ry, &q->Z);
  const int eq_y = fe_eq(&q->Y, &t);
  return rec[MOCHI_TREE17_RECORD_OK] & eq_x & eq_y;
}

// The whole tree verify of one signature, serially (the host build's
// counterpart of the two kernel passes): 1 valid, 0 not.  table: `rows`
// entries of 51 int32 (the registry's rows); bcomb: the 576 entries of the
// basepoint comb in the same layout.
MOCHI_HD int comb_tree17_verify_one(const int32_t* table, int64_t rows, int key_idx,
                                    const int32_t* y_r, int sign_r,
                                    const uint8_t* s_bytes, const uint8_t* h_bytes,
                                    const int32_t* bcomb) {
  int32_t rec[MOCHI_TREE17_RECORD_INTS];
  comb_tree17_prepare(rec, y_r, sign_r, s_bytes, h_bytes);
  const int8_t* dig = (const int8_t*)(rec + MOCHI_TREE17_RECORD_DIGITS);
  int32_t entries[MOCHI_TREE17_POINTS * MOCHI_COMB17_ENTRY_INTS];
  int8_t neg[MOCHI_TREE17_POINTS];
  for (int w = 0; w < MOCHI_COMB_WINDOWS; ++w) {
    const int dh = dig[64 + w], ds = dig[w];
    const int mh = dh < 0 ? -dh : dh, ms = ds < 0 ? -ds : ds;
    const int32_t* a = table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB17_ENTRY_INTS;
    const int32_t* b = bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB17_ENTRY_INTS;
    for (int k = 0; k < MOCHI_COMB17_ENTRY_INTS; ++k) {
      entries[w * MOCHI_COMB17_ENTRY_INTS + k] = a[k];
      entries[(w + 64) * MOCHI_COMB17_ENTRY_INTS + k] = b[k];
    }
    neg[w] = dh < 0;
    neg[w + 64] = ds < 0;
  }
  ge_p3_t<fe17> q;
  comb_tree17_sum_serial(&q, entries, neg);
  return comb_tree17_finish(&q, rec);
}
