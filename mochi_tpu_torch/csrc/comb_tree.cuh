// The comb's tree accumulation (MOCHI_COMB_IMPL=tree) for one signature.
// Counterpart of the reference package's comb.verify_comb_prepared with
// impl="tree" and its _tree_accumulate.
//
// The same 128 window points as the chain (comb25519.cuh): the signer's
// 64 rows T[key][w][|h_w|] and the basepoint comb's 64 rows B[w][|s_w|],
// each a Niels entry negated by its digit's sign.  In the reference's point
// order (signer windows at [0, 64), basepoint windows at [64, 128)), each
// level of the tree adds point i to point i + P/2, seven levels in all.
//
// Level 1 pairs signer window w with basepoint window w.  The reference
// converts both to extended form and adds them with the complete addition;
// here the signer point is converted (comb_tree_leaf) and the basepoint
// entry joins it by a mixed addition (ge_madd), since a Niels entry is
// already the addend form of a point with Z = 1 (y+x, y-x, 2dxy = T*2d).
// That is 10 multiplies a pair instead of 15, and the same group element:
// verdicts are equal, representations differ (the compare is projective).
// Levels 2-7 are ge_to_cached + ge_add (9 multiplies).
//
// Leaf bounds.  Entries are canonical (limbs in [0, 2^26) / [0, 2^25)) and
// a negated one swaps y+x and y-x and negates 2dxy.  The leaf forms
//   x = (ypx - ymx) / 2,  y = (ypx + ymx) / 2,  t = xy2d / (2d),  z = 1.
// ypx - ymx and xy2d have limbs below 2^26 in magnitude, within LOOSE.
// ypx + ymx reaches 2^27 - 2 on an even limb, over MOCHI_LOOSE_EVEN
// (110729625): fe_mul scales its second operand's limbs by 19 in int32,
// which overflows there.  So the sum is carried to TIGHT first.  The
// outputs are fe_mul outputs, TIGHT, as ge_madd and ge_add require of a
// point.  tests/test_torch_kernel_host.py fuzzes the leaf with every limb
// at 2^26 - 1 / 2^25 - 1, negated and not, and shows that the leaf without
// the carry gets such inputs wrong.
#pragma once

#include "comb25519.cuh"

#define MOCHI_TREE_POINTS 128
// Per-signature record the prepare pass writes for the accumulate pass:
// R's affine x and y (10 limbs each), R's decode verdict, then the 64 s
// digits and the 64 h digits as int8 (32 int32 words).
#define MOCHI_TREE_SCRATCH_INTS 53
#define MOCHI_TREE_SCRATCH_OK 20
#define MOCHI_TREE_SCRATCH_DIGITS 21

// (p + 1) / 2 and 1 / (2d) mod p, canonical.
MOCHI_HD void fe_const_inv2(fe* h) {
  const int32_t c[10] = {67108855, 33554431, 67108863, 33554431, 67108863,
                         33554431, 67108863, 33554431, 67108863, 16777215};
  for (int i = 0; i < 10; ++i) h->v[i] = c[i];
}

MOCHI_HD void fe_const_inv2d(fe* h) {
  const int32_t c[10] = {48561176, 1986265,  21160542, 6359525,  1489837,
                         14477235, 25707827, 14955185, 43034286, 25239805};
  for (int i = 0; i < 10; ++i) h->v[i] = c[i];
}

// One table entry (negated when `neg`) -> the extended point (x, y, 1, xy):
// 3 multiplies (see the leaf bounds above).
MOCHI_HD void comb_tree_leaf(ge_p3* r, const int32_t* e, int neg) {
  ge_niels n;
  comb_load_niels(&n, e, neg);
  fe c, t, u;
  fe_const_inv2(&c);
  fe_sub(&t, &n.ypx, &n.ymx);
  fe_mul(&r->X, &c, &t);
  fe_add(&t, &n.ypx, &n.ymx);
  fe_carry(&u, &t);
  fe_mul(&r->Y, &c, &u);
  fe_const_inv2d(&c);
  fe_mul(&r->T, &c, &n.xy2d);
  fe_1(&r->Z);
}

// Level 1: signer entry + basepoint entry (10 multiplies).
MOCHI_HD void comb_tree_pair(ge_p3* r, const int32_t* s_entry, int s_neg,
                             const int32_t* b_entry, int b_neg) {
  ge_niels n;
  comb_tree_leaf(r, s_entry, s_neg);
  comb_load_niels(&n, b_entry, b_neg);
  ge_madd(r, r, &n);
}

// Level 1 for window w of one signature: signer `key_idx`'s row for the
// digit dh (clipped into the table as comb_row clips) and the basepoint
// comb's row for the digit ds.
MOCHI_HD void comb_tree_window(ge_p3* r, const int32_t* table, int64_t rows,
                               int key_idx, const int32_t* bcomb, int w,
                               int dh, int ds) {
  const int mh = dh < 0 ? -dh : dh, ms = ds < 0 ? -ds : ds;
  comb_tree_pair(r,
                 table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB_ENTRY_INTS,
                 dh < 0,
                 bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB_ENTRY_INTS,
                 ds < 0);
}

// Levels 2-7: r = p + q with the complete addition (9 multiplies).  r may
// alias p.
MOCHI_HD void comb_tree_add(ge_p3* r, const ge_p3* p, const ge_p3* q) {
  ge_cached c;
  ge_to_cached(&c, q);
  ge_add(r, p, &c);
}

// The tree over 128 leaf entries of 30 int32 (leaf i negated when neg[i]),
// in the reference's order: leaves [0, 64) the signer's windows, [64, 128)
// the basepoint's.  Level 1 pairs leaf w with leaf w + 64, every later
// level point i with point i + P/2.  The kernel (comb_tree.cu) runs the same
// pairing across the 32 lanes of a warp, so both give the same limbs; this
// serial form is the host build's.
MOCHI_HD void comb_tree_sum_serial(ge_p3* q, const int32_t* entries,
                                   const int8_t* neg) {
  ge_p3 pts[MOCHI_TREE_POINTS / 2];
  for (int w = 0; w < MOCHI_TREE_POINTS / 2; ++w)
    comb_tree_pair(&pts[w], entries + w * MOCHI_COMB_ENTRY_INTS, neg[w],
                   entries + (w + 64) * MOCHI_COMB_ENTRY_INTS, neg[w + 64]);
  for (int half = MOCHI_TREE_POINTS / 4; half >= 1; half >>= 1)
    for (int i = 0; i < half; ++i) comb_tree_add(&pts[i], &pts[i], &pts[i + half]);
  *q = pts[0];
}

// The prepare pass of one signature: R's RFC 8032 decode and both scalars'
// signed recoding, into the MOCHI_TREE_SCRATCH_INTS record `rec`.
MOCHI_HD void comb_tree_prepare(int32_t* rec, const int32_t* y_r, int sign_r,
                                const uint8_t* s_bytes,
                                const uint8_t* h_bytes) {
  ge_p3 r;
  const int ok = ge_decode(&r, y_r, 1, sign_r);
  for (int k = 0; k < 10; ++k) {
    rec[k] = r.X.v[k];
    rec[10 + k] = r.Y.v[k];
  }
  rec[MOCHI_TREE_SCRATCH_OK] = ok;
  int8_t* dig = (int8_t*)(rec + MOCHI_TREE_SCRATCH_DIGITS);
  recode_signed4(dig, s_bytes);
  recode_signed4(dig + 64, h_bytes);
}

// R's decode verdict AND the projective compare of the sum q with R's
// affine (x, y) from the record: 2 multiplies.
MOCHI_HD int comb_tree_finish(const ge_p3* q, const int32_t* rec) {
  fe rx, ry, t;
  for (int k = 0; k < 10; ++k) {
    rx.v[k] = rec[k];
    ry.v[k] = rec[10 + k];
  }
  fe_mul(&t, &rx, &q->Z);
  const int eq_x = fe_eq(&q->X, &t);
  fe_mul(&t, &ry, &q->Z);
  const int eq_y = fe_eq(&q->Y, &t);
  return rec[MOCHI_TREE_SCRATCH_OK] & eq_x & eq_y;
}

// The whole tree verify of one signature, serially (the host build's
// counterpart of the two kernel passes): 1 valid, 0 not.
MOCHI_HD int comb_tree_verify_one(const int32_t* table, int64_t rows,
                                  int key_idx, const int32_t* y_r, int sign_r,
                                  const uint8_t* s_bytes,
                                  const uint8_t* h_bytes,
                                  const int32_t* bcomb) {
  int32_t rec[MOCHI_TREE_SCRATCH_INTS];
  comb_tree_prepare(rec, y_r, sign_r, s_bytes, h_bytes);
  const int8_t* dig = (const int8_t*)(rec + MOCHI_TREE_SCRATCH_DIGITS);
  int32_t entries[MOCHI_TREE_POINTS * MOCHI_COMB_ENTRY_INTS];
  int8_t neg[MOCHI_TREE_POINTS];
  for (int w = 0; w < MOCHI_COMB_WINDOWS; ++w) {
    const int dh = dig[64 + w], ds = dig[w];
    const int mh = dh < 0 ? -dh : dh, ms = ds < 0 ? -ds : ds;
    const int32_t* a = table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB_ENTRY_INTS;
    const int32_t* b = bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB_ENTRY_INTS;
    for (int k = 0; k < MOCHI_COMB_ENTRY_INTS; ++k) {
      entries[w * MOCHI_COMB_ENTRY_INTS + k] = a[k];
      entries[(w + 64) * MOCHI_COMB_ENTRY_INTS + k] = b[k];
    }
    neg[w] = dh < 0;
    neg[w + 64] = ds < 0;
  }
  ge_p3 q;
  comb_tree_sum_serial(&q, entries, neg);
  return comb_tree_finish(&q, rec);
}
