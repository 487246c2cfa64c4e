// The comb's tree accumulation (MOCHI_COMB_IMPL=tree) for one signature.
// Counterpart of the reference package's comb.verify_comb_prepared with
// impl="tree" and its _tree_accumulate.
//
// The sum is of 128 window points, as the chain's (comb25519.cuh): the
// signer's 64 rows T[key][w][|h_w|] and the basepoint comb's 64 rows
// B[w][|s_w|], each a Niels entry negated by its digit's sign.  Two orders
// of the same group sum live here:
//
//   * The reference's order (comb_tree_sum_serial, comb_tree_verify_one,
//     the host build's twin of the plain tree): the signer points at
//     [0, 64), the basepoint points at [64, 128), each level of the tree
//     adding point i to point i + P/2, seven levels in all.  Level 1 pairs
//     signer window w with basepoint window w.  The reference converts both
//     to extended form and adds them with the complete addition; here the
//     signer point is converted (comb_tree_leaf) and the basepoint entry
//     joins it by a mixed addition (ge_madd), since a Niels entry is already
//     the addend form of a point with Z = 1 (y+x, y-x, 2dxy = T*2d).  That
//     is 10 multiplies a pair instead of 15, and the same group element.
//     Levels 2-7 are ge_to_cached + ge_add (9 multiplies).
//   * The lane order (comb_tree_sum_lanes, comb_tree.cu's and its twin
//     comb_tree_verify_lanes): LANES lanes share a signature; lane j starts
//     from the identity and mixed-adds both tables' entries of its windows
//     [64 j / LANES, 64 (j + 1) / LANES), each window's signer entry, then
//     its basepoint entry, the digits recoded on the fly (comb_team.cuh's
//     ct_windows, comb.cu's lane sum); then log2(LANES) levels of complete
//     addition fold lane j + off into lane j (off = LANES / 2 ... 1), and
//     lane 0 holds the sum.
//
// The orders give the same point in other limbs (the group law is exact on
// the curve), so the verdicts agree, not the representations: the compare
// is projective.  The lane order is written once over a lane policy LN: on
// the card (tree_warp_lanes) a thread is lane j of its signature's
// MOCHI_TREE_LANES neighbouring lanes of a warp and a level takes the
// partner's point by __shfl_down_sync; on the host (tree_serial_lanes<L>)
// one thread plays a signature's L lanes in turn, so the g++ build in the
// tests runs every piece of the kernel's sum, at either lane count.
//
// Leaf bounds (the reference order).  Entries are canonical (limbs in
// [0, 2^26) / [0, 2^25)) and a negated one swaps y+x and y-x and negates
// 2dxy.  The leaf forms
//   x = (ypx - ymx) / 2,  y = (ypx + ymx) / 2,  t = xy2d / (2d),  z = 1.
// ypx - ymx and xy2d have limbs below 2^26 in magnitude, within LOOSE.
// ypx + ymx reaches 2^27 - 2 on an even limb, over MOCHI_LOOSE_EVEN
// (110729625): fe_mul scales its second operand's limbs by 19 in int32,
// which overflows there.  So the sum is carried to TIGHT first.  The
// outputs are fe_mul outputs, TIGHT, as ge_madd and ge_add require of a
// point.  tests/test_torch_kernel_host.py fuzzes the leaf with every limb
// at 2^26 - 1 / 2^25 - 1, negated and not, and shows that the leaf without
// the carry gets such inputs wrong.  The lane order starts from the
// identity and only ever holds fe_mul outputs; its mixed and complete
// additions are comb.cu's, fuzzed at the TIGHT maximum there.
#pragma once

#include "comb25519.cuh"
#include "comb_team.cuh"  // ct_windows, MOCHI_CT_MEMBER

// Lanes a signature in comb_tree.cu: 4 or 8.  8 measured as fast up to
// 4096 lanes and 30-53% slower from 8192 (PERF.md).
#define MOCHI_TREE_LANES 4
static_assert(MOCHI_TREE_LANES == 4 || MOCHI_TREE_LANES == 8, "4 or 8 lanes a signature");

#define MOCHI_TREE_POINTS 128

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
// level point i with point i + P/2.  The host build's twin of the plain
// tree, limb for limb.
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

// R's decode verdict `ok` AND the projective compare of the sum q with R's
// affine (x, y): 2 multiplies.
MOCHI_HD int comb_tree_compare(const ge_p3* q, const fe* xr, const fe* yr, int ok) {
  fe t;
  fe_mul(&t, xr, &q->Z);
  const int eq_x = fe_eq(&q->X, &t);
  fe_mul(&t, yr, &q->Z);
  const int eq_y = fe_eq(&q->Y, &t);
  return ok & eq_x & eq_y;
}

// The whole tree verify of one signature in the reference's order,
// serially (the host build's twin of the plain tree): 1 valid, 0 not.
// y_r: 17 contiguous limbs of 15 bits; table: `rows` entries; bcomb: the
// 576 entries of the basepoint comb.
MOCHI_HD int comb_tree_verify_one(const int32_t* table, int64_t rows,
                                  int key_idx, const int32_t* y_r, int sign_r,
                                  const uint8_t* s_bytes,
                                  const uint8_t* h_bytes,
                                  const int32_t* bcomb) {
  ge_p3 r;
  const int ok = ge_decode(&r, y_r, 1, sign_r);
  int8_t ds[MOCHI_COMB_WINDOWS], dh[MOCHI_COMB_WINDOWS];
  recode_signed4(ds, s_bytes);
  recode_signed4(dh, h_bytes);
  int32_t entries[MOCHI_TREE_POINTS * MOCHI_COMB_ENTRY_INTS];
  int8_t neg[MOCHI_TREE_POINTS];
  for (int w = 0; w < MOCHI_COMB_WINDOWS; ++w) {
    const int mh = dh[w] < 0 ? -dh[w] : dh[w], ms = ds[w] < 0 ? -ds[w] : ds[w];
    const int32_t* a = table + comb_row(rows, key_idx, w, mh) * MOCHI_COMB_ENTRY_INTS;
    const int32_t* b = bcomb + (w * MOCHI_COMB_ENTRIES + ms) * MOCHI_COMB_ENTRY_INTS;
    for (int k = 0; k < MOCHI_COMB_ENTRY_INTS; ++k) {
      entries[w * MOCHI_COMB_ENTRY_INTS + k] = a[k];
      entries[(w + 64) * MOCHI_COMB_ENTRY_INTS + k] = b[k];
    }
    neg[w] = dh[w] < 0;
    neg[w + 64] = ds[w] < 0;
  }
  ge_p3 q;
  comb_tree_sum_serial(&q, entries, neg);
  return comb_tree_compare(&q, &r.X, &r.Y, ok);
}

// ------------------------------------------------------------ the lane order

// One thread plays a signature's L lanes in turn: the serial twin.
template <int L>
struct tree_serial_lanes {
  static constexpr int N = L, LANES = L;
  MOCHI_CT_MEMBER int lane(int j) const { return j; }
  // o[j] = p[j + off], or p[j] where lane j + off is past the signature's
  // (its sum is never read), as a shuffle within a segment of L lanes gives
  MOCHI_CT_MEMBER void down(ge_p3* o, const ge_p3* p, int off) const {
    for (int j = 0; j < N; ++j) o[j] = p[j + off < N ? j + off : j];
  }
};

// The card's lanes: a thread is lane j of its signature, whose
// MOCHI_TREE_LANES lanes are neighbours in a warp; every lane of the warp
// calls down() together.
struct tree_warp_lanes {
  static constexpr int N = 1, LANES = MOCHI_TREE_LANES;
  int j;
  MOCHI_CT_MEMBER int lane(int) const { return j; }
  MOCHI_CT_MEMBER void down(ge_p3* o, const ge_p3* p, int off) const {
#if defined(__CUDA_ARCH__)
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      o->X.v[k] = __shfl_down_sync(0xffffffffu, p->X.v[k], off, MOCHI_TREE_LANES);
      o->Y.v[k] = __shfl_down_sync(0xffffffffu, p->Y.v[k], off, MOCHI_TREE_LANES);
      o->Z.v[k] = __shfl_down_sync(0xffffffffu, p->Z.v[k], off, MOCHI_TREE_LANES);
      o->T.v[k] = __shfl_down_sync(0xffffffffu, p->T.v[k], off, MOCHI_TREE_LANES);
    }
#endif
  }
};

// A lane's windows as the kernel reads them: signer `key`'s rows for h's
// digits (clipped into the table as comb_row clips) and the basepoint
// comb's for s's, recoded from the bytes on the fly.
struct tree_byte_rows {
  const int32_t* table;
  int64_t rows;
  int key;
  const uint8_t* s_bytes;
  const uint8_t* h_bytes;
  const int32_t* bcomb;
  MOCHI_CT_MEMBER void windows(ge_p3* q, int w0, int w1) const {
    ct_windows(q, w0, w1, table, rows, key, s_bytes, h_bytes, bcomb);
  }
};

// A lane's windows from 128 given entries in the reference's point order
// (leaves [0, 64) the signer's windows, [64, 128) the basepoint's), leaf i
// negated when neg[i]: the tests' form.
struct tree_given_rows {
  const int32_t* entries;
  const int8_t* neg;
  MOCHI_CT_MEMBER void windows(ge_p3* q, int w0, int w1) const {
    ge_identity(q);
    for (int w = w0; w < w1; ++w)
      for (int e = w; e < MOCHI_TREE_POINTS; e += 64) {
        ge_niels n;
        comb_load_niels(&n, entries + e * MOCHI_COMB_ENTRY_INTS, neg[e]);
        ge_madd(q, q, &n);
      }
  }
};

// The 128 window points summed in the lane order (see the header): q gets
// lane 0's sum on the host, the lane's own on the card (lane 0 holds the
// sum).  Each lane makes 128 / LANES mixed additions and log2(LANES)
// complete ones.
template <class LN, class SRC>
MOCHI_HD void comb_tree_sum_lanes(const LN& ln, ge_p3* q, const SRC& src) {
  constexpr int per = MOCHI_COMB_WINDOWS / LN::LANES;
  ge_p3 acc[LN::N];
  for (int j = 0; j < LN::N; ++j) src.windows(&acc[j], ln.lane(j) * per, (ln.lane(j) + 1) * per);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int off = LN::LANES / 2; off >= 1; off >>= 1) {
    ge_p3 other[LN::N];
    ln.down(other, acc, off);
    for (int j = 0; j < LN::N; ++j) comb_tree_add(&acc[j], &acc[j], &other[j]);
  }
  *q = acc[0];
}

// The whole tree verify of one signature in the lane order with L lanes,
// serially (the host build's twin of comb_tree.cu): R's decode, the lanes'
// sum, the compare.  1 valid, 0 not.
template <int L>
MOCHI_HD int comb_tree_verify_lanes(const int32_t* table, int64_t rows, int key_idx,
                                    const int32_t* y_r, int sign_r, const uint8_t* s_bytes,
                                    const uint8_t* h_bytes, const int32_t* bcomb) {
  ge_p3 r, q;
  const int ok = ge_decode(&r, y_r, 1, sign_r);
  const tree_byte_rows src = {table, rows, key_idx, s_bytes, h_bytes, bcomb};
  comb_tree_sum_lanes(tree_serial_lanes<L>(), &q, src);
  return comb_tree_compare(&q, &r.X, &r.Y, ok);
}
