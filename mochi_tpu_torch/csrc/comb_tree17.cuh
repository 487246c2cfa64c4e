// The comb's tree accumulation (MOCHI_COMB_IMPL=tree) for one signature in
// the 17 x 15-bit field of fe17.cuh, whose multiply is the integer
// tensor-core column reduction.  Counterpart of the reference package's
// comb.verify_comb_prepared with impl="tree" and its _tree_accumulate
// (crypto/comb.py:354, :428-472) traced under MOCHI_SKEW_IMPL=mxu, where
// every multiply is crypto/field.py:330 _mul_mxu.
//
// The sum is of comb_tree.cuh's 128 window points: the signer's 64 rows
// T[key][w][|h_w|] and the basepoint comb's 64 rows B[w][|s_w|], each a
// Niels entry negated by its digit's sign.  Entries are the registry's own
// 17 x 15 rows (comb17_load_niels, the branchless negation).  Two orders of
// the same group sum live here:
//
//   * The reference's order (comb_tree17_sum_serial, comb_tree17_verify_one,
//     the host build's twin of the plain tree): level 1 pairs signer window
//     w with basepoint window w as a leaf conversion plus a mixed addition
//     (ge_madd), levels 2-7 add point i to point i + P/2 with the complete
//     addition (ge_to_cached + ge_add).  Its limbs equal the plain tree's
//     under mxu.
//   * The team order (comb_tree17_sum_team, comb_tree_mxu.cu's accumulate
//     pass and its twin comb_tree17_verify_team): MOCHI_TREE17_TEAMS teams
//     of four lanes share a signature; team k starts from the identity and
//     mixed-adds the two entries of each of its windows w = k, k + TEAMS,
//     ..., then log2(TEAMS) levels of complete addition fold team k + off
//     into team k (off = TEAMS / 2 ... 1), and team 0 holds the sum.  The
//     same point; other limbs (the group law is exact on the curve, so the
//     verdicts agree, not the representations).
//
// The team order is written once over a team policy TP: on the card
// (tree17_warp_teams) a thread is a lane of team k of its warp and a level
// takes the partner team's point by __shfl_down_sync; on the host
// (tree17_serial_teams) one thread plays the signature's teams in turn.
// Under MOCHI_FE17_TEAM (comb_tree_mxu.cu, the g++ SHIM17T) every multiply
// is fe17_team.cuh's team multiply and ge_madd / ge_add pair theirs: 4 calls
// a mixed addition, 5 a level (ge_to_cached's one, ge_add's four), 1 for the
// compare.  Nothing here branches on a lane's data around a multiply: a
// window's row only changes an address, and loops run the same count on
// every lane.
//
// Leaf bounds (the reference order).  Entry limbs are canonical, in [0,
// 2^15), and a negated 2dxy is fe_neg's 2p - x, limbs in [0, LOOSE].
// fe17's fe_add and fe_sub carry once (fe17.cuh), so ypx + ymx (limbs <=
// 2^16 - 2 before the carry) and ypx - ymx leave them <= LOOSE, within
// fe_mul's bound: unlike comb_tree.cuh, the leaf needs no carry of its own.
// The outputs are fe_mul outputs (<= LOOSE) and z = 1, as ge_madd and
// ge_add require of a point; the team order starts from the identity and
// only ever holds fe_mul outputs.  tests/test_torch_kernel_host.py fuzzes
// the leaf and the paired ge_add with every limb at the maximum against
// Python integers.
#pragma once

#include "comb17.cuh"
#include "fe17_team.cuh"  // MOCHI_T17_MEMBER

// Teams of four lanes a signature in comb_tree_mxu.cu's accumulate pass: 4
// (two signatures a warp) or 8 (one).  4 measured faster at 2,752 and 8192
// lanes, 8 at small launches (PERF.md).
#define MOCHI_TREE17_TEAMS 4
static_assert(MOCHI_TREE17_TEAMS == 8 || MOCHI_TREE17_TEAMS == 4, "8 or 4 teams a signature");

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

// A tree level: r = p + q with the complete addition (9 multiplies; 5 team
// calls under MOCHI_FE17_TEAM).  r may alias p.
MOCHI_HD void comb_tree17_add(ge_p3_t<fe17>* r, const ge_p3_t<fe17>* p,
                              const ge_p3_t<fe17>* q) {
  ge_cached_t<fe17> c;
  ge_to_cached(&c, q);
  ge_add(r, p, &c);
}

// The tree over 128 leaf entries of 51 int32 (leaf i negated when neg[i]),
// in the reference's order: leaves [0, 64) the signer's windows, [64, 128)
// the basepoint's.  Level 1 pairs leaf w with leaf w + 64, every later
// level point i with point i + P/2.  The host build's twin of the plain
// tree, limb for limb.
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
// affine (x, y) from the record: 2 multiplies (one team call under
// MOCHI_FE17_TEAM).
MOCHI_HD int comb_tree17_finish(const ge_p3_t<fe17>* q, const int32_t* rec) {
  fe17 rx, ry, t, u;
  for (int k = 0; k < 17; ++k) {
    rx.v[k] = rec[k];
    ry.v[k] = rec[17 + k];
  }
#if defined(MOCHI_FE17_TEAM)
  fe_mul2(&t, &rx, &q->Z, &u, &ry, &q->Z);
#else
  fe_mul(&t, &rx, &q->Z);
  fe_mul(&u, &ry, &q->Z);
#endif
  return rec[MOCHI_TREE17_RECORD_OK] & fe_eq(&q->X, &t) & fe_eq(&q->Y, &u);
}

// The whole tree verify of one signature in the reference's order (the
// host build's twin of the plain tree): 1 valid, 0 not.  table: `rows`
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

// ------------------------------------------------------------ the team order

// One thread plays the signature's teams in turn: the serial twin.
struct tree17_serial_teams {
  static constexpr int N = MOCHI_TREE17_TEAMS;
  MOCHI_T17_MEMBER int team(int j) const { return j; }
  // o[j] = p[j + off], or p[j] where team j + off is past the signature's
  // (its sum is never read)
  MOCHI_T17_MEMBER void down(ge_p3_t<fe17>* o, const ge_p3_t<fe17>* p, int off) const {
    for (int j = 0; j < N; ++j) o[j] = p[j + off < N ? j + off : j];
  }
};

// The card's lanes: a thread is a lane of team k of its signature, every
// lane of the warp calls down() together.  A shuffle from past the warp
// returns the lane's own point, and with 4 teams a signature team k + off
// of the warp's first signature may be a team of its second: either way a
// team whose sum is never read.
struct tree17_warp_teams {
  static constexpr int N = 1;
  int k;
  MOCHI_T17_MEMBER int team(int) const { return k; }
  MOCHI_T17_MEMBER void down(ge_p3_t<fe17>* o, const ge_p3_t<fe17>* p, int off) const {
#if defined(__CUDA_ARCH__)
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      o->X.v[i] = __shfl_down_sync(0xffffffffu, p->X.v[i], 4 * off);
      o->Y.v[i] = __shfl_down_sync(0xffffffffu, p->Y.v[i], 4 * off);
      o->Z.v[i] = __shfl_down_sync(0xffffffffu, p->Z.v[i], 4 * off);
      o->T.v[i] = __shfl_down_sync(0xffffffffu, p->T.v[i], 4 * off);
    }
#endif
  }
};

// Window w's two entries as the kernel reads them: signer `key`'s row for
// h's digit (clipped into the table as comb_row clips) and the basepoint
// comb's row for s's digit, from the prepare pass's record digits.
struct tree17_digit_rows {
  const int32_t* table;
  int64_t rows;
  int key;
  const int32_t* bcomb;
  const int8_t* dig;  // the record's 64 s digits, then the 64 h digits
  // half 0: the signer's entry, half 1: the basepoint's; *neg its sign
  MOCHI_T17_MEMBER const int32_t* entry(int w, int half, int* neg) const {
    const int d = half ? dig[w] : dig[64 + w];
    const int m = d < 0 ? -d : d;
    *neg = d < 0;
    return half ? bcomb + (w * MOCHI_COMB_ENTRIES + m) * MOCHI_COMB17_ENTRY_INTS
                : table + comb_row(rows, key, w, m) * MOCHI_COMB17_ENTRY_INTS;
  }
};

// Window w's two entries from 128 given ones in the reference's point order
// (leaves [0, 64) the signer's windows, [64, 128) the basepoint's), leaf i
// negated when neg[i]: the tests' form.
struct tree17_given_rows {
  const int32_t* entries;
  const int8_t* neg;
  MOCHI_T17_MEMBER const int32_t* entry(int w, int half, int* ng) const {
    *ng = neg[w + 64 * half];
    return entries + (w + 64 * half) * MOCHI_COMB17_ENTRY_INTS;
  }
};

// The 128 window points summed in the team order (see the header): q gets
// team 0's sum on the host, the lane's own team's on the card (team 0's
// lanes hold the sum).  Each team makes 2 x 64 / TEAMS mixed additions and
// log2(TEAMS) complete ones.
template <class TP, class SRC>
MOCHI_HD void comb_tree17_sum_team(const TP& tp, ge_p3_t<fe17>* q, const SRC& src) {
  ge_p3_t<fe17> acc[TP::N];
  for (int j = 0; j < TP::N; ++j) ge_identity(&acc[j]);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int i = 0; i < MOCHI_COMB_WINDOWS / MOCHI_TREE17_TEAMS; ++i)
    for (int j = 0; j < TP::N; ++j) {
      const int w = tp.team(j) + MOCHI_TREE17_TEAMS * i;
      for (int half = 0; half < 2; ++half) {
        int neg;
        const int32_t* e = src.entry(w, half, &neg);
        ge_niels_t<fe17> n;
        comb17_load_niels(&n, e, neg);
        ge_madd(&acc[j], &acc[j], &n);
      }
    }
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int off = MOCHI_TREE17_TEAMS / 2; off >= 1; off >>= 1) {
    ge_p3_t<fe17> other[TP::N];
    tp.down(other, acc, off);
    for (int j = 0; j < TP::N; ++j) comb_tree17_add(&acc[j], &acc[j], &other[j]);
  }
  *q = acc[0];
}

// The accumulate pass of one signature from its prepare record `rec`: the
// team-order sum and the compare, 1 valid, 0 not (team 0's lanes hold the
// verdict on the card).  table: `rows` entries of 51 int32; bcomb: the 576
// entries of the basepoint comb in the same layout.
template <class TP>
MOCHI_HD int comb_tree17_accumulate(const TP& tp, const int32_t* table, int64_t rows, int key,
                                    const int32_t* bcomb, const int32_t* rec) {
  const tree17_digit_rows src = {table, rows, key, bcomb,
                                 (const int8_t*)(rec + MOCHI_TREE17_RECORD_DIGITS)};
  ge_p3_t<fe17> q;
  comb_tree17_sum_team(tp, &q, src);
  return comb_tree17_finish(&q, rec);
}

// The whole tree verify of one signature in the team order, serially (the
// host build's twin of comb_tree_mxu.cu's two passes): 1 valid, 0 not.
MOCHI_HD int comb_tree17_verify_team(const int32_t* table, int64_t rows, int key_idx,
                                     const int32_t* y_r, int sign_r, const uint8_t* s_bytes,
                                     const uint8_t* h_bytes, const int32_t* bcomb) {
  int32_t rec[MOCHI_TREE17_RECORD_INTS];
  comb_tree17_prepare(rec, y_r, sign_r, s_bytes, h_bytes);
  return comb_tree17_accumulate(tree17_serial_teams(), table, rows, key_idx, bcomb, rec);
}
