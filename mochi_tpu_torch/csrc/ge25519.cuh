// Ed25519 group operations and the cofactorless verify of one signature,
// for one thread.  Counterpart of the reference package's curve.verify_core
// (the body of its Pallas kernel, crypto/pallas_verify.py::_kernel).
//
// Points are extended twisted-Edwards coordinates (X:Y:Z:T), x = X/Z,
// y = Y/Z, T = XY/Z, with the complete a = -1 addition law (add-2008-hwcd-3,
// dbl-2008-hwcd, madd-2008-hwcd-3), so no input needs a special case.
// Every coordinate of a ge_p3 is TIGHT (fe25519.cuh); each formula keeps
// multiply inputs within three TIGHT terms, carrying where it would not.
//
// Semantics match the reference exactly, in the group (representations may
// differ, verdicts may not):
//   * RFC 8032 decode: x = u v^3 (u v^7)^((p-5)/8), the sqrt(-1) fix-up,
//     rejection of a non-square and of x = 0 with sign bit 1, then the
//     parity flip on the canonical x;
//   * signed 4-bit windows recoded from the little end with the carry of the
//     last window dropped, as the reference's recode_signed4 does;
//   * Q = [S]B + [h](-A) over 64 windows of 4 doublings, one addition from
//     the per-signature [0..8](-A) table and one mixed addition from the
//     constant [0..8]B Niels table;
//   * the projective compare X_Q == x_R Z_Q and Y_Q == y_R Z_Q.
// Table lookups are direct indexed loads: verification works on public
// data, so data-dependent indexing is allowed here.
//
// The formulas are templates over the field type FE: `fe` (fe25519.cuh,
// the kernels' radix 2^25.5) and `fe17` (fe17.cuh, the reference's 17 x
// 15-bit limbs with the tensor-core multiply of verify_mxu.cu).  A field
// type supplies fe_0/fe_1/fe_copy/fe_add/fe_sub/fe_neg/fe_carry/fe_mul/
// fe_sq/fe_eq/fe_is_zero/fe_canonical/fe_pow22523/fe_from_limbs15, the
// constants fe_const_d/_d2/_sqrtm1, fe_mul_sqrtm1_if and fe_neg_if (the
// decode's conditional multiply and parity flip) and fe_select.  Where the
// kernel radix branches on a lane's data (those two, the ladder's
// signed-digit selects), it keeps its own non-template code below; any
// other field type takes a branchless form: a warp-cooperative multiply
// needs every lane of the warp converged at every call, and a lane that
// branched on its own data need not be.
#pragma once

#include "fe25519.cuh"

template <class FE>
struct ge_p3_t {
  FE X, Y, Z, T;
};

// (Y+X, Y-X, Z, 2dT): the addend form of a variable point.
template <class FE>
struct ge_cached_t {
  FE YplusX, YminusX, Z, T2d;
};

// (y+x, y-x, 2dxy) of an affine point: the addend form of a table constant.
// Entries are canonical (< 2^26 / 2^25 per limb, within LOOSE) and only
// ever enter a multiply.
template <class FE>
struct ge_niels_t {
  FE ypx, ymx, xy2d;
};

typedef ge_p3_t<fe> ge_p3;
typedef ge_cached_t<fe> ge_cached;
typedef ge_niels_t<fe> ge_niels;

MOCHI_HD void fe_const_d(fe* h) {
  const int32_t c[10] = {56195235, 13857412, 51736253, 6949390, 114729,
                         24766616, 60832955, 30306712, 48412415, 21499315};
  for (int i = 0; i < 10; ++i) h->v[i] = c[i];
}

MOCHI_HD void fe_const_d2(fe* h) {
  const int32_t c[10] = {45281625, 27714825, 36363642, 13898781, 229458,
                         15978800, 54557047, 27058993, 29715967, 9444199};
  for (int i = 0; i < 10; ++i) h->v[i] = c[i];
}

MOCHI_HD void fe_const_sqrtm1(fe* h) {
  const int32_t c[10] = {34513072, 25610706, 9377949, 3500415, 12389472,
                         33281959, 41962654, 31548777, 326685, 11406482};
  for (int i = 0; i < 10; ++i) h->v[i] = c[i];
}

// The kernel radix's conditional multiply of the decode: a branch, as
// verify.cu has always run it (a thread's own chain, nothing to keep in
// step with).
MOCHI_HD void fe_mul_sqrtm1_if(fe* x, int cond) {
  if (cond) {
    fe s;
    fe_const_sqrtm1(&s);
    fe_mul(x, x, &s);
  }
}

// x = -x when `cond` (the decode's parity flip): a branch in the kernel
// radix.
MOCHI_HD void fe_neg_if(fe* x, int cond) {
  if (cond) fe_neg(x, x);
}

template <class FE>
MOCHI_HD void ge_identity(ge_p3_t<FE>* r) {
  fe_0(&r->X);
  fe_1(&r->Y);
  fe_1(&r->Z);
  fe_0(&r->T);
}

template <class FE>
MOCHI_HD void ge_to_cached(ge_cached_t<FE>* r, const ge_p3_t<FE>* p) {
  FE d2;
  fe_const_d2(&d2);
  fe_add(&r->YplusX, &p->Y, &p->X);   // 2 TIGHT terms
  fe_sub(&r->YminusX, &p->Y, &p->X);  // 2 TIGHT terms
  fe_copy(&r->Z, &p->Z);
  fe_mul(&r->T2d, &p->T, &d2);
}

// r = p + q (add-2008-hwcd-3, 8 multiplies).  r may alias p.
template <class FE>
MOCHI_HD void ge_add(ge_p3_t<FE>* r, const ge_p3_t<FE>* p, const ge_cached_t<FE>* q) {
  FE a, b, c, d, e, f, g, h, t;
  fe_sub(&t, &p->Y, &p->X);
  fe_mul(&a, &t, &q->YminusX);
  fe_add(&t, &p->Y, &p->X);
  fe_mul(&b, &t, &q->YplusX);
  fe_mul(&c, &p->T, &q->T2d);
  fe_mul(&t, &p->Z, &q->Z);
  fe_add(&d, &t, &t);  // 2 terms
  fe_sub(&e, &b, &a);  // 2 terms
  fe_sub(&f, &d, &c);  // 3 terms
  fe_add(&g, &d, &c);  // 3 terms
  fe_add(&h, &b, &a);  // 2 terms
  fe_mul(&r->X, &e, &f);
  fe_mul(&r->Y, &g, &h);
  fe_mul(&r->Z, &f, &g);
  fe_mul(&r->T, &e, &h);
}

// r = p + q for a table constant q (madd-2008-hwcd-3, 7 multiplies).
template <class FE>
MOCHI_HD void ge_madd(ge_p3_t<FE>* r, const ge_p3_t<FE>* p, const ge_niels_t<FE>* q) {
  FE a, b, c, d, e, f, g, h, t;
  fe_sub(&t, &p->Y, &p->X);
  fe_mul(&a, &t, &q->ymx);
  fe_add(&t, &p->Y, &p->X);
  fe_mul(&b, &t, &q->ypx);
  fe_mul(&c, &q->xy2d, &p->T);
  fe_add(&d, &p->Z, &p->Z);  // 2 terms
  fe_sub(&e, &b, &a);        // 2 terms
  fe_sub(&f, &d, &c);        // 3 terms
  fe_add(&g, &d, &c);        // 3 terms
  fe_add(&h, &b, &a);        // 2 terms
  fe_mul(&r->X, &e, &f);
  fe_mul(&r->Y, &g, &h);
  fe_mul(&r->Z, &f, &g);
  fe_mul(&r->T, &e, &h);
}

// r = 2p (dbl-2008-hwcd, 4 squarings + 3 or 4 multiplies).  The formula
// never reads p->T, so T is computed only when the caller needs it (the
// last of the four doublings of a window).  r may alias p.
template <class FE>
MOCHI_HD void ge_dbl(ge_p3_t<FE>* r, const ge_p3_t<FE>* p, int need_t) {
  FE a, b, c, e, f, g, h, t;
  fe_sq(&a, &p->X);
  fe_sq(&b, &p->Y);
  fe_sq(&t, &p->Z);
  fe_add(&c, &t, &t);  // 2 terms
  fe_add(&h, &a, &b);  // 2 terms
  fe_add(&t, &p->X, &p->Y);
  fe_sq(&e, &t);
  fe_sub(&e, &h, &e);  // 3 terms
  fe_sub(&g, &a, &b);  // 2 terms
  fe_add(&t, &c, &g);  // 4 terms: carry back to TIGHT
  fe_carry(&f, &t);
  fe_mul(&r->X, &e, &f);
  fe_mul(&r->Y, &g, &h);
  fe_mul(&r->Z, &f, &g);
  if (need_t) fe_mul(&r->T, &e, &h);
}

// RFC 8032 section 5.1.3 decode of (y, sign) with y given as 17 15-bit
// limbs.  Returns 1 for a point, 0 for a non-point (no square root, or
// x = 0 with sign = 1).  The point is written even when rejected.
template <class FE>
MOCHI_HD int ge_decode(ge_p3_t<FE>* r, const int32_t* y15, int stride, int sign) {
  FE y, yy, u, v, v3, v7, t, x, vxx, one, dc;
  fe_from_limbs15(&t, y15, stride);
  fe_carry(&y, &t);
  fe_1(&one);
  fe_const_d(&dc);
  fe_sq(&yy, &y);
  fe_sub(&u, &yy, &one);          // y^2 - 1
  fe_mul(&t, &yy, &dc);
  fe_add(&v, &t, &one);           // d y^2 + 1
  fe_sq(&t, &v);
  fe_mul(&v3, &t, &v);            // v^3
  fe_sq(&t, &v3);
  fe_mul(&v7, &t, &v);            // v^7
  fe_mul(&t, &u, &v7);
  fe_pow22523(&t, &t);            // (u v^7)^((p-5)/8)
  fe_mul(&x, &u, &v3);
  fe_mul(&x, &x, &t);             // candidate root
  fe_sq(&t, &x);
  fe_mul(&vxx, &v, &t);
  const int root_ok = fe_eq(&vxx, &u);
  fe_add(&t, &vxx, &u);
  const int root_neg = fe_is_zero(&t);  // v x^2 == -u
  fe_mul_sqrtm1_if(&x, root_neg);
  int ok = root_ok | root_neg;
  FE xc;
  fe_canonical(&xc, &x);
  int32_t any = 0;
  for (int i = 0; i < (int)(sizeof(xc.v) / sizeof(xc.v[0])); ++i) any |= xc.v[i];
  ok &= !(any == 0 && sign == 1);
  fe_neg_if(&x, (xc.v[0] & 1) != sign);
  fe_copy(&r->X, &x);
  fe_copy(&r->Y, &y);
  fe_1(&r->Z);
  fe_mul(&r->T, &x, &y);
  return ok;
}

// 32 little-endian scalar bytes -> 64 signed digits in [-8, 8], exactly the
// reference's recode: t = nibble + carry, t > 8 -> t - 16 with carry 1; the
// carry out of the last window is dropped.
MOCHI_HD void recode_signed4(int8_t* dig, const uint8_t* bytes) {
  int c = 0;
  for (int k = 0; k < 64; ++k) {
    const int nib = (bytes[k >> 1] >> ((k & 1) * 4)) & 15;
    const int t = nib + c;
    c = t > 8;
    dig[k] = (int8_t)(t - 16 * c);
  }
}

// ptab[k] = [k]P for k in 0..8, in cached form (65 multiplies).
template <class FE>
MOCHI_HD void ge_small_multiples(ge_cached_t<FE>* ptab, const ge_p3_t<FE>* p) {
  ge_p3_t<FE> acc;
  ge_identity(&acc);
  ge_to_cached(&ptab[0], &acc);
  ge_to_cached(&ptab[1], p);
  acc = *p;
  for (int k = 2; k < 9; ++k) {
    ge_add(&acc, &acc, &ptab[1]);
    ge_to_cached(&ptab[k], &acc);
  }
}

// r = e, or -e when `neg` (y+x and y-x swapped, the T term negated).  The
// kernel radix branches; other field types select without a branch.
MOCHI_HD void ge_cached_signed(ge_cached* r, const ge_cached* e, int neg) {
  if (neg) {
    fe_copy(&r->YplusX, &e->YminusX);
    fe_copy(&r->YminusX, &e->YplusX);
    fe_neg(&r->T2d, &e->T2d);
  } else {
    fe_copy(&r->YplusX, &e->YplusX);
    fe_copy(&r->YminusX, &e->YminusX);
    fe_copy(&r->T2d, &e->T2d);
  }
  fe_copy(&r->Z, &e->Z);
}

template <class FE>
MOCHI_HD void ge_cached_signed(ge_cached_t<FE>* r, const ge_cached_t<FE>* e,
                               int neg) {
  FE nt;
  fe_neg(&nt, &e->T2d);
  fe_select(&r->YplusX, &e->YminusX, &e->YplusX, neg);
  fe_select(&r->YminusX, &e->YplusX, &e->YminusX, neg);
  fe_select(&r->T2d, &nt, &e->T2d, neg);
  fe_copy(&r->Z, &e->Z);
}

MOCHI_HD void ge_niels_signed(ge_niels* r, const ge_niels* e, int neg) {
  if (neg) {
    fe_copy(&r->ypx, &e->ymx);
    fe_copy(&r->ymx, &e->ypx);
    fe_neg(&r->xy2d, &e->xy2d);
  } else {
    *r = *e;
  }
}

template <class FE>
MOCHI_HD void ge_niels_signed(ge_niels_t<FE>* r, const ge_niels_t<FE>* e,
                              int neg) {
  FE nt;
  fe_neg(&nt, &e->xy2d);
  fe_select(&r->ypx, &e->ymx, &e->ypx, neg);
  fe_select(&r->ymx, &e->ypx, &e->ymx, neg);
  fe_select(&r->xy2d, &nt, &e->xy2d, neg);
}

// One window of the ladder: q = 16 q + [dh]P + [ds]B for signed digits
// dh, ds in [-8, 8] (a negative digit reuses entry |d|, negated).
template <class FE>
MOCHI_HD void ge_window(ge_p3_t<FE>* q, int dh, int ds,
                        const ge_cached_t<FE>* ptab,
                        const ge_niels_t<FE>* btab) {
  ge_dbl(q, q, 0);
  ge_dbl(q, q, 0);
  ge_dbl(q, q, 0);
  ge_dbl(q, q, 1);
  {
    ge_cached_t<FE> ent;
    ge_cached_signed(&ent, &ptab[dh < 0 ? -dh : dh], dh < 0);
    ge_add(q, q, &ent);
  }
  {
    ge_niels_t<FE> ent;
    ge_niels_signed(&ent, &btab[ds < 0 ? -ds : ds], ds < 0);
    ge_madd(q, q, &ent);
  }
}

// Q = [S]B + [h]P with P already negated by the caller (P = -A).
// The [0..8]P table lives in the thread's local memory (9 x 160 bytes);
// btab points at the [0..8]B Niels table (shared memory in the kernel).
template <class FE>
MOCHI_HD void ge_double_scalar_mul(ge_p3_t<FE>* q, const int8_t* s_dig,
                                   const int8_t* h_dig, const ge_p3_t<FE>* p,
                                   const ge_niels_t<FE>* btab) {
  ge_cached_t<FE> ptab[9];
  ge_small_multiples(ptab, p);
  ge_identity(q);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int w = 63; w >= 0; --w) ge_window(q, h_dig[w], s_dig[w], ptab, btab);
}

// The whole cofactorless verify of one signature: 1 valid, 0 not.
// y_a / y_r: 17 limbs of 15 bits, `stride` elements apart.
template <class FE>
MOCHI_HD int ed25519_verify_one(const int32_t* y_a, int sign_a,
                                const int32_t* y_r, int sign_r,
                                const uint8_t* s_bytes,
                                const uint8_t* h_bytes, int stride,
                                const ge_niels_t<FE>* btab) {
  ge_p3_t<FE> a, r, q;
  const int ok_a = ge_decode(&a, y_a, stride, sign_a);
  const int ok_r = ge_decode(&r, y_r, stride, sign_r);
  fe_neg(&a.X, &a.X);  // -A = (-X, Y, Z, -T)
  fe_neg(&a.T, &a.T);
  int8_t s_dig[64], h_dig[64];
  recode_signed4(s_dig, s_bytes);
  recode_signed4(h_dig, h_bytes);
  ge_double_scalar_mul(&q, s_dig, h_dig, &a, btab);
  FE t;
  fe_mul(&t, &r.X, &q.Z);
  const int eq_x = fe_eq(&q.X, &t);
  fe_mul(&t, &r.Y, &q.Z);
  const int eq_y = fe_eq(&q.Y, &t);
  return ok_a & ok_r & eq_x & eq_y;
}
