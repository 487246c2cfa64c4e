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
#pragma once

#include "fe25519.cuh"

typedef struct {
  fe X, Y, Z, T;
} ge_p3;

// (Y+X, Y-X, Z, 2dT): the addend form of a variable point.
typedef struct {
  fe YplusX, YminusX, Z, T2d;
} ge_cached;

// (y+x, y-x, 2dxy) of an affine point: the addend form of a table constant.
// Entries are canonical (< 2^26 / 2^25 per limb, within LOOSE) and only
// ever enter a multiply.
typedef struct {
  fe ypx, ymx, xy2d;
} ge_niels;

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

MOCHI_HD void ge_identity(ge_p3* r) {
  fe_0(&r->X);
  fe_1(&r->Y);
  fe_1(&r->Z);
  fe_0(&r->T);
}

MOCHI_HD void ge_to_cached(ge_cached* r, const ge_p3* p) {
  fe d2;
  fe_const_d2(&d2);
  fe_add(&r->YplusX, &p->Y, &p->X);   // 2 TIGHT terms
  fe_sub(&r->YminusX, &p->Y, &p->X);  // 2 TIGHT terms
  fe_copy(&r->Z, &p->Z);
  fe_mul(&r->T2d, &p->T, &d2);
}

// r = p + q (add-2008-hwcd-3, 8 multiplies).  r may alias p.
MOCHI_HD void ge_add(ge_p3* r, const ge_p3* p, const ge_cached* q) {
  fe a, b, c, d, e, f, g, h, t;
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
MOCHI_HD void ge_madd(ge_p3* r, const ge_p3* p, const ge_niels* q) {
  fe a, b, c, d, e, f, g, h, t;
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
MOCHI_HD void ge_dbl(ge_p3* r, const ge_p3* p, int need_t) {
  fe a, b, c, e, f, g, h, t;
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
MOCHI_HD int ge_decode(ge_p3* r, const int32_t* y15, int stride, int sign) {
  fe y, yy, u, v, v3, v7, t, x, vxx, one, dc;
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
  if (root_neg) {
    fe s;
    fe_const_sqrtm1(&s);
    fe_mul(&x, &x, &s);
  }
  int ok = root_ok | root_neg;
  fe xc;
  fe_canonical(&xc, &x);
  int32_t any = 0;
  for (int i = 0; i < 10; ++i) any |= xc.v[i];
  if (any == 0 && sign == 1) ok = 0;
  if ((xc.v[0] & 1) != sign) fe_neg(&x, &x);
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
MOCHI_HD void ge_small_multiples(ge_cached* ptab, const ge_p3* p) {
  ge_p3 acc;
  ge_identity(&acc);
  ge_to_cached(&ptab[0], &acc);
  ge_to_cached(&ptab[1], p);
  acc = *p;
  for (int k = 2; k < 9; ++k) {
    ge_add(&acc, &acc, &ptab[1]);
    ge_to_cached(&ptab[k], &acc);
  }
}

// One window of the ladder: q = 16 q + [dh]P + [ds]B for signed digits
// dh, ds in [-8, 8] (a negative digit reuses entry |d|, negated).
MOCHI_HD void ge_window(ge_p3* q, int dh, int ds, const ge_cached* ptab,
                        const ge_niels* btab) {
  ge_dbl(q, q, 0);
  ge_dbl(q, q, 0);
  ge_dbl(q, q, 0);
  ge_dbl(q, q, 1);
  {
    const ge_cached* e = &ptab[dh < 0 ? -dh : dh];
    ge_cached ent;
    if (dh < 0) {
      fe_copy(&ent.YplusX, &e->YminusX);
      fe_copy(&ent.YminusX, &e->YplusX);
      fe_neg(&ent.T2d, &e->T2d);
    } else {
      fe_copy(&ent.YplusX, &e->YplusX);
      fe_copy(&ent.YminusX, &e->YminusX);
      fe_copy(&ent.T2d, &e->T2d);
    }
    fe_copy(&ent.Z, &e->Z);
    ge_add(q, q, &ent);
  }
  {
    const ge_niels* e = &btab[ds < 0 ? -ds : ds];
    ge_niels ent;
    if (ds < 0) {
      fe_copy(&ent.ypx, &e->ymx);
      fe_copy(&ent.ymx, &e->ypx);
      fe_neg(&ent.xy2d, &e->xy2d);
    } else {
      ent = *e;
    }
    ge_madd(q, q, &ent);
  }
}

// Q = [S]B + [h]P with P already negated by the caller (P = -A).
// The [0..8]P table lives in the thread's local memory (9 x 160 bytes);
// btab points at the [0..8]B Niels table (shared memory in the kernel).
MOCHI_HD void ge_double_scalar_mul(ge_p3* q, const int8_t* s_dig,
                                   const int8_t* h_dig, const ge_p3* p,
                                   const ge_niels* btab) {
  ge_cached ptab[9];
  ge_small_multiples(ptab, p);
  ge_identity(q);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int w = 63; w >= 0; --w) ge_window(q, h_dig[w], s_dig[w], ptab, btab);
}

// The whole cofactorless verify of one signature: 1 valid, 0 not.
// y_a / y_r: 17 limbs of 15 bits, `stride` elements apart.
MOCHI_HD int ed25519_verify_one(const int32_t* y_a, int sign_a,
                                const int32_t* y_r, int sign_r,
                                const uint8_t* s_bytes,
                                const uint8_t* h_bytes, int stride,
                                const ge_niels* btab) {
  ge_p3 a, r, q;
  const int ok_a = ge_decode(&a, y_a, stride, sign_a);
  const int ok_r = ge_decode(&r, y_r, stride, sign_r);
  fe_neg(&a.X, &a.X);  // -A = (-X, Y, Z, -T)
  fe_neg(&a.T, &a.T);
  int8_t s_dig[64], h_dig[64];
  recode_signed4(s_dig, s_bytes);
  recode_signed4(h_dig, h_bytes);
  ge_double_scalar_mul(&q, s_dig, h_dig, &a, btab);
  fe t;
  fe_mul(&t, &r.X, &q.Z);
  const int eq_x = fe_eq(&q.X, &t);
  fe_mul(&t, &r.Y, &q.Z);
  const int eq_y = fe_eq(&q.Y, &t);
  return ok_a & ok_r & eq_x & eq_y;
}
