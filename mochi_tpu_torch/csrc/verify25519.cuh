// The cofactorless verify of one signature by a team of four lanes, radix
// 2^25.5: the arithmetic of verify.cu.  Counterpart of the reference
// package's curve.verify_core (the body of its Pallas kernel,
// crypto/pallas_verify.py::_kernel): the same verdict for every input,
// computed as
//
//   Q = [h](-A) + [S]B,   then   X_Q == x_R Z_Q  and  Y_Q == y_R Z_Q.
//
// Why a team.  One thread's verify (ge25519.cuh's ed25519_verify_one) is a
// chain of 3,431 dependent field operations, so a small launch runs at one
// thread's latency.  Here four lanes of one warp share a signature:
//
//   1. Every lane recodes S and h into signed 4-bit digits (the reference's
//      recode, the carry out of window 63 dropped); lane r keeps the digits
//      of windows w = r mod 4 in the team's shared scratch.
//   2. [S]B leaves the doubling chain: lane r sums windows 16r..16r+15 of
//      the constant basepoint comb ([d 16^w]B, d = 0..8, the comb kernel's
//      table, read through L1), 16 mixed additions each; the team adds the
//      four partial sums into S = [S]B.
//   3. Lanes 0 and 2 decode A, lanes 1 and 3 decode R (RFC 8032, as
//      ge_decode): the two 274-operation decodes run side by side.
//   4. The team builds [1..8](-A) and runs the 64-window ladder of
//      [h](-A) (4 doublings and one cached addition a window), then adds S
//      and compares.  Each doubling (dbl-2008-hwcd) and each addition
//      (add-2008-hwcd-3) is two steps of four independent field operations
//      (4 squarings then 4 multiplies; 4 multiplies then 4): lane r does
//      operation r of each step, so the chain's length drops from 7-8
//      operations a doubling or addition to 2.
//
// Exchange.  After each step lane r writes its result to slot r of the
// team's exchange buffer, the team synchronises (__syncwarp on the team's
// four lanes), and every lane reads all four slots: every lane then holds
// the whole team state (the point, or the step's four products).  Two
// buffers alternate, so a lane that runs ahead never overwrites a slot
// another lane has still to read.  The cached table is laid out by
// coordinate: lane r writes and reads only coordinate r of every entry
// (Y-X, Y+X, 2dT, Z, in that order), which is the one operand its step of an
// addition needs, so the table needs no synchronisation of its own.  A
// negative digit swaps the products of lanes 0 and 1 and negates T on lane
// 2 (instead of swapping the entry's coordinates): A = s1, B = s0.
//
// Bounds (fe25519.cuh): every point coordinate is TIGHT (an fe_mul output,
// or a negated one, or a constant); a step's operands are the same sums
// ge_add, ge_madd and ge_dbl form (at most three TIGHT terms, F of a
// doubling carried), and a table coordinate is at most two TIGHT terms.
// tests/test_torch_kernel_host.py fuzzes both steps at the TIGHT maximum.
//
// The twin.  The verify is written once, over a lane policy LN: on the card
// (vt_warp_lanes, verify.cu) each thread plays one role and sync() is the
// team's __syncwarp; on the host (vt_serial_lanes) one thread plays the four
// roles in turn and sync() does nothing.  Lane-private values are arrays of
// LN::N (1 on the card, 4 on the host); team-wide values are single.  So
// the g++ build in the tests runs every team piece of the kernel's source.
#pragma once

#include "comb25519.cuh"
#include "ge25519.cuh"

// Lanes a signature: four, one role each (each step of a doubling or an
// addition is four independent field operations).  The code also runs with
// two (two roles a lane); PERF.md has both measured.
#define MOCHI_VT_TEAM 4

// A member function for both compilers (MOCHI_HD is `static` on the host).
#if defined(__CUDACC__)
#define MOCHI_HD_MEMBER __host__ __device__ __forceinline__
#else
#define MOCHI_HD_MEMBER inline
#endif

// One team's shared scratch: 497 int32 words (odd, so that the eight teams
// of a warp read a given word from eight different banks).
struct vt_area {
  int32_t xbuf[2][4][10];  // exchange buffers: [buffer][slot = role][limb]
  int32_t tab[9][4][10];   // [entry][coordinate][limb]: 0 is S, k is [k](-A)
  int32_t rpt[2][10];      // x_R, y_R
  int32_t ok[4];           // each role's decode verdict
  int8_t dig[2][64];       // signed digits of S and h
  int32_t pad;
};

// One thread plays every role: the serial twin.
struct vt_serial_lanes {
  static constexpr int N = 4;
  MOCHI_HD_MEMBER int role(int j) const { return j; }
  MOCHI_HD_MEMBER void sync() const {}
};

// The kernel's lanes: a team of MOCHI_VT_TEAM lanes of one warp, lane r
// (lane id mod the team) playing roles r, r + MOCHI_VT_TEAM, ...: one role
// a lane in a team of four.  `mask` names the team's lanes, which call
// every sync() together.
struct vt_warp_lanes {
  static constexpr int N = 4 / MOCHI_VT_TEAM;
  int r;
  unsigned mask;
  MOCHI_HD_MEMBER int role(int j) const { return r + j * MOCHI_VT_TEAM; }
  MOCHI_HD_MEMBER void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp(mask);
#endif
  }
};

MOCHI_HD void vt_load(fe* f, const int32_t* p) {
  for (int i = 0; i < 10; ++i) f->v[i] = p[i];
}

MOCHI_HD void vt_store(int32_t* p, const fe* f) {
  for (int i = 0; i < 10; ++i) p[i] = f->v[i];
}

// h = c ? f : g, limb by limb (a select, not a branch).
MOCHI_HD void vt_pick(fe* h, int c, const fe* f, const fe* g) {
  for (int i = 0; i < 10; ++i) h->v[i] = c ? f->v[i] : g->v[i];
}

// Signed 4-bit digits of 32 little-endian bytes, exactly recode_signed4's;
// only the windows w = r mod 4 are stored.
MOCHI_HD void vt_recode(int8_t* dig, const uint8_t* bytes, int r) {
  int c = 0;
  for (int k = 0; k < 64; ++k) {
    const int nib = (bytes[k >> 1] >> ((k & 1) * 4)) & 15;
    const int t = nib + c;
    c = t > 8;
    if ((k & 3) == r) dig[k] = (int8_t)(t - 16 * c);
  }
}

// The team's state after a step: every lane writes its results (slot =
// role), the team synchronises, every lane reads the four slots into s.
template <class LN>
MOCHI_HD void vt_exchange(const LN& ln, vt_area* a, int* xb, const fe* out, fe* s) {
  for (int j = 0; j < LN::N; ++j) vt_store(a->xbuf[*xb][ln.role(j)], &out[j]);
  ln.sync();
  for (int k = 0; k < 4; ++k) vt_load(&s[k], a->xbuf[*xb][k]);
  *xb ^= 1;
}

// Coordinate r of p's cached form (Y-X, Y+X, 2dT, Z): one multiply.
MOCHI_HD void vt_cached_coord(fe* out, const ge_p3* p, int r) {
  fe d2, t2d, ymx, ypx;
  fe_const_d2(&d2);
  fe_mul(&t2d, &p->T, &d2);
  fe_sub(&ymx, &p->Y, &p->X);  // 2 terms
  fe_add(&ypx, &p->Y, &p->X);  // 2 terms
  vt_pick(out, r == 0, &ymx, &t2d);
  vt_pick(out, r == 1, &ypx, out);
  vt_pick(out, r == 3, &p->Z, out);
}

// Each lane writes coordinate r of p's cached form into entry k.
template <class LN>
MOCHI_HD void vt_put_cached(const LN& ln, vt_area* a, int k, const ge_p3* p) {
  for (int j = 0; j < LN::N; ++j) {
    const int r = ln.role(j);
    fe c;
    vt_cached_coord(&c, p, r);
    vt_store(a->tab[k][r], &c);
  }
}

// The second step of an addition or a doubling: X = E F, Y = G H,
// Z = F G, T = E H, lane r computing the r-th.
template <class LN>
MOCHI_HD void vt_finish(const LN& ln, vt_area* a, int* xb, ge_p3* q, const fe* e,
                        const fe* f, const fe* g, const fe* h) {
  fe out[LN::N], s[4];
  for (int j = 0; j < LN::N; ++j) {
    const int r = ln.role(j);
    fe x, y;
    vt_pick(&x, r == 1, g, e);
    vt_pick(&x, r == 2, f, &x);
    vt_pick(&y, r == 0, f, h);
    vt_pick(&y, r == 2, g, &y);
    fe_mul(&out[j], &x, &y);
  }
  vt_exchange(ln, a, xb, out, s);
  q->X = s[0];
  q->Y = s[1];
  q->Z = s[2];
  q->T = s[3];
}

// q = q + (entry k of the cached table, negated when `neg`; the identity
// when `ident`): add-2008-hwcd-3 in two team steps.  Lane r multiplies
// coordinate r of the entry by Y-X, Y+X, T or Z of q; a negated entry swaps
// the first two operands and negates T, so A and B come back swapped.
template <class LN>
MOCHI_HD void vt_add(const LN& ln, vt_area* a, int* xb, ge_p3* q, int k, int neg, int ident) {
  fe out[LN::N], s[4];
  fe ymx, ypx, nt, u, v, t;
  fe_sub(&ymx, &q->Y, &q->X);  // 2 terms
  fe_add(&ypx, &q->Y, &q->X);  // 2 terms
  fe_neg(&nt, &q->T);
  vt_pick(&u, neg, &ypx, &ymx);
  vt_pick(&v, neg, &ymx, &ypx);
  vt_pick(&t, neg, &nt, &q->T);
  for (int j = 0; j < LN::N; ++j) {
    const int r = ln.role(j);
    fe x, c;
    vt_load(&c, a->tab[k][r]);
    // the identity's cached form is (1, 1, 0, 1)
    for (int i = 0; i < 10; ++i) c.v[i] = ident ? (int32_t)(i == 0 && r != 2) : c.v[i];
    vt_pick(&x, r == 0, &u, &q->Z);
    vt_pick(&x, r == 1, &v, &x);
    vt_pick(&x, r == 2, &t, &x);
    fe_mul(&out[j], &x, &c);
  }
  vt_exchange(ln, a, xb, out, s);
  fe pa, pb, d, e, f, g, h;
  vt_pick(&pa, neg, &s[1], &s[0]);
  vt_pick(&pb, neg, &s[0], &s[1]);
  fe_add(&d, &s[3], &s[3]);  // 2 terms
  fe_sub(&e, &pb, &pa);      // 2 terms
  fe_sub(&f, &d, &s[2]);     // 3 terms
  fe_add(&g, &d, &s[2]);     // 3 terms
  fe_add(&h, &pb, &pa);      // 2 terms
  vt_finish(ln, a, xb, q, &e, &f, &g, &h);
}

// q = 2q: dbl-2008-hwcd in two team steps (T always computed).
template <class LN>
MOCHI_HD void vt_dbl(const LN& ln, vt_area* a, int* xb, ge_p3* q) {
  fe out[LN::N], s[4];
  fe xy;
  fe_add(&xy, &q->X, &q->Y);  // 2 terms
  for (int j = 0; j < LN::N; ++j) {
    const int r = ln.role(j);
    fe x;
    vt_pick(&x, r == 0, &q->X, &xy);
    vt_pick(&x, r == 1, &q->Y, &x);
    vt_pick(&x, r == 2, &q->Z, &x);
    fe_sq(&out[j], &x);
  }
  vt_exchange(ln, a, xb, out, s);
  fe c, e, f, g, h, t;
  fe_add(&c, &s[2], &s[2]);  // 2 terms
  fe_add(&h, &s[0], &s[1]);  // 2 terms
  fe_sub(&e, &h, &s[3]);     // 3 terms
  fe_sub(&g, &s[0], &s[1]);  // 2 terms
  fe_add(&t, &c, &g);        // 4 terms: carry back to TIGHT
  fe_carry(&f, &t);
  vt_finish(ln, a, xb, q, &e, &f, &g, &h);
}

// The signed digits of S and h into the scratch; lane r stores windows
// w = r mod 4, so the team synchronises before any lane reads them.
template <class LN>
MOCHI_HD void vt_digits(const LN& ln, vt_area* a, const uint8_t* s_bytes, const uint8_t* h_bytes) {
  for (int j = 0; j < LN::N; ++j) {
    vt_recode(a->dig[0], s_bytes, ln.role(j));
    vt_recode(a->dig[1], h_bytes, ln.role(j));
  }
  ln.sync();
}

// [S]B by the team: lane r sums windows 16r..16r+15 of the basepoint comb
// (576 Niels entries, [d 16^w]B at w * 9 + d: comb25519.cuh's layout), the
// four partial sums go whole to entries 1..4 of the table, and the team
// adds them to the identity.  Needs vt_digits first.
template <class LN>
MOCHI_HD void vt_comb_sb(const LN& ln, vt_area* a, int* xb, ge_p3* sb, const int32_t* bcomb) {
  for (int j = 0; j < LN::N; ++j) {
    const int r = ln.role(j);
    ge_p3 part;
    ge_identity(&part);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
    for (int i = 0; i < 16; ++i) {
      const int w = 16 * r + i, d = a->dig[0][w];
      ge_niels n;
      comb_load_niels(&n, bcomb + (w * MOCHI_COMB_ENTRIES + (d < 0 ? -d : d)) * MOCHI_COMB_ENTRY_INTS,
                      d < 0);
      ge_madd(&part, &part, &n);
    }
    fe d2, c;
    fe_const_d2(&d2);
    fe_sub(&c, &part.Y, &part.X);
    vt_store(a->tab[1 + r][0], &c);
    fe_add(&c, &part.Y, &part.X);
    vt_store(a->tab[1 + r][1], &c);
    fe_mul(&c, &part.T, &d2);
    vt_store(a->tab[1 + r][2], &c);
    vt_store(a->tab[1 + r][3], &part.Z);
  }
  ln.sync();
  ge_identity(sb);
  for (int k = 1; k <= 4; ++k) vt_add(ln, a, xb, sb, k, 0, 0);
}

// Entries 1..8 of the table: [k]P in cached form, from P by 7 team
// additions.
template <class LN>
MOCHI_HD void vt_table(const LN& ln, vt_area* a, int* xb, const ge_p3* p) {
  vt_put_cached(ln, a, 1, p);
  ge_p3 acc = *p;
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int k = 2; k <= 8; ++k) {
    vt_add(ln, a, xb, &acc, 1, 0, 0);
    vt_put_cached(ln, a, k, &acc);
  }
}

// The whole cofactorless verify of one signature: 1 valid, 0 not.  y_a /
// y_r: 17 contiguous limbs of 15 bits; bcomb: the basepoint comb.
template <class LN>
MOCHI_HD int vt_verify(const LN& ln, vt_area* a, const int32_t* y_a, int sign_a, const int32_t* y_r,
                       int sign_r, const uint8_t* s_bytes, const uint8_t* h_bytes,
                       const int32_t* bcomb) {
  int xb = 0;
  vt_digits(ln, a, s_bytes, h_bytes);
  // [S]B, kept in entry 0 of the table until the end
  ge_p3 q;
  vt_comb_sb(ln, a, &xb, &q, bcomb);
  vt_put_cached(ln, a, 0, &q);
  // the decodes: A on even lanes, R on odd ones; the team gets x_A, x_R,
  // T_A, y_R (slots 0-3) and both verdicts; y_A it decodes itself
  ge_p3 p;
  {
    // roles of one parity share a decode: a lane runs one for each parity
    // among its roles (both only when one thread plays all four)
    constexpr int D = LN::N == 4 ? 2 : 1;
    ge_p3 pt[D];
    int okd[D];
    for (int d = 0; d < D; ++d) {
      const int odd = ln.role(d) & 1;
      okd[d] = ge_decode(&pt[d], odd ? y_r : y_a, 1, odd ? sign_r : sign_a);
    }
    fe out[LN::N], s[4];
    for (int j = 0; j < LN::N; ++j) {
      const int r = ln.role(j), d = D == 2 ? (j & 1) : 0;
      a->ok[r] = okd[d];
      vt_pick(&out[j], r == 0 || r == 1, &pt[d].X, &pt[d].T);
      vt_pick(&out[j], r == 3, &pt[d].Y, &out[j]);
    }
    vt_exchange(ln, a, &xb, out, s);
    for (int j = 0; j < LN::N; ++j) {
      const int r = ln.role(j);
      fe c;
      vt_pick(&c, r == 1, &s[1], &s[3]);
      if (r & 1) vt_store(a->rpt[r >> 1], &c);
    }
    fe t;
    fe_from_limbs15(&t, y_a, 1);
    fe_carry(&p.Y, &t);  // as ge_decode
    fe_neg(&p.X, &s[0]);
    fe_neg(&p.T, &s[2]);
    fe_1(&p.Z);
  }
  const int ok = a->ok[0] & a->ok[1];
  // [1..8]P for P = -A
  vt_table(ln, a, &xb, &p);
  // the ladder: Q = [h](-A), most significant window first (the identity's
  // four doublings skipped)
  ge_identity(&q);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int w = 63; w >= 0; --w) {
    if (w != 63) {
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
      for (int i = 0; i < 4; ++i) vt_dbl(ln, a, &xb, &q);
    }
    const int d = a->dig[1][w];
    vt_add(ln, a, &xb, &q, d < 0 ? -d : d, d < 0, d == 0);
  }
  // Q + [S]B, then the projective compare against R
  vt_add(ln, a, &xb, &q, 0, 0, 0);
  fe xr, yr, t;
  vt_load(&xr, a->rpt[0]);
  vt_load(&yr, a->rpt[1]);
  fe_mul(&t, &xr, &q.Z);
  const int eq_x = fe_eq(&q.X, &t);
  fe_mul(&t, &yr, &q.Z);
  const int eq_y = fe_eq(&q.Y, &t);
  return ok & eq_x & eq_y;
}
