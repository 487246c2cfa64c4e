// GF(2^255-19) arithmetic for one signature per thread, radix 2^25.5.
//
// Layout.  A field element is ten signed 32-bit limbs f[0..9]; limb i has
// weight 2^ceil(25.5*i) (bit offsets 0,26,51,77,102,128,153,179,204,230), so
// even limbs hold 26 bits and odd limbs 25 bits when carried.  The radix is
// chosen for Hopper's 32x32->64 integer multiply-add: a product of two limbs
// is one IMAD.WIDE into a 64-bit accumulator, a multiply is 100 of them and
// a squaring 55.  (The reference package's 17x15-bit layout exists because
// the TPU's vector unit has no widening multiply; its bounds do not apply.)
//
// Bounds (every claim below is fuzzed at its extremes by the host build in
// tests/test_torch_kernel_host.py):
//   TIGHT  -- what fe_carry/fe_mul/fe_sq return:
//             |even limb| <= 2^25 + 2^14, |odd limb| <= 2^24 + 2^14.
//   LOOSE  -- what fe_mul/fe_sq accept:
//             |even limb| <= MOCHI_LOOSE_EVEN = 110729625 (~1.65*2^26),
//             |odd limb|  <= MOCHI_LOOSE_ODD  =  55364812 (~1.65*2^25).
//   A signed sum of at most three TIGHT elements is LOOSE
//   (3*(2^25+2^14) = 100712448 <= 110729625; odd likewise), so fe_add and
//   fe_sub do not carry and the curve code keeps every multiply input within
//   three tight terms, carrying explicitly where a formula would go deeper.
//   Why LOOSE suffices: a multiply forms 19*g_j in int32
//   (19*110729625 = 2103862875 < 2^31) and 2*f_i for odd i; the largest
//   output column is f0g0 + 5 terms of 38*O*O + 4 terms of 19*E*E with
//   E = 110729625, O = 55364812, i.e. < 124.5*E^2 < 2^60.6 < 2^63, so the
//   int64 accumulators never overflow.
//
// Signed shifts.  Carries of negative columns need floor division by 2^k.
// The right shift of a negative signed integer is implementation-defined
// before C++20, so every such shift goes through mochi_asr64, which shifts
// only non-negative values (floor(x/2^k) = ~(~x >> k) for x < 0).
//
// Everything here is __host__ __device__ so the same source is compiled for
// the CPU in the tests and for sm_90a by nvcc.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define MOCHI_HD __host__ __device__ __forceinline__
#else
#define MOCHI_HD static inline
#endif

#define MOCHI_LOOSE_EVEN 110729625
#define MOCHI_LOOSE_ODD 55364812

typedef struct {
  int32_t v[10];
} fe;

// floor(x / 2^k) without shifting a negative value.
MOCHI_HD int64_t mochi_asr64(int64_t x, int k) {
  return x >= 0 ? (x >> k) : ~((~x) >> k);
}

MOCHI_HD void fe_0(fe* h) {
  for (int i = 0; i < 10; ++i) h->v[i] = 0;
}

MOCHI_HD void fe_1(fe* h) {
  fe_0(h);
  h->v[0] = 1;
}

MOCHI_HD void fe_copy(fe* h, const fe* f) {
  for (int i = 0; i < 10; ++i) h->v[i] = f->v[i];
}

MOCHI_HD void fe_add(fe* h, const fe* f, const fe* g) {
  for (int i = 0; i < 10; ++i) h->v[i] = f->v[i] + g->v[i];
}

MOCHI_HD void fe_sub(fe* h, const fe* f, const fe* g) {
  for (int i = 0; i < 10; ++i) h->v[i] = f->v[i] - g->v[i];
}

MOCHI_HD void fe_neg(fe* h, const fe* f) {
  for (int i = 0; i < 10; ++i) h->v[i] = -f->v[i];
}

// Round-to-nearest carry out of limb i into limb i+1 (2^25 or 2^24 bias):
// leaves |limb i| <= 2^25 (even) or 2^24 (odd).
MOCHI_HD void mochi_carry_at(int64_t* h, int i) {
  const int bits = (i & 1) ? 25 : 26;
  const int64_t c = mochi_asr64(h[i] + ((int64_t)1 << (bits - 1)), bits);
  h[i + 1] += c;
  h[i] -= c * ((int64_t)1 << bits);
}

// Carry ten 64-bit columns (|column| < 2^62) into a TIGHT element.  The
// interleaved order is ref10's: two chains run in parallel, the top carry
// folds into limb 0 times 19 (2^255 = 19 mod p), and one more carry out of
// limb 0 leaves limb 1 at most 2^24 + 2^14.
MOCHI_HD void fe_reduce64(fe* out, int64_t* h) {
  mochi_carry_at(h, 0);
  mochi_carry_at(h, 4);
  mochi_carry_at(h, 1);
  mochi_carry_at(h, 5);
  mochi_carry_at(h, 2);
  mochi_carry_at(h, 6);
  mochi_carry_at(h, 3);
  mochi_carry_at(h, 7);
  mochi_carry_at(h, 4);
  mochi_carry_at(h, 8);
  {
    const int64_t c = mochi_asr64(h[9] + ((int64_t)1 << 24), 25);
    h[0] += c * 19;
    h[9] -= c * ((int64_t)1 << 25);
  }
  mochi_carry_at(h, 0);
  for (int i = 0; i < 10; ++i) out->v[i] = (int32_t)h[i];
}

// Any element whose limbs fit in int32 -> TIGHT.
MOCHI_HD void fe_carry(fe* h, const fe* f) {
  int64_t t[10];
  for (int i = 0; i < 10; ++i) t[i] = f->v[i];
  fe_reduce64(h, t);
}

// h = f * g.  Inputs LOOSE, output TIGHT.  100 32x32->64 products.
MOCHI_HD void fe_mul_inline(fe* h, const fe* f, const fe* g) {
  const int32_t f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3],
                f4 = f->v[4], f5 = f->v[5], f6 = f->v[6], f7 = f->v[7],
                f8 = f->v[8], f9 = f->v[9];
  const int32_t g0 = g->v[0], g1 = g->v[1], g2 = g->v[2], g3 = g->v[3],
                g4 = g->v[4], g5 = g->v[5], g6 = g->v[6], g7 = g->v[7],
                g8 = g->v[8], g9 = g->v[9];
  const int32_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3,
                g4_19 = 19 * g4, g5_19 = 19 * g5, g6_19 = 19 * g6,
                g7_19 = 19 * g7, g8_19 = 19 * g8, g9_19 = 19 * g9;
  const int32_t f1_2 = 2 * f1, f3_2 = 2 * f3, f5_2 = 2 * f5, f7_2 = 2 * f7,
                f9_2 = 2 * f9;
#define M(a, b) ((int64_t)(a) * (int64_t)(b))
  int64_t t[10];
  t[0] = M(f0, g0) + M(f1_2, g9_19) + M(f2, g8_19) + M(f3_2, g7_19) +
         M(f4, g6_19) + M(f5_2, g5_19) + M(f6, g4_19) + M(f7_2, g3_19) +
         M(f8, g2_19) + M(f9_2, g1_19);
  t[1] = M(f0, g1) + M(f1, g0) + M(f2, g9_19) + M(f3, g8_19) + M(f4, g7_19) +
         M(f5, g6_19) + M(f6, g5_19) + M(f7, g4_19) + M(f8, g3_19) +
         M(f9, g2_19);
  t[2] = M(f0, g2) + M(f1_2, g1) + M(f2, g0) + M(f3_2, g9_19) + M(f4, g8_19) +
         M(f5_2, g7_19) + M(f6, g6_19) + M(f7_2, g5_19) + M(f8, g4_19) +
         M(f9_2, g3_19);
  t[3] = M(f0, g3) + M(f1, g2) + M(f2, g1) + M(f3, g0) + M(f4, g9_19) +
         M(f5, g8_19) + M(f6, g7_19) + M(f7, g6_19) + M(f8, g5_19) +
         M(f9, g4_19);
  t[4] = M(f0, g4) + M(f1_2, g3) + M(f2, g2) + M(f3_2, g1) + M(f4, g0) +
         M(f5_2, g9_19) + M(f6, g8_19) + M(f7_2, g7_19) + M(f8, g6_19) +
         M(f9_2, g5_19);
  t[5] = M(f0, g5) + M(f1, g4) + M(f2, g3) + M(f3, g2) + M(f4, g1) +
         M(f5, g0) + M(f6, g9_19) + M(f7, g8_19) + M(f8, g7_19) +
         M(f9, g6_19);
  t[6] = M(f0, g6) + M(f1_2, g5) + M(f2, g4) + M(f3_2, g3) + M(f4, g2) +
         M(f5_2, g1) + M(f6, g0) + M(f7_2, g9_19) + M(f8, g8_19) +
         M(f9_2, g7_19);
  t[7] = M(f0, g7) + M(f1, g6) + M(f2, g5) + M(f3, g4) + M(f4, g3) +
         M(f5, g2) + M(f6, g1) + M(f7, g0) + M(f8, g9_19) + M(f9, g8_19);
  t[8] = M(f0, g8) + M(f1_2, g7) + M(f2, g6) + M(f3_2, g5) + M(f4, g4) +
         M(f5_2, g3) + M(f6, g2) + M(f7_2, g1) + M(f8, g0) + M(f9_2, g9_19);
  t[9] = M(f0, g9) + M(f1, g8) + M(f2, g7) + M(f3, g6) + M(f4, g5) +
         M(f5, g4) + M(f6, g3) + M(f7, g2) + M(f8, g1) + M(f9, g0);
#undef M
  fe_reduce64(h, t);
}

// h = f^2.  Input LOOSE, output TIGHT.  55 products: each cross term once,
// doubled through the 2*f_i factors, odd*odd terms doubled again for the
// radix-2^25.5 weights, top half folded through 19*f_j (and 38*f_j where
// both weights are odd).
MOCHI_HD void fe_sq_inline(fe* h, const fe* f) {
  const int32_t f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3],
                f4 = f->v[4], f5 = f->v[5], f6 = f->v[6], f7 = f->v[7],
                f8 = f->v[8], f9 = f->v[9];
  const int32_t f0_2 = 2 * f0, f1_2 = 2 * f1, f2_2 = 2 * f2, f3_2 = 2 * f3,
                f4_2 = 2 * f4, f5_2 = 2 * f5, f6_2 = 2 * f6, f7_2 = 2 * f7;
  // 38 * loose odd limb: 38 * 55364812 = 2103862856 < 2^31; 19 * loose even
  // limb: 19 * 110729625 < 2^31.
  const int32_t f5_38 = 38 * f5, f6_19 = 19 * f6, f7_38 = 38 * f7,
                f8_19 = 19 * f8, f9_38 = 38 * f9;
#define M(a, b) ((int64_t)(a) * (int64_t)(b))
  int64_t t[10];
  t[0] = M(f0, f0) + M(f1_2, f9_38) + M(f2_2, f8_19) + M(f3_2, f7_38) +
         M(f4_2, f6_19) + M(f5, f5_38);
  t[1] = M(f0_2, f1) + M(f2, f9_38) + M(f3_2, f8_19) + M(f4, f7_38) +
         M(f5_2, f6_19);
  t[2] = M(f0_2, f2) + M(f1_2, f1) + M(f3_2, f9_38) + M(f4_2, f8_19) +
         M(f5_2, f7_38) + M(f6, f6_19);
  t[3] = M(f0_2, f3) + M(f1_2, f2) + M(f4, f9_38) + M(f5_2, f8_19) +
         M(f6, f7_38);
  t[4] = M(f0_2, f4) + M(f1_2, f3_2) + M(f2, f2) + M(f5_2, f9_38) +
         M(f6_2, f8_19) + M(f7, f7_38);
  t[5] = M(f0_2, f5) + M(f1_2, f4) + M(f2_2, f3) + M(f6, f9_38) +
         M(f7_2, f8_19);
  t[6] = M(f0_2, f6) + M(f1_2, f5_2) + M(f2_2, f4) + M(f3_2, f3) +
         M(f7_2, f9_38) + M(f8, f8_19);
  t[7] = M(f0_2, f7) + M(f1_2, f6) + M(f2_2, f5) + M(f3_2, f4) +
         M(f8, f9_38);
  t[8] = M(f0_2, f8) + M(f1_2, f7_2) + M(f2_2, f6) + M(f3_2, f5_2) +
         M(f4, f4) + M(f9, f9_38);
  t[9] = M(f0_2, f9) + M(f1_2, f8) + M(f2_2, f7) + M(f3_2, f6) +
         M(f4_2, f5);
#undef M
  fe_reduce64(h, t);
}

// fe_mul and fe_sq: inlined at every call, unless the kernel defines
// MOCHI_FE_CALLED before it includes this header (comb.cu does): then the
// card has one copy of each, which every site calls with its operands by
// value.  For comb.cu that makes the kernel's code 7x smaller and takes it
// from 255 registers to 150 with no local memory, and it runs faster at
// every launch size (PERF.md).
#if defined(MOCHI_FE_CALLED) && defined(__CUDACC__)
__host__ __device__ __noinline__ fe fe_mul_called(fe f, fe g) {
  fe h;
  fe_mul_inline(&h, &f, &g);
  return h;
}

__host__ __device__ __noinline__ fe fe_sq_called(fe f) {
  fe h;
  fe_sq_inline(&h, &f);
  return h;
}

MOCHI_HD void fe_mul(fe* h, const fe* f, const fe* g) { *h = fe_mul_called(*f, *g); }
MOCHI_HD void fe_sq(fe* h, const fe* f) { *h = fe_sq_called(*f); }
#else
MOCHI_HD void fe_mul(fe* h, const fe* f, const fe* g) { fe_mul_inline(h, f, g); }
MOCHI_HD void fe_sq(fe* h, const fe* f) { fe_sq_inline(h, f); }
#endif

// h = f^(2^n), n >= 1.
MOCHI_HD void fe_sq_n(fe* h, const fe* f, int n) {
  fe_sq(h, f);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int i = 1; i < n; ++i) fe_sq(h, h);
}

// Canonical form: the unique representative < p, limbs in [0, 2^26) /
// [0, 2^25).  Input: any element whose limbs fit in int32.
MOCHI_HD void fe_canonical(fe* out, const fe* f) {
  fe t;
  fe_carry(&t, f);  // TIGHT: value in (-2^255 - 2^240, 2^255 + 2^240)
  int64_t h[10];
  for (int i = 0; i < 10; ++i) h[i] = t.v[i];
  // q = floor((h + 19) / 2^255) is the number of p's to subtract, in
  // {-1, 0, 1} for a TIGHT value; computed by carrying 19*h9 estimate
  // through the limbs exactly as ref10's fe_tobytes.
  int64_t q = mochi_asr64(19 * h[9] + ((int64_t)1 << 24), 25);
  for (int i = 0; i < 10; ++i) q = mochi_asr64(h[i] + q, (i & 1) ? 25 : 26);
  h[0] += 19 * q;
  // exact carry chain (floor, not round): limbs land in [0, 2^bits), the
  // carry out of limb 9 is exactly the q*2^255 just accounted for.
  for (int i = 0; i < 9; ++i) {
    const int bits = (i & 1) ? 25 : 26;
    const int64_t c = mochi_asr64(h[i], bits);
    h[i + 1] += c;
    h[i] -= c * ((int64_t)1 << bits);
  }
  h[9] -= mochi_asr64(h[9], 25) * ((int64_t)1 << 25);
  for (int i = 0; i < 10; ++i) out->v[i] = (int32_t)h[i];
}

MOCHI_HD int fe_is_zero(const fe* f) {
  fe c;
  fe_canonical(&c, f);
  int32_t acc = 0;
  for (int i = 0; i < 10; ++i) acc |= c.v[i];
  return acc == 0;
}

MOCHI_HD int fe_eq(const fe* f, const fe* g) {
  fe d;
  fe_sub(&d, f, g);
  return fe_is_zero(&d);
}

// Parity of the canonical value (the x sign bit of RFC 8032).
MOCHI_HD int fe_parity(const fe* f) {
  fe c;
  fe_canonical(&c, f);
  return c.v[0] & 1;
}

// h = z^((p-5)/8) = z^(2^252 - 3): 250 squarings and 11 multiplies, the
// same addition chain as the reference's pow_p58.
MOCHI_HD void fe_pow22523(fe* out, const fe* z) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  fe_sq(&z2, z);                  // 2
  fe_sq_n(&t, &z2, 2);            // 8
  fe_mul(&z9, z, &t);             // 9
  fe_mul(&z11, &z2, &z9);         // 11
  fe_sq(&t, &z11);                // 22
  fe_mul(&z_5_0, &z9, &t);        // 2^5 - 1
  fe_sq_n(&t, &z_5_0, 5);
  fe_mul(&z_10_0, &t, &z_5_0);    // 2^10 - 1
  fe_sq_n(&t, &z_10_0, 10);
  fe_mul(&z_20_0, &t, &z_10_0);   // 2^20 - 1
  fe_sq_n(&t, &z_20_0, 20);
  fe_mul(&t, &t, &z_20_0);        // 2^40 - 1
  fe_sq_n(&t, &t, 10);
  fe_mul(&z_50_0, &t, &z_10_0);   // 2^50 - 1
  fe_sq_n(&t, &z_50_0, 50);
  fe_mul(&z_100_0, &t, &z_50_0);  // 2^100 - 1
  fe_sq_n(&t, &z_100_0, 100);
  fe_mul(&t, &t, &z_100_0);       // 2^200 - 1
  fe_sq_n(&t, &t, 50);
  fe_mul(&t, &t, &z_50_0);        // 2^250 - 1
  fe_sq_n(&t, &t, 2);
  fe_mul(out, &t, z);             // 2^252 - 3
}

// 17 little-endian 15-bit limbs (the reference package's public layout,
// each limb in [0, 2^15)) -> radix-2^25.5 limbs of the same value (< 2^255).
MOCHI_HD void fe_from_limbs15(fe* h, const int32_t* l15, int stride) {
  uint64_t w[4] = {0, 0, 0, 0};
  for (int i = 0; i < 17; ++i) {
    const uint64_t x = (uint64_t)(l15[i * stride] & 0x7fff);
    const int bit = 15 * i, word = bit >> 6, off = bit & 63;
    w[word] |= x << off;
    if (off > 49) w[word + 1] |= x >> (64 - off);
  }
  const int offs[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  for (int i = 0; i < 10; ++i) {
    const int bits = (i & 1) ? 25 : 26, word = offs[i] >> 6,
              off = offs[i] & 63;
    uint64_t x = w[word] >> off;
    if (off + bits > 64) x |= w[word + 1] << (64 - off);
    h->v[i] = (int32_t)(x & (((uint64_t)1 << bits) - 1));
  }
}
