// GF(2^255-19) in the reference package's 17 x 15-bit limbs, with the
// multiply's column reduction done as an exact integer matrix product on
// the tensor cores.  Counterpart of the reference's crypto/field.py under
// MOCHI_SKEW_IMPL=mxu (_mul_mxu, _build_mxu_matrix, _carry2, canonical).
//
// Layout and bounds are the reference's, proved in its field.py:
//   * a field element is 17 int32 limbs of weight 2^(15 i), each in
//     [0, LOOSE], LOOSE = 2^15 + 96, after every operation;
//   * a limb product is <= LOOSE^2 < 2^31, non-negative, and splits into
//     lo = p & 0x7fff (< 2^15) and hi = p >> 15 (<= 32965);
//   * column k sums the lo halves of the products with i + j = k and the
//     hi halves with i + j + 1 = k: at most 34 terms < 2^16, so < 2^21;
//   * the top 17 columns fold at 2^255 = 19 (< 20 * 2^21 < 2^26) and two
//     carry passes (carry2) bring every limb back to <= 32786 <= LOOSE.
// Exact reduction to [0, p) happens only in fe_canonical.
//
// The multiply (fe_mul).  The reference forms the 289 products, stacks lo
// and hi as a (578, B) operand and multiplies the constant (34, 578) 0/1
// matrix by it.  Here each product's two halves are split once more into
// bytes, (lo0, lo1, hi0, hi1), one 32-bit word per product, so that the
// reduction is a u8 x u8 -> s32 matrix product, which the tensor cores
// compute exactly:
//   * K runs over the products' bytes.  Products are taken column by
//     column (i + j = s), four to a half-step of K; a column's last
//     half-step is padded with empty (zero) products, so every half-step
//     holds one column, and two half-steps make one 32-byte k-step of the
//     MMA (43 steps, the last one half empty).
//   * M runs over 68 rows, row 2c + b for column c and byte plane b: byte
//     d of a product of column s lands in row 2s + d (lo at s, hi at s + 1,
//     each in planes 0 and 1).  So A[2s + d][k] = 1 for byte d of every
//     product of column s, else 0: the reference's matrix with each entry
//     split over two byte planes.  Rows are padded to 80 (5 tiles of 16).
//   * N runs over 32 signatures, one per lane of a warp.
//   * A plane row sums at most 34 bytes <= 255, < 2^14: s32 is exact.  The
//     column is row[2c] + 256 row[2c + 1] < 2^21, the reference's column.
// The kernel form (device) is warp-cooperative: each lane stages its own
// signature's product words in shared memory, 8 k-steps at a time; the
// warp loads them as B fragments with ldmatrix and runs
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 against A fragments built from
// the lane's row index; a (step, row tile) pair whose A tile is all zero is
// skipped at compile time (49 of the 215 pairs are live: 196 MMAs a
// multiply); each finished row tile goes to shared memory and every lane
// reads back its own 68 rows, recombines the planes, folds by 19 and runs
// carry2.  Every lane of the warp must call it together.  No kernel
// multiplies so any more: verify_mxu.cu, comb_mxu.cu and comb_tree_mxu.cu
// define MOCHI_FE17_TEAM and multiply with fe17_team.cuh's team form
// (four lanes a signature, each forming its products straight into the
// MMA's A fragments); the warp-wide form stays beside its serial twin,
// which the host tests hold against the plain multiply.  Only u8 operands
// with s32 accumulators are used, in either form: no f16, bf16, TF32 or
// f32 product, whose mantissas would truncate the sums (the reference pins
// precision=HIGHEST against the same trap on the TPU).  The host form is
// the serial twin: the same product words, the same live tiles and the
// same 0/1 entries, summed in loops for one signature; the CPU tests hold
// it limb for limb against the plain PyTorch _mul_mxu.
#pragma once

#include <stdint.h>

#include "fe25519.cuh"  // MOCHI_HD

#if defined(__CUDACC__)
#define MOCHI_HDC __host__ __device__ constexpr
#else
#define MOCHI_HDC static constexpr
#endif

#define MOCHI_FE17_MASK 0x7fff
#define MOCHI_FE17_LOOSE (32768 + 96)

struct fe17 {
  int32_t v[17];
};

// ------------------------------------------------------------- the schedule

#define MOCHI_MXU_STEPS 43  // k-steps of 32 bytes (8 products) a multiply
#define MOCHI_MXU_ROWS 68   // 34 columns x 2 byte planes
#define MOCHI_MXU_TILES 5   // row tiles of 16 (80 rows)

// Column s (0..32) holds the products i + j = s, i from fe17_col_lo(s).
MOCHI_HDC int fe17_col_lo(int s) { return s > 16 ? s - 16 : 0; }
MOCHI_HDC int fe17_col_n(int s) { return (s > 16 ? 32 - s : s) + 1; }

// Column of half-step h (four product slots); 33 for the padding half-step.
MOCHI_HDC int fe17_half_col(int h) {
  for (int s = 0; s <= 32; ++s) {
    const int n = (fe17_col_n(s) + 3) / 4;
    if (h < n) return s;
    h -= n;
  }
  return 33;
}

// Which of its column's half-steps h is.
MOCHI_HDC int fe17_half_index(int h) {
  for (int s = 0; s <= 32; ++s) {
    const int n = (fe17_col_n(s) + 3) / 4;
    if (h < n) return h;
    h -= n;
  }
  return 0;
}

// a-limb i of slot t (0..3) of half-step h (b-limb s - i), or -1 if empty.
MOCHI_HDC int fe17_slot_i(int h, int t) {
  const int s = fe17_half_col(h);
  const int i = fe17_col_lo(s) + 4 * fe17_half_index(h) + t;
  return s <= 32 && i < fe17_col_lo(s) + fe17_col_n(s) ? i : -1;
}

// Does row tile m (rows 16m .. 16m+15) receive anything at step st?  A
// half-step of column s writes rows 2s .. 2s+3.
MOCHI_HDC bool fe17_tile_live(int st, int m) {
  for (int h = 2 * st; h < 2 * st + 2; ++h) {
    const int s = fe17_half_col(h);
    if (s <= 32 && 2 * s + 3 >= 16 * m && 2 * s <= 16 * m + 15) return true;
  }
  return false;
}

MOCHI_HDC int fe17_first_step(int m) {
  for (int st = 0; st < MOCHI_MXU_STEPS; ++st)
    if (fe17_tile_live(st, m)) return st;
  return -1;
}

MOCHI_HDC int fe17_last_step(int m) {
  for (int st = MOCHI_MXU_STEPS - 1; st >= 0; --st)
    if (fe17_tile_live(st, m)) return st;
  return -1;
}

// The four A bytes a row takes from one product slot whose column's first
// row is d rows above it: byte d set (d in 0..3), else none.
MOCHI_HD uint32_t fe17_a_word(int d) {
  return d >= 0 && d <= 3 ? 1u << (8 * d) : 0u;
}

// A limb product (< 2^31) -> its word (lo0, lo1, hi0, hi1), low byte first.
MOCHI_HD uint32_t fe17_split(uint32_t p) {
  return (p & 0x7fffu) | ((p << 1) & 0xffff0000u);
}

// ----------------------------------------------------------------- carries

// floor(x / 2^k) without shifting a negative value.
MOCHI_HD int32_t mochi_asr32(int32_t x, int k) {
  return x >= 0 ? (x >> k) : ~((~x) >> k);
}

// One vectorized carry pass over non-negative columns: limb k+1 receives
// t[k] >> 15, limb 0 receives 19 t[16] >> 15 (the reference's _carry1).
MOCHI_HD void fe17_carry_pass(int32_t* t) {
  const int32_t top = t[16] >> 15;
  for (int k = 16; k > 0; --k) t[k] = (t[k] & MOCHI_FE17_MASK) + (t[k - 1] >> 15);
  t[0] = (t[0] & MOCHI_FE17_MASK) + 19 * top;
}

// Two passes (the reference's _carry2): columns in [0, 2^26) -> <= LOOSE.
MOCHI_HD void fe17_carry2(fe17* h, const int32_t* cols) {
  int32_t t[17];
  for (int k = 0; k < 17; ++k) t[k] = cols[k];
  fe17_carry_pass(t);
  fe17_carry_pass(t);
  for (int k = 0; k < 17; ++k) h->v[k] = t[k];
}

// Exact sequential carry (the reference's _carry_chain): limbs in
// [0, 2^15) and the signed carry out of limb 16.
MOCHI_HD int32_t fe17_carry_chain(int32_t* out, const int32_t* cols) {
  int32_t c = 0;
  for (int k = 0; k < 17; ++k) {
    const int32_t t = cols[k] + c;
    out[k] = t & MOCHI_FE17_MASK;
    c = mochi_asr32(t, 15);
  }
  return c;
}

// ---------------------------------------------------------- simple ops

MOCHI_HD void fe_0(fe17* h) {
  for (int i = 0; i < 17; ++i) h->v[i] = 0;
}

MOCHI_HD void fe_1(fe17* h) {
  fe_0(h);
  h->v[0] = 1;
}

MOCHI_HD void fe_copy(fe17* h, const fe17* f) {
  for (int i = 0; i < 17; ++i) h->v[i] = f->v[i];
}

// h = cond ? a : b, without a branch.
MOCHI_HD void fe_select(fe17* h, const fe17* a, const fe17* b, int cond) {
  const int32_t m = -(int32_t)(cond != 0);
  for (int i = 0; i < 17; ++i) h->v[i] = (a->v[i] & m) | (b->v[i] & ~m);
}

// Limbs in [0, 2^26) -> <= LOOSE (carry2).
MOCHI_HD void fe_carry(fe17* h, const fe17* f) { fe17_carry2(h, f->v); }

// a + b: columns <= 2 LOOSE <= 2^17, one pass.
MOCHI_HD void fe_add(fe17* h, const fe17* f, const fe17* g) {
  int32_t t[17];
  for (int i = 0; i < 17; ++i) t[i] = f->v[i] + g->v[i];
  fe17_carry_pass(t);
  for (int i = 0; i < 17; ++i) h->v[i] = t[i];
}

// a - b as a + 2p - b: every 2p limb (65498, 65534 x 16) exceeds a loose
// limb, so columns lie in [32634, 98398], one pass.
MOCHI_HD void fe_sub(fe17* h, const fe17* f, const fe17* g) {
  int32_t t[17];
  for (int i = 0; i < 17; ++i) t[i] = f->v[i] + ((i == 0 ? 65498 : 65534) - g->v[i]);
  fe17_carry_pass(t);
  for (int i = 0; i < 17; ++i) h->v[i] = t[i];
}

MOCHI_HD void fe_neg(fe17* h, const fe17* f) {
  fe17 z;
  fe_0(&z);
  fe_sub(h, &z, f);
}

// a * k for 0 <= k < 2^10: one pass for k <= 3, two below 2^10 (the
// reference's mul_small; larger constants take the full multiply there).
MOCHI_HD void fe_mul_small(fe17* h, const fe17* f, int k) {
  int32_t t[17];
  for (int i = 0; i < 17; ++i) t[i] = f->v[i] * k;
  fe17_carry_pass(t);
  if (k > 3) fe17_carry_pass(t);
  for (int i = 0; i < 17; ++i) h->v[i] = t[i];
}

// The unique representative < p (the reference's canonical).
MOCHI_HD void fe_canonical(fe17* out, const fe17* f) {
  int32_t l[17], d[17];
  const int32_t cout = fe17_carry_chain(l, f->v);
  l[0] += 19 * cout;
  fe17_carry_chain(l, l);
  for (int i = 0; i < 17; ++i) d[i] = l[i] - (i == 0 ? 32749 : 32767);
  const int32_t borrow = fe17_carry_chain(d, d);
  for (int i = 0; i < 17; ++i) out->v[i] = borrow >= 0 ? d[i] : l[i];
}

MOCHI_HD int fe_is_zero(const fe17* f) {
  fe17 c;
  fe_canonical(&c, f);
  int32_t acc = 0;
  for (int i = 0; i < 17; ++i) acc |= c.v[i];
  return acc == 0;
}

MOCHI_HD int fe_eq(const fe17* f, const fe17* g) {
  fe17 a, b;
  fe_canonical(&a, f);
  fe_canonical(&b, g);
  int32_t acc = 0;
  for (int i = 0; i < 17; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// 17 limbs of 15 bits, `stride` elements apart (the public layout).
MOCHI_HD void fe_from_limbs15(fe17* h, const int32_t* l15, int stride) {
  for (int i = 0; i < 17; ++i) h->v[i] = l15[i * stride] & MOCHI_FE17_MASK;
}

MOCHI_HD void fe_const_d(fe17* h) {
  const int32_t c[17] = {30883, 9906,  14120, 12122, 2743,  10299,
                         4944,  14341, 6144,  29649, 26077, 14851,
                         14540, 32718, 2779,  13943, 20995};
  for (int i = 0; i < 17; ++i) h->v[i] = c[i];
}

MOCHI_HD void fe_const_d2(fe17* h) {
  const int32_t c[17] = {29017, 19813, 28240, 24244, 5486,  20598,
                         9888,  28682, 12288, 26530, 19387, 29703,
                         29080, 32668, 5559,  27886, 9222};
  for (int i = 0; i < 17; ++i) h->v[i] = c[i];
}

MOCHI_HD void fe_const_sqrtm1(fe17* h) {
  const int32_t c[17] = {8368,  5149,  27805, 10096, 18316, 9724,
                         427,   8588,  10031, 30639, 25847, 26628,
                         12980, 15329, 5104,  4672,  11139};
  for (int i = 0; i < 17; ++i) h->v[i] = c[i];
}

// ----------------------------------------------------------------- multiply

// Rows of one signature -> the product: planes recombined, the top 17
// columns folded by 19, carry2.
MOCHI_HD void fe17_finish(fe17* h, const int32_t* row, int stride) {
  int32_t col[34], t[17];
  for (int c = 0; c < 34; ++c) col[c] = row[2 * c * stride] + 256 * row[(2 * c + 1) * stride];
  for (int k = 0; k < 17; ++k) t[k] = col[k] + 19 * col[k + 17];
  fe17_carry2(h, t);
}

// The serial twin: the kernel's product words, live tiles and A entries,
// summed in loops for one signature.
static inline void fe17_mul_serial(fe17* h, const fe17* f, const fe17* g) {
  int32_t rows[16 * MOCHI_MXU_TILES] = {0};
  for (int st = 0; st < MOCHI_MXU_STEPS; ++st) {
    uint8_t kb[32];
    for (int q = 0; q < 8; ++q) {
      const int hs = 2 * st + q / 4, i = fe17_slot_i(hs, q % 4);
      const uint32_t w =
          i < 0 ? 0u : fe17_split((uint32_t)(f->v[i] * g->v[fe17_half_col(hs) - i]));
      for (int b = 0; b < 4; ++b) kb[4 * q + b] = (uint8_t)(w >> (8 * b));
    }
    const int col[2] = {fe17_half_col(2 * st), fe17_half_col(2 * st + 1)};
    for (int m = 0; m < MOCHI_MXU_TILES; ++m) {
      if (!fe17_tile_live(st, m)) continue;
      for (int r = 16 * m; r < 16 * m + 16; ++r)
        for (int k = 0; k < 32; ++k) {
          const uint32_t a = fe17_a_word(r - 2 * col[k / 16]);
          rows[r] += (int32_t)((a >> (8 * (k & 3))) & 0xffu) * kb[k];
        }
    }
  }
  fe17_finish(h, rows, 1);
}

#if defined(__CUDACC__)

#define MOCHI_MXU_WARPS 2     // warps a block of the mxu kernels
#define MOCHI_MXU_CHUNK 8     // k-steps staged in shared memory at once
// Bytes of one signature's staging row: 8 steps x 32, plus 16 so that the
// eight rows an ldmatrix phase reads fall in eight different bank groups.
#define MOCHI_MXU_STAGE (MOCHI_MXU_CHUNK * 32 + 16)
// Words of one output row (32 signatures, plus 8 against bank conflicts
// of the accumulator stores).
#define MOCHI_MXU_OUT 40

struct fe17_mxu_smem {
  uint8_t stage[32 * MOCHI_MXU_STAGE];
  int32_t out[MOCHI_MXU_ROWS * MOCHI_MXU_OUT];
};

struct fe17_mxu_ctx {
  int32_t a[17], b[17];
  uint32_t fa[11];  // fe17_a_word(g - e) for e in -3..7, g = lane / 4
  int32_t acc[MOCHI_MXU_TILES][4][4];
  uint32_t bf[4][2];
  uint8_t* row;        // this lane's staging row
  uint32_t ld_addr;    // this lane's ldmatrix row address (shared window)
  int32_t* out;
  int lane;
};

__device__ __forceinline__ void fe17_mma(int32_t* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void fe17_ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int H, int T>
__device__ __forceinline__ uint32_t fe17_slot_word(const fe17_mxu_ctx& c) {
  constexpr int i = fe17_slot_i(H, T);
  if constexpr (i < 0) {
    return 0u;
  } else {
    constexpr int j = fe17_half_col(H) - i;
    return fe17_split((uint32_t)(c.a[i] * c.b[j]));
  }
}

// This lane's 32 bytes of step ST, at its place in the staged chunk.
template <int ST>
__device__ __forceinline__ void fe17_stage_step(fe17_mxu_ctx& c) {
  constexpr int h = 2 * ST;
  uint4* dst = reinterpret_cast<uint4*>(c.row + (ST % MOCHI_MXU_CHUNK) * 32);
  dst[0] = make_uint4(fe17_slot_word<h, 0>(c), fe17_slot_word<h, 1>(c),
                      fe17_slot_word<h, 2>(c), fe17_slot_word<h, 3>(c));
  dst[1] = make_uint4(fe17_slot_word<h + 1, 0>(c), fe17_slot_word<h + 1, 1>(c),
                      fe17_slot_word<h + 1, 2>(c), fe17_slot_word<h + 1, 3>(c));
}

template <int ST, int END>
__device__ __forceinline__ void fe17_stage_chunk(fe17_mxu_ctx& c) {
  fe17_stage_step<ST>(c);
  if constexpr (ST + 1 < END) fe17_stage_chunk<ST + 1, END>(c);
}

// The A register of rows 16M + g + 8*HI against a half-step of column S:
// fe17_a_word(g - E) with E = 2S - 16M - 8HI, zero outside E in -3..7.
template <int S, int M, int HI>
__device__ __forceinline__ uint32_t fe17_a_reg(const fe17_mxu_ctx& c) {
  constexpr int e = 2 * S - 16 * M - 8 * HI;
  if constexpr (S > 32 || e < -3 || e > 7) {
    return 0u;
  } else {
    return c.fa[e + 3];
  }
}

template <int ST, int M>
__device__ __forceinline__ void fe17_tile(fe17_mxu_ctx& c) {
  if constexpr (fe17_tile_live(ST, M)) {
    if constexpr (ST == fe17_first_step(M)) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) c.acc[M][t][k] = 0;
    }
    constexpr int sa = fe17_half_col(2 * ST), sb = fe17_half_col(2 * ST + 1);
    const uint32_t a0 = fe17_a_reg<sa, M, 0>(c), a1 = fe17_a_reg<sa, M, 1>(c);
    const uint32_t a2 = fe17_a_reg<sb, M, 0>(c), a3 = fe17_a_reg<sb, M, 1>(c);
#pragma unroll
    for (int t = 0; t < 4; ++t) fe17_mma(c.acc[M][t], a0, a1, a2, a3, c.bf[t][0], c.bf[t][1]);
    if constexpr (ST == fe17_last_step(M)) {
      // rows 16M + g and 16M + g + 8, signatures 8t + 2*(lane % 4) + {0, 1}
      const int g = c.lane >> 2, col = 2 * (c.lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = 16 * M + g + 8 * hi;
        if (r < MOCHI_MXU_ROWS) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            *reinterpret_cast<int2*>(&c.out[r * MOCHI_MXU_OUT + 8 * t + col]) =
                make_int2(c.acc[M][t][2 * hi], c.acc[M][t][2 * hi + 1]);
        }
      }
    }
  }
}

template <int ST>
__device__ __forceinline__ void fe17_steps(fe17_mxu_ctx& c) {
  if constexpr (ST % MOCHI_MXU_CHUNK == 0) {
    if constexpr (ST > 0) __syncwarp();  // the last chunk's fragments are read
    constexpr int end =
        ST + MOCHI_MXU_CHUNK < MOCHI_MXU_STEPS ? ST + MOCHI_MXU_CHUNK : MOCHI_MXU_STEPS;
    fe17_stage_chunk<ST, end>(c);
    __syncwarp();  // the chunk is staged
  }
  // B fragments of the four signature tiles: matrices (tile, k 0-15),
  // (tile, k 16-31) for tiles 0-1, then tiles 2-3 (16 rows further on).
  uint32_t r[4];
  fe17_ldmatrix_x4(r, c.ld_addr + (ST % MOCHI_MXU_CHUNK) * 32);
  c.bf[0][0] = r[0];
  c.bf[0][1] = r[1];
  c.bf[1][0] = r[2];
  c.bf[1][1] = r[3];
  fe17_ldmatrix_x4(r, c.ld_addr + (ST % MOCHI_MXU_CHUNK) * 32 + 16 * MOCHI_MXU_STAGE);
  c.bf[2][0] = r[0];
  c.bf[2][1] = r[1];
  c.bf[3][0] = r[2];
  c.bf[3][1] = r[3];
  fe17_tile<ST, 0>(c);
  fe17_tile<ST, 1>(c);
  fe17_tile<ST, 2>(c);
  fe17_tile<ST, 3>(c);
  fe17_tile<ST, 4>(c);
  if constexpr (ST + 1 < MOCHI_MXU_STEPS) fe17_steps<ST + 1>(c);
}

#if !defined(MOCHI_FE17_TEAM)
// The warp's multiply: lane l's f * g of its own signature.  All 32 lanes
// call it together, on blocks of 32 * MOCHI_MXU_WARPS threads.  Operands
// and result pass by value, so no pointer into the caller's frame crosses
// the call: with pointer operands, the ladder's block-scoped temporaries
// reached this call with the wrong contents on the card, while every
// multiply on its own was right.
__device__ __noinline__ fe17 fe17_mul_warp(const fe17 f, const fe17 g) {
  __shared__ __align__(16) fe17_mxu_smem smem[MOCHI_MXU_WARPS];
  fe17_mxu_smem& sm = smem[threadIdx.x >> 5];
  fe17_mxu_ctx c;
  c.lane = threadIdx.x & 31;
  for (int i = 0; i < 17; ++i) {
    c.a[i] = f.v[i];
    c.b[i] = g.v[i];
  }
  for (int e = -3; e <= 7; ++e) c.fa[e + 3] = fe17_a_word((c.lane >> 2) - e);
  c.row = sm.stage + c.lane * MOCHI_MXU_STAGE;
  c.out = sm.out;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8; matrix m covers
  // signatures 8 (m / 2) .. +7 and bytes 16 (m % 2) .. +15 of a step
  const int mat = c.lane >> 3;
  c.ld_addr = (uint32_t)__cvta_generic_to_shared(
      sm.stage + (8 * (mat >> 1) + (c.lane & 7)) * MOCHI_MXU_STAGE + 16 * (mat & 1));
  __syncwarp();  // every lane is here; the last multiply's reads are done
  // mma.sync and ldmatrix are warp-wide: a caller that let its lanes diverge
  // would get garbage, so it gets a fault instead
  if (__activemask() != 0xffffffffu) __trap();
  fe17_steps<0>(c);
  __syncwarp();  // every row tile is stored
  fe17 h;
  fe17_finish(&h, sm.out + c.lane, MOCHI_MXU_OUT);
  return h;
}
#endif  // MOCHI_FE17_TEAM

#endif  // __CUDACC__

#if defined(MOCHI_FE17_TEAM)
// A kernel that defines MOCHI_FE17_TEAM (verify_mxu.cu, comb_mxu.cu,
// comb_tree_mxu.cu)
// multiplies with fe17_team.cuh's team multiply instead: a team of four
// lanes a signature, eight signatures a warp, one multiply a call or two
// (fe_mul2).  It
// includes that header after this one, which also holds the host twins.
struct fe17_pair {
  fe17 a, b;
};
#if defined(__CUDACC__)
__device__ __noinline__ fe17 fe17_mul_team(const fe17 f, const fe17 g);
__device__ __noinline__ fe17_pair fe17_mul2_team(const fe17 f1, const fe17 g1, const fe17 f2,
                                                 const fe17 g2);
#endif
static inline void fe17_mul_team_host(fe17* h, const fe17* f, const fe17* g);
static inline void fe17_mul2_team_host(fe17* h1, const fe17* f1, const fe17* g1, fe17* h2,
                                       const fe17* f2, const fe17* g2);
#endif

// h = f * g.  Inputs <= LOOSE, output <= LOOSE.
#if defined(__CUDACC__)
__host__ __device__ inline
#else
static inline
#endif
void fe_mul(fe17* h, const fe17* f, const fe17* g) {
#if defined(__CUDA_ARCH__) && defined(MOCHI_FE17_TEAM)
  *h = fe17_mul_team(*f, *g);
#elif defined(__CUDA_ARCH__)
  *h = fe17_mul_warp(*f, *g);
#elif defined(MOCHI_FE17_TEAM)
  fe17_mul_team_host(h, f, g);
#else
  fe17_mul_serial(h, f, g);
#endif
}

#if defined(MOCHI_FE17_TEAM)
// h1 = f1 * g1 and h2 = f2 * g2, independent multiplies of one signature
// in one team call (the outputs may alias any input).
#if defined(__CUDACC__)
__host__ __device__ inline
#else
static inline
#endif
void fe_mul2(fe17* h1, const fe17* f1, const fe17* g1, fe17* h2, const fe17* f2, const fe17* g2) {
#if defined(__CUDA_ARCH__)
  const fe17_pair r = fe17_mul2_team(*f1, *g1, *f2, *g2);
  *h1 = r.a;
  *h2 = r.b;
#else
  fe17_mul2_team_host(h1, f1, g1, h2, f2, g2);
#endif
}
#endif

// h = f^2 as f * f, as the reference squares under MOCHI_SKEW_IMPL=mxu.
MOCHI_HD void fe_sq(fe17* h, const fe17* f) { fe_mul(h, f, f); }

MOCHI_HD void fe_sq_n(fe17* h, const fe17* f, int n) {
  fe_sq(h, f);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int i = 1; i < n; ++i) fe_sq(h, h);
}

// The decode's parity flip without a branch.
MOCHI_HD void fe_neg_if(fe17* x, int cond) {
  fe17 t;
  fe_neg(&t, x);
  fe_select(x, &t, x, cond);
}

// The decode's sqrt(-1) fix-up without a branch: every lane multiplies.
MOCHI_HD void fe_mul_sqrtm1_if(fe17* x, int cond) {
  fe17 s, t;
  fe_const_sqrtm1(&s);
  fe_mul(&t, x, &s);
  fe_select(x, &t, x, cond);
}

// z^((p-5)/8) = z^(2^252 - 3): the reference's pow_p58 chain.
MOCHI_HD void fe_pow22523(fe17* out, const fe17* z) {
  fe17 z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
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
