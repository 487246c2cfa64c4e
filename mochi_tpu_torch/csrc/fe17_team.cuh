// The mxu field multiply for a team of four lanes a signature, eight
// signatures a warp: each lane forms its share of the limb products in its
// own registers and hands them straight to the tensor cores.  verify_mxu.cu,
// comb_mxu.cu and comb_tree_mxu.cu define MOCHI_FE17_TEAM, so fe17.cuh's
// fe_mul calls fe17_mul_team on the card.
//
// The product is the one fe17.cuh describes: the 289 limb products, each
// split into its word (lo0, lo1, hi0, hi1), reduced by the constant 0/1
// matrix to 68 byte-plane rows (row 2c + b: byte plane b of column c) in
// u8 x u8 -> s32 MMAs, then planes recombined, the top 17 columns folded by
// 19 and carry2.  The schedule is fe17.cuh's too: 43 k-steps of two
// half-steps, a half-step four products of one column (fe17_slot_i).  What
// changes is which operand is which.  With g = lane / 4 and t = lane % 4,
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 gives lane (g, t)
//   A (16 x 32, row-major):    a0 = A[g][4t..4t+3], a2 = A[g][16+4t..16+4t+3],
//                              a1, a3 the same bytes of row g + 8;
//   B (32 x 8, column-major):  b0 = B[4t..4t+3][g], b1 = B[16+4t..16+4t+3][g];
//   D (16 x 8):                d0 = D[g][2t], d1 = D[g][2t+1], d2, d3 row g + 8
// (PTX ISA, matrix fragments for mma.m16n8k32 with .u8 operands).  So:
//   * A's rows are signatures, its K bytes the step's product words: a0 is
//     exactly the word of slot t of the step's first half-step and a2 of
//     its second.  Lane t of signature g's team computes those two words in
//     its registers; no staging, no ldmatrix.  Rows g + 8 are zero.
//   * B is the 0/1 matrix: n-tile j covers output rows 8j..8j+7, and byte d
//     of a half-step of column s lands in row 2s + d, so b0 =
//     fe17_a_word(8j + g - 2s): an entry of the same 11-word table per lane
//     (fa) the warp-wide multiply builds.  68 rows make 9 n-tiles.
//   * D's two registers of lane (g, t) in n-tile j are rows 8j + 2t and
//     8j + 2t + 1 of signature g: both byte planes of column 4j + t.  So
//     column c lands in lane c % 4 of its team, whole, with no shared memory.
// Of the 43 x 9 (step, n-tile) pairs 57 receive anything (fe17_ntile_live);
// only those are issued, chosen at compile time: 57 MMAs a multiply a warp
// of 8, against fe17_mul_warp's 196 a warp of 32.
//
// Two multiplies a call.  Rows g + 8 of A are free, so fe17_mul2_team (the
// curve code's fe_mul2) puts a second, independent multiply of the same
// signature there (a1, a3) and reads its columns from D's d2, d3: the same
// 57 MMAs serve both, and the two chains of products, folds and shuffles
// overlap in one call.  A signature's verify makes 1,308 such calls and
// 817 of one multiply (ge25519.cuh under MOCHI_FE17_TEAM); its comb chain
// (comb17.cuh) 385 and 403; its comb tree (comb_tree17.cuh, 4 teams) 420
// and 411 over its teams.
//
// Each lane's products.  Lane t needs f[i] g[s - i] with i = i0 + t for a
// half-step whose slot 0 takes a-limb i0, column s.  A register array
// cannot be indexed by the lane's t without going to local memory, so each
// lane first shifts its operands by t: F[k] = f[k + t] and G[k] = g[k - t],
// zero past either end (two rounds of selects).  Then every product is
// F[i0] G[s - i0] at indices known at compile time, and a slot past its
// column's last product (i > 16 or s - i < 0) meets a zero.  Lanes t = 0..3
// form 85, 76, 68 and 60 nonzero products; every lane issues 86.
//
// The finish.  Lane t holds columns t, t + 4, ..., t + 32.  Limb k = 4m + t
// of the fold needs column k + 17, which lane t + 1 (mod 4) holds: one
// shuffle a limb-slot (5).  carry2's two passes run on the lanes' own limbs,
// each limb's carry from the lane below (5 shuffles a pass), and then every
// lane gathers the 17 limbs from the team (17 shuffles), so every team lane
// returns the whole product, as the curve code expects of a field element.
// Column bounds are fe17.cuh's (a plane row sums at most 34 bytes, a column
// < 2^21, a folded limb < 2^26); the passes are fe17_carry_pass's.
//
// The twin.  The multiply is written once over a lane policy LN, as
// verify25519.cuh and comb_team.cuh are: lane-private values are arrays of
// LN::N.  On the card (fe17_warp_lanes) a thread is one lane, mma() is the
// MMA instruction and shfl() is __shfl_sync within the team.  On the host
// (fe17_serial_lanes) one thread plays the warp's 32 lanes: mma() rebuilds
// A, B and D from every lane's fragments by the mapping above and sums the
// product in loops, shfl() reads the source lane's array entry.  The CPU
// tests hold that twin limb for limb against the plain _mul_mxu.
#pragma once

#include <stdint.h>

#include "fe17.cuh"

#define MOCHI_TEAM17_NTILES 9  // n-tiles of 8 output rows (72 >= 68)

#if defined(__CUDACC__)
#define MOCHI_T17_MEMBER __host__ __device__ __forceinline__
#else
#define MOCHI_T17_MEMBER inline
#endif

// Does n-tile j (output rows 8j .. 8j+7) receive anything at step st?  A
// half-step of column s writes rows 2s .. 2s+3.
MOCHI_HDC bool fe17_ntile_live(int st, int j) {
  for (int h = 2 * st; h < 2 * st + 2; ++h) {
    const int s = fe17_half_col(h);
    if (s <= 32 && 2 * s + 3 >= 8 * j && 2 * s <= 8 * j + 7) return true;
  }
  return false;
}

// D (16 x 8 s32) += A (16 x 32 u8) B (32 x 8 u8), from and to the 32
// lanes' fragments as PTX lays out mma.m16n8k32 with .u8 operands (see the
// header): d[lane][0..3], a0..a3[lane], b0, b1[lane].
MOCHI_HD void fe17_mma_serial(int32_t (*d)[4], const uint32_t* a0, const uint32_t* a1,
                              const uint32_t* a2, const uint32_t* a3, const uint32_t* b0,
                              const uint32_t* b1) {
  uint8_t A[16][32], B[32][8];
  int32_t D[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int b = 0; b < 4; ++b) {
      A[g][4 * t + b] = (uint8_t)(a0[l] >> (8 * b));
      A[g + 8][4 * t + b] = (uint8_t)(a1[l] >> (8 * b));
      A[g][16 + 4 * t + b] = (uint8_t)(a2[l] >> (8 * b));
      A[g + 8][16 + 4 * t + b] = (uint8_t)(a3[l] >> (8 * b));
      B[4 * t + b][g] = (uint8_t)(b0[l] >> (8 * b));
      B[16 + 4 * t + b][g] = (uint8_t)(b1[l] >> (8 * b));
    }
    D[g][2 * t] = d[l][0];
    D[g][2 * t + 1] = d[l][1];
    D[g + 8][2 * t] = d[l][2];
    D[g + 8][2 * t + 1] = d[l][3];
  }
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 8; ++c)
      for (int k = 0; k < 32; ++k) D[r][c] += (int32_t)A[r][k] * (int32_t)B[k][c];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    d[l][0] = D[g][2 * t];
    d[l][1] = D[g][2 * t + 1];
    d[l][2] = D[g + 8][2 * t];
    d[l][3] = D[g + 8][2 * t + 1];
  }
}

// One thread plays the warp's 32 lanes: the serial twin.
struct fe17_serial_lanes {
  static constexpr int N = 32;
  MOCHI_T17_MEMBER int lane(int l) const { return l; }
  MOCHI_T17_MEMBER void mma(int32_t (*d)[4], const uint32_t* a0, const uint32_t* a1,
                            const uint32_t* a2, const uint32_t* a3, const uint32_t* b0,
                            const uint32_t* b1) const {
    fe17_mma_serial(d, a0, a1, a2, a3, b0, b1);
  }
  // out[l] = in[lane src[l] of l's team]
  MOCHI_T17_MEMBER void shfl(int32_t* out, const int32_t* in, const int* src) const {
    int32_t v[32];
    for (int l = 0; l < 32; ++l) v[l] = in[l];
    for (int l = 0; l < 32; ++l) out[l] = v[(l & ~3) | src[l]];
  }
};

// The card's lanes: one thread a lane of a converged warp.
struct fe17_warp_lanes {
  static constexpr int N = 1;
  MOCHI_T17_MEMBER int lane(int) const {
#if defined(__CUDA_ARCH__)
    return threadIdx.x & 31;
#else
    return 0;
#endif
  }
  MOCHI_T17_MEMBER void mma(int32_t (*d)[4], const uint32_t* a0, const uint32_t* a1,
                            const uint32_t* a2, const uint32_t* a3, const uint32_t* b0,
                            const uint32_t* b1) const {
#if defined(__CUDA_ARCH__)
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
        : "r"(a0[0]), "r"(a1[0]), "r"(a2[0]), "r"(a3[0]), "r"(b0[0]), "r"(b1[0]));
#endif
  }
  MOCHI_T17_MEMBER void shfl(int32_t* out, const int32_t* in, const int* src) const {
#if defined(__CUDA_ARCH__)
    out[0] = __shfl_sync(0xffffffffu, in[0], src[0], 4);
#endif
  }
};

// Each lane's registers of one call: P multiplies of one signature (1, or
// 2 sharing the MMAs: the second's words in rows g + 8, a1 and a3).
template <int N, int P>
struct fe17_team_regs {
  int32_t F[P][N][17], G[P][N][17];  // f shifted down by t, g up by t, zero-filled
  uint32_t fa[N][11];                // fe17_a_word(g - e) for e in -3..7
  int32_t acc[MOCHI_TEAM17_NTILES][N][4];
};

// Lane l's word of its slot of half-step H in multiply p: f[i] g[s - i]
// split, i = i0 + t.
template <int H, int N, int P>
MOCHI_HD uint32_t fe17_team_word(const fe17_team_regs<N, P>& c, int p, int l) {
  constexpr int s = fe17_half_col(H);
  if constexpr (s > 32) {
    return 0u;
  } else {
    constexpr int i0 = fe17_slot_i(H, 0);
    return fe17_split((uint32_t)(c.F[p][l][i0] * c.G[p][l][s - i0]));
  }
}

// Lane l's B bytes of n-tile J against a half-step of column S.
template <int S, int J, int N, int P>
MOCHI_HD uint32_t fe17_team_b(const fe17_team_regs<N, P>& c, int l) {
  constexpr int e = 2 * S - 8 * J;
  if constexpr (S > 32 || e < -3 || e > 7) {
    return 0u;
  } else {
    return c.fa[l][e + 3];
  }
}

// a[0..3][l]: lane l's A registers a0..a3 of the step.
template <int ST, int J, class LN, int P>
MOCHI_HD void fe17_team_tiles(const LN& ln, fe17_team_regs<LN::N, P>& c, uint32_t (*a)[LN::N]) {
  if constexpr (fe17_ntile_live(ST, J)) {
    constexpr int sa = fe17_half_col(2 * ST), sb = fe17_half_col(2 * ST + 1);
    uint32_t b0[LN::N], b1[LN::N];
    for (int l = 0; l < LN::N; ++l) {
      b0[l] = fe17_team_b<sa, J>(c, l);
      b1[l] = fe17_team_b<sb, J>(c, l);
    }
    ln.mma(c.acc[J], a[0], a[1], a[2], a[3], b0, b1);
  }
  if constexpr (J + 1 < MOCHI_TEAM17_NTILES) fe17_team_tiles<ST, J + 1>(ln, c, a);
}

template <int ST, class LN, int P>
MOCHI_HD void fe17_team_steps(const LN& ln, fe17_team_regs<LN::N, P>& c) {
  uint32_t a[4][LN::N];
  for (int l = 0; l < LN::N; ++l) {
    a[0][l] = fe17_team_word<2 * ST>(c, 0, l);
    a[2][l] = fe17_team_word<2 * ST + 1>(c, 0, l);
    a[1][l] = P == 2 ? fe17_team_word<2 * ST>(c, P - 1, l) : 0u;
    a[3][l] = P == 2 ? fe17_team_word<2 * ST + 1>(c, P - 1, l) : 0u;
  }
  fe17_team_tiles<ST, 0>(ln, c, a);
  if constexpr (ST + 1 < MOCHI_MXU_STEPS) fe17_team_steps<ST + 1>(ln, c);
}

// Each lane's shifted operands of multiply p.
template <class LN, int P>
MOCHI_HD void fe17_team_operands(const LN& ln, fe17_team_regs<LN::N, P>& c, int p, const fe17* f,
                                 const fe17* g) {
  for (int l = 0; l < LN::N; ++l) {
    const int t = ln.lane(l) & 3;
    int32_t x[17], y[17];
    for (int k = 0; k < 17; ++k) {
      x[k] = (t & 1) ? (k + 1 <= 16 ? f[l].v[k + 1] : 0) : f[l].v[k];
      y[k] = (t & 1) ? (k >= 1 ? g[l].v[k - 1] : 0) : g[l].v[k];
    }
    for (int k = 0; k < 17; ++k) {
      c.F[p][l][k] = (t & 2) ? (k + 2 <= 16 ? x[k + 2] : 0) : x[k];
      c.G[p][l][k] = (t & 2) ? (k >= 2 ? y[k - 2] : 0) : y[k];
    }
  }
}

// Each lane's B table and the accumulators cleared.  fa[e + 3] is bytes
// e .. e + 3 of the one-hot X = 2^(8 g): a funnel shift each.
template <class LN, int P>
MOCHI_HD void fe17_team_clear(const LN& ln, fe17_team_regs<LN::N, P>& c) {
  for (int l = 0; l < LN::N; ++l) {
    const int gs = ln.lane(l) >> 2;
    const uint64_t x = (uint64_t)1 << (8 * gs);
    for (int e = -3; e <= 7; ++e) c.fa[l][e + 3] = (uint32_t)(e < 0 ? x << (-8 * e) : x >> (8 * e));
    for (int j = 0; j < MOCHI_TEAM17_NTILES; ++j)
      for (int q = 0; q < 4; ++q) c.acc[j][l][q] = 0;
  }
}

// h[p] = f[p] * g[p] for every lane, p < P: lanes 4g .. 4g+3 hold
// signature g's operands and all receive its products.  Inputs <= LOOSE,
// outputs <= LOOSE.  The columns of multiply p are D's registers 2p, 2p + 1.
template <int P, class LN>
MOCHI_HD void fe17_team_muls(const LN& ln, fe17* const* h, const fe17* const* f, const fe17* const* g) {
  constexpr int N = LN::N;
  fe17_team_regs<N, P> c;
  for (int p = 0; p < P; ++p) fe17_team_operands(ln, c, p, f[p], g[p]);
  fe17_team_clear(ln, c);
  fe17_team_steps<0>(ln, c);
  for (int p = 0; p < P; ++p) {
    // lane t's columns 4j + t: both byte planes of n-tile j, recombined
    int32_t col[N][MOCHI_TEAM17_NTILES + 1];
    for (int l = 0; l < N; ++l) {
      for (int j = 0; j < MOCHI_TEAM17_NTILES; ++j)
        col[l][j] = c.acc[j][l][2 * p] + 256 * c.acc[j][l][2 * p + 1];
      col[l][MOCHI_TEAM17_NTILES] = 0;
    }
    // fold by 19: limb 4m + t takes column 4m + t + 17 from lane t + 1
    // (mod 4), which holds it at m + 4 (m + 5 when that lane is lane 0)
    int32_t fold[N][5], send[N], got[N];
    int src[N];
    for (int m = 0; m < 5; ++m) {
      for (int l = 0; l < N; ++l) {
        const int t = ln.lane(l) & 3;
        send[l] = t == 0 ? col[l][m + 5] : col[l][m + 4];
        src[l] = (t + 1) & 3;
      }
      ln.shfl(got, send, src);
      for (int l = 0; l < N; ++l) fold[l][m] = col[l][m] + 19 * got[l];
    }
    // carry2, spread over the team: in each pass limb 4m + t keeps its low
    // 15 bits and takes the carry of limb 4m + t - 1 from lane t - 1 (mod
    // 4), slot m (slot m - 1 from lane 3 when t = 0); limb 0 takes 19 times
    // the carry of limb 16, lane 0's own slot 4.  Slots past limb 16 (slot 4
    // of lanes 1-3) never feed a limb.
    for (int pass = 0; pass < 2; ++pass) {
      int32_t next[N][5];
      for (int m = 0; m < 5; ++m) {
        for (int l = 0; l < N; ++l) {
          const int t = ln.lane(l) & 3;
          send[l] = t == 3 ? (m > 0 ? fold[l][m - 1] : 0) : fold[l][m];
          src[l] = (t + 3) & 3;
        }
        ln.shfl(got, send, src);
        for (int l = 0; l < N; ++l) {
          const int t = ln.lane(l) & 3;
          next[l][m] = (fold[l][m] & MOCHI_FE17_MASK) + (got[l] >> 15) +
                       (m == 0 && t == 0 ? 19 * (fold[l][4] >> 15) : 0);
        }
      }
      for (int l = 0; l < N; ++l)
        for (int m = 0; m < 5; ++m) fold[l][m] = next[l][m];
    }
    // every lane gathers the 17 limbs (limb k from lane k % 4)
    for (int k = 0; k < 17; ++k) {
      for (int l = 0; l < N; ++l) {
        send[l] = fold[l][k >> 2];
        src[l] = k & 3;
      }
      ln.shfl(got, send, src);
      for (int l = 0; l < N; ++l) h[p][l].v[k] = got[l];
    }
  }
}

// h = f * g for every lane (one multiply a call).
template <class LN>
MOCHI_HD void fe17_team_mul(const LN& ln, fe17* h, const fe17* f, const fe17* g) {
  fe17* const hp[1] = {h};
  const fe17* const fp[1] = {f};
  const fe17* const gp[1] = {g};
  fe17_team_muls<1>(ln, hp, fp, gp);
}

// The host twin for one signature: every team of the played warp
// multiplies f * g (and f2 * g2); lane 0's products.  fe17.cuh's fe_mul
// and fe_mul2 call them on the host where MOCHI_FE17_TEAM is defined, so
// the g++ build of the whole verify runs every multiply through the team's
// code.
static inline void fe17_mul_team_host(fe17* h, const fe17* f, const fe17* g) {
  fe17 fs[32], gs[32], hs[32];
  for (int l = 0; l < 32; ++l) {
    fs[l] = *f;
    gs[l] = *g;
  }
  fe17_team_mul(fe17_serial_lanes(), hs, fs, gs);
  *h = hs[0];
}

static inline void fe17_mul2_team_host(fe17* h1, const fe17* f1, const fe17* g1, fe17* h2,
                                       const fe17* f2, const fe17* g2) {
  fe17 fs[2][32], gs[2][32], hs[2][32];
  for (int l = 0; l < 32; ++l) {
    fs[0][l] = *f1, gs[0][l] = *g1;
    fs[1][l] = *f2, gs[1][l] = *g2;
  }
  fe17* const hp[2] = {hs[0], hs[1]};
  const fe17* const fp[2] = {fs[0], fs[1]};
  const fe17* const gp[2] = {gs[0], gs[1]};
  fe17_team_muls<2>(fe17_serial_lanes(), hp, fp, gp);
  *h1 = hs[0][0];
  *h2 = hs[1][0];
}

#if defined(__CUDACC__) && defined(MOCHI_FE17_TEAM)
// The card's team multiply: lane l's f * g of its team's signature.  All 32
// lanes call it together (mma.sync and the shuffles are warp-wide: a caller
// that let its lanes diverge gets a fault, not garbage).  By value, as
// fe17_mul_warp, so no pointer into the caller's frame crosses the call.
__device__ __noinline__ fe17 fe17_mul_team(const fe17 f, const fe17 g) {
  if (__activemask() != 0xffffffffu) __trap();
  fe17 h;
  fe17_team_mul(fe17_warp_lanes(), &h, &f, &g);
  return h;
}

// Two independent multiplies of one signature in one call: the second's
// words ride rows g + 8 of the same 57 MMAs, and the two chains overlap.
__device__ __noinline__ fe17_pair fe17_mul2_team(const fe17 f1, const fe17 g1, const fe17 f2,
                                                 const fe17 g2) {
  if (__activemask() != 0xffffffffu) __trap();
  fe17_pair r;
  fe17* const hp[2] = {&r.a, &r.b};
  const fe17* const fp[2] = {&f1, &f2};
  const fe17* const gp[2] = {&g1, &g2};
  fe17_team_muls<2>(fe17_warp_lanes(), hp, fp, gp);
  return r;
}
#endif
