// The known-signer comb's tables and their gathers, shared by the comb
// kernels (comb_team.cuh for comb.cu, comb_tree.cuh, comb17.cuh) and by
// verify25519.cuh's [S]B.  Counterpart of the reference package's
// comb.verify_comb_prepared (impl="chain"):
//
//   Q = sum_w  [s_w 16^w]B  +  [h_w 16^w](-A)        w = 0..63
//
// with both terms read from precomputed Niels tables (the signer's rows
// from the registry's table, the basepoint's from the constant comb), so
// the check is 128 mixed additions and no doublings; then R's RFC 8032
// decode and the projective compare X_Q == x_R Z_Q, Y_Q == y_R Z_Q.  A is
// not decoded: the registry decoded it on the host at registration.
//
// Table layout (kernel radix, fe25519.cuh): one Niels entry is three field
// elements (y+x, y-x, 2dxy) of ten int32 limbs, 30 int32 = 120 bytes; the
// signer table holds 576 entries per signer (entry w*9 + d = [d 16^w](-A)),
// the basepoint comb the same 576 entries for +B.  Entries are canonical
// (limbs in [0, 2^26) / [0, 2^25)).
//
// Bounds of the Niels negation.  A negative digit reuses entry |d| with
// y+x and y-x swapped and 2dxy negated, so that coordinate's limbs are in
// (-2^26, 0] / (-2^25, 0].  Table coordinates only ever enter fe_mul (in
// ge_madd), which takes LOOSE limbs of either sign (|even| <=
// MOCHI_LOOSE_EVEN = 110729625 > 2^26, |odd| <= MOCHI_LOOSE_ODD = 55364812
// > 2^25), so canonical and negated-canonical entries are both within its
// bound; the point Q stays TIGHT (every coordinate is an fe_mul output).
// tests/test_torch_kernel_host.py fuzzes ge_madd with such entries against
// the formula on Python integers, with Q's limbs at the TIGHT maximum.
#pragma once

#include "ge25519.cuh"

#define MOCHI_COMB_WINDOWS 64
#define MOCHI_COMB_ENTRIES 9
#define MOCHI_COMB_ROWS_PER_SIGNER (MOCHI_COMB_WINDOWS * MOCHI_COMB_ENTRIES)
#define MOCHI_COMB_ENTRY_INTS 30

#if defined(__CUDA_ARCH__)
#define MOCHI_LDG(p) __ldg(p)
#else
#define MOCHI_LDG(p) (*(p))
#endif

// One table entry -> Niels point, negated when `neg` (swap y+x / y-x,
// negate 2dxy).
MOCHI_HD void comb_load_niels(ge_niels* n, const int32_t* e, int neg) {
  for (int i = 0; i < 10; ++i) {
    const int32_t ypx = MOCHI_LDG(&e[i]);
    const int32_t ymx = MOCHI_LDG(&e[10 + i]);
    const int32_t xy2d = MOCHI_LDG(&e[20 + i]);
    n->ypx.v[i] = neg ? ymx : ypx;
    n->ymx.v[i] = neg ? ypx : ymx;
    n->xy2d.v[i] = neg ? -xy2d : xy2d;
  }
}

// Row of signer `key_idx`, window w, magnitude mag in a table of `rows`
// entries, clipped into [0, rows) exactly as the reference's
// jnp.take(..., mode="clip") clips its flat index (padding lanes carry
// index 0; an index past the table reads its last row, never past it).
MOCHI_HD int64_t comb_row(int64_t rows, int key_idx, int w, int mag) {
  int64_t flat = (int64_t)key_idx * MOCHI_COMB_ROWS_PER_SIGNER +
                 w * MOCHI_COMB_ENTRIES + mag;
  if (flat < 0) flat = 0;
  if (flat >= rows) flat = rows - 1;
  return flat;
}
