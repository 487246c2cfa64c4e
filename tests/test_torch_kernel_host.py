"""The CUDA kernels' arithmetic, compiled for the host and fuzzed.

``mochi_tpu_torch/csrc/fe25519.cuh``, ``ge25519.cuh``, ``comb25519.cuh``,
``comb_tree.cuh``, ``fe17.cuh``, ``comb17.cuh`` and ``comb_tree17.cuh`` are plain
``__host__ __device__`` code,
so ``g++`` builds them here into small ctypes libraries (the test-only
shims below), with
``-fwrapv`` so that a signed int32 overflow wraps as it does on the card.
The fuzz holds every field op against Python integers, with inputs at the
edges of the bounds the header states (maximum loose limbs, every sign
pattern), and decode, the comb's
negated-Niels mixed addition, the whole comb verify, the tree's leaf
conversion, its 7-level sum and its whole verify against Python integers
and the port's plain PyTorch versions, and ``comb_tree.cu``'s lane order
(one thread playing a signature's 4 or 8 lanes): its sum against the
plain tree and, at the limb maximum, its own order's formulas on Python
integers, its whole verify against the reference-order twin, the plain
tree, ``comb.cu``'s twin and ``keys.verify``.  The 17 x 15-bit field of the mxu
kernel (``fe17.cuh``) builds with its serial twin of the tensor-core
multiply, which sums the same product bytes against the same 0/1 entries
over the same live tiles: it is held limb for limb against the plain
``_mul_mxu`` (at the limb maximum too), its carries against Python
integers, the whole verify over it (``ge25519.cuh`` on ``fe17``) against
the plain verify, the comb chain over it (``comb17.cuh``, the
arithmetic of ``comb_mxu.cu``): its negated-Niels mixed addition against
Python integers at the limb maximum, its whole verify against the plain
chain under ``mxu``, and the comb tree over it (``comb_tree17.cuh``, the
arithmetic of ``comb_tree_mxu.cu``): its leaf at the limb maximum, its sum,
its prepare record and its whole verify against Python integers, the plain
tree under ``mxu`` and the chain over ``fe17``.  The team multiply of
``verify_mxu.cu`` and ``comb_mxu.cu`` (``fe17_team.cuh``) builds with its
serial twin, one thread playing the warp's 32 lanes through PTX's
m16n8k32 u8 fragment mapping: one multiply a call and two are held limb
for limb against the plain ``_mul_mxu``, its product slots and live tiles
are counted, its fragment emulation is held against numpy, the whole
verify through it (paired curve formulas, the table in caller scratch)
against the serial twin and the plain bitmap, and the comb chain through
it (paired mixed additions and compare): its mixed addition at the limb
maximum against Python integers, its whole verify on the comb corpus
against the serial twin, the plain chain under ``mxu`` and
``keys.verify``; and ``comb_tree_mxu.cu``'s team order of the tree
(``comb_tree17.cuh``, one thread playing a signature's teams): its paired
complete addition at the limb maximum, its sum against the plain tree,
Python ints and, at the limb maximum, its own order's formulas, and its
whole verify against the reference-order twin, the plain tree, the chain
and ``keys.verify``.  ``verify.cu``'s team of four
lanes (``verify25519.cuh``) builds with its serial twin, one thread playing
the four lanes: its basepoint comb, its [S]B (the dropped carry too), both
team steps at the TIGHT maximum, one ladder window, and its whole verify
against Python integers, the plain version and ``keys.verify``, on the
adversarial corpus and the lanes only the host rejects.  The port never loads these builds; they exist
to catch radix, schedule and bounds faults before the kernels reach a card.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mochi_tpu_torch import kernels
from mochi_tpu_torch.crypto import cuda_verify as CV
from mochi_tpu_torch.crypto import curve as C
from mochi_tpu_torch.crypto import field as F
from mochi_tpu_torch.crypto import hostfallback as hf
from mochi_tpu_torch.crypto import keys

P = F.P_INT
OFFS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
LOOSE_EVEN = 110729625
LOOSE_ODD = 55364812
TIGHT_EVEN = (1 << 25) + (1 << 14)
TIGHT_ODD = (1 << 24) + (1 << 14)

SHIM = r"""
#include <string.h>
#include "ge25519.cuh"
#include "comb25519.cuh"
#include "comb_tree.cuh"
#include "comb_team.cuh"
#include "verify25519.cuh"

extern "C" {
void t_fe_mul(int32_t* h, const int32_t* f, const int32_t* g) {
  fe_mul((fe*)h, (const fe*)f, (const fe*)g);
}
void t_fe_sq(int32_t* h, const int32_t* f) { fe_sq((fe*)h, (const fe*)f); }
void t_fe_carry(int32_t* h, const int32_t* f) { fe_carry((fe*)h, (const fe*)f); }
void t_fe_canonical(int32_t* h, const int32_t* f) {
  fe_canonical((fe*)h, (const fe*)f);
}
void t_fe_pow22523(int32_t* h, const int32_t* f) {
  fe_pow22523((fe*)h, (const fe*)f);
}
void t_fe_from_limbs15(int32_t* h, const int32_t* l15) {
  fe_from_limbs15((fe*)h, l15, 1);
}
void t_consts(int32_t* out) {
  fe_const_d((fe*)out);
  fe_const_d2((fe*)(out + 10));
  fe_const_sqrtm1((fe*)(out + 20));
}
int t_ge_decode(int32_t* p, const int32_t* y15, int sign) {
  return ge_decode((ge_p3*)p, y15, 1, sign);
}
// verify.cu's team (verify25519.cuh) as its serial twin: one thread plays
// the four lanes.  One ladder window: the team's [1..8]P, q = 16 q + [dh]P.
void t_window(int32_t* q, int dh, const int32_t* p) {
  vt_area a;
  int xb = 0;
  vt_table(vt_serial_lanes(), &a, &xb, (const ge_p3*)p);
  for (int i = 0; i < 4; ++i) vt_dbl(vt_serial_lanes(), &a, &xb, (ge_p3*)q);
  vt_add(vt_serial_lanes(), &a, &xb, (ge_p3*)q, dh < 0 ? -dh : dh, dh < 0, dh == 0);
}
int t_verify(const int32_t* y_a, int sign_a, const int32_t* y_r, int sign_r,
             const uint8_t* s, const uint8_t* h, const int32_t* bcomb) {
  vt_area a;
  return vt_verify(vt_serial_lanes(), &a, y_a, sign_a, y_r, sign_r, s, h, bcomb);
}
// [S]B by the comb: the digits, the four partial sums and their team sum.
void t_comb_sb(int32_t* q, const uint8_t* s, const int32_t* bcomb) {
  vt_area a;
  const uint8_t zero[32] = {0};
  int xb = 0;
  vt_digits(vt_serial_lanes(), &a, s, zero);
  vt_comb_sb(vt_serial_lanes(), &a, &xb, (ge_p3*)q, bcomb);
}
// q + entry (4 coordinates: y-x, y+x, 2dt, z), negated or the identity.
void t_team_add(int32_t* q, const int32_t* entry, int neg, int ident) {
  vt_area a;
  memcpy(a.tab[3], entry, sizeof(a.tab[3]));
  int xb = 0;
  vt_add(vt_serial_lanes(), &a, &xb, (ge_p3*)q, 3, neg, ident);
}
void t_team_dbl(int32_t* q) {
  vt_area a;
  int xb = 0;
  vt_dbl(vt_serial_lanes(), &a, &xb, (ge_p3*)q);
}
// The four coordinates of p's cached form, as the team stores them.
void t_team_cached(int32_t* out, const int32_t* p) {
  vt_area a;
  vt_put_cached(vt_serial_lanes(), &a, 5, (const ge_p3*)p);
  memcpy(out, a.tab[5], sizeof(a.tab[5]));
}
void t_comb_madd(int32_t* r, const int32_t* p, const int32_t* entry, int neg) {
  ge_niels n;
  comb_load_niels(&n, entry, neg);
  ge_madd((ge_p3*)r, (const ge_p3*)p, &n);
}
// comb.cu's team (comb_team.cuh) as its serial twin: one thread plays
// every role.  The whole verify:
int t_comb_verify(const int32_t* table, long long rows, int key_idx,
                  const int32_t* y_r, int sign_r, const uint8_t* s,
                  const uint8_t* h, const int32_t* bcomb) {
  ct_area a;
  return ct_verify(ct_serial_lanes(), &a, table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
int t_ct_team() { return MOCHI_CT_TEAM; }
int t_ct_first(int r) { return ct_first(r); }
// Lane r's partial sum (X, Y, Z, T).
void t_ct_partial(int32_t* q, int r, const int32_t* table, long long rows, int key_idx,
                  const uint8_t* s, const uint8_t* h, const int32_t* bcomb) {
  ct_partial((ge_p3*)q, r, table, rows, key_idx, s, h, bcomb);
}
// The team's sum of MOCHI_CT_TEAM partial points (40 int32 each).
void t_ct_sum(int32_t* q, const int32_t* parts) {
  ct_area a;
  memcpy(a.part, parts, sizeof(a.part));
  ct_sum(ct_serial_lanes(), &a);
  memcpy(q, a.part[0], sizeof(a.part[0]));
}
void t_tree_leaf(int32_t* r, const int32_t* entry, int neg) {
  comb_tree_leaf((ge_p3*)r, entry, neg);
}
// The leaf's y without the carry of ypx + ymx: what the carry protects.
void t_tree_leaf_y_uncarried(int32_t* y, const int32_t* entry, int neg) {
  ge_niels n;
  comb_load_niels(&n, entry, neg);
  fe c, t;
  fe_const_inv2(&c);
  fe_add(&t, &n.ypx, &n.ymx);
  fe_mul((fe*)y, &c, &t);
}
void t_tree_sum(int32_t* q, const int32_t* entries, const int8_t* neg) {
  comb_tree_sum_serial((ge_p3*)q, entries, neg);
}
int t_tree_verify(const int32_t* table, long long rows, int key_idx,
                  const int32_t* y_r, int sign_r, const uint8_t* s,
                  const uint8_t* h, const int32_t* bcomb) {
  return comb_tree_verify_one(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
// comb_tree.cu's lane order as its serial twin, one thread playing a
// signature's 4 or 8 lanes: the sum of 128 given entries, the sum of one
// lane's gathers from the bytes, and the whole verify.
int t_tree_lanes(void) { return MOCHI_TREE_LANES; }
void t_tree_sum_lanes(int32_t* q, int lanes, const int32_t* entries, const int8_t* neg) {
  const tree_given_rows src = {entries, neg};
  if (lanes == 8)
    comb_tree_sum_lanes(tree_serial_lanes<8>(), (ge_p3*)q, src);
  else
    comb_tree_sum_lanes(tree_serial_lanes<4>(), (ge_p3*)q, src);
}
void t_tree_sum_lanes_gathered(int32_t* q, int lanes, const int32_t* table, long long rows, int key_idx,
                               const uint8_t* s, const uint8_t* h, const int32_t* bcomb) {
  const tree_byte_rows src = {table, rows, key_idx, s, h, bcomb};
  if (lanes == 8)
    comb_tree_sum_lanes(tree_serial_lanes<8>(), (ge_p3*)q, src);
  else
    comb_tree_sum_lanes(tree_serial_lanes<4>(), (ge_p3*)q, src);
}
int t_tree_verify_lanes(int lanes, const int32_t* table, long long rows, int key_idx,
                        const int32_t* y_r, int sign_r, const uint8_t* s,
                        const uint8_t* h, const int32_t* bcomb) {
  return lanes == 8 ? comb_tree_verify_lanes<8>(table, rows, key_idx, y_r, sign_r, s, h, bcomb)
                    : comb_tree_verify_lanes<4>(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
}
"""

SHIM17 = r"""
#include "fe17.cuh"
#include "fe17_team.cuh"
#include "ge25519.cuh"
#include "comb17.cuh"
#include "comb_tree17.cuh"

// the words every lane of the played warp forms, step by step (team code)
template <int ST>
void team_words(uint32_t* out, const fe17_team_regs<32, 1>& c) {
  for (int l = 0; l < 32; ++l) {
    out[(2 * ST) * 32 + l] = fe17_team_word<2 * ST>(c, 0, l);
    out[(2 * ST + 1) * 32 + l] = fe17_team_word<2 * ST + 1>(c, 0, l);
  }
  if constexpr (ST + 1 < MOCHI_MXU_STEPS) team_words<ST + 1>(out, c);
}

extern "C" {
// n multiplies, (n, 17) each
void t17_mul(int32_t* h, const int32_t* f, const int32_t* g, int n) {
  for (int i = 0; i < n; ++i)
    fe_mul((fe17*)(h + 17 * i), (const fe17*)(f + 17 * i), (const fe17*)(g + 17 * i));
}
// the same through the team multiply's twin, eight items a played warp
// (lanes 4p .. 4p+3 item w + p; past n, the last item); h gets lane 4p's
// product.  With `pair`, each call also multiplies item n - 1 - i in rows
// g + 8 (fe_mul2's form), into h2.  Returns the count of lanes whose
// product differs from their team's lane 0.
int t17_mul_team(int32_t* h, int32_t* h2, const int32_t* f, const int32_t* g, int n, int pair) {
  int differ = 0;
  for (int w = 0; w < n; w += 8) {
    fe17 fs[2][32], gs[2][32], hs[2][32];
    for (int l = 0; l < 32; ++l) {
      const int i = w + l / 4 < n ? w + l / 4 : n - 1;
      fs[0][l] = *(const fe17*)(f + 17 * i), gs[0][l] = *(const fe17*)(g + 17 * i);
      fs[1][l] = *(const fe17*)(f + 17 * (n - 1 - i)), gs[1][l] = *(const fe17*)(g + 17 * (n - 1 - i));
    }
    fe17* const hp[2] = {hs[0], hs[1]};
    const fe17* const fp[2] = {fs[0], fs[1]};
    const fe17* const gp[2] = {gs[0], gs[1]};
    if (pair)
      fe17_team_muls<2>(fe17_serial_lanes(), hp, fp, gp);
    else
      fe17_team_mul(fe17_serial_lanes(), hs[0], fs[0], gs[0]);
    for (int p = 0; p < 1 + pair; ++p)
      for (int l = 0; l < 32; ++l) {
        for (int k = 0; k < 17; ++k) differ += hs[p][l].v[k] != hs[p][l & ~3].v[k];
        const int i = w + l / 4;
        if ((l & 3) == 0 && i < n) *(fe17*)((p ? h2 + 17 * (n - 1 - i) : h + 17 * i)) = hs[p][l];
      }
  }
  return differ;
}
// one MMA on the played warp's fragments: d (32, 4), a (32, 4), b (32, 2)
void t17_mma(int32_t* d, const uint32_t* a, const uint32_t* b) {
  uint32_t a0[32], a1[32], a2[32], a3[32], b0[32], b1[32];
  for (int l = 0; l < 32; ++l) {
    a0[l] = a[4 * l], a1[l] = a[4 * l + 1], a2[l] = a[4 * l + 2], a3[l] = a[4 * l + 3];
    b0[l] = b[2 * l], b1[l] = b[2 * l + 1];
  }
  fe17_serial_lanes().mma((int32_t(*)[4])d, a0, a1, a2, a3, b0, b1);
}
// the A word of every lane at every half-step, (86, 32), every team on f, g
void t17_team_words(uint32_t* out, const int32_t* f, const int32_t* g) {
  fe17 fs[32], gs[32];
  for (int l = 0; l < 32; ++l) fs[l] = *(const fe17*)f, gs[l] = *(const fe17*)g;
  fe17_team_regs<32, 1> c;
  fe17_team_operands(fe17_serial_lanes(), c, 0, fs, gs);
  team_words<0>(out, c);
}
// each (step, n-tile)'s liveness, (43, 9)
void t17_team_live(int32_t* live) {
  for (int st = 0; st < MOCHI_MXU_STEPS; ++st)
    for (int j = 0; j < MOCHI_TEAM17_NTILES; ++j) live[MOCHI_TEAM17_NTILES * st + j] = fe17_ntile_live(st, j);
}
void t17_carry2(int32_t* h, const int32_t* cols) { fe17_carry2((fe17*)h, cols); }
int t17_carry_chain(int32_t* out, const int32_t* cols) { return fe17_carry_chain(out, cols); }
void t17_canonical(int32_t* h, const int32_t* f) { fe_canonical((fe17*)h, (const fe17*)f); }
void t17_pow22523(int32_t* h, const int32_t* f) { fe_pow22523((fe17*)h, (const fe17*)f); }
// op 0 add, 1 sub, 2 neg, 3 mul_small by k, 4 select(f, g, k)
void t17_op(int op, int32_t* h, const int32_t* f, const int32_t* g, int k) {
  fe17* o = (fe17*)h;
  const fe17 *a = (const fe17*)f, *b = (const fe17*)g;
  if (op == 0) fe_add(o, a, b);
  if (op == 1) fe_sub(o, a, b);
  if (op == 2) fe_neg(o, a);
  if (op == 3) fe_mul_small(o, a, k);
  if (op == 4) fe_select(o, a, b, k);
}
// the schedule: slot q of step st -> (i, column), and each (step, tile)'s liveness
void t17_schedule(int32_t* slots, int32_t* live) {
  for (int st = 0; st < MOCHI_MXU_STEPS; ++st) {
    for (int q = 0; q < 8; ++q) {
      slots[2 * (8 * st + q)] = fe17_slot_i(2 * st + q / 4, q % 4);
      slots[2 * (8 * st + q) + 1] = fe17_half_col(2 * st + q / 4);
    }
    for (int m = 0; m < MOCHI_MXU_TILES; ++m) live[MOCHI_MXU_TILES * st + m] = fe17_tile_live(st, m);
  }
}
int t17_verify(const int32_t* y_a, int sign_a, const int32_t* y_r, int sign_r,
               const uint8_t* s, const uint8_t* h, const int32_t* btab) {
  ge_cached_t<fe17> ptab[9];
  return ed25519_verify_one(y_a, sign_a, y_r, sign_r, s, h, 1, (const ge_niels_t<fe17>*)btab, ptab);
}
void t17_comb_madd(int32_t* r, const int32_t* p, const int32_t* entry, int neg) {
  ge_niels_t<fe17> n;
  comb17_load_niels(&n, entry, neg);
  ge_madd((ge_p3_t<fe17>*)r, (const ge_p3_t<fe17>*)p, &n);
}
int t17_comb_verify(const int32_t* table, long long rows, int key_idx,
                    const int32_t* y_r, int sign_r, const uint8_t* s,
                    const uint8_t* h, const int32_t* bcomb) {
  return comb17_verify_one(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
void t17_ge_add(int32_t* r, const int32_t* p, const int32_t* c) {
  ge_add((ge_p3_t<fe17>*)r, (const ge_p3_t<fe17>*)p, (const ge_cached_t<fe17>*)c);
}
void t17_tree_leaf(int32_t* r, const int32_t* entry, int neg) {
  comb_tree17_leaf((ge_p3_t<fe17>*)r, entry, neg);
}
void t17_tree_sum(int32_t* q, const int32_t* entries, const int8_t* neg) {
  comb_tree17_sum_serial((ge_p3_t<fe17>*)q, entries, neg);
}
void t17_tree_prepare(int32_t* rec, const int32_t* y_r, int sign_r, const uint8_t* s,
                      const uint8_t* h) {
  comb_tree17_prepare(rec, y_r, sign_r, s, h);
}
int t17_tree_verify(const int32_t* table, long long rows, int key_idx,
                    const int32_t* y_r, int sign_r, const uint8_t* s,
                    const uint8_t* h, const int32_t* bcomb) {
  return comb_tree17_verify_one(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
}
"""

# verify_mxu.cu's, comb_mxu.cu's and comb_tree_mxu.cu's arithmetic: the
# whole verify with every multiply through the team multiply's twin and the
# [0..8](-A) table in caller scratch, as the kernel's team keeps it in
# shared memory; the comb chain (comb17.cuh) and its mixed addition in their
# team forms; the comb tree's team order (comb_tree17.cuh) and its paired
# complete addition
SHIM17T = r"""
#define MOCHI_FE17_TEAM
#include "fe17.cuh"
#include "fe17_team.cuh"
#include "ge25519.cuh"
#include "comb17.cuh"
#include "comb_tree17.cuh"

extern "C" {
int t17t_verify(const int32_t* y_a, int sign_a, const int32_t* y_r, int sign_r,
                const uint8_t* s, const uint8_t* h, const int32_t* btab, int32_t* scratch) {
  return ed25519_verify_one(y_a, sign_a, y_r, sign_r, s, h, 1, (const ge_niels_t<fe17>*)btab,
                            (ge_cached_t<fe17>*)scratch);
}
void t17t_comb_madd(int32_t* r, const int32_t* p, const int32_t* entry, int neg) {
  ge_niels_t<fe17> n;
  comb17_load_niels(&n, entry, neg);
  ge_madd((ge_p3_t<fe17>*)r, (const ge_p3_t<fe17>*)p, &n);
}
int t17t_comb_verify(const int32_t* table, long long rows, int key_idx,
                     const int32_t* y_r, int sign_r, const uint8_t* s,
                     const uint8_t* h, const int32_t* bcomb) {
  return comb17_verify_one(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
// r = p + the cached point c (YplusX, YminusX, Z, T2d): ge_add's paired form
void t17t_ge_add(int32_t* r, const int32_t* p, const int32_t* c) {
  ge_add((ge_p3_t<fe17>*)r, (const ge_p3_t<fe17>*)p, (const ge_cached_t<fe17>*)c);
}
int t17t_tree_teams(void) { return MOCHI_TREE17_TEAMS; }
void t17t_tree_sum_team(int32_t* q, const int32_t* entries, const int8_t* neg) {
  const tree17_given_rows src = {entries, neg};
  comb_tree17_sum_team(tree17_serial_teams(), (ge_p3_t<fe17>*)q, src);
}
int t17t_tree_verify(const int32_t* table, long long rows, int key_idx,
                     const int32_t* y_r, int sign_r, const uint8_t* s,
                     const uint8_t* h, const int32_t* bcomb) {
  return comb_tree17_verify_team(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
}
}
"""

I32P = ctypes.POINTER(ctypes.c_int32)


def _build(tmp_path_factory, name, text):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel arithmetic needs it")
    d = tmp_path_factory.mktemp(name)
    src = d / "shim.cpp"
    src.write_text(text)
    so = d / "shim.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-fwrapv", "-Wall", "-Werror",
         "-I", str(kernels.CSRC), "-o", str(so), str(src)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "kernel_host", SHIM)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.t_verify.argtypes = [I32P, ctypes.c_int, I32P, ctypes.c_int, u8, u8, I32P]
    lib.t_comb_sb.argtypes = [I32P, u8, I32P]
    return lib


@pytest.fixture(scope="module")
def lib17(tmp_path_factory):
    return _build(tmp_path_factory, "kernel_host17", SHIM17)


@pytest.fixture(scope="module")
def lib17t(tmp_path_factory):
    return _build(tmp_path_factory, "kernel_host17t", SHIM17T)


# ------------------------------------------------------------------ helpers


def arr(vals) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(vals, dtype=np.int32))


def ptr(a: np.ndarray):
    return a.ctypes.data_as(I32P)


def value(limbs) -> int:
    return sum(int(v) << o for v, o in zip(np.asarray(limbs).reshape(-1)[:10], OFFS))


def is_tight(limbs) -> bool:
    v = np.asarray(limbs, dtype=np.int64)
    return bool((np.abs(v[0::2]) <= TIGHT_EVEN).all() and (np.abs(v[1::2]) <= TIGHT_ODD).all())


def call1(fn, f):
    out = np.zeros(10, np.int32)
    fn(ptr(out), ptr(arr(f)))
    return out


def call2(fn, f, g):
    out = np.zeros(10, np.int32)
    fn(ptr(out), ptr(arr(f)), ptr(arr(g)))
    return out


def _bcomb25():
    from mochi_tpu_torch.crypto import cuda_comb as CC

    return arr(CC.bcomb_table25())


def rand_limbs(rng, even_bound, odd_bound):
    return [rng.randint(-even_bound, even_bound) if i % 2 == 0 else rng.randint(-odd_bound, odd_bound)
            for i in range(10)]


def extreme_limbs(rng):
    """Every limb at its loose maximum, with a random sign pattern."""
    return [(LOOSE_EVEN if i % 2 == 0 else LOOSE_ODD) * rng.choice((-1, 1)) for i in range(10)]


def field_inputs(seed, n=200):
    rng = random.Random(seed)
    out = [CV.int_to_limbs25(x) for x in (0, 1, P - 1, P, P + 1, (1 << 255) - 1, 19, P - 19)]
    out += [[LOOSE_EVEN, LOOSE_ODD] * 5, [-LOOSE_EVEN, -LOOSE_ODD] * 5]
    for _ in range(n):
        kind = rng.randrange(3)
        if kind == 0:
            out.append(CV.int_to_limbs25(rng.randrange(1 << 255)))
        elif kind == 1:
            out.append(rand_limbs(rng, LOOSE_EVEN, LOOSE_ODD))
        else:
            out.append(extreme_limbs(rng))
    return [list(map(int, f)) for f in out]


# ------------------------------------------------------------------- field


def test_constants_match_python_ints(lib):
    out = np.zeros(30, np.int32)
    lib.t_consts(ptr(out))
    assert value(out[:10]) == F.D_INT
    assert value(out[10:20]) == 2 * F.D_INT % P
    assert value(out[20:]) == F.SQRT_M1_INT


@pytest.mark.parametrize("op", ["mul", "sq"])
def test_mul_and_square_fuzz_at_loose_bounds(lib, op):
    ins = field_inputs(seed=11 if op == "mul" else 12)
    rng = random.Random(13)
    for f in ins:
        g = ins[rng.randrange(len(ins))]
        if op == "mul":
            got, want = call2(lib.t_fe_mul, f, g), value(f) * value(g)
        else:
            got, want = call1(lib.t_fe_sq, f), value(f) ** 2
        assert value(got) % P == want % P, (f, g)
        assert is_tight(got), got


def test_carry_of_any_int32_limbs_is_tight(lib):
    rng = random.Random(21)
    cases = [[(1 << 31) - 1] * 10, [-(1 << 31)] * 10]
    cases += [[rng.randint(-(1 << 31), (1 << 31) - 1) for _ in range(10)] for _ in range(300)]
    for f in cases:
        got = call1(lib.t_fe_carry, f)
        assert value(got) % P == value(f) % P
        assert is_tight(got)


def test_canonical_and_boundaries(lib):
    rng = random.Random(31)
    cases = field_inputs(seed=32)
    cases += [[rng.randint(-(1 << 31), (1 << 31) - 1) for _ in range(10)] for _ in range(100)]
    # values just around 0, p and 2p with mixed-sign limbs (2^255 = 2^25 in
    # the top limb): -1, -19, -p, p - 1, p, p + 18, 2p - 1
    top = lambda low, hi: [low] + [0] * 8 + [hi]  # noqa: E731
    cases += [top(-1, 0), top(-19, 0), top(19, -(1 << 25)), top(-20, 1 << 25),
              top(-19, 1 << 25), top(-1, 1 << 25), top(-39, 1 << 26)]
    for f in cases:
        got = call1(lib.t_fe_canonical, f)
        assert value(got) == value(f) % P, f
        assert all(0 <= got[i] < (1 << (26 if i % 2 == 0 else 25)) for i in range(10))


def test_pow22523(lib):
    e = (P - 5) // 8
    for f in field_inputs(seed=41, n=40):
        got = call1(lib.t_fe_pow22523, f)
        assert value(got) % P == pow(value(f) % P, e, P)
        assert is_tight(got)


def test_from_limbs15(lib):
    rng = random.Random(51)
    for x in [0, 1, P - 1, P, (1 << 255) - 1] + [rng.randrange(1 << 255) for _ in range(100)]:
        got = call1(lib.t_fe_from_limbs15, F.int_to_limbs(x).tolist() + [0] * 3)
        assert value(got) == x
        assert list(got) == list(CV.int_to_limbs25(x))


# ------------------------------------------------------------------- curve


def _recover_x(y, sign):
    """RFC 8032 section 5.1.3 on Python ints: x, or None for a non-point."""
    u, v = (y * y - 1) % P, (F.D_INT * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    if v * x * x % P == u:
        pass
    elif v * x * x % P == (-u) % P:
        x = x * F.SQRT_M1_INT % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    return (P - x) % P if x & 1 != sign else x


def _affine(pt):
    X, Y, Z = (value(pt[10 * k : 10 * k + 10]) for k in range(3))
    zi = pow(Z % P, P - 2, P)
    return X * zi % P, Y * zi % P


def _mul(k, pt):
    acc = (0, 1)
    for bit in bin(k)[2:] if k > 0 else "":
        acc = C._py_edwards_add(acc, acc)
        if bit == "1":
            acc = C._py_edwards_add(acc, pt)
    return acc


def _proj(lib, pt, rng):
    """Affine point -> random projective (X:Y:Z:T), each coordinate TIGHT
    as the header requires of a point (canonical limbs are not)."""
    z = rng.randrange(1, P)
    x, y = pt
    coords = (x * z % P, y * z % P, z, x * y * z % P)
    return arr(np.concatenate([call1(lib.t_fe_carry, CV.int_to_limbs25(c)) for c in coords]))


LOW_ORDER_Y = [1, P - 1, 0]  # identity, order 2, order 4 (y = 0)
ORDER8 = "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac03fa"


def _decode_cases():
    rng = random.Random(61)
    cases = [(y, s) for y in LOW_ORDER_Y for s in (0, 1)]
    enc = int.from_bytes(bytes.fromhex(ORDER8), "little")
    cases += [(enc & ((1 << 255) - 1), enc >> 255)]
    for pub in ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
                "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c"):
        e = int.from_bytes(bytes.fromhex(pub), "little")
        cases.append((e & ((1 << 255) - 1), e >> 255))
    cases += [(P, 0), (P + 1, 1), ((1 << 255) - 1, 0)]  # non-canonical y
    cases += [(rng.randrange(1 << 255), rng.randrange(2)) for _ in range(24)]
    return cases


def test_decode_matches_python_and_plain(lib):
    cases = _decode_cases()
    ys = torch.from_numpy(np.stack([F.int_to_limbs(y) for y, _ in cases], axis=-1).astype(np.int64))
    signs = torch.tensor([s for _, s in cases], dtype=torch.int64)
    plain_pt, plain_ok = C.decompress(ys, signs)
    plain_x = F.limbs_to_int_batch(F.canonical(plain_pt.x))
    n_ok = 0
    for j, (y, s) in enumerate(cases):
        out = np.zeros(40, np.int32)
        ok = lib.t_ge_decode(ptr(out), ptr(arr(F.int_to_limbs(y))), s)
        want = _recover_x(y % P, s)
        assert bool(ok) == (want is not None) == bool(plain_ok[j]), (y, s)
        if ok:
            n_ok += 1
            x, yy = _affine(out)
            assert (x, yy) == (want, y % P)
            assert x == plain_x[j]
            assert value(out[30:]) % P == x * (y % P) % P  # T = xy
    assert 0 < n_ok < len(cases)


def test_one_ladder_window_matches_python_ints(lib):
    """One window of verify.cu's ladder as the team runs it (the team's
    [1..8]P table, four doublings, one cached addition of a signed digit;
    [S]B is not in the ladder): q = 16 q + [dh]P on Python integers."""
    rng = random.Random(71)
    bpt = (F.BX_INT, F.BY_INT)
    for trial in range(40):
        q_aff = _mul(rng.randrange(1, 1 << 64), bpt)
        p_aff = _mul(rng.randrange(1, 1 << 64), bpt)
        if trial % 8 == 0:
            p_aff = (0, P - 1)  # a low-order P
        dh = rng.randint(-8, 8) if trial > 2 else trial - 1  # -1, 0 and 1 first
        q = _proj(lib, q_aff, rng)
        p = _proj(lib, p_aff, rng)
        lib.t_window(ptr(q), dh, ptr(p))
        want = _mul(16, q_aff)
        neg = lambda pt: ((P - pt[0]) % P, pt[1])  # noqa: E731
        want = C._py_edwards_add(want, _mul(abs(dh), p_aff if dh >= 0 else neg(p_aff)))
        assert _affine(q) == want, (trial, dh)
        assert is_tight(q[:10]) and is_tight(q[10:20]) and is_tight(q[20:30]) and is_tight(q[30:])


def _items(rng):
    """Valid, forged and low-order items, with their RFC 8032 verdicts."""
    out = []
    seed = bytes(rng.randrange(256) for _ in range(32))
    pub = hf.public_from_seed(seed)
    for i in range(10):
        msg = b"host %d" % i
        sig = bytearray(hf.sign(seed, msg))
        if i % 3 == 1:
            sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
        out.append((pub, msg, bytes(sig)))
    r = rng.randrange(F.L_INT)
    sig_id = hf._compress(hf._mul_base(r)) + r.to_bytes(32, "little")
    out.append(((1).to_bytes(32, "little"), b"any", sig_id))  # identity key
    out.append(((0).to_bytes(32, "little"), b"m", hf.sign(seed, b"m")))
    out.append((bytes.fromhex(ORDER8), b"m", hf.sign(seed, b"m")))
    out.append((pub, b"m", bytes.fromhex(ORDER8) + hf.sign(seed, b"m")[32:]))
    return out


def _host_verdicts(lib, items):
    from mochi_tpu_torch.crypto import batch_verify as BV

    y_a, sign_a, y_r, sign_r, s_b, h_b, pre_ok = BV.prepare_packed(items)
    bcomb = _bcomb25()
    u8 = ctypes.POINTER(ctypes.c_uint8)
    raw = [
        bool(lib.t_verify(ptr(arr(y_a[j])), int(sign_a[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                          np.ascontiguousarray(s_b[j]).ctypes.data_as(u8),
                          np.ascontiguousarray(h_b[j]).ctypes.data_as(u8), ptr(bcomb)))
        for j in range(len(items))
    ]
    return raw, [r and bool(ok) for r, ok in zip(raw, pre_ok)]


def test_mutated_signatures_match_keys_verify(lib):
    """Valid signatures and random single-bit mutations of the key, R and S:
    the host build of the kernel gives keys.verify's verdict on each."""
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = random.Random(91)
    items = []
    for i in range(120):
        seed = bytes(rng.randrange(256) for _ in range(32))
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 80)))
        pub, sig = bytearray(hf.public_from_seed(seed)), bytearray(hf.sign(seed, msg))
        if i % 3:  # flip one bit of the key (i % 3 == 1) or of R||S
            target = pub if i % 3 == 1 else sig
            bit = rng.randrange(8 * len(target))
            target[bit // 8] ^= 1 << (bit % 8)
        items.append(VerifyItem(bytes(pub), msg, bytes(sig)))
    _, got = _host_verdicts(lib, items)
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert got == want
    assert 40 <= sum(want) < 120


def test_whole_verify_matches_keys_verify_and_plain(lib):
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.verifier.spi import VerifyItem

    items = [VerifyItem(*t) for t in _items(random.Random(81))]
    host, final = _host_verdicts(lib, items)
    plain = C.verify_prepared_packed(*CV.from_reference_prepared(BV.prepare_packed(items), "cpu"))
    assert host == plain.tolist()
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert final == want
    assert any(want) and not all(want)
    # the identity-key item verifies for any message (cofactorless semantics)
    assert want[10] is True


# -------------------------------------------------------------------- comb


def _madd_ints(p, ent, neg):
    """madd-2008-hwcd-3 on Python ints mod p: extended point p (X, Y, Z, T)
    plus the Niels entry (y+x, y-x, 2dxy), negated when ``neg``."""
    X, Y, Z, T = p
    ypx, ymx, xy2d = ent
    if neg:
        ypx, ymx, xy2d = ymx, ypx, -xy2d
    a, b, c, d = (Y - X) * ymx, (Y + X) * ypx, xy2d * T, 2 * Z
    e, f, g, h = b - a, d - c, d + c, b + a
    return [v % P for v in (e * f, g * h, f * g, e * h)]


def test_comb_negated_niels_madd_fuzz_at_the_bounds(lib):
    """A negative digit feeds the negated entry (limbs down to -(2^26 - 1))
    into ge_madd: with the point's limbs at the TIGHT maximum, every sign
    pattern, and the entry's limbs at the canonical maximum, the result is
    the formula mod p and TIGHT."""
    rng = random.Random(101)
    max_entry = [(1 << 26) - 1 if i % 2 == 0 else (1 << 25) - 1 for i in range(10)]
    for trial in range(300):
        if trial % 3 == 0:
            pt = [rand_limbs(rng, TIGHT_EVEN, TIGHT_ODD) for _ in range(4)]
        else:
            pt = [[(TIGHT_EVEN if i % 2 == 0 else TIGHT_ODD) * rng.choice((-1, 1)) for i in range(10)]
                  for _ in range(4)]
        if trial % 2:
            ent = [max_entry for _ in range(3)]
        else:
            ent = [list(CV.int_to_limbs25(rng.randrange(P))) for _ in range(3)]
        neg = trial % 4 >= 2
        out = np.zeros(40, np.int32)
        lib.t_comb_madd(ptr(out), ptr(arr(sum(pt, []))), ptr(arr(sum(ent, []))), int(neg))
        want = _madd_ints([value(c) for c in pt], [value(c) for c in ent], neg)
        got = [value(out[10 * k : 10 * k + 10]) % P for k in range(4)]
        assert got == want, trial
        assert all(is_tight(out[10 * k : 10 * k + 10]) for k in range(4))


def test_comb_verify_matches_the_plain_version_lane_for_lane(lib):
    """The serial twin of ``comb.cu``'s team (``comb_team.cuh``: table
    gather with the index clipped, negated entries, the partial sums, R's
    decode, the team's sum, the compare) equals the plain PyTorch comb on
    every lane, including forged and malformed ones and key indices past
    either end of the table."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = random.Random(111)
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    pubs = [hf.public_from_seed(sd) for sd in seeds]
    reg = comb.SignerRegistry("cpu")
    reg.register_all(pubs)
    items, kidx = [], []
    for i in range(14):
        k = i % 3
        msg = b"comb host %d" % i
        sig = bytearray(hf.sign(seeds[k], msg))
        if i % 4 == 1:
            sig[40] ^= 4  # flipped S bit
        elif i % 4 == 2:
            sig[:32] = bytes.fromhex(ORDER8)  # small-order R
        items.append(VerifyItem(pubs[k], msg, bytes(sig)))
        kidx.append(k)
    kidx[5], kidx[9], kidx[13] = (k + 1) % 3, 1000, -7  # wrong, past the end, negative
    prep = BV.prepare_packed(items)
    kidx = np.asarray(kidx, dtype=np.int32)
    t15 = reg.device_table("cpu", layout="fe17")
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu")).tolist()
    t25 = arr(CC.to_radix25(t15.numpy()))
    bcomb = arr(CC.bcomb_table25())
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.t_comb_verify.argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, u8, u8, I32P]
    host = [
        bool(lib.t_comb_verify(ptr(t25), t25.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                               s_b[j].ctypes.data_as(u8), h_b[j].ctypes.data_as(u8), ptr(bcomb)))
        for j in range(len(items))
    ]
    assert host == plain
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert [h and ok for h, ok in zip(host, prep[6])][:5] == want[:5]
    assert any(host) and not all(host)


def _digits(raw: bytes):
    """The 64 signed digits of 32 little-endian bytes (recode_signed4)."""
    out, c = [], 0
    for k in range(64):
        t = ((raw[k >> 1] >> (4 * (k & 1))) & 15) + c
        c = int(t > 8)
        out.append(t - 16 * c)
    return out


def _clip_row(rows, key_idx, w, mag):
    return min(max(key_idx * 576 + w * 9 + mag, 0), rows - 1)


def test_comb_team_partials_equal_python_ints(lib):
    """Each lane of ``comb.cu``'s team (``ct_partial``) sums its windows of
    both tables: on a real signer's table, the partial is [sum of its
    windows' digits](-A) + [...]B on Python integers; on tables whose
    limbs are at the canonical maximum (negated by the digit's sign, so
    every table coordinate entering fe_mul reaches the edge of LOOSE's
    canonical half), the partial is the mixed-addition formula iterated
    on Python integers from the identity, with the row index clipped, and
    every coordinate TIGHT."""
    import chip_smoke as cs
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    team = lib.t_ct_team()
    firsts = [lib.t_ct_first(r) for r in range(team + 1)]
    assert firsts[0] == 0 and firsts[-1] == 64 and firsts == sorted(firsts)
    lib.t_ct_partial.argtypes = [I32P, ctypes.c_int, I32P, ctypes.c_longlong, ctypes.c_int, U8P, U8P, I32P]
    rng = random.Random(331)
    signer = cs.make_signers(np.random.default_rng(332), 1)[0]
    table = arr(CC.to_radix25(comb.signer_table(signer.pub)))
    bcomb = _bcomb25()
    bpt = (F.BX_INT, F.BY_INT)
    for trial in range(3):
        s_raw = bytes(rng.randrange(256) for _ in range(32)) if trial else bytes([255] * 32)
        h_raw = bytes(rng.randrange(256) for _ in range(32))
        ds, dh = _digits(s_raw), _digits(h_raw)
        for r in range(team):
            w0, w1 = lib.t_ct_first(r), lib.t_ct_first(r + 1)
            k = sum((ds[w] - signer.a * dh[w]) << (4 * w) for w in range(w0, w1))
            q = np.zeros(40, np.int32)
            lib.t_ct_partial(ptr(q), r, ptr(table), table.shape[0], 0, (ctypes.c_uint8 * 32).from_buffer_copy(s_raw),
                             (ctypes.c_uint8 * 32).from_buffer_copy(h_raw), ptr(bcomb))
            assert _affine(q) == _mul(k % F.L_INT, bpt), (trial, r)
            assert all(is_tight(q[10 * c : 10 * c + 10]) for c in range(4))
    # tables at the canonical maximum: the formula on Python integers
    rows = 2 * 576
    for trial in range(4):
        tab = np.array([[MAX_ENTRY if rng.random() < 0.5 else CV.int_to_limbs25(rng.randrange(P))
                         for _ in range(3)] for _ in range(rows)], dtype=np.int32)
        bc = np.array([[MAX_ENTRY if rng.random() < 0.5 else CV.int_to_limbs25(rng.randrange(P))
                        for _ in range(3)] for _ in range(576)], dtype=np.int32)
        key_idx = (0, 1, -3, 7)[trial]  # in the table, past either end
        s_raw = bytes(rng.randrange(256) for _ in range(32))
        h_raw = bytes(rng.randrange(256) for _ in range(32))
        ds, dh = _digits(s_raw), _digits(h_raw)
        for r in range(team):
            want = [0, 1, 1, 0]
            for w in range(lib.t_ct_first(r), lib.t_ct_first(r + 1)):
                ent = tab[_clip_row(rows, key_idx, w, abs(dh[w]))]
                want = _madd_ints(want, [value(c) for c in ent], dh[w] < 0)
                want = _madd_ints(want, [value(c) for c in bc[w * 9 + abs(ds[w])]], ds[w] < 0)
            q = np.zeros(40, np.int32)
            lib.t_ct_partial(ptr(q), r, ptr(arr(tab)), rows, key_idx, (ctypes.c_uint8 * 32).from_buffer_copy(s_raw),
                             (ctypes.c_uint8 * 32).from_buffer_copy(h_raw), ptr(arr(bc)))
            assert [value(q[10 * c : 10 * c + 10]) % P for c in range(4)] == want, (trial, r)
            assert all(is_tight(q[10 * c : 10 * c + 10]) for c in range(4))


def test_comb_team_sum_fuzz_at_the_tight_maximum(lib):
    """The team's sum of the lanes' partial points (``ct_sum``: a tree of
    ge_to_cached + ge_add, level k adding partial r + 2^k into partial r),
    with every limb of every partial at the TIGHT maximum (every sign
    pattern) or random within TIGHT: the addition formula applied in the
    same tree on Python integers, every output coordinate TIGHT."""
    team = lib.t_ct_team()
    rng = random.Random(341)
    for trial in range(120):
        parts = [[_tight_max(rng) if trial % 3 else rand_limbs(rng, TIGHT_EVEN, TIGHT_ODD) for _ in range(4)]
                 for _ in range(team)]
        ints = [[value(c) for c in pt] for pt in parts]
        step = 1
        while step < team:
            for r in range(0, team - step, 2 * step):
                X, Y, Z, T = ints[r + step]
                ints[r] = _add_ints(ints[r], [Y - X, Y + X, 2 * F.D_INT * T, Z], False, False)
            step *= 2
        q = np.zeros(40, np.int32)
        lib.t_ct_sum(ptr(q), ptr(arr([sum(pt, []) for pt in parts])))
        assert [value(q[10 * c : 10 * c + 10]) % P for c in range(4)] == [v % P for v in ints[0]], trial
        assert all(is_tight(q[10 * c : 10 * c + 10]) for c in range(4))


def _comb_corpus(seed, n):
    """``chip_smoke.py``'s registered-signer corpus of ``n`` items over 4
    signers (valid, forged, another signer's key, adversarial R and S),
    with key indices past both ends of the table on four lanes: (items,
    expected verdicts, key indices, the clipped lanes, the prepared
    arrays, the registry's (rows, 51) table)."""
    import chip_smoke as cs
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb

    signers = cs.make_signers(np.random.default_rng(seed), 4)
    items, want, kinds = cs.make_comb_corpus(seed + 1, n, signers)
    assert len(set(kinds)) >= 8 and 0.3 < np.mean(want) < 0.95
    reg = comb.SignerRegistry("cpu")
    reg.register_all([sg.pub for sg in signers])
    kidx = np.asarray([reg.index_of(it.public_key) for it in items], dtype=np.int32)
    clipped = {3: -1, 11: -(10 ** 6), 19: len(signers), 27: 10 ** 6}
    for j, k in clipped.items():
        kidx[j] = k
    return items, want, kidx, set(clipped), BV.prepare_packed(items), reg.device_table("cpu", layout="fe17")


def _check_comb_corpus_verdicts(bits, items, want, clipped, pre_ok):
    """``bits`` ANDed with the host prechecks: the expected verdicts and
    ``keys.verify`` on every lane whose key index is the signer's."""
    final = [b and bool(ok) for b, ok in zip(bits, pre_ok)]
    kept = [j for j in range(len(items)) if j not in clipped]
    assert [final[j] for j in kept] == [want[j] for j in kept]
    assert [final[j] for j in kept] == [keys.verify(items[j].public_key, items[j].message, items[j].signature)
                                        for j in kept]


def test_comb_team_twin_equals_the_plain_chain_on_the_comb_corpus(lib):
    """The serial twin of ``comb.cu``'s team on ``chip_smoke.py``'s
    registered-signer corpus (valid, forged, another signer's key,
    adversarial R and S) with key indices past both ends of the table: the
    raw bitmap equals the plain chain's lane for lane, and, ANDed with the
    host prechecks, the expected verdicts and ``keys.verify`` on every lane
    whose index is the signer's."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    items, want, kidx, clipped, prep, t15 = _comb_corpus(351, 96)
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu")).tolist()
    t25 = arr(CC.to_radix25(t15.numpy()))
    bcomb = _bcomb25()
    _, _, y_r, sign_r, s_b, h_b, pre_ok = prep
    lib.t_comb_verify.argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, U8P, U8P, I32P]
    host = [
        bool(lib.t_comb_verify(ptr(t25), t25.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                               np.ascontiguousarray(s_b[j]).ctypes.data_as(U8P),
                               np.ascontiguousarray(h_b[j]).ctypes.data_as(U8P), ptr(bcomb)))
        for j in range(len(items))
    ]
    assert host == plain
    _check_comb_corpus_verdicts(host, items, want, clipped, pre_ok)


# -------------------------------------------------------------------- tree

MAX_ENTRY = [(1 << 26) - 1 if i % 2 == 0 else (1 << 25) - 1 for i in range(10)]
INV2 = (P + 1) // 2
INV2D = pow(2 * F.D_INT % P, P - 2, P)


def _leaf_ints(ent, neg):
    """The leaf conversion on Python ints: Niels (y+x, y-x, 2dxy), negated
    when ``neg``, -> (x, y, 1, xy) mod p."""
    ypx, ymx, xy2d = ent
    if neg:
        ypx, ymx, xy2d = ymx, ypx, -xy2d
    return [(ypx - ymx) * INV2 % P, (ypx + ymx) * INV2 % P, 1, xy2d * INV2D % P]


def test_tree_leaf_fuzz_at_the_bound(lib):
    """Canonical and negated entries, with every limb of a coordinate at
    2^26 - 1 / 2^25 - 1 or random: the leaf is the formula mod p and TIGHT.
    The same inputs without the carry of ypx + ymx come out wrong (its even
    limbs reach 2^27 - 2, and 19 times that overflows int32)."""
    rng = random.Random(121)
    uncarried_wrong = 0
    for trial in range(240):
        ent = [MAX_ENTRY if rng.random() < 0.5 or trial < 8 else list(CV.int_to_limbs25(rng.randrange(P)))
               for _ in range(3)]
        neg = trial % 2
        out = np.zeros(40, np.int32)
        lib.t_tree_leaf(ptr(out), ptr(arr(sum(ent, []))), neg)
        want = _leaf_ints([value(c) for c in ent], neg)
        got = [value(out[10 * k : 10 * k + 10]) % P for k in (0, 1, 2, 3)]
        assert [got[0], got[1], got[2], got[3]] == want, trial
        assert all(is_tight(out[10 * k : 10 * k + 10]) for k in range(4))
        y = np.zeros(10, np.int32)
        lib.t_tree_leaf_y_uncarried(ptr(y), ptr(arr(sum(ent, []))), neg)
        uncarried_wrong += value(y) % P != want[1]
    assert uncarried_wrong > 0


def _tree_entries(seed):
    """128 leaf entries of a real signer table and the basepoint comb, in
    the reference's point order (signer windows, then basepoint windows),
    with random digits: (kernel-radix entries (128, 30), 17 x 15 rows
    (128, 51), negation flags (128,))."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    rng = random.Random(seed)
    tab = comb.signer_table(hf.public_from_seed(bytes(rng.randrange(256) for _ in range(32))))
    rows = np.stack([tab[w, rng.randrange(9)] for w in range(64)]
                    + [comb._b_comb()[w, rng.randrange(9)] for w in range(64)])
    neg = np.array([rng.randrange(2) for _ in range(128)], dtype=np.int8)
    return arr(CC.to_radix25(rows).reshape(128, 30)), rows, neg


def test_tree_sum_serial_equals_the_plain_tree_and_python_ints(lib):
    """The header's 7-level sum of 128 window points: its affine value
    equals the plain PyTorch tree's and the sum of the points on Python
    ints."""
    from mochi_tpu_torch.crypto import comb

    for seed in (131, 132, 133):
        ent25, rows, neg = _tree_entries(seed)
        q = np.zeros(40, np.int32)
        lib.t_tree_sum(ptr(q), ptr(ent25), neg.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        t15 = torch.from_numpy(rows.astype(np.int64)).T  # (51, 128): the point axis major, one lane
        ngt = torch.from_numpy(neg.astype(bool))
        ypx, ymx, xy2d = t15[:17], t15[17:34], t15[34:]
        pt = comb._tree_accumulate(F.select(ngt, ymx, ypx), F.select(ngt, ypx, ymx),
                                   F.select(ngt, F.neg(xy2d), xy2d), 128, 1)
        X, Y, Z = (F.limbs_to_int(c) for c in pt[:3])
        zi = pow(Z % P, P - 2, P)
        want = (0, 1)
        for r, ng in zip(rows, neg):
            x, y = _leaf_ints([F.limbs_to_int(r[17 * k : 17 * k + 17]) for k in range(3)], ng)[:2]
            want = C._py_edwards_add(want, (x, y))
        assert _affine(q) == (X * zi % P, Y * zi % P) == want, seed
        assert all(is_tight(q[10 * k : 10 * k + 10]) for k in range(4))


def test_tree_verify_matches_the_plain_tree_lane_for_lane(lib):
    """The tree header's whole verify (prepare record, clipped gathers,
    negated entries, the 7-level sum, compare) equals the plain PyTorch
    tree and the plain chain on every lane, including forged and malformed
    ones and key indices past either end of the table."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = random.Random(141)
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    pubs = [hf.public_from_seed(sd) for sd in seeds]
    reg = comb.SignerRegistry("cpu")
    reg.register_all(pubs)
    items, kidx = [], []
    for i in range(16):
        k = i % 3
        msg = b"tree host %d" % i
        sig = bytearray(hf.sign(seeds[k], msg))
        if i % 4 == 1:
            sig[41] ^= 8  # flipped S bit
        elif i % 4 == 2:
            sig[:32] = bytes.fromhex(ORDER8)  # small-order R
        items.append(VerifyItem(pubs[k], msg, bytes(sig)))
        kidx.append(k)
    kidx[5], kidx[9], kidx[13] = (k + 1) % 3, 1000, -7  # wrong, past the end, negative
    prep = BV.prepare_packed(items)
    kidx = np.asarray(kidx, dtype=np.int32)
    t15 = reg.device_table("cpu", layout="fe17")
    lanes = CC.from_prepared(kidx, prep, "cpu")
    plain = comb.verify_comb_prepared(t15, *lanes, impl="tree").tolist()
    assert plain == comb.verify_comb_prepared(t15, *lanes, impl="chain").tolist()
    t25 = arr(CC.to_radix25(t15.numpy()))
    bcomb = arr(CC.bcomb_table25())
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.t_tree_verify.argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, u8, u8, I32P]
    host = [
        bool(lib.t_tree_verify(ptr(t25), t25.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                               s_b[j].ctypes.data_as(u8), h_b[j].ctypes.data_as(u8), ptr(bcomb)))
        for j in range(len(items))
    ]
    assert host == plain
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert [h and ok for h, ok in zip(host, prep[6])][:5] == want[:5]
    assert any(host) and not all(host)


def _lane_sum_ints(ents, neg, lanes):
    """``comb_tree_sum_lanes``'s order on Python ints mod p over 128 entries
    (each three ints, y+x, y-x, 2dxy): lane j mixed-adds entries w and
    w + 64 of its windows w in [64 j / lanes, 64 (j + 1) / lanes) to the
    identity, then each level off = lanes / 2 ... 1 adds lane j + off's
    point to lane j's; lane 0's (X, Y, Z, T)."""
    per = 64 // lanes
    acc = []
    for j in range(lanes):
        a = [0, 1, 1, 0]
        for w in range(j * per, (j + 1) * per):
            for e in (w, w + 64):
                a = _madd_ints(a, ents[e], bool(neg[e]))
        acc.append(a)
    off = lanes // 2
    while off:
        acc = [_add_ints(acc[k], _cached_ints(acc[k + off]), False, False) if k + off < lanes else acc[k]
               for k in range(lanes)]
        off //= 2
    return acc[0]


def _lane_sum(lib, lanes, ent25, neg):
    q = np.zeros(40, np.int32)
    lib.t_tree_sum_lanes(ptr(q), lanes, ptr(ent25), neg.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return q


@pytest.mark.parametrize("lanes", [4, 8])
def test_tree_lane_sum_equals_the_plain_tree_and_python_ints(lib, lanes):
    """``comb_tree.cu``'s order of the sum (``comb_tree_sum_lanes``: each
    lane's windows by mixed additions from the identity, then the levels
    across the lanes) with 4 and 8 lanes a signature, on real window entries
    (a signer table and the basepoint comb with random digits, and the
    lanes of the tree corpus whose key is in the table): the affine sum
    equals the plain tree's (the reference's order), the reference-order
    twin's and the group sum of the points on Python ints, its projective
    limbs the lane order's formulas on Python ints, every coordinate
    TIGHT."""
    from mochi_tpu_torch.crypto import cuda_comb as CC

    assert lib.t_tree_lanes() == CC.TREE_LANES in (4, 8)
    cases = [_tree_entries(seed)[1:] for seed in (135, 136)]
    reg, items, kidx, prep = _tree17_corpus(207)
    table = reg.host_table()
    _, _, _, _, s_b, h_b, _ = prep
    cases += [_corpus_rows(table, kidx, s_b, h_b, j) for j in range(len(items)) if 0 <= kidx[j] < len(reg)][:5]
    for rows, neg in cases:
        ent25 = arr(CC.to_radix25(rows).reshape(128, 30))
        q = _lane_sum(lib, lanes, ent25, neg)
        serial = np.zeros(40, np.int32)
        lib.t_tree_sum(ptr(serial), ptr(ent25), neg.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        want = (0, 1)
        for r, ng in zip(rows, neg):
            x, y = _leaf_ints([F.limbs_to_int(r[17 * k : 17 * k + 17]) for k in range(3)], ng)[:2]
            want = C._py_edwards_add(want, (x, y))
        assert _affine(q) == _affine(serial) == _plain_tree_affine(rows, neg, "pad") == want
        ents = [[value(c) for c in e.reshape(3, 10)] for e in ent25]
        assert [value(q[10 * k : 10 * k + 10]) % P for k in range(4)] == _lane_sum_ints(ents, neg, lanes)
        assert all(is_tight(q[10 * k : 10 * k + 10]) for k in range(4))


@pytest.mark.parametrize("negated", ["none", "all", "mixed"])
@pytest.mark.parametrize("lanes", [4, 8])
def test_tree_lane_sum_at_the_limb_maximum_equals_python_ints(lib, lanes, negated):
    """The same lane-order sum with most entries' limbs at 2^26 - 1 /
    2^25 - 1 (the canonical maximum), negated on no leaf, on every leaf
    (2dxy's limbs down to -(2^26 - 1)) or on random ones.  Such entries are
    not curve points, so no other order sums them to the same point: the
    projective result equals the lane order's formulas on Python ints mod p,
    every coordinate TIGHT."""
    rng = random.Random({"none": 221, "all": 222, "mixed": 223}[negated] + lanes)
    ent25 = arr([[MAX_ENTRY if rng.random() < 0.75 else list(CV.int_to_limbs25(rng.randrange(P)))
                  for _ in range(3)] for _ in range(128)]).reshape(128, 30)
    neg = np.array([{"none": 0, "all": 1}.get(negated, rng.randrange(2)) for _ in range(128)], dtype=np.int8)
    q = _lane_sum(lib, lanes, ent25, neg)
    ents = [[value(c) for c in e.reshape(3, 10)] for e in ent25]
    assert [value(q[10 * k : 10 * k + 10]) % P for k in range(4)] == _lane_sum_ints(ents, neg, lanes)
    assert all(is_tight(q[10 * k : 10 * k + 10]) for k in range(4))


@pytest.mark.parametrize("lanes", [4, 8])
def test_tree_lane_verify_equals_the_reference_order_twin_the_plain_tree_the_chain_and_keys_verify(lib, lanes):
    """``comb_tree.cu``'s arithmetic as its serial twin
    (``comb_tree_verify_lanes``: R's decode, each lane's gathers recoded from
    the bytes with the row index clipped, the lane-order sum, the compare),
    with 4 and 8 lanes, on ``chip_smoke.py``'s registered-signer corpus with
    key indices past both ends of the table and the two lanes the host
    rejects while the device accepts them (ROADMAP Queue C): the raw bitmap
    equals the reference-order twin's (``comb_tree_verify_one``), the plain
    tree's, ``comb.cu``'s twin's lane for lane, True on both host-rejected
    lanes, and, ANDed with the host prechecks, the expected verdicts and
    ``keys.verify`` on every lane whose index is the signer's.  On every
    lane, a lane's gathers from the bytes sum to the same limbs as the
    lane order over the same 128 entries given."""
    import chip_smoke as cs
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    items, want, kidx, clipped, prep, t15 = _comb_corpus(359, 40)
    signer = cs.make_signers(np.random.default_rng(359), 4)[0]  # _comb_corpus's signers[0]
    rprep = BV.prepare_packed(cs.host_rejected_items(signer))
    prep = tuple(np.concatenate([a, b]) for a, b in zip(prep, rprep))
    kidx = np.concatenate([kidx, np.asarray([0, 0], dtype=np.int32)])
    assert rprep[6].tolist() == [False, False]
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu"), impl="tree").tolist()
    t25 = arr(CC.to_radix25(t15.numpy()))
    bcomb = _bcomb25()
    _, _, y_r, sign_r, s_b, h_b, pre_ok = prep
    args = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, U8P, U8P, I32P]
    lib.t_tree_verify_lanes.argtypes = [ctypes.c_int] + args
    lib.t_tree_sum_lanes_gathered.argtypes = [I32P, ctypes.c_int, I32P, ctypes.c_longlong, ctypes.c_int, U8P,
                                              U8P, I32P]
    for fn in (lib.t_tree_verify, lib.t_comb_verify):
        fn.argtypes = args

    def lane_args(j):
        return (ptr(t25), t25.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                np.ascontiguousarray(s_b[j]).ctypes.data_as(U8P), np.ascontiguousarray(h_b[j]).ctypes.data_as(U8P),
                ptr(bcomb))

    got = [bool(lib.t_tree_verify_lanes(lanes, *lane_args(j))) for j in range(len(kidx))]
    serial, chain = ([bool(fn(*lane_args(j))) for j in range(len(kidx))] for fn in (lib.t_tree_verify,
                                                                                    lib.t_comb_verify))
    assert got == serial == plain == chain
    assert got[-2:] == [True, True]
    _check_comb_corpus_verdicts(got[:-2], items, want, clipped, pre_ok[:-2])
    assert any(got) and not all(got)
    table15 = t15.numpy()
    for j in range(len(kidx)):
        rows, neg = _corpus_rows(table15, kidx, s_b, h_b, j)
        q = np.zeros(40, np.int32)
        lib.t_tree_sum_lanes_gathered(ptr(q), lanes, ptr(t25), t25.shape[0], int(kidx[j]),
                                      np.ascontiguousarray(s_b[j]).ctypes.data_as(U8P),
                                      np.ascontiguousarray(h_b[j]).ctypes.data_as(U8P), ptr(bcomb))
        assert np.array_equal(q, _lane_sum(lib, lanes, arr(CC.to_radix25(rows).reshape(128, 30)), neg)), j


# ---------------------------------------------------- the mxu field (fe17)


def _mul17(lib17, a, b, twin="serial"):
    """(17, n) operands through the serial twin of the warp's multiply
    (``serial``) or of the team multiply, one multiply a call (``team``) or
    two (``team2``: both results must agree), whose four lanes of a
    signature must all hold the product -> (17, n) int64."""
    a_r, b_r = arr(a.T), arr(b.T)
    out, out2 = np.zeros_like(a_r), np.zeros_like(a_r)
    if twin == "serial":
        lib17.t17_mul(ptr(out), ptr(a_r), ptr(b_r), a_r.shape[0])
    else:
        pair = int(twin == "team2")
        assert lib17.t17_mul_team(ptr(out), ptr(out2), ptr(a_r), ptr(b_r), a_r.shape[0], pair) == 0
        if pair:
            np.testing.assert_array_equal(out2, out)
    return out.T.astype(np.int64)


@pytest.mark.parametrize(
    "twin,case",
    [(t, c) for t in ("serial", "team", "team2") for c in ("random", "loose", "zeros")],
    ids=["random", "loose", "zeros", "team-random", "team-loose", "team-zeros",
         "team2-random", "team2-loose", "team2-zeros"],
)
def test_fe17_serial_mxu_multiply_equals_the_plain_one(lib17, twin, case):
    """The kernels' multiplies in their serial forms (the same product
    bytes, 0/1 entries and live tiles as the MMAs; for the team multiply the
    same lane shifts, fragments and shuffles, one thread playing the warp,
    one multiply a call or two sharing the MMAs) are limb-equal to the plain
    ``_mul_mxu`` and to the schoolbook, including every limb at LOOSE.
    n = 203 leaves the team's last warp partial."""
    rng = np.random.default_rng({"random": 1, "loose": 2, "zeros": 3}[case])
    n = 200 if twin == "serial" else 203
    a = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n))
    b = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n))
    if case == "loose":
        a[:, : n // 2] = F.LOOSE
        b[:, n // 4 :] = F.LOOSE
    elif case == "zeros":
        a[:, ::2] = 0
        b[:, 1::3] = 0
        b[:, 0] = 1
    got = _mul17(lib17, a, b, twin)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(got, F._mul_mxu(ta, tb).numpy())
    np.testing.assert_array_equal(got, F.mul(ta, tb).numpy())
    assert got.min() >= 0 and got.max() <= F.LOOSE


def test_fe17_schedule_covers_every_product_once(lib17):
    """Every one of the 289 limb products sits in exactly one slot of the 43
    k-steps, under its own column, and the live (step, row tile) pairs are
    exactly those whose rows a step's columns reach: 49 of 215."""
    slots = np.zeros((43 * 8, 2), np.int32)
    live = np.zeros((43, 5), np.int32)
    lib17.t17_schedule(ptr(slots), ptr(live))
    seen = []
    for st in range(43):
        for q in range(8):
            i, col = slots[8 * st + q]
            if i >= 0:
                j = col - i
                assert 0 <= i <= 16 and 0 <= j <= 16
                seen.append((i, j))
            rows = set(range(2 * col, 2 * col + 4)) if col <= 32 else set()
            for m in range(5):
                if rows & set(range(16 * m, 16 * m + 16)):
                    assert live[st, m], (st, q, m)
    assert sorted(seen) == [(i, j) for i in range(17) for j in range(17)]
    assert int(live.sum()) == 49


def test_fe17_team_schedule_puts_every_product_in_one_lane_slot(lib17):
    """The team multiply's products as its lanes form them (operands shifted
    by the lane, then the words of every half-step): every one of the 289
    limb products sits in exactly one (lane t, step, half-step) slot, under
    its half-step's column, lanes t = 0..3 form 85, 76, 68 and 60 of them,
    every team forms the same, and exactly 57 of the 43 x 9 (step, n-tile)
    pairs are live: those whose rows a step's columns reach."""
    one = np.ones(F.NLIMBS, np.int32)
    ramp = np.arange(1, F.NLIMBS + 1, dtype=np.int32)
    words = {}
    for name, f, g in (("i", ramp, one), ("j", one, ramp)):
        w = np.zeros((86, 32), np.uint32)
        lib17.t17_team_words(w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), ptr(f), ptr(g))
        words[name] = (w & 0x7FFF) | ((w >> 16) << 15)  # the product back from its word
        assert (words[name] == np.tile(words[name][:, :4], 8)).all()  # every team alike
    slots = np.zeros((43 * 8, 2), np.int32)
    live = np.zeros((43, 5), np.int32)
    lib17.t17_schedule(ptr(slots), ptr(live))
    seen, per_lane = [], [0] * 4
    for h in range(86):
        col = slots[8 * (h // 2) + 4 * (h % 2), 1]
        for t in range(4):
            pi, pj = int(words["i"][h, t]), int(words["j"][h, t])
            assert (pi == 0) == (pj == 0), (h, t)
            if pi:
                i, j = pi - 1, pj - 1
                assert i + j == col, (h, t, i, j, col)
                seen.append((i, j))
                per_lane[t] += 1
    assert sorted(seen) == [(i, j) for i in range(17) for j in range(17)]
    assert per_lane == [85, 76, 68, 60]
    tiles = np.zeros((43, 9), np.int32)
    lib17.t17_team_live(ptr(tiles))
    for st in range(43):
        cols = [slots[8 * st + 4 * q, 1] for q in range(2)]
        for j in range(9):
            reach = any(c <= 32 and 2 * c + 3 >= 8 * j and 2 * c <= 8 * j + 7 for c in cols)
            assert bool(tiles[st, j]) == reach, (st, j)
    assert int(tiles.sum()) == 57


def test_fe17_team_mma_emulation_equals_a_numpy_u8_product(lib17):
    """The twin's MMA (the 32 lanes' fragments put together by PTX's
    m16n8k32 .u8 mapping: A rows g and g + 8, bytes 4t.. and 16 + 4t..; B
    column g; D rows g and g + 8, columns 2t and 2t + 1) equals C + A B
    computed by numpy on random u8 matrices, bytes at 255 included."""
    rng = np.random.default_rng(97)
    for trial in range(8):
        A = rng.integers(0, 256, (16, 32), dtype=np.uint8)
        B = rng.integers(0, 256, (32, 8), dtype=np.uint8)
        if trial == 0:
            A[:] = 255
            B[:] = 255
        C = rng.integers(-(1 << 20), 1 << 20, (16, 8)).astype(np.int32)
        a = np.zeros((32, 4), np.uint32)
        b = np.zeros((32, 2), np.uint32)
        d = np.zeros((32, 4), np.int32)
        word = lambda v: int(v[0]) | int(v[1]) << 8 | int(v[2]) << 16 | int(v[3]) << 24  # noqa: E731
        for lane in range(32):
            g, t = lane // 4, lane % 4
            a[lane] = [word(A[g, 4 * t:4 * t + 4]), word(A[g + 8, 4 * t:4 * t + 4]),
                       word(A[g, 16 + 4 * t:20 + 4 * t]), word(A[g + 8, 16 + 4 * t:20 + 4 * t])]
            b[lane] = [word(B[4 * t:4 * t + 4, g]), word(B[16 + 4 * t:20 + 4 * t, g])]
            d[lane] = [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
        u32 = ctypes.POINTER(ctypes.c_uint32)
        lib17.t17_mma(ptr(d), a.ctypes.data_as(u32), b.ctypes.data_as(u32))
        want = C.astype(np.int64) + A.astype(np.int64) @ B.astype(np.int64)
        got = np.zeros((16, 8), np.int64)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            got[g, 2 * t], got[g, 2 * t + 1], got[g + 8, 2 * t], got[g + 8, 2 * t + 1] = d[lane]
        np.testing.assert_array_equal(got, want)


def test_fe17_carries_canonical_and_small_ops_match(lib17):
    """carry2, the exact carry chain, canonical, add, sub (+2p), neg,
    mul_small, select and the pow chain against the plain field ops and
    Python integers, at the boundaries (0, p - 1, p, p + 1, 2^255 - 1,
    every limb at LOOSE) and on random limbs."""
    rng = np.random.default_rng(4)
    vals = [0, 1, P - 1, P, P + 1, (1 << 255) - 1, 19, P - 19]
    limbs = [F.int_to_limbs(v) for v in vals] + [np.full(F.NLIMBS, F.LOOSE, np.int32)]
    limbs += list(rng.integers(0, F.LOOSE + 1, (24, F.NLIMBS)).astype(np.int32))
    cols = rng.integers(0, 1 << 26, (20, F.NLIMBS)).astype(np.int32)
    for c in cols:
        out = np.zeros(F.NLIMBS, np.int32)
        lib17.t17_carry2(ptr(out), ptr(arr(c)))
        want = F._carry2(torch.from_numpy(c.astype(np.int64))[:, None])[:, 0].numpy()
        np.testing.assert_array_equal(out, want)
        assert out.max() <= F.LOOSE
    signed = rng.integers(-(1 << 20), 1 << 20, (20, F.NLIMBS)).astype(np.int32)
    for c in signed:
        out = np.zeros(F.NLIMBS, np.int32)
        cout = lib17.t17_carry_chain(ptr(out), ptr(arr(c)))
        assert sum(int(v) << (15 * k) for k, v in enumerate(out)) + (cout << 255) == \
            sum(int(v) << (15 * k) for k, v in enumerate(c))
        assert out.min() >= 0 and out.max() < 1 << 15
    for k, f in enumerate(limbs):
        g = limbs[(5 * k + 3) % len(limbs)]
        fi, gi = F.limbs_to_int(f), F.limbs_to_int(g)
        out = np.zeros(F.NLIMBS, np.int32)
        lib17.t17_canonical(ptr(out), ptr(arr(f)))
        assert F.limbs_to_int(out) == fi % P
        for op, small, want in ((0, 0, fi + gi), (1, 0, fi - gi), (2, 0, -fi), (3, 977, 977 * fi), (3, 3, 3 * fi)):
            lib17.t17_op(op, ptr(out), ptr(arr(f)), ptr(arr(g)), small)
            assert F.limbs_to_int(out) % P == want % P and out.min() >= 0 and out.max() <= F.LOOSE, (op, k)
        lib17.t17_op(4, ptr(out), ptr(arr(f)), ptr(arr(g)), k % 2)
        np.testing.assert_array_equal(out, f if k % 2 else g)
    f = arr(limbs[-1])
    out = np.zeros(F.NLIMBS, np.int32)
    lib17.t17_pow22523(ptr(out), ptr(f))
    np.testing.assert_array_equal(out, F.pow_p58(torch.from_numpy(f.astype(np.int64))[:, None])[:, 0].numpy())


def test_fe17_verify_equals_the_plain_bitmap_and_keys_verify(lib17):
    """The whole verify over the 17 x 15-bit field with the serial twin of
    the tensor-core multiply: the plain verify's bitmap (under ``mxu`` and
    ``pad`` alike) on valid, forged and low-order items."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.verifier.spi import VerifyItem

    items = [VerifyItem(*t) for t in _items(random.Random(83))]
    y_a, sign_a, y_r, sign_r, s_b, h_b, pre_ok = BV.prepare_packed(items)
    btab = arr(CV.basepoint_table17())
    u8 = ctypes.POINTER(ctypes.c_uint8)
    host = [
        bool(lib17.t17_verify(ptr(arr(y_a[j])), int(sign_a[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                              s_b[j].ctypes.data_as(u8), h_b[j].ctypes.data_as(u8), ptr(btab)))
        for j in range(len(items))
    ]
    plain = C.verify_prepared_packed(*CV.from_reference_prepared(BV.prepare_packed(items), "cpu"))
    assert host == plain.tolist()
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert [h and bool(ok) for h, ok in zip(host, pre_ok)] == want
    assert any(want) and not all(want)


def test_fe17_team_verify_equals_the_serial_twin_and_the_plain_bitmap(lib17, lib17t):
    """``verify_mxu.cu``'s arithmetic: the whole verify over ``fe17`` with
    every multiply through the team multiply's twin and the [0..8](-A)
    table in caller scratch (the team's shared memory on the card) gives, on
    valid, forged and low-order items, the serial twin's verdict
    (``t17_verify``) and the plain verify's bitmap lane for lane."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.verifier.spi import VerifyItem

    items = [VerifyItem(*t) for t in _items(random.Random(83))]
    y_a, sign_a, y_r, sign_r, s_b, h_b, pre_ok = BV.prepare_packed(items)
    btab = arr(CV.basepoint_table17())
    u8 = ctypes.POINTER(ctypes.c_uint8)
    scratch = np.zeros(9 * 4 * F.NLIMBS, np.int32)
    args = [(ptr(arr(y_a[j])), int(sign_a[j]), ptr(arr(y_r[j])), int(sign_r[j]),
             s_b[j].ctypes.data_as(u8), h_b[j].ctypes.data_as(u8), ptr(btab)) for j in range(len(items))]
    team = [bool(lib17t.t17t_verify(*a, ptr(scratch))) for a in args]
    assert team == [bool(lib17.t17_verify(*a)) for a in args]
    plain = C.verify_prepared_packed(*CV.from_reference_prepared(BV.prepare_packed(items), "cpu"))
    assert team == plain.tolist()
    assert any(team) and not all(team)


def _fuzz_comb17_madd(madd):
    """``madd`` (a shim's ``comb17_load_niels`` + ``ge_madd<fe17>``) with
    the point's limbs at LOOSE or random in [0, LOOSE], and the entry's at
    the canonical maximum 2^15 - 1 or random, negated or not (``fe_neg``'s
    2p - x): the result is the formula mod p with every limb in [0,
    LOOSE]."""
    rng = random.Random(151)
    max_entry = [(1 << 15) - 1] * F.NLIMBS
    for trial in range(120):
        if trial % 3 == 0:
            pt = [[F.LOOSE] * F.NLIMBS for _ in range(4)]
        else:
            pt = [[rng.randint(0, F.LOOSE) for _ in range(F.NLIMBS)] for _ in range(4)]
        if trial % 2:
            ent = [max_entry for _ in range(3)]
        else:
            ent = [list(F.int_to_limbs(rng.randrange(P))) for _ in range(3)]
        neg = trial % 4 >= 2
        out = np.zeros(4 * F.NLIMBS, np.int32)
        madd(ptr(out), ptr(arr(sum(pt, []))), ptr(arr(sum(ent, []))), int(neg))
        want = _madd_ints([F.limbs_to_int(c) for c in pt], [F.limbs_to_int(c) for c in ent], neg)
        got = [F.limbs_to_int(out[F.NLIMBS * k : F.NLIMBS * (k + 1)]) % P for k in range(4)]
        assert got == want, trial
        assert out.min() >= 0 and out.max() <= F.LOOSE, trial


def test_fe17_comb_negated_niels_madd_fuzz_at_the_limb_maximum(lib17):
    """The chain's mixed addition over ``fe17`` (``comb17_load_niels``, then
    ``ge_madd<fe17>``, one multiply a call) at the limb maximum, negated
    entries too, against the formula on Python integers."""
    _fuzz_comb17_madd(lib17.t17_comb_madd)


def test_fe17_team_comb_negated_niels_madd_fuzz_at_the_limb_maximum(lib17t):
    """The same mixed addition in ``comb_mxu.cu``'s team form: its paired
    multiplies (``fe_mul2``) and the lone one through the team multiply's
    twin, at the limb maximum, negated entries too, against the formula on
    Python integers."""
    _fuzz_comb17_madd(lib17t.t17t_comb_madd)


def test_fe17_comb_verify_equals_the_plain_chain_under_mxu_lane_for_lane(lib17, monkeypatch):
    """The comb chain over ``fe17`` (the arithmetic of ``comb_mxu.cu``, with
    the serial twin of the tensor-core multiply) on the registry's own 17 x
    15 rows equals the plain chain under ``mxu`` (every multiply through
    ``_mul_mxu``) on every lane: forged and malformed lanes, another
    signer's row, and key indices clipped at both ends of the table."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = random.Random(161)
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    pubs = [hf.public_from_seed(sd) for sd in seeds]
    reg = comb.SignerRegistry("cpu")
    reg.register_all(pubs)
    items, kidx = [], []
    for i in range(12):
        k = i % 3
        msg = b"comb17 host %d" % i
        sig = bytearray(hf.sign(seeds[k], msg))
        if i % 4 == 1:
            sig[42] ^= 2  # flipped S bit
        elif i % 4 == 2:
            sig[:32] = bytes.fromhex(ORDER8)  # small-order R
        items.append(VerifyItem(pubs[k], msg, bytes(sig)))
        kidx.append(k)
    kidx[4], kidx[8], kidx[11] = (kidx[4] + 1) % 3, 1000, -7  # wrong, past the end, negative
    prep = BV.prepare_packed(items)
    kidx = np.asarray(kidx, dtype=np.int32)
    t15 = reg.device_table("cpu", layout="fe17")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu")).tolist()
    assert used
    table = arr(t15.numpy())
    bcomb = arr(comb._b_comb().reshape(-1, comb.ROW_WIDTH))
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib17.t17_comb_verify.argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, u8, u8, I32P]
    host = [
        bool(lib17.t17_comb_verify(ptr(table), table.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                                   s_b[j].ctypes.data_as(u8), h_b[j].ctypes.data_as(u8), ptr(bcomb)))
        for j in range(len(items))
    ]
    assert host == plain
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert [h and ok for h, ok in zip(host, prep[6])][:4] == want[:4]
    assert any(host) and not all(host)


def test_fe17_team_comb_verify_equals_the_serial_twin_the_plain_chain_and_keys_verify(lib17, lib17t, monkeypatch):
    """``comb_mxu.cu``'s arithmetic: the comb chain over ``fe17`` with every
    multiply through the team multiply's twin, the mixed additions and the
    compare paired (``fe_mul2``), on ``chip_smoke.py``'s registered-signer
    corpus (valid, forged, another signer's key, adversarial R and S) with
    key indices past both ends of the table: the raw bitmap equals the
    serial twin's (``t17_comb_verify``) and the plain chain's under ``mxu``
    lane for lane, and, ANDed with the host prechecks, the expected
    verdicts and ``keys.verify`` on every lane whose index is the
    signer's."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    items, want, kidx, clipped, prep, t15 = _comb_corpus(353, 64)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu")).tolist()
    assert used
    table = arr(t15.numpy())
    bcomb = arr(comb._b_comb().reshape(-1, comb.ROW_WIDTH))
    _, _, y_r, sign_r, s_b, h_b, pre_ok = prep
    argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, U8P, U8P, I32P]
    lib17.t17_comb_verify.argtypes = lib17t.t17t_comb_verify.argtypes = argtypes
    args = [(ptr(table), table.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
             np.ascontiguousarray(s_b[j]).ctypes.data_as(U8P), np.ascontiguousarray(h_b[j]).ctypes.data_as(U8P),
             ptr(bcomb)) for j in range(len(items))]
    team = [bool(lib17t.t17t_comb_verify(*a)) for a in args]
    assert team == [bool(lib17.t17_comb_verify(*a)) for a in args]
    assert team == plain
    _check_comb_corpus_verdicts(team, items, want, clipped, pre_ok)


# ------------------------------------------------ the comb tree over fe17

U8P = ctypes.POINTER(ctypes.c_uint8)


def _tree17_ints(out):
    """(4 x 17) int32 point -> the affine (x, y) of X/Z, Y/Z on Python ints."""
    X, Y, Z = (F.limbs_to_int(out[F.NLIMBS * k : F.NLIMBS * (k + 1)]) for k in range(3))
    zi = pow(Z % P, P - 2, P)
    return X * zi % P, Y * zi % P


def test_fe17_tree_leaf_fuzz_at_the_limb_maximum(lib17):
    """The tree's leaf over ``fe17`` (no carry of ypx + ymx by hand: fe17's
    add and sub carry once): canonical and negated entries with every limb
    at 2^15 - 1 or random give the formula mod p with every limb in [0,
    LOOSE], and the plain leaf under ``mxu``'s limbs exactly."""
    rng = random.Random(171)
    max_entry = [(1 << 15) - 1] * F.NLIMBS
    inv2 = F.const(INV2, (1,))
    inv2d = F.const(INV2D, (1,))
    for trial in range(160):
        ent = [max_entry if rng.random() < 0.5 or trial < 8 else list(F.int_to_limbs(rng.randrange(P)))
               for _ in range(3)]
        neg = trial % 2
        out = np.zeros(4 * F.NLIMBS, np.int32)
        lib17.t17_tree_leaf(ptr(out), ptr(arr(sum(ent, []))), neg)
        want = _leaf_ints([F.limbs_to_int(c) for c in ent], neg)
        got = [F.limbs_to_int(out[F.NLIMBS * k : F.NLIMBS * (k + 1)]) % P for k in range(4)]
        assert got == want, trial
        assert out.min() >= 0 and out.max() <= F.LOOSE, trial
        ypx, ymx, xy2d = (torch.tensor(c, dtype=torch.int64)[:, None] for c in ent)
        if neg:
            ypx, ymx, xy2d = ymx, ypx, F.neg(xy2d)
        with F.skew("mxu"):
            plain = (F.mul(F.sub(ypx, ymx), inv2), F.mul(F.add(ypx, ymx), inv2), F.mul(xy2d, inv2d))
        for k, c in zip((0, 1, 3), plain):
            np.testing.assert_array_equal(out[F.NLIMBS * k : F.NLIMBS * (k + 1)], c[:, 0].numpy())


def test_fe17_tree_sum_serial_equals_the_plain_tree_under_mxu_and_python_ints(lib17):
    """The header's 7-level sum of 128 window points over ``fe17``: its
    affine value equals the plain tree's under ``mxu`` and the sum of the
    points on Python ints, every limb in [0, LOOSE]."""
    from mochi_tpu_torch.crypto import comb

    for seed in (181, 182):
        _, rows, neg = _tree_entries(seed)
        q = np.zeros(4 * F.NLIMBS, np.int32)
        lib17.t17_tree_sum(ptr(q), ptr(arr(rows)), neg.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        t15 = torch.from_numpy(rows.astype(np.int64)).T
        ngt = torch.from_numpy(neg.astype(bool))
        ypx, ymx, xy2d = t15[:17], t15[17:34], t15[34:]
        with F.skew("mxu"):
            pt = comb._tree_accumulate(F.select(ngt, ymx, ypx), F.select(ngt, ypx, ymx),
                                       F.select(ngt, F.neg(xy2d), xy2d), 128, 1)
        X, Y, Z = (F.limbs_to_int(c) for c in pt[:3])
        zi = pow(Z % P, P - 2, P)
        want = (0, 1)
        for r, ng in zip(rows, neg):
            x, y = _leaf_ints([F.limbs_to_int(r[17 * k : 17 * k + 17]) for k in range(3)], ng)[:2]
            want = C._py_edwards_add(want, (x, y))
        assert _tree17_ints(q) == (X * zi % P, Y * zi % P) == want, seed
        assert q.min() >= 0 and q.max() <= F.LOOSE


def test_fe17_tree_prepare_record_equals_the_plain_decode_under_mxu(lib17, monkeypatch):
    """The prepare pass's record over ``fe17``: R's x and y limb for limb and
    its verdict equal the plain ``curve.decompress`` under ``mxu`` (low
    order, non-canonical, non-point and random encodings), and the 128
    digits the plain signed recoding of both scalars, in the wrapper's
    ``TREE17_RECORD_INTS``."""
    from mochi_tpu_torch.crypto import cuda_comb as CC

    cases = _decode_cases()
    ys = np.stack([F.int_to_limbs(y) for y, _ in cases])  # (n, 17): the public layout's 15-bit limbs
    signs = [s for _, s in cases]
    rng = np.random.default_rng(191)
    s_b = rng.integers(0, 256, (len(cases), 32), dtype=np.uint8)
    h_b = rng.integers(0, 256, (len(cases), 32), dtype=np.uint8)
    s_b[0], h_b[1] = 0xFF, 0x88  # every digit carries / sits at 8
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    with F.skew("mxu"):
        plain_pt, plain_ok = C.decompress(torch.from_numpy(ys.T.astype(np.int64)),
                                          torch.tensor(signs, dtype=torch.int64))
    assert used
    s_mag, s_neg = C.recode_signed4(C.digits4_from_bytes(torch.from_numpy(s_b)))
    h_mag, h_neg = C.recode_signed4(C.digits4_from_bytes(torch.from_numpy(h_b)))
    for j in range(len(cases)):
        rec = np.zeros(CC.TREE17_RECORD_INTS, np.int32)
        lib17.t17_tree_prepare(ptr(rec), ptr(arr(ys[j])), signs[j], s_b[j].ctypes.data_as(U8P),
                               h_b[j].ctypes.data_as(U8P))
        np.testing.assert_array_equal(rec[:17], plain_pt.x[:, j].numpy())
        np.testing.assert_array_equal(rec[17:34], plain_pt.y[:, j].numpy())
        assert rec[34] == int(plain_ok[j]), cases[j]
        dig = rec[35:].view(np.int8)  # the record's last 32 words
        want = np.concatenate([torch.where(s_neg[:, j], -s_mag[:, j], s_mag[:, j]).numpy(),
                               torch.where(h_neg[:, j], -h_mag[:, j], h_mag[:, j]).numpy()])
        np.testing.assert_array_equal(dig, want)
    assert 0 < int(plain_ok.sum()) < len(cases)


def _tree17_corpus(seed):
    """Comb lanes for three registered signers: valid, flipped S bit,
    small-order R, S + L (S >= L), non-point R, x = 0 with the sign bit R,
    another signer's key, and key indices past both ends of the table."""
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.verifier.spi import VerifyItem

    rng = random.Random(seed)
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    pubs = [hf.public_from_seed(sd) for sd in seeds]
    reg = comb.SignerRegistry("cpu")
    reg.register_all(pubs)
    non_point = next(y for y in range(2, 64) if _recover_x(y, 0) is None)
    items, kidx = [], []
    for i in range(18):
        k = i % 3
        msg = b"tree17 host %d" % i
        sig = bytearray(hf.sign(seeds[k], msg))
        kind = i % 6
        if kind == 1:
            sig[43] ^= 16  # flipped S bit
        elif kind == 2:
            sig[:32] = bytes.fromhex(ORDER8)  # small-order R
        elif kind == 3:
            sig[32:] = (int.from_bytes(sig[32:], "little") + F.L_INT).to_bytes(32, "little")  # S >= L
        elif kind == 4:
            sig[:32] = non_point.to_bytes(32, "little")  # non-point R
        elif kind == 5:
            sig[:32] = (1 | 1 << 255).to_bytes(32, "little")  # x = 0 with the sign bit
        items.append(VerifyItem(pubs[k], msg, bytes(sig)))
        kidx.append(k)
    kidx[6], kidx[12], kidx[13], kidx[17] = 1, 1000, -7, 5000  # another key, past the end, negative
    return reg, items, np.asarray(kidx, dtype=np.int32), BV.prepare_packed(items)


def test_fe17_tree_verify_equals_the_plain_tree_under_mxu_and_the_chain(lib17, monkeypatch):
    """The comb tree over ``fe17`` (the arithmetic of ``comb_tree_mxu.cu``,
    with the serial twin of the tensor-core multiply) on the registry's own
    17 x 15 rows equals, lane for lane, the plain tree under ``mxu`` (every
    multiply through ``_mul_mxu``) and the chain over ``fe17``: adversarial
    R, S >= L, another signer's key and key indices clipped at both ends of
    the table."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, kidx, prep = _tree17_corpus(201)
    t15 = reg.device_table("cpu", layout="fe17")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu"), impl="tree",
                                      multiply="mxu").tolist()
    assert used
    table = arr(t15.numpy())
    bcomb = arr(comb._b_comb().reshape(-1, comb.ROW_WIDTH))
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    for fn in (lib17.t17_tree_verify, lib17.t17_comb_verify):
        fn.argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, U8P, U8P, I32P]
    tree, chain = (
        [bool(fn(ptr(table), table.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                 s_b[j].ctypes.data_as(U8P), h_b[j].ctypes.data_as(U8P), ptr(bcomb)))
         for j in range(len(items))]
        for fn in (lib17.t17_tree_verify, lib17.t17_comb_verify))
    assert tree == plain == chain
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert [t and ok for t, ok in zip(tree, prep[6])][:6] == want[:6]
    assert any(tree) and not all(tree)


def _ge_add17_ints(p, c):
    """add-2008-hwcd-3 on Python ints mod p: extended point p (X, Y, Z, T)
    plus the cached point c (Y+X, Y-X, Z, 2dT), as ``ge25519.cuh`` lays out
    ``ge_cached_t``."""
    ypx, ymx, z2, t2d = c
    return _add_ints(p, (ymx, ypx, t2d, z2), False, False)


@pytest.mark.parametrize("form", ["serial", "team"])
def test_fe17_ge_add_fuzz_at_the_limb_maximum(lib17, lib17t, form):
    """The tree's complete addition over ``fe17`` (``ge_add<fe17>``), one
    multiply a call (``serial``) and in ``comb_tree_mxu.cu``'s paired form
    through the team multiply's twin (``team``), with the point's and the
    cached addend's limbs at LOOSE or random in [0, LOOSE]: the formula mod
    p on Python integers, every limb in [0, LOOSE]."""
    add = lib17.t17_ge_add if form == "serial" else lib17t.t17t_ge_add
    rng = random.Random(157)
    for trial in range(120):
        pt, c = ([[F.LOOSE] * F.NLIMBS if trial % 3 == k or rng.random() < 0.2
                  else [rng.randint(0, F.LOOSE) for _ in range(F.NLIMBS)] for _ in range(4)] for k in (0, 1))
        out = np.zeros(4 * F.NLIMBS, np.int32)
        add(ptr(out), ptr(arr(sum(pt, []))), ptr(arr(sum(c, []))))
        want = _ge_add17_ints([F.limbs_to_int(v) for v in pt], [F.limbs_to_int(v) for v in c])
        got = [F.limbs_to_int(out[F.NLIMBS * k : F.NLIMBS * (k + 1)]) % P for k in range(4)]
        assert got == want, trial
        assert out.min() >= 0 and out.max() <= F.LOOSE, trial


def _team_sum_ints(rows, neg, teams):
    """``comb_tree17_sum_team``'s order on Python ints mod p: team k
    mixed-adds entries w and w + 64 of its windows w = k, k + teams, ... to
    the identity, then each level off = teams / 2 ... 1 adds team k + off's
    point to team k's; team 0's (X, Y, Z, T)."""
    ents = [[F.limbs_to_int(r[17 * c : 17 * c + 17]) for c in range(3)] for r in rows]
    acc = [[0, 1, 1, 0] for _ in range(teams)]
    for i in range(64 // teams):
        for k in range(teams):
            for e in (k + teams * i, k + teams * i + 64):
                acc[k] = _madd_ints(acc[k], ents[e], bool(neg[e]))
    off = teams // 2
    while off:
        acc = [_add_ints(acc[k], _cached_ints(acc[k + off]), False, False) if k + off < teams else acc[k]
               for k in range(teams)]
        off //= 2
    return acc[0]


def _cached_ints(q):
    X, Y, Z, T = q
    return ((Y - X) % P, (Y + X) % P, 2 * F.D_INT * T % P, Z)


def _corpus_rows(table, kidx, s_b, h_b, j):
    """Lane j's 128 window entries in the reference's point order (the
    signer's rows for h's digits, clipped as ``comb_row`` clips, then the
    basepoint comb's for s's digits) and their negation flags."""
    from mochi_tpu_torch.crypto import comb

    digs = []
    for b in (h_b[j], s_b[j]):
        mag, ng = C.recode_signed4(C.digits4_from_bytes(torch.from_numpy(np.ascontiguousarray(b))[None]))
        digs.append((mag[:, 0].numpy(), ng[:, 0].numpy()))
    (hm, hn), (sm, sn) = digs
    flat = np.clip(int(kidx[j]) * 576 + np.arange(64) * 9 + hm, 0, table.shape[0] - 1)
    rows = np.concatenate([table[flat], comb._b_comb()[np.arange(64), sm]])
    return arr(rows), np.concatenate([hn, sn]).astype(np.int8)


def _plain_tree_affine(rows, neg, multiply="mxu"):
    """The plain tree under ``multiply`` over 128 entries: the affine (x, y)."""
    from mochi_tpu_torch.crypto import comb

    t15 = torch.from_numpy(rows.astype(np.int64)).T
    ngt = torch.from_numpy(neg.astype(bool))
    ypx, ymx, xy2d = t15[:17], t15[17:34], t15[34:]
    with F.skew(multiply):
        pt = comb._tree_accumulate(F.select(ngt, ymx, ypx), F.select(ngt, ypx, ymx),
                                   F.select(ngt, F.neg(xy2d), xy2d), 128, 1)
    X, Y, Z = (F.limbs_to_int(c) for c in pt[:3])
    zi = pow(Z % P, P - 2, P)
    return X * zi % P, Y * zi % P


def _team_sum(lib17t, rows, neg):
    """The shim's team-order sum of 128 entries: (4 x 17) int32."""
    q = np.zeros(4 * F.NLIMBS, np.int32)
    lib17t.t17t_tree_sum_team(ptr(q), ptr(rows), neg.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return q


def test_fe17_team_tree_sum_equals_the_plain_tree_under_mxu_and_python_ints(lib17t):
    """``comb_tree_mxu.cu``'s accumulate order (``comb_tree17_sum_team``:
    each team's windows by paired mixed additions from the identity, then
    the levels across teams, every multiply through the team multiply's
    twin) on real window entries (a signer table and the basepoint comb
    with random digits, and the lanes of the tree corpus whose key is in
    the table): the affine sum equals the plain tree's under ``mxu`` (the
    reference's order) and the group sum of the points on Python ints, its
    projective limbs the team order's formulas on Python ints, every limb
    in [0, LOOSE]."""
    teams = lib17t.t17t_tree_teams()
    assert teams in (4, 8)
    cases = [_tree_entries(seed)[1:] for seed in (183, 184)]
    reg, items, kidx, prep = _tree17_corpus(205)
    table = reg.host_table()
    _, _, _, _, s_b, h_b, _ = prep
    cases += [_corpus_rows(table, kidx, s_b, h_b, j) for j in range(len(items)) if 0 <= kidx[j] < len(reg)][:6]
    for rows, neg in cases:
        rows = arr(rows)
        q = _team_sum(lib17t, rows, neg)
        want = (0, 1)
        for r, ng in zip(rows, neg):
            x, y = _leaf_ints([F.limbs_to_int(r[17 * k : 17 * k + 17]) for k in range(3)], ng)[:2]
            want = C._py_edwards_add(want, (x, y))
        assert _tree17_ints(q) == _plain_tree_affine(rows, neg) == want
        got = [F.limbs_to_int(q[F.NLIMBS * k : F.NLIMBS * (k + 1)]) % P for k in range(4)]
        assert got == _team_sum_ints(rows, neg, teams)
        assert q.min() >= 0 and q.max() <= F.LOOSE


@pytest.mark.parametrize("negated", ["none", "all", "mixed"])
def test_fe17_team_tree_sum_at_the_limb_maximum_equals_python_ints(lib17t, negated):
    """The same team-order sum with every entry limb at 2^15 - 1 (the
    canonical maximum), some entries random: negated on no leaf, on every
    leaf (``fe_neg``'s 2p - x, limbs up to LOOSE) or on random ones.  Such
    entries are not curve points, so no other order sums them to the same
    point: the projective result equals the team order's formulas on Python
    ints mod p, every limb in [0, LOOSE]."""
    teams = lib17t.t17t_tree_teams()
    rng = random.Random({"none": 211, "all": 212, "mixed": 213}[negated])
    rows = arr([[(1 << 15) - 1] * 51 if rng.random() < 0.75 else
                sum((list(F.int_to_limbs(rng.randrange(P))) for _ in range(3)), []) for _ in range(128)])
    neg = np.array([{"none": 0, "all": 1}.get(negated, rng.randrange(2)) for _ in range(128)], dtype=np.int8)
    q = _team_sum(lib17t, rows, neg)
    got = [F.limbs_to_int(q[F.NLIMBS * k : F.NLIMBS * (k + 1)]) % P for k in range(4)]
    assert got == _team_sum_ints(rows, neg, teams)
    assert q.min() >= 0 and q.max() <= F.LOOSE


def test_fe17_team_tree_verify_equals_the_serial_twin_the_plain_tree_comb_mxu_and_keys_verify(
        lib17, lib17t, monkeypatch):
    """``comb_tree_mxu.cu``'s arithmetic, both passes: the prepare record
    and the team-order sum and compare (``comb_tree17_verify_team``), every
    multiply through the team multiply's twin, on ``chip_smoke.py``'s
    registered-signer corpus with key indices past both ends of the table
    and the two lanes the host rejects while the device accepts them (ROADMAP
    Queue C): the raw bitmap equals the reference-order serial twin's
    (``t17_tree_verify``), the plain tree's under ``mxu``, ``comb_mxu.cu``'s
    twin's (``t17t_comb_verify``) lane for lane, True on both host-rejected
    lanes, and, ANDed with the host prechecks, the expected verdicts and
    ``keys.verify`` on every lane whose index is the signer's."""
    import chip_smoke as cs
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    items, want, kidx, clipped, prep, t15 = _comb_corpus(357, 40)
    signer = cs.make_signers(np.random.default_rng(357), 4)[0]  # _comb_corpus's signers[0]
    rej = cs.host_rejected_items(signer)
    rprep = BV.prepare_packed(rej)
    prep = tuple(np.concatenate([a, b]) for a, b in zip(prep, rprep))
    kidx = np.concatenate([kidx, np.asarray([0, 0], dtype=np.int32)])
    assert rprep[6].tolist() == [False, False]
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    plain = comb.verify_comb_prepared(t15, *CC.from_prepared(kidx, prep, "cpu"), impl="tree",
                                      multiply="mxu").tolist()
    assert used
    table = arr(t15.numpy())
    bcomb = arr(comb._b_comb().reshape(-1, comb.ROW_WIDTH))
    _, _, y_r, sign_r, s_b, h_b, pre_ok = prep
    fns = (lib17t.t17t_tree_verify, lib17.t17_tree_verify, lib17t.t17t_comb_verify)
    for fn in fns:
        fn.argtypes = [I32P, ctypes.c_longlong, ctypes.c_int, I32P, ctypes.c_int, U8P, U8P, I32P]
    team, serial, chain = (
        [bool(fn(ptr(table), table.shape[0], int(kidx[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                 np.ascontiguousarray(s_b[j]).ctypes.data_as(U8P), np.ascontiguousarray(h_b[j]).ctypes.data_as(U8P),
                 ptr(bcomb))) for j in range(len(kidx))]
        for fn in fns)
    assert team == serial == plain == chain
    assert team[-2:] == [True, True]
    _check_comb_corpus_verdicts(team[:-2], items, want, clipped, pre_ok[:-2])
    assert any(team) and not all(team)


# ------------------------------------------- the team verify (verify25519.cuh)

def _niels_ints(x, y):
    return ((y + x) % P, (y - x) % P, 2 * F.D_INT * x % P * y % P)


def test_team_basepoint_comb_equals_python_ints_and_the_plain_curve():
    """The table ``verify.cu`` reads for [S]B (uploaded by
    ``cuda_verify._table_on``): entry w * 9 + d is [d 16^w]B in Niels form,
    canonical limbs, entry for entry against Python-integer point
    multiplication and against the plain curve's ladder on the same
    scalars."""
    table = CV._table_on("cpu", "pad").numpy()
    assert table.shape == (576, 3, 10) and table.dtype == np.int32
    assert np.array_equal(table, _bcomb25())
    bpt = (F.BX_INT, F.BY_INT)
    base = bpt
    for w in range(64):
        acc = (0, 1)
        for d in range(9):
            got = tuple(value(table[9 * w + d, c]) for c in range(3))
            assert got == _niels_ints(*acc), (w, d)
            assert all(0 <= table[9 * w + d, c, i] < (1 << (26 if i % 2 == 0 else 25))
                       for c in range(3) for i in range(10))
            acc = C._py_edwards_add(acc, base)
        base = _mul(16, base)
    # the plain ladder's [d 16^w]B for every entry, one lane each
    ks = [d << (4 * w) for w in range(64) for d in range(9)]
    s_dig = torch.tensor([[(k >> (4 * i)) & 15 for k in ks] for i in range(64)], dtype=F.DTYPE)
    zero = torch.zeros_like(s_dig)
    ident = C.identity((len(ks),), "cpu")
    q = C.double_scalar_mul_windowed(s_dig, zero, ident)
    xs, ys, zs = (F.limbs_to_int_batch(F.canonical(c)) for c in (q.x, q.y, q.z))
    for j, (x, y, z) in enumerate(zip(xs, ys, zs)):
        zi = pow(z, P - 2, P)
        assert _niels_ints(x * zi % P, y * zi % P) == tuple(value(table[j, c]) for c in range(3)), j


def _recoded(s: int) -> int:
    """The scalar the signed-4 recode of 32 bytes stands for, the carry out
    of window 63 dropped."""
    out, c = 0, 0
    for k in range(64):
        t = ((s >> (4 * k)) & 15) + c
        c = int(t > 8)
        out += (t - 16 * c) << (4 * k)
    return out


def test_team_comb_sb_equals_python_ints_and_the_plain_ladder(lib):
    """The team's [S]B (four partial comb sums, added by the team) equals
    [S']B on Python integers, S' the recoded scalar with window 63's carry
    dropped, and the plain ladder's [S]B: random S, 0, L - 1, L, L + 1 and
    2^256 - 1 (which recodes to -1)."""
    rng = random.Random(301)
    ss = [0, F.L_INT - 1, F.L_INT, F.L_INT + 1, (1 << 256) - 1, (1 << 252) + 8 * 16 ** 62]
    ss += [rng.randrange(1 << 256) for _ in range(14)] + [rng.randrange(F.L_INT) for _ in range(6)]
    assert _recoded((1 << 256) - 1) == -1
    bcomb = _bcomb25()
    raw = np.array([list(s.to_bytes(32, "little")) for s in ss], dtype=np.uint8)
    s_dig = C.digits4_from_bytes(torch.from_numpy(raw))
    plain = C.double_scalar_mul_windowed(s_dig, torch.zeros_like(s_dig), C.identity((len(ss),), "cpu"))
    px, py, pz = (F.limbs_to_int_batch(F.canonical(c)) for c in (plain.x, plain.y, plain.z))
    for j, s in enumerate(ss):
        q = np.zeros(40, np.int32)
        sb = np.ascontiguousarray(raw[j])
        lib.t_comb_sb(ptr(q), sb.ctypes.data_as(U8P), ptr(bcomb))
        want = _mul(_recoded(s) % F.L_INT, (F.BX_INT, F.BY_INT))
        assert _affine(q) == want, hex(s)
        zi = pow(pz[j], P - 2, P)
        assert (px[j] * zi % P, py[j] * zi % P) == want
        assert value(q[30:]) * pow(value(q[20:30]), P - 2, P) % P == want[0] * want[1] % P  # T = XY/Z
        assert all(is_tight(q[10 * k : 10 * k + 10]) for k in range(4))


def _add_ints(q, ent, neg, ident):
    """add-2008-hwcd-3 on Python ints mod p: q (X, Y, Z, T) plus the cached
    entry (Y-X, Y+X, 2dT, Z), negated when ``neg``, the identity when
    ``ident``."""
    X, Y, Z, T = q
    ymx, ypx, t2d, z2 = (1, 1, 0, 1) if ident else ent
    if neg:
        ymx, ypx, t2d = ypx, ymx, -t2d
    a, b, c, d = (Y - X) * ymx, (Y + X) * ypx, T * t2d, 2 * Z * z2
    e, f, g, h = b - a, d - c, d + c, b + a
    return [v % P for v in (e * f, g * h, f * g, e * h)]


def _dbl_ints(q):
    X, Y, Z, _ = q
    a, b, c = X * X, Y * Y, 2 * Z * Z
    h = a + b
    e, g = h - (X + Y) ** 2, a - b
    f = c + g
    return [v % P for v in (e * f, g * h, f * g, e * h)]


def _tight_max(rng):
    return [(TIGHT_EVEN if i % 2 == 0 else TIGHT_ODD) * rng.choice((-1, 1)) for i in range(10)]


def test_team_steps_fuzz_at_the_tight_maximum(lib):
    """The team's two-step addition (every sign of digit, the identity
    entry) and doubling, and the cached form the team stores, with the
    point's limbs at the TIGHT maximum (every sign pattern) and the entry's
    at their own maximum (two TIGHT terms for y-x and y+x): the formulas mod
    p on Python integers, every output TIGHT."""
    rng = random.Random(311)
    for trial in range(240):
        if trial % 4 == 0:
            pt = [rand_limbs(rng, TIGHT_EVEN, TIGHT_ODD) for _ in range(4)]
        else:
            pt = [_tight_max(rng) for _ in range(4)]
        two = [[2 * v for v in _tight_max(rng)] for _ in range(2)]
        ent = two + [_tight_max(rng), _tight_max(rng)] if trial % 2 else \
            [rand_limbs(rng, 2 * TIGHT_EVEN, 2 * TIGHT_ODD) for _ in range(2)] + \
            [rand_limbs(rng, TIGHT_EVEN, TIGHT_ODD) for _ in range(2)]
        neg, ident = trial % 3 == 1, trial % 7 == 3
        ints = [value(c) for c in pt]
        out = arr(sum(pt, []))
        lib.t_team_add(ptr(out), ptr(arr(sum(ent, []))), int(neg), int(ident))
        assert [value(out[10 * k : 10 * k + 10]) % P for k in range(4)] == \
            _add_ints(ints, [value(c) for c in ent], neg, ident), trial
        assert all(is_tight(out[10 * k : 10 * k + 10]) for k in range(4))
        out = arr(sum(pt, []))
        lib.t_team_dbl(ptr(out))
        assert [value(out[10 * k : 10 * k + 10]) % P for k in range(4)] == _dbl_ints(ints), trial
        assert all(is_tight(out[10 * k : 10 * k + 10]) for k in range(4))
        cached = np.zeros(40, np.int32)
        lib.t_team_cached(ptr(cached), ptr(arr(sum(pt, []))))
        X, Y, Z, T = ints
        assert [value(cached[10 * k : 10 * k + 10]) % P for k in range(4)] == \
            [(Y - X) % P, (Y + X) % P, 2 * F.D_INT * T % P, Z % P]
        assert is_tight(cached[20:30]) and is_tight(cached[30:])


def test_team_verify_equals_the_plain_bitmap_and_keys_verify(lib):
    """The serial twin of the team's whole verify, lane for lane: the raw
    bitmap equals the plain version's on the adversarial corpus (every kind
    of ``chip_smoke.py``'s, forgeries, mutated bits, the identity key) and
    on the two lanes the host rejects but the device accepts (A y = p + 1
    with R = B, S = 1; a valid A with R = B, S = L + 1, both raw True);
    ANDed with the host prechecks it equals ``keys.verify``."""
    import chip_smoke as cs
    from mochi_tpu_torch.crypto import batch_verify as BV
    from mochi_tpu_torch.verifier.spi import VerifyItem

    signers = cs.make_signers(np.random.default_rng(321), 4)
    items, _, kinds = cs.make_corpus(322, 170, signers)
    assert len(set(kinds)) >= 28
    items = items + [VerifyItem(*t) for t in _items(random.Random(323))] + cs.host_rejected_items(signers[0])
    prep = BV.prepare_packed(items)
    plain = C.verify_prepared_packed(*CV.from_reference_prepared(prep, "cpu")).tolist()
    y_a, sign_a, y_r, sign_r, s_b, h_b, pre_ok = prep
    bcomb = _bcomb25()
    host = [
        bool(lib.t_verify(ptr(arr(y_a[j])), int(sign_a[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                          np.ascontiguousarray(s_b[j]).ctypes.data_as(U8P),
                          np.ascontiguousarray(h_b[j]).ctypes.data_as(U8P), ptr(bcomb)))
        for j in range(len(items))
    ]
    assert host == plain
    assert host[-2:] == [True, True] and pre_ok[-2:].tolist() == [False, False]
    want = [keys.verify(it.public_key, it.message, it.signature) for it in items]
    assert [h and bool(ok) for h, ok in zip(host, pre_ok)] == want
    assert 0.3 < np.mean(want) < 0.95
