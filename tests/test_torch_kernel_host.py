"""The CUDA kernels' arithmetic, compiled for the host and fuzzed.

``mochi_tpu_torch/csrc/fe25519.cuh``, ``ge25519.cuh``, ``comb25519.cuh``,
``comb_tree.cuh``, ``fe17.cuh`` and ``comb17.cuh`` are plain
``__host__ __device__`` code,
so ``g++`` builds them here into small ctypes libraries (the test-only
shims below), with
``-fwrapv`` so that a signed int32 overflow wraps as it does on the card.
The fuzz holds every field op against Python integers, with inputs at the
edges of the bounds the header states (maximum loose limbs, every sign
pattern), and decode, one ladder window, the whole verify, the comb's
negated-Niels mixed addition, the whole comb verify, the tree's leaf
conversion, its 7-level sum and its whole verify against Python integers
and the port's plain PyTorch versions.  The 17 x 15-bit field of the mxu
kernel (``fe17.cuh``) builds with its serial twin of the tensor-core
multiply, which sums the same product bytes against the same 0/1 entries
over the same live tiles: it is held limb for limb against the plain
``_mul_mxu`` (at the limb maximum too), its carries against Python
integers, the whole verify over it (``ge25519.cuh`` on ``fe17``) against
the plain verify, and the comb chain over it (``comb17.cuh``, the
arithmetic of ``comb_mxu.cu``): its negated-Niels mixed addition against
Python integers at the limb maximum, its whole verify against the plain
chain under ``mxu``.  The port never loads these builds; they exist
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
void t_ge_window(int32_t* q, int dh, int ds, const int32_t* p,
                 const int32_t* btab) {
  ge_cached ptab[9];
  ge_small_multiples(ptab, (const ge_p3*)p);
  ge_window((ge_p3*)q, dh, ds, ptab, (const ge_niels*)btab);
}
int t_verify(const int32_t* y_a, int sign_a, const int32_t* y_r, int sign_r,
             const uint8_t* s, const uint8_t* h, const int32_t* btab) {
  return ed25519_verify_one(y_a, sign_a, y_r, sign_r, s, h, 1,
                            (const ge_niels*)btab);
}
void t_comb_madd(int32_t* r, const int32_t* p, const int32_t* entry, int neg) {
  ge_niels n;
  comb_load_niels(&n, entry, neg);
  ge_madd((ge_p3*)r, (const ge_p3*)p, &n);
}
int t_comb_verify(const int32_t* table, long long rows, int key_idx,
                  const int32_t* y_r, int sign_r, const uint8_t* s,
                  const uint8_t* h, const int32_t* bcomb) {
  return comb_verify_one(table, rows, key_idx, y_r, sign_r, s, h, bcomb);
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
}
"""

SHIM17 = r"""
#include "fe17.cuh"
#include "ge25519.cuh"
#include "comb17.cuh"

extern "C" {
// n multiplies, (n, 17) each
void t17_mul(int32_t* h, const int32_t* f, const int32_t* g, int n) {
  for (int i = 0; i < n; ++i)
    fe_mul((fe17*)(h + 17 * i), (const fe17*)(f + 17 * i), (const fe17*)(g + 17 * i));
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
  return ed25519_verify_one(y_a, sign_a, y_r, sign_r, s, h, 1, (const ge_niels_t<fe17>*)btab);
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
    return _build(tmp_path_factory, "kernel_host", SHIM)


@pytest.fixture(scope="module")
def lib17(tmp_path_factory):
    return _build(tmp_path_factory, "kernel_host17", SHIM17)


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
    rng = random.Random(71)
    btab = CV.basepoint_table25()
    bpt = (F.BX_INT, F.BY_INT)
    for trial in range(40):
        q_aff = _mul(rng.randrange(1, 1 << 64), bpt)
        p_aff = _mul(rng.randrange(1, 1 << 64), bpt)
        if trial % 8 == 0:
            p_aff = (0, P - 1)  # a low-order P
        dh, ds = rng.randint(-8, 8), rng.randint(-8, 8)
        q = _proj(lib, q_aff, rng)
        p = _proj(lib, p_aff, rng)
        lib.t_ge_window(ptr(q), dh, ds, ptr(p), ptr(arr(btab)))
        want = _mul(16, q_aff)
        neg = lambda pt: ((P - pt[0]) % P, pt[1])  # noqa: E731
        want = C._py_edwards_add(want, _mul(abs(dh), p_aff if dh >= 0 else neg(p_aff)))
        want = C._py_edwards_add(want, _mul(abs(ds), bpt if ds >= 0 else neg(bpt)))
        assert _affine(q) == want, (trial, dh, ds)
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
    btab = arr(CV.basepoint_table25())
    u8 = ctypes.POINTER(ctypes.c_uint8)
    raw = [
        bool(lib.t_verify(ptr(arr(y_a[j])), int(sign_a[j]), ptr(arr(y_r[j])), int(sign_r[j]),
                          s_b[j].ctypes.data_as(u8), h_b[j].ctypes.data_as(u8), ptr(btab)))
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
    """The comb header's whole verify (table gather with the index clipped,
    negated entries, R decode, compare) equals the plain PyTorch comb on
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


# ---------------------------------------------------- the mxu field (fe17)


def _mul17(lib17, a, b):
    """(17, n) operands through the serial twin -> (17, n) int64."""
    a_r, b_r = arr(a.T), arr(b.T)
    out = np.zeros_like(a_r)
    lib17.t17_mul(ptr(out), ptr(a_r), ptr(b_r), a_r.shape[0])
    return out.T.astype(np.int64)


@pytest.mark.parametrize("case", ["random", "loose", "zeros"])
def test_fe17_serial_mxu_multiply_equals_the_plain_one(lib17, case):
    """The kernel's multiply in its serial form (the same product bytes, 0/1
    entries and live tiles as the MMAs) is limb-equal to the plain
    ``_mul_mxu`` and to the schoolbook, including every limb at LOOSE."""
    rng = np.random.default_rng({"random": 1, "loose": 2, "zeros": 3}[case])
    n = 200
    a = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n))
    b = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n))
    if case == "loose":
        a[:, : n // 2] = F.LOOSE
        b[:, n // 4 :] = F.LOOSE
    elif case == "zeros":
        a[:, ::2] = 0
        b[:, 1::3] = 0
        b[:, 0] = 1
    got = _mul17(lib17, a, b)
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


def test_fe17_comb_negated_niels_madd_fuzz_at_the_limb_maximum(lib17):
    """The chain's mixed addition over ``fe17`` (``comb17_load_niels``, then
    ``ge_madd<fe17>``): with the point's limbs at LOOSE or random in [0,
    LOOSE], and the entry's at the canonical maximum 2^15 - 1 or random,
    negated or not (``fe_neg``'s 2p - x), the result is the formula mod p
    with every limb in [0, LOOSE]."""
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
        lib17.t17_comb_madd(ptr(out), ptr(arr(sum(pt, []))), ptr(arr(sum(ent, []))), int(neg))
        want = _madd_ints([F.limbs_to_int(c) for c in pt], [F.limbs_to_int(c) for c in ent], neg)
        got = [F.limbs_to_int(out[F.NLIMBS * k : F.NLIMBS * (k + 1)]) % P for k in range(4)]
        assert got == want, trial
        assert out.min() >= 0 and out.max() <= F.LOOSE, trial


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
