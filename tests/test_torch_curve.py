"""The port's plain curve ops against the JAX package's, as integers.

Decode, add, double, madd_niels, the signed recode and the windowed ladder
run on the same inputs (numpy seed, RFC 8032 keys, low-order points, x = 0
with the sign bit, non-canonical y) through both packages; every output
limb must match (tolerance zero), and the Niels basepoint tables must equal
the JAX package's as integers.  The JAX ops run eagerly on JAX's CPU
backend; the expensive ones (decode and ladder, whose loops compile) run
once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mochi_tpu.crypto import curve as JC
from mochi_tpu.crypto import field as JF
from mochi_tpu_torch.crypto import curve as C
from mochi_tpu_torch.crypto import field as F

P = F.P_INT
RFC_PUBS = [
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
    "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
    "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
]
ORDER8 = "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac03fa"


def _decode_inputs():
    """(y, sign) pairs: low-order points, x = 0 with the sign bit, RFC keys,
    non-canonical y (the host rejects them; the device math must still
    agree), and random y from a numpy seed (about half are non-points)."""
    pairs = [(1, 0), (1, 1), (P - 1, 0), (P - 1, 1), (0, 0), (0, 1)]
    for h in RFC_PUBS + [ORDER8]:
        e = int.from_bytes(bytes.fromhex(h), "little")
        pairs.append((e & ((1 << 255) - 1), e >> 255))
    pairs += [(P, 0), (P + 1, 1), ((1 << 255) - 1, 0)]
    rng = np.random.default_rng(5)
    pairs += [(int.from_bytes(rng.bytes(32), "little") & ((1 << 255) - 1), int(rng.integers(2)))
              for _ in range(9)]
    return pairs


def _to_np(x):
    return np.asarray(x).astype(np.int64)


def _assert_point_eq(jp, tp):
    for jc, tc in zip(jp, tp):
        np.testing.assert_array_equal(_to_np(jc), tc.numpy())


@pytest.fixture(scope="module")
def decoded():
    pairs = _decode_inputs()
    ys = np.stack([F.int_to_limbs(y) for y, _ in pairs], axis=-1)
    signs = np.array([s for _, s in pairs], np.int32)
    jp, jok = JC.decompress(jnp.asarray(ys), jnp.asarray(signs))
    tp, tok = C.decompress(torch.from_numpy(ys.astype(np.int64)), torch.from_numpy(signs.astype(np.int64)))
    return pairs, jp, np.asarray(jok), tp, tok.numpy()


def test_decode_matches_limb_for_limb(decoded):
    pairs, jp, jok, tp, tok = decoded
    np.testing.assert_array_equal(jok, tok)
    _assert_point_eq(jp, tp)
    # the RFC keys and the order-8 point decode, x = 0 with the sign bit
    # does not, and some random y are non-points
    ok = dict(zip(pairs, tok.tolist()))
    assert ok[(1, 0)] and ok[(P - 1, 0)] and ok[(0, 0)]
    assert not ok[(1, 1)] and not ok[(P - 1, 1)]
    assert 0 < sum(tok[-9:]) < 9


def test_add_double_negate_madd_match(decoded):
    _, jp, _, tp, _ = decoded
    jq = JC.Point(*(jnp.roll(c, 3, axis=1) for c in jp))
    tq = C.Point(*(torch.roll(c, 3, dims=1) for c in tp))
    _assert_point_eq(JC.add(jp, jq), C.add(tp, tq))
    _assert_point_eq(JC.double(jp), C.double(tp))
    _assert_point_eq(JC.negate(jp), C.negate(tp))
    lanes = tp.x.shape[1]
    idx = np.arange(lanes) % 9
    tabs = (C.B_TAB_YPX, C.B_TAB_YMX, C.B_TAB_XY2D)
    j_ent = [jnp.asarray(t[idx].T) for t in tabs]
    t_ent = [torch.from_numpy(t[idx].T.astype(np.int64)) for t in tabs]
    _assert_point_eq(JC.madd_niels(jp, *j_ent), C.madd_niels(tp, *t_ent))


def test_basepoint_niels_tables_equal_the_reference_as_integers():
    for mine, ref in ((C.B_TAB_YPX, JC._B_TAB_YPX), (C.B_TAB_YMX, JC._B_TAB_YMX),
                      (C.B_TAB_XY2D, JC._B_TAB_XY2D)):
        assert mine.shape == ref.shape == (9, F.NLIMBS)
        assert [F.limbs_to_int(r) for r in mine] == [JF.limbs_to_int(r) for r in ref]


def test_signed_recode_and_digits_match():
    rng = np.random.default_rng(9)
    scal = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    scal[0] = 0xFF  # the top window's carry is dropped, as in the reference
    scal[1] = 0
    bits = np.unpackbits(scal, axis=1, bitorder="little").astype(np.int32)
    jdig = JC.digits4_from_bits(jnp.asarray(bits.T))
    tdig = C.digits4_from_bytes(torch.from_numpy(scal))
    np.testing.assert_array_equal(_to_np(jdig), tdig.numpy())
    jm, jn = JC.recode_signed4(jdig)
    tm, tn = C.recode_signed4(tdig)
    np.testing.assert_array_equal(_to_np(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


def test_ladder_matches_limb_for_limb(decoded):
    _, jp, _, tp, _ = decoded
    lanes = tp.x.shape[1]
    rng = np.random.default_rng(11)
    s_dig = rng.integers(0, 16, (64, lanes)).astype(np.int32)
    h_dig = rng.integers(0, 16, (64, lanes)).astype(np.int32)
    s_dig[63] = rng.integers(0, 2, lanes)  # scalars < 2^253, as after mod L
    jq = JC.double_scalar_mul_windowed(jnp.asarray(s_dig), jnp.asarray(h_dig), JC.negate(jp))
    tq = C.double_scalar_mul_windowed(torch.from_numpy(s_dig.astype(np.int64)),
                                      torch.from_numpy(h_dig.astype(np.int64)), C.negate(tp))
    _assert_point_eq(jq, tq)
