"""Ed25519 group operations on tensors: the plain version of the verify kernel.

Counterpart of the reference package's ``crypto/curve.py``.  Points are
extended twisted-Edwards coordinates (X : Y : Z : T) whose coordinates are
``(17, *lanes)`` limb tensors (:mod:`.field`); every formula is the
reference's (complete add-2008-hwcd-3 addition, dbl-2008-hwcd doubling,
madd-2008-hwcd-3 Niels addition), so every intermediate equals the
reference's limb for limb.  Where the reference used masked select sums
(a vector-unit workaround), this module indexes its tables directly.

:func:`verify_prepared_packed` is the plain version of
:mod:`.cuda_verify`'s kernel: the CPU tests run it, and the chip smoke test
compares the kernel with it on the card.  It is never on the main path when
a card is present.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import field as F


class Point(NamedTuple):
    """Extended coordinates, each a ``(17, *lanes)`` limb tensor."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(lanes, device="cpu") -> Point:
    zero = F.zeros(lanes, device)
    one = F.one(lanes, device)
    return Point(zero, one, one, zero)


_D2_INT = (2 * F.D_INT) % F.P_INT


def add(p: Point, q: Point) -> Point:
    """Complete unified addition (add-2008-hwcd-3, a = -1)."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q.y, q.x))
    b = F.mul(F.add(p.y, p.x), F.add(q.y, q.x))
    c = F.mul(F.mul(p.t, F.const(_D2_INT, p.t.shape[1:], p.t.device)), q.t)
    d = F.mul(F.add(p.z, p.z), q.z)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double(p: Point) -> Point:
    """Doubling (dbl-2008-hwcd, a = -1)."""
    a = F.square(p.x)
    b = F.square(p.y)
    c = F.mul_small(F.square(p.z), 2)
    h = F.add(a, b)
    e = F.sub(h, F.square(F.add(p.x, p.y)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def negate(p: Point) -> Point:
    return Point(F.neg(p.x), p.y, p.z, F.neg(p.t))


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor) -> Tuple[Point, torch.Tensor]:
    """RFC 8032 section 5.1.3 decode, batched.

    ``y_limbs`` ``(17, lanes)``; ``sign`` ``(lanes,)`` in {0, 1}.  Returns
    (point with Z = 1, ok); ok is False for a non-point (no square root, or
    x = 0 with sign = 1)."""
    lanes = y_limbs.shape[1:]
    dev = y_limbs.device
    yy = F.square(y_limbs)
    one = F.one(lanes, dev)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, F.const(F.D_INT, lanes, dev)), one)
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))

    vxx = F.mul(v, F.square(x))
    root_ok = F.eq(vxx, u)
    root_neg = F.eq(vxx, F.neg(u))
    x = F.select(root_neg, F.mul(x, F.const(F.SQRT_M1_INT, lanes, dev)), x)
    ok = root_ok | root_neg

    x_can = F.canonical(x)
    x_is_zero = torch.all(x_can == 0, dim=0)
    ok = ok & ~(x_is_zero & (sign == 1))
    flip = (x_can[0] & 1) != sign
    x = F.select(flip, F.neg(x), x)
    return Point(x, y_limbs, one, F.mul(x, y_limbs)), ok


# ----------------------------------------------------------------- ladder


def _py_edwards_add(p, q):
    """Affine Edwards addition on python ints (table precompute only)."""
    P, D = F.P_INT, F.D_INT
    x1, y1 = p
    x2, y2 = q
    k = D * x1 * x2 * y1 * y2 % P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + k, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - k, P - 2, P) % P
    return (x3, y3)


def basepoint_multiples():
    """Affine [d]B for d in 0..8, python ints."""
    pts = [(0, 1)]
    for _ in range(8):
        pts.append(_py_edwards_add(pts[-1], (F.BX_INT, F.BY_INT)))
    return pts


def basepoint_niels_ints():
    """[d]B, d in 0..8, in Niels form as python ints: (y+x, y-x, 2dxy)."""
    P = F.P_INT
    return [
        ((y + x) % P, (y - x) % P, 2 * F.D_INT * x * y % P)
        for x, y in basepoint_multiples()
    ]


def _basepoint_niels_table():
    """The Niels table as three (9, 17) int32 arrays (signed 4-bit windows:
    a negative digit reuses entry |d| with the Niels negation)."""
    ents = basepoint_niels_ints()
    return tuple(
        np.stack([F.int_to_limbs(e[c]) for e in ents]) for c in range(3)
    )


B_TAB_YPX, B_TAB_YMX, B_TAB_XY2D = _basepoint_niels_table()
N_TABLE = 9  # [0..8]P: signed 4-bit windows need magnitudes 0..8 only


def madd_niels(p: Point, ypx: torch.Tensor, ymx: torch.Tensor, xy2d: torch.Tensor) -> Point:
    """Mixed addition with a Niels-form point (madd-2008-hwcd-3)."""
    a = F.mul(F.sub(p.y, p.x), ymx)
    b = F.mul(F.add(p.y, p.x), ypx)
    c = F.mul(xy2d, p.t)
    d = F.add(p.z, p.z)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def digits4_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 little-endian scalars -> (64, B) base-16 digits."""
    b = b.to(F.DTYPE)
    return torch.stack([b & 15, b >> 4], dim=2).reshape(b.shape[0], 64).T


def recode_signed4(dig: torch.Tensor):
    """Base-16 digits -> (magnitude in [0, 8], negative flag), the
    reference's exact recode: the last window's carry is dropped."""
    mags, negs = [], []
    c = torch.zeros(dig.shape[1:], dtype=F.DTYPE, device=dig.device)
    for k in range(dig.shape[0]):
        t = dig[k] + c
        carry = (t > 8).to(F.DTYPE)
        d = t - 16 * carry
        c = carry
        neg = d < 0
        mags.append(torch.where(neg, -d, d))
        negs.append(neg)
    return torch.stack(mags, dim=0), torch.stack(negs, dim=0)


def small_multiples_table(p: Point):
    """[0..8]P: four ``(9, 17, lanes)`` tensors, by chained additions."""
    pts = [identity(p.x.shape[1:], p.x.device)]
    for _ in range(N_TABLE - 1):
        pts.append(add(pts[-1], p))
    return tuple(torch.stack([getattr(pt, c) for pt in pts], dim=0) for c in "xyzt")


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane row ``idx[j]`` of ``table`` ((9, 17, B) or (9, 17)) -> (17, B)."""
    if table.dim() == 2:
        return table[idx].T
    return table[idx, :, torch.arange(idx.shape[0], device=idx.device)].T


def double_scalar_mul_windowed(s_dig: torch.Tensor, p_dig: torch.Tensor, p_point: Point) -> Point:
    """[s]B + [p]P over 64 signed 4-bit windows, most significant first.
    ``s_dig``/``p_dig``: (64, lanes) base-16 digits."""
    dev = s_dig.device
    lanes = s_dig.shape[1:]
    s_mag, s_neg = recode_signed4(s_dig)
    p_mag, p_neg = recode_signed4(p_dig)
    a_tab = small_multiples_table(p_point)
    b_tab = tuple(torch.from_numpy(t.astype(np.int64)).to(dev) for t in (B_TAB_YPX, B_TAB_YMX, B_TAB_XY2D))
    q = identity(lanes, dev)
    for w in range(63, -1, -1):
        q = double(double(double(double(q))))
        ex, ey, ez, et = (_take(c, p_mag[w]) for c in a_tab)
        pn = p_neg[w]
        q = add(q, Point(F.select(pn, F.neg(ex), ex), ey, ez, F.select(pn, F.neg(et), et)))
        nypx, nymx, nxy2d = (_take(c, s_mag[w]) for c in b_tab)
        sn = s_neg[w]
        nypx, nymx = F.select(sn, nymx, nypx), F.select(sn, nypx, nymx)
        nxy2d = F.select(sn, F.neg(nxy2d), nxy2d)
        q = madd_niels(q, nypx, nymx, nxy2d)
    return q


def verify_core(y_a, sign_a, y_r, sign_r, s_dig, h_dig) -> torch.Tensor:
    """Limbs-leading batched verify -> (lanes,) bool: decode A and R, then
    the cofactorless equation as Q = [S]B + [h](-A) == R, compared
    projectively (X_Q == x_R Z_Q, Y_Q == y_R Z_Q)."""
    a_point, ok_a = decompress(y_a, sign_a)
    r_point, ok_r = decompress(y_r, sign_r)
    q = double_scalar_mul_windowed(s_dig, h_dig, negate(a_point))
    eq_x = F.eq(q.x, F.mul(r_point.x, q.z))
    eq_y = F.eq(q.y, F.mul(r_point.y, q.z))
    return ok_a & ok_r & eq_x & eq_y


def verify_prepared_packed(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes) -> torch.Tensor:
    """Batch-leading public layout, as the reference's: ``y_a``/``y_r``
    (B, 17) int32 limbs, ``sign_*`` (B,), ``s_bytes``/``h_bytes`` (B, 32)
    uint8 -> (B,) bool bitmap."""
    return verify_core(
        y_a.to(F.DTYPE).T,
        sign_a.to(F.DTYPE),
        y_r.to(F.DTYPE).T,
        sign_r.to(F.DTYPE),
        digits4_from_bytes(s_bytes),
        digits4_from_bytes(h_bytes),
    )
