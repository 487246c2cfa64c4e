"""Ed25519 over Python integers (RFC 8032): key generation, signing, a plain
verify, and the fixed-base comb the generator and the reference share.

This is the benchmark's own arithmetic.  It imports nothing of the program
under test and is slow (a point addition costs a few microseconds), so it
does only what is done once a run: the basepoint's comb, the replicas' keys,
a pool of signing nonces, and the per-key tables of the batched reference
(:mod:`portbench.reference`).  :func:`verify` is the RFC's cofactorless
check one signature at a time; the tests hold the batched reference to it.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended coordinates (X : Y : Z : T)
IDENTITY: Point = (0, 1, 1, 0)


def recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 section 5.1.3: the x of the point with this y and sign, or
    None when there is none (y >= p, no square root, or x = 0 with sign 1)."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = recover_x(_BY, 0)
BASE: Point = (_BX, _BY, 1, _BX * _BY % P)


def add(p: Point, q: Point) -> Point:
    """Complete addition in extended coordinates (RFC 8032 section 5.1.4)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def negate(p: Point) -> Point:
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def to_affine(p: Point) -> Tuple[int, int]:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def affine_batch(points: Sequence[Point]) -> List[Tuple[int, int]]:
    """Affine (x, y) of many points with one inversion (Montgomery's trick)."""
    prefix = [1]
    for p in points:
        prefix.append(prefix[-1] * p[2] % P)
    inv = pow(prefix[-1], P - 2, P)
    out: List[Tuple[int, int]] = [(0, 0)] * len(points)
    for i in range(len(points) - 1, -1, -1):
        zi = inv * prefix[i] % P
        inv = inv * points[i][2] % P
        out[i] = (points[i][0] * zi % P, points[i][1] * zi % P)
    return out


def compress(p: Point) -> bytes:
    x, y = to_affine(p)
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(s: bytes) -> Optional[Point]:
    """The point a 32-byte encoding names, or None (RFC 8032 section 5.1.3)."""
    if len(s) != 32:
        return None
    v = int.from_bytes(s, "little")
    y, sign = v & ((1 << 255) - 1), v >> 255
    x = recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def comb_table(base: Point) -> List[List[Point]]:
    """table[w][d] = d * 16^w * base, for 64 windows of 4 bits."""
    table = []
    step = base
    for _ in range(64):
        row = [IDENTITY]
        for _ in range(15):
            row.append(add(row[-1], step))
        table.append(row)
        step = add(row[15], step)  # 16 * step
    return table


_B_TABLE: Optional[List[List[Point]]] = None


def base_table() -> List[List[Point]]:
    global _B_TABLE
    if _B_TABLE is None:
        _B_TABLE = comb_table(BASE)
    return _B_TABLE


def base_mul(k: int) -> Point:
    """[k]B for 0 <= k < 2^256, by the basepoint's comb."""
    table = base_table()
    acc = IDENTITY
    for w in range(64):
        d = (k >> (4 * w)) & 15
        if d:
            acc = add(acc, table[w][d])
    return acc


def scalar_mul(k: int, p: Point) -> Point:
    """[k]P by double-and-add (slow; tests and one-off use only)."""
    acc, q = IDENTITY, p
    while k:
        if k & 1:
            acc = add(acc, q)
        q = add(q, q)
        k >>= 1
    return acc


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def keypair(seed: bytes) -> Tuple[int, bytes, bytes]:
    """RFC 8032 section 5.1.5: (secret scalar a, nonce prefix, public key)."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return a, h[32:], compress(base_mul(a))


def challenge(r_bytes: bytes, pub: bytes, msg: bytes) -> int:
    return int.from_bytes(hashlib.sha512(r_bytes + pub + msg).digest(), "little") % L


def sign_with_nonce(a: int, pub: bytes, r: int, r_bytes: bytes, msg: bytes) -> bytes:
    """A signature with the nonce r (R = [r]B encoded as ``r_bytes``): valid
    under RFC 8032's verify for any r; the RFC's own r is :func:`sign`'s."""
    s = (r + challenge(r_bytes, pub, msg) * a) % L
    return r_bytes + s.to_bytes(32, "little")


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 section 5.1.6, the deterministic signature."""
    a, prefix, pub = keypair(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    return sign_with_nonce(a, pub, r, compress(base_mul(r)), msg)


def verify(pub: bytes, msg: bytes, sig: bytes, check_s: bool = True) -> bool:
    """RFC 8032 section 5.1.7, cofactorless: S < L, A and R decode, and
    [S]B == R + [h]A.  ``check_s=False`` drops the S < L rule (the
    malleable check that the benchmark's control stands for)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    a_pt = decompress(pub)
    r_pt = decompress(sig[:32])
    s = int.from_bytes(sig[32:], "little")
    if a_pt is None or r_pt is None or (check_s and s >= L):
        return False
    h = challenge(sig[:32], pub, msg)
    lhs = base_mul(s)
    rhs = add(r_pt, scalar_mul(h, a_pt))
    return to_affine(lhs) == to_affine(rhs)
