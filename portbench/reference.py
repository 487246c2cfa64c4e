"""The plain reference of the quorum step: verdicts, counts per slot and
commits, worked out again from the raw items.

It imports nothing of the program under test and takes nothing that the
program made: it reads the raw lanes (public key, message, signature) and
the slot of each, as the generator hands them to both sides.

A verdict is RFC 8032's cofactorless verify, checked as OpenSSL checks it:
S < L, A decodes, and the encoding of [S]B - [h]A equals the signature's R
bytes (an encoding is always canonical, so an R with y >= p, or that names
no point, never matches).  The signers are the cluster's replicas, so each
distinct key gets a comb table of its negation, and a lane costs 64 + 64
mixed additions of table entries and one inversion; the tables and h =
SHA-512(R || A || M) mod L are made on the host with Python integers
(:mod:`portbench.ed25519`).  The additions run batched over lanes in plain
PyTorch: a field element is 16 limbs of 16 bits held in float64, a multiply
is one broadcast product and one matrix product against a 0/1 matrix that
sums its columns, every value exact below 2^53 (bounds at :func:`mul`).
This is a different algorithm and a different representation from the
program's kernels and from its own plain versions.

The count of a slot is the number of its lanes whose verdict is True; a slot
commits when its count reaches the threshold.  ``check_s=False`` drops the
S < L rule: the control, which breaks the configuration's guarantee of
canonical, non-malleable signatures.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import ed25519 as E

NL = 16  # limbs
RADIX = 1 << 16
F64 = torch.float64

# 16 * p limb by limb: every limb is at least 2^19, above any limb that
# sub() takes away, so a + K - b stays non-negative limb by limb.
_P_LIMBS = [(E.P >> (16 * i)) & 0xFFFF for i in range(NL)]
_K_LIMBS = [16 * v for v in _P_LIMBS]


def _column_matrix(device) -> torch.Tensor:
    """(16, 256): row k sums the products a_i * b_j with i + j == k, and 38
    times those with i + j == k + 16 (2^256 is 38 mod p)."""
    m = torch.zeros(NL, NL * NL, dtype=F64)
    for i in range(NL):
        for j in range(NL):
            m[(i + j) % NL, i * NL + j] = 1.0 if i + j < NL else 38.0
    return m.to(device)


class Field:
    """GF(2^255 - 19) on (16, lanes) float64 tensors of one device.

    Invariant: inputs of :meth:`mul` have limbs in [0, 2^21); its outputs
    have limbs in [0, 2^17); :meth:`add` and :meth:`sub` of two values with
    limbs below 2^18 give limbs below 2^21."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cols = _column_matrix(self.device)
        self.k = torch.tensor(_K_LIMBS, dtype=F64, device=self.device)[:, None]

    def carry(self, c: torch.Tensor) -> torch.Tensor:
        """Three parallel carry passes; the carry out of limb 15 is 2^256,
        which is 38 mod p.  Takes :meth:`mul`'s columns (below 2^51.2,
        of which limb 15's below 2^46) and gives limbs below 2^17 (after
        pass 1: < 2^35.3; pass 2: < 2^24.6; pass 3: < 2^16 + 2^9)."""
        for _ in range(3):
            hi = torch.div(c, RADIX, rounding_mode="floor")
            c = torch.sub(c, hi, alpha=RADIX)
            c[1:] += hi[:-1]
            c[0].add_(hi[-1], alpha=38)
        return c

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b.  With limbs below 2^21: products < 2^42, and a column (at
        most 16 products, of which those at or above limb 16 count 38 times)
        at most 1 + 38 * 15 products, < 2^51.2; every partial sum is an
        integer below 2^53, so the float64 matrix product is exact."""
        lanes = a.shape[1]
        prod = (a[:, None, :] * b[None, :, :]).reshape(NL * NL, lanes)
        return self.carry(self.cols @ prod)

    def sq(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + (self.k - b)

    def invert(self, z: torch.Tensor) -> torch.Tensor:
        """z^(p-2), by ref10's chain (254 squarings, 11 multiplies)."""
        def sqn(x, n):
            for _ in range(n):
                x = self.sq(x)
            return x

        z2 = self.sq(z)
        z9 = self.mul(sqn(z2, 2), z)
        z11 = self.mul(z9, z2)
        z_5_0 = self.mul(self.sq(z11), z9)
        z_10_0 = self.mul(sqn(z_5_0, 5), z_5_0)
        z_20_0 = self.mul(sqn(z_10_0, 10), z_10_0)
        z_40_0 = self.mul(sqn(z_20_0, 20), z_20_0)
        z_50_0 = self.mul(sqn(z_40_0, 10), z_10_0)
        z_100_0 = self.mul(sqn(z_50_0, 50), z_50_0)
        z_200_0 = self.mul(sqn(z_100_0, 100), z_100_0)
        z_250_0 = self.mul(sqn(z_200_0, 50), z_50_0)
        return self.mul(sqn(z_250_0, 5), z11)

    def madd(self, p, q):
        """p + q, p extended (X, Y, Z, T), q an affine point in Niels form
        (y + x, y - x, 2dxy) (madd-2008-hwcd-3; complete)."""
        x1, y1, z1, t1 = p
        ypx, ymx, xy2d = q
        a = self.mul(self.sub(y1, x1), ymx)
        b = self.mul(self.add(y1, x1), ypx)
        c = self.mul(t1, xy2d)
        d = self.add(z1, z1)
        e, f, g, h = self.sub(b, a), self.sub(d, c), self.add(d, c), self.add(b, a)
        return self.mul(e, f), self.mul(g, h), self.mul(f, g), self.mul(e, h)


def ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """Integers in [0, 2^256) -> (len, 16) float64 limbs of 16 bits."""
    raw = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, NL).astype(np.float64)


def limbs_to_ints(limbs: torch.Tensor) -> List[int]:
    """(16, lanes) limbs, each in [0, 2^17) -> the integers they sum to."""
    c = limbs.to(torch.int64).cpu()
    out = torch.zeros(NL + 1, c.shape[1], dtype=torch.int64)
    carry = torch.zeros(c.shape[1], dtype=torch.int64)
    for i in range(NL):
        t = c[i] + carry
        out[i] = t & 0xFFFF
        carry = t >> 16
    out[NL] = carry
    low = out[:NL].numpy().astype("<u2").T.copy()
    top = out[NL].tolist()
    return [int.from_bytes(row.tobytes(), "little") + (hi << 256) for row, hi in zip(low, top)]


def niels_rows(points: Sequence[E.Point]) -> np.ndarray:
    """(len, 48) float64: each point's (y + x, y - x, 2dxy) limbs, affine."""
    vals = []
    for x, y in E.affine_batch(points):
        vals += [(y + x) % E.P, (y - x) % E.P, E.D2 * x * y % E.P]
    return ints_to_limbs(vals).reshape(len(points), 3 * NL)


def _digits(scalars: np.ndarray) -> torch.Tensor:
    """(lanes, 32) uint8 little-endian scalars -> (lanes, 64) 4-bit digits."""
    lo = scalars & 15
    hi = scalars >> 4
    return torch.from_numpy(np.stack([lo, hi], axis=2).reshape(-1, 64).astype(np.int64))


class Reference:
    """Verdicts, counts and commits of quorum-step batches (module docstring)."""

    def __init__(self, device, block: int = 1 << 18):
        self.device = torch.device(device)
        self.block = block
        self.field = Field(self.device)
        self.b_table = torch.from_numpy(niels_rows([p for row in E.base_table() for p in row])).to(self.device)
        self._keys: Dict[bytes, int] = {}
        self._key_ok: List[bool] = []
        self._a_rows: List[np.ndarray] = []
        self._a_table = None

    def _key_index(self, pub: bytes) -> int:
        """Index of a distinct public key; builds its table of -A on first
        sight (an A that does not decode gets a table of zeros, unused)."""
        k = self._keys.get(pub)
        if k is None:
            k = self._keys[pub] = len(self._key_ok)
            a_pt = E.decompress(pub)
            self._key_ok.append(a_pt is not None)
            if a_pt is None:
                self._a_rows.append(np.zeros((64 * 16, 3 * NL)))
            else:
                self._a_rows.append(niels_rows([p for row in E.comb_table(E.negate(a_pt)) for p in row]))
            self._a_table = None
        return k

    def verdicts(self, pubs: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
                 check_s: bool = True) -> np.ndarray:
        """(lanes,) bool: RFC 8032's cofactorless verdict of each lane (with
        ``check_s=False``, without the S < L rule)."""
        n = len(pubs)
        out = np.zeros(n, dtype=bool)
        pre = np.zeros(n, dtype=bool)
        kidx = np.zeros(n, dtype=np.int64)
        s_rows = np.zeros((n, 32), dtype=np.uint8)
        h_rows = np.zeros((n, 32), dtype=np.uint8)
        r_vals: List[int] = [0] * n
        for i, (pub, msg, sig) in enumerate(zip(pubs, msgs, sigs)):
            if len(pub) != 32 or len(sig) != 64:
                continue
            k = self._key_index(bytes(pub))
            s = int.from_bytes(sig[32:], "little")
            if not self._key_ok[k] or (check_s and s >= E.L):
                continue
            pre[i] = True
            kidx[i] = k
            s_rows[i] = np.frombuffer(sig[32:], dtype=np.uint8)
            h = int.from_bytes(hashlib.sha512(bytes(sig[:32]) + bytes(pub) + bytes(msg)).digest(), "little") % E.L
            h_rows[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
            r_vals[i] = int.from_bytes(sig[:32], "little")
        if self._a_table is None and self._a_rows:
            self._a_table = torch.from_numpy(np.concatenate(self._a_rows)).to(self.device)
        lanes = np.flatnonzero(pre)
        for lo in range(0, len(lanes), self.block):
            sel = lanes[lo: lo + self.block]
            enc = self._encode(kidx[sel], s_rows[sel], h_rows[sel])
            for j, (y, x_odd) in zip(sel, enc):
                r = r_vals[j]
                out[j] = (r & ((1 << 255) - 1)) == y and (r >> 255) == x_odd
        return out

    def _encode(self, kidx: np.ndarray, s_rows: np.ndarray, h_rows: np.ndarray) -> List[Tuple[int, int]]:
        """For each lane, (y, x mod 2) of [S]B + [h](-A) in affine form."""
        f = self.field
        n = len(kidx)
        dev = self.device
        s_dig = _digits(s_rows).to(dev)
        h_dig = _digits(h_rows).to(dev)
        base = torch.from_numpy(kidx * (64 * 16)).to(dev)
        zero = torch.zeros(NL, n, dtype=F64, device=dev)
        one = zero.clone()
        one[0] = 1
        acc = (zero, one, one.clone(), zero.clone())
        for w in range(64):
            for table, idx in ((self.b_table, w * 16 + s_dig[:, w]), (self._a_table, base + w * 16 + h_dig[:, w])):
                rows = table.index_select(0, idx).T.reshape(3, NL, n)
                acc = f.madd(acc, (rows[0], rows[1], rows[2]))
        x, y, z, _ = acc
        zi = f.invert(z)
        xs = limbs_to_ints(f.mul(x, zi))
        ys = limbs_to_ints(f.mul(y, zi))
        return [(yv % E.P, (xv % E.P) & 1) for xv, yv in zip(xs, ys)]


def tally(verdicts: np.ndarray, group_ids: np.ndarray, n_groups: int, threshold: int):
    """(counts int32 (n_groups,), committed bool (n_groups,)): lanes of each
    slot whose verdict is True, and whether that reaches the threshold."""
    ids = np.asarray(group_ids, dtype=np.int64)
    if len(ids) and (ids.min() < 0 or ids.max() >= n_groups):
        raise ValueError("a slot id lies outside [0, n_groups)")
    counts = np.bincount(ids[np.asarray(verdicts, dtype=bool)], minlength=n_groups).astype(np.int32)
    return counts, counts >= threshold
