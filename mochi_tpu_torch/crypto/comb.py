"""Known-signer comb verification: doubling-free Ed25519 for registered keys.

Counterpart of the reference package's ``crypto/comb.py``.  The cluster's
certificate traffic is signed by the n replica identities of the cluster
configuration.  For such a REGISTERED key the host precomputes, once, the
Niels-form table

    T[w][d] = [d * 16^w](-A)      w in 0..63, d in 0..8

(and the module keeps the same table for the basepoint B), so the check
[S]B + [h](-A) == R becomes a sum of 128 table points with no doublings:

    Q = sum_w  B_tab[w][s_w]  +  T[key][w][h_w]      (signed 4-bit digits)

Three layers live here:

* **Host tables** (python ints and numpy, no torch): ``decompress_host``,
  ``signer_table``, ``_b_comb`` — byte-equal to the reference's (64, 9, 51)
  int32 rows in the 17 x 15-bit layout.
* :class:`SignerRegistry` — pubkey -> index, the tables, and their copies
  on a device, pinned per generation, in the layout the kernel of a launch
  reads: ``radix25`` (converted once to the kernel radix 2^25.5 for
  ``comb.cu`` and ``comb_tree.cu``,
  :func:`mochi_tpu_torch.crypto.cuda_comb.to_radix25`) or ``fe17`` (the
  17 x 15 rows as they are, for ``comb_mxu.cu`` and the plain version).
* :func:`verify_comb_prepared` — the plain PyTorch version of both comb
  kernels, limb-equal to the reference's two accumulations: ``impl="chain"``
  (``csrc/comb.cu``, 128 dependent mixed additions) and ``impl="tree"``
  (``csrc/comb_tree.cu``, the 128 window points converted from Niels to
  extended form and summed by a 7-level balanced tree of complete
  additions).  Its multiplies follow ``MOCHI_SKEW_IMPL`` as the
  reference's do, so under ``mxu`` the chain is also the plain version of
  ``csrc/comb_mxu.cu``.  The CPU tests run it and the chip smoke test holds
  the kernels against it; it is never on the main path when a card is
  present.

``MOCHI_COMB_IMPL``, read at import into :data:`COMB_IMPL` as the
reference reads it, chooses the accumulation for every caller that does not
name one: ``tree`` the tree, any other value the chain (the default), as the
reference runs the chain for every value but ``tree``.  The reference
selects the tree's basepoint rows with a one-hot float32 matmul; here that
select is an exact integer gather, so no float product (exact only while
TF32 is off, ROADMAP.md Queue C) is anywhere on either path.

Verdict semantics are the general path's: the same host prechecks, R's RFC
8032 decode on the device, the same cofactorless equation.  Registration
decodes A on the host and refuses a non-canonical or non-point key, which
then simply takes the general kernel.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import curve
from . import field as F

N_WINDOWS = 64
N_ENTRIES = 9  # signed 4-bit digits: magnitudes 0..8
ROWS_PER_SIGNER = N_WINDOWS * N_ENTRIES
ROW_WIDTH = 3 * F.NLIMBS  # ypx | ymx | xy2d

COMB_IMPLS = ("chain", "tree")

# Layouts of a device table (SignerRegistry.device_table): the kernel radix
# 2^25.5 and the registry's own 17 x 15 rows.
LAYOUTS = ("radix25", "fe17")


_substituted: set = set()


def check_impl(impl: Optional[str]) -> str:
    """The accumulation that runs for ``impl`` (:data:`COMB_IMPL` when
    None): ``tree`` for ``tree``, ``chain`` for any other value, as the
    reference does; a name other than the two is said once on stderr."""
    impl = COMB_IMPL if impl is None else impl
    if impl == "tree":
        return "tree"
    if impl != "chain" and impl not in _substituted:
        _substituted.add(impl)
        print(f"mochi_tpu_torch: comb accumulation {impl!r} (MOCHI_COMB_IMPL or impl=) runs the chain, "
              "as the reference does for any value but 'tree'", file=sys.stderr)
    return "chain"


# The accumulation every comb verify runs unless its caller names one.
COMB_IMPL = check_impl(os.environ.get("MOCHI_COMB_IMPL", "chain"))

# (p+1)/2: multiplying by it halves a field element (Niels y+x, y-x -> x, y)
_INV2_INT = (F.P_INT + 1) // 2
# 1/(2d): recovers t = x*y from the Niels xy2d coordinate
_INV_2D_INT = pow(2 * F.D_INT % F.P_INT, F.P_INT - 2, F.P_INT)


# --------------------------------------------------------------------------
# Host point arithmetic (python ints, extended coordinates).  Table builds
# run one batched inversion at the end (Montgomery trick).


def _ext_add(p, q):
    """Complete unified addition (add-2008-hwcd-3, the device's law) on
    python-int extended coordinates (X, Y, Z, T)."""
    P = F.P_INT
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * F.D_INT * t1 % P * t2 % P
    d = 2 * z1 * z2 % P
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


_EXT_IDENTITY = (0, 1, 1, 0)


def _batch_affine(points) -> List[Tuple[int, int]]:
    """Extended -> affine for a list of points with ONE modular inversion."""
    P = F.P_INT
    zs = [pt[2] for pt in points]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv_all = pow(prefix[-1], P - 2, P)
    out: List[Optional[Tuple[int, int]]] = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        z_inv = prefix[i] * inv_all % P
        inv_all = inv_all * zs[i] % P
        out[i] = (points[i][0] * z_inv % P, points[i][1] * z_inv % P)
    return out  # type: ignore[return-value]


def decompress_host(pub: bytes) -> Optional[Tuple[int, int]]:
    """RFC 8032 section 5.1.3 point decoding on host ints: affine (x, y), or
    None for y >= p, no square root, or x = 0 with the sign bit set."""
    if len(pub) != 32:
        return None
    P = F.P_INT
    enc = int.from_bytes(pub, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (F.D_INT * y * y + 1) % P
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (-u) % P:
        x = x * F.SQRT_M1_INT % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y)


def _comb_table_rows(x: int, y: int) -> np.ndarray:
    """(64, 9, 51) int32 Niels comb table for the affine point (x, y):
    row [w][d] = [d * 16^w](x, y) as (y+x | y-x | 2dxy) limbs."""
    P = F.P_INT
    base = (x, y, 1, x * y % P)
    pts = []
    for _ in range(N_WINDOWS):
        acc = _EXT_IDENTITY
        for _d in range(N_ENTRIES - 1):
            acc = _ext_add(acc, base)
            pts.append(acc)
        for _ in range(4):  # next window's base = [16] base
            base = _ext_add(base, base)
    affine = _batch_affine(pts)
    rows = np.zeros((N_WINDOWS, N_ENTRIES, ROW_WIDTH), dtype=np.int32)
    one = F.int_to_limbs(1)  # d = 0 is the identity: Niels (1, 1, 0)
    rows[:, 0, : F.NLIMBS] = one
    rows[:, 0, F.NLIMBS : 2 * F.NLIMBS] = one
    k = 0
    for w in range(N_WINDOWS):
        for d in range(1, N_ENTRIES):
            ax, ay = affine[k]
            k += 1
            rows[w, d, : F.NLIMBS] = F.int_to_limbs((ay + ax) % P)
            rows[w, d, F.NLIMBS : 2 * F.NLIMBS] = F.int_to_limbs((ay - ax) % P)
            rows[w, d, 2 * F.NLIMBS :] = F.int_to_limbs(2 * F.D_INT * ax % P * ay % P)
    return rows


def signer_table(pub: bytes) -> Optional[np.ndarray]:
    """(64, 9, 51) comb table for -A (the verify equation uses [h](-A)),
    or None if ``pub`` is not a canonical curve-point encoding."""
    aff = decompress_host(pub)
    if aff is None:
        return None
    x, y = aff
    return _comb_table_rows((F.P_INT - x) % F.P_INT if x else 0, y)


_B_COMB: Optional[np.ndarray] = None
_B_COMB_LOCK = threading.Lock()


def _b_comb() -> np.ndarray:
    """(64, 9, 51) comb table for +B, built lazily once."""
    global _B_COMB
    if _B_COMB is None:
        with _B_COMB_LOCK:
            if _B_COMB is None:
                _B_COMB = _comb_table_rows(F.BX_INT, F.BY_INT)
    return _B_COMB


# --------------------------------------------------------------------------
# Registry


class SignerRegistry:
    """Pubkey -> comb table registry, with device copies pinned per
    generation.

    Indices are stable and registration is idempotent; an invalid encoding
    is refused (None) and its traffic stays on the general kernel.
    ``generation`` is the table count.  Device tables pad the capacity to a
    power of two (at least 8), so the table is rebuilt only when the signer
    set doubles; the padding is byte for byte the reference's (zero rows
    behind registered signers, identity rows in an empty registry).
    Thread-safe: the cluster registers replica identities at boot and on
    reconfiguration while the verifier's executor threads read.
    """

    def __init__(self, device="cuda"):
        self._device = torch.device(device)
        self._idx: Dict[bytes, int] = {}
        self._tables: List[np.ndarray] = []
        self._rejected: set = set()
        self._lock = threading.Lock()
        # (device, capacity, layout) -> (tensor, rows filled at build time)
        self._dev_tables: Dict[tuple, tuple] = {}

    def __len__(self) -> int:
        return len(self._idx)

    @property
    def generation(self) -> int:
        """Monotone registration count.  Routing pins it: keys registered
        after the pinned generation take the general kernel, and the pinned
        table keeps that generation's shape."""
        return len(self._tables)

    def register(self, pub: bytes) -> Optional[int]:
        """Add a signer; returns its index, or None for an invalid encoding."""
        pub = bytes(pub)
        with self._lock:
            if pub in self._idx:
                return self._idx[pub]
            if pub in self._rejected:
                return None
        tab = signer_table(pub)  # outside the lock: host math
        with self._lock:
            if pub in self._idx:  # raced with another registrar
                return self._idx[pub]
            if tab is None:
                self._rejected.add(pub)
                return None
            idx = len(self._tables)
            self._tables.append(tab)
            self._idx[pub] = idx
            return idx

    def register_all(self, pubs: Sequence[bytes]) -> None:
        for p in pubs:
            self.register(p)

    def index_of(self, pub: bytes) -> Optional[int]:
        return self._idx.get(bytes(pub))

    def public_keys(self) -> List[bytes]:
        """Registered keys in index order."""
        with self._lock:
            return sorted(self._idx, key=self._idx.__getitem__)

    @staticmethod
    def _capacity_for(gen: int) -> int:
        cap = 8
        while cap < gen:
            cap *= 2
        return cap

    def host_table(self, gen: Optional[int] = None) -> np.ndarray:
        """(capacity * 576, 51) int32 flat table in the 17 x 15 layout, at
        generation ``gen`` (default: current) — the reference's
        ``device_table`` contents."""
        with self._lock:
            return self._host_table_locked(len(self._tables) if gen is None else gen)

    def _host_table_locked(self, gen: int) -> np.ndarray:
        cap = self._capacity_for(max(1, gen))
        n_rows = min(len(self._tables), cap)
        flat = np.zeros((cap, N_WINDOWS, N_ENTRIES, ROW_WIDTH), np.int32)
        if n_rows:
            flat[:n_rows] = np.stack(self._tables[:n_rows])  # unused slots stay zero
        else:
            # even an empty registry ships well-formed identity rows
            one = F.int_to_limbs(1)
            flat[..., : F.NLIMBS] = one
            flat[..., F.NLIMBS : 2 * F.NLIMBS] = one
        return flat.reshape(cap * ROWS_PER_SIGNER, ROW_WIDTH)

    def device_table(self, device=None, gen: Optional[int] = None, *, layout: str) -> torch.Tensor:
        """The flat table on ``device``, at the capacity of generation
        ``gen`` (default: current), in ``layout`` (one of :data:`LAYOUTS`):
        ``radix25``, the (capacity * 576, 3, 10) int32 table ``comb.cu`` and
        ``comb_tree.cu`` read (converted once, exactly, at upload), or
        ``fe17``, the (capacity * 576, 51) int32 17 x 15 rows as they are,
        which ``comb_mxu.cu`` and the plain version read.  The caller names
        it: :func:`cuda_comb.table_layout` says which one a launch reads.
        Each layout is cached apart: one never replaces the other.

        A returned tensor is never freed or reshaped while a caller holds
        it: a registration that outgrows the cached table builds a new one
        and drops only the registry's reference, so a launch that keeps the
        table in its launched tuple until readback (``batch_verify``) reads
        valid rows on whatever stream it runs.  Content newer than ``gen``
        is harmless (those rows are never indexed by a caller pinned at
        ``gen``).
        """
        device = self._device if device is None else torch.device(device)
        if layout not in LAYOUTS:
            raise ValueError(f"table layout {layout!r}: expected one of {LAYOUTS}")
        with self._lock:
            cur = len(self._tables)
            g = cur if gen is None else gen
            cap = self._capacity_for(max(1, g))
            key = (str(device), cap, layout)
            cached = self._dev_tables.get(key)
            if cached is not None and cached[1] >= min(cur, cap):
                return cached[0]
            flat = self._host_table_locked(g)
            n_rows = min(cur, cap)
            if layout == "radix25":
                from .cuda_comb import to_radix25

                flat = to_radix25(flat)
            tab = torch.from_numpy(flat).to(device)
            if device.type == "cuda":
                # the upload must land before a kernel on any other
                # thread's stream reads the table
                torch.cuda.current_stream(device).synchronize()
            self._dev_tables[key] = (tab, n_rows)
            return tab


# --------------------------------------------------------------------------
# The plain version of the comb kernel


def _tree_accumulate(ypx, ymx, xy2d, n_points: int, lanes_n: int) -> curve.Point:
    """Balanced-tree sum of ``n_points`` Niels points per lane.

    Coordinates arrive limbs leading over a fused point * lane axis,
    (17, P*B) with the point axis MAJOR, signs already applied.  Each point
    becomes extended (x, y, 1, xy) with 3 constant multiplies, then each of
    log2(P) levels adds point i to point i + P/2 with the complete addition:
    the reference's ``_tree_accumulate`` step for step.
    """
    lanes = ypx.shape[1:]
    inv2 = F.const(_INV2_INT, lanes, ypx.device)
    inv2d = F.const(_INV_2D_INT, lanes, ypx.device)
    x = F.mul(F.sub(ypx, ymx), inv2)
    y = F.mul(F.add(ypx, ymx), inv2)
    t = F.mul(xy2d, inv2d)
    pt = curve.Point(x, y, F.one(lanes, ypx.device), t)
    p = n_points
    while p > 1:
        half = p // 2
        split = [c.reshape(F.NLIMBS, p, lanes_n) for c in pt]
        lo = curve.Point(*(c[:, :half].reshape(F.NLIMBS, half * lanes_n) for c in split))
        hi = curve.Point(*(c[:, half:].reshape(F.NLIMBS, half * lanes_n) for c in split))
        pt = curve.add(lo, hi)
        p = half
    return pt


def verify_comb_prepared(table_flat, key_idx, y_r, sign_r, s_bytes, h_bytes,
                         impl: Optional[str] = None) -> torch.Tensor:
    """Batched comb verify -> (B,) bool bitmap, in plain PyTorch.

    ``table_flat``: (K*576, 51) int32 signer tables in the 17 x 15 layout
    (row [k*576 + w*9 + d] = Niels [d*16^w](-A_k)); ``key_idx``: (B,) int32
    registry indices; ``y_r`` (B, 17) int32 limbs and ``sign_r`` (B,) int32,
    the R encodings; ``s_bytes``/``h_bytes`` (B, 32) uint8 little-endian
    scalars; ``impl``: ``chain`` or ``tree`` (default :data:`COMB_IMPL`).
    The row index ``key_idx*576 + w*9 + |h_w|`` is clipped into the table,
    as the reference's ``jnp.take(..., mode="clip")`` does.  Every
    intermediate equals the reference's of the same ``impl`` limb for limb.
    Every rank-2 multiply follows ``field.SKEW_IMPL`` as the reference's
    does when traced: under ``mxu`` the chain here is the plain version of
    ``csrc/comb_mxu.cu`` (the plain ``_mul_mxu``), else of ``csrc/comb.cu``.
    """
    impl = check_impl(impl)
    dev = y_r.device
    s_mag, s_neg = curve.recode_signed4(curve.digits4_from_bytes(s_bytes))
    h_mag, h_neg = curve.recode_signed4(curve.digits4_from_bytes(h_bytes))
    r_point, ok_r = curve.decompress(y_r.to(F.DTYPE).T, sign_r.to(F.DTYPE))
    lanes = y_r.shape[:1]

    win = torch.arange(N_WINDOWS, dtype=F.DTYPE, device=dev)[:, None]
    flat_idx = key_idx.to(F.DTYPE)[None, :] * ROWS_PER_SIGNER + win * N_ENTRIES + h_mag
    flat_idx = flat_idx.clamp(0, table_flat.shape[0] - 1)
    a_rows = table_flat.to(F.DTYPE)[flat_idx]  # (64, B, 51)
    b_tab = torch.from_numpy(_b_comb().astype(np.int64)).to(dev)  # (64, 9, 51)

    def signed(row, neg):
        ypx, ymx, xy2d = row[: F.NLIMBS], row[F.NLIMBS : 2 * F.NLIMBS], row[2 * F.NLIMBS :]
        return F.select(neg, ymx, ypx), F.select(neg, ypx, ymx), F.select(neg, F.neg(xy2d), xy2d)

    if impl == "tree":
        n = lanes[0]
        # every window's basepoint row at once: the exact integer gather
        # b_tab[w][s_mag[w]] (the reference's one-hot f32 matmul selects the
        # same integers)
        b_rows = b_tab[win, s_mag]  # (64, B, 51)
        a = signed(a_rows.reshape(N_WINDOWS * n, ROW_WIDTH).T, h_neg.reshape(-1))
        b = signed(b_rows.reshape(N_WINDOWS * n, ROW_WIDTH).T, s_neg.reshape(-1))
        q = _tree_accumulate(*(torch.cat([ca, cb], dim=1) for ca, cb in zip(a, b)), 2 * N_WINDOWS, n)
    else:
        q = curve.identity(lanes, dev)
        for w in range(N_WINDOWS):
            q = curve.madd_niels(q, *signed(a_rows[w].T, h_neg[w]))
            q = curve.madd_niels(q, *signed(b_tab[w][s_mag[w]].T, s_neg[w]))
    eq_x = F.eq(q.x, F.mul(r_point.x, q.z))
    eq_y = F.eq(q.y, F.mul(r_point.y, q.z))
    return ok_r & eq_x & eq_y
