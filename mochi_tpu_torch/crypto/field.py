"""GF(2^255-19): constants, host limb helpers, and the plain PyTorch field ops.

Two representations live in the port:

* **The kernel's**, radix 2^25.5 in ten int32 limbs with int64 column
  sums (``csrc/fe25519.cuh``), chosen for Hopper's widening multiply.
* **This module's**, the reference package's 17 x 15-bit limb layout,
  limbs leading: a field element is a ``(17, *lanes)`` tensor.  The plain
  ops here repeat the reference's algorithm step for step (the same
  loose-carry discipline, the same lo/hi product split, the same carry
  passes), held in int64 tensors, so every intermediate value equals the
  reference's limb for limb and tests compare them as integers with
  :func:`limbs_to_int`.  These ops are the plain version of the kernel's
  arithmetic: the CPU tests run them, and the chip smoke test holds the
  kernel against them on the card.

Loose-carry invariant (the reference's proofs, unchanged because the
algorithm is unchanged): limbs in ``[0, LOOSE]`` with ``LOOSE = 2^15 + 96``;
products <= LOOSE^2 < 2^31; columns < 2^21; folded columns < 2^26; two
carry passes restore the invariant.  Exact reduction happens only in
:func:`canonical`.

``MOCHI_SKEW_IMPL`` (:data:`SKEW_IMPL`, read at import as the reference
reads it) chooses how a multiply reduces its 17 x 17 products to columns.
``mxu`` sends every multiply and squaring of two rank-2 ``(17, B)``
operands through :func:`_mul_mxu`, the column reduction as one matrix
product against a constant 0/1 matrix (the reference's MXU form); the
general verify kernel then becomes ``csrc/verify_mxu.cu``, the same
reduction on the integer tensor cores.  Every other value (``pad``, the
default, ``reshape`` and ``shift``, which are layouts of the same columns
in the reference, or an unknown name, which the reference also runs as
``pad``) takes the one schoolbook multiply here.  Both give the same limbs.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

NLIMBS = 17
RADIX = 15
MASK = (1 << RADIX) - 1
LOOSE = (1 << RADIX) + 96

# p = 2^255 - 19
P_INT = (1 << 255) - 19
# curve constant d = -121665/121666 mod p
D_INT = 37095705934669439343138083508754565189542113879843219016388785533085940283555
# sqrt(-1) mod p (2^((p-1)/4))
SQRT_M1_INT = 19681161376707505956807079304988542015446066515923890162744021073123829784752
# group order L = 2^252 + 27742317777372353535851937790883648493
L_INT = (1 << 252) + 27742317777372353535851937790883648493

# Ed25519 basepoint (affine)
BX_INT = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BY_INT = 46316835694926478169428394003475163141307993866256225615783033603165251855960

DTYPE = torch.int64

# How a multiply reduces its products to columns (see the module docstring).
SKEW_IMPL = os.environ.get("MOCHI_SKEW_IMPL", "pad")

# This thread's pinned skew (see :func:`skew`), None where SKEW_IMPL holds.
_pinned = threading.local()


@contextmanager
def skew(name: str):
    """Every multiply this thread makes inside the block reduces as ``name``
    does (``mxu`` or any other value, as :data:`SKEW_IMPL`), whatever
    :data:`SKEW_IMPL` reads meanwhile."""
    before = getattr(_pinned, "name", None)
    _pinned.name = name
    try:
        yield
    finally:
        _pinned.name = before


def available_skews():
    return ("pad", "reshape", "shift", "mxu")


# ------------------------------------------------------------ host helpers


def int_to_limbs(x: int) -> np.ndarray:
    """Python int in [0, 2^255) -> 17 int32 limbs (little-endian, radix 2^15)."""
    assert 0 <= x < (1 << 255), "value out of 255-bit limb range"
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMBS)], dtype=np.int32)


def limbs_to_int(limbs) -> int:
    """Limb array (17,) or (17, 1) -> python int (no reduction)."""
    arr = np.asarray(limbs).reshape(NLIMBS)
    return sum(int(arr[i]) << (RADIX * i) for i in range(NLIMBS))


def limbs_to_int_batch(limbs) -> list:
    """(17, B) limb array or tensor -> list of B python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs).reshape(NLIMBS, -1)
    return [
        sum(int(arr[i, j]) << (RADIX * i) for i in range(NLIMBS))
        for j in range(arr.shape[1])
    ]


def bytes32_to_limbs(b: bytes) -> np.ndarray:
    """32 little-endian bytes (bit 255 clear) -> 17 limbs."""
    assert len(b) == 32
    x = int.from_bytes(b, "little")
    assert x < (1 << 255)
    return int_to_limbs(x)


# -------------------------------------------------------------- constants


def const(x: int, lanes=(), device="cpu") -> torch.Tensor:
    """Constant ``(17, *lanes)``, broadcast (not copied) over the lanes."""
    c = torch.from_numpy(int_to_limbs(x).astype(np.int64)).to(device)
    c = c.reshape(NLIMBS, *([1] * len(lanes)))
    return c.expand(NLIMBS, *lanes)


def zeros(lanes, device="cpu") -> torch.Tensor:
    return torch.zeros((NLIMBS, *lanes), dtype=DTYPE, device=device)


def one(lanes, device="cpu") -> torch.Tensor:
    out = zeros(lanes, device)
    out[0] = 1
    return out


_P_LIMBS_NP = np.array([(P_INT >> (RADIX * i)) & MASK for i in range(NLIMBS)], dtype=np.int64)
# 2p limb by limb (65498, 65534 x16): dominates any loose limb, so a + 2p - b
# stays non-negative limb by limb.
_TWO_P_LIMBS = 2 * _P_LIMBS_NP


@lru_cache(maxsize=None)
def _limb_vec(which: str, device: str) -> torch.Tensor:
    arr = {"p": _P_LIMBS_NP, "2p": _TWO_P_LIMBS}[which]
    return torch.from_numpy(arr.copy()).to(device)


def _vec(which: str, like: torch.Tensor) -> torch.Tensor:
    v = _limb_vec(which, str(like.device))
    return v.reshape(NLIMBS, *([1] * (like.dim() - 1)))


@lru_cache(maxsize=None)
def _column_index(device: str) -> torch.Tensor:
    """Column of each of the 17x17 partial products: i + j."""
    i = torch.arange(NLIMBS)
    return (i[:, None] + i[None, :]).reshape(-1).to(device)


# ------------------------------------------------------------------ carries


def _shift_in(c: torch.Tensor, fold: int) -> torch.Tensor:
    """Limb k+1 receives c[k]; limb 0 receives fold * c[16]."""
    return torch.cat([fold * c[NLIMBS - 1 :], c[: NLIMBS - 1]], dim=0)


def _carry1(cols: torch.Tensor) -> torch.Tensor:
    """One carry pass, valid for 0 <= cols <= 2^17 (output <= LOOSE)."""
    return (cols & MASK) + _shift_in(cols >> RADIX, 19)


def _carry2(cols: torch.Tensor) -> torch.Tensor:
    """Two carry passes, valid for 0 <= cols < 2^26 (output <= LOOSE)."""
    t = (cols & MASK) + _shift_in(cols >> RADIX, 19)
    return (t & MASK) + _shift_in(t >> RADIX, 19)


def _carry_chain(cols: torch.Tensor):
    """Exact sequential carry -> (limbs < 2^15, signed carry-out).

    ``>>`` on a signed torch tensor is an arithmetic (floor) shift, so
    negative columns borrow correctly."""
    c = torch.zeros(cols.shape[1:], dtype=DTYPE, device=cols.device)
    out = []
    for k in range(NLIMBS):
        t = cols[k] + c
        out.append(t & MASK)
        c = t >> RADIX
    return torch.stack(out, dim=0), c


# ------------------------------------------------------------------ add/sub


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry1(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry1(a + (_vec("2p", a) - b))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


# ----------------------------------------------------------------- multiply


def _build_mxu_matrix() -> np.ndarray:
    """The reduction matrix of :func:`_mul_mxu`, (34, 578) of 0/1: row k
    sums the lo halves of the products with i + j == k (column i*17 + j)
    and the hi halves with i + j + 1 == k (column 289 + i*17 + j), as the
    reference builds it."""
    m = np.zeros((2 * NLIMBS, 2 * NLIMBS * NLIMBS), dtype=np.float64)
    for i in range(NLIMBS):
        for j in range(NLIMBS):
            m[i + j, i * NLIMBS + j] = 1.0
            m[i + j + 1, NLIMBS * NLIMBS + i * NLIMBS + j] = 1.0
    return m


@lru_cache(maxsize=None)
def _mxu_matrix(device: str) -> torch.Tensor:
    return torch.from_numpy(_build_mxu_matrix()).to(device)


def _mul_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The multiply of two (17, B) operands with its column reduction as
    one matrix product: the 289 products split into lo (15 bits) and hi,
    stacked as a (578, B) operand, multiplied by the constant (34, 578) 0/1
    matrix; the top 17 columns fold by 19, then :func:`_carry2`.  Limb for
    limb the reference's ``_mul_mxu`` and :func:`mul`'s schoolbook.

    The product is float64: every entry is an integer below 2^16 and every
    sum one below 2^21 < 2^53, so the result is exact in any summation
    order, and float64 matmuls run on the card (int64 ones do not) and
    never go through TF32.  The reference's float32 is exact only at
    ``precision=HIGHEST``; no float32 product is used here."""
    prod = a[:, None] * b[None, :]  # (17, 17, B), <= LOOSE^2 < 2^31
    lanes = prod.shape[2:]
    lo = (prod & MASK).reshape(NLIMBS * NLIMBS, *lanes)
    hi = (prod >> RADIX).reshape(NLIMBS * NLIMBS, *lanes)
    p = torch.cat([lo, hi], dim=0).to(torch.float64)  # (578, B)
    cols = (_mxu_matrix(str(p.device)) @ p).to(DTYPE)  # (34, B), exact
    return _carry2(cols[:NLIMBS] + 19 * cols[NLIMBS:])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 17x17 multiply with the reference's lo/hi split: the
    15-bit halves of every product are summed into columns (lo at i+j, hi
    at i+j+1), the top 17 columns fold at 2^255 = 19, two carry passes.
    Under ``SKEW_IMPL == "mxu"`` (or a pinned :func:`skew`) two rank-2
    operands take :func:`_mul_mxu` (the same limbs), as in the reference."""
    name = getattr(_pinned, "name", None)
    if (SKEW_IMPL if name is None else name) == "mxu" and a.dim() == 2 == b.dim():
        return _mul_mxu(a, b)
    prod = a[:, None] * b[None, :]  # (17, 17, *lanes)
    lanes = prod.shape[2:]
    idx = _column_index(str(prod.device))
    lo = (prod & MASK).reshape(NLIMBS * NLIMBS, *lanes)
    hi = (prod >> RADIX).reshape(NLIMBS * NLIMBS, *lanes)
    cols = torch.zeros((2 * NLIMBS, *lanes), dtype=DTYPE, device=prod.device)
    cols[: 2 * NLIMBS - 1].index_add_(0, idx, lo)
    cols[1:].index_add_(0, idx, hi)
    return _carry2(cols[:NLIMBS] + 19 * cols[NLIMBS:])


def square(a: torch.Tensor) -> torch.Tensor:
    """a^2.  The reference's symmetric schoolbook produces exactly the
    columns of ``mul(a, a)``, so this is that (under ``mxu`` a rank-2
    square takes :func:`_mul_mxu`, as the reference's does)."""
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    if 0 <= k <= 3:
        return _carry1(a * k)
    if 0 <= k < (1 << 10):
        return _carry2(a * k)
    return mul(a, const(k % P_INT, a.shape[1:], a.device))


# -------------------------------------------------------------------- exact


def canonical(a: torch.Tensor) -> torch.Tensor:
    """The unique representative < p of a loose element."""
    limbs, cout = _carry_chain(a)
    limbs = torch.cat([(limbs[0] + 19 * cout)[None], limbs[1:]], dim=0)
    limbs, _ = _carry_chain(limbs)
    diff, borrow = _carry_chain(limbs - _vec("p", limbs))
    return torch.where((borrow >= 0)[None], diff, limbs)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == canonical(b), dim=0)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[None], a, b)


# ----------------------------------------------------------------- powering


def _square_n(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = square(a)
    return a


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3) by ref10's pow22523 addition chain."""
    z2 = square(a)
    z9 = mul(a, _square_n(z2, 2))
    z11 = mul(z2, z9)
    z_5_0 = mul(z9, square(z11))
    z_10_0 = mul(_square_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(_square_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(_square_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(_square_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(_square_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(_square_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(_square_n(z_200_0, 50), z_50_0)
    return mul(_square_n(z_250_0, 2), a)
