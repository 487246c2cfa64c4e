"""Known-signer (comb) Ed25519 verification on the card: the wrapper of
the four CUDA comb kernels.

Counterpart of the reference package's ``comb._verify_comb_jit`` with its
two accumulations, under either multiply.  Which kernel a launch runs
follows the pair of switches (:func:`kernel_of`):

* ``impl="chain"``, ``multiply="pad"``: ``csrc/comb.cu`` (arithmetic in
  ``csrc/comb25519.cuh``), one signature per thread in radix 2^25.5: 64
  windows of two Niels mixed additions from the signer's table and the
  basepoint comb, R's decode, the projective compare;
* ``impl="chain"``, ``multiply="mxu"`` (``MOCHI_SKEW_IMPL=mxu``):
  ``csrc/comb_mxu.cu`` (arithmetic in ``csrc/comb17.cuh``), the same chain
  in the reference's 17 x 15-bit field with every multiply's column
  reduction on the integer tensor cores (``csrc/fe17.cuh``), 32 signatures
  a warp;
* ``impl="tree"``, ``multiply="pad"``: ``csrc/comb_tree.cu`` (arithmetic
  in ``csrc/comb_tree.cuh``), a prepare pass (R's decode and the digit
  recoding, one thread per signature) and an accumulate pass (the 128
  window points summed by a 7-level tree, one warp per signature), in radix
  2^25.5;
* ``impl="tree"``, ``multiply="mxu"``: ``csrc/comb_tree_mxu.cu``
  (arithmetic in ``csrc/comb_tree17.cuh``), the same two passes in the 17 x
  15-bit field with every multiply on the integer tensor cores; in the
  accumulate pass the warp-wide multiply serves the 32 tree nodes of one
  signature.

``impl=None`` takes :data:`comb.COMB_IMPL` (``MOCHI_COMB_IMPL``) and
``multiply=None`` the ``MOCHI_SKEW_IMPL`` switch (``mxu`` for ``mxu``, else
``pad``); :func:`switches` reads both at once.  Each source note says what
bounds its kernel and what the design does about that.

:func:`verify_comb_prepared` takes the reference's public layout for the
lanes (``key_idx`` (B,) int32, ``y_r`` (B, 17) int32 15-bit limbs,
``sign_r`` (B,) int32, ``s_bytes``/``h_bytes`` (B, 32) uint8) and the table
in the layout its kernel reads (:func:`table_layout`), as
:meth:`~mochi_tpu_torch.crypto.comb.SignerRegistry.device_table` returns it:
on a CUDA device the kernel-radix (rows, 3, 10) int32 table (``radix25``)
for ``comb.cu`` and ``comb_tree.cu``, the registry's (rows, 51) int32 17 x
15 rows (``fe17``) for ``comb_mxu.cu`` and ``comb_tree_mxu.cu``, and the
kernel is launched on the current stream or the call raises; on the CPU the
(rows, 51) rows, and the plain version of the same ``impl`` and
``multiply`` (:func:`mochi_tpu_torch.crypto.comb.verify_comb_prepared`)
runs.  The kernels do not synchronise: the caller reads the bitmap back.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from . import comb
from . import field as F
from .cuda_verify import _BITS, _OFFS, _check

# The comb kernels, by the name :func:`kernel_of` gives them: comb.cu,
# comb_tree.cu, comb_mxu.cu and comb_tree_mxu.cu.
KERNELS = ("chain", "tree", "chain_mxu", "tree_mxu")

# Launches of each kernel, keyed by kernel (plain counts; the chip smoke
# test zeroes them before driving a main path and reads them after).  A
# tree counts one per call, both passes.
launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

# Launch traces of each kernel, keyed by kernel, off when None.  When a
# list, each launch appends (lanes, start, end): CUDA events recorded on the
# launch's stream just before and just after the kernel (a tree's: both
# passes).
launch_logs = dict.fromkeys(KERNELS)

# 32x32->64 integer multiply-adds one signature's verdict takes (the
# source notes): the chain's 917 field multiplies of 100 products and 255
# squarings of 55, the least of the two accumulations, so the bound of
# either kernel.  The data-dependent sqrt(-1) multiply of the decode is
# left out.
IMADS_PER_SIGNATURE = 917 * 100 + 255 * 55
# What comb_tree.cu issues for the same verdict: 1,228 multiplies and the
# same 255 squarings (the lanes that compute unread sums are not counted).
IMADS_PER_SIGNATURE_TREE = 1228 * 100 + 255 * 55

# Each tree's per-signature record between its passes (comb_tree.cuh,
# comb_tree17.cuh): R's x and y, R's verdict, 128 int8 digits.
TREE_RECORD_INTS = 53
TREE17_RECORD_INTS = 67
_RECORD_INTS = {"tree": TREE_RECORD_INTS, "tree_mxu": TREE17_RECORD_INTS}

# Multiplies and squarings one signature of the chain under mxu issues
# (comb_mxu.cu: 128 mixed additions of 7, the decode's 275, its sqrt(-1)
# multiply included, since over fe17 it is a select that always multiplies,
# and the compare's 2), and the
# integer multiply-adds each one's tensor-core reduction issues (196
# m16n8k32 MMAs a warp of 32, fe17.cuh).
MULS_PER_SIGNATURE_MXU = 128 * 7 + 275 + 2
MMA_MACS_PER_MUL = 196 * 16 * 8 * 32 // 32
# The same count for the tree under mxu (comb_tree_mxu.cu), in multiplies
# of one lane's operands: the prepare pass's decode (275, one signature a
# lane) and the accumulate pass's 76 warp-wide multiplies (a lane's two
# windows of 10, their sum and 5 levels of 9, the compare's 2), each
# serving the 32 lanes of one signature.
MULS_PER_SIGNATURE_TREE_MXU = 275 + 32 * (2 * (3 + 7) + 9 + 5 * 9 + 2)

# Bytes per signature in and out: key_idx, y_r, sign_r, s, h, the verdict.
BYTES_PER_SIGNATURE = 4 + 17 * 4 + 4 + 32 + 32 + 1
# Bytes of one table entry in the kernel radix (3 coordinates x 10 limbs).
ENTRY_BYTES = 3 * 10 * 4


def to_radix25(rows15: np.ndarray) -> np.ndarray:
    """(N, 51) int32 17 x 15-bit Niels rows -> (N, 3, 10) int32 in the
    kernel's radix-2^25.5 limbs, value for value (exact: both layouts hold
    the same integer below 2^255)."""
    rows15 = np.ascontiguousarray(rows15, dtype=np.int32)
    limbs = rows15.reshape(-1, 3, F.NLIMBS).astype(np.uint64) & np.uint64(F.MASK)
    words = np.zeros(limbs.shape[:2] + (4,), dtype=np.uint64)
    for i in range(F.NLIMBS):
        bit = F.RADIX * i
        word, off = bit >> 6, bit & 63
        words[..., word] |= limbs[..., i] << np.uint64(off)
        if off > 64 - F.RADIX:
            words[..., word + 1] |= limbs[..., i] >> np.uint64(64 - off)
    out = np.empty(limbs.shape[:2] + (10,), dtype=np.int32)
    for i, (o, b) in enumerate(zip(_OFFS, _BITS)):
        word, off = o >> 6, o & 63
        x = words[..., word] >> np.uint64(off)
        if off + b > 64:
            x |= words[..., word + 1] << np.uint64(64 - off)
        out[..., i] = (x & np.uint64((1 << b) - 1)).astype(np.int32)
    return out


def bcomb_table25() -> np.ndarray:
    """The basepoint comb in the kernel radix: (576, 3, 10) int32."""
    return to_radix25(comb._b_comb().reshape(-1, comb.ROW_WIDTH))


@lru_cache(maxsize=None)
def _bcomb_on(device: str, layout: str = "radix25") -> torch.Tensor:
    """The basepoint comb on ``device`` in ``layout``."""
    table = comb._b_comb().reshape(-1, comb.ROW_WIDTH) if layout == "fe17" else bcomb_table25()
    return torch.from_numpy(table).to(device)


def switches() -> tuple:
    """(impl, multiply) of a comb launch now, both switches read at once:
    :data:`comb.COMB_IMPL` and ``mxu`` under ``MOCHI_SKEW_IMPL=mxu``, else
    ``pad``.  A batch reads them once, where its table is pinned, and hands
    the pair to :func:`table_layout` and :func:`verify_comb_prepared`, so
    that the table's layout and the kernel agree even if a switch flips
    meanwhile."""
    return comb.check_impl(None), ("mxu" if F.SKEW_IMPL == "mxu" else "pad")


def kernel_of(impl: str, multiply: str) -> str:
    """The kernel a launch of ``(impl, multiply)`` runs: the impl's own
    (``chain``, ``tree``), or its tensor-core form under ``mxu``
    (``chain_mxu``, ``tree_mxu``)."""
    impl = comb.check_impl(impl)
    return impl + "_mxu" if multiply == "mxu" else impl


def multiply_of(impl: Optional[str] = None) -> str:
    """The multiply ``impl``'s kernel runs under the switch now (the
    verifier's stats name it): ``mxu`` under ``MOCHI_SKEW_IMPL=mxu``, for
    either accumulation, else ``pad``."""
    impl_, multiply = switches()
    return "mxu" if kernel_of(impl_ if impl is None else impl, multiply).endswith("_mxu") else "pad"


def table_layout(device, impl: str, multiply: str) -> str:
    """The layout of ``SignerRegistry.device_table`` a launch of ``(impl,
    multiply)`` on ``device`` reads: ``fe17`` (the registry's 17 x 15 rows)
    on the CPU, where the plain version runs, and for ``comb_mxu.cu`` and
    ``comb_tree_mxu.cu``; ``radix25`` for ``comb.cu`` and ``comb_tree.cu``."""
    if torch.device(device).type != "cuda" or kernel_of(impl, multiply).endswith("_mxu"):
        return "fe17"
    return "radix25"


# kernel -> (library, launch function, pointer arguments between the row
# count and the lane count, whether the attribute query takes a pass index)
_LIBS = {
    "chain": ("comb", "mochi_comb_verify", 7, False),
    "tree": ("comb_tree", "mochi_comb_tree_verify", 8, True),
    "chain_mxu": ("comb_mxu", "mochi_comb_mxu_verify", 7, False),
    "tree_mxu": ("comb_tree_mxu", "mochi_comb_tree_mxu_verify", 8, True),
}


def _lib(kernel: str = "chain"):
    """The loaded library of ``kernel`` (one of :data:`KERNELS`), built on
    first use."""
    from .. import kernels

    name, fn, n_ptrs, by_pass = _LIBS[kernel]
    lib = kernels.load(name)
    if not getattr(lib, "_mochi_typed", False):
        launch, attrs = getattr(lib, fn), getattr(lib, fn + "_attrs")
        launch.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int, ctypes.c_void_p])
        launch.restype = ctypes.c_int
        attrs.argtypes = [ctypes.c_int] * by_pass + [ctypes.POINTER(ctypes.c_int)] * 4
        attrs.restype = ctypes.c_int
        lib._mochi_typed = True
    return lib


_ATTR_NAMES = ("registers", "local_bytes", "shared_bytes", "threads")


def kernel_attributes(kernel: str = "chain") -> dict:
    """Registers per thread, local bytes per thread, static shared bytes and
    threads per block of ``kernel``'s compiled kernel (one of
    :data:`KERNELS`; cudaFuncGetAttributes); for a tree, one such dict for
    each pass (``prepare``, ``accumulate``)."""
    fn = getattr(_lib(kernel), _LIBS[kernel][1] + "_attrs")

    def query(*which):
        vals = [ctypes.c_int(0) for _ in range(4)]
        rc = fn(*which, *[ctypes.byref(v) for v in vals])
        if rc:
            raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
        return dict(zip(_ATTR_NAMES, (v.value for v in vals)))

    if _LIBS[kernel][3]:
        return {"prepare": query(0), "accumulate": query(1)}
    return query()


# The table shape each layout has, past its row count.
_TABLE_SHAPES = {"radix25": (3, 10), "fe17": (comb.ROW_WIDTH,)}


def verify_comb_prepared(table, key_idx, y_r, sign_r, s_bytes, h_bytes, impl=None,
                         multiply=None) -> torch.Tensor:
    """(B,) bool bitmap of the comb verify with ``impl``'s accumulation
    (default ``comb.COMB_IMPL``) and ``multiply`` (``pad`` or ``mxu``;
    default ``MOCHI_SKEW_IMPL``'s): on a card the kernel of
    :func:`kernel_of`; on the CPU the plain version of the same pair (see
    the module docstring)."""
    impl = comb.check_impl(impl)
    if multiply is None:
        multiply = switches()[1]
    if multiply not in ("pad", "mxu"):
        raise ValueError(f"multiply {multiply!r}: expected 'pad' or 'mxu'")
    device = y_r.device
    layout = table_layout(device, impl, multiply)
    if table.dim() != 1 + len(_TABLE_SHAPES[layout]) or tuple(table.shape[1:]) != _TABLE_SHAPES[layout] \
            or table.shape[0] == 0:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected (rows, "
                         f"{', '.join(map(str, _TABLE_SHAPES[layout]))}) in the {layout} layout")
    if device.type == "cpu":
        return comb.verify_comb_prepared(table, key_idx, y_r, sign_r, s_bytes, h_bytes, impl=impl,
                                         multiply=multiply)
    if device.type != "cuda":
        raise ValueError(f"no comb kernel for device {device}")
    kernel = kernel_of(impl, multiply)
    n = y_r.shape[0]
    _check("table", table, torch.int32, tuple(table.shape), device)
    _check("key_idx", key_idx, torch.int32, (n,), device)
    _check("y_r", y_r, torch.int32, (n, F.NLIMBS), device)
    _check("sign_r", sign_r, torch.int32, (n,), device)
    _check("s_bytes", s_bytes, torch.uint8, (n, 32), device)
    _check("h_bytes", h_bytes, torch.uint8, (n, 32), device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    lib = _lib(kernel)
    bcomb = _bcomb_on(str(device), layout)
    log = launch_logs[kernel]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if log is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        args = (table.data_ptr(), table.shape[0], key_idx.data_ptr(), y_r.data_ptr(), sign_r.data_ptr(),
                s_bytes.data_ptr(), h_bytes.data_ptr(), bcomb.data_ptr())
        if kernel in _RECORD_INTS:
            # allocated on this stream: the caching allocator reuses it only
            # after work queued here, so the passes below own it
            scratch = torch.empty((n, _RECORD_INTS[kernel]), dtype=torch.int32, device=device)
            args += (scratch.data_ptr(),)
        rc = getattr(lib, _LIBS[kernel][1])(*args, out.data_ptr(), n, stream.cuda_stream)
        if log is not None:
            end.record(stream)
    if rc:
        raise RuntimeError(f"comb {kernel} kernel launch failed with CUDA error {rc}")
    if log is not None:
        log.append((n, start, end))
    with _count_lock:
        launches[kernel] += 1
    return out


def from_prepared(key_idx, arrays, device) -> tuple:
    """``key_idx`` and ``batch_verify.prepare_packed``'s first six arrays ->
    this module's lane tensors (key_idx, y_r, sign_r, s_bytes, h_bytes) on
    ``device``."""
    _y_a, _sign_a, y_r, sign_r, s_bytes, h_bytes = arrays[:6]
    dtypes = (torch.int32, torch.int32, torch.int32, torch.uint8, torch.uint8)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)
        for a, dtype in zip((key_idx, y_r, sign_r, s_bytes, h_bytes), dtypes)
    )
