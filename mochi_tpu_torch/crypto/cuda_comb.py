"""Known-signer (comb) Ed25519 verification on the card: the wrapper of
the two CUDA comb kernels.

Counterpart of the reference package's ``comb._verify_comb_jit`` with its
two accumulations.  ``impl="chain"`` launches ``csrc/comb.cu`` (arithmetic
in ``csrc/comb25519.cuh``): one signature per thread, 64 windows of two
Niels mixed additions from the signer's table and the basepoint comb, R's
decode, the projective compare.  ``impl="tree"`` launches
``csrc/comb_tree.cu`` (arithmetic in ``csrc/comb_tree.cuh``): a prepare
pass (R's decode and the digit recoding, one thread per signature) and an
accumulate pass (the 128 window points summed by a 7-level tree, one warp
per signature).  ``impl=None`` takes :data:`comb.COMB_IMPL`, the
``MOCHI_COMB_IMPL`` switch.  Each source note says what bounds its kernel
and what the design does about that.

:func:`verify_comb_prepared` takes the reference's public layout for the
lanes (``key_idx`` (B,) int32, ``y_r`` (B, 17) int32 15-bit limbs,
``sign_r`` (B,) int32, ``s_bytes``/``h_bytes`` (B, 32) uint8) and the table
in the layout of its device, as
:meth:`~mochi_tpu_torch.crypto.comb.SignerRegistry.device_table` returns it:
on a CUDA device the kernel-radix (rows, 3, 10) int32 table, and the kernel
of ``impl`` is launched on the current stream or the call raises; on the
CPU the (rows, 51) int32 17 x 15 table, and the plain version of the same
``impl`` (:func:`mochi_tpu_torch.crypto.comb.verify_comb_prepared`) runs.
The kernels do not synchronise: the caller reads the bitmap back.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from functools import lru_cache

import numpy as np
import torch

from . import comb
from . import field as F
from .cuda_verify import _BITS, _OFFS, _check

# Launches of each impl's kernel, keyed by impl (plain counts; the chip
# smoke test zeroes them before driving a main path and reads them after).
# The tree counts one per call, both passes.
launches = dict.fromkeys(comb.COMB_IMPLS, 0)
_count_lock = threading.Lock()

# Launch traces of each impl's kernel, keyed by impl, off when None.  When a
# list, each launch appends (lanes, start, end): CUDA events recorded on the
# launch's stream just before and just after the kernel (the tree's: both
# passes).
launch_logs = dict.fromkeys(comb.COMB_IMPLS)

# 32x32->64 integer multiply-adds one signature's verdict takes (the
# source notes): the chain's 917 field multiplies of 100 products and 255
# squarings of 55, the least of the two accumulations, so the bound of
# either kernel.  The data-dependent sqrt(-1) multiply of the decode is
# left out.
IMADS_PER_SIGNATURE = 917 * 100 + 255 * 55
# What the tree kernel issues for the same verdict: 1,228 multiplies and the
# same 255 squarings (the lanes that compute unread sums are not counted).
IMADS_PER_SIGNATURE_TREE = 1228 * 100 + 255 * 55

# The tree's per-signature record between its passes (comb_tree.cuh):
# R's x and y, R's verdict, 128 int8 digits.
TREE_RECORD_INTS = 53

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
def _bcomb_on(device: str) -> torch.Tensor:
    return torch.from_numpy(bcomb_table25()).to(device)


def _lib(impl: str = "chain"):
    """The loaded library of ``impl``'s kernel, built on first use."""
    from .. import kernels

    if impl == "tree":
        lib = kernels.load("comb_tree")
        if not getattr(lib, "_mochi_typed", False):
            lib.mochi_comb_tree_verify.argtypes = (
                [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
            )
            lib.mochi_comb_tree_verify.restype = ctypes.c_int
            lib.mochi_comb_tree_verify_attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
            lib.mochi_comb_tree_verify_attrs.restype = ctypes.c_int
            lib._mochi_typed = True
        return lib
    lib = kernels.load("comb")
    if not getattr(lib, "_mochi_typed", False):
        lib.mochi_comb_verify.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.mochi_comb_verify.restype = ctypes.c_int
        lib.mochi_comb_verify_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.mochi_comb_verify_attrs.restype = ctypes.c_int
        lib._mochi_typed = True
    return lib


_ATTR_NAMES = ("registers", "local_bytes", "shared_bytes", "threads")


def kernel_attributes(impl: str = "chain") -> dict:
    """Registers per thread, local bytes per thread, static shared bytes and
    threads per block of ``impl``'s compiled kernel (cudaFuncGetAttributes);
    for the tree, one such dict for each pass (``prepare``, ``accumulate``)."""

    def query(fn, *which):
        vals = [ctypes.c_int(0) for _ in range(4)]
        rc = fn(*which, *[ctypes.byref(v) for v in vals])
        if rc:
            raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
        return dict(zip(_ATTR_NAMES, (v.value for v in vals)))

    if comb.check_impl(impl) == "tree":
        fn = _lib("tree").mochi_comb_tree_verify_attrs
        return {"prepare": query(fn, 0), "accumulate": query(fn, 1)}
    return query(_lib().mochi_comb_verify_attrs)


# The multiply every comb kernel runs: its own radix-2^25.5 schoolbook,
# whatever MOCHI_SKEW_IMPL says (the comb kernels' mxu multiply is not
# ported yet); said once on stderr when a launch runs under mxu.
MULTIPLY = "pad"
_said_mxu = False


def verify_comb_prepared(table, key_idx, y_r, sign_r, s_bytes, h_bytes, impl=None) -> torch.Tensor:
    """(B,) bool bitmap of the comb verify with ``impl``'s accumulation
    (default ``comb.COMB_IMPL``; see the module docstring)."""
    global _said_mxu
    impl = comb.check_impl(impl)
    device = y_r.device
    if device.type == "cpu":
        return comb.verify_comb_prepared(table, key_idx, y_r, sign_r, s_bytes, h_bytes, impl=impl)
    if device.type != "cuda":
        raise ValueError(f"no comb kernel for device {device}")
    if F.SKEW_IMPL == "mxu" and not _said_mxu:
        _said_mxu = True
        print(f"mochi_tpu_torch: the comb kernels run their own {MULTIPLY} multiply under MOCHI_SKEW_IMPL=mxu "
              "(their mxu multiply is not ported yet)", file=sys.stderr)
    n = y_r.shape[0]
    if table.dim() != 3 or tuple(table.shape[1:]) != (3, 10) or table.shape[0] == 0:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected (rows, 3, 10) in the kernel radix")
    _check("table", table, torch.int32, tuple(table.shape), device)
    _check("key_idx", key_idx, torch.int32, (n,), device)
    _check("y_r", y_r, torch.int32, (n, F.NLIMBS), device)
    _check("sign_r", sign_r, torch.int32, (n,), device)
    _check("s_bytes", s_bytes, torch.uint8, (n, 32), device)
    _check("h_bytes", h_bytes, torch.uint8, (n, 32), device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    tree = impl == "tree"
    lib = _lib(impl)
    bcomb = _bcomb_on(str(device))
    log = launch_logs[impl]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if log is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        args = (table.data_ptr(), table.shape[0], key_idx.data_ptr(), y_r.data_ptr(), sign_r.data_ptr(),
                s_bytes.data_ptr(), h_bytes.data_ptr(), bcomb.data_ptr())
        if tree:
            # allocated on this stream: the caching allocator reuses it only
            # after work queued here, so the passes below own it
            scratch = torch.empty((n, TREE_RECORD_INTS), dtype=torch.int32, device=device)
            rc = lib.mochi_comb_tree_verify(*args, scratch.data_ptr(), out.data_ptr(), n, stream.cuda_stream)
        else:
            rc = lib.mochi_comb_verify(*args, out.data_ptr(), n, stream.cuda_stream)
        if log is not None:
            end.record(stream)
    if rc:
        raise RuntimeError(f"comb {impl} kernel launch failed with CUDA error {rc}")
    if log is not None:
        log.append((n, start, end))
    with _count_lock:
        launches[impl] += 1
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
