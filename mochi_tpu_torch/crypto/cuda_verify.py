"""Batched Ed25519 verification on the card: the CUDA kernel's wrapper.

Counterpart of the reference package's ``crypto/pallas_verify.py``.  The
kernel (``csrc/verify.cu``, arithmetic in ``csrc/fe25519.cuh`` and
``csrc/ge25519.cuh``) runs one signature per thread: decode A and R, the
64-window double-scalar multiply, the projective compare.  Its source note
says what bounds it and what the design does about that.

:func:`verify_prepared_packed` takes the reference package's public layout
so tests compare like with like: ``y_a``/``y_r`` (B, 17) int32 15-bit limbs,
``sign_a``/``sign_r`` (B,) int32, ``s_bytes``/``h_bytes`` (B, 32) uint8
little-endian scalars; it returns a (B,) bool bitmap.  For CUDA tensors it
launches the kernel on the current stream or raises; for CPU tensors it
runs the plain version (:func:`mochi_tpu_torch.crypto.curve.verify_prepared_packed`).
The kernel does not synchronise: the caller reads the bitmap back.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch

from . import curve
from . import field as F

# Launches of the kernel (a plain count; the chip smoke test zeroes it
# before driving the main path and reads it after).
launches = 0
_count_lock = threading.Lock()

# Launch trace, off when None.  When a list, each launch appends (lanes,
# start, end): CUDA events recorded on the launch's stream just before and
# just after the kernel, so their elapsed time is the kernel's own.
launch_log = None

# 32x32->64 integer multiply-adds one signature costs the kernel (the count
# in verify.cu's source note): 1,897 field multiplies of 100 products and
# 1,534 squarings of 55.  The data-dependent sqrt(-1) multiply of a decode
# (at most two per signature) is left out, so a bound built on it errs low.
IMADS_PER_SIGNATURE = 1897 * 100 + 1534 * 55

# Radix-2^25.5 limb layout of the kernel (fe25519.cuh).
_OFFS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
_BITS = (26, 25) * 5


def int_to_limbs25(x: int) -> np.ndarray:
    """Python int in [0, 2^255) -> the kernel's ten unsigned limbs."""
    assert 0 <= x < (1 << 255)
    return np.array([(x >> o) & ((1 << b) - 1) for o, b in zip(_OFFS, _BITS)], dtype=np.int32)


def basepoint_table25() -> np.ndarray:
    """[0..8]B in Niels form for the kernel: (9, 3, 10) int32, entries
    (y+x, y-x, 2dxy) canonical, the same points as ``curve.B_TAB_*``."""
    return np.stack(
        [np.stack([int_to_limbs25(c) for c in ent]) for ent in curve.basepoint_niels_ints()]
    )


@lru_cache(maxsize=None)
def _table_on(device: str) -> torch.Tensor:
    return torch.from_numpy(basepoint_table25()).to(device)


def _lib():
    from .. import kernels

    lib = kernels.load("verify")
    if not getattr(lib, "_mochi_typed", False):
        lib.mochi_ed25519_verify.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
        lib.mochi_ed25519_verify.restype = ctypes.c_int
        lib.mochi_ed25519_verify_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.mochi_ed25519_verify_attrs.restype = ctypes.c_int
        lib._mochi_typed = True
    return lib


def kernel_attributes() -> dict:
    """Registers per thread, local bytes per thread, static shared bytes and
    threads per block of the compiled kernel (cudaFuncGetAttributes)."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = _lib().mochi_ed25519_verify_attrs(*[ctypes.byref(v) for v in vals])
    if rc:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads"), (v.value for v in vals)))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def verify_prepared_packed(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes) -> torch.Tensor:
    """(B,) bool bitmap of the cofactorless verify (see module docstring)."""
    global launches
    device = y_a.device
    if device.type == "cpu":
        return curve.verify_prepared_packed(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes)
    if device.type != "cuda":
        raise ValueError(f"no verify kernel for device {device}")
    n = y_a.shape[0]
    _check("y_a", y_a, torch.int32, (n, F.NLIMBS), device)
    _check("sign_a", sign_a, torch.int32, (n,), device)
    _check("y_r", y_r, torch.int32, (n, F.NLIMBS), device)
    _check("sign_r", sign_r, torch.int32, (n,), device)
    _check("s_bytes", s_bytes, torch.uint8, (n, 32), device)
    _check("h_bytes", h_bytes, torch.uint8, (n, 32), device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    lib = _lib()
    table = _table_on(str(device))
    log = launch_log
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if log is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        rc = lib.mochi_ed25519_verify(
            y_a.data_ptr(), sign_a.data_ptr(), y_r.data_ptr(), sign_r.data_ptr(),
            s_bytes.data_ptr(), h_bytes.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, stream.cuda_stream,
        )
        if log is not None:
            end.record(stream)
    if rc:
        raise RuntimeError(f"verify kernel launch failed with CUDA error {rc}")
    if log is not None:
        log.append((n, start, end))
    with _count_lock:
        launches += 1
    return out


def from_reference_prepared(arrays, device) -> tuple:
    """The reference package's prepared numpy tensors (``prepare_packed``'s
    first six: y_a, sign_a, y_r, sign_r, s_bytes, h_bytes) -> this module's
    input tensors on ``device``."""
    y_a, sign_a, y_r, sign_r, s_bytes, h_bytes = arrays[:6]
    dtypes = (torch.int32, torch.int32, torch.int32, torch.int32, torch.uint8, torch.uint8)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)
        for a, dtype in zip((y_a, sign_a, y_r, sign_r, s_bytes, h_bytes), dtypes)
    )
