"""Batched Ed25519 verification on the card: the general kernels' wrapper.

Counterpart of the reference package's ``crypto/pallas_verify.py`` and of
its jitted general verify programs.  Which kernel runs follows
``MOCHI_SKEW_IMPL`` (:data:`field.SKEW_IMPL`, read at every call, as the
reference's multiply reads it while it traces):

* ``pad`` (the default, and every value but ``mxu``): ``csrc/verify.cu``
  (arithmetic in ``csrc/fe25519.cuh`` and ``csrc/ge25519.cuh``, the team's
  verify in ``csrc/verify25519.cuh``), one signature per team of four lanes
  in radix 2^25.5, [S]B from the basepoint comb;
* ``mxu``: ``csrc/verify_mxu.cu`` (``csrc/fe17.cuh`` under the same curve
  code), the reference's 17 x 15-bit field with every multiply's column
  reduction an integer tensor-core product: a team of four lanes a
  signature, 8 signatures a warp, each lane forming a quarter of a
  multiply's limb products straight into the MMA's A fragments
  (``csrc/fe17_team.cuh``).  That layout's 289 products and splits a
  multiply (against the kernel radix's 100) and its chain of ~3,430
  dependent warp-wide multiplies a signature bound it, not the tensor
  cores.

Both decode A and R, run the 64-window double-scalar multiply and the
projective compare; each source note says what bounds its kernel and what
the design does about that.  :func:`fe_mul_mxu` launches the mxu kernel's
multiply alone on a batch of pairs.

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

SKEWS = ("pad", "mxu")

# Launches of each general kernel, keyed by skew (plain counts; the chip
# smoke test zeroes them before driving a main path and reads them after).
launches = dict.fromkeys(SKEWS, 0)
# Launches of the batch multiply (fe_mul_mxu), which no main path runs.
mul_launches = 0
_count_lock = threading.Lock()

# Launch traces of each general kernel, keyed by skew, off when None.  When
# a list, each launch appends (lanes, start, end): CUDA events recorded on
# the launch's stream just before and just after the kernel, so their
# elapsed time is the kernel's own.
launch_logs = dict.fromkeys(SKEWS)

# 32x32->64 integer multiply-adds one signature costs the kernel (the count
# in verify.cu's source note): 1,897 field multiplies of 100 products and
# 1,534 squarings of 55.  The data-dependent sqrt(-1) multiply of a decode
# (at most two per signature) is left out, so a bound built on it errs low.
IMADS_PER_SIGNATURE = 1897 * 100 + 1534 * 55
# Field multiplies a signature under ``mxu``, where a squaring is a multiply.
MULS_PER_SIGNATURE = 1897 + 1534
# The multiply-adds verify.cu's team of four lanes issues a signature
# (verify25519.cuh): each lane decodes (A on two lanes, R on two: 4 x (19
# multiplies + 255 squarings)); the comb's 64 mixed additions of 7 and each
# lane's partial sum to cached form (1); 4 team additions of 8 to sum the
# partials; [S]B and [1..8](-A) to cached form, 1 a lane each (9 x 4); 7
# team additions for the table; the ladder's 252 doublings (4 squarings and
# 4 multiplies: T always) and 64 additions of 8; the last addition; the
# compare's 2 on every lane.  The sqrt(-1) multiply is left out as above.
IMADS_ISSUED_PER_SIGNATURE = (
    4 * 19 + 64 * 7 + 4 + 4 * 8 + 9 * 4 + 7 * 8 + 252 * 4 + 64 * 8 + 8 + 4 * 2
) * 100 + (4 * 255 + 252 * 4) * 55

# Bytes a multiply of fe_mul_mxu moves: two (17,) int32 operands in, one out.
BYTES_PER_MUL = 3 * 17 * 4
# Limb products a multiply forms (17 x 17), the integer operations that
# form and split one (a multiply-add and two bit operations), and the
# multiply-adds one signature's share of a team call's tensor-core
# reduction issues: 57 m16n8k32 MMAs a warp of 8 signatures
# (fe17_team.cuh).  The batch multiply makes one multiply a call.
PRODUCTS_PER_MUL = 17 * 17
OPS_PER_PRODUCT = 3
MMA_MACS_PER_MUL = 57 * 16 * 8 * 32 // 8
# Team calls a signature makes in verify_mxu.cu (hand count of ge25519.cuh
# under MOCHI_FE17_TEAM, counted on its g++ build): 1,308 carrying two
# multiplies (the table's and the ladder's additions and doublings) and 817
# carrying one (both decodes, each sqrt(-1) fix-up included, the lone
# multiplies of the ladder and the table, the compare).
MXU_CALLS_PER_SIGNATURE = 1308 + 817


def skew() -> str:
    """The general kernel every launch runs now: ``mxu`` under
    ``MOCHI_SKEW_IMPL=mxu``, else ``pad``."""
    return "mxu" if F.SKEW_IMPL == "mxu" else "pad"


# Radix-2^25.5 limb layout of the kernel (fe25519.cuh).
_OFFS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
_BITS = (26, 25) * 5


def int_to_limbs25(x: int) -> np.ndarray:
    """Python int in [0, 2^255) -> the kernel's ten unsigned limbs."""
    assert 0 <= x < (1 << 255)
    return np.array([(x >> o) & ((1 << b) - 1) for o, b in zip(_OFFS, _BITS)], dtype=np.int32)


def basepoint_table17() -> np.ndarray:
    """[0..8]B in Niels form for the mxu kernel: (9, 3, 17) int32 in the
    17 x 15-bit layout, ``curve.B_TAB_*`` entry by entry."""
    return np.ascontiguousarray(np.stack([curve.B_TAB_YPX, curve.B_TAB_YMX, curve.B_TAB_XY2D], axis=1),
                                dtype=np.int32)


@lru_cache(maxsize=None)
def _table_on(device: str, skew_: str = "pad") -> torch.Tensor:
    """The basepoint table ``skew_``'s kernel reads, uploaded once per
    device: for ``pad`` the basepoint comb ([d 16^w]B, (576, 3, 10) int32,
    the comb kernels' own upload), for ``mxu`` [0..8]B in 17 x 15 limbs."""
    if skew_ == "mxu":
        return torch.from_numpy(basepoint_table17()).to(device)
    from . import cuda_comb  # imports this module

    return cuda_comb._bcomb_on(device, "radix25")


def _lib(skew_: str = "pad"):
    """The loaded library of ``skew_``'s general kernel, built on first use."""
    from .. import kernels

    if skew_ == "mxu":
        lib = kernels.load("verify_mxu")
        if not getattr(lib, "_mochi_typed", False):
            lib.mochi_ed25519_verify_mxu.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
            lib.mochi_ed25519_verify_mxu.restype = ctypes.c_int
            lib.mochi_fe17_mul_mxu.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
            lib.mochi_fe17_mul_mxu.restype = ctypes.c_int
            lib.mochi_ed25519_verify_mxu_attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 6
            lib.mochi_ed25519_verify_mxu_attrs.restype = ctypes.c_int
            lib._mochi_typed = True
        return lib
    lib = kernels.load("verify")
    if not getattr(lib, "_mochi_typed", False):
        lib.mochi_ed25519_verify.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
        lib.mochi_ed25519_verify.restype = ctypes.c_int
        lib.mochi_ed25519_verify_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 6
        lib.mochi_ed25519_verify_attrs.restype = ctypes.c_int
        lib._mochi_typed = True
    return lib


def kernel_attributes(skew_: str = "pad") -> dict:
    """Registers per thread, local bytes per thread, static shared bytes and
    threads per block of ``skew_``'s compiled kernel (cudaFuncGetAttributes),
    the lanes a signature (``team``) and the dynamic shared bytes of a
    launch; for ``mxu`` one such dict for the verify kernel and one for the
    batch multiply (``verify``, ``mul``)."""
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "team", "dynamic_shared_bytes")

    def query(fn, *which):
        vals = [ctypes.c_int(0) for _ in keys]
        rc = fn(*which, *[ctypes.byref(v) for v in vals])
        if rc:
            raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
        return dict(zip(keys, (v.value for v in vals)))

    if skew_ == "mxu":
        fn = _lib("mxu").mochi_ed25519_verify_mxu_attrs
        return {"verify": query(fn, 0), "mul": query(fn, 1)}
    return query(_lib().mochi_ed25519_verify_attrs)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def verify_prepared_packed(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, out=None) -> torch.Tensor:
    """(B,) bool bitmap of the cofactorless verify with the kernel of
    :func:`skew` (see module docstring).  ``out``, a contiguous (B,) bool
    tensor on the inputs' device (a view into a larger bitmap, say), takes
    the bitmap in place of a new one and is returned."""
    device = y_a.device
    n = y_a.shape[0]
    if out is not None:
        _check("out", out, torch.bool, (n,), device)
    if device.type == "cpu":
        got = curve.verify_prepared_packed(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes)
        return got if out is None else out.copy_(got)
    if device.type != "cuda":
        raise ValueError(f"no verify kernel for device {device}")
    _check("y_a", y_a, torch.int32, (n, F.NLIMBS), device)
    _check("sign_a", sign_a, torch.int32, (n,), device)
    _check("y_r", y_r, torch.int32, (n, F.NLIMBS), device)
    _check("sign_r", sign_r, torch.int32, (n,), device)
    _check("s_bytes", s_bytes, torch.uint8, (n, 32), device)
    _check("h_bytes", h_bytes, torch.uint8, (n, 32), device)
    if out is None:
        out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    sk = skew()
    lib = _lib(sk)
    launch = lib.mochi_ed25519_verify_mxu if sk == "mxu" else lib.mochi_ed25519_verify
    table = _table_on(str(device), sk)
    log = launch_logs[sk]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if log is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        rc = launch(
            y_a.data_ptr(), sign_a.data_ptr(), y_r.data_ptr(), sign_r.data_ptr(),
            s_bytes.data_ptr(), h_bytes.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, stream.cuda_stream,
        )
        if log is not None:
            end.record(stream)
    if rc:
        raise RuntimeError(f"verify ({sk}) kernel launch failed with CUDA error {rc}")
    if log is not None:
        log.append((n, start, end))
    with _count_lock:
        launches[sk] += 1
    return out


def fe_mul_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """n independent field multiplies, limbs leading: ``a``, ``b`` (17, n)
    with limbs in [0, LOOSE] -> (17, n).  On a card: int32 tensors, the mxu
    kernel's multiply (``csrc/verify_mxu.cu``), launched on the current
    stream, or the call raises; on the CPU: the plain
    :func:`~mochi_tpu_torch.crypto.field._mul_mxu`, in ``a``'s dtype."""
    global mul_launches
    device = a.device
    if device.type == "cpu":
        return F._mul_mxu(a.to(F.DTYPE), b.to(F.DTYPE)).to(a.dtype)
    if device.type != "cuda":
        raise ValueError(f"no multiply kernel for device {device}")
    if a.dim() != 2:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected (17, n)")
    n = a.shape[1]
    _check("a", a, torch.int32, (F.NLIMBS, n), device)
    _check("b", b, torch.int32, (F.NLIMBS, n), device)
    out = torch.empty((F.NLIMBS, n), dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = _lib("mxu")
    with torch.cuda.device(device):
        rc = lib.mochi_fe17_mul_mxu(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                    torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"fe17 multiply kernel launch failed with CUDA error {rc}")
    with _count_lock:
        mul_launches += 1
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
