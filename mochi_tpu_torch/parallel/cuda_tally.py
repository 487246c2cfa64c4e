"""The 2f+1 quorum tally on the card: the CUDA kernels' wrappers.

Counterpart of the tally inside the reference package's
``parallel/sharded.py::make_quorum_step``.  The kernels (``csrc/tally.cu``,
the slot rule and a warp's walk in ``csrc/tally.cuh``) sum accepted votes
into quorum slots, one integer atomic a run of equal slots a warp, and
compare the sums with the threshold; the source note says what bounds them.

:func:`quorum_tally` takes ``bitmap`` and ``pre_ok`` (B,) bool, the device
verdicts and the host prechecks, and ``group_ids`` (B,) int32; it returns
the (n_groups,) int32 count of lanes accepted by both, per slot, with the
reference's index rule (an id in [-n_groups, -1] wraps, any other id outside
[0, n_groups) is dropped).  :func:`quorum_commit` takes those counts and
returns ``counts >= threshold`` as (n_groups,) bool.
:func:`quorum_tally_commit` does both in one launch, for counts that are
final when the tally ends (one slice, no process group): it returns
``(counts, committed)``.  For CUDA tensors each launches its kernel on the
current stream or raises; for CPU tensors each runs its plain version
(:func:`mochi_tpu_torch.parallel.sharded.segment_tally`, then
:func:`~mochi_tpu_torch.parallel.sharded.commit`).  None synchronises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..crypto.cuda_verify import _check

# Launches of each kernel (plain counts; the chip smoke test zeroes them
# before driving the main path and reads them after): ``launches`` counts
# every tally launch, fused or not, ``fused_launches`` the fused ones, and
# ``commit_launches`` the standalone commit kernel's.
launches = 0
fused_launches = 0
commit_launches = 0
_count_lock = threading.Lock()

# Bytes a lane moves: its verdict, its precheck and its int32 group id.
BYTES_PER_LANE = 1 + 1 + 4


def _lib():
    from .. import kernels

    lib = kernels.load("tally")
    if not getattr(lib, "_mochi_typed", False):
        lib.mochi_quorum_tally.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        lib.mochi_quorum_tally.restype = ctypes.c_int
        lib.mochi_quorum_tally_commit.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                                  + [ctypes.c_void_p] * 3)
        lib.mochi_quorum_tally_commit.restype = ctypes.c_int
        lib.mochi_quorum_commit.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_void_p]
        lib.mochi_quorum_commit.restype = ctypes.c_int
        lib.mochi_quorum_tally_attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.mochi_quorum_tally_attrs.restype = ctypes.c_int
        lib._mochi_typed = True
    return lib


def kernel_attributes(fused: bool = False) -> dict:
    """Registers per thread, local bytes per thread, static shared bytes and
    threads per block of the compiled tally kernel, or of the fused
    tally-and-commit kernel (cudaFuncGetAttributes)."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = _lib().mochi_quorum_tally_attrs(int(fused), *[ctypes.byref(v) for v in vals])
    if rc:
        raise RuntimeError(f"cudaFuncGetAttributes failed with CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads"), (v.value for v in vals)))


def _int_arg(name: str, value: int) -> int:
    value = int(value)
    if not -(1 << 31) <= value < (1 << 31):
        raise ValueError(f"{name} = {value} does not fit the kernel's int32")
    return value


def _tally_args(bitmap, pre_ok, group_ids, n_groups: int):
    """Check a CUDA tally's inputs; returns (device, lanes, n_groups)."""
    device = bitmap.device
    if device.type != "cuda":
        raise ValueError(f"no tally kernel for device {device}")
    n = bitmap.shape[0]
    _check("bitmap", bitmap, torch.bool, (n,), device)
    _check("pre_ok", pre_ok, torch.bool, (n,), device)
    _check("group_ids", group_ids, torch.int32, (n,), device)
    return device, n, _int_arg("n_groups", n_groups)


def quorum_tally(bitmap, pre_ok, group_ids, n_groups: int) -> torch.Tensor:
    """(n_groups,) int32 accepted votes per slot (see module docstring)."""
    global launches
    if n_groups < 0:
        raise ValueError(f"n_groups = {n_groups} is negative")
    if bitmap.device.type == "cpu":
        from .sharded import segment_tally

        return segment_tally(bitmap, pre_ok, group_ids, n_groups)
    device, n, n_groups = _tally_args(bitmap, pre_ok, group_ids, n_groups)
    counts = torch.empty(n_groups, dtype=torch.int32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = lib.mochi_quorum_tally(bitmap.data_ptr(), pre_ok.data_ptr(), group_ids.data_ptr(),
                                    n, n_groups, counts.data_ptr(), stream.cuda_stream)
    if rc:
        raise RuntimeError(f"tally kernel launch failed with CUDA error {rc}")
    with _count_lock:
        launches += 1
    return counts


def quorum_tally_commit(bitmap, pre_ok, group_ids, n_groups: int, threshold: int):
    """``(counts, committed)``: :func:`quorum_tally`'s counts and
    ``counts >= threshold``, in one launch on a card (see module
    docstring)."""
    global launches, fused_launches
    if n_groups < 0:
        raise ValueError(f"n_groups = {n_groups} is negative")
    if bitmap.device.type == "cpu":
        from .sharded import commit, segment_tally

        counts = segment_tally(bitmap, pre_ok, group_ids, n_groups)
        return counts, commit(counts, threshold)
    device, n, n_groups = _tally_args(bitmap, pre_ok, group_ids, n_groups)
    threshold = _int_arg("threshold", threshold)
    slots = torch.empty(n_groups + 1, dtype=torch.int32, device=device)  # the counts, then the ticket
    committed = torch.empty(n_groups, dtype=torch.bool, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = lib.mochi_quorum_tally_commit(bitmap.data_ptr(), pre_ok.data_ptr(), group_ids.data_ptr(), n,
                                           n_groups, threshold, slots.data_ptr(), committed.data_ptr(),
                                           stream.cuda_stream)
    if rc:
        raise RuntimeError(f"fused tally-and-commit kernel launch failed with CUDA error {rc}")
    with _count_lock:
        launches += 1
        fused_launches += 1
    return slots[:n_groups], committed


def quorum_commit(counts, threshold: int) -> torch.Tensor:
    """(n_groups,) bool: ``counts >= threshold`` (see module docstring)."""
    global commit_launches
    device = counts.device
    if device.type == "cpu":
        from .sharded import commit

        return commit(counts, threshold)
    if device.type != "cuda":
        raise ValueError(f"no commit kernel for device {device}")
    n_groups = counts.shape[0]
    _check("counts", counts, torch.int32, (n_groups,), device)
    committed = torch.empty(n_groups, dtype=torch.bool, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = lib.mochi_quorum_commit(counts.data_ptr(), n_groups, _int_arg("threshold", threshold),
                                     committed.data_ptr(), stream.cuda_stream)
    if rc:
        raise RuntimeError(f"commit kernel launch failed with CUDA error {rc}")
    with _count_lock:
        commit_launches += 1
    return committed
