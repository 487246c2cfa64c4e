"""Known-signer (comb) Ed25519 verification on the card: the wrapper of
the four CUDA comb kernels.

Counterpart of the reference package's ``comb._verify_comb_jit`` with its
two accumulations, under either multiply.  Which kernel a launch runs
follows the pair of switches (:func:`kernel_of`):

* ``impl="chain"``, ``multiply="pad"``: ``csrc/comb.cu`` (arithmetic in
  ``csrc/comb25519.cuh``, the team's verify in ``csrc/comb_team.cuh``), one
  signature per team of four lanes in radix 2^25.5, one lane in each of a
  block's four warps: each lane sums its share of the 64 windows of two
  Niels mixed additions from the signer's table and the basepoint comb (the
  last lane decodes R first and takes fewer windows), then the team adds the
  four partial sums and compares;
* ``impl="chain"``, ``multiply="mxu"`` (``MOCHI_SKEW_IMPL=mxu``):
  ``csrc/comb_mxu.cu`` (arithmetic in ``csrc/comb17.cuh``), the same chain
  in the reference's 17 x 15-bit field with every multiply's column
  reduction on the integer tensor cores, one signature per team of four
  lanes, 8 a warp, each lane forming a quarter of a multiply's products
  straight into the MMA's operands (``csrc/fe17_team.cuh``), two
  multiplies a call where the chain has two independent ones;
* ``impl="tree"``, ``multiply="pad"``: ``csrc/comb_tree.cu`` (arithmetic
  in ``csrc/comb_tree.cuh``), one launch in radix 2^25.5, 24 signatures a
  block of four warps: one warp decodes R of each, while :data:`TREE_LANES` lanes a
  signature split its 128 window points (each lane mixed-adds both tables'
  entries of its windows from the identity, then levels of complete
  addition across the lanes by shuffles) and the first compares;
* ``impl="tree"``, ``multiply="mxu"``: ``csrc/comb_tree_mxu.cu``
  (arithmetic in ``csrc/comb_tree17.cuh``), the same two passes in the 17 x
  15-bit field on ``comb_mxu.cu``'s team multiply: the prepare pass a team
  of four lanes a signature, the accumulate pass four teams of four lanes
  splitting one signature's 128 window points, two signatures a warp (each
  team mixed-adds its windows' entries, then two levels of complete
  addition across the teams).

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
# test zeroes them before driving a main path and reads them after).
# comb_tree_mxu.cu counts one per call, both passes.
launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

# Launch traces of each kernel, keyed by kernel, off when None.  When a
# list, each launch appends (lanes, start, end): CUDA events recorded on the
# launch's stream just before and just after the kernel (comb_tree_mxu.cu's:
# both passes).
launch_logs = dict.fromkeys(KERNELS)

# 32x32->64 integer multiply-adds one signature's verdict takes (the
# source notes): the chain's 917 field multiplies of 100 products and 255
# squarings of 55, the least of the two accumulations, so the bound of
# either kernel.  The data-dependent sqrt(-1) multiply of the decode is
# left out.
IMADS_PER_SIGNATURE = 917 * 100 + 255 * 55
# Lanes a signature and signatures a block in comb_tree.cu (MOCHI_TREE_LANES
# in comb_tree.cuh, MOCHI_TREE_SIGS in comb_tree.cu; they size the issued
# count below and the card test of the attributes).
TREE_LANES = 4
TREE_SIGS = 24
# What comb_tree.cu issues for the same verdict: each of a signature's
# TREE_LANES lanes makes its share of the 128 mixed additions of 7
# multiplies, every level across the lanes (ge_to_cached's and ge_add's 9)
# and the compare's 2 (issued for the warp, whichever lanes store), plus R's
# decode, 19 multiplies and 255 squarings, on the decode warp, whose 32
# lanes serve TREE_SIGS signatures.
IMADS_PER_SIGNATURE_TREE = ((128 * 7 + TREE_LANES * (9 * (TREE_LANES.bit_length() - 1) + 2)) * 100
                            + (19 * 100 + 255 * 55) * 32 // TREE_SIGS)

# comb_tree_mxu.cu's per-signature record between its passes
# (comb_tree17.cuh): R's x and y, R's verdict, 128 int8 digits.
TREE17_RECORD_INTS = 67

# Multiplies and squarings one signature of the chain under mxu makes
# (128 mixed additions of 7, the decode's 275, its sqrt(-1) multiply
# included, since over fe17 it is a select that always multiplies, and the
# compare's 2), and the team calls comb_mxu.cu makes for them (comb17.cuh
# under MOCHI_FE17_TEAM): each mixed addition 3 calls of two multiplies and
# 1 of one, the compare 1 of two, the decode 275 of one: 385 + 403.
MULS_PER_SIGNATURE_MXU = 128 * 7 + 275 + 2
MXU_CALLS_PER_SIGNATURE = 128 * 4 + 275 + 1
# Integer multiply-adds one signature's share of a team call's tensor-core
# reduction issues: 57 m16n8k32 MMAs a warp of 8 signatures
# (fe17_team.cuh), one multiply a call or two.
MMA_MACS_PER_CALL = 57 * 16 * 8 * 32 // 8
# Team calls one signature of the tree under mxu makes (comb_tree_mxu.cu):
# the prepare pass's decode, 275 of one multiply, and in the accumulate
# pass each of the signature's TREE_MXU_TEAMS teams (MOCHI_TREE17_TEAMS)
# makes its share of the 128 mixed additions (4 calls each), every level
# of the sum across the teams (ge_to_cached's call and ge_add's 4) and the
# compare's 1: 275 + 4 x 139.  Each call issues MMA_MACS_PER_CALL.
TREE_MXU_TEAMS = 4
TREE_MXU_CALLS_PER_SIGNATURE = 275 + TREE_MXU_TEAMS * (
    128 * 4 // TREE_MXU_TEAMS + 5 * (TREE_MXU_TEAMS.bit_length() - 1) + 1)

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
    "tree": ("comb_tree", "mochi_comb_tree_verify", 7, False),
    "chain_mxu": ("comb_mxu", "mochi_comb_mxu_verify", 7, False),
    "tree_mxu": ("comb_tree_mxu", "mochi_comb_tree_mxu_verify", 8, True),
}

# What every comb kernel's attribute query reports, in its order.
_ATTR_NAMES = ("registers", "local_bytes", "shared_bytes", "threads", "team", "dynamic_shared_bytes")


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
        attrs.argtypes = [ctypes.c_int] * by_pass + [ctypes.POINTER(ctypes.c_int)] * len(_ATTR_NAMES)
        attrs.restype = ctypes.c_int
        lib._mochi_typed = True
    return lib


def kernel_attributes(kernel: str = "chain") -> dict:
    """Registers per thread, local bytes per thread, static shared bytes,
    threads per block, lanes a signature (``team``) and the dynamic shared
    bytes of a launch of ``kernel``'s compiled kernel (one of
    :data:`KERNELS`; cudaFuncGetAttributes); for ``tree_mxu``, one such
    dict for each pass (``prepare``, ``accumulate``)."""
    fn = getattr(_lib(kernel), _LIBS[kernel][1] + "_attrs")

    def query(*which):
        vals = [ctypes.c_int(0) for _ in _ATTR_NAMES]
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
                         multiply=None, out=None) -> torch.Tensor:
    """(B,) bool bitmap of the comb verify with ``impl``'s accumulation
    (default ``comb.COMB_IMPL``) and ``multiply`` (``pad`` or ``mxu``;
    default ``MOCHI_SKEW_IMPL``'s): on a card the kernel of
    :func:`kernel_of`; on the CPU the plain version of the same pair (see
    the module docstring).  ``out``, a contiguous (B,) bool tensor on the
    lanes' device, takes the bitmap in place of a new one and is returned."""
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
    n = y_r.shape[0]
    if out is not None:
        _check("out", out, torch.bool, (n,), device)
    if device.type == "cpu":
        got = comb.verify_comb_prepared(table, key_idx, y_r, sign_r, s_bytes, h_bytes, impl=impl,
                                        multiply=multiply)
        return got if out is None else out.copy_(got)
    if device.type != "cuda":
        raise ValueError(f"no comb kernel for device {device}")
    kernel = kernel_of(impl, multiply)
    _check("table", table, torch.int32, tuple(table.shape), device)
    _check("key_idx", key_idx, torch.int32, (n,), device)
    _check("y_r", y_r, torch.int32, (n, F.NLIMBS), device)
    _check("sign_r", sign_r, torch.int32, (n,), device)
    _check("s_bytes", s_bytes, torch.uint8, (n, 32), device)
    _check("h_bytes", h_bytes, torch.uint8, (n, 32), device)
    if out is None:
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
        if kernel == "tree_mxu":
            # allocated on this stream: the caching allocator reuses it only
            # after work queued here, so the passes below own it
            scratch = torch.empty((n, TREE17_RECORD_INTS), dtype=torch.int32, device=device)
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
