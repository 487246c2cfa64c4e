"""Sharded Ed25519 verification and the 2f+1 quorum tally over several devices.

Counterpart of the reference package's ``parallel/sharded.py``, which runs
``shard_map`` over a 1-D ``jax.sharding.Mesh``: each chip verifies its slice
of the signature batch, the quorum tally is a segment sum of the local
bitmap into quorum slots, and one ``psum`` adds the slots over the mesh.

Here a :class:`Mesh` is a list of ``torch.device``s, one contiguous slice of
every batch each (a device may appear twice: two slices on one card), plus
the ``torch.distributed`` process group when the batch spans processes (one
process per card; NCCL on cards, gloo on the CPU).  On a CUDA device a slice
runs the hand-written kernels (``csrc/verify.cu``, ``csrc/comb.cu``,
``csrc/tally.cu``) on a stream of its own, launched through
``crypto/batch_verify.py``'s path (pinned staging, a non-blocking upload,
a readback on the same stream), and every slice is launched before any is
read back; a slice of 2 x ``MAX_LAUNCH`` lanes or more is staged and
launched in parts of about ``MAX_LAUNCH`` lanes, so the host pins a part
while the card verifies the one before.  On the CPU it runs their plain
versions.  The slots of the local slices are added on the first slice's device (a copy and an add, after
an event per slice), then ``all_reduce(SUM)`` over the process group, so
every rank holds the same counts, as the reference's replicated outputs do.

Two differences from the reference, both on purpose:

* the quorum step takes ``prepare_packed``'s ``pre_ok`` and tallies only
  lanes that the device bitmap AND the host prechecks accept.  The
  reference tallies the raw bitmap, which is True for some lanes the host
  rejected (S >= L, a non-canonical A), because ``prepare_packed`` leaves
  h = 0 there and the device then checks only [S]B == R;
* batches are host arrays and results come back to the host: the bitmap
  (the verdicts, ANDed with ``pre_ok`` in the quorum step) and the counts.

As in the reference, shapes are static in one respect: a batch must split
evenly over the mesh's slices; :func:`pad_to_multiple` pads it, with lanes
that tally into a dead slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import batch_verify as BV
from ..crypto import cuda_comb
from ..obs.trace import SPAN_QUORUM_STEP, SPAN_READBACK, SPAN_TALLY, device_span
from . import cuda_tally


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the batch axis (see the module docstring)."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """Slices of each batch in this process."""
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card, or this
    process's own card once ``torch.distributed`` is initialised).  Pass
    ``devices=["cpu"] * k`` for k slices on the host, or ``["cuda:0",
    "cuda:0"]`` for two slices on one card.  Raises when the default finds
    no card."""
    import torch.distributed as dist

    distributed = dist.is_available() and dist.is_initialized()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices=['cpu', ...] "
                "to run the plain versions on the host"
            )
        if distributed:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: no CUDA device is available for {d}")
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"make_mesh: the devices {devs} are not all of one type")
    return Mesh(tuple(devs), dist.group.WORLD if distributed else None)


def pad_to_multiple(arrays, n: int, multiple: int, dead_group: int):
    """Pad leading dim of each array to a multiple; extra group_ids -> dead slot.

    ``arrays`` is a tuple whose LAST entry is the (n,) group ids (the
    reference passes (y_a, sign_a, y_r, sign_r, s_bits, h_bits, group_ids);
    the port's quorum step takes ``prepare_packed``'s seven arrays, pre_ok
    included, then the group ids); padded lanes fail verification (all-zero
    encodings are fine to feed the kernel; their pre_ok is False) and tally
    into ``dead_group``, which callers ignore.  Returns (arrays, padded
    length); the arrays are returned as given when no padding is needed.
    """
    m = ((n + multiple - 1) // multiple) * multiple
    if m == n:
        return arrays, n
    out = []
    for i, a in enumerate(arrays):
        pad = [(0, m - n)] + [(0, 0)] * (a.ndim - 1)
        if i == len(arrays) - 1:  # group_ids
            a = np.pad(a, pad, constant_values=dead_group)
        else:
            a = np.pad(a, pad)
        out.append(a)
    return tuple(out), m


# ------------------------------------------------------------ plain tally


def segment_tally(bitmap, pre_ok, group_ids, n_groups: int) -> torch.Tensor:
    """The tally kernel's plain version: (n_groups,) int32 count, per slot,
    of lanes that ``bitmap`` and ``pre_ok`` both accept, with the
    reference's index rule (``.at[ids].add(..., mode="drop")``): an id in
    [-n_groups, -1] wraps to id + n_groups, any other id outside
    [0, n_groups) is dropped.  Written as a one-hot compare and a column
    sum, in chunks of lanes, on the tensors' device."""
    dev = bitmap.device
    ids = group_ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + n_groups, ids)
    vote = bitmap.to(torch.bool) & pre_ok.to(torch.bool) & (ids >= 0) & (ids < n_groups)
    slots = torch.arange(n_groups, dtype=torch.int64, device=dev)
    counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    for lo in range(0, ids.shape[0], 4096):
        hit = (ids[lo : lo + 4096, None] == slots[None, :]) & vote[lo : lo + 4096, None]
        counts += hit.sum(dim=0)
    return counts.to(torch.int32)


def commit(counts, threshold: int) -> torch.Tensor:
    """The commit kernel's plain version: ``counts >= threshold``."""
    return counts >= int(threshold)


# ---------------------------------------------------------- slice launches


def _bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous bounds of ``n`` lanes in ``parts`` parts, as even as they
    go (equal when ``n`` is a multiple of ``parts``)."""
    return [(k * n // parts, (k + 1) * n // parts) for k in range(parts)]


def _require_even(mesh: Mesh, n: int) -> None:
    """The reference's static shapes: a batch must split evenly."""
    if n % mesh.size:
        raise ValueError(
            f"a batch of {n} lanes does not split over the mesh's {mesh.size} slices: "
            "pad it with pad_to_multiple first"
        )


def _dispatch_slices(mesh: Mesh, prepared, key_idx=None, registry=None, gen: Optional[int] = None) -> list:
    """Launch every slice of ``prepare_packed``'s seven arrays through
    ``batch_verify``'s launch path (slice k on its device's stream for this
    thread and k), all before any readback: the comb kernel against
    ``registry``'s table of generation ``gen`` on each device when
    ``key_idx`` is given (y_a and sign_a may then be None), else the general
    kernel.  The comb switches are read once for the batch
    (``cuda_comb.switches``): every slice pins the table layout of the
    kernel it launches.  A slice whose prechecks reject every lane does no
    device work; a slice of 2 x ``MAX_LAUNCH`` lanes or more is staged in
    parts (:func:`_dispatch_slice`).  Returns ``batch_verify._dispatch``'s
    record per slice."""
    launched = []
    switches = None if key_idx is None else cuda_comb.switches()
    for k, (dev, (lo, hi)) in enumerate(zip(mesh.devices, _bounds(len(prepared[6]), mesh.size))):
        part = tuple(None if a is None else a[lo:hi] for a in prepared)
        comb = None
        if key_idx is not None:
            table = registry.device_table(dev, gen, layout=cuda_comb.table_layout(dev, *switches))
            comb = (key_idx[lo:hi], table, *switches)
        launched.append(_dispatch_slice(part, dev, k, comb))
    return launched


def _dispatch_slice(prepared, dev: torch.device, k: int, comb: Optional[tuple]):
    """Launch one slice: ``batch_verify._dispatch`` of the whole slice when
    it holds under 2 x ``MAX_LAUNCH`` lanes (read at the call), else of each
    of its ``n // MAX_LAUNCH`` contiguous parts, as even as they go, in
    turn, each with its own pins, uploads and launch, so the host pins part
    j + 1 while the card runs part j.  On a card the parts' kernels run on
    the slice's stream and their uploads on an upload stream of the slice,
    which the kernels' stream waits for part by part, so an upload overlaps
    the kernel before it too.  The kernels write into views of one (n,)
    bool bitmap on the device; a part the prechecks reject whole launches
    nothing and its range is zeroed.  Returns ``_dispatch``'s record for
    the slice: (bitmap, or None when no part launched; stream; every
    part's pinned inputs; the slice's pre_ok)."""
    n = len(prepared[6])
    parts = n // BV.MAX_LAUNCH
    if parts < 2:
        return BV._dispatch(prepared, dev, k, comb=comb)
    stream = upload = None
    if dev.type == "cuda":
        stream, upload = BV._thread_stream(dev, k), BV._thread_stream(dev, (k, "upload"))
    with torch.cuda.stream(stream):  # a no-op on the CPU
        bitmap = torch.empty(n, dtype=torch.bool, device=dev)  # on the slice's stream, as its kernels
    alive, skipped = [], []
    for lo, hi in _bounds(n, parts):
        part = tuple(None if a is None else a[lo:hi] for a in prepared)
        sub = None if comb is None else (comb[0][lo:hi], *comb[1:])
        got, _s, keep, _ok = BV._dispatch(part, dev, k, comb=sub, out=bitmap[lo:hi], upload=upload)
        if got is None:
            skipped.append((lo, hi))
        else:
            alive.append(keep)
    if not alive:  # one entry a launched part (None on the CPU)
        return None, None, None, prepared[6]
    with torch.cuda.stream(stream):  # no rejected part's lane ever holds an uninitialised byte
        for lo, hi in skipped:
            bitmap[lo:hi].zero_()
    return bitmap, stream, alive, prepared[6]


def _bitmap(launched) -> torch.Tensor:
    """Read every slice back, each on its own stream: (B,) bool, the device
    bitmap AND pre_ok."""
    return torch.from_numpy(np.concatenate([BV._readback(sl) for sl in launched]))


def verify_prepared(mesh: Mesh, prepared, key_idx=None, registry=None, gen: Optional[int] = None) -> torch.Tensor:
    """(B,) bool verdicts of ``prepare_packed``'s seven arrays, split over
    the mesh in contiguous slices as even as they go (the sharded verifier's
    batches need no padding): see :func:`_dispatch_slices`."""
    return _bitmap(_dispatch_slices(mesh, prepared, key_idx, registry, gen))


def make_sharded_verify_packed(mesh: Mesh):
    """Batch-sharded general verify in the packed scalar form: ``verify(y_a,
    sign_a, y_r, sign_r, s_bytes, h_bytes)`` (``prepare_packed``'s first
    six arrays, B a multiple of ``mesh.size``) -> (B,) bool bitmap on the
    host.  One launch of the verify kernel per slice, no collective."""

    def verify(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes) -> torch.Tensor:
        n = len(y_a)
        _require_even(mesh, n)
        return verify_prepared(mesh, (y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, np.ones(n, dtype=bool)))

    return verify


def make_sharded_verify(mesh: Mesh):
    """Batch-sharded general verify in the reference's bit-tensor form:
    ``verify(y_a, sign_a, y_r, sign_r, s_bits, h_bits)`` with (B, 256)
    little-endian scalar bits, packed into bytes on the host and then run
    as :func:`make_sharded_verify_packed` runs them."""
    packed = make_sharded_verify_packed(mesh)

    def verify(y_a, sign_a, y_r, sign_r, s_bits, h_bits) -> torch.Tensor:
        def to_bytes(bits):
            return np.packbits(np.asarray(bits, dtype=np.uint8), axis=1, bitorder="little")

        return packed(y_a, sign_a, y_r, sign_r, to_bytes(s_bits), to_bytes(h_bits))

    return verify


def make_sharded_verify_comb(mesh: Mesh):
    """Batch-sharded known-signer (comb) verify: ``verify(registry, key_idx,
    y_r, sign_r, s_bytes, h_bytes, gen=None)`` -> (B,) bool bitmap on the
    host.  The lanes are split over the slices; the signer table is
    replicated, each slice reading ``registry.device_table(device, gen,
    layout)`` in the layout of the kernel the switches choose (uploaded once
    per device, capacity and layout, then cached), as the reference
    replicates its table over the mesh.  No collective."""

    def verify(registry, key_idx, y_r, sign_r, s_bytes, h_bytes, gen: Optional[int] = None) -> torch.Tensor:
        n = len(key_idx)
        _require_even(mesh, n)
        prepared = (None, None, y_r, sign_r, s_bytes, h_bytes, np.ones(n, dtype=bool))
        return verify_prepared(mesh, prepared, np.asarray(key_idx, dtype=np.int32), registry, gen)

    return verify


def make_quorum_step(mesh: Mesh, n_groups: int):
    """The full distributed step: sharded verify, then the cross-device
    quorum tally.

    ``step(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, pre_ok, group_ids,
    threshold)``: ``prepare_packed``'s seven arrays, ``group_ids`` (B,)
    int32 — the quorum slot (object or transaction) each signature votes
    for — and ``threshold``, 2f+1.  B must be a multiple of ``mesh.size``
    (:func:`pad_to_multiple`).  Per slice: one verify launch, or one a part
    for a slice of 2 x ``MAX_LAUNCH`` lanes or more (:func:`_dispatch_slice`),
    into one bitmap, and one tally launch into an (n_groups,) int32 on its
    device, on the slice's stream (a slice the prechecks reject whole
    launches no verify and tallies no lane).  Then the slots of all slices
    are added on the first slice's stream, after an event per slice, summed over the process group
    (``all_reduce``), and compared with the threshold there.  On a mesh of
    one slice and no process group the tally's counts are final, so one
    launch of the fused tally-and-commit kernel does both.

    Returns (bitmap (B,) bool: the verdicts, device bitmap AND pre_ok;
    counts (n_groups,) int32; committed (n_groups,) bool), on the host.

    While a ``torch.profiler`` session records, a step runs in a
    ``mochi.quorum_step`` span: each verify launch (one a slice, or one a
    part) in a ``mochi.dispatch`` span, then the tally section (its pins,
    uploads, launches, the slot sum, ``all_reduce`` and the commit) in a
    ``mochi.tally`` one, each group of pins in ``mochi.pin``, each readback in
    ``mochi.readback`` (``obs/trace.py``'s ``device_span``).
    """
    if n_groups < 0:
        raise ValueError(f"n_groups = {n_groups} is negative")

    def step(y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, pre_ok, group_ids, threshold):
        with device_span(SPAN_QUORUM_STEP):
            ids = np.ascontiguousarray(group_ids, dtype=np.int32)
            _require_even(mesh, len(ids))
            prepared = (y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, np.asarray(pre_ok, dtype=bool))
            launched = _dispatch_slices(mesh, prepared)
            final = mesh.size == 1 and mesh.group is None  # the one slice's counts are the step's
            committed = None
            parts, alive = [], []  # (stream, counts) per slice; pinned inputs kept until readback
            with device_span(SPAN_TALLY):
                for k, (dev, (lo, hi), (bitmap, _s, _keep, ok)) in enumerate(
                        zip(mesh.devices, _bounds(len(ids), mesh.size), launched)):
                    stream = BV._thread_stream(dev, k) if dev.type == "cuda" else None
                    with torch.cuda.stream(stream):  # a no-op on the CPU
                        if bitmap is None:  # the host rejected every lane: no vote to count
                            lanes = (torch.zeros(0, dtype=torch.bool, device=dev),) * 2 + (
                                torch.zeros(0, dtype=torch.int32, device=dev),)
                        else:
                            host = (torch.from_numpy(ok), torch.from_numpy(ids[lo:hi]))
                            if stream is not None:
                                host = BV._pinned(host)
                                alive.append(host)
                            lanes = (bitmap, *(h.to(dev, non_blocking=True) for h in host))
                        if final:
                            counts, committed = cuda_tally.quorum_tally_commit(*lanes, n_groups, threshold)
                        else:
                            counts = cuda_tally.quorum_tally(*lanes, n_groups)
                    parts.append((stream, counts))
                stream0 = parts[0][0]
                with torch.cuda.stream(stream0):
                    counts = parts[0][1]
                    for stream, c in parts[1:]:
                        if stream is not None:
                            # the add on the first slice's stream waits for this
                            # slice's tally, and no longer
                            done = torch.cuda.Event()
                            done.record(stream)
                            stream0.wait_event(done)
                        counts = counts + c.to(mesh.devices[0], non_blocking=True)
                    if mesh.group is not None:
                        _all_reduce(counts, mesh.group)
                    if committed is None:
                        committed = cuda_tally.quorum_commit(counts, threshold)
            bitmap = _bitmap(launched)
            with device_span(SPAN_READBACK), torch.cuda.stream(stream0):
                return bitmap, counts.cpu(), committed.cpu()

    return step


def _all_reduce(counts: torch.Tensor, group) -> None:
    """Sum ``counts`` in place over the process group (on a card: on the
    current stream's order, which NCCL waits for and then joins)."""
    import torch.distributed as dist

    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
