"""Batched Ed25519 verification: host prepare + the CUDA verify kernel.

Division of labour (as in the reference package):

* **Host** — everything variable-length or cheap: SHA-512 of R||A||M and
  its mod-L reduction (one call of ``native/hbatch.c`` over the batch where
  it is built, else hashlib and a Python bignum per item), the RFC 8032 canonical
  prechecks (lengths, y < p on the masked encoding, S < L), and packing
  into fixed-shape tensors (scalars as bytes).
* **Device** — decode and the double-scalar multiply, one signature per
  team of four lanes (:mod:`.cuda_verify`); or, for a key registered in a
  :class:`~mochi_tpu_torch.crypto.comb.SignerRegistry` (the cluster's
  replica identities), the doubling-free comb kernel (:mod:`.cuda_comb`).

Routing (``verify_batch(..., registry=...)``): items whose key is registered
below the pinned generation take the comb kernel, the rest the general
kernel; a mixed batch launches both kernels before reading either back and
merges one bitmap.  ``MOCHI_COMB=0`` turns the comb path off (every item
takes the general kernel), as in the reference.  ``MOCHI_COMB_IMPL``
(``comb.COMB_IMPL``: ``chain`` by default, or ``tree``) chooses which comb
kernel every comb launch runs, as the reference's switch reaches every comb
caller: the verifier service, ``CudaBatchVerifier``, the sharded backend and
the replica all launch through :func:`_dispatch`.  ``MOCHI_SKEW_IMPL=mxu``
(``field.SKEW_IMPL``) reaches every general launch the same way (they run
the tensor-core kernel, :mod:`.cuda_verify`), and every comb launch (the
tensor-core chain, ``comb_mxu.cu``, or tree, ``comb_tree_mxu.cu``).  A batch reads both switches once,
where it pins its comb table (``cuda_comb.switches``), so the table's
layout and the kernel that reads it always agree.

Requests larger than the launch size (``MAX_LAUNCH``, ``MOCHI_MAX_BUCKET``)
are cut into chunks behind the reference's bounded window: one prepare
worker thread (``mochi-prep``) prepares chunk k+1 while the caller launches
chunk k, and launches stay at most ``_PIPELINE_DEPTH`` (4) chunks ahead of
readbacks, so live memory is O(4 chunks), not O(request).  A chunk's pinned
inputs and bitmap are released at its readback.  Each chunk travels through
pinned host buffers with ``non_blocking`` copies on the calling thread's own
CUDA stream, so the batches that several threads verify at once overlap on
the card too.  A mixed batch whose two halves each fit one launch launches
both kernels before reading either back.  A chunk whose prechecks reject
every item never reaches the device and is not counted as a dispatch.
While a ``torch.profiler`` session records, each launch, its pins and each
readback open a span on the profiler's clock
(:func:`~mochi_tpu_torch.obs.trace.device_span`: ``mochi.dispatch``,
``mochi.pin``, ``mochi.readback``).

Verdicts equal OpenSSL's cofactorless verify and the reference package's
bit for bit: per-item verdicts, device bitmap ANDed with the host
prechecks (random-linear-combination batching was rejected in the
reference for its cofactored disagreements; the port keeps that choice).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import cuda_comb
from . import cuda_verify
from . import field as F
from .comb import SignerRegistry
from ..obs.trace import SPAN_DISPATCH, SPAN_PIN, SPAN_READBACK, device_span
from ..verifier.spi import VerifyItem


MIN_LAUNCH = 16


def _max_bucket() -> int:
    """``MOCHI_MAX_BUCKET`` as the reference reads it: 8192 by default or
    when it is not an integer, at least ``MIN_LAUNCH``, rounded down to a
    power of two."""
    try:
        v = int(os.environ.get("MOCHI_MAX_BUCKET", "8192"))
    except ValueError:
        return 8192
    v = max(v, MIN_LAUNCH)
    return 1 << (v.bit_length() - 1)


# Largest single kernel launch (read once, at import), and
# CudaBatchVerifier's default batch.  The kernels take any lane count; the
# default 8192 is the reference's, and the card's own launch size is still
# to be chosen from measurements (ROADMAP.md).
MAX_LAUNCH = _max_bucket()

# Chunks launched ahead of readbacks in verify_batch's window.
_PIPELINE_DEPTH = 4

# 15-bit limb weights and the uint64-word forms of p and L, for the
# vectorized prechecks below.
_W15 = (1 << np.arange(15, dtype=np.int32)).astype(np.int32)
_P_WORDS = [(F.P_INT >> (64 * k)) & ((1 << 64) - 1) for k in range(4)]
_L_WORDS = [(F.L_INT >> (64 * k)) & ((1 << 64) - 1) for k in range(4)]


def _bits_le(rows: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 -> (n, 256) little-endian bits (uint8)."""
    return np.unpackbits(rows, axis=1, bitorder="little")


def _bits_to_limbs(bits: np.ndarray) -> np.ndarray:
    """(n, 256) LE bits -> (n, 17) int32 limbs (bit 255 never read)."""
    return bits[:, :255].reshape(-1, F.NLIMBS, F.RADIX).astype(np.int32) @ _W15


def _words_le(rows: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 -> (n, 4) uint64 little-endian words."""
    return rows.view("<u8")


def _lt_p(words: np.ndarray) -> np.ndarray:
    """value < p = 2^255-19, for values already masked below 2^255."""
    w0, w1, w2, w3 = (words[:, k] for k in range(4))
    ge = (
        (w3 == _P_WORDS[3]) & (w2 == _P_WORDS[2]) & (w1 == _P_WORDS[1])
        & (w0 >= _P_WORDS[0])
    )
    return ~ge


def _lt_l(words: np.ndarray) -> np.ndarray:
    """value < L (group order), lexicographic compare from the top word."""
    w0, w1, w2, w3 = (words[:, k] for k in range(4))
    ge = (w3 > _L_WORDS[3]) | (
        (w3 == _L_WORDS[3])
        & ((w2 > _L_WORDS[2]) | ((w2 == _L_WORDS[2]) & (
            (w1 > _L_WORDS[1]) | ((w1 == _L_WORDS[1]) & (w0 >= _L_WORDS[0]))
        )))
    )
    return ~ge


def _hbatch():
    """The native batched-h module (None -> the hashlib path)."""
    from ..native import get_hbatch

    return get_hbatch()


def prepare_packed(items: Sequence[VerifyItem]):
    """Host-side packing, array for array identical to the reference's:
    (y_a (n,17) int32, sign_a (n,) int32, y_r, sign_r, s_bytes (n,32) uint8,
    h_bytes (n,32) uint8, pre_ok (n,) bool).  Malformed lengths, y >= p and
    S >= L are rejected here; h is hashed only for items that pass."""
    n = len(items)
    y_a = np.zeros((n, F.NLIMBS), dtype=np.int32)
    y_r = np.zeros((n, F.NLIMBS), dtype=np.int32)
    sign_a = np.zeros(n, dtype=np.int32)
    sign_r = np.zeros(n, dtype=np.int32)
    s_bytes = np.zeros((n, 32), dtype=np.uint8)
    h_bytes = np.zeros((n, 32), dtype=np.uint8)
    pre_ok = np.zeros(n, dtype=bool)

    idx = [
        i
        for i, it in enumerate(items)
        if len(it.public_key) == 32 and len(it.signature) == 64
    ]
    if not idx:
        return y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, pre_ok
    m = len(idx)

    a_rows = np.frombuffer(
        b"".join(bytes(items[i].public_key) for i in idx), dtype=np.uint8
    ).reshape(m, 32)
    sig_rows = np.frombuffer(
        b"".join(bytes(items[i].signature) for i in idx), dtype=np.uint8
    ).reshape(m, 64)
    r_rows = np.ascontiguousarray(sig_rows[:, :32])
    s_rows = np.ascontiguousarray(sig_rows[:, 32:])

    a_bits = _bits_le(a_rows)
    r_bits = _bits_le(r_rows)
    sa = a_bits[:, 255].astype(np.int32)
    sr = r_bits[:, 255].astype(np.int32)

    a_masked = a_rows.copy()
    a_masked[:, 31] &= 0x7F
    r_masked = r_rows.copy()
    r_masked[:, 31] &= 0x7F
    ok = _lt_p(_words_le(a_masked)) & _lt_p(_words_le(r_masked))
    ok &= _lt_l(_words_le(s_rows))

    # h = SHA-512(R || A || M) mod L, ONLY for items that passed the
    # prechecks (a flood of non-canonical signatures over big messages must
    # not buy host hashing work; rejected lanes are masked by pre_ok
    # regardless): one call of native/hbatch.c over the batch where it is
    # built, else hashlib and a Python bignum per item.
    idx_arr = np.asarray(idx)
    ok_idx = idx_arr[ok]
    if len(ok_idx):
        hb = _hbatch()
        if hb is not None:
            msgs = b"".join(bytes(items[i].message) for i in ok_idx)
            lens = np.fromiter((len(items[i].message) for i in ok_idx), dtype=np.uint64, count=len(ok_idx))
            h_cat = hb.h_batch(r_rows[ok].tobytes(), a_rows[ok].tobytes(), msgs, lens.tobytes())
            h_bytes[ok_idx] = np.frombuffer(h_cat, dtype=np.uint8).reshape(-1, 32)
        else:
            h_parts = []
            for i in ok_idx:
                it = items[i]
                h_int = (
                    int.from_bytes(
                        hashlib.sha512(
                            bytes(it.signature[:32]) + bytes(it.public_key) + bytes(it.message)
                        ).digest(),
                        "little",
                    )
                    % F.L_INT
                )
                h_parts.append(h_int.to_bytes(32, "little"))
            h_bytes[ok_idx] = np.frombuffer(b"".join(h_parts), dtype=np.uint8).reshape(-1, 32)

    y_a[idx_arr] = _bits_to_limbs(a_bits)
    y_r[idx_arr] = _bits_to_limbs(r_bits)
    sign_a[idx_arr] = sa
    sign_r[idx_arr] = sr
    s_bytes[idx_arr] = s_rows
    pre_ok[idx_arr] = ok
    return y_a, sign_a, y_r, sign_r, s_bytes, h_bytes, pre_ok


# ------------------------------------------------------------ dispatch counts

# Real device dispatches (of either kernel) and the items they carried,
# the comb kernel's share, and the router's occupancy: items sent down each
# path and batches that carried both (process totals; the lock because
# BatchingVerifier runs several backend calls at once).
_device_dispatches = 0
_device_items = 0
_comb_dispatches = 0
_comb_items_routed = 0
_ladder_items_routed = 0
_mixed_batches = 0
_count_lock = threading.Lock()


def _note_dispatch(n_items: int, comb: bool = False) -> None:
    global _device_dispatches, _device_items, _comb_dispatches
    with _count_lock:
        _device_dispatches += 1
        _device_items += n_items
        _comb_dispatches += comb


def _note_routing(n_comb: int, n_ladder: int) -> None:
    global _comb_items_routed, _ladder_items_routed, _mixed_batches
    with _count_lock:
        _comb_items_routed += n_comb
        _ladder_items_routed += n_ladder
        _mixed_batches += bool(n_comb and n_ladder)


def device_dispatch_count() -> int:
    return _device_dispatches


def device_item_count() -> int:
    """Items (lanes) sent to the device, all dispatches together."""
    return _device_items


def comb_dispatch_count() -> int:
    """Dispatches of the comb kernel (included in device_dispatch_count)."""
    return _comb_dispatches


def comb_routing_counts() -> dict:
    """The router's occupancy: items routed to each kernel (counted only
    where a registry was consulted) and batches that carried both."""
    with _count_lock:
        return {
            "comb_items": _comb_items_routed,
            "ladder_items": _ladder_items_routed,
            "mixed_batches": _mixed_batches,
        }


def reset_counts() -> None:
    global _device_dispatches, _device_items, _comb_dispatches
    global _comb_items_routed, _ladder_items_routed, _mixed_batches
    with _count_lock:
        _device_dispatches = _device_items = _comb_dispatches = 0
        _comb_items_routed = _ladder_items_routed = _mixed_batches = 0


def comb_enabled() -> bool:
    """Operator kill switch for the known-signer comb path."""
    return os.environ.get("MOCHI_COMB", "1") != "0"


# ------------------------------------------------------------------- launch

_streams: dict = {}


def _thread_stream(device: torch.device, k=0) -> torch.cuda.Stream:
    """One CUDA stream per (thread, device, slice ``k``), so concurrent
    callers, and the slices of one sharded batch on one card, overlap
    (``k`` may be any key: a slice's upload stream is ``(k, "upload")``)."""
    key = (threading.get_ident(), str(device), k)
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(device=device)
    return s


def _dispatch(prepared, device: torch.device, k: int = 0, comb: Optional[tuple] = None,
              out: Optional[torch.Tensor] = None, upload: Optional[torch.cuda.Stream] = None):
    """Send one prepared chunk to the device and launch; no readback.
    With ``comb`` = (key_idx, table, impl, multiply), the comb table pinned
    at routing time in the layout of the (impl, multiply) read with it, that
    comb kernel runs, else the general kernel.  On a card it runs on the
    stream of (this thread, ``device``, slice ``k``); its uploads run there
    too, or on ``upload``, which that stream then waits for (so a chunk's
    uploads can overlap the kernel before it).  ``out``, a contiguous bool
    view on ``device`` of the chunk's length, takes the kernel's bitmap
    (left as it is when no lane passes the prechecks).  Returns (bitmap or
    None, stream, what must stay alive until readback, pre_ok).  Runs in a
    ``mochi.dispatch`` span, its pins in a ``mochi.pin`` one."""
    with device_span(SPAN_DISPATCH):
        *arrays, pre_ok = prepared
        if not pre_ok.any():
            return None, None, None, pre_ok
        _note_dispatch(len(pre_ok), comb=comb is not None)
        table = None
        into = {} if out is None else {"out": out}
        if comb is not None:
            key_idx, table, impl, multiply = comb
            host = cuda_comb.from_prepared(key_idx, arrays, "cpu")
            kernel = lambda *t: cuda_comb.verify_comb_prepared(table, *t, impl=impl, multiply=multiply, **into)  # noqa: E731
        else:
            host = cuda_verify.from_reference_prepared(arrays, "cpu")
            kernel = lambda *t: cuda_verify.verify_prepared_packed(*t, **into)  # noqa: E731
        if device.type == "cpu":
            return kernel(*host), None, None, pre_ok
        hosts = _pinned(host)
        stream = _thread_stream(device, k)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            if upload is None:
                lanes = [h.to(device, non_blocking=True) for h in hosts]
            else:
                with torch.cuda.stream(upload):
                    lanes = [h.to(device, non_blocking=True) for h in hosts]
                stream.wait_stream(upload)
                for t in lanes:  # freed below: not reused before the kernel has read it
                    t.record_stream(stream)
            bitmap = kernel(*lanes)
        # The pinned inputs and the pinned comb table stay referenced until the
        # readback synchronises: a registration that rebuilds the registry's
        # table cannot free this one under the running kernel.
        return bitmap, stream, (hosts, table), pre_ok


def _pinned(host: Sequence[torch.Tensor]) -> list:
    """Pinned copies of ``host``, in one ``mochi.pin`` span.  One span a
    group, not a pin: under the profiler a span's own records cost about
    half of a 1,536-lane pin."""
    with device_span(SPAN_PIN):
        return [h.pin_memory() for h in host]


def _readback(launched) -> np.ndarray:
    """Block on one launched chunk (a synchronising copy on the stream it
    ran on) and AND the bitmap with the host prechecks: (n,) bool.  Runs
    in a ``mochi.readback`` span."""
    with device_span(SPAN_READBACK):
        bitmap, stream, _hosts, pre_ok = launched
        if bitmap is None:  # all-rejected chunk: no device work was done
            return np.zeros(len(pre_ok), dtype=bool)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            host = bitmap.cpu().numpy()
        return np.logical_and(host, pre_ok)


def verify_batch(items: Sequence[VerifyItem], device="cuda", registry=None,
                 comb_gen: Optional[int] = None) -> List[bool]:
    """Verify a batch on ``device`` ("cuda" by default, "cpu" for the plain
    versions); returns one bool per item.

    ``registry`` (a :class:`~mochi_tpu_torch.crypto.comb.SignerRegistry`)
    enables the comb path: an item whose key is registered with an index
    below ``comb_gen`` (the generation pinned at routing time; default: the
    current one) takes the comb kernel against the table of that
    generation, the rest the general kernel.  The comb chunks, then the
    general ones, go through one window (:func:`_run_window`).  Verdicts
    are identical either way.
    """
    if not items:
        return []
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    comb_pos: List[int] = []
    gen_pos: List[int] = list(range(len(items)))
    if registry is not None and len(registry) and comb_enabled():
        gen = registry.generation if comb_gen is None else comb_gen
        idx = [registry.index_of(it.public_key) for it in items]
        comb_pos = [i for i, k in enumerate(idx) if k is not None and k < gen]
        gen_pos = [i for i, k in enumerate(idx) if k is None or k >= gen]
        _note_routing(len(comb_pos), len(gen_pos))
    jobs = []
    if comb_pos:
        switches = cuda_comb.switches()  # read once: the table's layout and the kernel agree
        table = registry.device_table(device, gen, layout=cuda_comb.table_layout(device, *switches))
        kidx = np.asarray([idx[i] for i in comb_pos], dtype=np.int32)
        for i in range(0, len(comb_pos), MAX_LAUNCH):
            jobs.append(([items[j] for j in comb_pos[i : i + MAX_LAUNCH]],
                         (kidx[i : i + MAX_LAUNCH], table, *switches)))
    for i in range(0, len(gen_pos), MAX_LAUNCH):
        jobs.append(([items[j] for j in gen_pos[i : i + MAX_LAUNCH]], None))
    out: List[bool] = [False] * len(items)
    prefetch = max(len(comb_pos), len(gen_pos)) > MAX_LAUNCH
    for j, ok in zip(comb_pos + gen_pos, (ok for chunk in _run_window(jobs, device, prefetch) for ok in chunk)):
        out[j] = bool(ok)
    return out


def _run_window(jobs, device: torch.device, prefetch: bool) -> List[np.ndarray]:
    """Launch each (items, comb) job of ``jobs`` and read it back in order,
    at most ``_PIPELINE_DEPTH`` launched and not yet read back: chunk k is
    launched, then chunk k - 4 read back before chunk k + 1 is.  With
    ``prefetch`` the prepare worker prepares chunk k + 1 while chunk k is
    launched and chunk k - 4 read back; without it (a request of at most
    one chunk a kernel) each chunk is prepared on the caller's thread, and
    both kernels of a mixed batch still launch before either is read back.
    A launched chunk (its pinned inputs, its bitmap) is dropped at its
    readback.  Returns one verdict array per job."""
    window: deque = deque()
    out: List[np.ndarray] = []
    pool = _prep_pool() if prefetch else None
    fut = pool.submit(prepare_packed, jobs[0][0]) if pool else None
    for k, (chunk, comb) in enumerate(jobs):
        if pool is not None:
            prepared = fut.result()
            if k + 1 < len(jobs):
                fut = pool.submit(prepare_packed, jobs[k + 1][0])
        else:
            prepared = prepare_packed(chunk)
        window.append(_dispatch(prepared, device, comb=comb))
        if len(window) >= _PIPELINE_DEPTH:
            out.append(_readback(window.popleft()))
    while window:
        out.append(_readback(window.popleft()))
    return out


# One persistent prepare worker: verify_batch runs on the verifier's
# executor threads, so a single overlap thread is enough (the reference's).
_PREP_POOL: Optional[ThreadPoolExecutor] = None
_PREP_POOL_LOCK = threading.Lock()


def _prep_pool() -> ThreadPoolExecutor:
    global _PREP_POOL
    if _PREP_POOL is None:
        with _PREP_POOL_LOCK:
            if _PREP_POOL is None:
                _PREP_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mochi-prep")
    return _PREP_POOL


def _dummy_items(n: int) -> List[VerifyItem]:
    """``n`` copies of one valid signature by a throwaway key (never a
    registered signer): items every host precheck accepts."""
    from .keys import generate_keypair

    kp = generate_keypair()
    msg = b"mochi-tpu warmup"
    return [VerifyItem(kp.public_key, msg, kp.sign(msg))] * n


# ------------------------------------------------------------------ backend


class TorchBatchBackend:
    """``BatchBackend`` for :class:`mochi_tpu_torch.verifier.spi.BatchingVerifier`.

    Called from the verifier's executor threads; each call verifies its
    items through :func:`verify_batch` on ``device``.  A CUDA kernel needs
    no per-shape compile, so the reference's bucket-readiness machinery has
    no counterpart here.

    Known signers: the backend owns a
    :class:`~mochi_tpu_torch.crypto.comb.SignerRegistry`;
    :meth:`register_signers` builds their comb tables, and every call pins
    the registry's generation at routing time, so a registration racing a
    batch moves only later batches onto the comb kernel.

    CPU crossover: a batch smaller than ``min_device_items``
    (``MOCHI_DEVICE_MIN_BATCH``) is verified on the host instead.  The
    default is 0, every batch to the device: the reference's 384 was set for
    a TPU behind a network tunnel, and the attached card's crossover is not
    measured yet.
    """

    def __init__(self, device="cuda", min_device_items: Optional[int] = None):
        self.device = torch.device(device)
        if min_device_items is None:
            try:
                min_device_items = int(os.environ.get("MOCHI_DEVICE_MIN_BATCH", "0"))
            except ValueError:
                min_device_items = 0
        self.min_device_items = max(0, min_device_items)
        self.registry = SignerRegistry(self.device)
        self.crossover_batches = 0
        self._lock = threading.Lock()

    @property
    def registered_signers(self) -> List[bytes]:
        return self.registry.public_keys()

    def warmup(self, batch_sizes: Sequence[int] = ()) -> None:
        """Build and load the kernels now (one nvcc each, in parallel), and
        upload the comb table of the registered signers in the layout of
        the switches in effect, so no request waits for either.  Then, at
        each of ``batch_sizes`` (at most ``MAX_LAUNCH``), launch the general
        kernel of the skew in effect once on items its prechecks accept,
        and, with signers registered, the comb kernel of the switches in
        effect once against the registry's table, through the launch path
        of live traffic (:func:`_dispatch`, :func:`_readback`), so the
        first request pays no first launch.  A build or launch error
        raises; so does a warm general launch that rejects a valid item."""
        if self.device.type == "cuda":
            switches = cuda_comb.switches()
            cuda_verify._lib(cuda_verify.skew())  # builds every missing kernel at once
            cuda_comb._lib(cuda_comb.kernel_of(*switches))
            if len(self.registry):
                self.registry.device_table(self.device, layout=cuda_comb.table_layout(self.device, *switches))
        self._warm_launches(self.device, batch_sizes)

    def _warm_launches(self, device: torch.device, batch_sizes: Sequence[int]) -> None:
        """One warm launch of each kernel of the live path on ``device`` at
        each size; synchronizes the card before it returns."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        for n in dict.fromkeys(min(max(int(b), 1), MAX_LAUNCH) for b in batch_sizes):
            prepared = prepare_packed(_dummy_items(n))
            if not _readback(_dispatch(prepared, device)).all():
                raise RuntimeError(f"warmup: the general kernel rejected valid items at {n} lanes")
            if len(self.registry) and comb_enabled():
                switches = cuda_comb.switches()
                table = self.registry.device_table(device, layout=cuda_comb.table_layout(device, *switches))
                comb = (np.zeros(n, dtype=np.int32), table, *switches)
                _readback(_dispatch(prepared, device, comb=comb))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def register_signers(self, pubs: Sequence[bytes]) -> None:
        """Register known signers (cluster replica identities): their
        traffic takes the comb kernel from the next batch on."""
        self.registry.register_all(pubs)

    def __call__(self, items: Sequence[VerifyItem]) -> Sequence[bool]:
        if len(items) < self.min_device_items:
            from . import keys as _keys

            with self._lock:
                self.crossover_batches += 1
            return [_keys.verify(it.public_key, it.message, it.signature) for it in items]
        return self._verify(items)

    def _verify(self, items: Sequence[VerifyItem]) -> List[bool]:
        """The device path of one batch (a sharded backend overrides it)."""
        return verify_batch(items, self.device, self.registry)
