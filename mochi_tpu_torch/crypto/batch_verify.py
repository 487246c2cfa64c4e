"""Batched Ed25519 verification: host prepare + the CUDA verify kernel.

Division of labour (as in the reference package):

* **Host** — everything variable-length or cheap: SHA-512 of R||A||M
  (hashlib), the mod-L reduction (python bignum), the RFC 8032 canonical
  prechecks (lengths, y < p on the masked encoding, S < L), and packing
  into fixed-shape tensors (scalars as bytes).
* **Device** — decode and the double-scalar multiply, one signature per
  thread (:mod:`.cuda_verify`).

Requests larger than the launch size are cut into chunks.  Every chunk is
launched before any is read back, so chunk k+1's host prepare runs while
chunk k is on the card; each travels through pinned host buffers with
``non_blocking`` copies on the calling thread's own CUDA stream, so the
batches that several threads verify at once overlap on the card too.  A
chunk whose prechecks reject every item never reaches the device and is not
counted as a dispatch.

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
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import cuda_verify
from . import field as F
from ..verifier.spi import VerifyItem


# Largest single kernel launch, and CudaBatchVerifier's default batch.  The
# kernel takes any lane count; 8192 was the reference's TPU memory limit,
# and the card's own launch size is still to be chosen from measurements
# (ROADMAP.md).
MAX_LAUNCH = 8192

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

    idx_arr = np.asarray(idx)
    ok_idx = idx_arr[ok]
    if len(ok_idx):
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

# Real device dispatches and the items they carried (process totals; the
# lock because BatchingVerifier runs several backend calls at once).
_device_dispatches = 0
_device_items = 0
_count_lock = threading.Lock()


def _note_dispatch(n_items: int) -> None:
    global _device_dispatches, _device_items
    with _count_lock:
        _device_dispatches += 1
        _device_items += n_items


def device_dispatch_count() -> int:
    return _device_dispatches


def device_item_count() -> int:
    """Items (lanes) sent to the device, all dispatches together."""
    return _device_items


def reset_counts() -> None:
    global _device_dispatches, _device_items
    with _count_lock:
        _device_dispatches = 0
        _device_items = 0


# ------------------------------------------------------------------- launch

_streams: dict = {}


def _thread_stream(device: torch.device) -> torch.cuda.Stream:
    """One CUDA stream per (thread, device), so concurrent callers overlap."""
    key = (threading.get_ident(), str(device))
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(device=device)
    return s


def _dispatch(prepared, device: torch.device):
    """Send one prepared chunk to the device and launch; no readback.
    Returns (bitmap or None, stream, pinned inputs, pre_ok)."""
    *arrays, pre_ok = prepared
    if not pre_ok.any():
        return None, None, None, pre_ok
    _note_dispatch(len(pre_ok))
    if device.type == "cpu":
        bitmap = cuda_verify.verify_prepared_packed(*cuda_verify.from_reference_prepared(arrays, device))
        return bitmap, None, None, pre_ok
    hosts = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrays]
    stream = _thread_stream(device)
    with torch.cuda.stream(stream):
        bitmap = cuda_verify.verify_prepared_packed(*(h.to(device, non_blocking=True) for h in hosts))
    # the pinned inputs stay referenced until the readback synchronises
    return bitmap, stream, hosts, pre_ok


def _readback(launched) -> List[bool]:
    """Block on one launched chunk (a synchronising copy on the stream it
    ran on) and AND the bitmap with the host prechecks."""
    bitmap, stream, _hosts, pre_ok = launched
    if bitmap is None:  # all-rejected chunk: no device work was done
        return [False] * len(pre_ok)
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        host = bitmap.cpu().numpy()
    return [bool(b) for b in np.logical_and(host, pre_ok)]


def verify_batch(items: Sequence[VerifyItem], device="cuda") -> List[bool]:
    """Verify a batch on ``device`` ("cuda" by default, "cpu" for the plain
    version); returns one bool per item."""
    if not items:
        return []
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    launched = [
        _dispatch(prepare_packed(items[i : i + MAX_LAUNCH]), device)
        for i in range(0, len(items), MAX_LAUNCH)
    ]
    return [ok for chunk in launched for ok in _readback(chunk)]


# ------------------------------------------------------------------ backend


class TorchBatchBackend:
    """``BatchBackend`` for :class:`mochi_tpu_torch.verifier.spi.BatchingVerifier`.

    Called from the verifier's executor threads; each call verifies its
    items through :func:`verify_batch` on ``device``.  A CUDA kernel needs
    no per-shape compile, so the reference's bucket-readiness machinery has
    no counterpart here.

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
        # Known signers (cluster identities).  Accepted for the comb path
        # that is still to be ported; all traffic takes the general kernel.
        self.registered_signers: List[bytes] = []
        self.crossover_batches = 0
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """Build and load the kernel now, so no request waits for nvcc."""
        if self.device.type == "cuda":
            cuda_verify._lib()

    def register_signers(self, pubs: Sequence[bytes]) -> None:
        with self._lock:
            known = set(self.registered_signers)
            for p in map(bytes, pubs):
                if p not in known:
                    known.add(p)
                    self.registered_signers.append(p)

    def __call__(self, items: Sequence[VerifyItem]) -> Sequence[bool]:
        if len(items) < self.min_device_items:
            from . import keys as _keys

            with self._lock:
                self.crossover_batches += 1
            return [_keys.verify(it.public_key, it.message, it.signature) for it in items]
        return verify_batch(items, self.device)
