"""The ``SignatureVerifier`` SPI — the north-star seam (BASELINE.json).

In the reference, message ingress goes straight from the dispatcher to the
datastore with zero cryptographic verification (``server/requesthandlers/*``,
SURVEY.md §2.4).  Here every replica routes signature checks through this SPI:

* :class:`CpuVerifier` — the default host path (OpenSSL via ``cryptography``),
  one verify per call, run inline.
* :class:`BatchingVerifier` — an async micro-batching front: concurrent
  requests' signatures accumulate in a queue that flushes to a pluggable
  batch backend either when ``max_batch`` is reached or after
  ``max_delay_s`` (bounding p50 commit latency at low load — SURVEY.md §7
  "batching discipline").  The CUDA backend
  (:class:`mochi_tpu_torch.crypto.batch_verify.TorchBatchBackend`) plugs in
  here.  On backend failure a host or remote backend falls back to the CPU
  path rather than ever skipping verification, and counts the batch in
  ``fallback_batches``; a verifier without a fallback (the CUDA verifier on
  the card) raises the failure to every caller of the batch instead.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..crypto import keys as crypto_keys

LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class VerifyItem:
    """One Ed25519 verification: (public key, message, signature)."""

    public_key: bytes  # 32 bytes
    message: bytes
    signature: bytes  # 64 bytes


def aggregate_key(items: Sequence[VerifyItem]) -> bytes:
    """Collision-resistant digest of an ORDERED verification set — the memo
    key for :meth:`SignatureVerifier.verify_aggregate`.  Length-prefixed so
    (pub, msg, sig) boundaries can't be shifted between items; callers that
    want cluster-wide memo hits (round 18: one attestation per write
    certificate) must build the item list deterministically (grant order =
    certificate order)."""
    h = hashlib.sha256(b"mochi.agg.v1\x00")
    for it in items:
        for part in (it.public_key, it.message, it.signature):
            h.update(len(part).to_bytes(4, "big"))
            h.update(part)
    return h.digest()


class SignatureVerifier:
    """SPI: verify a batch, returning a validity bitmap (one bool per item)."""

    async def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        raise NotImplementedError

    async def verify_aggregate(
        self, key: bytes, items: Sequence[VerifyItem]
    ) -> bool:
        """Verify an all-or-nothing attestation SET under one memo key.

        The certificate fast path: a write certificate's 2f+1
        grants are one logical artifact — every receiving replica needs the
        same yes/no, not 2f+1 independent verdicts.  ``key`` MUST be a
        collision-resistant digest of ``items`` (:func:`aggregate_key`), so
        the verdict is a pure function of the key and caching/memoizing it
        cluster-wide is sound.  Default: one batched ``verify_batch`` round
        trip (batched EdDSA beats pairing aggregation at committee sizes —
        arXiv 2302.00418); :class:`CachingVerifier` overrides with an
        aggregate memo that counts ONE unique check per certificate.
        A False verdict says only "not all valid" — callers that need
        attribution fall back to the per-item path.
        """
        if not items:
            return True
        return all(await self.verify_batch(items))

    async def close(self) -> None:
        pass

    def register_signers(self, pubs: Sequence[bytes]) -> bool:
        """Route known-signer registration (cluster replica identities) to
        every layer of this composition that can exploit it, and report
        whether any did.

        This is how the comb fast path becomes the DEFAULT engine rather
        than an opt-in: the replica calls this once at boot and on every
        reconfiguration with the cluster config's public keys, whatever
        verifier composition it was built with.  The default walks the
        standard composition attributes — ``inner`` (Caching/Coalescing
        wrappers), ``backend`` (BatchingVerifier → TorchBatchBackend, which
        owns the device :class:`~mochi_tpu_torch.crypto.comb.SignerRegistry`) and
        ``fallback`` (the CPU path, whose pure-Python engine keeps per-
        signer window tables) — so registration reaches the device registry
        AND the host fallback through any stack.  Registration is always
        best-effort: an unreachable layer leaves that traffic on the
        general ladder, never unverified.
        """
        routed = False
        for attr in ("inner", "backend", "fallback"):
            target = getattr(self, attr, None)
            if target is None or target is self:
                continue
            reg = getattr(target, "register_signers", None)
            if callable(reg):
                try:
                    # None (e.g. TorchBatchBackend) means "registered"; only
                    # an explicit False ("nothing here uses signer hints",
                    # e.g. the OpenSSL CPU path) leaves `routed` unset.
                    routed = (reg(list(pubs)) is not False) or routed
                except Exception:
                    LOG.exception(
                        "signer registration via %s.%s failed; its traffic "
                        "stays on the general verify path",
                        type(self).__name__, attr,
                    )
        return routed


class CpuVerifier(SignatureVerifier):
    """Inline host verification (the reference-analog CPU path)."""

    async def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        # Deliberately inline on the loop: this IS the metered host path the
        # batching/remote verifiers fall back to, and shipping single-item
        # batches to an executor costs more than the ~120 us verify itself.
        return [
            crypto_keys.verify(it.public_key, it.message, it.signature)  # mochi-lint: disable=async-blocking
            for it in items
        ]

    def register_signers(self, pubs: Sequence[bytes]) -> bool:
        # With OpenSSL installed this is a no-op (per-verify cost is already
        # ~120 us), and likewise on hosts running the native-C engine (no
        # per-signer state); on toolchain-less wheel-less hosts it
        # pre-promotes the pure-Python engine's per-signer window tables
        # (the host analog of the device comb) so the FIRST certificate
        # check runs combed instead of paying two ~380-addition ladders to
        # earn promotion.
        return crypto_keys.register_known_signers(pubs)


class CoalescingVerifier(SignatureVerifier):
    """Coalesce concurrent ``verify_batch`` calls into shared inner calls.

    For verifiers whose per-call cost is dominated by a fixed round trip
    (``RemoteVerifier``: two loopback frames + service-side scheduling per
    call), N concurrent Write2 certificate checks in one replica otherwise
    pay N round trips for what one combined request answers.  Requests that
    arrive while a flush is in flight ride the NEXT flush together, so
    under load a replica ships one RPC per round trip instead of one per
    certificate.  There is no timer: a lone call flushes immediately; the
    only queueing is behind ``max_inflight`` already-overlapping round
    trips (same overlap discipline as :class:`BatchingVerifier`, whose
    sync-backend/thread-executor shape doesn't fit an async inner).
    """

    def __init__(
        self,
        inner: SignatureVerifier,
        max_batch: int = 16384,
        max_inflight: int = 4,
    ):
        self.inner = inner
        self.max_batch = max_batch
        self.max_inflight = max(1, max_inflight)
        self._pending: List[Tuple[VerifyItem, asyncio.Future]] = []
        self._flush_task: Optional[asyncio.Task] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._chunk_tasks: set = set()
        self.calls = 0
        self.inner_calls = 0

    async def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        if not items:
            return []
        self.calls += 1
        loop = asyncio.get_running_loop()
        if self._inflight is None:
            self._inflight = asyncio.Semaphore(self.max_inflight)
        futures = [loop.create_future() for _ in items]
        self._pending.extend(zip(items, futures))
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = loop.create_task(self._flush())
        return list(await asyncio.gather(*futures))

    async def _flush(self) -> None:
        assert self._inflight is not None
        while self._pending:
            # Acquire BEFORE popping so a cancellation here leaves items in
            # _pending for close() to cancel rather than hanging callers.
            await self._inflight.acquire()
            if not self._pending:
                self._inflight.release()
                break
            chunk = self._pending[: self.max_batch]
            del self._pending[: len(chunk)]
            task = asyncio.get_running_loop().create_task(self._run_chunk(chunk))
            self._chunk_tasks.add(task)
            task.add_done_callback(self._chunk_tasks.discard)

    async def _run_chunk(
        self, chunk: List[Tuple[VerifyItem, asyncio.Future]]
    ) -> None:
        try:
            items = [it for it, _ in chunk]
            try:
                self.inner_calls += 1
                bitmap = await self.inner.verify_batch(items)
                if len(bitmap) != len(items):
                    raise ValueError("inner bitmap length mismatch")
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # Propagate to the callers of THIS chunk (same behavior as
                # calling the inner verifier bare); other chunks still run.
                for _, fut in chunk:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            for (_, fut), ok in zip(chunk, bitmap):
                if not fut.done():
                    fut.set_result(bool(ok))
        finally:
            assert self._inflight is not None
            self._inflight.release()

    async def verify_aggregate(
        self, key: bytes, items: Sequence[VerifyItem]
    ) -> bool:
        # Route to the inner verifier so a wrapped CachingVerifier's
        # aggregate memo still answers in one entry; an aggregate is already
        # one round trip, so there is nothing here to coalesce.
        return await self.inner.verify_aggregate(key, items)

    async def close(self) -> None:
        if self._flush_task is not None and not self._flush_task.done():
            try:
                await self._flush_task
            except asyncio.CancelledError:
                # close() did NOT cancel the flusher (it drains it), so a
                # CancelledError here is close() itself being cancelled —
                # propagate, or a wait_for(close(), t) timeout would hang on
                # the gather below.
                raise
            except Exception:
                pass
        if self._chunk_tasks:
            await asyncio.gather(*list(self._chunk_tasks), return_exceptions=True)
        for _, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        await self.inner.close()


class CachingVerifier(SignatureVerifier):
    """LRU memo over any verifier — verification is a pure function of
    (public key, message, signature), so caching is sound.

    Where it pays: the shared verifier service (``verifier/service.py``)
    sees the SAME MultiGrant from every replica of the set within
    milliseconds (each replica independently checks the certificate, as BFT
    requires) — one device/CPU verification serves all rf of them.  Negative
    results are cached too (a forged grant replayed across replicas costs
    one check, not rf).
    """

    def __init__(self, inner: SignatureVerifier, max_entries: int = 1 << 16):
        self.inner = inner
        self.max_entries = max_entries
        self._cache: "dict[Tuple[bytes, bytes, bytes], bool]" = {}
        # single-flight: key -> future for a verification already dispatched
        # but not yet answered.  All rf replicas of a set check the same
        # certificate within one batching window, so without this the
        # duplicates race past the cache (observed: 0 service cache hits
        # under concurrent cluster load) and each costs a real verification.
        self._inflight: "dict[Tuple[bytes, bytes, bytes], asyncio.Future]" = {}
        self.hits = 0
        self.misses = 0
        # Aggregate memo (round 18): cert-hash -> all-valid verdict.  Kept
        # SEPARATE from the per-item cache so one certificate counts as ONE
        # unique check in the hits/misses meter regardless of quorum size —
        # that ratio IS the live verifies/txn meter (config7_wan).
        self._agg: "dict[bytes, bool]" = {}
        self._agg_inflight: "dict[bytes, asyncio.Future]" = {}
        self.agg_hits = 0
        self.agg_misses = 0

    async def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        out: List[Optional[bool]] = [None] * len(items)
        waiting: List[Tuple[int, asyncio.Future]] = []
        new_keys: "dict[Tuple[bytes, bytes, bytes], List[int]]" = {}
        reps: List[VerifyItem] = []
        for i, it in enumerate(items):
            k = (bytes(it.public_key), bytes(it.message), bytes(it.signature))
            cached = self._cache.get(k)
            if cached is not None:
                out[i] = cached
                self.hits += 1
            elif k in self._inflight:
                waiting.append((i, self._inflight[k]))
                self.hits += 1
            elif k in new_keys:
                new_keys[k].append(i)
                self.hits += 1
            else:
                new_keys[k] = [i]
                reps.append(it)
                self.misses += 1
        if new_keys:
            loop = asyncio.get_running_loop()
            futs = {k: loop.create_future() for k in new_keys}
            self._inflight.update(futs)
            try:
                bitmap = await self.inner.verify_batch(reps)
                if len(bitmap) != len(reps):
                    # A short/long bitmap would silently truncate the zip
                    # below, leaving the tail keys' futures unresolved forever
                    # (concurrent waiters would hang).  Route through the same
                    # cleanup path as a dispatch failure.
                    raise RuntimeError(
                        f"inner verifier returned {len(bitmap)} verdicts "
                        f"for {len(reps)} items"
                    )
            except BaseException:
                # Dispatch failed (or owner cancelled): resolve the futures
                # with a retry sentinel rather than an exception — a
                # concurrent waiter must not inherit THIS caller's failure
                # (it would have verified independently before single-flight
                # existed), and a sentinel can't trigger "exception never
                # retrieved" warnings when nobody is waiting.
                for k, fut in futs.items():
                    # mochi-lint: disable=await-races -- single-flight owner: only the caller that registered futs[k] ever pops it (waiters see `k in _inflight` and never mutate), so the entry cannot have been replaced across the await
                    self._inflight.pop(k, None)
                    if not fut.done():
                        fut.set_result(None)
                raise
            for (k, idxs), ok in zip(new_keys.items(), bitmap):
                ok = bool(ok)
                for i in idxs:
                    out[i] = ok
                if len(self._cache) >= self.max_entries:
                    # drop the oldest insertion (dict preserves order)
                    self._cache.pop(next(iter(self._cache)))
                self._cache[k] = ok
                fut = futs[k]
                # mochi-lint: disable=await-races -- single-flight owner (same contract as the failure path above)
                self._inflight.pop(k, None)
                if not fut.done():
                    fut.set_result(ok)
        for i, fut in waiting:
            ok = await fut
            if ok is None:
                # the dispatching caller failed before producing a verdict —
                # verify this item ourselves (re-enters cache/single-flight)
                (ok,) = await self.verify_batch([items[i]])
            out[i] = bool(ok)
        return [bool(b) for b in out]

    async def verify_aggregate(
        self, key: bytes, items: Sequence[VerifyItem]
    ) -> bool:
        """One memo entry — and ONE hits/misses tick — per attestation set.

        The miss path dispatches straight to ``self.inner.verify_batch``
        (bypassing the per-item cache) so the 2f+1 constituent checks don't
        ALSO land in the per-item meter: with the fast path on, a write
        certificate is one unique check cluster-wide, which is exactly the
        claim the live meter must be able to falsify.  Single-flight the
        same way as items: all rf replicas of a set ask about the same
        certificate within one batching window.
        """
        if not items:
            return True
        key = bytes(key)
        cached = self._agg.get(key)
        if cached is not None:
            self.agg_hits += 1
            self.hits += 1
            return cached
        fut = self._agg_inflight.get(key)
        if fut is not None:
            self.agg_hits += 1
            self.hits += 1
            ok = await fut
            if ok is None:  # dispatcher failed: verify ourselves (re-enters)
                return await self.verify_aggregate(key, items)
            return bool(ok)
        self.agg_misses += 1
        self.misses += 1
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._agg_inflight[key] = fut
        try:
            bitmap = await self.inner.verify_batch(items)
            if len(bitmap) != len(items):
                raise RuntimeError(
                    f"inner verifier returned {len(bitmap)} verdicts "
                    f"for {len(items)} items"
                )
        except BaseException:
            # same retry-sentinel contract as verify_batch's failure path
            # (single-flight owner: only the caller that registered the
            # future ever pops it)
            self._agg_inflight.pop(key, None)
            if not fut.done():
                fut.set_result(None)
            raise
        verdict = all(bool(b) for b in bitmap)
        if len(self._agg) >= self.max_entries:
            self._agg.pop(next(iter(self._agg)))
        self._agg[key] = verdict
        self._agg_inflight.pop(key, None)
        if not fut.done():
            fut.set_result(verdict)
        return verdict

    async def close(self) -> None:
        await self.inner.close()


BatchBackend = Callable[[Sequence[VerifyItem]], Sequence[bool]]


class BatchingVerifier(SignatureVerifier):
    """Micro-batching front for a (possibly device-backed) batch backend.

    Requests enqueue items and await their bitmap slice; a single flusher task
    drains the queue in backend-sized batches.  ``max_delay_s`` bounds how
    long a lone item waits for co-batching (latency/throughput knob); each
    flush runs in a thread executor so the event loop keeps serving traffic
    while the device crunches.  Up to ``max_inflight`` batches run
    concurrently, so in-flight batches overlap one batch's host prepare and
    readback with another's device execution.

    ``fallback`` (default: :class:`CpuVerifier`) answers a batch the backend
    failed.  A subclass that sets ``self.fallback = None`` fails closed: the
    backend's exception reaches every caller of that batch.
    """

    def __init__(
        self,
        backend: BatchBackend,
        max_batch: int = 8192,
        max_delay_s: float = 0.002,
        fallback: Optional[SignatureVerifier] = None,
        max_inflight: int = 4,
    ):
        self.backend = backend
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_inflight = max(1, max_inflight)
        self._inflight: Optional[asyncio.Semaphore] = None
        self._chunk_tasks: set = set()
        self.fallback = fallback if fallback is not None else CpuVerifier()
        self._pending: List[Tuple[VerifyItem, asyncio.Future]] = []
        self._wakeup: Optional[asyncio.Event] = None
        self._flusher: Optional[asyncio.Task] = None
        self._closed = False
        # simple counters for observability (see mochi_tpu_torch.utils.metrics)
        self.batches_flushed = 0
        self.items_verified = 0
        # batches the backend failed and the CPU fallback answered
        self.fallback_batches = 0

    def _ensure_flusher(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._wakeup = asyncio.Event()
            self._inflight = asyncio.Semaphore(self.max_inflight)
            self._flusher = asyncio.get_running_loop().create_task(self._flush_loop())

    async def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        if self._closed:
            raise RuntimeError("verifier closed")
        if not items:
            return []
        self._ensure_flusher()
        loop = asyncio.get_running_loop()
        futures = [loop.create_future() for _ in items]
        self._pending.extend(zip(items, futures))
        assert self._wakeup is not None
        self._wakeup.set()
        return list(await asyncio.gather(*futures))

    async def _flush_loop(self) -> None:
        assert self._wakeup is not None
        while not self._closed:
            await self._wakeup.wait()
            self._wakeup.clear()
            if not self._pending:
                continue
            # Micro-batching window: let concurrent requests pile on.
            if len(self._pending) < self.max_batch and self.max_delay_s > 0:
                await asyncio.sleep(self.max_delay_s)
            while self._pending:
                # Acquire BEFORE popping: if close() cancels us at this
                # await, the items are still in _pending and get cancelled
                # by the close() sweep instead of hanging their callers.
                assert self._inflight is not None
                await self._inflight.acquire()
                if not self._pending:
                    self._inflight.release()
                    break
                chunk = self._pending[: self.max_batch]
                del self._pending[: len(chunk)]
                task = asyncio.get_running_loop().create_task(
                    self._run_chunk_guarded(chunk)
                )
                self._chunk_tasks.add(task)
                task.add_done_callback(self._chunk_tasks.discard)

    async def _run_chunk_guarded(
        self, chunk: List[Tuple[VerifyItem, asyncio.Future]]
    ) -> None:
        try:
            await self._run_chunk(chunk)
        finally:
            assert self._inflight is not None
            self._inflight.release()

    async def _run_chunk(self, chunk: List[Tuple[VerifyItem, asyncio.Future]]) -> None:
        items = [it for it, _ in chunk]
        loop = asyncio.get_running_loop()
        try:
            bitmap = await loop.run_in_executor(None, lambda: list(self.backend(items)))
            if len(bitmap) != len(items):
                raise ValueError("backend bitmap length mismatch")
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            if self.fallback is None:
                LOG.exception("batch backend failed; the batch's callers get the error")
                for _, fut in chunk:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            LOG.exception("batch backend failed; falling back to CPU verify")
            self.fallback_batches += 1
            bitmap = await self.fallback.verify_batch(items)
        self.batches_flushed += 1
        self.items_verified += len(items)
        for (_, fut), ok in zip(chunk, bitmap):
            if not fut.done():
                fut.set_result(bool(ok))

    async def close(self) -> None:
        self._closed = True
        if self._wakeup is not None:
            self._wakeup.set()
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except asyncio.CancelledError:
                pass  # the cancellation we just requested
            except Exception:
                pass
        # Let in-flight chunks finish so their futures resolve (their
        # backend work is already running in the executor either way).
        if self._chunk_tasks:
            await asyncio.gather(*list(self._chunk_tasks), return_exceptions=True)
        for _, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()


def verifier_stats(verifier) -> dict:
    """Type + counters for any verifier composition, recursively unwrapping
    ``.inner`` (CachingVerifier, BatchingVerifier-over-Remote, ...).  The
    single extractor behind BOTH operator surfaces — the replica admin
    /status and the verifier service's --admin-port — so key names cannot
    drift between them."""
    st: dict = {"type": type(verifier).__name__ if verifier else "CpuVerifier"}
    if verifier is None or isinstance(verifier, CpuVerifier):
        # Which host engine actually runs this node's inline verifies —
        # openssl / native-c / pure-python.  The same provenance string the
        # benchmark records stamp, so an operator can
        # tell a wheel-less node from a scrape instead of from latency.
        st["host_crypto_engine"] = crypto_keys.host_crypto_engine()
    for attr in (
        "batches_flushed",
        "items_verified",
        "remote_batches",
        "fallback_batches",
        "hits",
        "misses",
        "agg_hits",     # CachingVerifier: one-attestation certificate memo
        "agg_misses",
        "calls",        # CoalescingVerifier: caller-side verify_batch calls
        "inner_calls",  # ...vs inner round trips (calls/inner_calls = merge ratio)
    ):
        v = getattr(verifier, attr, None)
        if isinstance(v, int):
            st[attr] = v
    warm = getattr(verifier, "warmup_buckets", None)
    if warm is not None:
        # the lane counts each kernel was launched at before the first
        # request (CudaBatchVerifier(warmup_buckets=)), and the seconds the
        # build, the table upload and those launches took
        st["warmup"] = {"buckets": list(warm), "seconds": getattr(verifier, "warmup_s", None)}
    backend = getattr(verifier, "backend", None)
    registry = getattr(backend, "registry", None)
    if registry is not None:
        # comb fast-path observability (crypto/comb.py): is the registry
        # populated, and is the comb kernel actually carrying traffic.  The
        # reference's "ready_buckets" has no counterpart: a CUDA kernel
        # needs no per-shape compile.
        from ..crypto import batch_verify as _bv

        routed = _bv.comb_routing_counts()
        from ..crypto import comb as _comb

        from ..crypto import cuda_comb as _cuda_comb
        from ..crypto import cuda_verify as _cuda_verify

        # the multiply the general kernel runs (MOCHI_SKEW_IMPL)
        st["general"] = {"multiply": _cuda_verify.skew()}
        st["comb"] = {
            "registered_signers": len(registry),
            # the accumulation every comb launch runs (MOCHI_COMB_IMPL), and
            # its multiply: mxu for either under MOCHI_SKEW_IMPL=mxu, else pad
            "impl": _comb.COMB_IMPL,
            "multiply": _cuda_comb.multiply_of(_comb.COMB_IMPL),
            "device_dispatches_process_total": _bv.comb_dispatch_count(),
            # routing occupancy (process-global): items the router sent
            # down each kernel, and batches that carried both
            "items_comb_routed_process_total": routed["comb_items"],
            "items_ladder_routed_process_total": routed["ladder_items"],
            "mixed_batches_process_total": routed["mixed_batches"],
        }
    inner = getattr(verifier, "inner", None)
    if inner is not None:
        st["inner"] = verifier_stats(inner)
    return st
