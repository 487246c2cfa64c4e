"""Log-structured durable engine: WAL + snapshots + verified crash recovery.

Layout under one replica's directory (``<storage_root>/<server_id>/``)::

    wal-0000000001.log ...   CRC-framed segments (storage/wal.py)
    snapshot.bin             framed snapshot (crc + server/persistence doc)

Durability contract at the batched-write2 seam (``MOCHI_WAL_FSYNC``):

* ``always`` — an acknowledged write has been ``fsync``'d.  Concurrent
  batches coalesce onto shared fsyncs (classic group commit: at most two
  fsyncs cover any waiter), so the per-ack cost amortizes under load.
* ``group`` (default) — an acknowledged write has reached the OS page
  cache (``write()`` + flush), which survives SIGKILL of the process; a
  background group tick fsyncs every ``MOCHI_WAL_GROUP_MS``, bounding the
  machine-crash window to one tick.
* ``off`` — no fsync outside snapshot/close (bench/throwaway postures).

Recovery trusts NOTHING on disk beyond its own conservativeness rules:

* commits replay through the full Write2 validation — every certificate's
  grant signatures re-verify through the verifier's batch path (pooled
  across replay entries, one round trip per chunk, exactly the hot path's
  amortization), then quorum shape / hash agreement / staleness at the
  store.  A mutated value, forged grant, thinned quorum, or reordered
  record is CONVICTED (per-entry attribution in the replay report and on
  the admin surfaces) and skipped — never silently adopted;
* reclaim records and snapshot epoch marks only ever RAISE epochs (a
  tampered raise is a self-inflicted liveness nuisance; a lowered epoch —
  the dangerous direction, re-granting a promised-never slot — is ignored
  by construction via ``max``);
* a torn tail on the FINAL segment is the expected crash shape (clean
  stop at the last valid record); a torn NON-final segment cannot happen
  honestly (later segments only exist after a clean rotation) and is
  convicted as tampering.

All file IO runs in the default executor; the staging hooks called from
the store's batch loop turn are pure in-memory appends.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import logging
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..protocol import SyncEntry, Transaction, WriteCertificate, transaction_hash
from ..protocol.codec import encode as _codec_encode
from ..verifier.spi import VerifyItem
from . import wal
from .spi import StorageEngine

LOG = logging.getLogger(__name__)

SNAP_MAGIC = b"mochi-snap-crc1\n"
_SNAP_HEADER = struct.Struct("<I")  # crc32 of the doc blob

# How many replay commits share one verifier round trip.  Each entry
# contributes ~quorum VerifyItems, so 128 entries ≈ 384-512 signatures per
# batch — comfortably inside the batch engine's sweet spot.
REPLAY_CHUNK = 128
# Bounded per-entry attribution (the admin surface renders these).
CONVICTIONS_MAX = 64

FSYNC_POLICIES = ("always", "group", "off")

# Node-local MAC secret for reclaim records (see stage_reclaim).  Commits
# are self-certifying (the certificate re-verifies at replay); reclaims
# carry no signature — before this key existed they were adopted on CRC
# alone, which the wal.py docstring explicitly disclaims as tamper
# protection: a rewritten reclaim body could poison the reclaimed audit
# ledger with an arbitrary granted-hash.  The key lives next to the
# log it authenticates: this defends the log against OFFLINE tampering
# (edit-the-bytes attacks the CRC invites); an adversary who can also
# replace the key file — i.e. owns the node — is outside what any
# node-local secret can address.
RECLAIM_KEY_FILE = "reclaim.key"


def _load_or_create_reclaim_key(directory: str) -> Tuple[bytes, bool]:
    """Returns ``(key, created)``.  ``created`` means no key predated this
    boot — the one state in which legacy (pre-MAC, 4-field) reclaim
    records are still admissible at replay: they were necessarily written
    before the upgrade.  Once a key exists, every staged reclaim is
    MAC'd, so an unMAC'd record under an existing key is tampering."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, RECLAIM_KEY_FILE)
    try:
        with open(path, "rb") as fh:
            key = fh.read()
        if len(key) >= 16:
            return key, False
    except OSError:
        pass
    key = os.urandom(32)
    tmp = f"{path}.tmp{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        os.write(fd, key)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    return key, True


def _env_policy(value: Optional[str]) -> str:
    policy = (value or os.environ.get("MOCHI_WAL_FSYNC", "group")).lower()
    if policy not in FSYNC_POLICIES:
        raise ValueError(
            f"MOCHI_WAL_FSYNC must be one of {FSYNC_POLICIES}, got {policy!r}"
        )
    return policy


def _sync_unless_closed(writer: wal.SegmentWriter) -> None:
    """fsync ``writer``'s segment.  The engine syncs a segment before it
    closes it (a snapshot's rotation, ``close``), so a group fsync whose
    segment a rotation closed under it has nothing left to do: the
    reference package's engine raised here and its background tick logged
    the failure."""
    try:
        writer.sync()
    except ValueError:
        if not writer.closed:
            raise


def frame_snapshot(blob: bytes) -> bytes:
    return SNAP_MAGIC + _SNAP_HEADER.pack(zlib.crc32(blob)) + blob


def unframe_snapshot(data: bytes) -> bytes:
    """Raises ValueError on anything but an intact framed snapshot."""
    if not data.startswith(SNAP_MAGIC):
        raise ValueError("not a framed mochi snapshot")
    off = len(SNAP_MAGIC)
    if len(data) < off + _SNAP_HEADER.size:
        raise ValueError("truncated snapshot frame")
    (crc,) = _SNAP_HEADER.unpack_from(data, off)
    blob = data[off + _SNAP_HEADER.size:]
    if zlib.crc32(blob) != crc:
        raise ValueError("snapshot crc mismatch")
    return blob


class DurableStorage(StorageEngine):
    """One replica's durable engine (``MochiReplica(storage_dir=...)``)."""

    name = "durable"

    def __init__(
        self,
        directory: str,
        server_id: str,
        fsync: Optional[str] = None,
        metrics=None,
        group_ms: Optional[float] = None,
        snapshot_trigger_bytes: Optional[int] = None,
    ):
        self.directory = directory
        self.server_id = server_id
        self.fsync_policy = _env_policy(fsync)
        self.metrics = metrics
        self.group_ms = (
            group_ms
            if group_ms is not None
            else float(os.environ.get("MOCHI_WAL_GROUP_MS", "25"))
        )
        # WAL growth past this arms a snapshot on the next background tick
        # (bounded recovery replay without an operator timer).
        self.snapshot_trigger_bytes = (
            snapshot_trigger_bytes
            if snapshot_trigger_bytes is not None
            else int(os.environ.get("MOCHI_WAL_SNAPSHOT_BYTES", str(64 << 20)))
        )
        self.snapshot_path = os.path.join(directory, "snapshot.bin")
        self._reclaim_key, self._reclaim_key_created = (
            _load_or_create_reclaim_key(directory)
        )
        # staged-but-unwritten frames (encoded on the store's loop turn —
        # native mcode, cheap — so the executor write is pure IO)
        self._staged: List[bytes] = []
        self._seq = 0  # last staged/assigned sequence number
        self._written_seq = 0  # highest seq write()+flush()'d to the OS
        self._synced_seq = 0  # highest seq covered by an fsync
        self._append_lock: Optional[asyncio.Lock] = None
        self._snapshot_lock = asyncio.Lock()
        self._sync_inflight: Optional[asyncio.Task] = None
        self._writer: Optional[wal.SegmentWriter] = None
        self._bg_task: Optional[asyncio.Task] = None
        self._closed = False
        self._replaying = False
        # The store this engine persists — attached by the replica after
        # recovery so the background tick can self-trigger snapshots.
        self.store = None
        self._snapshot_due = False
        # counters / report state
        self.wal_entries = 0  # records appended this process lifetime
        self.wal_bytes = 0
        self.fsyncs = 0
        self.snapshots = 0
        self.snapshot_seq = 0  # watermark of the last snapshot written/loaded
        self._snapshot_time: Optional[float] = None
        self._snapshot_bytes = 0
        self._bytes_since_snapshot = 0
        # segment count cache: stats() serves admin scrapes from the loop,
        # so it must not os.listdir (no blocking file IO on the loop) —
        # maintained by _open_segment/snapshot, which already run in
        # executors where the listing is free
        self._wal_segments = 0
        self._replay: Dict[str, object] = {
            "entries": 0,
            "convicted": 0,
            "reclaims": 0,
            "skipped_unowned": 0,
            "torn_tail": False,
            "ms": 0.0,
        }
        self._convictions: List[Dict[str, object]] = []
        self._convicted_keys: set = set()

    # ------------------------------------------------------------- staging

    def stage_commit(self, keys, transaction, certificate) -> None:
        """One record per applied TRANSACTION (``keys`` = the keys it
        applied here): the store applies a whole transaction in one
        ``process_write2``, so replay must too — per-key records would make
        every multi-key transaction's second record look like a duplicate."""
        if self._replaying or self._closed:
            return
        self._seq += 1
        frame = wal.encode_record(
            self._seq, wal.RT_COMMIT,
            [list(keys), transaction.to_obj(), certificate.to_obj()],
        )
        self._staged.append(frame)
        self.wal_entries += 1
        self.wal_bytes += len(frame)

    def stage_reclaim(
        self, key: str, ts: int, granted_hash: bytes, new_epoch: int
    ) -> None:
        """Reclaims are the one record kind with no certificate to re-verify
        at replay, so each body carries a node-keyed MAC (bound to the
        record's sequence number — a relocated copy fails too); replay
        re-verifies it via :meth:`_reclaim_auth_ok` before the epoch bump
        and ledger write are adopted."""
        if self._replaying or self._closed:
            return
        self._seq += 1
        mac = self._reclaim_mac(self._seq, key, ts, granted_hash, new_epoch)
        frame = wal.encode_record(
            self._seq, wal.RT_RECLAIM, [key, ts, granted_hash, new_epoch, mac]
        )
        self._staged.append(frame)
        self.wal_entries += 1
        self.wal_bytes += len(frame)

    def _reclaim_mac(
        self, seq: int, key: str, ts: int, granted_hash: bytes, new_epoch: int
    ) -> bytes:
        msg = _codec_encode(
            [int(seq), str(key), int(ts), bytes(granted_hash), int(new_epoch)]
        )
        return hmac.new(self._reclaim_key, msg, hashlib.sha256).digest()

    def _reclaim_auth_ok(
        self, seq: int, key: str, ts: int, granted_hash: bytes,
        new_epoch: int, mac: bytes
    ) -> bool:
        """Everything a reclaim record contributes to the store is admitted
        only through this check."""
        want = self._reclaim_mac(seq, key, ts, granted_hash, new_epoch)
        return hmac.compare_digest(want, bytes(mac))

    @property
    def dirty(self) -> bool:
        if self._staged:
            return True
        if self.fsync_policy == "always":
            return self._synced_seq < self._seq
        return self._written_seq < self._seq

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        """Open a fresh segment (never append to a possibly-torn tail) and
        start the background group tick.  Idempotent."""
        if self._writer is not None:
            return
        self._append_lock = asyncio.Lock()
        loop = asyncio.get_running_loop()
        self._writer = await loop.run_in_executor(None, self._open_segment)
        if self._bg_task is None:
            self._bg_task = asyncio.ensure_future(self._bg_loop())

    def _open_segment(self) -> wal.SegmentWriter:
        os.makedirs(self.directory, exist_ok=True)
        index = wal.last_segment_index(self.directory) + 1
        writer = wal.SegmentWriter(
            os.path.join(self.directory, wal.segment_name(index)),
            self.server_id,
            index,
        )
        self._wal_segments = len(wal.list_segments(self.directory))
        return writer

    async def flush(self) -> None:
        """Append everything staged and wait to the policy's durability
        level.  This is what the replica awaits before acknowledging a
        batch of writes."""
        if self._writer is None:
            raise RuntimeError("DurableStorage.flush before start()")
        loop = asyncio.get_running_loop()
        # The append lock serializes drains: two concurrent flushes must
        # hit the file in staging order or replay would convict an honest
        # log for sequence reordering.
        async with self._append_lock:
            while self._staged:
                # snapshot-and-clear BEFORE the await: stage_* can run in
                # other loop turns while the executor writes
                frames = b"".join(self._staged)
                seq = self._seq
                self._staged.clear()
                await loop.run_in_executor(None, self._writer.append, frames)
                self._written_seq = max(self._written_seq, seq)
                self._bytes_since_snapshot += len(frames)
        if (
            self.snapshot_trigger_bytes > 0
            and self._bytes_since_snapshot >= self.snapshot_trigger_bytes
        ):
            self._snapshot_due = True
        if self.fsync_policy == "always":
            await self._ensure_synced(self._written_seq)

    async def _ensure_synced(self, target_seq: int) -> None:
        """Group commit: block until an fsync covers ``target_seq``.  All
        concurrent waiters share in-flight fsyncs — any waiter joins the
        current one and at most starts one more."""
        while self._synced_seq < target_seq:
            task = self._sync_inflight
            if task is None:
                task = asyncio.ensure_future(self._do_sync())
                self._sync_inflight = task
            await asyncio.shield(task)

    async def _do_sync(self) -> None:
        covered = self._written_seq  # records on the OS *before* this fsync
        t0 = time.perf_counter()
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, _sync_unless_closed, self._writer
            )
        finally:
            self._sync_inflight = None
        self.fsyncs += 1
        self._synced_seq = max(self._synced_seq, covered)
        if self.metrics is not None:
            self.metrics.histogram(
                "storage-fsync-ms", (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 100, 500)
            ).observe((time.perf_counter() - t0) * 1e3)

    async def _bg_loop(self) -> None:
        """Group tick: drains staged records the ack path never flushed
        (write1-side reclaims), advances the group fsync horizon, and runs
        armed snapshots."""
        while not self._closed:
            await asyncio.sleep(max(self.group_ms, 1.0) / 1e3)
            try:
                if self._staged:
                    await self.flush()
                if (
                    self.fsync_policy == "group"
                    and self._synced_seq < self._written_seq
                ):
                    await self._ensure_synced(self._written_seq)
                if self._snapshot_due and self.store is not None:
                    self._snapshot_due = False
                    await self.snapshot(self.store)
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("storage background tick failed")

    async def snapshot(self, store) -> int:
        """Flush, serialize on the loop (store quiescence = loop turn),
        write the framed snapshot atomically, rotate the WAL, and delete
        fully-covered segments.  Returns bytes written.

        Crash ordering: the snapshot (with its ``wal_seq`` watermark) is
        durable via tmp+rename+fsync BEFORE any segment is deleted, so a
        crash in any window leaves either (old snapshot + full log) or
        (new snapshot + superfluous-but-skippable log prefix) — the
        watermark makes replay of the overlap a no-op, pinned by the
        crash-between-snapshot-and-truncate regression test.

        One snapshot at a time (``_snapshot_lock``; the paged engine's
        compaction takes it too).  Two interleaved snapshots could land
        their files in the other order than they truncate the log: the
        older document (lower watermark) last on disk, and the segments
        between the two watermarks already deleted by the newer one.  The
        reference package's engine does not serialize them (ROADMAP.md
        Queue C).
        """
        async with self._snapshot_lock:
            return await self._snapshot(store)

    async def _snapshot(self, store) -> int:
        from ..server import persistence

        if self._writer is None:
            raise RuntimeError("DurableStorage.snapshot before start()")
        await self.flush()
        loop = asyncio.get_running_loop()
        async with self._append_lock:
            # Capture and rotate ATOMICALLY w.r.t. appends: a contending
            # flush queued on this lock may write records staged after our
            # flush() into the pre-rotation segment — if the blob/watermark
            # were captured before acquiring the lock (as they once were),
            # those records would be above the snapshot's coverage yet
            # inside a segment the truncation below deletes: an acked write
            # lost.  Under the lock, anything staged after this capture can
            # only ever reach the NEW segment, strictly above the watermark.
            blob = persistence.snapshot_bytes(
                store, extra={"wal_seq": self._seq}
            )
            framed = frame_snapshot(blob)
            watermark = self._seq
            old_writer = self._writer

            def _rotate() -> wal.SegmentWriter:
                old_writer.sync()
                old_writer.close()
                return self._open_segment()

            self._writer = await loop.run_in_executor(None, _rotate)
            keep_from = self._writer.index
        await loop.run_in_executor(
            None, persistence.write_snapshot_blob, framed, self.snapshot_path
        )

        def _truncate() -> int:
            wal.delete_segments_below(self.directory, keep_from)
            return len(wal.list_segments(self.directory))

        self._wal_segments = await loop.run_in_executor(None, _truncate)
        self.snapshots += 1
        self.snapshot_seq = watermark
        self._snapshot_time = time.monotonic()
        self._snapshot_bytes = len(framed)
        self._bytes_since_snapshot = 0
        if self.metrics is not None:
            self.metrics.mark("storage.snapshots")
        return len(framed)

    async def close(self, store=None) -> None:
        """Final flush (+ snapshot when the store is available) and file
        teardown.  Safe to call twice."""
        if self._closed:
            return
        if self._bg_task is not None:
            self._bg_task.cancel()
            try:
                await self._bg_task
            except asyncio.CancelledError:
                pass
            except Exception:
                pass
            self._bg_task = None
        try:
            if self._writer is not None:
                target = store if store is not None else self.store
                if target is not None:
                    await self.snapshot(target)
                else:
                    await self.flush()
                    await self._ensure_synced(self._written_seq)
        finally:
            self._closed = True
            writer, self._writer = self._writer, None
            if writer is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, writer.close
                )

    # ------------------------------------------------------------- recovery

    async def recover(self, store, verifier=None, metrics=None) -> Dict:
        """Rebuild ``store`` from snapshot + WAL with full re-verification.

        ``verifier`` is a ``SignatureVerifier`` (None -> a throwaway
        ``CpuVerifier``); every certificate's grants re-verify through its
        ``verify_batch``, pooled ``REPLAY_CHUNK`` entries per round trip.
        Convictions (signature, quorum, hash, reorder, torn-non-final)
        are attributed per entry and NEVER applied.  Call before
        :meth:`start`'s writer serves traffic; the replica attaches
        ``store.storage`` only after this returns, and the ``_replaying``
        guard keeps accidental re-staging out regardless.
        """
        t0 = time.perf_counter()
        metrics = metrics if metrics is not None else self.metrics
        owned_verifier = None
        if verifier is None:
            from ..verifier.spi import CpuVerifier

            verifier = owned_verifier = CpuVerifier()
        loop = asyncio.get_running_loop()
        self._replaying = True
        try:
            snap_doc, snap_err = await loop.run_in_executor(
                None, self._read_snapshot
            )
            if snap_err is not None:
                self._convict(None, None, None, f"snapshot unusable: {snap_err}")
            segments = await loop.run_in_executor(
                None, lambda: list(wal.iter_log(self.directory, self.server_id))
            )
            watermark = 0
            if snap_doc is not None:
                watermark = int(snap_doc.get("wal_seq", 0) or 0)
                await self._replay_snapshot(store, snap_doc, verifier)
            await self._replay_wal(store, segments, watermark, verifier)
            # the writer (started next) must continue above every sequence
            # number the log ever used, or fresh records would collide with
            # replayed ones at the next snapshot's watermark
            self.snapshot_seq = watermark
        finally:
            self._replaying = False
            if owned_verifier is not None:
                await owned_verifier.close()
        self._replay["ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        if metrics is not None:
            metrics.mark("storage.replay-entries", int(self._replay["entries"]))
            if self._replay["convicted"]:
                metrics.mark(
                    "storage.replay-convicted", int(self._replay["convicted"])
                )
        return self.replay_report()

    def _read_snapshot(self):
        try:
            with open(self.snapshot_path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return None, None
        from ..server import persistence

        try:
            blob = unframe_snapshot(data)
            return persistence.read_snapshot_doc(blob, self.server_id), None
        except ValueError as exc:
            return None, str(exc)

    def _convict(self, seq, key, txh, reason: str) -> None:
        self._replay["convicted"] = int(self._replay["convicted"]) + 1
        if key is not None:
            self._convicted_keys.add(key)
        if len(self._convictions) < CONVICTIONS_MAX:
            self._convictions.append(
                {
                    "seq": seq,
                    "key": key,
                    "txh": txh.hex()[:16] if txh else None,
                    "reason": reason,
                }
            )
        LOG.warning(
            "REPLAY CONVICTION seq=%s key=%r: %s — entry not adopted",
            seq, key, reason,
        )

    async def _replay_snapshot(self, store, doc, verifier) -> None:
        """Snapshot entries replay through the SAME verified path as WAL
        commits (the snapshot is self-certifying too): config keyspace
        first — twice, like resync, so the archive chain enables each next
        stamp — then data.  Conviction for snapshots is a post-pass ADOPTION
        AUDIT rather than per-apply verdicts: several snapshot entries can
        legitimately share one multi-key transaction (the first apply
        covers its siblings) and config entries legitimately no-op on the
        second pass, so "did not advance" is not evidence here — "the
        verified replay refused to adopt this entry's transaction" is.
        Finally the per-key epoch marks are adopted upward-only."""
        def entries_of(objs):
            out = []
            for obj in objs:
                key, _value, _exists, cert, txn, _epoch = obj
                if cert is None or txn is None:
                    continue
                try:
                    out.append(
                        SyncEntry(
                            key,
                            Transaction.from_obj(txn),
                            WriteCertificate.from_obj(cert),
                        )
                    )
                except Exception:
                    self._convict(None, key, None, "undecodable snapshot entry")
            return out

        config_entries = entries_of(doc.get("data_config", ()))
        data_entries = entries_of(doc.get("data", ()))
        for pass_no in range(2):
            await self._apply_verified(
                store,
                [(None, [e.key], e.transaction, e.certificate) for e in config_entries],
                verifier,
                convict_stale=False,
                attribute=pass_no == 1,
            )
        await self._apply_verified(
            store,
            [(None, [e.key], e.transaction, e.certificate) for e in data_entries],
            verifier,
            convict_stale=False,
        )
        for e in config_entries + data_entries:
            if not store.owns(e.key) or e.key in self._convicted_keys:
                continue
            txh = transaction_hash(e.transaction)
            sv = store._get(e.key)
            cur = (
                transaction_hash(sv.last_transaction)
                if sv is not None and sv.last_transaction is not None
                else None
            )
            if cur != txh:
                self._convict(
                    None, e.key, txh,
                    "snapshot entry rejected by verified replay",
                )
        # Epoch marks: upward-only (max), so a tampered snapshot can only
        # make this replica refuse more, never re-grant a consumed slot.
        for obj in list(doc.get("data", ())) + list(doc.get("data_config", ())):
            key, _value, _exists, _cert, _txn, epoch = obj
            if not isinstance(epoch, int) or epoch <= 0:
                continue
            sv = store._get_or_create(key)
            if epoch > sv.current_epoch:
                sv.current_epoch = epoch

    async def _replay_wal(self, store, segments, watermark, verifier) -> None:
        from ..cluster.config import CONFIG_KEY_PREFIX

        last_index = segments[-1][0] if segments else 0
        prev_seq = watermark
        batch: List = []  # (seq, keys, transaction, certificate)
        for index, scan in segments:
            if scan.torn:
                if index != last_index:
                    # honest crashes tear only the final segment: a torn
                    # middle segment means the log was rewritten
                    self._convict(
                        None, None, None,
                        f"torn non-final segment {index}: {scan.detail}",
                    )
                else:
                    self._replay["torn_tail"] = True
            for rec in scan.records:
                if rec.seq <= watermark:
                    continue  # covered by the snapshot (truncation raced a crash)
                if rec.seq <= prev_seq:
                    self._convict(
                        rec.seq, None, None,
                        f"sequence regression ({rec.seq} after {prev_seq}): "
                        "log reordered or duplicated",
                    )
                    continue
                prev_seq = rec.seq
                self._seq = max(self._seq, rec.seq)
                if rec.rtype == wal.RT_COMMIT:
                    try:
                        keys, txn_obj, cert_obj = rec.body
                        keys = [str(k) for k in keys]
                        item = (
                            rec.seq,
                            keys,
                            Transaction.from_obj(txn_obj),
                            WriteCertificate.from_obj(cert_obj),
                        )
                    except Exception:
                        self._convict(rec.seq, None, None, "undecodable commit body")
                        continue
                    if any(k.startswith(CONFIG_KEY_PREFIX) for k in keys):
                        # a config install changes signer keys and ownership
                        # for everything after it: drain, then apply alone
                        if batch:
                            await self._apply_verified(store, batch, verifier)
                            batch = []
                        await self._apply_verified(store, [item], verifier)
                        continue
                    batch.append(item)
                    if len(batch) >= REPLAY_CHUNK:
                        await self._apply_verified(store, batch, verifier)
                        batch = []
                elif rec.rtype == wal.RT_RECLAIM:
                    # ordering: reclaims interleave with commits; drain the
                    # pending commit chunk first so the epoch bump lands
                    # after the commits that preceded it in the log
                    if batch:
                        await self._apply_verified(store, batch, verifier)
                        batch = []
                    self._replay_reclaim(store, rec)
                else:
                    self._convict(rec.seq, None, None, f"unknown record type {rec.rtype}")
        if batch:
            await self._apply_verified(store, batch, verifier)
        self._seq = max(self._seq, prev_seq)
        self._written_seq = self._synced_seq = self._seq

    def _replay_reclaim(self, store, rec) -> None:
        try:
            if len(rec.body) == 5:
                key, ts, granted_hash, new_epoch, mac = rec.body
                mac = bytes(mac)
            else:
                key, ts, granted_hash, new_epoch = rec.body
                mac = None
            ts = int(ts)
            new_epoch = int(new_epoch)
            granted_hash = bytes(granted_hash)
        except Exception:
            self._convict(rec.seq, None, None, "undecodable reclaim body")
            return
        if mac is None:
            # Legacy pre-MAC record.  Acceptable only if no reclaim key
            # predated this boot (the log necessarily predates the upgrade);
            # once a key exists, every genuine record carries a MAC and a
            # bare body is tampering.
            if not self._reclaim_key_created:
                self._convict(rec.seq, key, None, "reclaim missing MAC")
                return
            self._replay["legacy_reclaims"] = (
                int(self._replay.get("legacy_reclaims", 0)) + 1
            )
        elif not self._reclaim_auth_ok(
            rec.seq, key, ts, granted_hash, new_epoch, mac
        ):
            self._convict(rec.seq, key, None, "reclaim MAC mismatch")
            return
        sv = store._get_or_create(key)
        if new_epoch > sv.current_epoch:
            sv.current_epoch = new_epoch  # upward-only, like snapshot marks
        from ..server.store import RECLAIM_LEDGER_MAX

        if len(store.reclaimed) >= RECLAIM_LEDGER_MAX:
            store.reclaimed.pop(next(iter(store.reclaimed)))
        store.reclaimed[(key, ts)] = granted_hash
        self._replay["reclaims"] = int(self._replay["reclaims"]) + 1
        self._replay["entries"] = int(self._replay["entries"]) + 1

    async def _apply_verified(
        self,
        store,
        batch,
        verifier,
        convict_stale: bool = True,
        attribute: bool = True,
    ) -> None:
        """One pooled verify round trip for a chunk of replay commits
        (``(seq, keys, transaction, certificate)`` tuples), then
        store-level validation per entry (quorum, hash, staleness) via the
        full Write2 path.  ``convict_stale=False`` for snapshot entries
        (adoption is audited post-pass instead); ``attribute=False`` for
        the snapshot's config warm-up pass, whose failures are expected
        (the archive chain may not be learnable yet) and re-judged on the
        second pass."""
        if not batch:
            return
        items: List[VerifyItem] = []
        preps = []
        for seq, keys, txn, cert in batch:
            cfg = store.cert_config(cert)
            server_ids = list(cert.grants.keys())
            idx: List[int] = []
            start = len(items)
            for i, sid in enumerate(server_ids):
                mg = cert.grants[sid]
                key = cfg.public_keys.get(sid)
                if key is None or mg.signature is None or mg.server_id != sid:
                    continue
                idx.append(i)
                items.append(VerifyItem(key, mg.signing_bytes(), mg.signature))
            preps.append((seq, keys, txn, cert, server_ids, idx, start))
        bitmap = await verifier.verify_batch(items) if items else []
        for seq, keys, txn, cert, server_ids, idx, start in preps:
            valid = [False] * len(server_ids)
            for j, i in enumerate(idx):
                valid[i] = bool(bitmap[start + j])
            kept = {
                sid: cert.grants[sid]
                for sid, ok in zip(server_ids, valid)
                if ok
            }
            txh = transaction_hash(txn)
            owned = [k for k in keys if store.owns(k)]
            if len(kept) != len(server_ids) and attribute:
                self._convict(
                    seq, keys[0] if keys else None, txh,
                    f"{len(server_ids) - len(kept)} grant signature(s) failed "
                    "re-verification",
                )
            if not kept:
                continue
            # surviving grants may still carry an honest quorum (a
            # certificate with one garbage grant appended is the CARRIER's
            # lie, not the quorum's) — let the store decide below
            if not owned:
                self._replay["skipped_unowned"] = (
                    int(self._replay["skipped_unowned"]) + 1
                )
                continue
            checked = SyncEntry(owned[0], txn, WriteCertificate(kept))
            try:
                advanced = store.apply_sync_entry(checked)
            except Exception as exc:
                if attribute:
                    self._convict(seq, owned[0], txh, f"replay apply raised: {exc!r}")
                continue
            if advanced:
                self._replay["entries"] = int(self._replay["entries"]) + 1
            elif convict_stale and attribute:
                # an honest log's commits are strictly fresh per key: the
                # watermark skips snapshot-covered records, and the store
                # never stages idempotent equal-ts re-applies (Write2
                # retries, resync re-pulls) — so a non-advancing entry is
                # stale/duplicated/quorum-rejected, i.e. tampered
                self._convict(
                    seq, owned[0], txh,
                    "replayed commit did not advance state "
                    "(stale, duplicated, or failed Write2 validation)",
                )

    # --------------------------------------------------------------- admin

    @property
    def convictions(self) -> List[Dict[str, object]]:
        return list(self._convictions)

    def replay_report(self) -> Dict[str, object]:
        report = dict(self._replay)
        report["convictions"] = list(self._convictions)
        return report

    def stats(self) -> Dict[str, object]:
        age = (
            round(time.monotonic() - self._snapshot_time, 1)
            if self._snapshot_time is not None
            else None
        )
        return {
            "engine": self.name,
            "dir": self.directory,
            "fsync": self.fsync_policy,
            "wal_seq": self._seq,
            "written_seq": self._written_seq,
            "synced_seq": self._synced_seq,
            "staged": len(self._staged),
            "wal_entries": self.wal_entries,
            "wal_bytes": self.wal_bytes,
            "wal_segments": self._wal_segments,
            "fsyncs": self.fsyncs,
            "snapshots": self.snapshots,
            "snapshot_seq": self.snapshot_seq,
            "snapshot_bytes": self._snapshot_bytes,
            "snapshot_age_s": age,
            "replay": {
                k: v for k, v in self._replay.items()
            },
        }
