"""Paged self-certifying value engine: the keyspace outgrows RAM.

The WAL engine (:mod:`.durable`) keeps every committed value resident and
re-serializes the WHOLE store at each snapshot — a million-key cluster is
a million-StoreValue RAM statement and a hundred-megabyte snapshot write.
This engine replaces the snapshot with immutable, sorted, self-certifying
value pages and lets :class:`~mochi_tpu_torch.server.store.DataStore` fault
values back in on demand through the storage SPI:

Layout under one replica's directory (``<storage_root>/<server_id>/``)::

    wal-0000000001.log ...   CRC-framed WAL segments (inherited verbatim)
    page-0000000001.pg ...   immutable sorted value pages (this module)
    pages.manifest           CRC-framed page list + WAL watermark

* **Pages** are flushed from the memtable — the resident dirty keys the
  WAL tail covers.  Each entry is the protocol's own self-certifying
  evidence, ``(key, transaction, certificate, epoch)``, individually
  CRC-framed, with a footer index ``(key, offset, len, crc, txh, epoch)``
  so recovery rebuilds the key index from footers alone — **no values are
  loaded at boot**.  The WAL tail above the manifest watermark replays
  through the inherited verified path exactly as the WAL engine's does.
* **Fault-in** (``DataStore._get`` miss) reads one entry, re-checks it
  per-entry (CRC, footer/transaction hash agreement, certificate quorum
  shape and hash agreement — :meth:`PagedStorage._page_entry_admissible`,
  and adopts it through
  ``store.apply_sync_entry`` — the same full-Write2 sink resync and WAL
  replay use.  Grant *signatures* are deliberately NOT re-checked per
  fault: following DSig (arXiv 2406.07215), signature verification rides
  off the critical path — the background **audit** sweep and every
  **compaction** rewrite re-verify them on the batch verifier, convicting
  per entry with the same attribution the WAL replay gives.  An offline
  value mutation (even with every CRC recomputed) flips the transaction
  hash out from under the quorum's signed grants, so it cannot survive
  the hash-agreement recheck at fault time, let alone the audit.
* **The page cache** bounds resident CLEAN values (``MOCHI_PAGE_CACHE_BYTES``):
  faulted-in and flushed-clean keys enter a second-chance CLOCK; eviction
  drops the StoreValue from the store dict (the page keeps the evidence).
  Dirty keys (WAL tail), keys holding grants, and keys whose epoch or
  transaction advanced past their page entry are pinned resident.
* **Compaction** is incremental: pages whose live ratio decays (entries
  superseded by newer flushes) merge into one new page; every rewritten
  entry's grant signatures re-verify through ``verify_batch`` first.
  This replaces the WAL engine's whole-store snapshot entirely.

Crash ordering mirrors the WAL engine's snapshot discipline: the new page
is durable (tmp+rename+fsync) before the manifest references it, the
manifest is durable before any WAL segment is deleted, and the manifest
watermark makes replay of the overlap a no-op.  Page files the manifest
never adopted are orphans, deleted at boot.

Deliberate trade: a page
fault is a synchronous pread of ONE entry on the event loop — the store's
read/validation paths are synchronous, so a fault cannot await.  The unit
of blocking is one entry (~KB), bounded by the op that needed it, not by
keyspace size; bulk paths (recovery, audit, compaction) do their IO in
executors, so the loop never blocks on them.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import time
import zlib
from collections import namedtuple
from typing import Dict, Iterator, List, Optional, Tuple

# The reference package imports analysis.wire_taint here and registers this
# module's page-read source and per-entry recheck at its end; the port has
# no analysis/ package yet, so both are left out, as in the port's replica.
from ..protocol import (
    Action,
    SyncEntry,
    Transaction,
    WriteCertificate,
    transaction_hash,
)
from ..protocol.codec import decode as _decode, encode as _encode
from ..verifier.spi import VerifyItem
from . import wal
from .durable import REPLAY_CHUNK, DurableStorage

LOG = logging.getLogger(__name__)

PAGE_MAGIC = b"mochi-page-1\n"
MANIFEST_MAGIC = b"mochi-pages-crc1\n"
MANIFEST_NAME = "pages.manifest"
_U32 = struct.Struct("<I")
_FOOTER_TAIL = struct.Struct("<II")  # footer blob length, footer crc32

# Reclaims can bump a key's epoch with no committed entry to carry it; the
# manifest persists those marks.  FIFO-bounded like the store's reclaim
# ledger (RECLAIM_LEDGER_MAX) — commit-carried epochs are unbounded-safe
# because they live in the page entries themselves.
EPOCH_MARKS_MAX = 4096

# page_id the entry lives in, byte offset/length of its CRC-framed blob,
# that blob's crc32, the committed transaction hash and epoch from the
# footer.  A plain tuple subclass: at 10^6 keys this index IS the
# per-key RAM cost of the engine.
PageEntry = namedtuple("PageEntry", "page_id off length crc txh epoch")


class PageError(ValueError):
    """An on-disk page (or one entry of it) failed its integrity frame."""


def page_name(page_id: int) -> str:
    return f"page-{page_id:010d}.pg"


def _is_page_name(name: str) -> bool:
    return name.startswith("page-") and name.endswith(".pg")


def _write_page(
    path: str, server_id: str, page_id: int, entries: List[Tuple]
) -> Tuple[List[List[object]], int]:
    """Write one immutable page (tmp+rename+fsync).  ``entries`` are
    ``(key, blob, crc, txh, epoch)`` tuples, already key-sorted.  Returns
    ``(footer_rows, total_bytes)``."""
    header = _encode([server_id, int(page_id)])
    buf = bytearray()
    buf += PAGE_MAGIC
    buf += _U32.pack(len(header))
    buf += _U32.pack(zlib.crc32(header))
    buf += header
    footer: List[List[object]] = []
    for key, blob, crc, txh, epoch in entries:
        off = len(buf) + 2 * _U32.size
        buf += _U32.pack(len(blob))
        buf += _U32.pack(crc)
        buf += blob
        footer.append([key, off, len(blob), crc, txh, int(epoch)])
    fblob = _encode(footer)
    buf += fblob
    buf += _FOOTER_TAIL.pack(len(fblob), zlib.crc32(fblob))
    tmp = f"{path}.tmp{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, bytes(buf))
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    return footer, len(buf)


def scan_page_footer(path: str, server_id: str) -> Tuple[int, List[List[object]], int]:
    """Rebuild one page's index rows WITHOUT reading values: header frame,
    then the footer at the tail.  Returns ``(page_id, rows, file_bytes)``;
    raises :class:`PageError` on any integrity failure."""
    with open(path, "rb") as fh:
        head = fh.read(len(PAGE_MAGIC) + 2 * _U32.size)
        if not head.startswith(PAGE_MAGIC):
            raise PageError("bad page magic")
        (hlen,) = _U32.unpack_from(head, len(PAGE_MAGIC))
        (hcrc,) = _U32.unpack_from(head, len(PAGE_MAGIC) + _U32.size)
        header = fh.read(hlen)
        if len(header) != hlen or zlib.crc32(header) != hcrc:
            raise PageError("page header crc mismatch")
        sid, page_id = _decode(header)
        if sid != server_id:
            raise PageError(f"page belongs to {sid!r}, not {server_id!r}")
        size = os.fstat(fh.fileno()).st_size
        if size < _FOOTER_TAIL.size:
            raise PageError("page truncated below footer tail")
        fh.seek(size - _FOOTER_TAIL.size)
        flen, fcrc = _FOOTER_TAIL.unpack(fh.read(_FOOTER_TAIL.size))
        if flen <= 0 or flen > size - _FOOTER_TAIL.size:
            raise PageError("page footer length out of range")
        fh.seek(size - _FOOTER_TAIL.size - flen)
        fblob = fh.read(flen)
    if zlib.crc32(fblob) != fcrc:
        raise PageError("page footer crc mismatch")
    rows = _decode(fblob)
    if not isinstance(rows, list):
        raise PageError("page footer is not a row list")
    return int(page_id), rows, size


def read_page_entry(path: str, off: int, length: int, crc: int) -> object:
    """One entry's decoded ``[key, txn_obj, cert_obj, epoch]``: untrusted
    (CRC is corruption detection, not authentication) until
    :meth:`PagedStorage._page_entry_admissible` admits it."""
    with open(path, "rb") as fh:
        fh.seek(off)
        blob = fh.read(length)
    if len(blob) != length or zlib.crc32(blob) != crc:
        raise PageError("page entry crc mismatch")
    return _decode(blob)


def _final_state(txn: Transaction, key: str) -> Tuple[Optional[bytes], bool, bool]:
    """``(value, exists, found)`` after the transaction's last WRITE/DELETE
    op for ``key`` (duplicate keys apply last-write-wins, as in
    ``DataStore._apply``)."""
    value: Optional[bytes] = None
    exists = False
    found = False
    for op in txn.operations:
        if op.key != key or op.action not in (Action.WRITE, Action.DELETE):
            continue
        found = True
        if op.action == Action.WRITE:
            value, exists = op.value, True
        else:
            value, exists = None, False
    return value, exists, found


class PagedStorage(DurableStorage):
    """Log-structured paged engine: inherited WAL staging/group-commit/
    verified tail replay, pages + fault-in + CLOCK cache + incremental
    compaction instead of whole-store snapshots."""

    name = "paged"
    pager = True

    def __init__(
        self,
        directory: str,
        server_id: str,
        fsync: Optional[str] = None,
        metrics=None,
        group_ms: Optional[float] = None,
        snapshot_trigger_bytes: Optional[int] = None,
        cache_bytes: Optional[int] = None,
        memtable_bytes: Optional[int] = None,
    ):
        super().__init__(
            directory,
            server_id,
            fsync=fsync,
            metrics=metrics,
            group_ms=group_ms,
            snapshot_trigger_bytes=snapshot_trigger_bytes,
        )
        self.manifest_path = os.path.join(directory, MANIFEST_NAME)
        self.cache_cap = (
            cache_bytes
            if cache_bytes is not None
            else int(os.environ.get("MOCHI_PAGE_CACHE_BYTES", str(64 << 20)))
        )
        # Memtable bound: staged-WAL growth past this arms a page flush on
        # the next background tick (the paged analog of the WAL engine's
        # snapshot trigger, at a much lower default — flushing is cheap
        # and keeps the dirty resident set small).
        self.memtable_cap = (
            memtable_bytes
            if memtable_bytes is not None
            else int(os.environ.get("MOCHI_MEMTABLE_BYTES", str(8 << 20)))
        )
        self.compact_debt_ratio = float(
            os.environ.get("MOCHI_PAGE_COMPACT_DEBT", "0.25")
        )
        self.audit_policy = os.environ.get("MOCHI_PAGE_AUDIT", "boot")
        if self.audit_policy not in ("boot", "off"):
            raise ValueError(
                f"MOCHI_PAGE_AUDIT must be 'boot' or 'off', got "
                f"{self.audit_policy!r}"
            )
        # key -> PageEntry: the page index, rebuilt from footers at boot.
        # Entries leave via conviction (_drop_index_entry) and compaction
        # re-point; the index is the engine's O(keys) RAM budget.
        self._index: Dict[str, PageEntry] = {}
        # page_id -> {"path", "entries", "live", "bytes"}; "live" decays as
        # newer flushes supersede entries — the compaction-debt signal.
        self._pages: Dict[int, Dict[str, object]] = {}
        self._next_page_id = 1
        # Memtable: keys committed/reclaimed since their last page flush.
        # Pinned resident (never evicted) until the next flush pages them.
        self._dirty_keys: set = set()
        self._memtable_bytes = 0
        # Reclaim-driven epochs with no committed entry to ride (see
        # EPOCH_MARKS_MAX) — persisted in the manifest, adopted upward-only.
        self._epoch_marks: Dict[str, int] = {}
        # Second-chance CLOCK over clean resident values: key -> ref bit
        # (dict order is the hand; eviction pops the head, re-appends on a
        # set ref).  _sizes mirrors the per-key byte estimate.
        self._clock: Dict[str, bool] = {}
        self._sizes: Dict[str, int] = {}
        self._resident_bytes = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.pages_convicted = 0
        self.compactions = 0
        self.compaction_rewritten = 0
        self.compaction_reverified = 0
        self.audits = 0
        self.audited_entries = 0
        self._faulting = False
        self._audit_due = False
        self._compact_due = False
        # The verifier recovery ran with (the replica's) — reused by the
        # audit/compaction sweeps; falls back to a throwaway CpuVerifier.
        self._verifier = None

    # ------------------------------------------------------------- staging

    def stage_commit(self, keys, transaction, certificate) -> None:
        before = self.wal_bytes
        super().stage_commit(keys, transaction, certificate)
        if self._replaying or self._closed:
            return
        self._memtable_bytes += self.wal_bytes - before
        for k in keys:
            self._dirty_keys.add(k)
            self._drop_cache_entry(k)  # dirty = pinned resident
        if self._memtable_bytes >= self.memtable_cap:
            self._snapshot_due = True

    def stage_reclaim(self, key, ts, granted_hash, new_epoch) -> None:
        super().stage_reclaim(key, ts, granted_hash, new_epoch)
        if self._replaying or self._closed:
            return
        self._mark_epoch(key, int(new_epoch))
        if key in self._index:
            # re-page with the bumped epoch at the next flush
            self._dirty_keys.add(key)
            self._drop_cache_entry(key)

    def _mark_epoch(self, key: str, epoch: int) -> None:
        if epoch <= self._epoch_marks.get(key, 0):
            return
        while len(self._epoch_marks) >= EPOCH_MARKS_MAX and key not in self._epoch_marks:
            self._epoch_marks.pop(next(iter(self._epoch_marks)))
        self._epoch_marks[key] = epoch

    # ------------------------------------------------------- fault-in path

    def fault_in(self, store, key: str):
        """Synchronous on-demand load of one evicted/never-resident key —
        the ``DataStore._get`` miss hook.  Per-entry recheck, then
        adoption through the full Write2 sink (``apply_sync_entry``);
        grant signatures re-verify at audit/compaction time (DSig
        posture), and any inadmissible entry is convicted with per-entry
        attribution and never served."""
        if self._faulting or self._closed:
            return None
        ent = self._index.get(key)
        mark = self._epoch_marks.get(key, 0)
        if ent is None:
            if mark <= 0:
                return None
            # epoch-only resurrection: a reclaim promised this slot away
            # with no commit to carry the epoch — refuse to forget it
            from ..server.store import StoreValue

            sv = store.data.get(key)
            if sv is None:
                sv = StoreValue(key)
                store.data[key] = sv
            if mark > sv.current_epoch:
                sv.current_epoch = mark
            return sv
        self._faulting = True
        prev_replaying = self._replaying
        try:
            page = self._pages.get(ent.page_id)
            if page is None:
                self._drop_index_entry(key, ent, "page missing for entry")
                return None
            try:
                obj = read_page_entry(
                    str(page["path"]), ent.off, ent.length, ent.crc
                )
            except (OSError, PageError, ValueError) as exc:
                self._drop_index_entry(key, ent, f"page fault failed: {exc}")
                return None
            txn, cert, epoch, why = self._decode_page_entry(key, obj)
            if txn is None:
                self._drop_index_entry(key, ent, why)
                return None
            if not self._page_entry_admissible(store, key, txn, cert, ent):
                self._drop_index_entry(
                    key, ent, "page entry rejected by per-entry recheck"
                )
                return None
            # stage guard: adopting an already-durable entry must not write
            # a fresh WAL record (fault_in never awaits, so the flag cannot
            # leak into a concurrent turn)
            self._replaying = True
            advanced = store.apply_sync_entry(SyncEntry(key, txn, cert))
            self._replaying = prev_replaying
            sv = store.data.get(key)
            if not advanced or sv is None or sv.last_transaction is None:
                if sv is not None and sv.last_transaction is None:
                    del store.data[key]  # drop the empty shell _apply left
                self._drop_index_entry(
                    key, ent, "page entry rejected by verified re-apply"
                )
                return None
            floor = max(int(epoch), ent.epoch, mark)
            if floor > sv.current_epoch:
                sv.current_epoch = floor
            self.cache_misses += 1
            self._note_resident(key, sv)
            self._evict_to_cap(store)
            return sv
        finally:
            self._replaying = prev_replaying
            self._faulting = False

    def _decode_page_entry(self, key: str, obj) -> Tuple:
        """``(txn, cert, epoch, why)`` — typed decode of one page entry;
        ``txn is None`` means undecodable (``why`` says how)."""
        try:
            ekey, txn_obj, cert_obj, epoch = obj
            if ekey != key:
                return None, None, 0, f"page entry key {ekey!r} != index {key!r}"
            txn = Transaction.from_obj(txn_obj)
            cert = WriteCertificate.from_obj(cert_obj)
            epoch = int(epoch)
        except Exception as exc:
            return None, None, 0, f"undecodable page entry: {exc!r}"
        return txn, cert, epoch, ""

    def _page_entry_admissible(self, store, key, txn, cert, ent) -> bool:
        """The per-entry recheck: footer/transaction hash agreement, the
        key actually committed by this transaction, and the certificate's
        quorum shape + grant hash agreement under ITS configuration —
        everything the Write2 validation checks except grant signatures,
        which the audit/compaction sweeps re-verify in batch (an offline
        tamper cannot satisfy hash agreement without breaking them)."""
        txh = transaction_hash(txn)
        if bytes(ent.txh) != txh:
            return False
        _value, _exists, found = _final_state(txn, key)
        if not found:
            return False
        try:
            coalesced, cert_cfg = store._coalesce_grants(cert, txn)
        except Exception:
            return False
        slot = coalesced.get(key)
        if slot is None:
            return False
        _ts, grant_list = slot
        if len(grant_list) < cert_cfg.quorum:
            return False
        if any(g.transaction_hash != txh for g in grant_list):
            return False
        return True

    def note_access(self, key: str) -> None:
        """Resident hit on a cache-managed key: set the CLOCK ref bit."""
        if self._clock.get(key) is False:
            self._clock[key] = True
        if key in self._clock:
            self.cache_hits += 1

    # ---------------------------------------------------------- page cache

    def _note_resident(self, key: str, sv) -> None:
        size = len(sv.value or b"") + len(key) + 96  # StoreValue overhead
        self._resident_bytes += size - self._sizes.get(key, 0)
        self._sizes[key] = size
        self._clock[key] = True

    def _drop_cache_entry(self, key: str) -> None:
        if self._clock.pop(key, None) is not None:
            self._resident_bytes -= self._sizes.pop(key, 0)

    def _evictable(self, key: str, sv) -> bool:
        if key in self._dirty_keys or sv.grants:
            return False
        ent = self._index.get(key)
        if ent is None or sv.last_transaction is None:
            return False
        if sv.current_epoch > max(ent.epoch, self._epoch_marks.get(key, 0)):
            return False
        # a mid-transaction apply precedes its stage_commit: the hash
        # check catches state the dirty set hasn't heard about yet
        if transaction_hash(sv.last_transaction) != bytes(ent.txh):
            return False
        return True

    def _evict_to_cap(self, store) -> None:
        """Second-chance CLOCK down to ``cache_cap``: pop the hand, give
        referenced keys one more revolution, drop clean unreferenced
        StoreValues from the store dict (the page keeps the evidence)."""
        guard = 2 * len(self._clock) + 1
        while self._resident_bytes > self.cache_cap and self._clock and guard:
            guard -= 1
            key = next(iter(self._clock))
            ref = self._clock.pop(key)
            sv = store.data.get(key)
            if sv is None:
                self._resident_bytes -= self._sizes.pop(key, 0)
                continue
            if ref:
                self._clock[key] = False
                continue
            if not self._evictable(key, sv):
                self._clock[key] = False
                continue
            del store.data[key]
            self._resident_bytes -= self._sizes.pop(key, 0)
            self.cache_evictions += 1

    # --------------------------------------------- store export extensions

    def paged_keys(self) -> Iterator[str]:
        """Every key with a page entry (resident or not) — the store's
        export/resync walks union these with its resident dicts."""
        return iter(self._index)

    def iter_evicted_digests(
        self, resident_data, resident_config
    ) -> Iterator[Tuple[str, bytes]]:
        """``(key, txh)`` for index keys with no resident StoreValue:
        anti-entropy digests must cover evicted keys too.  The footer txh
        is CRC-gated only — a tampered footer can at worst force a digest
        mismatch, i.e. a resync repair, never an adoption."""
        for key, ent in self._index.items():
            if key in resident_data or key in resident_config:
                continue
            yield key, bytes(ent.txh)

    # -------------------------------------------------- flush (page write)

    async def _snapshot(self, store) -> int:
        """The paged engine's "snapshot" is a memtable flush: drain the
        WAL, write one immutable page of the dirty keys, manifest it,
        rotate + truncate the WAL.  Same crash discipline as the WAL
        engine's snapshot (page durable before manifest, manifest durable
        before truncation, watermark no-ops the overlap), and run under
        the same ``_snapshot_lock``: a flush that overlapped another could
        write a manifest without the other's page (which boot then deletes
        as an orphan) after truncating the log that page covers, and a
        caller's flush could return before the keys it found dirty were
        in a page."""
        if self._writer is None:
            raise RuntimeError("PagedStorage.snapshot before start()")
        await self.flush()
        loop = asyncio.get_running_loop()
        async with self._append_lock:
            entries = self._capture_dirty(store)
            watermark = self._seq
            old_writer = self._writer

            def _rotate() -> wal.SegmentWriter:
                old_writer.sync()
                old_writer.close()
                return self._open_segment()

            self._writer = await loop.run_in_executor(None, _rotate)
            keep_from = self._writer.index
        page_id = None
        page_path = ""
        footer: List[List[object]] = []
        page_bytes = 0
        if entries:
            page_id = self._next_page_id
            self._next_page_id += 1
            page_path = os.path.join(self.directory, page_name(page_id))
            footer, page_bytes = await loop.run_in_executor(
                None, _write_page, page_path, self.server_id, page_id, entries
            )
        page_ids = sorted(self._pages) + ([page_id] if page_id else [])
        await loop.run_in_executor(
            None, self._write_manifest, watermark, page_ids
        )

        def _truncate() -> int:
            wal.delete_segments_below(self.directory, keep_from)
            return len(wal.list_segments(self.directory))

        self._wal_segments = await loop.run_in_executor(None, _truncate)
        if page_id is not None:
            self._adopt_page(page_id, page_path, footer, page_bytes)
        self.snapshots += 1
        self.snapshot_seq = watermark
        self._snapshot_time = time.monotonic()
        self._snapshot_bytes = page_bytes
        self._bytes_since_snapshot = 0
        self._memtable_bytes = 0
        self._evict_to_cap(store)
        if self._debt_ratio() >= self.compact_debt_ratio and len(self._pages) > 1:
            self._compact_due = True
        if self.metrics is not None:
            self.metrics.mark("storage.snapshots")
        return page_bytes

    def _capture_dirty(self, store) -> List[Tuple]:
        """Encode the memtable on the loop turn, under the append lock
        (same quiescence argument as the WAL snapshot's blob capture):
        anything staged after this capture reaches only the NEW segment,
        strictly above the watermark."""
        entries: List[Tuple] = []
        flushed: List[str] = []
        for key in sorted(self._dirty_keys):
            sv = store._map_for(key).get(key)
            if (
                sv is None
                or sv.last_transaction is None
                or sv.current_certificate is None
            ):
                # granted-but-uncommitted (or convicted): nothing to page;
                # reclaim epochs ride the manifest's marks
                flushed.append(key)
                continue
            blob = _encode(
                [
                    key,
                    sv.last_transaction.to_obj(),
                    sv.current_certificate.to_obj(),
                    int(sv.current_epoch),
                ]
            )
            entries.append(
                (
                    key,
                    blob,
                    zlib.crc32(blob),
                    transaction_hash(sv.last_transaction),
                    int(sv.current_epoch),
                )
            )
            flushed.append(key)
        self._dirty_keys.difference_update(flushed)
        return entries

    def _adopt_page(
        self, page_id: int, path: str, footer: List[List[object]], size: int
    ) -> None:
        self._pages[page_id] = {
            "path": path,
            "entries": len(footer),
            "live": 0,
            "bytes": size,
        }
        for key, off, length, crc, txh, epoch in footer:
            old = self._index.get(key)
            if old is not None:
                page = self._pages.get(old.page_id)
                if page is not None and old.page_id != page_id:
                    page["live"] = max(0, int(page["live"]) - 1)
            self._index[key] = PageEntry(
                page_id, int(off), int(length), int(crc), bytes(txh), int(epoch)
            )
        self._recount_live(page_id)
        # flushed keys are clean now: enter cache accounting (resident
        # until the CLOCK says otherwise)
        for key, _off, _length, _crc, _txh, _epoch in footer:
            sv = self._owning_map_value(key)
            if sv is not None and key not in self._clock and not key.startswith(
                self._config_prefix()
            ):
                self._note_resident(key, sv)

    def _owning_map_value(self, key: str):
        store = self.store
        if store is None:
            return None
        return store._map_for(key).get(key)

    @staticmethod
    def _config_prefix() -> str:
        from ..cluster.config import CONFIG_KEY_PREFIX

        return CONFIG_KEY_PREFIX

    def _recount_live(self, page_id: int) -> None:
        page = self._pages.get(page_id)
        if page is None:
            return
        page["live"] = sum(
            1 for ent in self._index.values() if ent.page_id == page_id
        )

    def _debt_ratio(self) -> float:
        total = sum(int(p["entries"]) for p in self._pages.values())
        if not total:
            return 0.0
        live = sum(int(p["live"]) for p in self._pages.values())
        return (total - live) / total

    def _write_manifest(self, watermark: int, page_ids: List[int]) -> None:
        from ..server import persistence

        doc = {
            "version": 1,
            "server_id": self.server_id,
            "wal_seq": int(watermark),
            "pages": [int(p) for p in page_ids],
            "next_page_id": int(self._next_page_id),
            "epoch_marks": {k: int(v) for k, v in self._epoch_marks.items()},
        }
        blob = _encode(doc)
        framed = MANIFEST_MAGIC + _U32.pack(zlib.crc32(blob)) + blob
        persistence.write_snapshot_blob(framed, self.manifest_path)

    def _read_manifest(self):
        try:
            with open(self.manifest_path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return None, None
        if not data.startswith(MANIFEST_MAGIC):
            return None, "bad manifest magic"
        off = len(MANIFEST_MAGIC)
        if len(data) < off + _U32.size:
            return None, "truncated manifest frame"
        (crc,) = _U32.unpack_from(data, off)
        blob = data[off + _U32.size:]
        if zlib.crc32(blob) != crc:
            return None, "manifest crc mismatch"
        try:
            doc = _decode(blob)
        except Exception as exc:
            return None, f"undecodable manifest: {exc!r}"
        if not isinstance(doc, dict):
            return None, "manifest is not a document"
        if doc.get("server_id") != self.server_id:
            return None, (
                f"manifest belongs to {doc.get('server_id')!r}, "
                f"not {self.server_id!r}"
            )
        return doc, None

    # ------------------------------------------------------------- recovery

    async def recover(self, store, verifier=None, metrics=None) -> Dict:
        """Manifest -> page-footer index (values NOT loaded) -> eagerly
        verified config entries -> inherited WAL-tail replay.  The page
        audit (full signature re-verification) is armed for the first
        background tick — off the boot critical path, as DSig argues."""
        t0 = time.perf_counter()
        metrics = metrics if metrics is not None else self.metrics
        owned_verifier = None
        if verifier is None:
            from ..verifier.spi import CpuVerifier

            verifier = owned_verifier = CpuVerifier()
        else:
            self._verifier = verifier
        loop = asyncio.get_running_loop()
        self._replaying = True
        try:
            man, man_err = await loop.run_in_executor(None, self._read_manifest)
            if man_err is not None:
                self._convict(None, None, None, f"manifest unusable: {man_err}")
            watermark = 0
            if man is not None:
                watermark = int(man.get("wal_seq", 0) or 0)
                self._next_page_id = max(
                    self._next_page_id, int(man.get("next_page_id", 1) or 1)
                )
                for k, e in dict(man.get("epoch_marks") or {}).items():
                    try:
                        self._mark_epoch(str(k), int(e))
                    except (TypeError, ValueError):
                        continue
                page_ids = [int(p) for p in (man.get("pages") or ())]
            else:
                page_ids = []
            bad_pages = await loop.run_in_executor(
                None, self._load_page_index, page_ids
            )
            for page_id, err in bad_pages:
                self._convict(None, None, None, f"page {page_id} unusable: {err}")
            await self._load_config_entries(store, verifier)
            segments = await loop.run_in_executor(
                None, lambda: list(wal.iter_log(self.directory, self.server_id))
            )
            await self._replay_wal(store, segments, watermark, verifier)
            self.snapshot_seq = watermark
            # the WAL tail's residue is the reborn memtable: anything
            # resident that the pages don't already cover stays dirty
            for space in (store.data, store.data_config):
                for key, sv in space.items():
                    if sv.last_transaction is None:
                        continue
                    ent = self._index.get(key)
                    if ent is None or bytes(ent.txh) != transaction_hash(
                        sv.last_transaction
                    ):
                        self._dirty_keys.add(key)
            if self.audit_policy == "boot" and self._index:
                self._audit_due = True
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

    def _load_page_index(self, page_ids: List[int]) -> List[Tuple[int, str]]:
        """Executor half of recovery: scan manifest-listed page footers
        oldest-first (newer pages shadow older entries), delete orphan
        page files the manifest never adopted.  Returns unusable pages as
        ``(page_id, error)`` for loop-side conviction."""
        bad: List[Tuple[int, str]] = []
        listed = set(page_ids)
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for name in names:
            if _is_page_name(name) or ".pg.tmp" in name:
                try:
                    stem = name.split("-", 1)[1].split(".", 1)[0]
                    if _is_page_name(name) and int(stem) in listed:
                        continue
                except (IndexError, ValueError):
                    pass
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass
        for page_id in sorted(page_ids):
            path = os.path.join(self.directory, page_name(page_id))
            try:
                got_id, rows, size = scan_page_footer(path, self.server_id)
                if got_id != page_id:
                    raise PageError(f"header id {got_id} != manifest id {page_id}")
            except (OSError, PageError, ValueError) as exc:
                bad.append((page_id, str(exc)))
                continue
            self._pages[page_id] = {
                "path": path,
                "entries": len(rows),
                "live": 0,
                "bytes": size,
            }
            for row in rows:
                try:
                    key, off, length, crc, txh, epoch = row
                    self._index[str(key)] = PageEntry(
                        page_id, int(off), int(length), int(crc),
                        bytes(txh), int(epoch),
                    )
                except (TypeError, ValueError):
                    bad.append((page_id, "malformed footer row"))
                    break
        for page_id in list(self._pages):
            self._recount_live(page_id)
        return bad

    async def _load_config_entries(self, store, verifier) -> None:
        """Config keys cannot fault lazily — the replica needs membership,
        signer keys and the archive chain at boot — so they load eagerly
        through the same double-pass verified path the WAL engine gives
        snapshot config entries (signatures included: the set is small)."""
        loop = asyncio.get_running_loop()
        prefix = self._config_prefix()
        wanted = [
            (key, ent)
            for key, ent in self._index.items()
            if key.startswith(prefix)
        ]
        if not wanted:
            return

        def _read_all():
            out = []
            for key, ent in wanted:
                page = self._pages.get(ent.page_id)
                if page is None:
                    out.append((key, ent, None, "page missing for entry"))
                    continue
                try:
                    obj = read_page_entry(
                        str(page["path"]), ent.off, ent.length, ent.crc
                    )
                    out.append((key, ent, obj, None))
                except (OSError, PageError, ValueError) as exc:
                    out.append((key, ent, None, f"page fault failed: {exc}"))
            return out

        batch = []
        epochs: List[Tuple[str, int]] = []
        for key, ent, obj, err in await loop.run_in_executor(None, _read_all):
            if err is not None:
                self._drop_index_entry(key, ent, err)
                continue
            txn, cert, epoch, why = self._decode_page_entry(key, obj)
            if txn is None:
                self._drop_index_entry(key, ent, why)
                continue
            if not self._page_entry_admissible(store, key, txn, cert, ent):
                self._drop_index_entry(
                    key, ent, "page entry rejected by per-entry recheck"
                )
                continue
            batch.append((None, [key], txn, cert))
            epochs.append((key, max(int(epoch), ent.epoch)))
        for pass_no in range(2):
            await self._apply_verified(
                store, batch, verifier,
                convict_stale=False, attribute=pass_no == 1,
            )
        # adoption audit, as for snapshot config entries: an entry the
        # verified double-pass refused to adopt leaves the index
        for _seq, keys, txn, _cert in batch:
            key = keys[0]
            ent = self._index.get(key)
            if ent is None:
                continue
            sv = store._map_for(key).get(key)
            cur = (
                transaction_hash(sv.last_transaction)
                if sv is not None and sv.last_transaction is not None
                else None
            )
            if cur != transaction_hash(txn):
                self._drop_index_entry(
                    key, ent, "page config entry rejected by verified replay"
                )
        for key, epoch in epochs:
            if epoch <= 0:
                continue
            if key in self._convicted_keys:
                continue
            sv = store._get_or_create(key)
            if epoch > sv.current_epoch:
                sv.current_epoch = epoch

    # ----------------------------------------------------- audit/compaction

    def _drop_index_entry(self, key: str, ent: PageEntry, reason: str) -> None:
        """Per-entry conviction: attributed on the replay report/admin
        surfaces exactly like a WAL replay conviction, and the entry
        leaves the index — a convicted entry is never served again (the
        honest value comes back from the quorum via resync)."""
        self._convict(None, key, bytes(ent.txh), reason)
        self.pages_convicted += 1
        if self._index.get(key) == ent:
            self._index.pop(key, None)
            page = self._pages.get(ent.page_id)
            if page is not None:
                page["live"] = max(0, int(page["live"]) - 1)
        if self.metrics is not None:
            self.metrics.mark("storage.page-convictions")

    def _by_page(self) -> Dict[int, List[Tuple[str, PageEntry]]]:
        grouped: Dict[int, List[Tuple[str, PageEntry]]] = {}
        for key, ent in self._index.items():
            grouped.setdefault(ent.page_id, []).append((key, ent))
        return grouped

    def _get_sweep_verifier(self):
        if self._verifier is not None:
            return self._verifier, None
        from ..verifier.spi import CpuVerifier

        owned = CpuVerifier()
        return owned, owned

    async def _verify_entries(
        self, store, items: List[Tuple[str, PageEntry]], verifier,
    ) -> List[Tuple[str, PageEntry, Transaction, WriteCertificate, int]]:
        """Read + recheck + batch-verify grant signatures for a chunk of
        live entries.  Inadmissible entries are convicted; a failed grant
        signature is attributed per entry, and the entry is convicted out
        of the index when the surviving quorum breaks (a certificate with
        one garbage grant appended is the carrier's lie, not the
        quorum's).  Returns the entries that remain serviceable."""
        loop = asyncio.get_running_loop()

        def _read_chunk():
            out = []
            for key, ent in items:
                page = self._pages.get(ent.page_id)
                if page is None:
                    out.append((key, ent, None, "page missing for entry"))
                    continue
                try:
                    obj = read_page_entry(
                        str(page["path"]), ent.off, ent.length, ent.crc
                    )
                    out.append((key, ent, obj, None))
                except (OSError, PageError, ValueError) as exc:
                    out.append((key, ent, None, f"page read failed: {exc}"))
            return out

        decoded = []
        for key, ent, obj, err in await loop.run_in_executor(None, _read_chunk):
            if err is not None:
                self._drop_index_entry(key, ent, err)
                continue
            txn, cert, epoch, why = self._decode_page_entry(key, obj)
            if txn is None:
                self._drop_index_entry(key, ent, why)
                continue
            if not self._page_entry_admissible(store, key, txn, cert, ent):
                self._drop_index_entry(
                    key, ent, "page entry rejected by per-entry recheck"
                )
                continue
            decoded.append((key, ent, txn, cert, int(epoch)))
        vitems: List[VerifyItem] = []
        spans = []
        for key, ent, txn, cert, epoch in decoded:
            cfg = store.cert_config(cert)
            start = len(vitems)
            checked = 0
            for sid, mg in cert.grants.items():
                pub = cfg.public_keys.get(sid)
                if pub is None or mg.signature is None or mg.server_id != sid:
                    continue
                vitems.append(VerifyItem(pub, mg.signing_bytes(), mg.signature))
                checked += 1
            spans.append((start, checked, cfg.quorum))
        bitmap = await verifier.verify_batch(vitems) if vitems else []
        survivors = []
        for (key, ent, txn, cert, epoch), (start, checked, quorum) in zip(
            decoded, spans
        ):
            ok = sum(1 for j in range(checked) if bitmap[start + j])
            self.compaction_reverified += checked
            if ok < checked:
                self._convict(
                    None, key, bytes(ent.txh),
                    f"{checked - ok} grant signature(s) failed page "
                    "re-verification",
                )
            if ok < quorum:
                # the quorum itself is broken, not just the carrier: the
                # entry leaves the index — rejected, never served again
                self._drop_index_entry(
                    key, ent,
                    "page entry rejected: quorum broken after signature "
                    "re-verification",
                )
                continue
            survivors.append((key, ent, txn, cert, epoch))
        return survivors

    async def audit(self, store=None, verifier=None) -> Dict[str, int]:
        """Full-page certificate re-verification sweep — the DSig
        "verification off the critical path" half of the fault-time
        recheck.  Streams footer order, chunked ``REPLAY_CHUNK`` entries
        per verifier round trip, values discarded after the check (the
        sweep never grows the resident set).  Runs on the first
        background tick after boot; callable directly by tests/benches."""
        store = store if store is not None else self.store
        if store is None or self._closed:
            return {"entries": 0, "convicted": 0}
        sweep_verifier, owned = (
            (verifier, None) if verifier is not None else self._get_sweep_verifier()
        )
        before = self.pages_convicted
        audited = 0
        try:
            for page_id, items in sorted(self._by_page().items()):
                for i in range(0, len(items), REPLAY_CHUNK):
                    chunk = items[i:i + REPLAY_CHUNK]
                    # skip entries convicted/re-pointed since grouping
                    chunk = [
                        (k, e) for k, e in chunk if self._index.get(k) == e
                    ]
                    if not chunk:
                        continue
                    audited += len(chunk)
                    await self._verify_entries(store, chunk, sweep_verifier)
        finally:
            if owned is not None:
                await owned.close()
        self.audits += 1
        self.audited_entries += audited
        if self.metrics is not None:
            self.metrics.mark("storage.page-audits")
        return {
            "entries": audited,
            "convicted": self.pages_convicted - before,
        }

    async def compact(self, max_pages: int = 8, verifier=None) -> Dict[str, int]:
        """Incremental compaction: merge the worst-debt pages' LIVE
        entries into one new page (grant signatures re-verified on the
        batch verifier as each entry is rewritten), manifest the new page
        set, delete the victims.  Superseded/dead versions are dropped by
        construction — they were never in the index.

        Compactions and page flushes run one at a time (``_snapshot_lock``):
        the background tick's armed compaction and an explicit call used to
        interleave over the same victims, and the second to finish wrote a
        duplicate page whose every entry was already dead (the reference
        package's unsteady paged compaction test; ROADMAP.md Queue C); a
        flush beside a compaction could write a manifest naming the
        compaction's victims.  A call that finds one running waits for it,
        then scores the pages anew."""
        async with self._snapshot_lock:
            return await self._compact(max_pages, verifier)

    async def _compact(self, max_pages: int, verifier) -> Dict[str, int]:
        store = self.store
        if store is None or self._writer is None or len(self._pages) < 2:
            return {"pages": 0, "rewritten": 0}
        by_page = self._by_page()
        scored = []
        for page_id, meta in self._pages.items():
            entries = int(meta["entries"]) or 1
            live = len(by_page.get(page_id, ()))
            scored.append((live / entries, int(meta["bytes"]), page_id))
        scored.sort()
        victims = [pid for _ratio, _bytes, pid in scored[:max_pages]]
        if len(victims) < 2:
            return {"pages": 0, "rewritten": 0}
        sweep_verifier, owned = (
            (verifier, None) if verifier is not None else self._get_sweep_verifier()
        )
        survivors: List[Tuple[str, PageEntry, Transaction, WriteCertificate, int]] = []
        try:
            work = [
                (key, ent)
                for pid in victims
                for key, ent in by_page.get(pid, ())
            ]
            for i in range(0, len(work), REPLAY_CHUNK):
                chunk = [
                    (k, e)
                    for k, e in work[i:i + REPLAY_CHUNK]
                    if self._index.get(k) == e  # still live, not re-flushed
                ]
                if chunk:
                    survivors.extend(
                        await self._verify_entries(store, chunk, sweep_verifier)
                    )
        finally:
            if owned is not None:
                await owned.close()
        loop = asyncio.get_running_loop()
        page_id = self._next_page_id
        self._next_page_id += 1
        entries = []
        for key, ent, txn, cert, epoch in sorted(survivors):
            blob = _encode([key, txn.to_obj(), cert.to_obj(), int(epoch)])
            entries.append(
                (key, blob, zlib.crc32(blob), bytes(ent.txh), int(epoch))
            )
        page_path = os.path.join(self.directory, page_name(page_id))
        footer: List[List[object]] = []
        page_bytes = 0
        if entries:
            footer, page_bytes = await loop.run_in_executor(
                None, _write_page, page_path, self.server_id, page_id, entries
            )
        # adopt BEFORE the manifest/deletes: a fault between the awaits
        # must resolve to a page that still exists on disk
        if footer:
            self._adopt_page_from_compaction(
                page_id, page_path, footer, page_bytes, set(victims)
            )
        keep = [pid for pid in sorted(self._pages) if pid not in victims]
        await loop.run_in_executor(
            None, self._write_manifest, self.snapshot_seq, keep
        )

        def _unlink_victims():
            for pid in victims:
                meta = self._pages.get(pid)
                if meta is None:
                    continue
                try:
                    os.unlink(str(meta["path"]))
                except OSError:
                    pass

        await loop.run_in_executor(None, _unlink_victims)
        # re-validate in THIS loop turn (the guard above is awaits stale):
        # concurrent flushes only ever ADD pages, but act only on victims
        # still present all the same
        victims = [pid for pid in victims if pid in self._pages]
        for pid in victims:
            self._pages.pop(pid, None)
        # index entries still pointing into a victim page are gone from
        # disk: they were superseded mid-compaction (re-flushed) or failed
        # re-verification — re-point already happened for survivors
        for key, ent in list(self._index.items()):
            if ent.page_id in victims:
                self._index.pop(key, None)
        for pid in list(self._pages):
            self._recount_live(pid)
        self.compactions += 1
        self.compaction_rewritten += len(entries)
        if self.metrics is not None:
            self.metrics.mark("storage.compactions")
        return {"pages": len(victims), "rewritten": len(entries)}

    def _adopt_page_from_compaction(
        self, page_id: int, path: str, footer: List[List[object]],
        size: int, victims: set,
    ) -> None:
        self._pages[page_id] = {
            "path": path,
            "entries": len(footer),
            "live": 0,
            "bytes": size,
        }
        for key, off, length, crc, txh, epoch in footer:
            cur = self._index.get(key)
            # only re-point keys whose live entry still sits in a victim —
            # a flush that landed during the verify awaits already shadows
            # us with a newer version, and a conviction mid-sweep must not
            # be resurrected by the rewrite
            if cur is None or cur.page_id not in victims:
                continue
            self._index[key] = PageEntry(
                page_id, int(off), int(length), int(crc), bytes(txh), int(epoch)
            )
        self._recount_live(page_id)

    # ------------------------------------------------------------ lifecycle

    async def _bg_loop(self) -> None:
        """Inherited group tick + the paged engine's deferred work: the
        boot audit sweep and armed compactions."""
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
                if self._audit_due and self.store is not None:
                    self._audit_due = False
                    await self.audit()
                if self._compact_due and self.store is not None:
                    self._compact_due = False
                    await self.compact()
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("paged storage background tick failed")

    # --------------------------------------------------------------- admin

    def stats(self) -> Dict[str, object]:
        s = super().stats()
        total_entries = sum(int(p["entries"]) for p in self._pages.values())
        live = sum(int(p["live"]) for p in self._pages.values())
        s["pages"] = {
            "count": len(self._pages),
            "resident": len(self._clock),
            "entries": total_entries,
            "live_entries": live,
            "bytes": sum(int(p["bytes"]) for p in self._pages.values()),
            "convicted": self.pages_convicted,
        }
        s["cache"] = {
            "cap_bytes": self.cache_cap,
            "resident_bytes": self._resident_bytes,
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "evictions": self.cache_evictions,
        }
        s["compaction"] = {
            "debt": total_entries - live,
            "debt_ratio": round(self._debt_ratio(), 4),
            "runs": self.compactions,
            "rewritten": self.compaction_rewritten,
            "reverified": self.compaction_reverified,
        }
        s["memtable"] = {
            "dirty_keys": len(self._dirty_keys),
            "bytes": self._memtable_bytes,
            "cap_bytes": self.memtable_cap,
        }
        s["audits"] = self.audits
        s["audited_entries"] = self.audited_entries
        return s
