"""CRC-framed append-only log: the record format under the durable engine.

Framing (all little-endian, per record)::

    [u32 length][u32 crc32(payload)][payload]

``payload`` is an mcode-encoded ``[seq, rtype, body]`` triple: ``seq`` is a
log-global strictly-increasing sequence number (the snapshot watermark and
the reorder detector), ``rtype`` names the record kind, ``body`` is
kind-specific.  The framing exists for exactly one failure family — TORN
TAIL WRITES: a crash (or SIGKILL) mid-``write()`` leaves a prefix of the
last record on disk, and :func:`scan` must stop cleanly at the last record
whose length and CRC both check out, never hand a partial record to replay.
CRC is *not* the integrity story against tampering — an adversary rewriting
its own log recomputes CRCs trivially; the replayed certificates are
self-certifying (2f+1 Ed25519 grants) and the durable engine re-verifies
them through the batch signature path, which is what convicts a mutated
record (docs/OPERATIONS.md §4i).

Segments: one log = ``wal-<10-digit-seq>.log`` files in a directory.  Each
segment opens with a fixed header (magic + server id + segment index) so a
restore mix-up — another replica's log, a truncated-at-zero file — fails
loudly instead of replaying foreign epochs.  Writers always ROTATE to a
fresh segment at boot (never append to a possibly-torn tail) and at
snapshot time; snapshotting deletes every segment whose records are fully
covered by the snapshot's ``wal_seq`` watermark.

Everything in this module is synchronous by design: the durable engine
calls it from an executor (the replica's event loop never blocks on file
IO).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..protocol.codec import decode, encode

MAGIC = b"mochi-wal-1\n"
# Record kinds.  Commits are the log's reason to exist: the self-certifying
# (key, transaction, certificate) triple replay re-validates end to end.
# Reclaims are the one epoch event commits cannot reconstruct: a reclaim
# bumps a key's epoch WITHOUT a commit, and losing that bump across a
# restart would let the recovered replica re-grant a slot it promised never
# to re-grant (store.process_write1's safety argument, point 2).
RT_COMMIT = 1
RT_RECLAIM = 2

_HEADER = struct.Struct("<II")  # length, crc32
MAX_RECORD = 64 * 1024 * 1024  # same guard as the mcode codec


class TornSegmentHeader(ValueError):
    """The file is too short or garbled to even carry its segment header —
    the honest shape of a crash DURING segment creation (``open`` raced the
    header reaching disk).  :func:`scan_segment` folds this into the torn
    result (clean stop, zero records) instead of failing the boot; a
    DECODABLE header naming another server stays a hard ``ValueError``
    (restore mix-up, which must refuse loudly)."""


def encode_record(seq: int, rtype: int, body) -> bytes:
    """One framed record, ready to append."""
    payload = encode([seq, rtype, body])
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


@dataclass
class Record:
    seq: int
    rtype: int
    body: object
    offset: int  # byte offset of the frame inside its segment


@dataclass
class ScanResult:
    """One segment's scan: the valid prefix, and why the scan stopped.

    ``torn`` is True when the segment ends in garbage — a truncated frame,
    a CRC mismatch, an undecodable payload.  That is the EXPECTED shape
    after a crash mid-append and replay treats it as a clean end of log;
    anything after the first bad frame is unreachable by construction
    (lengths can no longer be trusted), so the scan never resynchronizes.
    """

    records: List[Record]
    valid_bytes: int  # offset just past the last valid record
    torn: bool
    detail: str = ""


def segment_header(server_id: str, index: int) -> bytes:
    return MAGIC + encode([server_id, index])


def read_segment_header(data: bytes, server_id: str) -> int:
    """Validate a segment's header; returns the offset where records start.

    Raises ``ValueError`` on foreign or unrecognizable headers — a wrong
    server id is a restore mix-up (another replica's epochs), not a torn
    write, and must fail the boot rather than replay silently.
    """
    if not data.startswith(MAGIC):
        if MAGIC.startswith(data):
            # empty file or a proper prefix of the magic: a crash tore the
            # header write itself — torn, not foreign
            raise TornSegmentHeader("truncated segment header")
        raise ValueError("not a mochi WAL segment (bad magic)")
    # header body is a 2-element mcode list directly after the magic; its
    # encoded length is recovered by decoding from a bounded slice
    rest = data[len(MAGIC):]
    from ..protocol.codec import _Reader  # the readable-spec reader

    reader = _Reader(bytes(rest[: 4096]))
    try:
        hdr = reader.read_value()
    except Exception:
        raise TornSegmentHeader("truncated or undecodable segment header")
    if not isinstance(hdr, list) or len(hdr) != 2:
        raise ValueError("malformed WAL segment header")
    sid, _index = hdr
    if sid != server_id:
        raise ValueError(f"WAL segment belongs to {sid!r}, not {server_id!r}")
    return len(MAGIC) + reader.pos


def scan_segment(data: bytes, server_id: str) -> ScanResult:
    """Walk a segment's records, stopping at the first invalid frame."""
    try:
        pos = read_segment_header(data, server_id)
    except TornSegmentHeader as exc:
        return ScanResult([], 0, torn=True, detail=str(exc))
    records: List[Record] = []
    n = len(data)
    while True:
        if pos == n:
            return ScanResult(records, pos, torn=False)
        if pos + _HEADER.size > n:
            return ScanResult(records, pos, torn=True, detail="truncated frame header")
        length, crc = _HEADER.unpack_from(data, pos)
        if length > MAX_RECORD:
            return ScanResult(records, pos, torn=True, detail="frame length guard")
        start = pos + _HEADER.size
        end = start + length
        if end > n:
            return ScanResult(records, pos, torn=True, detail="truncated frame body")
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            return ScanResult(records, pos, torn=True, detail="crc mismatch")
        try:
            seq, rtype, body = decode(payload)
        except Exception:
            return ScanResult(records, pos, torn=True, detail="undecodable payload")
        records.append(Record(seq, rtype, body, pos))
        pos = end


def segment_name(index: int) -> str:
    return f"wal-{index:010d}.log"


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """Sorted (index, path) pairs of the directory's WAL segments."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith("wal-") and name.endswith(".log"):
            mid = name[len("wal-"):-len(".log")]
            if mid.isdigit():
                out.append((int(mid), os.path.join(directory, name)))
    return sorted(out)


class SegmentWriter:
    """Append half of one segment file.  Synchronous; executor-only on the
    replica path.  ``flush()`` pushes buffered bytes to the OS (what makes
    an append survive SIGKILL of this process); ``sync()`` fsyncs (what
    makes it survive the machine)."""

    def __init__(self, path: str, server_id: str, index: int):
        self.path = path
        self.index = index
        self._fh = open(path, "xb")
        self._fh.write(segment_header(server_id, index))
        self._fh.flush()
        self.bytes_written = len(segment_header(server_id, index))

    def append(self, frames: bytes) -> None:
        self._fh.write(frames)
        self._fh.flush()
        self.bytes_written += len(frames)

    def sync(self) -> None:
        os.fsync(self._fh.fileno())

    @property
    def closed(self) -> bool:
        return self._fh.closed

    def close(self) -> None:
        try:
            self._fh.flush()
        finally:
            self._fh.close()


def iter_log(
    directory: str, server_id: str
) -> Iterator[Tuple[int, ScanResult]]:
    """Scan every segment in order; yields (segment_index, ScanResult).

    A torn NON-final segment still only surrenders its valid prefix — the
    caller decides whether trailing segments after a torn one are evidence
    of tampering (an honest crash tears only the final segment: later
    segments exist only after a clean rotation).
    """
    for index, path in list_segments(directory):
        with open(path, "rb") as fh:
            data = fh.read()
        yield index, scan_segment(data, server_id)


def last_segment_index(directory: str) -> int:
    segs = list_segments(directory)
    return segs[-1][0] if segs else 0


def delete_segments_below(directory: str, keep_from_index: int) -> int:
    """Remove segments with index < keep_from_index; returns count removed.
    The unlink order is ascending, so a crash mid-truncation leaves a
    contiguous suffix — recovery's watermark skip handles the overlap."""
    removed = 0
    for index, path in list_segments(directory):
        if index >= keep_from_index:
            break
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed
