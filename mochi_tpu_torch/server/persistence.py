"""Snapshot persistence for replica state.

The Java system this store is modelled on has no durability: storage is two
in-memory maps and a killed server loses everything.  Here a replica can periodically snapshot its committed state to disk (atomic
tmp+rename, mcode-encoded) and reload it at boot; the state-transfer
protocol (``MochiReplica.resync``) then catches up the tail written since
the snapshot.  Only *committed* state is persisted — certificates prove it;
transient Write1 grants are deliberately not (a recovering replica must not
resurrect stale grants: the grant book is epoch-scoped and the resync'd
epoch supersedes them).

Snapshots are self-certifying the same way sync entries are: each object
carries its (transaction, certificate) pair, so a replica can optionally
re-validate a snapshot it does not trust (e.g. restored from shared media)
through the Write2 checks.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from ..protocol import Transaction, WriteCertificate
from ..protocol.codec import decode, encode
from .store import DataStore, StoreValue

LOG = logging.getLogger(__name__)

MAGIC = "mochi-tpu-snapshot"
VERSION = 1


def _sv_to_obj(sv: StoreValue):
    return [
        sv.key,
        sv.value,
        sv.exists,
        sv.current_certificate.to_obj() if sv.current_certificate else None,
        sv.last_transaction.to_obj() if sv.last_transaction else None,
        sv.current_epoch,
    ]


def _sv_from_obj(obj) -> StoreValue:
    key, value, exists, cert, txn, epoch = obj
    return StoreValue(
        key=key,
        value=value,
        exists=exists,
        current_certificate=WriteCertificate.from_obj(cert) if cert is not None else None,
        last_transaction=Transaction.from_obj(txn) if txn is not None else None,
        current_epoch=epoch,
    )


def snapshot_bytes(store: DataStore, extra: Optional[dict] = None) -> bytes:
    """Serialize committed state (grants excluded by design).

    ``extra`` merges additional top-level keys into the document — the
    durable engine stamps its WAL watermark (``wal_seq``) here so recovery
    knows which log records the snapshot already covers.  Unknown keys are
    ignored by :func:`load_snapshot_bytes`, so the wire format stays
    version-1 compatible in both directions.
    """
    doc = {
        "magic": MAGIC,
        "version": VERSION,
        "server_id": store.server_id,
        "data": [_sv_to_obj(sv) for sv in store.data.values()],
        "data_config": [_sv_to_obj(sv) for sv in store.data_config.values()],
    }
    if extra:
        for k, v in extra.items():
            doc.setdefault(k, v)
    return encode(doc)


def read_snapshot_doc(blob: bytes, server_id: str) -> dict:
    """Decode + validate a snapshot document without touching any store
    (the durable engine replays entries through the verified Write2 path
    instead of raw-installing them)."""
    doc = decode(blob)
    if doc.get("magic") != MAGIC:
        raise ValueError("not a mochi-tpu snapshot")
    if doc.get("version") != VERSION:
        raise ValueError(f"unsupported snapshot version {doc.get('version')}")
    if doc.get("server_id") != server_id:
        # A snapshot carries one replica's epochs and ownership view; loading
        # another server's (shared data dir, restore mix-up) would serve
        # wrong shards at wrong epochs.
        raise ValueError(
            f"snapshot belongs to {doc.get('server_id')!r}, not {server_id!r}"
        )
    return doc


def load_snapshot_bytes(store: DataStore, blob: bytes) -> int:
    """Populate an (empty) store from snapshot bytes; returns object count."""
    doc = read_snapshot_doc(blob, store.server_id)
    n = 0
    for obj in doc["data"]:
        sv = _sv_from_obj(obj)
        store.data[sv.key] = sv
        n += 1
    for obj in doc["data_config"]:
        sv = _sv_from_obj(obj)
        store.data_config[sv.key] = sv
        n += 1
    return n


def write_snapshot(store: DataStore, path: str) -> int:
    """Atomically write a snapshot file; returns bytes written.

    Must be called where the store is quiescent (the replica's event loop);
    for concurrent use serialize there with :func:`snapshot_bytes` and hand
    the blob to :func:`write_snapshot_blob` in an executor.
    """
    return write_snapshot_blob(snapshot_bytes(store), path)


def write_snapshot_blob(blob: bytes, path: str) -> int:
    """Atomically write pre-serialized snapshot bytes (thread-safe)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".snap-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(blob)


def load_snapshot(store: DataStore, path: str) -> Optional[int]:
    """Load a snapshot if present; returns object count or None."""
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except FileNotFoundError:
        return None
    n = load_snapshot_bytes(store, blob)
    LOG.info("loaded snapshot: %d objects from %s", n, path)
    return n
