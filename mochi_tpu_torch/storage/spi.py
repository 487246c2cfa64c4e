"""Storage SPI: the seam ``DataStore`` persists through.

The datastore is the in-memory protocol state machine (dicts, single loop
turn, no locks).  Every DURABLE event flows through one narrow interface so
the engine behind it is swappable:

* ``stage_commit(keys, transaction, certificate)`` — called synchronously
  from the store's apply path, ONCE per applied transaction (``keys`` =
  the distinct keys it applied on this replica).  The staged triple is the
  protocol's own self-certifying evidence (2f+1 signed grants), so a log
  of these is its own proof and replay re-verifies instead of trusting the
  disk.
* ``stage_reclaim(key, ts, granted_hash, new_epoch)`` — the one epoch
  event commits cannot reconstruct.
* ``flush()`` — awaited by the replica at the batched-write2 seam BEFORE
  responses go out.

Engines:

* :class:`MemoryStorage` — the default: state lives and dies with the
  process, the reference's posture (and the right one for the in-process
  test matrix).  Every hook is a no-op.
* :class:`~mochi_tpu_torch.storage.durable.DurableStorage` — the
  log-structured engine (WAL + snapshots + verified recovery), opted into via
  ``MochiReplica(storage_dir=...)`` / ``--storage-dir``.
* :class:`~mochi_tpu_torch.storage.paged.PagedStorage` — the paged engine
  (WAL tail + immutable self-certifying value pages + bounded resident
  cache), selected with ``MOCHI_STORAGE_ENGINE=paged`` / ``--storage-engine
  paged`` once a storage dir is configured.

Paging engines (``pager = True``) additionally serve the READ path:
``DataStore._get`` calls ``fault_in(store, key)`` on a resident miss and
``note_access(key)`` on a resident hit, so a keyspace larger than RAM
stays addressable — values come back from disk on demand, re-checked
per entry before adoption.

Both durable engines re-verify every stored grant signature through the
replica's verifier at recovery (and the paged one again at its audit and
compaction): with ``CudaBatchVerifier`` that is the card's comb kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class StorageEngine:
    """Interface + the shared no-op defaults.

    All ``stage_*`` hooks are synchronous and must stay cheap: they run
    inside the store's uninterrupted batch loop turn.  All IO happens in
    the async half (``flush``/``snapshot``/``recover``/``close``), which
    engines run through executors — the replica's event loop never blocks
    on a file.
    """

    name = "none"
    # Paging engines override these: pager=True opts the store's read path
    # into fault_in/note_access dispatch (see module docstring).
    pager = False

    def fault_in(self, store, key: str):
        """On-demand load of a non-resident key; returns the StoreValue
        now resident (and adopted into ``store``) or None."""
        return None

    def note_access(self, key: str) -> None:
        """Resident-hit notification (cache recency bookkeeping)."""

    # ------------------------------------------------------------- staging

    def stage_commit(self, keys: List[str], transaction, certificate) -> None:
        pass

    def stage_reclaim(
        self, key: str, ts: int, granted_hash: bytes, new_epoch: int
    ) -> None:
        pass

    @property
    def dirty(self) -> bool:
        """Anything staged or written-but-not-yet-durable."""
        return False

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        pass

    async def flush(self) -> None:
        pass

    async def snapshot(self, store) -> None:
        pass

    async def recover(self, store, verifier=None, metrics=None) -> Dict:
        """Rebuild ``store`` from disk; returns the replay report."""
        return {"entries": 0, "convicted": 0}

    async def close(self, store=None) -> None:
        pass

    # --------------------------------------------------------------- admin

    def stats(self) -> Dict[str, object]:
        return {"engine": self.name}

    def replay_report(self) -> Dict[str, object]:
        return {"entries": 0, "convicted": 0, "convictions": []}

    @property
    def convictions(self) -> List[Dict[str, object]]:
        return []


class MemoryStorage(StorageEngine):
    """Explicit no-op engine (the default posture, reference-equivalent)."""

    name = "memory"


STORAGE_ENGINES = ("wal", "paged")


def build_storage(
    storage_dir: Optional[str],
    server_id: str,
    fsync: Optional[str] = None,
    metrics=None,
    engine: Optional[str] = None,
) -> StorageEngine:
    """``storage_dir`` -> a durable engine rooted at ``<dir>/<server_id>``
    (per-replica isolation under one operator-supplied root); None -> the
    in-memory no-op.  ``engine`` (or ``MOCHI_STORAGE_ENGINE``) picks which
    durable engine: ``wal`` (default — whole-store snapshots, everything
    resident) or ``paged`` (value pages + bounded resident cache)."""
    if not storage_dir:
        return MemoryStorage()
    import os

    engine = (engine or os.environ.get("MOCHI_STORAGE_ENGINE", "wal")).lower()
    if engine not in STORAGE_ENGINES:
        raise ValueError(
            f"MOCHI_STORAGE_ENGINE must be one of {STORAGE_ENGINES}, "
            f"got {engine!r}"
        )
    directory = os.path.join(storage_dir, server_id)
    if engine == "paged":
        from .paged import PagedStorage

        return PagedStorage(directory, server_id, fsync=fsync, metrics=metrics)
    from .durable import DurableStorage

    return DurableStorage(directory, server_id, fsync=fsync, metrics=metrics)
