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

Engines in this package: :class:`MemoryStorage` only — state lives and dies
with the process, the reference's in-memory posture and the test-matrix
default.  The durable engines of the JAX package (the WAL, snapshots and
verified recovery of ``storage/durable.py``, the paged engine of
``storage/paged.py``) are not ported yet: :func:`build_storage` refuses a
storage directory rather than quietly running in memory.
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
    """None -> the in-memory no-op engine.  A ``storage_dir`` asks for a
    durable engine (``wal`` or ``paged``), which this package does not have
    yet: that raises, naming the slice it belongs to."""
    if not storage_dir:
        return MemoryStorage()
    raise NotImplementedError(
        f"durable storage (storage_dir={storage_dir!r}, engine "
        f"{engine or 'wal'!r}) is not ported to mochi_tpu_torch yet: the WAL, "
        "snapshot and paged engines land with the storage slice; run without "
        "a storage directory (in-memory replicas)"
    )
