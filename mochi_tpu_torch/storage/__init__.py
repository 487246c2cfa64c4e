"""Storage engines behind the :class:`StorageEngine` SPI.

``MemoryStorage`` (default) keeps the reference's in-process posture;
``DurableStorage`` is the log-structured engine: CRC-framed WAL of
self-certifying write certificates, group-commit fsync policies, snapshots
with log truncation, and crash recovery that re-verifies every replayed
certificate through the batch signature path (tampered logs are convicted,
never adopted).  ``PagedStorage`` (``MOCHI_STORAGE_ENGINE=paged``) keeps the
same WAL tail but pages committed values to immutable self-certifying page
files with a bounded resident cache, so the keyspace can outgrow RAM.  The
on-disk formats are the reference package's, byte for byte: either package
recovers a directory the other wrote.
"""

from .durable import DurableStorage
from .paged import PagedStorage
from .spi import MemoryStorage, StorageEngine, build_storage

__all__ = [
    "StorageEngine",
    "MemoryStorage",
    "DurableStorage",
    "PagedStorage",
    "build_storage",
]
