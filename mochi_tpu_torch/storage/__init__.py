"""Storage behind the :class:`StorageEngine` SPI.

Only ``MemoryStorage`` (the default, in-process posture) is part of this
package so far; ``build_storage`` refuses a storage directory until the
durable engines are ported.
"""

from .spi import MemoryStorage, StorageEngine, build_storage

__all__ = ["StorageEngine", "MemoryStorage", "build_storage"]
