from .store import DataStore, StoreValue, EPOCH_UNIT
from .replica import MochiReplica

__all__ = ["DataStore", "StoreValue", "EPOCH_UNIT", "MochiReplica"]
