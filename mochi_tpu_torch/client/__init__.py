from .errors import (
    MochiClientError,
    InconsistentRead,
    InconsistentWrite,
    RequestFailed,
    RequestRefused,
)
from .txn import TransactionBuilder
from .client import MochiDBClient

__all__ = [
    "MochiClientError",
    "InconsistentRead",
    "InconsistentWrite",
    "RequestFailed",
    "RequestRefused",
    "TransactionBuilder",
    "MochiDBClient",
]
