"""L5: pluggable persistence.

Rebuilds the capability of the reference's store layer
(chana-mq-server .../store/package.scala:15-43 `DBOpService` trait and its
CassandraOpService implementation): durable exchanges, queues, bindings,
vhosts, refcounted message blobs, per-queue message logs keyed by offset, a
lastConsumed watermark, unacked bookkeeping, and archival copies on queue
delete. Backends: in-memory (transient/testing) and SQLite (durable).
"""

from .api import StoreService, StoredQueue, StoredExchange, StoredMessage
from .memory import MemoryStore
from .sqlite import SqliteStore

__all__ = [
    "StoreService",
    "StoredQueue",
    "StoredExchange",
    "StoredMessage",
    "MemoryStore",
    "SqliteStore",
]
