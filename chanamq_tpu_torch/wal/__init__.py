"""Log-structured write-ahead storage engine.

``WalStore`` wraps the SQLite store: appends win durability via one
cross-channel group fsync per flush window, SQLite stays the read index
fed by a background checkpointer, and recovery replays the WAL tail.
See :mod:`chanamq_tpu_torch.wal.engine` for the full design notes. The
frame format (``codec.py``) is the one the reference package writes, so a
WAL written by either replays in the other.
"""

from .engine import CHECKPOINT_KEY, WalStore  # noqa: F401
