"""Tiered sealed-segment storage + key compaction for stream segments.

Generalizes the streams' sealed-blob RAM cache one level down: a cold
sealed stream segment's blob bytes are evicted from the SQLite row
(``blob=NULL``) into a side file under ``<wal dir>/tier/``, while the
segment index row stays queryable; a cursor replaying into an offloaded
segment rehydrates the blob from the tier file transparently
(WalStore.select_stream_segment).  Tier files carry a CRC32 trailer so
a short write or bit rot reads back as "absent" (the caller sees a
missing segment, never silent garbage).

Key compaction rewrites sealed segment blobs for stream queues declared
with ``x-stream-compact``: only the newest record per routing key
survives, Kafka-style.  Offsets are preserved — a compacted blob is
*sparse*, and the streams read path skips the holes — so committed
cursors remain valid across compaction.
"""

from __future__ import annotations

import os
import struct
from typing import TYPE_CHECKING
from urllib.parse import quote
from zlib import crc32

if TYPE_CHECKING:  # pragma: no cover - import cycle (streams -> broker)
    from ..streams.segment import StreamRecord

_U32 = struct.Struct("<I")


class StreamTier:
    """Side-file store for offloaded sealed stream-segment blobs."""

    def __init__(self, dir_path: str) -> None:
        self.dir = dir_path
        self.data_bytes = 0
        self._scanned = False

    def _queue_dir(self, vhost: str, queue: str) -> str:
        # percent-encode: vhost may contain "/" and the replica-NS marker
        return os.path.join(
            self.dir, quote(vhost, safe="") + "~" + quote(queue, safe=""))

    def _path(self, vhost: str, queue: str, base_offset: int) -> str:
        return os.path.join(self._queue_dir(vhost, queue),
                            f"{base_offset:020d}.seg")

    def scan(self) -> None:
        """Recount on-disk bytes (boot); cheap — tier trees are small."""
        total = 0
        for root, _dirs, files in os.walk(self.dir):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
        self.data_bytes = total
        self._scanned = True

    def write(self, vhost: str, queue: str, base_offset: int,
              blob: bytes) -> None:
        """Durable offload: tmp + fsync + rename, CRC32 trailer. Runs on
        an executor thread (called via run_in_executor)."""
        qdir = self._queue_dir(vhost, queue)
        os.makedirs(qdir, exist_ok=True)
        path = self._path(vhost, queue, base_offset)
        tmp = path + ".tmp"
        data = blob + _U32.pack(crc32(blob))
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.data_bytes += len(data)

    def read(self, vhost: str, queue: str, base_offset: int):
        """Rehydrate a blob; None when absent or CRC-damaged."""
        try:
            with open(self._path(vhost, queue, base_offset), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if len(data) < 4:
            return None
        blob, want = data[:-4], _U32.unpack(data[-4:])[0]
        return blob if crc32(blob) == want else None

    def has(self, vhost: str, queue: str, base_offset: int) -> bool:
        return os.path.exists(self._path(vhost, queue, base_offset))

    def forget(self, vhost: str, queue: str,
               base_offsets: "list[int]") -> None:
        for base in base_offsets:
            path = self._path(vhost, queue, base)
            try:
                self.data_bytes -= os.path.getsize(path)
                os.unlink(path)
            except OSError:
                pass

    def forget_queue(self, vhost: str, queue: str) -> None:
        qdir = self._queue_dir(vhost, queue)
        try:
            names = os.listdir(qdir)
        except OSError:
            return
        for name in names:
            path = os.path.join(qdir, name)
            try:
                self.data_bytes -= os.path.getsize(path)
                os.unlink(path)
            except OSError:
                pass
        try:
            os.rmdir(qdir)
        except OSError:
            pass


def compact_records(
    records: "list[StreamRecord]", seen_keys: "set[str]",
) -> "tuple[list[StreamRecord], int]":
    """One segment's compaction pass, newest-first against keys already
    seen in newer segments.  Returns (kept ascending, dropped count) and
    folds this segment's keys into seen_keys for the next (older) one."""
    kept: list[StreamRecord] = []
    dropped = 0
    for rec in reversed(records):
        if rec is None:
            continue  # already-sparse slot from a previous compaction
        if rec.routing_key in seen_keys:
            dropped += 1
        else:
            seen_keys.add(rec.routing_key)
            kept.append(rec)
    kept.reverse()
    return kept, dropped


def compacted_blob(kept: "list[StreamRecord]") -> "tuple[bytes, int]":
    from .engine import _stream_segment_mod  # lazy: import cycle

    blob = _stream_segment_mod().pack_records(kept)
    return blob, sum(r.wire_size for r in kept)
