"""WAL segment files: append-only logs under ``<store>.wal/``.

One shard store directory holds one WAL: an active segment the commit
loop appends to, plus zero or more sealed segments awaiting checkpoint
truncation.  File names carry the first LSN a segment may contain
(``segment-<first_lsn>.log``), so the set orders and scans without any
side index — recovery is a directory listing plus a frame walk.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from .codec import scan_frames

_NAME = re.compile(r"^segment-(\d{20})\.log$")


def segment_name(first_lsn: int) -> str:
    return f"segment-{first_lsn:020d}.log"


def list_segments(dir_path: str) -> "list[tuple[int, str]]":
    """(first_lsn, path) for every segment file, in LSN order."""
    out: list[tuple[int, str]] = []
    try:
        names = os.listdir(dir_path)
    except FileNotFoundError:
        return out
    for name in names:
        m = _NAME.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dir_path, name)))
    out.sort()
    return out


def read_segment(path: str) -> "tuple[list[bytes], int, str]":
    """Frame-walk one segment file: (payloads, good_bytes, status)."""
    with open(path, "rb") as f:
        data = f.read()
    return scan_frames(data)


def truncate_segment(path: str, good_bytes: int) -> None:
    """Drop a torn tail in place (crash interrupted the final append)."""
    with open(path, "r+b") as f:
        f.truncate(good_bytes)


class SegmentWriter:
    """The active segment: buffered appends + explicit fsync.

    All methods run on the WAL's dedicated writer thread (one commit at
    a time), so no locking is needed here.
    """

    def __init__(self, dir_path: str, first_lsn: int) -> None:
        self.dir = dir_path
        self.first_lsn = first_lsn
        self.last_lsn = first_lsn - 1
        self.path = os.path.join(dir_path, segment_name(first_lsn))
        self._f = open(self.path, "ab")
        self.size = self._f.tell()

    def append(self, data: bytes, last_lsn: int) -> None:
        self._f.write(data)
        self.size += len(data)
        self.last_lsn = last_lsn

    def sync(self, fsync: bool) -> None:
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def roll(self, fsync: bool) -> "SegmentWriter":
        """Seal this segment (flushed + synced) and open the next one."""
        self.sync(fsync)
        self._f.close()
        return SegmentWriter(self.dir, self.last_lsn + 1)

    def close(self, fsync: bool = True) -> None:
        try:
            self.sync(fsync)
        finally:
            self._f.close()


def fsync_dir(dir_path: str) -> None:
    """Make segment create/unlink durable (directory entry fsync)."""
    try:
        fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def ensure_dir(dir_path: str) -> None:
    os.makedirs(dir_path, exist_ok=True)


def quarantine(path: str) -> Optional[str]:
    """Rename an unreplayable segment aside (evidence, never replayed)."""
    target = path + ".corrupt"
    try:
        os.replace(path, target)
        return target
    except OSError:
        return None
