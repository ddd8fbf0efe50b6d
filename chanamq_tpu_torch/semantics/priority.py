"""Per-priority ready-list fan for x-max-priority queues.

The seed kept priority queues in one deque ordered (priority desc,
offset asc), which made every enqueue an ordered-insert scan — O(depth)
per publish as soon as priorities mix. ``PriorityFan`` fans the ready
list into one deque per priority level and keeps a high-water hint, so
the hot operations (push, dispatch pop, head peek) are O(1) while every
deque-shaped access the queue code performs (iteration, len, peek,
clear, recovery extend) still works unchanged.

Ordering contract (identical to the seed's single deque): iteration and
popleft observe (priority desc, offset asc) — within one band FIFO by
offset, bands served highest first.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Iterable, Iterator


class PriorityFan:
    """Deque-compatible ready list: one band per priority level 0..max.

    ``_hi`` is an upper bound on the highest non-empty band — bumped on
    append, lazily walked down on pop/peek — so the common steady state
    (traffic concentrated on few levels) never scans the full fan.
    """

    __slots__ = ("_bands", "_hi", "_len")

    def __init__(self, max_priority: int, items: Iterable[Any] = ()) -> None:
        self._bands: list[deque] = [deque() for _ in range(max_priority + 1)]
        self._hi = 0
        self._len = 0
        for qm in items:
            self.append(qm)

    # -- hot path ----------------------------------------------------------

    def append(self, qm: Any) -> None:
        """Enqueue by the entry's (already clamped) priority."""
        p = qm.priority
        self._bands[p].append(qm)
        if p > self._hi:
            self._hi = p
        self._len += 1

    def appendleft(self, qm: Any) -> None:
        """Restore an entry to the head of its band — the exact inverse of
        popleft, which the basic_get store-error path relies on."""
        p = qm.priority
        self._bands[p].appendleft(qm)
        if p > self._hi:
            self._hi = p
        self._len += 1

    def popleft(self) -> Any:
        bands = self._bands
        h = self._hi
        while h > 0 and not bands[h]:
            h -= 1
        self._hi = h
        qm = bands[h].popleft()  # empty fan -> IndexError, like deque
        self._len -= 1
        return qm

    # -- requeue -----------------------------------------------------------

    def requeue(self, qm: Any) -> None:
        """Put a redelivered entry back in offset order within its band.

        Requeued offsets are older than the band's tail by construction,
        so the scan runs from the left and usually stops immediately (a
        rejected head goes straight back to the front)."""
        band = self._bands[qm.priority]
        for i, existing in enumerate(band):
            if existing.offset > qm.offset:
                band.insert(i, qm)
                break
        else:
            band.append(qm)
        if qm.priority > self._hi:
            self._hi = qm.priority
        self._len += 1

    # -- deque-shaped surface ----------------------------------------------

    def extend(self, items: Iterable[Any]) -> None:
        for qm in items:
            self.append(qm)

    def clear(self) -> None:
        for band in self._bands:
            band.clear()
        self._hi = 0
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator[Any]:
        # (priority desc, offset asc) — the order the seed's deque held
        return itertools.chain.from_iterable(reversed(self._bands))

    def __getitem__(self, idx: int) -> Any:
        if self._len == 0:
            raise IndexError("fan is empty")
        bands = self._bands
        if idx == 0:
            h = self._hi
            while h > 0 and not bands[h]:
                h -= 1
            self._hi = h
            return bands[h][0]
        if idx == -1:
            for band in bands:
                if band:
                    return band[-1]
        # cold path (nothing in the queue code takes it today): resolve an
        # arbitrary index against the flattened iteration order
        if idx < 0:
            idx += self._len
        if not 0 <= idx < self._len:
            raise IndexError("fan index out of range")
        for band in reversed(bands):
            n = len(band)
            if idx < n:
                return band[idx]
            idx -= n
        raise IndexError("fan index out of range")  # unreachable
