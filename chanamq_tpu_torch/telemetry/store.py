"""Fixed-slot per-entity timeseries rings.

One 3-D numpy buffer holds every entity's ring: ``(slots, ticks,
fields)``. A slot is leased to an entity (a queue or a connection) on
first sight and recycled when the entity disappears; beyond capacity new
entities are *dropped from sampling* (counted, never resized) so memory
stays fixed no matter how many queues a tenant declares — the
data-parallel batch-over-actors idea (PAPERS.md, OpenCL Actors): the
alert engine and the top-K selector read the whole entity population as
one matrix operation instead of per-entity loops.

Plain numpy, no device work: writers run on the broker's event loop each sampler
tick; readers (admin handlers, the forecaster feature tap) take copies.
"""

from __future__ import annotations

from typing import Hashable, Optional

import numpy as np

# per-queue series, one value per field per tick. Rates are per-second
# deltas of the queue's monotonic n_published/n_delivered/n_acked
# counters; the rest are instantaneous gauges.
QUEUE_FIELDS: tuple[str, ...] = (
    "publish_rate", "deliver_rate", "ack_rate",
    "depth", "unacked", "consumers", "ready_bytes",
)

# per-connection series. credit is the remaining consumer-prefetch
# budget summed over the connection's channels (0 when unlimited).
CONN_FIELDS: tuple[str, ...] = (
    "publish_rate", "deliver_rate", "ack_rate",
    "channels", "unacked", "credit",
)


class EntityRings:
    """Slot-leased timeseries rings over one shared (slots, ticks, F) buffer.

    Single-writer (the sampler tick on the event loop). All active slots
    are written every tick, so per-slot cursors advance in lockstep; a
    per-slot count still tracks how much history each entity has (slots
    leased mid-run have shorter series).
    """

    def __init__(self, slots: int, ticks: int, fields: tuple[str, ...]) -> None:
        assert slots > 0 and ticks > 1
        self.fields = fields
        self.slots = slots
        self.ticks = ticks
        self._buf = np.zeros((slots, ticks, len(fields)), dtype=np.float32)
        self._index: dict[Hashable, int] = {}
        self._free = list(range(slots - 1, -1, -1))  # pop() leases slot 0 first
        self._next = np.zeros(slots, dtype=np.int64)
        self._count = np.zeros(slots, dtype=np.int64)
        self.evicted = 0   # slots recycled because their entity went away
        self.dropped = 0   # entities seen while no slot was free

    def __len__(self) -> int:
        return len(self._index)

    def lease(self, key: Hashable) -> Optional[int]:
        """Slot for key, leasing a free one on first sight. None = full
        (the entity is invisible to telemetry until a slot frees up)."""
        slot = self._index.get(key)
        if slot is not None:
            return slot
        if not self._free:
            self.dropped += 1
            return None
        slot = self._free.pop()
        self._index[key] = slot
        self._buf[slot] = 0.0
        self._next[slot] = 0
        self._count[slot] = 0
        return slot

    def retire(self, key: Hashable) -> None:
        """Entity disappeared: recycle its slot."""
        slot = self._index.pop(key, None)
        if slot is not None:
            self._free.append(slot)
            self.evicted += 1

    def retire_absent(self, live: set) -> None:
        """Recycle every slot whose entity is not in the live set."""
        for key in [k for k in self._index if k not in live]:
            self.retire(key)

    def push(self, slot: int, vec: np.ndarray) -> None:
        self._buf[slot, self._next[slot]] = vec
        self._next[slot] = (self._next[slot] + 1) % self.ticks
        self._count[slot] += 1

    # -- matrix reads (alert engine / top-K) -------------------------------

    def keys(self) -> list:
        """Active entities, sorted for deterministic evaluation order."""
        return sorted(self._index)

    def latest_matrix(self) -> tuple[list, np.ndarray]:
        """(keys, (E, F) matrix) of each active entity's newest vector."""
        keys = self.keys()
        if not keys:
            return keys, np.zeros((0, len(self.fields)), dtype=np.float32)
        slots = np.array([self._index[k] for k in keys])
        idx = (self._next[slots] - 1) % self.ticks
        return keys, self._buf[slots, idx].copy()

    def delta_matrix(self, window: int) -> tuple[list, np.ndarray]:
        """(keys, (E, F) matrix) of newest-minus-(window-ticks-ago) per
        entity — the growth signal. Entities with less history than the
        window compare against their oldest sample; entities with a
        single sample report zero growth."""
        keys = self.keys()
        if not keys:
            return keys, np.zeros((0, len(self.fields)), dtype=np.float32)
        slots = np.array([self._index[k] for k in keys])
        count = self._count[slots]
        back = np.minimum(np.maximum(count - 1, 0), window)
        newest = (self._next[slots] - 1) % self.ticks
        oldest = (self._next[slots] - 1 - back) % self.ticks
        return keys, (self._buf[slots, newest] - self._buf[slots, oldest])

    # -- per-entity reads (drilldown / forecaster features) ----------------

    def series(self, key: Hashable, window: int) -> Optional[np.ndarray]:
        """The newest <= window vectors for key, oldest first (copy)."""
        slot = self._index.get(key)
        if slot is None:
            return None
        n = int(min(self._count[slot], self.ticks, window))
        if n == 0:
            return np.zeros((0, len(self.fields)), dtype=np.float32)
        end = int(self._next[slot])
        start = (end - n) % self.ticks
        if start < end:
            return self._buf[slot, start:end].copy()
        return np.concatenate(
            [self._buf[slot, start:], self._buf[slot, :end]])

    def stats(self) -> dict:
        return {
            "entities": len(self._index),
            "slots": self.slots,
            "ticks": self.ticks,
            "evicted": self.evicted,
            "dropped": self.dropped,
        }
