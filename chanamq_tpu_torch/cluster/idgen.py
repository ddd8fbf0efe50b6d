"""Cluster-wide unique message ids (snowflake scheme).

Capability parity with the reference's IdGenerator
(chana-mq-server .../service/IdGenerator.scala:13-92): 64-bit ids composed of
a 42-bit millisecond timestamp (custom epoch) << 22 | 10-bit worker id |
12-bit per-ms sequence; monotonic, spin-to-next-ms on sequence overflow,
clock-regression rejected.
"""

from __future__ import annotations

import threading
import time

# custom epoch: 2020-01-01T00:00:00Z, giving 42 bits of headroom for ~139 years
EPOCH_MS = 1577836800000

WORKER_BITS = 10
SEQUENCE_BITS = 12
MAX_WORKER_ID = (1 << WORKER_BITS) - 1
SEQUENCE_MASK = (1 << SEQUENCE_BITS) - 1
TIMESTAMP_SHIFT = WORKER_BITS + SEQUENCE_BITS


class ClockRegressionError(RuntimeError):
    pass


class IdGenerator:
    """Thread-safe snowflake id generator for one worker (node)."""

    __slots__ = ("worker_id", "_lock", "_last_ms", "_sequence")

    def __init__(self, worker_id: int) -> None:
        if not 0 <= worker_id <= MAX_WORKER_ID:
            raise ValueError(f"worker_id must be in [0, {MAX_WORKER_ID}]")
        self.worker_id = worker_id
        self._lock = threading.Lock()
        self._last_ms = -1
        self._sequence = 0

    def next_id(self) -> int:
        # runs once per published message; the uncontended lock stays for
        # thread-safety but the id math lives inline, no extra call frame
        with self._lock:
            now = int(time.time() * 1000)
            if now < self._last_ms:
                raise ClockRegressionError(
                    f"clock moved backwards: {self._last_ms - now} ms"
                )
            if now == self._last_ms:
                self._sequence = (self._sequence + 1) & SEQUENCE_MASK
                if self._sequence == 0:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000)
            else:
                self._sequence = 0
            self._last_ms = now
            return (
                ((now - EPOCH_MS) << TIMESTAMP_SHIFT)
                | (self.worker_id << SEQUENCE_BITS)
                | self._sequence
            )

    def next_ids(self, n: int) -> list[int]:
        # cold path (worker-lease batches): re-acquiring the uncontended
        # lock per id keeps exactly one copy of the snowflake algorithm
        return [self.next_id() for _ in range(n)]

    @staticmethod
    def timestamp_ms(message_id: int) -> int:
        """Extract the creation time (unix ms) from an id."""
        return (message_id >> TIMESTAMP_SHIFT) + EPOCH_MS
