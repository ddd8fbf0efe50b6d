"""Live broker telemetry: the feature vectors the forecaster reads.

A copy of ``chanamq_tpu/models/telemetry.py``, carried over as it is: this
package keeps its own copies and imports nothing of the JAX package. It is
the wiring between chanamq_tpu_torch.utils.metrics (counters + gauges,
maintained on the broker's hot paths) and chanamq_tpu_torch.models.forecaster
(the PyTorch model): each sampler tick turns the counter deltas and queue
gauges into one 8-feature vector and appends it to a fixed-size ring
buffer. The ring is plain numpy — no torch import, no device work — so the
sampler can run on the broker's event loop at negligible cost; prediction
reads *copies* of the ring from a worker thread (models/service.py) and
never touches broker state.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker

# One vector per sampler tick. Rates are per-second deltas of the metrics
# counters; depth/unacked/consumers are instantaneous gauges summed over
# every queue in every vhost (matching models/forecaster.py:3-7).
FEATURES: tuple[str, ...] = (
    "publish_rate",        # messages published / s
    "deliver_rate",        # messages delivered / s
    "depth",               # ready messages across all queues
    "unacked",             # outstanding (unacked) deliveries
    "consumers",           # registered consumers
    "publish_bytes_rate",  # body bytes published / s
    "deliver_bytes_rate",  # body bytes delivered / s
    "confirm_rate",        # publisher confirms / s
)

N_FEATURES = len(FEATURES)

# counter names backing the rate features, in feature order
_RATE_COUNTERS = (
    "published_msgs", "delivered_msgs", "published_bytes",
    "delivered_bytes", "confirmed_msgs",
)
_RATE_INDEX = (0, 1, 5, 6, 7)  # position of each rate in FEATURES


def counter_state(broker: "Broker") -> dict[str, int]:
    """Snapshot the monotonic counters a rate delta needs."""
    metrics = broker.metrics
    return {name: getattr(metrics, name) for name in _RATE_COUNTERS}


def sample(
    broker: "Broker", prev: dict[str, int], dt_s: float
) -> tuple[np.ndarray, dict[str, int]]:
    """One telemetry vector from the broker's live metrics.

    prev is the counter snapshot from the previous tick; dt_s the elapsed
    wall time since then. Returns (vector[N_FEATURES] float32, new snapshot).
    """
    current = counter_state(broker)
    vec = np.zeros(N_FEATURES, dtype=np.float32)
    dt = max(dt_s, 1e-6)
    for (name, idx) in zip(_RATE_COUNTERS, _RATE_INDEX):
        vec[idx] = (current[name] - prev.get(name, 0)) / dt
    # O(1): the broker maintains these gauges incrementally at every queue
    # mutation site (entities.py), so a tick costs the same at 10 queues
    # as at 10k — the old per-tick walk over every queue in every vhost
    # was O(all queues) and would dominate the loop at scale
    vec[2] = broker.queue_depth
    vec[3] = broker.queue_unacked
    vec[4] = broker.queue_consumers
    return vec, current


class TelemetryRing:
    """Fixed-capacity ring of telemetry vectors (newest-last windows).

    Single-writer (the sampler task on the event loop); readers take
    consistent copies via window()/history() and may run on any thread.
    """

    def __init__(self, capacity: int = 4096, width: int = N_FEATURES) -> None:
        assert capacity > 1
        self.capacity = capacity
        self.width = width
        self._buf = np.zeros((capacity, width), dtype=np.float32)
        self._next = 0   # write position
        self.count = 0   # total vectors ever pushed

    def push(self, vec: np.ndarray) -> None:
        self._buf[self._next] = vec
        self._next = (self._next + 1) % self.capacity
        self.count += 1

    def __len__(self) -> int:
        return min(self.count, self.capacity)

    def history(self) -> np.ndarray:
        """All retained vectors, oldest first (copy)."""
        n = len(self)
        if self.count <= self.capacity:
            return self._buf[:n].copy()
        # ring has wrapped: stitch [next:] + [:next] (concatenate already
        # allocates a fresh array)
        return np.concatenate([self._buf[self._next:], self._buf[:self._next]])

    def window(self, seq_len: int) -> Optional[np.ndarray]:
        """The newest seq_len vectors, oldest first; None if not enough."""
        if len(self) < seq_len:
            return None
        return self.history()[-seq_len:]

    def latest(self) -> Optional[np.ndarray]:
        if len(self) == 0:
            return None
        return self._buf[(self._next - 1) % self.capacity].copy()


class TopKSlots:
    """Identity-pinned feature slots for the per-queue forecaster columns.

    The old tap (TelemetryService.topk_features) re-ranked queues every
    tick and wrote "the i-th busiest queue" into slot i. Whenever the
    top-K *set* changed between ticks, a feature column silently changed
    meaning mid-window — the model saw queue A's depth spliced onto
    queue B's history and trained on the seam. Here a slot, once
    assigned, stays bound to the same queue for as long as that queue
    remains in the top-K set; membership changes are explicit:

    - eviction: a queue that drops out of the current top-K frees its
      slot (the slot emits zeros from that tick on),
    - reset: a newly assigned slot emits zeros for exactly one tick (the
      reset marker), so the window shows a clean break instead of a
      discontinuous splice between two queues' series.

    Assignment of new entrants to freed slots follows rank order, so the
    mapping is deterministic for a given telemetry series.
    """

    def __init__(self, k: int) -> None:
        self.k = max(0, int(k))
        self._keys: list[Optional[tuple]] = [None] * self.k

    def slot_queues(self) -> list[Optional[tuple]]:
        """Current slot -> queue identity binding (None = free)."""
        return list(self._keys)

    def update(self, keys: list, latest: np.ndarray) -> np.ndarray:
        """One tick: re-rank, evict/assign, and emit the 2k feature tail
        (depth, publish_rate per slot) aligned to the pinned bindings.

        keys/latest are EntityRings.latest_matrix() output (QUEUE_FIELDS
        column order: publish_rate, deliver_rate, ack_rate, depth, ...).
        """
        out = np.zeros(2 * self.k, dtype=np.float32)
        if self.k == 0:
            return out
        desired: list[tuple] = []
        if keys:
            rate = latest[:, 0] + latest[:, 1]
            order = np.argsort(-rate, kind="stable")[: self.k]
            desired = [tuple(keys[i]) for i in order]
        desired_set = set(desired)
        # evict slots whose queue left the top-K set
        freed: list[int] = []
        for slot, key in enumerate(self._keys):
            if key is not None and key not in desired_set:
                self._keys[slot] = None
            if self._keys[slot] is None:
                freed.append(slot)
        # assign new entrants to freed slots in rank order; fresh slots
        # emit zeros this tick (the reset marker)
        occupied = {key for key in self._keys if key is not None}
        entrants = [key for key in desired if key not in occupied]
        fresh: set[int] = set()
        for slot, key in zip(freed, entrants):
            self._keys[slot] = key
            fresh.add(slot)
        index = {tuple(key): i for i, key in enumerate(keys)}
        for slot, key in enumerate(self._keys):
            if key is None or slot in fresh:
                continue
            row = index.get(key)
            if row is None:
                continue  # vanished this tick; evicted on the next update
            out[2 * slot] = latest[row, 3]      # depth
            out[2 * slot + 1] = latest[row, 0]  # publish_rate
        return out


def training_batch(
    history: np.ndarray, seq_len: int, batch: int, rng: np.random.Generator
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Sample `batch` (window, next-vector) training pairs from a history
    array (as returned by TelemetryRing.history()). Returns (x, y) with
    x [batch, seq_len, N_FEATURES] and y [batch, N_FEATURES], or None if
    the history is too short for even one pair."""
    n = len(history)
    if n < seq_len + 1:
        return None
    starts = rng.integers(0, n - seq_len, size=batch)
    x = np.stack([history[s:s + seq_len] for s in starts])
    y = np.stack([history[s + seq_len] for s in starts])
    return x.astype(np.float32), y.astype(np.float32)


def normalization(history: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature (mean, std) over a history array; std floored so a
    constant feature (e.g. consumers under steady load) never divides by
    zero."""
    mean = history.mean(axis=0)
    std = np.maximum(history.std(axis=0), 1e-3)
    return mean.astype(np.float32), std.astype(np.float32)
