"""Shared and key-shared consumer groups on stream queues.

Pulsar-style subscription semantics grafted onto the stream cursor
machinery: consumers that pass ``x-group: <name>`` at consume time join
ONE group cursor instead of getting a private replay cursor. The group
reads the log once and spreads records across its members:

- ``x-group-type: shared`` (default) — round-robin across members with
  available QoS credit. No ordering guarantee beyond the log itself;
  maximum drain parallelism.
- ``x-group-type: key-shared`` — each record's routing key hashes onto a
  consistent-hash ring of members, and a key STICKS to the member that
  holds its in-flight deliveries: while any delivery for key K is
  unacked, every further K record goes to (or waits for) that member.
  Per-key delivery order is therefore preserved across acks, nacks with
  requeue, and member churn; keys only migrate between members when the
  key has nothing in flight.

Progress is a single committed offset per group (the contiguous floor
below every in-flight and pending-redelivery record), persisted through
the queue's existing cursor-commit machinery under the reserved name
``%grp%<group>`` — so a group survives broker restarts and full member
churn exactly like an individual durable cursor.

Redelivery: a member leaving (cancel, channel close, connection drop)
moves its in-flight offsets into an offset-ordered redelivery heap that
is drained BEFORE the group reads new records — combined with key
stickiness this keeps per-key order intact through mid-flight
disconnects (the chaos soak asserts exactly this invariant).

Like Pulsar, an individual negative-ack redelivery (as opposed to a
member leaving) may arrive after later records already delivered to the
same member; that is the one place per-key order is relaxed.
"""

from __future__ import annotations

import hashlib
import heapq
from bisect import bisect_right
from typing import TYPE_CHECKING, Any, Optional

from ..broker.entities import QueuedMessage

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.channel import Consumer
    from .queue import StreamQueue

# committed-offset namespace for group cursors ("%" is not producible by
# client consumer tags the broker generates, and collides with nothing:
# individual cursors commit under their consumer tag, gets under "%get%")
GROUP_CURSOR_PREFIX = "%grp%"

GROUP_MODES = ("shared", "key-shared")

# virtual nodes per member on the key-shared ring: enough to keep key
# spread within a few percent of uniform at small member counts
_VNODES = 32


def validate_group_args(queue, arguments: Optional[dict]) -> Optional[str]:
    """Consume-time validation of ``x-group`` / ``x-group-type``; returns
    an error string (PRECONDITION_FAILED) or None. Called before
    ConsumeOk so a bad subscription never half-attaches."""
    args = arguments or {}
    name = args.get("x-group")
    mode = args.get("x-group-type")
    if name is None:
        if mode is not None:
            return "x-group-type requires x-group"
        return None
    if not isinstance(name, str) or not name:
        return "x-group must be a non-empty string"
    if mode is None:
        mode = "shared"
    elif mode not in GROUP_MODES:
        return f"unknown x-group-type {mode!r} (shared/key-shared)"
    existing = queue._groups.get(name)
    if existing is not None and existing.mode != mode:
        return (f"group '{name}' already exists with "
                f"x-group-type {existing.mode}")
    return None


def _ring_points(tag: str) -> list[int]:
    points = []
    for vn in range(_VNODES):
        digest = hashlib.sha1(f"{tag}#{vn}".encode()).digest()
        points.append(int.from_bytes(digest[:8], "big"))
    return points


def _key_point(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class StreamGroup:
    """One named subscription on a stream queue: a shared read position,
    its member set, in-flight tracking, and the redelivery heap."""

    __slots__ = (
        "queue", "name", "mode", "cursor_name", "members", "next",
        "skip_ts_ms", "_inflight", "_redeliver", "_redeliver_set",
        "_order", "_rr", "_key_owner", "_key_inflight", "_ring",
    )

    def __init__(self, queue: "StreamQueue", name: str, mode: str) -> None:
        self.queue = queue
        self.name = name
        self.mode = mode
        self.cursor_name = GROUP_CURSOR_PREFIX + name
        self.members: dict[str, "Consumer"] = {}
        self.next = 0  # seeded by StreamQueue.add_consumer on first join
        self.skip_ts_ms: Optional[int] = None
        # offset -> (member_tag, routing_key) for every unacked delivery
        self._inflight: dict[int, tuple[str, str]] = {}
        # offsets awaiting redelivery, drained in offset order before any
        # fresh read — the per-key-order keystone on member loss
        self._redeliver: list[int] = []
        self._redeliver_set: set[int] = set()
        # member join order (round-robin base for shared mode)
        self._order: list[str] = []
        self._rr = 0
        # key-shared state: sticky owner while the key has deliveries in
        # flight, consistent-hash ring for free keys
        self._key_owner: dict[str, str] = {}
        self._key_inflight: dict[str, int] = {}
        self._ring: list[tuple[int, str]] = []

    # -- membership --------------------------------------------------------

    def add_member(self, consumer: "Consumer") -> None:
        self.members[consumer.tag] = consumer
        self._order.append(consumer.tag)
        if self.mode == "key-shared":
            self._rebuild_ring()

    def remove_member(self, tag: str) -> None:
        """Member departed. Channel teardown requeues its unacked BEFORE
        removing consumers, so on disconnect nothing is in flight here by
        now; after a bare basic.cancel the client may still settle its
        outstanding tags, so in-flight entries are left to drain through
        the normal ack/requeue paths (keys stay stuck to the departed tag
        until then — _owner_for blocks them rather than reassigning, which
        is what preserves per-key order through a cancel)."""
        self.members.pop(tag, None)
        try:
            self._order.remove(tag)
        except ValueError:
            pass
        if self._rr >= len(self._order):
            self._rr = 0
        if self.mode == "key-shared":
            self._rebuild_ring()
        self._maybe_release_tag(tag)
        if self.members:
            self.queue.schedule_dispatch()

    def _maybe_release_tag(self, tag: str) -> None:
        """Drop the queue's tag->group settle route once a departed
        member's last in-flight delivery settles (guarded: the tag may
        have been reused by a new consumer, possibly in another group)."""
        if tag in self.members:
            return
        if any(t == tag for t, _ in self._inflight.values()):
            return
        routes = self.queue._member_groups
        if routes.get(tag) is self:
            del routes[tag]

    def _rebuild_ring(self) -> None:
        ring: list[tuple[int, str]] = []
        for tag in self.members:
            ring.extend((p, tag) for p in _ring_points(tag))
        ring.sort()
        self._ring = ring

    def _owner_for(self, key: str) -> Optional["Consumer"]:
        tag = self._key_owner.get(key)
        if tag is not None:
            # sticky while the key has in-flight deliveries; a departed
            # owner returns None → the key BLOCKS until those settle (the
            # alternative, reassigning immediately, would let a new member
            # see later records before the old one's requeue resolves)
            return self.members.get(tag)
        if not self._ring:
            return None
        points = [p for p, _ in self._ring]
        idx = bisect_right(points, _key_point(key)) % len(self._ring)
        return self.members.get(self._ring[idx][1])

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, budget: int) -> bool:
        """One pass: drain the redelivery heap in offset order, then read
        fresh records at the group position, handing each to a member. A
        record whose target member has no credit parks the whole group
        (head-of-line) — skipping past it would break per-key order and
        tear a hole in the committed floor. Returns True when the budget
        (not credit or the tail) stopped the pass."""
        queue = self.queue
        if not self.members:
            return False
        from .queue import _COMPACTED, _LOADING  # sentinels

        metrics = queue.broker.metrics
        delivered = 0
        while delivered < budget:
            if self._redeliver:
                offset = self._redeliver[0]
                redelivered = True
            else:
                if self.next < queue.first_offset:
                    self.next = queue.first_offset
                offset = self.next
                redelivered = False
            rec = queue._record_at(offset)
            if rec is _LOADING:
                break  # blob fetch kicked; resume next pass
            if rec is None or rec is _COMPACTED:
                if redelivered:
                    # retention or compaction removed the record while it
                    # waited: nothing left to redeliver
                    heapq.heappop(self._redeliver)
                    self._redeliver_set.discard(offset)
                    self._commit_floor()
                    continue
                if rec is _COMPACTED:
                    self.next = offset + 1
                    continue
                break  # log tail
            if not redelivered and self.skip_ts_ms is not None:
                if rec.ts_ms < self.skip_ts_ms:
                    self.next = offset + 1
                    continue
                self.skip_ts_ms = None
            key = rec.routing_key
            consumer = self._pick_member(key, len(rec.body))
            if consumer is None:
                break  # no credit anywhere / key owner saturated
            qm = QueuedMessage(queue._record_message(rec), rec.offset,
                               None, body_size=len(rec.body))
            qm.redelivered = redelivered
            delivery = consumer.deliver(queue, qm)
            metrics.stream_records_delivered += 1
            metrics.stream_group_deliveries += 1
            queue.n_delivered += 1
            if redelivered:
                heapq.heappop(self._redeliver)
                self._redeliver_set.discard(offset)
            else:
                self.next = offset + 1
            delivered += 1
            if delivery is None:  # no_ack member: settled at delivery
                self._commit_floor()
                queue.broker.unrefer(qm.message)
            else:
                self._inflight[offset] = (consumer.tag, key)
                if self.mode == "key-shared":
                    self._key_inflight[key] = (
                        self._key_inflight.get(key, 0) + 1)
                    self._key_owner[key] = consumer.tag
                queue.outstanding[(consumer.tag, offset)] = delivery
                if queue._counted:
                    queue.broker.queue_unacked += 1
        return delivered >= budget

    def _pick_member(self, key: str, size: int) -> Optional["Consumer"]:
        if self.mode == "key-shared":
            owner = self._owner_for(key)
            if owner is None or not owner.can_take(size):
                return None  # head-of-line: preserves per-key order
            return owner
        # shared: round-robin from the cursor, first member with credit
        n = len(self._order)
        for i in range(n):
            tag = self._order[(self._rr + i) % n]
            member = self.members.get(tag)
            if member is not None and member.can_take(size):
                self._rr = (self._rr + i + 1) % n
                return member
        return None

    # -- settlement --------------------------------------------------------

    def settle(self, offset: int) -> None:
        """ack / reject-without-requeue: the record is done; advance the
        committed floor past any contiguous completed prefix."""
        entry = self._inflight.pop(offset, None)
        if entry is not None:
            self._unstick(entry[1])
            self._maybe_release_tag(entry[0])
        self._commit_floor()

    def requeue(self, tag: str, offset: int) -> None:
        """nack-with-requeue or teardown release: back onto the heap for
        the next dispatch pass (possibly to a different member)."""
        entry = self._inflight.pop(offset, None)
        if entry is None:
            return
        self._unstick(entry[1])
        if offset not in self._redeliver_set:
            heapq.heappush(self._redeliver, offset)
            self._redeliver_set.add(offset)
        self._maybe_release_tag(entry[0])

    def _unstick(self, key: str) -> None:
        if self.mode != "key-shared":
            return
        n = self._key_inflight.get(key, 0) - 1
        if n <= 0:
            self._key_inflight.pop(key, None)
            self._key_owner.pop(key, None)  # key free: ring may reassign
        else:
            self._key_inflight[key] = n

    def _commit_floor(self) -> None:
        """Commit the offset below which everything is settled: in-flight
        and pending-redelivery records hold the floor down, so a crash or
        restart redelivers exactly the unsettled suffix."""
        floor = self.next
        if self._inflight:
            floor = min(floor, min(self._inflight))
        if self._redeliver:
            floor = min(floor, self._redeliver[0])
        if floor > 0:
            self.queue._commit(self.cursor_name, floor - 1)

    # -- introspection (admin surface) ------------------------------------

    def snapshot(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "mode": self.mode,
            "members": len(self.members),
            "next_offset": self.next,
            "committed": self.queue.committed.get(self.cursor_name),
            "inflight": len(self._inflight),
            "redeliver_pending": len(self._redeliver),
            "sticky_keys": len(self._key_owner),
        }
