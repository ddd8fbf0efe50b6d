"""StreamQueue: an append-only log queue with non-destructive cursors.

Selected with ``x-queue-type: stream`` at declare time. Differences from
the classic `Queue` (RabbitMQ-streams semantics):

- publishes APPEND records (offset, timestamp, header+body) to an active
  in-memory segment; at a size/age threshold the segment seals and
  spills to the store as one blob (streams/segment.py);
- consumers are independent CURSORS attaching at ``x-stream-offset``
  (``first`` | ``last`` | ``next`` | absolute offset | timestamp); every
  cursor sees every record, reading through the same prefetch/QoS credit
  machinery as classic consumers;
- ack never deletes data — it COMMITS the cursor's offset, persisted
  server-side (keyed by consumer tag) so a reconnecting consumer
  resumes where it left off;
- retention is by ``x-max-length-bytes`` / ``x-max-age``, enforced as
  whole-segment truncation of the oldest sealed segments only.

The class subclasses `Queue` to share the consumer registry, exclusive
ownership, and admin surface, but replaces the ready-deque machinery
(push/dispatch/ack/requeue/get) with cursor reads over the segment log.
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import logging
from typing import TYPE_CHECKING, Any, Optional, Union

from .. import trace
from ..amqp.properties import BasicProperties
from ..amqp.value_codec import Timestamp
from ..broker.entities import Delivery, Message, Queue, QueuedMessage, now_ms
from .segment import (
    Segment, StreamRecord, pack_records, unpack_records_indexed,
)
from .groups import GROUP_CURSOR_PREFIX, validate_group_args  # noqa: F401

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker
    from ..broker.channel import Consumer
    from .groups import StreamGroup

log = logging.getLogger("chanamq.streams")

# sentinel: the record lives in an evicted sealed segment whose blob is
# being (re)loaded from the store — the cursor resumes on load completion
_LOADING = object()

# sentinel: the offset existed but key compaction (chanamq_tpu/wal/)
# dropped its record from the sealed blob — readers skip to offset+1
_COMPACTED = object()

# cursor name backing basic.get reads (shares the committed-offset table
# with consumer cursors, so gets also survive restarts)
GET_CURSOR = "%get%"

VALID_QUEUE_TYPES = ("classic", "stream")


class StreamCursor:
    """One attached consumer's read position in the log."""

    __slots__ = ("name", "consumer", "next", "skip_ts_ms")

    def __init__(self, name: str, consumer: "Consumer", next_offset: int,
                 skip_ts_ms: Optional[int] = None) -> None:
        self.name = name
        self.consumer = consumer
        self.next = next_offset  # next offset to deliver
        # timestamp attach: records older than this are skipped without
        # delivery until the first match, then the filter clears
        self.skip_ts_ms = skip_ts_ms


def parse_offset_spec(value: Any) -> tuple[str, Optional[int]]:
    """Validate + normalize an ``x-stream-offset`` consume argument.

    Returns (kind, arg): ("next"|"first"|"last", None), ("offset", n) or
    ("timestamp", epoch_ms). AMQP 'T' fields and datetimes are
    timestamps; plain ints are absolute offsets (RabbitMQ's dialect).
    Raises ValueError on anything else.
    """
    if value is None:
        return ("next", None)
    if isinstance(value, Timestamp):
        return ("timestamp", int(value) * 1000)
    if isinstance(value, _dt.datetime):
        return ("timestamp", int(value.timestamp() * 1000))
    if isinstance(value, bool):
        raise ValueError("x-stream-offset must be first/last/next, an "
                         "offset (int) or a timestamp")
    if isinstance(value, int):
        if value < 0:
            raise ValueError("x-stream-offset offset must be >= 0")
        return ("offset", value)
    if isinstance(value, str):
        if value in ("first", "last", "next"):
            return (value, None)
        raise ValueError(
            f"unknown x-stream-offset {value!r} (first/last/next)")
    raise ValueError("x-stream-offset must be first/last/next, an offset "
                     "(int) or a timestamp")


class StreamQueue(Queue):
    """Append-only segmented log queue (``x-queue-type: stream``)."""

    is_stream = True
    # {record offset: Trace} for federated records that arrived with a
    # W3C context: the federation apply populates it, the
    # first materialization of that record consumes it, so mirror-side
    # deliver/settle spans join the producer's trace. Class-level None
    # keeps the untraced dispatch path at one falsy attribute check.
    fed_traces: "dict | None" = None

    def __init__(
        self,
        broker: "Broker",
        vhost: str,
        name: str,
        *,
        durable: bool = True,
        exclusive_owner: Optional[int] = None,
        auto_delete: bool = False,
        ttl_ms: Optional[int] = None,
        arguments: Optional[dict[str, Any]] = None,
    ) -> None:
        super().__init__(
            broker, vhost, name, durable=durable,
            exclusive_owner=exclusive_owner, auto_delete=auto_delete,
            ttl_ms=ttl_ms, arguments=arguments)
        args = self.arguments
        # segment sealing thresholds: per-queue override, else broker
        # defaults (chana.mq.stream.* config block)
        self.segment_bytes: int = int(
            args.get("x-stream-max-segment-size-bytes")
            or broker.stream_segment_bytes)
        self.segment_age_ms: int = int(broker.stream_segment_age_s * 1000)
        self.max_age_ms: Optional[int] = _parse_max_age_ms(
            args.get("x-max-age"))
        # retention byte cap reuses the x-max-length-bytes argument the
        # base class already parsed (self.max_length_bytes), but enforced
        # as whole-segment truncation, never record drops
        self.delivery_batch: int = broker.stream_delivery_batch
        self.cache_segments: int = broker.stream_cache_segments

        # the log: sealed segments (ascending base offset) + active tail
        self._segments: list[Segment] = []
        self._seg_bases: list[int] = []  # parallel bisect index
        self._active: list[StreamRecord] = []
        self._active_base = self.next_offset
        self._active_bytes = 0
        self._active_first_ts: Optional[int] = None
        # cursors: live attachments by consumer tag + committed offsets
        # (committed survives detach and, durably, restarts)
        self._cursors: dict[str, StreamCursor] = {}
        self.committed: dict[str, int] = {}
        # consumer groups (x-group): shared read position per group name,
        # plus member-tag -> group for settle-path delegation
        self._groups: dict[str, "StreamGroup"] = {}
        self._member_groups: dict[str, "StreamGroup"] = {}
        self._cursor_dirty: set[str] = set()
        self._cursor_flush_scheduled = False
        # segment blob loads in flight (base offsets)
        self._loading: set[int] = set()
        # in-session basic.get read position (None = derive from committed)
        self._get_pos: Optional[int] = None
        # self.ready_bytes (inherited gauge) tracks RETAINED bytes

    # -- introspection ----------------------------------------------------

    @property
    def first_offset(self) -> int:
        """Oldest retained offset (== next_offset when the log is empty)."""
        if self._segments:
            return self._segments[0].base_offset
        return self._active_base

    @property
    def message_count(self) -> int:  # type: ignore[override]
        return self.next_offset - self.first_offset

    @property
    def retained_bytes(self) -> int:
        return self.ready_bytes

    @property
    def segment_count(self) -> int:
        """Sealed segments + the active one when it holds records."""
        return len(self._segments) + (1 if self._active else 0)

    @property
    def cache_bytes(self) -> int:
        """Resident stream bytes: the active segment plus every sealed
        segment whose record blob is cached in RAM. Polled once per broker
        sweep tick as the flow accountant's ``stream_cache`` component —
        computed, not incrementally tracked, so it can never drift from
        the seal/evict/hydrate paths it observes."""
        total = self._active_bytes
        for seg in self._segments:
            if seg.records is not None:
                total += seg.size_bytes
        return total

    def cursor_lag(self, name: str) -> int:
        """Records between a cursor's committed offset and the log tail."""
        committed = self.committed.get(name)
        floor = self.first_offset - 1
        if committed is None or committed < floor:
            committed = floor
        return max(0, (self.next_offset - 1) - committed)

    # -- append (publish) --------------------------------------------------

    def push(self, message: Message, body_size: Optional[int] = None):  # type: ignore[override]
        """Append one record to the active segment. Never drops, never
        passivates, never dead-letters: retention is the only deleter."""
        self.last_used = now_ms()
        ts = self.last_used
        body = message.body if message.body is not None else b""
        rec = StreamRecord(self.next_offset, ts, message.exchange,
                           message.routing_key, message.header_payload(),
                           body)
        self.next_offset += 1
        if not self._active:
            self._active_first_ts = ts
        self._active.append(rec)
        size = rec.wire_size
        self._active_bytes += size
        self.ready_bytes += size
        metrics = self.broker.metrics
        metrics.stream_appends += 1
        metrics.stream_append_bytes += size
        # per-queue rate counter only: a stream append never contributes to
        # the broker depth gauge (records retire by retention, not consume)
        self.n_published += 1
        if (self._active_bytes >= self.segment_bytes
                or (self.segment_age_ms
                    and ts - self._active_first_ts >= self.segment_age_ms)):
            self._seal_active()
        # the stream owns its own copy of the bytes (the record): release
        # this queue's share of the routed Message immediately
        self.broker.unrefer(message)
        self.schedule_dispatch()
        return rec

    def _seal_active(self) -> None:
        if not self._active:
            return
        records = self._active
        seg = Segment(self._active_base, records[-1].offset,
                      records[0].ts_ms, records[-1].ts_ms,
                      self._active_bytes, records)
        self._segments.append(seg)
        self._seg_bases.append(seg.base_offset)
        if self.durable and not self.deleted:
            self.broker.store_bg(self.broker.store.insert_stream_segment(
                self.vhost, self.name, seg.base_offset, seg.last_offset,
                seg.first_ts_ms, seg.last_ts_ms, seg.size_bytes,
                pack_records(records)))
        self.broker.metrics.stream_segments_sealed += 1
        self._active = []
        self._active_base = self.next_offset
        self._active_bytes = 0
        self._active_first_ts = None
        self._enforce_retention()
        self._evict_cache()
        federation = self.broker.federation
        if federation is not None:
            # sealed segments are the federation shipping unit: wake any
            # link mirroring this stream
            federation.on_seal(self)

    def _enforce_retention(self, now: Optional[int] = None) -> None:
        """Truncate whole sealed segments from the head while over the
        x-max-length-bytes cap or past x-max-age. The active segment is
        never truncated."""
        dropped: list[int] = []
        cap = self.max_length_bytes
        age = self.max_age_ms
        if age is not None and now is None:
            now = now_ms()
        while self._segments:
            seg = self._segments[0]
            if not ((cap is not None and self.ready_bytes > cap)
                    or (age is not None and seg.last_ts_ms < now - age)):
                break
            self._segments.pop(0)
            self._seg_bases.pop(0)
            self.ready_bytes -= seg.size_bytes
            dropped.append(seg.base_offset)
        if dropped:
            self.broker.metrics.stream_segments_truncated += len(dropped)
            if self.durable and not self.deleted:
                self.broker.store_bg(self.broker.store.delete_stream_segments(
                    self.vhost, self.name, dropped))

    def _evict_cache(self, keep: Optional[Segment] = None) -> None:
        """Bound resident sealed records: only the newest cache_segments
        (plus the one just loaded for a replaying cursor) stay in RAM."""
        resident = [s for s in self._segments if s.records is not None]
        excess = len(resident) - self.cache_segments
        for seg in resident:
            if excess <= 0:
                break
            if seg is keep:
                continue
            seg.records = None
            excess -= 1

    # -- record lookup -----------------------------------------------------

    def _find_segment(self, offset: int) -> Optional[Segment]:
        import bisect
        idx = bisect.bisect_right(self._seg_bases, offset) - 1
        if idx < 0:
            return None
        seg = self._segments[idx]
        return seg if offset <= seg.last_offset else None

    def _record_at(self, offset: int):
        """StreamRecord at `offset`, None when past the tail, or _LOADING
        while an evicted segment's blob is fetched from the store."""
        if offset >= self._active_base:
            idx = offset - self._active_base
            return self._active[idx] if idx < len(self._active) else None
        seg = self._find_segment(offset)
        if seg is None:
            return None  # truncated gap: caller clamps to first_offset
        if seg.records is None:
            self._start_segment_load(seg)
            return _LOADING
        rec = seg.records[offset - seg.base_offset]
        return rec if rec is not None else _COMPACTED

    def _start_segment_load(self, seg: Segment) -> None:
        if seg.base_offset in self._loading or self.deleted:
            return
        self._loading.add(seg.base_offset)
        asyncio.get_event_loop().create_task(self._load_segment(seg))

    async def _load_segment(self, seg: Segment) -> None:
        failed = False
        try:
            blob = await self.broker.store.select_stream_segment(
                self.vhost, self.name, seg.base_offset)
            if blob is not None and seg.records is None:
                seg.records = unpack_records_indexed(
                    blob, seg.base_offset, seg.last_offset)
                self._evict_cache(keep=seg)
        except Exception:
            failed = True
            log.exception("stream %s: segment %d load failed; retrying",
                          self.name, seg.base_offset)
        finally:
            self._loading.discard(seg.base_offset)
        if failed:
            asyncio.get_event_loop().call_later(1.0, self.schedule_dispatch)
        else:
            self.schedule_dispatch()

    def _record_message(self, rec: StreamRecord,
                        decode_props: bool = False) -> Message:
        """Materialize a deliverable Message from a record. refer_count=1
        so the delivery settle paths unrefer it symmetrically with classic
        queues (a no-op here: never persisted, never accounted)."""
        if decode_props:
            _, _, props = BasicProperties.decode_header(rec.header_raw)
        else:
            props = _NO_PROPS
        msg = Message(0, props, rec.body, rec.exchange, rec.routing_key,
                      header_raw=rec.header_raw)
        msg.refer_count = 1
        if self.fed_traces:
            tr = self.fed_traces.pop(rec.offset, None)
            if tr is not None:
                msg.trace = tr
        return msg

    # -- dispatch ----------------------------------------------------------

    def schedule_dispatch(self) -> None:  # type: ignore[override]
        if self._dispatch_scheduled or self.deleted:
            return
        if not self._cursors and not self._groups:
            return
        self._dispatch_scheduled = True
        asyncio.get_event_loop().call_soon(self._dispatch)

    def _dispatch(self) -> None:  # type: ignore[override]
        """One coalesced pass: every cursor reads up to delivery_batch
        records through its consumer's prefetch credit. A cursor parked on
        an evicted segment kicks an async blob load and resumes on the
        next pass."""
        self._dispatch_scheduled = False
        if self.deleted:
            return
        more = False
        metrics = self.broker.metrics
        for cursor in list(self._cursors.values()):
            consumer = cursor.consumer
            delivered = 0
            while delivered < self.delivery_batch:
                if cursor.next < self.first_offset:
                    # fell behind retention: jump to the oldest retained
                    cursor.next = self.first_offset
                rec = self._record_at(cursor.next)
                if rec is None or rec is _LOADING:
                    break
                if rec is _COMPACTED:
                    # key compaction dropped this offset from the sealed
                    # blob; the cursor walks the hole without delivering
                    cursor.next += 1
                    continue
                if cursor.skip_ts_ms is not None:
                    if rec.ts_ms < cursor.skip_ts_ms:
                        cursor.next = rec.offset + 1
                        continue
                    cursor.skip_ts_ms = None
                if not consumer.can_take(len(rec.body)):
                    break
                qm = QueuedMessage(self._record_message(rec), rec.offset,
                                   None, body_size=len(rec.body))
                delivery = consumer.deliver(self, qm)
                metrics.stream_records_delivered += 1
                self.n_delivered += 1
                cursor.next = rec.offset + 1
                delivered += 1
                if delivery is None:  # no_ack: consumed + committed now
                    self._commit(cursor.name, rec.offset)
                    self.broker.unrefer(qm.message)
                else:
                    self.outstanding[(cursor.name, rec.offset)] = delivery
                    if self._counted:
                        self.broker.queue_unacked += 1
            if delivered >= self.delivery_batch:
                more = True  # budget exhausted, not credit: keep going
        for group in list(self._groups.values()):
            if group.dispatch(self.delivery_batch):
                more = True
        if more:
            self.schedule_dispatch()

    # -- cursor commit (ack) -----------------------------------------------

    def _commit(self, name: str, offset: int) -> None:
        current = self.committed.get(name)
        if current is not None and offset <= current:
            return
        self.committed[name] = offset
        self.broker.metrics.stream_cursor_commits += 1
        federation = self.broker.federation
        if federation is not None:
            # mirror the commit so a failed-over consumer group resumes
            # contiguously on the remote cluster (coalesced per link)
            federation.on_cursor_commit(self, name, offset)
        if self.durable:
            self._cursor_dirty.add(name)
            if not self._cursor_flush_scheduled:
                # one persisted write per cursor per loop tick, value
                # re-read at flush (same coalescing as the classic
                # lastConsumed watermark)
                self._cursor_flush_scheduled = True
                asyncio.get_event_loop().call_soon(self._flush_cursors)

    def _flush_cursors(self) -> None:
        self._cursor_flush_scheduled = False
        dirty, self._cursor_dirty = self._cursor_dirty, set()
        if self.deleted:
            return
        for name in dirty:
            offset = self.committed.get(name)
            if offset is not None:
                self.broker.store_bg(self.broker.store.update_stream_cursor(
                    self.vhost, self.name, name, offset))

    def note_outstanding(self, delivery: Delivery) -> None:  # type: ignore[override]
        # two cursors can hold the SAME offset unacked simultaneously, so
        # the key is (cursor, offset), never the bare offset
        self.outstanding[
            (delivery.consumer_tag or GET_CURSOR,
             delivery.queued.offset)] = delivery
        if self._counted:
            self.broker.queue_unacked += 1

    def ack(self, delivery: Delivery) -> None:  # type: ignore[override]
        name = delivery.consumer_tag or GET_CURSOR
        popped = self.outstanding.pop((name, delivery.queued.offset), None)
        if popped is not None and self._counted:
            self.broker.queue_unacked -= 1
        self.n_acked += 1
        group = self._member_groups.get(name)
        if group is not None:
            # group member: the shared floor commits, not a private cursor
            group.settle(delivery.queued.offset)
        else:
            self._commit(name, delivery.queued.offset)
        if trace.ACTIVE is not None:
            # a federated record's lifted trace (fed_traces) finishes at
            # the consumer's settle, same as a classic queue's ack path
            tr = delivery.queued.message.trace
            if tr is not None:
                trace.ACTIVE.on_settle(tr, self.broker.trace_node)
        self.broker.unrefer(delivery.queued.message)

    def drop(self, delivery: Delivery) -> None:  # type: ignore[override]
        # reject without requeue: the cursor moves past the record (the
        # data itself is immutable; only retention deletes)
        self.ack(delivery)

    def requeue(self, delivery: Delivery) -> None:  # type: ignore[override]
        """Nack-with-requeue / channel teardown: nothing re-enters a log —
        the record stays uncommitted, and a still-attached cursor rewinds
        to redeliver it."""
        name = delivery.consumer_tag or GET_CURSOR
        popped = self.outstanding.pop((name, delivery.queued.offset), None)
        if popped is not None and self._counted:
            self.broker.queue_unacked -= 1
        group = self._member_groups.get(name)
        if group is not None:
            group.requeue(name, delivery.queued.offset)
        else:
            cursor = self._cursors.get(name)
            if cursor is not None and delivery.queued.offset < cursor.next:
                cursor.next = delivery.queued.offset
        self.broker.unrefer(delivery.queued.message)
        self.schedule_dispatch()

    # -- get (polling read) ------------------------------------------------

    async def basic_get(self) -> Optional[QueuedMessage]:  # type: ignore[override]
        """Non-destructive single read from the shared get cursor; ack
        commits it like any consumer cursor."""
        self.last_used = now_ms()
        pos = self._get_pos
        if pos is None:
            committed = self.committed.get(GET_CURSOR)
            pos = self.first_offset if committed is None else committed + 1
        while True:
            if pos < self.first_offset:
                pos = self.first_offset
            rec = self._record_at(pos)
            if rec is _LOADING:
                seg = self._find_segment(pos)
                if seg is None:
                    return None
                blob = await self.broker.store.select_stream_segment(
                    self.vhost, self.name, seg.base_offset)
                if self.deleted or blob is None:
                    return None
                if seg.records is None:
                    seg.records = unpack_records_indexed(
                        blob, seg.base_offset, seg.last_offset)
                    self._evict_cache(keep=seg)
                continue  # re-read now that the segment is resident
            if rec is _COMPACTED:
                pos += 1  # compaction hole: step to the next offset
                continue
            break
        if rec is None:
            return None
        self._get_pos = pos + 1
        self.broker.metrics.stream_records_delivered += 1
        self.n_delivered += 1
        return QueuedMessage(self._record_message(rec, decode_props=True),
                             rec.offset, None, body_size=len(rec.body))

    # -- consumers (cursor attach / detach) ----------------------------------

    def add_consumer(self, consumer: "Consumer") -> None:  # type: ignore[override]
        group_name = (consumer.arguments or {}).get("x-group")
        if group_name:
            self._join_group(consumer, group_name)
            return
        kind, arg = parse_offset_spec(
            (consumer.arguments or {}).get("x-stream-offset"))
        skip_ts: Optional[int] = None
        if kind == "first":
            start = self.first_offset
        elif kind == "last":
            # the final retained record onward
            start = max(self.first_offset, self.next_offset - 1)
        elif kind == "offset":
            start = max(arg, self.first_offset)
        elif kind == "timestamp":
            start = self._offset_for_ts(arg)
            skip_ts = arg
        else:  # "next": new records only — unless this tag committed
            # before, then resume where it left off (server-tracked cursor)
            committed = self.committed.get(consumer.tag)
            start = (self.next_offset if committed is None
                     else max(committed + 1, self.first_offset))
        self._cursors[consumer.tag] = StreamCursor(
            consumer.tag, consumer, start, skip_ts)
        super().add_consumer(consumer)

    def _join_group(self, consumer: "Consumer", group_name: str) -> None:
        """x-group consume: attach to (or create) the named group instead
        of a private cursor. Validation (mode vocabulary, mode conflicts)
        already ran in connection._on_consume before ConsumeOk."""
        from .groups import StreamGroup

        group = self._groups.get(group_name)
        if group is None:
            mode = ((consumer.arguments or {}).get("x-group-type")
                    or "shared")
            group = StreamGroup(self, group_name, mode)
            # position: a previously committed group offset wins (the
            # group resumes across restarts / full member churn); else the
            # FOUNDING member's x-stream-offset seeds it
            committed = self.committed.get(group.cursor_name)
            if committed is not None:
                group.next = max(committed + 1, self.first_offset)
            else:
                kind, arg = parse_offset_spec(
                    (consumer.arguments or {}).get("x-stream-offset"))
                if kind == "first":
                    group.next = self.first_offset
                elif kind == "last":
                    group.next = max(self.first_offset, self.next_offset - 1)
                elif kind == "offset":
                    group.next = max(arg, self.first_offset)
                elif kind == "timestamp":
                    group.next = self._offset_for_ts(arg)
                    group.skip_ts_ms = arg
                else:  # "next"
                    group.next = self.next_offset
            self._groups[group_name] = group
            self.broker.metrics.stream_groups_created += 1
        group.add_member(consumer)
        self._member_groups[consumer.tag] = group
        super().add_consumer(consumer)

    def _offset_for_ts(self, ts_ms: int) -> int:
        """First offset whose record could be >= ts_ms, by segment
        metadata; the cursor's skip filter does the exact record match."""
        for seg in self._segments:
            if seg.last_ts_ms >= ts_ms:
                return seg.base_offset
        return self._active_base

    def remove_consumer(self, consumer: "Consumer") -> bool:  # type: ignore[override]
        group = self._member_groups.get(consumer.tag)
        if group is not None and group.members.get(consumer.tag) is consumer:
            group.remove_member(consumer.tag)
        cursor = self._cursors.get(consumer.tag)
        if cursor is not None and cursor.consumer is consumer:
            del self._cursors[consumer.tag]
        return super().remove_consumer(consumer)

    # -- maintenance (sweep / purge / shutdown / recovery) -------------------

    def _expire_head(self) -> None:  # type: ignore[override]
        """Per-sweep-tick hook: age-seal a quiet active segment and apply
        age retention (size retention runs inline on seal)."""
        now = now_ms()
        if (self._active and self.segment_age_ms
                and self._active_first_ts is not None
                and now - self._active_first_ts >= self.segment_age_ms):
            self._seal_active()
        elif self.max_age_ms is not None:
            self._enforce_retention(now)

    def purge(self) -> int:  # type: ignore[override]
        """queue.purge on a stream: truncate ALL sealed segments and the
        active one. Offsets keep counting; cursors clamp forward."""
        count = self.message_count
        dropped = self._seg_bases[:]
        self._segments.clear()
        self._seg_bases.clear()
        self._active = []
        self._active_base = self.next_offset
        self._active_bytes = 0
        self._active_first_ts = None
        self.ready_bytes = 0
        if dropped:
            self.broker.metrics.stream_segments_truncated += len(dropped)
            if self.durable and not self.deleted:
                self.broker.store_bg(self.broker.store.delete_stream_segments(
                    self.vhost, self.name, dropped))
        return count

    def flush_store_buffers(self) -> None:  # type: ignore[override]
        """Shutdown path: seal + spill the active segment and flush dirty
        cursor commits, so a clean restart retains every appended record."""
        if self._active:
            self._seal_active()
        if self._cursor_dirty:
            self._flush_cursors()

    def restore_segments(
        self, metas: list[tuple[int, int, int, int, int]]
    ) -> None:
        """Recovery: rebuild the sealed-segment index from store metadata
        (blobs stay on disk until a cursor reads into them)."""
        for base, last, first_ts, last_ts, size in metas:
            self._segments.append(
                Segment(base, last, first_ts, last_ts, size))
            self._seg_bases.append(base)
            self.ready_bytes += size
            if last >= self.next_offset:
                self.next_offset = last + 1
        self._active_base = self.next_offset
        self._enforce_retention()


_NO_PROPS = BasicProperties()


def _parse_max_age_ms(value: Any) -> Optional[int]:
    """x-max-age: a duration string ("7d", "12h", "30s", "500ms") or a
    number of seconds. Returns milliseconds, or None when unset.
    Raises ValueError on garbage (declare validation surfaces it)."""
    if value is None:
        return None
    if isinstance(value, bool):
        raise ValueError("x-max-age must be a duration")
    if isinstance(value, (int, float)):
        if value <= 0:
            raise ValueError("x-max-age must be positive")
        return int(value * 1000)
    if isinstance(value, str):
        from ..config import parse_duration_s
        seconds = parse_duration_s(value)
        if seconds is None or seconds <= 0:
            raise ValueError(f"bad x-max-age duration {value!r}")
        return int(seconds * 1000)
    raise ValueError("x-max-age must be a duration")
