"""Broker entities: Message, Queue, Exchange, VHost.

Capability parity with the reference's entity actors:
- Message         <- MessageEntity (entity/MessageEntity.scala:33-200):
                     body held once, reference-counted per routed queue,
                     deleted (and removed from store) at refcount 0.
- Queue           <- QueueEntity (entity/QueueEntity.scala:34-488): ordered
                     offsets, TTL clamp min(msg, queue), unacked bookkeeping,
                     consumer registry with auto-delete, exclusive ownership,
                     lastConsumed watermark persistence.
- Exchange        <- ExchangeEntity (entity/ExchangeEntity.scala:66-410):
                     typed matcher, durable-persistence decision, auto-delete
                     on last unbind.
- VHost           <- VhostEntity (entity/VhostEntity.scala:20-131) plus the
                     per-vhost entity registries.

Architectural difference, by design: the reference delivers by *polling*
every out-active channel on a 1 microsecond tick (ServerBluePrint.scala:31-38,
FrameStage.scala:366-453). Here each queue owns an event-driven dispatch
step — enqueue/ack/consume/qos/flow events schedule one coalesced dispatch
pass on the event loop (call_soon), which round-robins eligible consumers.
No polling, no idle CPU burn, and delivery latency is one loop hop.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Optional

from .. import profile, trace
from ..amqp.properties import BasicProperties
from ..semantics.priority import PriorityFan
from ..store.api import StoredMessage
from .matchers import Matcher, matcher_for

if TYPE_CHECKING:  # pragma: no cover
    from .broker import Broker
    from .channel import Consumer, ServerChannel


log = logging.getLogger("chanamq.broker")


def now_ms() -> int:
    return int(time.time() * 1000)


class Message:
    """A message body + properties, shared (refcounted) across queues."""

    __slots__ = (
        "id", "properties", "body", "exchange", "routing_key",
        "ttl_ms", "refer_count", "persisted", "published_ns", "header_raw",
        "accounted", "paged", "exrk_raw", "trace",
    )

    def __init__(
        self,
        id: int,
        properties: BasicProperties,
        body: bytes,
        exchange: str,
        routing_key: str,
        ttl_ms: Optional[int] = None,
        header_raw: Optional[bytes] = None,
    ) -> None:
        self.id = id
        self.properties = properties
        self.body = body
        self.exchange = exchange
        self.routing_key = routing_key
        self.ttl_ms = ttl_ms
        self.refer_count = 0
        self.persisted = False
        self.published_ns = time.perf_counter_ns()
        # wire-format content-header payload; rendered lazily when absent
        # and reused for every delivery + the persisted blob
        self.header_raw = header_raw
        # body bytes counted in Broker.resident_bytes (cleared on
        # passivation / final unrefer so accounting never double-releases)
        self.accounted = False
        # blob written to the store ONLY for passivation (transient message
        # paged out under memory pressure) — deleted at refcount 0 like a
        # persisted blob, but never promised durable: no queue-log/unack
        # rows are written for it and recovery never resurrects it
        self.paged = False
        # length-prefixed exchange + routing-key wire slice (as basic.deliver
        # frames need it); captured from the publish frame when available,
        # else built lazily by the first deliver render
        self.exrk_raw: Optional[bytes] = None
        # sampled trace riding this message (chanamq_tpu/trace/); attached
        # by push_local / the data-plane handlers only when sampled
        self.trace = None

    def header_payload(self) -> bytes:
        hp = self.header_raw
        if hp is None:
            hp = self.properties.encode_header(len(self.body))
            self.header_raw = hp
        return hp

    @property
    def is_persistent(self) -> bool:
        return self.properties.delivery_mode == 2


class QueuedMessage:
    """A message's residency in one queue (offset, expiry, redelivery mark).

    body_size is recorded separately from the message so QoS accounting and
    store bookkeeping keep working while the body itself is passivated
    (paged out to the store, reference: MessageEntity.scala:168-198)."""

    __slots__ = ("message", "offset", "expire_at_ms", "redelivered",
                 "body_size", "dead", "priority")

    def __init__(
        self, message: Message, offset: int, expire_at_ms: Optional[int],
        body_size: Optional[int] = None,
    ) -> None:
        self.message = message
        self.offset = offset
        self.expire_at_ms = expire_at_ms
        self.redelivered = False
        self.body_size = len(message.body) if body_size is None else body_size
        # set when hydration finds the stored blob gone (TTL'd / deleted):
        # dispatch and pop discard dead entries
        self.dead = False
        # effective message priority (priority queues only; 0 elsewhere)
        self.priority = 0

    def is_expired(self, now: Optional[int] = None) -> bool:
        return self.expire_at_ms is not None and (now or now_ms()) >= self.expire_at_ms


class Delivery:
    """An unacked delivery: the link channel<->queue for one message."""

    __slots__ = ("queued", "queue", "channel", "consumer_tag", "delivery_tag",
                 "no_ack", "delivered_at_ms")

    def __init__(
        self,
        queued: QueuedMessage,
        queue: "Queue",
        channel: "ServerChannel",
        consumer_tag: str,
        delivery_tag: int,
        no_ack: bool,
    ) -> None:
        self.queued = queued
        self.queue = queue
        self.channel = channel
        self.consumer_tag = consumer_tag
        self.delivery_tag = delivery_tag
        self.no_ack = no_ack
        # ack-timeout clock (chana.mq.consumer.timeout; RabbitMQ's
        # consumer_timeout): a delivery unacked past the deadline closes
        # its channel so a stuck consumer can't pin messages forever
        self.delivered_at_ms = now_ms()


class Queue:
    """One message queue within a vhost."""

    # queue-type discriminant: StreamQueue (streams/queue.py) overrides to
    # True; broker paths that differ by type branch on this, not isinstance
    is_stream = False

    HYDRATE_BATCH = 128
    # resident head kept in RAM for x-queue-mode=lazy queues: exactly one
    # dispatch hydration batch, so the consumer never stalls on an empty
    # resident head (defined in terms of HYDRATE_BATCH to keep the
    # invariant under tuning)
    LAZY_RESIDENT = HYDRATE_BATCH

    def __init__(
        self,
        broker: "Broker",
        vhost: str,
        name: str,
        *,
        durable: bool = False,
        exclusive_owner: Optional[int] = None,
        auto_delete: bool = False,
        ttl_ms: Optional[int] = None,
        arguments: Optional[dict[str, Any]] = None,
    ) -> None:
        self.broker = broker
        self.vhost = vhost
        self.name = name
        self.durable = durable
        self.exclusive_owner = exclusive_owner  # connection id or None
        self.auto_delete = auto_delete
        self.ttl_ms = ttl_ms
        self.arguments = arguments or {}
        # queue-argument extensions beyond the reference (which supports
        # only x-message-ttl, QueueEntity.scala:288-297): dead-letter
        # routing, ready-backlog length/byte caps (drop-head overflow), and
        # idle auto-expiry — RabbitMQ-compatible argument names/semantics
        args = self.arguments
        self.dlx: Optional[str] = args.get("x-dead-letter-exchange")
        self.dlx_rk: Optional[str] = args.get("x-dead-letter-routing-key")
        self.max_length: Optional[int] = args.get("x-max-length")
        self.max_length_bytes: Optional[int] = args.get("x-max-length-bytes")
        self.expires_ms: Optional[int] = args.get("x-expires")
        # x-queue-mode=lazy (RabbitMQ lazy queues): page bodies out beyond
        # a small resident head instead of the broker-wide watermark —
        # maps straight onto the passivation machinery
        self.max_resident_override: Optional[int] = (
            self.LAZY_RESIDENT if args.get("x-queue-mode") == "lazy" else None)
        # x-max-priority (RabbitMQ priority queues): ready messages order by
        # (priority desc, offset) instead of plain FIFO. Because consumption
        # then leaves offset order, the lastConsumed watermark cannot prune
        # the durable queue log — settles delete their rows individually
        # (coalesced per tick) and recovery replays whatever rows remain.
        self.max_priority: Optional[int] = args.get("x-max-priority")
        self._row_del_buf: list[int] = []
        # x-single-active-consumer (RabbitMQ SAC): deliveries go only to
        # the longest-registered consumer; when it cancels or dies the
        # next registrant takes over automatically
        self.single_active = bool(args.get("x-single-active-consumer"))
        self.last_used = now_ms()
        # body bytes across READY messages (limit enforcement + gauge)
        self.ready_bytes = 0
        # monotonic per-queue counters: the telemetry sampler derives
        # per-queue publish/deliver/ack rates from their deltas
        self.n_published = 0
        self.n_delivered = 0
        self.n_acked = 0
        # whether this queue is reflected in the broker-wide entity gauges
        # (queue_depth/queue_unacked/queue_consumers); gauges_detach()
        # clears it at deletion so late settles cannot double-subtract
        self._counted = True
        # replication log when this node owns a replicated queue (bound by
        # ReplicationManager.attach); every durable store mutation below
        # mirrors itself into it so followers track exactly the rows a
        # restart of THIS node would recover
        self.repl = None  # Optional[replicate.QueueRepLog]

        # ready list: plain FIFO deque, or — when x-max-priority is set —
        # the per-priority fan (semantics/priority.py), which keeps the
        # same (priority desc, offset) iteration order with O(1) enqueue
        # and dispatch instead of ordered-insert scans
        self.messages: Any = (
            deque() if self.max_priority is None
            else PriorityFan(self.max_priority))
        self.next_offset = 1
        self.last_consumed = 0
        self.consumers: list["Consumer"] = []
        self._rr_index = 0
        # priority dispatch groups ([consumers, rotation-index] per level,
        # highest first); None = all default priority (flat RR fast path)
        self._prio_groups: Optional[list[list]] = None
        self.outstanding: dict[int, Delivery] = {}  # msg offset -> delivery
        self.had_consumer = False  # auto-delete arms only after first consumer
        self.deleted = False
        self._dispatch_scheduled = False
        # per-tick store-write coalescing (hot delivery/ack paths)
        self._wm_dirty = False  # a watermark persist is scheduled
        self._unack_del_buf: list[int] = []
        # passivation: an async head-hydration pass is in flight
        self._hydrating = False
        self._hydrate_task: Optional[asyncio.Task] = None
        # entries this queue paged out, in offset order, so a hydration
        # pass is O(batch) instead of rescanning the resident prefix of
        # self.messages; entries hydrated/dropped by other paths are
        # lazily skipped. A fanout sibling can page a shared body without
        # touching this deque — _hydrate_head falls back to a full scan
        # when the passivated head isn't covered.
        self._passivated: deque[QueuedMessage] = deque()

    # -- introspection ----------------------------------------------------

    def touch(self) -> None:
        """Mark the queue used (x-expires idle clock reset)."""
        self.last_used = now_ms()

    @property
    def message_count(self) -> int:
        self._expire_head()
        return len(self.messages)

    @property
    def consumer_count(self) -> int:
        return len(self.consumers)

    def has_exclusive_consumer(self) -> bool:
        return any(c.exclusive for c in self.consumers)

    # -- enqueue ----------------------------------------------------------

    def clamp_expiry(self, message: Message) -> Optional[int]:
        """Effective expiry = now + min(per-message TTL, queue x-message-ttl)
        (reference: QueueEntity.scala:288-297). Allocation-free: runs once
        per enqueued message."""
        mt = message.ttl_ms
        qt = self.ttl_ms
        if mt is None:
            if qt is None:
                return None
            ttl = qt
        elif qt is None or mt < qt:
            ttl = mt
        else:
            ttl = qt
        return now_ms() + ttl

    def push(self, message: Message, body_size: Optional[int] = None) -> QueuedMessage:
        # body_size is computed ONCE by the publisher and passed to every
        # routed queue: a fanout sibling may already have passivated the
        # shared body (message.body is None), so it can't be re-measured here
        qm = QueuedMessage(message, self.next_offset, self.clamp_expiry(message),
                           body_size=body_size)
        self.next_offset += 1
        if self.max_priority is None:
            self.messages.append(qm)
        else:
            # ceiling clamp (RabbitMQ: priority above x-max-priority is
            # treated as the maximum, not an error)
            qm.priority = min(message.properties.priority or 0,
                              self.max_priority)
            self.messages.append(qm)  # fan routes by qm.priority
            self.broker.metrics.semantics_priority_msgs += 1
        self.ready_bytes += qm.body_size
        self.n_published += 1
        if self._counted:
            self.broker.queue_depth += 1
        if self.durable and message.persisted:
            self.broker.store.insert_queue_msg_nowait(
                self.vhost, self.name, qm.offset, message.id,
                qm.body_size, qm.expire_at_ms,
            )
            if self.repl is not None:
                # before this call's own passivation below, so the body is
                # normally still resident; a fanout sibling may already have
                # paged it (body None) — the follower then resyncs the blob
                if trace.ACTIVE is not None and message.trace is not None:
                    t_repl = time.perf_counter_ns()
                    self.repl.enqueue(qm, message)
                    message.trace.span(
                        trace.REPLICATE_SHIP, t_repl,
                        time.perf_counter_ns(), self.broker.trace_node)
                else:
                    self.repl.enqueue(qm, message)
        # length/byte caps: drop-head overflow, dead-lettering each victim
        # (x-overflow=drop-head is the only supported policy; declare
        # rejects others). Runs before passivation so a dropped entry is
        # never paged out.
        if self.max_length is not None or self.max_length_bytes is not None:
            if self._drop_overflow(watch=qm):
                # the pushed entry itself overflowed (tiny cap): it is
                # settled, so skip passivation and just wake dispatch
                self.schedule_dispatch()
                return qm
        # deep-backlog passivation (reference: MessageEntity pages ANY
        # inactive body out — transient included — persisting it first,
        # MessageEntity.scala:171-186): beyond the per-queue resident
        # watermark, drop the body from RAM. Persistent bodies are already
        # in the store (the blob insert was enqueued at publish and rides
        # the same FIFO store queue, so hydration reads always see it);
        # transient bodies are written now, flagged paged-not-persisted so
        # no durability promise attaches and recovery never resurrects
        # them. Dispatch hydrates either kind back on demand.
        max_resident = (self.max_resident_override
                        if self.max_resident_override is not None
                        else self.broker.queue_max_resident)
        # flow stage >= 1 tightens the cap to the pressure watermark, but
        # only where passivation is enabled at all: a 0 cap is an explicit
        # operator opt-out that memory pressure must not override
        page_cap = self.broker.flow_page_resident_active
        if max_resident and page_cap and page_cap < max_resident:
            max_resident = page_cap
        if (max_resident and len(self.messages) > max_resident
                and message.body is not None):
            if not (message.persisted or message.paged):
                message.paged = True
                self.broker.store.insert_message_nowait(
                    StoredMessage(
                        id=message.id,
                        properties_raw=message.header_payload(),
                        body=message.body, exchange=message.exchange,
                        routing_key=message.routing_key,
                        refer_count=message.refer_count,
                        ttl_ms=message.ttl_ms,
                    ))
            if message.accounted:
                self.broker.account_memory(-len(message.body))
                message.accounted = False
            # only the body pages out; properties/header_raw stay so a
            # hydrated delivery needs just the blob read
            message.body = None
            self._passivated.append(qm)
            if page_cap:
                self.broker.metrics.flow_paged_bodies += 1
                self.broker.metrics.flow_paged_bytes += qm.body_size
        self.schedule_dispatch()
        return qm

    def passivate_excess(self, cap: int) -> int:
        """Stage-1 pressure actuation (Broker._sweep_loop): page every
        resident body past the pressure cap out to the store, oldest part
        of the tail first — the head stays resident so dispatch serves it
        without a hydration round-trip. Same per-entry mechanics as the
        push-path passivation above; respects a queue whose passivation
        is explicitly disabled (cap 0)."""
        if self.is_stream or cap <= 0:
            return 0
        base = (self.max_resident_override
                if self.max_resident_override is not None
                else self.broker.queue_max_resident)
        if not base:
            return 0
        cap = min(cap, base)
        if len(self.messages) <= cap:
            return 0
        broker = self.broker
        paged = 0
        for qm in itertools.islice(self.messages, cap, None):
            message = qm.message
            if message.body is None:
                continue
            if not (message.persisted or message.paged):
                message.paged = True
                broker.store.insert_message_nowait(
                    StoredMessage(
                        id=message.id,
                        properties_raw=message.header_payload(),
                        body=message.body, exchange=message.exchange,
                        routing_key=message.routing_key,
                        refer_count=message.refer_count,
                        ttl_ms=message.ttl_ms,
                    ))
            if message.accounted:
                broker.account_memory(-len(message.body))
                message.accounted = False
            message.body = None
            self._passivated.append(qm)
            paged += 1
            broker.metrics.flow_paged_bodies += 1
            broker.metrics.flow_paged_bytes += qm.body_size
        return paged

    def _requeue_priority(self, qm: QueuedMessage) -> None:
        """Requeue into (priority desc, offset asc) position. Durable
        bookkeeping: the dispatch that delivered this entry buffered a
        delete of its queue-log row — if that delete has NOT flushed yet,
        cancel it (the row is still there) instead of re-inserting behind
        it, which would let the flush erase the re-inserted row."""
        self.messages.requeue(qm)  # offset-ordered within its band
        if self.durable and qm.message.persisted:
            try:
                self._row_del_buf.remove(qm.offset)
                row_present = True
            except ValueError:
                row_present = False
            self.broker.store_bg(
                self.broker.store.delete_queue_unacks(
                    self.vhost, self.name, [qm.message.id]))
            if not row_present:
                self.broker.store_bg(
                    self.broker.store.insert_queue_msg(
                        self.vhost, self.name, qm.offset, qm.message.id,
                        qm.body_size, qm.expire_at_ms))
            if self.repl is not None:
                # row_add strictly before unack_del: the unack entry holds
                # the follower's last blob reference until the row re-lands
                if not row_present:
                    self.repl.append("row_add", {
                        "o": qm.offset, "m": qm.message.id,
                        "z": qm.body_size, "e": qm.expire_at_ms})
                self.repl.append("unack_del", {"ids": [qm.message.id]})

    def _drop_overflow(self, watch: Optional[QueuedMessage] = None) -> bool:
        """Enforce x-max-length / x-max-length-bytes by dropping from the
        head (oldest first), dead-lettering each victim (RabbitMQ
        drop-head semantics: the cap bounds READY messages). Returns True
        if `watch` (the just-pushed entry) was among the victims — identity
        is tracked explicitly because a priority insert may land anywhere,
        not just at the tail."""
        messages = self.messages
        dropped_watch = False
        while messages and (
            (self.max_length is not None and len(messages) > self.max_length)
            or (self.max_length_bytes is not None
                and self.ready_bytes > self.max_length_bytes)
        ):
            qm = messages.popleft()
            if qm is watch:
                dropped_watch = True
            self.ready_bytes -= qm.body_size
            if self._counted:
                self.broker.queue_depth -= 1
            self._advance_watermark(qm)
            self._settle_dead(qm, "maxlen")
        if self._passivated:
            self._prune_passivated()
        return dropped_watch

    def _settle_dead(self, qm: QueuedMessage, reason: str) -> None:
        """A message died in this queue (expired / rejected / overflowed):
        forward to the dead-letter exchange when configured, else release
        the reference. `is not None` matters: DLX "" (the default exchange,
        routing straight to a queue named by x-dead-letter-routing-key) is
        a legal RabbitMQ pattern."""
        if self.dlx is not None and not qm.dead:
            # settled from this queue's perspective: hydration and
            # passivated-deque pruning must skip it even while the async
            # dead-letter publish still holds the message reference
            qm.dead = True
            self.broker.dead_letter(self, qm, reason)
        else:
            self.broker.unrefer(qm.message)

    # -- dequeue / dispatch ------------------------------------------------

    def _expire_head(self) -> None:
        """Drop expired and dead (blob gone from the store) head entries."""
        now = now_ms()
        expired = False
        while self.messages and (
                self.messages[0].dead or self.messages[0].is_expired(now)):
            qm = self.messages.popleft()
            self.ready_bytes -= qm.body_size
            if self._counted:
                self.broker.queue_depth -= 1
            self._advance_watermark(qm)
            self._settle_dead(qm, "expired")
            expired = True
        if expired and self._passivated:
            # settled (expired) entries must leave the passivated deque too:
            # on a consumerless TTL'd queue nothing else ever prunes it, and
            # each retained entry pins a Message (properties + header_raw)
            # invisibly to the resident_bytes gauge
            self._prune_passivated()


    def _advance_watermark(self, qm: QueuedMessage) -> None:
        if self.max_priority is not None:
            # priority queues consume out of offset order: the watermark
            # cannot prune, so each settled entry deletes its own row
            # (coalesced into one executemany per loop tick)
            if self.durable and qm.message.persisted and not self.deleted:
                buf = self._row_del_buf
                buf.append(qm.offset)
                if len(buf) == 1:
                    asyncio.get_event_loop().call_soon(self._flush_row_deletes)
            return
        if qm.offset > self.last_consumed:
            self.last_consumed = qm.offset
            if self.durable and not self._wm_dirty:
                # coalesce: one persisted watermark write per loop tick, with
                # the value re-read at flush time (covers every advance and
                # any requeue rewind in between)
                self._wm_dirty = True
                asyncio.get_event_loop().call_soon(self._persist_watermark)

    def _flush_row_deletes(self) -> None:
        offsets, self._row_del_buf = self._row_del_buf, []
        if offsets and not self.deleted:
            self.broker.store_bg(
                self.broker.store.delete_queue_msgs_offsets(
                    self.vhost, self.name, offsets))
            if self.repl is not None:
                self.repl.append("row_del", {"offs": offsets})

    def _persist_watermark(self) -> None:
        self._wm_dirty = False
        if self.deleted:
            return
        self.broker.store_bg(
            self.broker.store.update_queue_last_consumed(
                self.vhost, self.name, self.last_consumed
            )
        )
        if self.repl is not None:
            self.repl.append("watermark", {"wm": self.last_consumed})

    def flush_store_buffers(self) -> None:
        """Flush per-tick coalescing buffers now (shutdown path)."""
        if self._wm_dirty:
            self._persist_watermark()
        self._flush_unack_deletes()
        if self._row_del_buf:
            self._flush_row_deletes()

    def schedule_dispatch(self) -> None:
        if self._dispatch_scheduled or self.deleted:
            return
        if not self.messages or not self.consumers:
            return
        self._dispatch_scheduled = True
        asyncio.get_event_loop().call_soon(self._dispatch)

    def _dispatch(self) -> None:
        """One coalesced dispatch pass: round-robin messages to eligible
        consumers until either runs out (reference's fair poll,
        AMQChannel.scala:43-48 + FrameStage.scala:380-443, turned inside out
        into an event-driven push)."""
        self._dispatch_scheduled = False
        if self.deleted:
            return
        # dispatch-pass ledger window: two stamps per coalesced pass, not
        # per delivery. The pass is ~all delivery rendering, so the same
        # window feeds both the top-level "dispatch" stage (calls=passes,
        # thread-CPU so the attribution busy-sum stays steal-proof) and
        # the fine "deliver" stage (calls=messages, so ns/calls reads
        # as us per delivered message). The pass is synchronous, so no
        # other ledger window can interleave inside it.
        prof = profile.ACTIVE
        t_pass = 0
        n_before = 0
        if prof is not None:
            t_pass = time.thread_time_ns()
            n_before = self.n_delivered
        new_unacks: list[tuple[int, int, int, Optional[int]]] = []
        messages = self.messages
        while messages and self.consumers:
            # expiry is checked on the head inline (no clock read for the
            # overwhelming TTL-less case); head checks and the pop below
            # all act on the same entry, so no re-validation is needed
            qm = messages[0]
            if qm.dead or (qm.expire_at_ms is not None
                           and qm.expire_at_ms <= now_ms()):
                self._expire_head()
                if not messages:
                    break
                qm = messages[0]
            if qm.message.body is None:
                # head is passivated: reattach bodies from the store first;
                # dispatch resumes when the hydration pass completes
                # (reference: MessageEntity.Get lazy store load,
                # MessageEntity.scala:82-102)
                self._start_hydration()
                break
            consumer = self._next_eligible_consumer(qm.body_size)
            if consumer is None:
                break
            messages.popleft()
            self.ready_bytes -= qm.body_size
            if self._counted:
                self.broker.queue_depth -= 1
            delivery = consumer.deliver(self, qm)
            self._advance_watermark(qm)
            self.n_delivered += 1
            if delivery is None:  # no_ack: consumed immediately
                self.broker.unrefer(qm.message)
            else:
                self.outstanding[qm.offset] = delivery
                if self._counted:
                    self.broker.queue_unacked += 1
                if self.durable and qm.message.persisted:
                    new_unacks.append(
                        (qm.message.id, qm.offset, qm.body_size, qm.expire_at_ms)
                    )
        if new_unacks:
            self.broker.store.insert_queue_unacks_nowait(
                self.vhost, self.name, new_unacks)
            if self.repl is not None:
                self.repl.append(
                    "unacks", {"rows": [list(r) for r in new_unacks]})
        # native batch egress: render every connection's buffered delivery
        # records now, INSIDE the dispatch ledger window, so the encode
        # cost stays attributed to dispatch/deliver (the per-connection
        # call_soon guard only catches deliveries buffered outside a
        # dispatch pass — streams, cluster stubs)
        dirty = self.broker.egress_dirty
        if dirty:
            for conn in list(dirty):
                conn.flush_egress()
            dirty.clear()
        if prof is not None:
            dt = time.thread_time_ns() - t_pass
            sns, sc = prof.stage_ns, prof.stage_calls
            sns[profile.DISPATCH] += dt
            sc[profile.DISPATCH] += 1
            delivered = self.n_delivered - n_before
            if delivered:
                sns[profile.DELIVER] += dt
                sc[profile.DELIVER] += delivered

    # -- passivation / hydration -------------------------------------------

    def _start_hydration(self) -> None:
        if self._hydrating or self.deleted:
            return
        self._hydrating = True
        self._hydrate_task = asyncio.get_event_loop().create_task(
            self._hydrate_head())

    def _prune_passivated(self) -> None:
        """Drop settled entries (hydrated / dead / final-unreferred) off the
        front of the passivated deque. basic_get hydrates bodies without
        going through _collect_hydrate_targets — without this prune a
        publish-burst → basic_get-drain cycle would retain every hydrated
        body through the deque forever, invisible to resident_bytes."""
        passivated = self._passivated
        while passivated:
            qm = passivated[0]
            if (qm.dead or qm.message.refer_count <= 0
                    or qm.message.body is not None):
                passivated.popleft()
            else:
                break

    def _collect_hydrate_targets(self) -> list[QueuedMessage]:
        """Pop the next hydration batch off the passivated deque, lazily
        discarding entries already settled by other paths (hydrated via
        basic_get, dead, purged/final-unreferred)."""
        targets: list[QueuedMessage] = []
        while self._passivated and len(targets) < self.HYDRATE_BATCH:
            qm = self._passivated[0]
            if qm.dead or qm.message.refer_count <= 0:
                self._passivated.popleft()
                continue
            if qm.message.body is not None:
                self._passivated.popleft()
                continue
            targets.append(self._passivated.popleft())
        return targets

    async def _hydrate_head(self) -> None:
        """Batch-reattach passivated bodies at the queue head from the store.
        Entries whose blob is gone (TTL'd / deleted) are marked dead and
        discarded by the next _expire_head pass."""
        failed = False
        targets: list[QueuedMessage] = []
        try:
            targets = self._collect_hydrate_targets()
            head = self.messages[0] if self.messages else None
            if (head is not None and head.message.body is None
                    and not head.dead
                    and (not targets or targets[0] is not head)):
                # the passivated head isn't covered by our own deque: a
                # fanout sibling paged the shared body out from under us
                # (entities.py push nulls message.body for every routed
                # queue). Full scan of the resident prefix — rare path.
                self._passivated.extendleft(reversed(targets))
                targets = []
                for qm in self.messages:
                    if len(targets) >= self.HYDRATE_BATCH:
                        break
                    if qm.message.body is None and not qm.dead:
                        targets.append(qm)
            if not targets:
                return
            stored = await self.broker.store.select_messages(
                [qm.message.id for qm in targets])
            if self.deleted:
                return
            for qm in targets:
                msg = qm.message
                if qm.dead or msg.refer_count <= 0:
                    # purged/expired while the read was in flight: its final
                    # unrefer already ran, so reattaching would leak the
                    # resident_bytes accounting forever
                    continue
                sm = stored.get(msg.id)
                if sm is None:
                    qm.dead = True
                elif msg.body is None:
                    msg.body = sm.body
                    if msg.header_raw is None:
                        msg.header_raw = sm.properties_raw
                    self.broker.account_memory(len(sm.body))
                    msg.accounted = True
        except Exception:
            failed = True
            # return unfinished targets so the retry pass finds them again
            # (duplicates vs fallback-scanned entries are lazily skipped
            # once hydrated)
            self._passivated.extendleft(reversed(targets))
            log.exception("hydration of queue %s failed; retrying in 1s",
                          self.name)
        finally:
            self._hydrating = False
            self._hydrate_task = None
        if failed:
            # store trouble: back off instead of dispatch->hydrate spinning
            asyncio.get_event_loop().call_later(1.0, self.schedule_dispatch)
        else:
            self.schedule_dispatch()

    def _next_eligible_consumer(self, size: int) -> Optional["Consumer"]:
        """Round-robin pick of a consumer with prefetch budget for a
        `size`-byte delivery (reference fair poll: AMQChannel.scala:43-48).
        With x-priority consumers present (RabbitMQ extension), higher
        priorities are served first while they have budget, round-robin
        within a level; the flat fast path is untouched otherwise."""
        if self.single_active:
            # SAC: one active consumer — the highest x-priority, earliest-
            # registered within that level (RabbitMQ 3.12+ activates by
            # priority); plain SAC queues use pure registration order
            if not self.consumers:
                return None
            if self._prio_groups is not None:
                consumer = self._prio_groups[0][0][0]
            else:
                consumer = self.consumers[0]
            return consumer if consumer.can_take(size) else None
        if self._prio_groups is not None:
            return self._next_by_priority(size)
        n = len(self.consumers)
        for i in range(n):
            consumer = self.consumers[(self._rr_index + i) % n]
            if consumer.can_take(size):
                self._rr_index = (self._rr_index + i + 1) % n
                return consumer
        return None

    def _next_by_priority(self, size: int) -> Optional["Consumer"]:
        """Walk priority levels high to low; round-robin WITHIN a level via
        its own rotation index (a shared index would let the top level
        reset rotation and starve lower-level siblings). The groups are
        rebuilt only on consumer add/remove, not per delivery."""
        for group in self._prio_groups:
            consumers, start = group[0], group[1]
            n = len(consumers)
            for i in range(n):
                consumer = consumers[(start + i) % n]
                if consumer.can_take(size):
                    group[1] = (start + i + 1) % n
                    return consumer
        return None

    def _rebuild_prio_groups(self) -> None:
        """Consumer set changed: rebuild the priority-ordered dispatch
        groups, or drop back to the flat fast path when every consumer is
        at default priority."""
        if not any(getattr(c, "priority", 0) for c in self.consumers):
            self._prio_groups = None
            return
        levels: dict[int, list] = {}
        for consumer in self.consumers:
            levels.setdefault(getattr(consumer, "priority", 0), []).append(
                consumer)
        self._prio_groups = [
            [levels[priority], 0] for priority in sorted(levels, reverse=True)
        ]

    # -- get (polling read) ------------------------------------------------

    async def basic_get(self) -> Optional[QueuedMessage]:
        """Pop one message, hydrating a passivated head from the store
        first (the reference Promise-latches Get on the lazy store load,
        MessageEntity.scala:82-102). The entry is CLAIMED (popped) before
        the store read so a concurrent dispatch pass can't starve the get."""
        self.last_used = now_ms()
        self._prune_passivated()
        while True:
            self._expire_head()
            if not self.messages:
                return None
            qm = self.messages.popleft()
            self.ready_bytes -= qm.body_size
            if self._counted:
                self.broker.queue_depth -= 1
            msg = qm.message
            if msg.body is None:
                try:
                    stored = await self.broker.store.select_messages([msg.id])
                except Exception:
                    self.messages.appendleft(qm)
                    self.ready_bytes += qm.body_size
                    if self._counted:
                        self.broker.queue_depth += 1
                    raise
                sm = stored.get(msg.id)
                if sm is None:  # blob gone: drop and try the next entry
                    self._advance_watermark(qm)
                    self.broker.unrefer(msg)
                    continue
                if msg.body is None:
                    msg.body = sm.body
                    if msg.header_raw is None:
                        msg.header_raw = sm.properties_raw
                    self.broker.account_memory(len(sm.body))
                    msg.accounted = True
                self._prune_passivated()  # this entry is settled now
            self._advance_watermark(qm)
            self.n_delivered += 1
            return qm

    # -- ack / requeue -----------------------------------------------------

    def note_outstanding(self, delivery: Delivery) -> None:
        """Register an out-of-dispatch delivery (basic.get) as unacked.
        Streams key this differently (cursor, offset), so callers go
        through this hook instead of writing the dict directly."""
        self.outstanding[delivery.queued.offset] = delivery
        if self._counted:
            self.broker.queue_unacked += 1

    def _settle_store(self, delivery: Delivery) -> None:
        popped = self.outstanding.pop(delivery.queued.offset, None)
        if popped is not None and self._counted:
            self.broker.queue_unacked -= 1
        if self.durable and delivery.queued.message.persisted:
            buf = self._unack_del_buf
            buf.append(delivery.queued.message.id)
            if len(buf) == 1:
                asyncio.get_event_loop().call_soon(self._flush_unack_deletes)

    def ack(self, delivery: Delivery) -> None:
        prof = profile.ACTIVE
        t_settle = time.perf_counter_ns() if prof is not None else 0
        self._settle_store(delivery)
        self.n_acked += 1
        if trace.ACTIVE is not None:
            tr = delivery.queued.message.trace
            if tr is not None:
                trace.ACTIVE.on_settle(tr, self.broker.trace_node)
        self.broker.unrefer(delivery.queued.message)
        if prof is not None:
            prof.stage_ns[profile.SETTLE] += (
                time.perf_counter_ns() - t_settle)
            prof.stage_calls[profile.SETTLE] += 1

    def _flush_unack_deletes(self) -> None:
        ids, self._unack_del_buf = self._unack_del_buf, []
        if ids and not self.deleted:
            self.broker.store_bg(
                self.broker.store.delete_queue_unacks(self.vhost, self.name, ids)
            )
            if self.repl is not None:
                self.repl.append("unack_del", {"ids": ids})

    def drop(self, delivery: Delivery) -> None:
        """Reject without requeue: same store cleanup as ack, then the
        message dead-letters (reason "rejected") when a DLX is set."""
        prof = profile.ACTIVE
        t_settle = time.perf_counter_ns() if prof is not None else 0
        self._settle_store(delivery)
        if trace.ACTIVE is not None:
            tr = delivery.queued.message.trace
            if tr is not None:
                trace.ACTIVE.on_settle(tr, self.broker.trace_node)
        self._settle_dead(delivery.queued, "rejected")
        if prof is not None:
            prof.stage_ns[profile.SETTLE] += (
                time.perf_counter_ns() - t_settle)
            prof.stage_calls[profile.SETTLE] += 1

    def requeue(self, delivery: Delivery) -> None:
        """Return an unacked message to the queue, in offset order, marked
        redelivered (reference: QueueEntity.scala:415-446)."""
        popped = self.outstanding.pop(delivery.queued.offset, None)
        if popped is not None and self._counted:
            self.broker.queue_unacked -= 1
        qm = delivery.queued
        qm.redelivered = True
        if qm.is_expired():
            if self.durable and qm.message.persisted:
                self.broker.store_bg(
                    self.broker.store.delete_queue_unacks(
                        self.vhost, self.name, [qm.message.id]
                    )
                )
                if self.repl is not None:
                    self.repl.append("unack_del", {"ids": [qm.message.id]})
            self._settle_dead(qm, "expired")
            return
        self.ready_bytes += qm.body_size
        if self._counted:
            self.broker.queue_depth += 1
        if self.max_priority is not None:
            # priority queues: back into the (priority desc, offset) order;
            # durably, the dispatch deleted this entry's row, so settle the
            # unack row and re-insert the queue-log row (FIFO store thread
            # keeps the pair ordered)
            self._requeue_priority(qm)
            self.schedule_dispatch()
            return
        # insert keeping offset order. Requeues nearly always precede the
        # whole backlog (they were at the head when delivered), so the O(1)
        # end checks cover the hot cases; the linear scan is the rare
        # interleaved-offset fallback.
        if not self.messages or qm.offset < self.messages[0].offset:
            self.messages.appendleft(qm)
        elif qm.offset > self.messages[-1].offset:
            self.messages.append(qm)
        else:
            idx = 0
            for idx, existing in enumerate(self.messages):
                if existing.offset > qm.offset:
                    break
            else:
                idx = len(self.messages)
            self.messages.insert(idx, qm)
        # rewind the watermark so recovery replays it (reference rewinds
        # lastConsumed on requeue)
        if qm.offset <= self.last_consumed:
            self.last_consumed = qm.offset - 1
            if self.durable and qm.message.persisted:
                self.broker.store_bg(
                    self.broker.store.delete_queue_unacks(
                        self.vhost, self.name, [qm.message.id]
                    )
                )
                self.broker.store_bg(
                    self.broker.store.insert_queue_msg(
                        self.vhost, self.name, qm.offset, qm.message.id,
                        qm.body_size, qm.expire_at_ms,
                    )
                )
                self.broker.store_bg(
                    self.broker.store.update_queue_last_consumed(
                        self.vhost, self.name, self.last_consumed
                    )
                )
                if self.repl is not None:
                    # row back first (keeps the blob referenced), then the
                    # unack settle, then the rewound watermark
                    self.repl.append("row_add", {
                        "o": qm.offset, "m": qm.message.id,
                        "z": qm.body_size, "e": qm.expire_at_ms})
                    self.repl.append("unack_del", {"ids": [qm.message.id]})
                    self.repl.append(
                        "watermark", {"wm": self.last_consumed})
        self.schedule_dispatch()

    # -- purge / consumers -------------------------------------------------

    def purge(self) -> int:
        self._expire_head()
        count = len(self.messages)
        for qm in self.messages:
            self._advance_watermark(qm)
            self.broker.unrefer(qm.message)
        if self._counted:
            self.broker.queue_depth -= len(self.messages)
        self.messages.clear()
        self.ready_bytes = 0
        self._passivated.clear()
        # purge_queue_msgs below supersedes any per-row deletes buffered by
        # _advance_watermark for the purged entries (priority queues)
        self._row_del_buf.clear()
        if self.durable:
            self.broker.store_bg(
                self.broker.store.purge_queue_msgs(self.vhost, self.name)
            )
            if self.repl is not None:
                self.repl.append("purge", {})
        return count

    def add_consumer(self, consumer: "Consumer") -> None:
        self.consumers.append(consumer)
        if self._counted:
            self.broker.queue_consumers += 1
        if self._prio_groups is not None or getattr(consumer, "priority", 0):
            self._rebuild_prio_groups()
        self.had_consumer = True
        self.last_used = now_ms()
        self.schedule_dispatch()

    def remove_consumer(self, consumer: "Consumer") -> bool:
        """Returns True if the queue auto-deleted as a result
        (reference: QueueEntity.scala:236-269)."""
        try:
            self.consumers.remove(consumer)
        except ValueError:
            return False
        if self._counted:
            self.broker.queue_consumers -= 1
        if self._prio_groups is not None:
            self._rebuild_prio_groups()
        if self.single_active and self.consumers:
            # SAC succession: the next-longest-registered consumer takes
            # over the backlog immediately
            self.schedule_dispatch()
        self.last_used = now_ms()
        if self.auto_delete and self.had_consumer and not self.consumers:
            return True
        return False

    def gauges_detach(self) -> None:
        """Remove this queue's contribution from the broker-wide entity
        gauges (queue/vhost deletion paths tear down messages/consumers
        directly, bypassing the incremental sites above). Idempotent: a
        settle arriving after deletion must not double-subtract."""
        if not self._counted:
            return
        self._counted = False
        broker = self.broker
        broker.queue_depth -= len(self.messages)
        broker.queue_unacked -= len(self.outstanding)
        broker.queue_consumers -= len(self.consumers)


class Exchange:
    """One exchange within a vhost."""

    def __init__(
        self,
        vhost: str,
        name: str,
        type: str,
        *,
        durable: bool = False,
        auto_delete: bool = False,
        internal: bool = False,
        arguments: Optional[dict[str, Any]] = None,
    ) -> None:
        self.vhost = vhost
        self.name = name
        self.type = type
        self.durable = durable
        self.auto_delete = auto_delete
        self.internal = internal
        self.arguments = arguments or {}
        self.matcher: Matcher = matcher_for(type)
        # exchange-to-exchange bindings (EXCEEDS the reference, which stubs
        # Exchange.Bind/Unbind with TODO logs, FrameStage.scala:1023-1027):
        # a second matcher whose "queue" targets are destination exchange
        # names. None until the first e2e bind, so the common single-hop
        # publish path pays nothing for the feature.
        self.ex_matcher: Optional[Matcher] = None
        # alternate exchange (RabbitMQ extension): messages this exchange
        # cannot route (no binding matched) fall through to the named
        # exchange instead of being dropped/returned
        alt = self.arguments.get("alternate-exchange")
        self.alternate: Optional[str] = alt if isinstance(alt, str) else None

    def ensure_ex_matcher(self) -> Matcher:
        if self.ex_matcher is None:
            self.ex_matcher = matcher_for(self.type)
        return self.ex_matcher

    def route(self, routing_key: str, headers: Optional[dict] = None) -> set[str]:
        return self.matcher.route(routing_key, headers)

    def is_unused(self) -> bool:
        return self.matcher.is_empty() and (
            self.ex_matcher is None or self.ex_matcher.is_empty())

    def equivalent(self, type: str, durable: bool, auto_delete: bool, internal: bool) -> bool:
        return (
            self.type == type.lower()
            and self.durable == durable
            and self.auto_delete == auto_delete
            and self.internal == internal
        )


class VHost:
    """A virtual host: independent namespace of exchanges and queues."""

    # Exchanges every vhost predeclares. The default "" direct exchange binds
    # every queue by its name (AMQP 0-9-1 mandated); amq.* are the standard
    # predeclared set.
    PREDECLARED: tuple[tuple[str, str], ...] = (
        ("", "direct"),
        ("amq.direct", "direct"),
        ("amq.fanout", "fanout"),
        ("amq.topic", "topic"),
        ("amq.headers", "headers"),
        ("amq.match", "headers"),
        # system exchanges (chanamq_tpu/events/): internal events and the
        # firehose tap publish here; clients may bind/consume but the
        # amq.* name guard keeps them undeclarable and undeletable
        ("amq.chanamq.event", "topic"),
        ("amq.chanamq.trace", "topic"),
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.active = True
        self.exchanges: dict[str, Exchange] = {}
        self.queues: dict[str, Queue] = {}
        for ex_name, ex_type in self.PREDECLARED:
            self.exchanges[ex_name] = Exchange(
                name, ex_name, ex_type, durable=True
            )

    def route(
        self, exchange_name: str, routing_key: str,
        headers: Optional[dict] = None,
        queue_exists: Optional[Callable[[str], bool]] = None,
    ) -> Optional[set[str]]:
        """Resolve target queue names; None when the exchange doesn't exist.

        With exchange-to-exchange bindings present, routing is a cycle-safe
        breadth-first walk of the exchange graph (RabbitMQ semantics: each
        hop re-matches the message's ORIGINAL routing key / headers against
        the next exchange's bindings; queues reached via multiple paths
        receive one copy). Exchanges without e2e bindings take the original
        single-hop path untouched."""
        exchange = self.exchanges.get(exchange_name)
        if exchange is None:
            return None
        if exchange_name == "":
            # default exchange: implicit binding queue-name == routing-key
            return {routing_key} if routing_key in self.queues else set()
        if exchange.ex_matcher is None and exchange.alternate is None:
            return exchange.route(routing_key, headers)
        # graph walk covering e2e bindings AND alternate-exchange fallback:
        # an exchange that routes the key nowhere (no queue, no e2e target)
        # hands it to its alternate; cycle-safe via the visited set
        queues: set[str] = set()
        visited: set[str] = set()
        frontier = {exchange_name}
        while frontier:
            hop: set[str] = set()
            for ex_name in frontier:
                if ex_name in visited:
                    continue
                visited.add(ex_name)
                ex = self.exchanges.get(ex_name)
                if ex is None:
                    continue  # dangling bind to a deleted exchange
                if ex.name == "":
                    # default exchange as an alternate target: implicit
                    # queue-name binding. queue_exists (broker-supplied in
                    # cluster mode) also covers remotely-owned queues that
                    # exist here only as replicated metadata.
                    if routing_key in self.queues or (
                            queue_exists is not None
                            and queue_exists(routing_key)):
                        queues.add(routing_key)
                    continue
                matched = ex.route(routing_key, headers)
                targets = (ex.ex_matcher.route(routing_key, headers)
                           if ex.ex_matcher is not None else set())
                if not matched and not targets and ex.alternate is not None:
                    hop.add(ex.alternate)
                queues |= matched
                hop |= targets
            frontier = hop
        return queues

    def drop_exchange_refs(self, name: str) -> None:
        """An exchange was deleted: remove every e2e binding that targets
        it (RabbitMQ deletes bindings on either side of a dead exchange)."""
        for exchange in self.exchanges.values():
            if exchange.ex_matcher is not None:
                exchange.ex_matcher.unbind_queue(name)
