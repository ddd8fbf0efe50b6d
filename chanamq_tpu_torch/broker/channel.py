"""Server-side channel state: consumers, delivery tags, prefetch, confirms.

Capability parity with the reference's AMQChannel
(chana-mq-base .../model/AMQChannel.scala:16-182): per-channel mode
(normal/transaction/confirm), consumer registry with round-robin fairness,
monotonically increasing delivery tags, unacked maps, prefetch count/size
with global-vs-per-consumer accounting, confirm sequence counter — plus the
delivery rendering that the reference's FrameStage did inline
(FrameStage.scala:411-443).
"""

from __future__ import annotations

import enum
import struct
import time
from typing import TYPE_CHECKING, Any, Optional

from .. import events, trace
from ..amqp.command import AMQCommand
from ..amqp.constants import FRAME_OVERHEAD
from ..amqp.methods import Basic
from .entities import Delivery, Queue, QueuedMessage

if TYPE_CHECKING:  # pragma: no cover
    from .connection import AMQPConnection

_FRAME_HDR = struct.Struct(">BHI").pack


class ChannelMode(enum.Enum):
    NORMAL = "normal"
    CONFIRM = "confirm"
    TX = "tx"


class Consumer:
    """One basic.consume subscription."""

    __slots__ = (
        "tag", "channel", "queue", "no_ack", "exclusive", "arguments",
        "priority", "unacked_count", "unacked_size", "buffered_bytes",
        "slow", "_deliver_prefix",
    )

    def __init__(
        self,
        tag: str,
        channel: "ServerChannel",
        queue: Queue,
        no_ack: bool,
        exclusive: bool,
        arguments: Optional[dict[str, Any]] = None,
    ) -> None:
        self.tag = tag
        self.channel = channel
        self.queue = queue
        self.no_ack = no_ack
        self.exclusive = exclusive
        self.arguments = arguments or {}
        # consumer priority (RabbitMQ x-priority consume argument, default
        # 0; higher is served first while it has prefetch budget — an
        # extension the reference lacks)
        self.priority = int(self.arguments.get("x-priority") or 0)
        self.unacked_count = 0
        self.unacked_size = 0
        # bounded delivery buffer (chana.mq.flow.consumer-buffer): body
        # bytes rendered to the connection's output buffer since it last
        # fully drained to the kernel; `slow` marks a consumer currently
        # over the bound (detected once per episode, see can_take)
        self.buffered_bytes = 0
        self.slow = False
        # precomputed basic.deliver method-payload prefix:
        # class 60, method 60, shortstr consumer-tag
        tag_b = tag.encode("utf-8")
        self._deliver_prefix = b"\x00\x3c\x00\x3c" + bytes((len(tag_b),)) + tag_b

    def deliver(self, queue: Queue, qm: QueuedMessage) -> Optional[Delivery]:
        """Dispatch hook: render to this consumer's channel. The cluster
        layer's RemoteConsumer overrides this to ship over RPC instead."""
        return self.channel.deliver(self, queue, qm)

    def detach(self) -> None:
        """Called when the queue is deleted under this consumer: deregister
        and notify the client with a server-sent Basic.Cancel if it asked
        for consumer_cancel_notify."""
        self.channel.consumers.pop(self.tag, None)
        self.channel.connection.notify_consumer_cancel(self.channel, self.tag)

    def can_take(self, next_size: int) -> bool:
        """Unified consumer-credit admission (reference:
        FrameStage.scala:387-392 + QueueEntity.scala:342-359): every
        delivery passes the same ordered budget checks — channel flow,
        connection write saturation, the per-consumer bounded delivery
        buffer (slow-consumer detection), then the basic.qos prefetch
        count/size budgets (per-consumer and channel-global, with
        RabbitMQ's let-one-oversized-through-when-empty size semantics).
        no_ack consumers skip only the prefetch budgets — the buffer bound
        still applies (they are exactly the consumers that can otherwise
        buffer without limit)."""
        ch = self.channel
        if not ch.flow_active or ch.closed:
            return False
        if ch.connection.write_saturated:
            return False
        limit = ch.connection.broker.flow_consumer_buffer
        if limit and self.buffered_bytes + next_size > limit:
            if self.buffered_bytes > 0:
                if not self.slow:
                    # one detection per episode; cleared when the
                    # connection's output buffer drains to the kernel
                    self.slow = True
                    ch.connection.broker.metrics.flow_slow_consumers += 1
                return False
        if self.no_ack:
            return True
        if ch.prefetch_count_consumer and self.unacked_count >= ch.prefetch_count_consumer:
            return False
        if ch.prefetch_size_consumer and self.unacked_size + next_size > ch.prefetch_size_consumer:
            if self.unacked_count > 0:
                return False
        if ch.prefetch_count_global and ch.total_unacked_count() >= ch.prefetch_count_global:
            return False
        if ch.prefetch_size_global and ch.total_unacked_size() + next_size > ch.prefetch_size_global:
            if ch.total_unacked_count() > 0:
                return False
        return True


class ServerChannel:
    """Per-channel broker state on one connection."""

    def __init__(self, connection: "AMQPConnection", channel_id: int) -> None:
        self.connection = connection
        self.id = channel_id
        self.mode = ChannelMode.NORMAL
        self.flow_active = True
        self.closed = False

        self.consumers: dict[str, Consumer] = {}
        self._delivery_tag = 0
        self.unacked: dict[int, Delivery] = {}  # delivery tag -> delivery

        # qos: global_=False applies to consumers started afterwards
        # (per-consumer budget); global_=True is shared across the channel.
        self.prefetch_count_consumer = 0
        self.prefetch_size_consumer = 0
        self.prefetch_count_global = 0
        self.prefetch_size_global = 0

        # confirm mode
        self.publish_seq = 0  # next publish's confirm seq (1-based when armed)

        # tx mode (reference stubs tx.* with TODO logs,
        # FrameStage.scala:1261-1272 — implemented here): ordered buffer of
        # ("publish", AMQCommand) and ("ack"|"requeue"|"drop", Delivery)
        # entries replayed at tx.commit, discarded at tx.rollback. Settle
        # entries hold deliveries REMOVED from `unacked` (so a double-settle
        # inside one tx still raises PRECONDITION_FAILED) with their QoS
        # budget still held until the commit applies them — tx_held_count/
        # size keep the channel-global prefetch math honest while the
        # deliveries are parked outside the unacked dict. tx_bytes tracks
        # buffered publish bodies for the broker memory gate.
        self.tx_ops: list = []
        self.tx_bytes = 0
        self.tx_held_count = 0
        self.tx_held_size = 0

    # -- qos accounting ----------------------------------------------------

    def total_unacked_count(self) -> int:
        return len(self.unacked) + self.tx_held_count

    def total_unacked_size(self) -> int:
        return (sum(d.queued.body_size for d in self.unacked.values())
                + self.tx_held_size)

    def set_qos(self, prefetch_size: int, prefetch_count: int, global_: bool) -> None:
        if global_:
            self.prefetch_count_global = prefetch_count
            self.prefetch_size_global = prefetch_size
        else:
            self.prefetch_count_consumer = prefetch_count
            self.prefetch_size_consumer = prefetch_size
        for consumer in self.consumers.values():
            consumer.queue.schedule_dispatch()

    # -- delivery ----------------------------------------------------------

    def next_delivery_tag(self) -> int:
        self._delivery_tag += 1
        return self._delivery_tag

    def has_delivery_older_than(self, cutoff_ms: int) -> bool:
        """Ack-timeout probe: any outstanding delivery older than the
        cutoff — including settles parked inside an uncommitted tx (they
        left `unacked` but still pin the message and its QoS budget)."""
        for delivery in self.unacked.values():
            if delivery.delivered_at_ms < cutoff_ms:
                return True
        for op in self.tx_ops:
            if op[0] != "publish" and op[1].delivered_at_ms < cutoff_ms:
                return True
        return False

    def tag_was_issued(self, tag: int) -> bool:
        """Whether this delivery tag was ever issued on the channel (ack/nack
        validation: an above-range tag is unknown even with multiple=true)."""
        return 0 < tag <= self._delivery_tag

    def deliver(
        self, consumer: Consumer, queue: Queue, qm: QueuedMessage
    ) -> Optional[Delivery]:
        """Render basic.deliver to the connection buffer. Returns the
        Delivery for acked consumers, None for no_ack (nothing outstanding).

        Hot loop: the frames are hand-assembled (the reference renders in
        FrameStage.scala:411-443) — per-consumer constant method prefix,
        cached wire-format content header (Message.header_payload), one
        buffer append for the whole delivery."""
        tag = self.next_delivery_tag()
        msg = qm.message
        body = msg.body
        tr = None
        if trace.ACTIVE is not None:
            tr = msg.trace
            if tr is not None:
                t_del = time.perf_counter_ns()
        conn = self.connection
        if conn._egress is not None:
            # native batch egress: buffer the record, render the whole
            # dispatch pass in one chana_encode_deliveries call at the
            # flush point (connection.flush_egress)
            exrk = msg.exrk_raw
            if exrk is None:
                ex = msg.exchange.encode("utf-8")
                rk = msg.routing_key.encode("utf-8")
                exrk = msg.exrk_raw = (
                    bytes((len(ex),)) + ex + bytes((len(rk),)) + rk)
            conn.egress_deliver(
                self.id, consumer._deliver_prefix, tag, qm.redelivered,
                exrk, msg.header_payload(), body)
        else:
            conn.send_bytes(
                self._render_deliver(consumer, tag, qm.redelivered, msg, body))
        conn.delivered_msgs += 1
        if self.connection.broker.flow_consumer_buffer:
            consumer.buffered_bytes += len(body)
        metrics = self.connection.broker.metrics
        metrics.delivered(len(body))
        us = (time.perf_counter_ns() - msg.published_ns) / 1000.0
        metrics.publish_to_deliver_us.observe_us(us)
        tenant = self.connection.tenant
        if tenant is not None and tenant.latency_hist is not None:
            # per-tenant publish->deliver histogram: allocated only when a
            # delivery-latency SLO targets the tenant (tenancy/registry.py)
            tenant.latency_hist.observe_us(us)
        if tr is not None:
            tr.span(trace.DELIVER, t_del, time.perf_counter_ns(),
                    self.connection.broker.trace_node)
        fh = events.FIREHOSE
        if fh is not None and fh.tap_bindings:
            fh.tap_deliver(queue.name, msg.exchange, msg.routing_key, body,
                           queue.vhost)
        if consumer.no_ack:
            if tr is not None:
                # no-ack settles at delivery (AMQP 0-9-1 semantics)
                trace.ACTIVE.on_settle(tr, self.connection.broker.trace_node)
            return None
        delivery = Delivery(qm, queue, self, consumer.tag, tag, no_ack=False)
        self.unacked[tag] = delivery
        consumer.unacked_count += 1
        consumer.unacked_size += len(body)
        return delivery

    def _render_deliver(
        self, consumer: Consumer, tag: int, redelivered: bool, msg, body: bytes
    ) -> bytes:
        # length-prefixed exchange+routing-key: captured verbatim from the
        # publish frame when possible, else built once and cached
        exrk = msg.exrk_raw
        if exrk is None:
            ex = msg.exchange.encode("utf-8")
            rk = msg.routing_key.encode("utf-8")
            exrk = msg.exrk_raw = (
                bytes((len(ex),)) + ex + bytes((len(rk),)) + rk)
        method_payload = b"".join((
            consumer._deliver_prefix,
            tag.to_bytes(8, "big"),
            b"\x01" if redelivered else b"\x00",
            exrk,
        ))
        header_payload = msg.header_payload()
        cid = self.id
        parts = [
            _FRAME_HDR(1, cid, len(method_payload)), method_payload, b"\xce",
            _FRAME_HDR(2, cid, len(header_payload)), header_payload, b"\xce",
        ]
        if body:
            frame_max = self.connection.frame_max
            max_payload = (frame_max - FRAME_OVERHEAD) if frame_max else len(body)
            if len(body) <= max_payload:
                parts += (_FRAME_HDR(3, cid, len(body)), body, b"\xce")
            else:
                for off in range(0, len(body), max_payload):
                    chunk = body[off:off + max_payload]
                    parts += (_FRAME_HDR(3, cid, len(chunk)), chunk, b"\xce")
        return b"".join(parts)

    def redeliver(self, delivery: Delivery) -> None:
        """basic.recover(requeue=false): resend an unacked delivery on the
        same channel with the same tag, redelivered=true
        (reference: FrameStage.scala:711-776)."""
        msg = delivery.queued.message
        delivery.queued.redelivered = True
        self.connection.send_command(
            AMQCommand(
                self.id,
                Basic.Deliver(
                    consumer_tag=delivery.consumer_tag,
                    delivery_tag=delivery.delivery_tag,
                    redelivered=True,
                    exchange=msg.exchange,
                    routing_key=msg.routing_key,
                ),
                msg.properties,
                msg.body,
                header_raw=msg.header_raw,
            )
        )
        self.connection.broker.metrics.delivered(len(msg.body))

    def _release_budget(self, delivery: Delivery) -> None:
        consumer = self.consumers.get(delivery.consumer_tag)
        if consumer is not None:
            consumer.unacked_count = max(0, consumer.unacked_count - 1)
            consumer.unacked_size = max(
                0, consumer.unacked_size - delivery.queued.body_size
            )

    # -- ack paths ---------------------------------------------------------

    def resolve_tags(self, delivery_tag: int, multiple: bool) -> list[Delivery]:
        """Tags covered by an ack/nack (reference: AMQChannel.scala:161-174
        getMultipleTagsTill). delivery_tag=0 with multiple means 'all'."""
        if multiple:
            if delivery_tag == 0:
                tags = sorted(self.unacked)
            else:
                tags = sorted(t for t in self.unacked if t <= delivery_tag)
        else:
            tags = [delivery_tag] if delivery_tag in self.unacked else []
        return [self.unacked[t] for t in tags]

    def ack(self, delivery: Delivery) -> None:
        self.unacked.pop(delivery.delivery_tag, None)
        self._release_budget(delivery)
        self.connection.acked_msgs += 1
        delivery.queue.ack(delivery)
        delivery.queue.schedule_dispatch()

    def requeue(self, delivery: Delivery) -> None:
        self.unacked.pop(delivery.delivery_tag, None)
        self._release_budget(delivery)
        delivery.queue.requeue(delivery)

    # -- tx buffering ------------------------------------------------------

    def tx_stash_settle(self, kind: str, delivery: Delivery) -> None:
        """Park a validated ack/nack/reject resolution until tx.commit: the
        delivery leaves `unacked` (a second settle of the same tag inside
        the tx raises like a double-ack would) but its QoS budget stays
        held via tx_held_count/size until the commit applies it."""
        self.unacked.pop(delivery.delivery_tag, None)
        self.tx_ops.append((kind, delivery))
        self.tx_held_count += 1
        self.tx_held_size += delivery.queued.body_size

    def tx_release_held(self, delivery: Delivery) -> None:
        """Commit is applying this parked settle: drop it from the held-
        budget counters (ack/requeue/drop then release the rest)."""
        self.tx_held_count -= 1
        self.tx_held_size -= delivery.queued.body_size

    def tx_restore_settles(self, ops: list) -> None:
        """Return parked settles to the unacked set (rollback / implicit
        rollback / partial-commit failure): the acks are discarded and the
        deliveries are outstanding again, NOT redelivered (per 0-9-1, a
        client wanting redelivery issues basic.recover)."""
        for op in ops:
            if op[0] != "publish":
                delivery = op[1]
                self.tx_release_held(delivery)
                self.unacked[delivery.delivery_tag] = delivery

    def tx_rollback(self) -> None:
        """Discard the buffered transaction: publishes vanish (with their
        memory-gauge accounting), parked settles return to unacked. Shared
        by tx.rollback and the implicit rollback on channel close."""
        ops, self.tx_ops = self.tx_ops, []
        if self.tx_bytes:
            self.connection.broker.account_memory(-self.tx_bytes)
            self.tx_bytes = 0
        self.tx_restore_settles(ops)

    def drop(self, delivery: Delivery) -> None:
        self.unacked.pop(delivery.delivery_tag, None)
        self._release_budget(delivery)
        delivery.queue.drop(delivery)
        delivery.queue.schedule_dispatch()

    # -- teardown ----------------------------------------------------------

    def release_all(self) -> None:
        """On channel close: requeue every unacked delivery and detach all
        consumers (reference: FrameStage.scala:144-153 semantics). An open
        transaction implicitly rolls back: buffered publishes are dropped
        (with their memory accounting) and tx-held deliveries requeue like
        any other unacked delivery."""
        self.closed = True
        self.tx_rollback()
        # highest tag first: each requeue then lands at the queue head via
        # the O(1) appendleft fast path instead of a linear insert scan
        for tag in sorted(self.unacked, reverse=True):
            delivery = self.unacked.pop(tag)
            self._release_budget(delivery)
            delivery.queue.requeue(delivery)
        for consumer in list(self.consumers.values()):
            self.consumers.pop(consumer.tag, None)
            auto_deleted = consumer.queue.remove_consumer(consumer)
            if auto_deleted:
                self.connection.broker.schedule_queue_delete(
                    self.connection.vhost_name, consumer.queue.name
                )
