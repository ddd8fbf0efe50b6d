"""Broker-native event bus + firehose tap (RabbitMQ's ``amq.rabbitmq.event``
exchange and firehose tracer, recast onto this broker's own machinery).

Every internal transition the subsystems already log — alert fire/resolve,
control decisions, lifecycle states, flow-ladder stages, chaos fault fires,
profiler slow-callback episodes, connection and queue lifecycle, shard
respawns — is additionally published as an ordinary AMQP message on the
per-vhost system topic exchange ``amq.chanamq.event``, with a structured
routing key (``alert.fired.<rule>``, ``flow.stage.<n>``, ...) and a JSON
body carrying the same payload the log line carries. Any plain AMQP client
binds a queue and consumes: the broker dogfoods its own routing, dispatch
and QoS for its own observability.

The firehose (``chana.mq.firehose.*``) is the per-message sibling: it taps
publishes and deliveries into ``amq.chanamq.trace`` with routing keys
``publish.<exchange>`` / ``deliver.<queue>``, and is gated on the flow
accountant's stage so a slow firehose consumer sheds taps instead of
building unbounded memory (tapped copies are accounted bytes like any
queue resident, so backlog pressure raises the stage, which stops taps).

Gating discipline is identical to chaos/trace/profile: module-level
``ACTIVE`` / ``FIREHOSE`` are ``None`` unless enabled, and every emit seam
costs one attribute load plus an identity check when off. With the bus on
but nothing bound, an emit is one topic-trie walk that returns empty — the
event is dropped O(1), no message object is ever built.
"""

from __future__ import annotations

from typing import Optional

from .bus import EventBus, Firehose, EVENT_EXCHANGE, TRACE_EXCHANGE  # noqa: F401

ACTIVE: Optional[EventBus] = None
FIREHOSE: Optional[Firehose] = None


def install(bus: Optional[EventBus],
            firehose: Optional[Firehose] = None) -> None:
    global ACTIVE, FIREHOSE
    ACTIVE = bus
    if firehose is not None or bus is None:
        FIREHOSE = firehose


def clear() -> None:
    global ACTIVE, FIREHOSE
    ACTIVE = None
    FIREHOSE = None


def enable_from_config(config, broker):
    """Boot-time wiring (``chana.mq.events.enabled`` /
    ``chana.mq.firehose.enabled``): build the bus and/or firehose from the
    knobs, hang the bus off the broker for introspection, install the
    module gates."""
    bus = None
    firehose = None
    if config.bool("chana.mq.events.enabled"):
        bus = EventBus(
            broker,
            vhost=config.str("chana.mq.events.vhost") or "/",
        )
        broker.events = bus
    if config.bool("chana.mq.firehose.enabled"):
        firehose = Firehose(
            broker,
            vhost=config.str("chana.mq.firehose.vhost") or "/",
            queue_filter=config.str("chana.mq.firehose.queue-filter") or "",
            tenant_filter=config.str("chana.mq.firehose.tenant") or "",
        )
    install(bus, firehose)
    return bus, firehose
