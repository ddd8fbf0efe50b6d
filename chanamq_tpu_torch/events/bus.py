"""EventBus and Firehose: internal transitions as real AMQP messages.

Both publish through ``Broker.push_local`` — the same single local-enqueue
block every client publish already flows through — so delivered events ride
the ordinary dispatch/QoS/credit machinery and cost nothing special. The
system exchanges they publish into (``amq.chanamq.event`` and
``amq.chanamq.trace``) are part of every vhost's predeclared set
(broker/entities.py VHost.PREDECLARED); the existing ``amq.*`` name guard
makes them undeclarable and undeletable by clients, while binding to them
is ordinary Queue.Bind.

Determinism: the bus assigns a per-bus monotonically increasing ``seq`` and
stamps the emitting node, so two same-seed soak runs produce identical
event sequences once wall-clock ``ts`` fields are masked (the same
"deterministic mod timestamps" bar the chaos plan and decision logs set).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from typing import Optional

from ..amqp.properties import BasicProperties

log = logging.getLogger("chanamq.events")

EVENT_EXCHANGE = "amq.chanamq.event"
TRACE_EXCHANGE = "amq.chanamq.trace"


class EventBus:
    """Publishes internal events into the ``amq.chanamq.event`` exchange.

    ``emit`` is synchronous and cheap: one topic-trie walk; when nothing is
    bound the event is counted dropped and no allocation happens. Hook
    sites are all off the per-message hot path (alert ticks, control
    decisions, stage transitions, ...), so emitting inline keeps ordering
    exact without a flush task.
    """

    def __init__(self, broker, vhost: str = "/") -> None:
        self.broker = broker
        self.vhost = vhost
        self.seq = 0
        # loop captured for emit_threadsafe (the profiler's sampler thread
        # reports slow callbacks from off-loop); None until a loop exists
        try:
            self._loop: Optional[asyncio.AbstractEventLoop] = (
                asyncio.get_event_loop())
        except RuntimeError:
            self._loop = None
        self._loop_thread = threading.get_ident()

    # -- emission ----------------------------------------------------------

    def emit(self, routing_key: str, payload: dict,
             vhost_name: Optional[str] = None) -> bool:
        """Publish one event. Returns True iff it reached >= 1 queue."""
        broker = self.broker
        metrics = broker.metrics
        try:
            vhost = broker.vhosts.get(vhost_name or self.vhost)
            if vhost is None:
                metrics.events_dropped_total += 1
                return False
            exchange = vhost.exchanges.get(EVENT_EXCHANGE)
            if exchange is None:
                metrics.events_dropped_total += 1
                return False
            names = exchange.matcher.route(routing_key)
            # tenant-scoped subscriptions: when the event's vhost belongs
            # to a tenant, the same event ALSO routes under
            # tenant.<name>.<key> — one extra trie walk, only for events
            # carrying a tenant-owned vhost, and only when tenancy is on
            tenant = None
            registry = getattr(broker, "tenancy", None)
            if registry is not None:
                tenant = registry.tenant_of_vhost(payload.get("vhost"))
                if tenant is not None:
                    names = names | exchange.matcher.route(
                        f"tenant.{tenant}.{routing_key}")
            queues = [vhost.queues[n] for n in names if n in vhost.queues]
            if not queues:
                # nothing bound (or bound queues not local): O(1) drop —
                # no body built, no Message allocated
                metrics.events_dropped_total += 1
                return False
            self.seq += 1
            # envelope fields win over payload keys of the same name (an
            # alert payload carries its own "event": fired/resolved)
            envelope = {**payload, "event": routing_key,
                        "node": broker.trace_node,
                        "seq": self.seq, "ts": round(time.time(), 3)}
            if tenant is not None:
                envelope["tenant"] = tenant
            body = json.dumps(
                envelope,
                separators=(",", ":"), sort_keys=True, default=str,
            ).encode()
            props = BasicProperties(
                content_type="application/json", delivery_mode=1,
                app_id="chanamq.events")
            broker.push_local(
                queues, props, body, EVENT_EXCHANGE, routing_key, None, None)
            metrics.events_published_total += 1
            return True
        except Exception:
            # an observability seam must never take down the subsystem it
            # observes; count it and move on
            metrics.events_dropped_total += 1
            log.debug("event emit failed for %s", routing_key, exc_info=True)
            return False

    def emit_threadsafe(self, routing_key: str, payload: dict) -> None:
        """Emit from a non-loop thread (profiler sampler): hop onto the
        loop so queue state is only ever touched from the loop thread."""
        if threading.get_ident() == self._loop_thread or self._loop is None:
            self.emit(routing_key, payload)
            return
        try:
            self._loop.call_soon_threadsafe(self.emit, routing_key, payload)
        except RuntimeError:
            pass  # loop already closed: shutdown race, drop silently

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        m = self.broker.metrics
        return {
            "vhost": self.vhost,
            "exchange": EVENT_EXCHANGE,
            "seq": self.seq,
            "published": m.events_published_total,
            "dropped": m.events_dropped_total,
        }


class Firehose:
    """Per-message tap: publishes/deliveries republished into
    ``amq.chanamq.trace``.

    Exclusions and bounds:

    - messages whose source exchange is ``amq.chanamq.*`` are never tapped
      (the firehose cannot tap its own output or the event bus — no
      recursion);
    - taps stop the moment the flow accountant leaves stage 0: a slow
      firehose consumer grows its queue, the accounted bytes raise the
      stage, and the tap sheds instead of compounding the pressure;
    - ``queue_filter`` (a queue-name prefix) narrows the tap to matching
      queues.
    """

    def __init__(self, broker, vhost: str = "/",
                 queue_filter: str = "", tenant_filter: str = "") -> None:
        self.broker = broker
        self.vhost = vhost
        self.queue_filter = queue_filter
        # chana.mq.firehose.tenant: narrow the tap to traffic on vhosts
        # owned by one tenant (resolved live against broker.tenancy, so
        # runtime tenant changes apply to the next tap)
        self.tenant_filter = tenant_filter
        # ``tap_bindings`` is the hot-path gate both seams read before
        # calling into the firehose at all: the trace exchange matcher's
        # live binding table (identity-stable, mutated in place), so an
        # enabled-but-unconsumed firehose costs one attribute load plus a
        # dict bool test per seam — no method call, no allocation, no trie
        # walk. Falsy (or None when the vhost doesn't exist yet) = no tap.
        self.tap_bindings: "dict | None" = None
        self.refresh()

    def refresh(self) -> None:
        """(Re)resolve the trace exchange's binding table. Called at
        construction and whenever the target vhost is created or deleted
        (a recreated vhost gets a fresh matcher object, so the cached
        table would otherwise go stale)."""
        vhost = self.broker.vhosts.get(self.vhost)
        exchange = vhost.exchanges.get(TRACE_EXCHANGE) if vhost else None
        self.tap_bindings = (
            exchange.matcher.binding_table if exchange is not None else None)

    def _tap(self, routing_key: str, body: bytes, headers: dict) -> None:
        broker = self.broker
        metrics = broker.metrics
        flow = broker.flow
        if flow is not None and flow.stage > 0:
            metrics.firehose_dropped_total += 1
            return
        vhost = broker.vhosts.get(self.vhost)
        if vhost is None:
            return
        exchange = vhost.exchanges.get(TRACE_EXCHANGE)
        if exchange is None:
            return
        names = exchange.matcher.route(routing_key)
        queues = [vhost.queues[n] for n in names if n in vhost.queues]
        if not queues:
            metrics.firehose_dropped_total += 1
            return
        try:
            props = BasicProperties(
                headers=headers, delivery_mode=1, app_id="chanamq.firehose")
            broker.push_local(
                queues, props, body, TRACE_EXCHANGE, routing_key, None, None)
            metrics.firehose_published_total += 1
        except Exception:
            metrics.firehose_dropped_total += 1
            log.debug("firehose tap failed for %s", routing_key,
                      exc_info=True)

    def _tenant_owns(self, vhost_name: str) -> bool:
        registry = getattr(self.broker, "tenancy", None)
        return (registry is not None
                and registry.tenant_of_vhost(vhost_name)
                == self.tenant_filter)

    def tap_publish(self, exchange_name: str, routing_key: str,
                    body: bytes, queues: list) -> None:
        """Called from Broker.push_local after the normal enqueues (only
        when ``tap_bindings`` is truthy — the seam checks)."""
        if exchange_name.startswith("amq.chanamq."):
            return
        if self.queue_filter and not any(
                q.name.startswith(self.queue_filter) for q in queues):
            return
        if self.tenant_filter and not (
                queues and self._tenant_owns(queues[0].vhost)):
            # push_local enqueues within one vhost: the first queue's
            # vhost is the publish's vhost
            return
        key = f"publish.{exchange_name}" if exchange_name else "publish"
        self._tap(key, body, {
            "exchange": exchange_name, "routing_key": routing_key,
            "node": self.broker.trace_node})

    def tap_deliver(self, queue_name: str, exchange_name: str,
                    routing_key: str, body: bytes,
                    vhost_name: str = "") -> None:
        """Called from ServerChannel.deliver as the frame is rendered
        (only when ``tap_bindings`` is truthy — the seam checks)."""
        if exchange_name.startswith("amq.chanamq."):
            return
        if self.queue_filter and not queue_name.startswith(self.queue_filter):
            return
        if self.tenant_filter and not self._tenant_owns(vhost_name):
            return
        self._tap(f"deliver.{queue_name}", body, {
            "queue": queue_name, "exchange": exchange_name,
            "routing_key": routing_key, "node": self.broker.trace_node})
