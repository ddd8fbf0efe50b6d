"""Delayed delivery: x-delay via a broker timer wheel.

RabbitMQ ships this as the delayed-message-exchange plugin; here it is a
publish-path feature (EXCEEDS the reference, which has no timers beyond
per-entity TTL sweeps, MessageEntity.scala:168-198). A publish whose
headers carry ``x-delay: <ms>`` parks in a hashed timer wheel instead of
routing; when the delay elapses it re-enters the NORMAL publish path
with the header stripped. Because routing happens at fire time, a
delayed message naturally survives topology churn in between — the queue
it would have landed in may be deleted and recreated, or its bindings
rewired, and the fire simply routes against whatever exists then
(unroutable fires drop, plugin parity: mandatory is not honored for
delayed publishes).

Parked bodies are resident broker memory, so they are accounted through
the flow MemoryAccountant like queued bodies — a flood of long-delay
publishes walks the flow ladder instead of growing silently.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Optional

from .. import events

log = logging.getLogger("chanamq.semantics")

# one wheel turn at the default tick covers 512 * 50ms = 25.6s; longer
# delays just ride multiple turns (entries carry their absolute tick)
DEFAULT_TICK_MS = 50
DEFAULT_SLOTS = 512

# clamp ceiling, mirroring the delayed-message-exchange plugin's
# ERL_MAX_T-derived bound (~49.7 days); an absurd x-delay is a client
# bug, not a reason to pin memory for years
MAX_DELAY_MS = (1 << 32) - 1


def parse_delay(headers: Optional[dict]) -> Optional[int]:
    """Effective x-delay in ms, or None when the publish is immediate.
    Non-positive and non-integer values mean "no delay" (the plugin
    routes those immediately rather than erroring)."""
    if not headers:
        return None
    d = headers.get("x-delay")
    if isinstance(d, bool) or not isinstance(d, int) or d <= 0:
        return None
    return min(d, MAX_DELAY_MS)


class TimerWheel:
    """Hashed timer wheel: slots of pending entries, advanced tick by
    tick. schedule() is O(1); advance() touches only the slot under the
    cursor. Entries carry their absolute due tick, so a slot shared by
    multiple wheel turns fires only what is actually due."""

    __slots__ = ("tick_ms", "slots", "_wheel", "_tick", "_count")

    def __init__(self, tick_ms: int = DEFAULT_TICK_MS,
                 slots: int = DEFAULT_SLOTS) -> None:
        self.tick_ms = tick_ms
        self.slots = slots
        self._wheel: list[list] = [[] for _ in range(slots)]
        self._tick = 0
        self._count = 0

    def schedule(self, delay_ms: int, item: Any) -> None:
        ticks = max(1, -(-delay_ms // self.tick_ms))  # ceil, min one tick
        due = self._tick + ticks
        self._wheel[due % self.slots].append((due, item))
        self._count += 1

    def advance(self, ticks: int = 1) -> list:
        """Move the cursor forward, returning every entry that came due
        (in schedule order within a tick)."""
        fired: list = []
        for _ in range(ticks):
            self._tick += 1
            slot = self._wheel[self._tick % self.slots]
            if not slot:
                continue
            keep = []
            for due, item in slot:
                if due <= self._tick:
                    fired.append(item)
                else:
                    keep.append((due, item))  # a later wheel turn's entry
            slot[:] = keep
        self._count -= len(fired)
        return fired

    def __len__(self) -> int:
        return self._count


class DelayService:
    """Owns the wheel and the single asyncio timer task.

    The timer task runs only while entries are parked (spawned on first park,
    exits when the wheel drains), so an idle broker pays nothing. Fires
    re-publish synchronously on single-node brokers — the same eager
    path Tx commits rely on — and via a spawned task when clustered.
    """

    def __init__(self, broker, tick_ms: int = DEFAULT_TICK_MS,
                 slots: int = DEFAULT_SLOTS) -> None:
        self.broker = broker
        self.wheel = TimerWheel(tick_ms=tick_ms, slots=slots)
        self._task = None

    def park(self, vhost: str, exchange: str, routing_key: str,
             properties, body: bytes, delay_ms: int) -> None:
        """Stage one delayed publish. The x-delay header is stripped NOW
        so the fire-time publish cannot re-park (and downstream consumers
        see the same headers the plugin would deliver)."""
        headers = dict(properties.headers)
        headers.pop("x-delay", None)
        props = properties.copy()
        props.headers = headers or None
        self.wheel.schedule(delay_ms, (vhost, exchange, routing_key, props, body))
        broker = self.broker
        broker.account_memory(len(body))
        broker.metrics.semantics_delayed_msgs += 1
        bus = events.ACTIVE
        if bus is not None:
            bus.emit("message.delayed", {
                "vhost": vhost, "exchange": exchange,
                "routing_key": routing_key, "delay_ms": delay_ms,
                "bytes": len(body),
            }, vhost_name=vhost)
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())
            broker._bg_tasks.add(self._task)
            self._task.add_done_callback(broker._bg_tasks.discard)

    async def _run(self) -> None:
        tick_s = self.wheel.tick_ms / 1000.0
        loop = asyncio.get_event_loop()
        last = loop.time()
        while len(self.wheel):
            await asyncio.sleep(tick_s)
            now = loop.time()
            elapsed_ticks = max(1, int((now - last) / tick_s))
            last += elapsed_ticks * tick_s
            for item in self.wheel.advance(elapsed_ticks):
                self._fire(item)

    def _fire(self, item: tuple) -> None:
        vhost, exchange, routing_key, props, body = item
        broker = self.broker
        broker.account_memory(-len(body))
        broker.metrics.semantics_delay_fired += 1
        if broker.cluster is None:
            try:
                broker.publish_sync(vhost, exchange, routing_key, props, body)
            except Exception as exc:  # topology vanished: drop, don't die
                log.warning("delayed publish to '%s' dropped: %s", exchange, exc)
        else:
            broker.spawn(self._publish_clustered(item))

    async def _publish_clustered(self, item: tuple) -> None:
        vhost, exchange, routing_key, props, body = item
        try:
            await self.broker.publish(vhost, exchange, routing_key, props, body)
        except Exception as exc:
            log.warning("delayed publish to '%s' dropped: %s", exchange, exc)

    def snapshot(self) -> dict:
        m = self.broker.metrics
        return {
            "parked": len(self.wheel),
            "tick_ms": self.wheel.tick_ms,
            "delayed_total": m.semantics_delayed_msgs,
            "fired_total": m.semantics_delay_fired,
        }
