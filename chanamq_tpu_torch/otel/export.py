"""OTLP-shaped span export: render + background shipper.

The render maps one completed :class:`~chanamq_tpu_torch.trace.Trace` to an
OTLP span tree — a root ``broker`` span covering the trace bounds
(parented to the client's span when a W3C context was propagated) plus
one child span per populated stage slot. Everything serializes as
OTLP/HTTP **JSON** (``ResourceSpans``), so a stock collector ingests it
on ``/v1/traces`` and the pull fallback ``GET /admin/otel/spans`` serves
the identical document for scrape-style collection.

The :class:`OtelExporter` drains completed traces through a bounded
queue: the trace runtime's finish hook enqueues (shedding — with a
counter — when the overload ladder is at stage >= 1 or the queue is
full), and a timer task flushes batches to the configured endpoint,
dialing through the cluster layer's :class:`ReconnectBackoff` so a dead
collector costs one fast failure per window, not a connect timeout per
batch.

Timestamps: trace spans stamp ``time.perf_counter_ns()``; OTLP wants
epoch nanoseconds. One offset (``time_ns - perf_counter_ns``) is
computed per render so all spans in a document share a consistent clock
mapping.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from typing import TYPE_CHECKING, Iterable, Optional
from urllib.parse import urlsplit

from .. import trace as trace_mod
from ..cluster.rpc import ReconnectBackoff, RpcError
from .context import derive_span_id, derive_trace_id

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker
    from ..trace.runtime import Trace

log = logging.getLogger("chanamq.otel")

_SCOPE = {"name": "chanamq-tpu.trace", "version": "1"}
_KIND_SERVER = 2
_KIND_INTERNAL = 1


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        wrapped = {"boolValue": value}
    elif isinstance(value, int):
        wrapped = {"intValue": str(value)}  # OTLP JSON: int64 as string
    elif isinstance(value, float):
        wrapped = {"doubleValue": value}
    else:
        wrapped = {"stringValue": str(value)}
    return {"key": key, "value": wrapped}


def clock_offset_ns() -> int:
    """perf_counter timeline -> unix-epoch nanoseconds."""
    return time.time_ns() - time.perf_counter_ns()


def otlp_ids(tr: "Trace") -> "tuple[str, str, str]":
    """``(trace_id, root_span_id, root_parent_span_id)`` for a trace.

    A propagated context supplies all three (parent = the client's
    span); a seeded sample derives a stable trace id from its internal
    ``node#seq`` id and exports its root with no parent."""
    w3c = tr.w3c
    if w3c is not None:
        return w3c.trace_id, w3c.root_span_id, w3c.parent_span_id
    trace_id = derive_trace_id(tr.trace_id)
    return trace_id, derive_span_id(trace_id, "broker", tr.origin), ""


def trace_spans(tr: "Trace", offset_ns: int) -> list:
    """One OTLP span per populated stage slot, under a root broker span."""
    bounds = tr.bounds_ns()
    if bounds is None:
        return []
    trace_id, root_id, root_parent = otlp_ids(tr)
    attrs = [_attr("chanamq.trace_id", tr.trace_id),
             _attr("chanamq.origin", tr.origin)]
    for key, value in (tr.attrs or {}).items():
        attrs.append(_attr(f"chanamq.{key}", value))
    if tr.chaos_rules:
        attrs.append(_attr("chanamq.chaos_rules", ",".join(tr.chaos_rules)))
    root = {
        "traceId": trace_id,
        "spanId": root_id,
        "name": "broker",
        "kind": _KIND_SERVER,
        "startTimeUnixNano": str(bounds[0] + offset_ns),
        "endTimeUnixNano": str(bounds[1] + offset_ns),
        "attributes": attrs,
    }
    if root_parent:
        root["parentSpanId"] = root_parent
    spans = [root]
    stages = trace_mod.STAGES
    for i, slot in enumerate(tr.slots):
        if slot is None:
            continue
        t0, t1, node = slot
        spans.append({
            "traceId": trace_id,
            "spanId": derive_span_id(trace_id, stages[i], node, str(i)),
            "parentSpanId": root_id,
            "name": stages[i],
            "kind": _KIND_INTERNAL,
            "startTimeUnixNano": str(t0 + offset_ns),
            "endTimeUnixNano": str(max(t0, t1) + offset_ns),
            "attributes": [_attr("chanamq.node", node)],
        })
    return spans


def default_resource(broker) -> dict:
    res = {
        "service.name": "chanamq-tpu",
        "chanamq.node": getattr(broker, "trace_node", None) or "local",
    }
    shard = getattr(broker, "shard_info", None)
    if shard:
        res["chanamq.shard"] = shard.get("index")
    return res


def resource_spans(traces: Iterable["Trace"], resource: dict,
                   offset_ns: Optional[int] = None) -> dict:
    """The full OTLP/HTTP JSON document for a batch of traces."""
    if offset_ns is None:
        offset_ns = clock_offset_ns()
    spans: list = []
    for tr in traces:
        spans.extend(trace_spans(tr, offset_ns))
    return {"resourceSpans": [{
        "resource": {
            "attributes": [_attr(k, v) for k, v in resource.items()
                           if v is not None]},
        "scopeSpans": [{"scope": dict(_SCOPE), "spans": spans}],
    }]}


def span_count(doc: dict) -> int:
    return sum(len(scope.get("spans") or ())
               for rs in doc.get("resourceSpans") or ()
               for scope in rs.get("scopeSpans") or ())


class OtelExporter:
    """Background drain of completed traces into OTLP/HTTP JSON batches.

    With an endpoint configured a flush task posts batches every
    ``flush_ms``; without one (collector-less mode) completed traces
    queue for the pull fallback ``GET /admin/otel/spans`` and the
    bounded queue simply sheds the oldest overflow."""

    def __init__(self, broker: "Broker", *, endpoint: str = "",
                 flush_ms: int = 1000, max_batch: int = 64,
                 queue_size: int = 1024) -> None:
        self.broker = broker
        self.metrics = broker.metrics
        self.endpoint = endpoint
        self.flush_ms = max(10, int(flush_ms))
        self.max_batch = max(1, int(max_batch))
        self.queue_size = max(1, int(queue_size))
        self._queue: deque = deque()
        self._task: Optional[asyncio.Task] = None
        self._backoff = ReconnectBackoff()

    # -- intake (called from TraceRuntime.finish) --------------------------

    def on_trace(self, tr: "Trace") -> None:
        """Enqueue a completed trace; shed-and-count under pressure.

        Sheds when the overload ladder is at stage >= 1 (exporting is the
        first observability luxury to go) or when the queue is full (a
        down collector must not grow memory without bound)."""
        flow = self.broker.flow
        if (flow is not None and flow.stage >= 1) \
                or len(self._queue) >= self.queue_size:
            self.metrics.otel_spans_shed += 1
            return
        self._queue.append(tr)

    def queue_depth(self) -> int:
        return len(self._queue)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        rt = trace_mod.ACTIVE
        if rt is not None:
            rt.export_hook = self.on_trace
        if self.endpoint:
            self._task = asyncio.get_event_loop().create_task(self._run())

    async def stop(self) -> None:
        rt = trace_mod.ACTIVE
        # == not `is`: a bound-method attribute access mints a fresh
        # object every time, so identity would never match and a stopped
        # exporter would keep receiving (and leaking) finished traces
        if rt is not None and rt.export_hook == self.on_trace:
            rt.export_hook = None
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    def status(self) -> dict:
        return {
            "endpoint": self.endpoint or None,
            "queue_depth": len(self._queue),
            "queue_size": self.queue_size,
            "flush_ms": self.flush_ms,
            "max_batch": self.max_batch,
            "backoff": self._backoff.state(),
        }

    # -- pull fallback -----------------------------------------------------

    def pull(self, limit: Optional[int] = None) -> dict:
        """Drain up to ``limit`` queued traces as one OTLP document (the
        collector-less mode: a scraper owns delivery instead of a push
        pipeline, so a pull consumes what it takes)."""
        n = len(self._queue)
        if limit is not None:
            n = min(n, max(0, limit))
        batch = [self._queue.popleft() for _ in range(n)]
        doc = resource_spans(batch, default_resource(self.broker))
        self.metrics.otel_spans_exported += span_count(doc)
        self.metrics.otel_pull_served += 1
        return doc

    # -- push loop ---------------------------------------------------------

    async def _run(self) -> None:
        url = urlsplit(self.endpoint)
        while True:
            await asyncio.sleep(self.flush_ms / 1000.0)
            while self._queue:
                batch = [self._queue.popleft() for _ in range(
                    min(self.max_batch, len(self._queue)))]
                doc = resource_spans(batch, default_resource(self.broker))
                if await self._post(url, json.dumps(doc).encode()):
                    self.metrics.otel_spans_exported += span_count(doc)
                    self.metrics.otel_batches_sent += 1
                else:
                    # requeue at the head and wait for the next window:
                    # the bounded queue (+ shed counter) caps what a dead
                    # collector can accumulate
                    self.metrics.otel_export_errors += 1
                    self._queue.extendleft(reversed(batch))
                    break

    async def _post(self, url, payload: bytes) -> bool:
        try:
            self._backoff.check()
        except RpcError:
            return False
        host = url.hostname or "127.0.0.1"
        port = url.port or 4318
        path = url.path or "/v1/traces"
        writer = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), 5)
        except (OSError, asyncio.TimeoutError):
            self._backoff.failed()
            return False
        try:
            head = (f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: close\r\n\r\n")
            writer.write(head.encode() + payload)
            await writer.drain()
            status = await asyncio.wait_for(reader.readline(), 10)
            parts = status.split()
            ok = len(parts) >= 2 and parts[1].startswith(b"2")
            if ok:
                self._backoff.succeeded()
                self._backoff.note_clean()
            else:
                log.warning("otel export rejected: %s",
                            status.decode("ascii", "replace").strip())
            return ok
        except (OSError, asyncio.TimeoutError):
            self._backoff.failed()
            return False
        finally:
            if writer is not None:
                writer.close()
