"""Structured JSON log output (``chana.mq.log.json``).

One JSON object per line — machine-ingestable without fragile regexes —
stamped with the broker's cluster node id and, when a trace context is
pinned on the running task, the active trace id so log lines can be
joined against ``GET /admin/traces/<id>``.
"""

from __future__ import annotations

import json
import logging


class JsonLogFormatter(logging.Formatter):
    """Render records as single-line JSON objects.

    The node id is read from the broker lazily: ``broker.trace_node``
    starts as ``"local"`` and is updated to ``host:port`` when the
    cluster layer starts, after logging is already configured.
    """

    def __init__(self, broker=None) -> None:
        super().__init__()
        self._broker = broker

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "node": getattr(self._broker, "trace_node", None) or "local",
        }
        # node health verdict on every line: the telemetry service caches
        # a one-word state each sampler tick, so this is an attribute
        # read, never a health evaluation per log record
        svc = getattr(self._broker, "telemetry", None)
        if svc is not None:
            out["health"] = svc.health_state
        from .. import trace

        tid = trace.current_trace_id()
        if tid is not None:
            out["trace"] = tid
            # a propagated W3C context adds the cross-system join key —
            # the same trace_id exported spans and exemplars carry
            w3c = trace.current_w3c_trace_id()
            if w3c is not None:
                out["trace_id"] = w3c
        # structured payloads: callers attach machine-readable fields via
        # `log.warning(..., extra={"data": {...}})` (e.g. the profiler's
        # slow-callback captures ship duration + folded stack this way)
        data = getattr(record, "data", None)
        if isinstance(data, dict):
            out.update(data)
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def install(broker=None) -> None:
    """Swap every root-logger handler's formatter for JSON output."""
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig()
    formatter = JsonLogFormatter(broker)
    for handler in root.handlers:
        handler.setFormatter(formatter)
