"""OpenTelemetry interop for the trace subsystem.

Three pieces, all optional and all riding the existing fixed-slot
traces (chanamq_tpu/trace/):

- :mod:`context` — W3C trace-context parsing/formatting plus the
  deterministic id derivations that let a forced sample mint span ids
  without touching the seeded sampling RNG;
- :mod:`export` — the OTLP/HTTP JSON render (``ResourceSpans``) and the
  background :class:`~chanamq_tpu.otel.export.OtelExporter` service
  behind ``chana.mq.otel.*``;
- Prometheus exemplars are rendered by rest/admin from the same slow
  ring (scrape ``/metrics?format=openmetrics``).

Nothing here is imported on the hot path: the trace runtime imports only
the pure helpers in :mod:`context`, and the exporter hooks trace
completion (already off the per-message path).
"""

from __future__ import annotations

from .context import (  # noqa: F401  (package API)
    W3CContext, derive_span_id, derive_trace_id, extract,
    format_traceparent, parse_traceparent, stamp_headers,
)
