"""Per-entity telemetry: fixed-slot timeseries rings per queue and per
connection, an event-loop lag / sampler-saturation probe, a health and
readiness surface, and a declarative alert-rule engine evaluated
vectorized over the per-entity matrix each tick.

Layout mirrors the chaos/ and trace/ subsystems: a service object hangs
off ``broker.telemetry`` when ``chana.mq.telemetry.enabled`` is on, the
hot path pays nothing (the broker maintains plain int gauges and
counters; sampling happens on a timer off the message path), and the
admin layer serves cluster-wide views by pulling per-node payloads over
the existing control-plane RPC (``telemetry.pull``).
"""

from .store import EntityRings, QUEUE_FIELDS, CONN_FIELDS  # noqa: F401
from .alerts import AlertRule, AlertEngine, default_rules  # noqa: F401
from .health import evaluate_health  # noqa: F401
from .service import TelemetryService  # noqa: F401
