"""Service-level objectives over the broker's existing telemetry.

``SLOEngine`` (engine.py) is the pure burn-rate evaluator; this module
adds the impure edge: :class:`SLISampler` turns the broker's monotonic
counters into per-tick (good, bad) SLI samples, and ``engine_from_config``
builds the engine from the ``chana.mq.slo.*`` knobs. The telemetry tick
(telemetry/service.py) drives both — one ``sample()`` + one ``evaluate()``
per tick, off the message path — and every burn/clear transition feeds the
event bus (``slo.burn-rate.<name>`` / ``slo.cleared.<name>``), the metrics
registry (``slo_violations_total``) and the structured log.

Surfaces: ``GET /admin/slo`` (cluster-aggregated via the ``slo.pull``
control-plane RPC), ``POST /admin/slo/configure`` (replace the spec set at
runtime), ``chanamq_slo_{budget_remaining,burn_rate,violations_total}``
Prometheus series, and a compact stamp on the /admin/health payload.
"""

from __future__ import annotations

from typing import Optional

from .engine import (  # noqa: F401
    SLI_KINDS, SLOEngine, SLOSpec, default_slos, specs_from_json,
)


class SLISampler:
    """Derives per-tick (good, bad) SLI deltas from broker counters.

    Keeps the previous tick's counter snapshot; each ``sample()`` returns
    the deltas since then, keyed by SLI kind. Latency is judged from the
    publish->deliver histogram's *delta* buckets (this tick's
    observations only), so one slow burst cannot poison the p99 forever.
    """

    def __init__(self, broker, latency_threshold_ms: float = 250.0,
                 federation_lag_records: int = 1000) -> None:
        self.broker = broker
        self.latency_threshold_ms = latency_threshold_ms
        self.federation_lag_records = federation_lag_records
        self._prev: dict[str, float] = {}
        self._prev_buckets: dict[str, list[int]] = {}

    def _delta(self, name: str, value: float) -> float:
        prev = self._prev.get(name, value)
        self._prev[name] = value
        return max(0.0, value - prev)

    def _latency_sample(self, hist, key: str = "") -> tuple[float, float]:
        """(good, bad) for a latency SLI: one sample per tick that saw
        deliveries — good iff the tick's delta p99 is under threshold.
        ``key`` separates the node-wide histogram's previous-bucket state
        from each tenant's."""
        buckets = list(hist.buckets)
        prev = self._prev_buckets.get(key)
        self._prev_buckets[key] = buckets
        if prev is None:
            return (0.0, 0.0)
        delta = [b - p for b, p in zip(buckets, prev)]
        count = sum(delta)
        if count <= 0:
            return (0.0, 0.0)
        target = 0.99 * count
        seen = 0
        p99_us = float("inf")
        for i, n in enumerate(delta):
            seen += n
            if seen >= target:
                p99_us = (float(hist.BOUNDS[i]) if i < len(hist.BOUNDS)
                          else float("inf"))
                break
        if p99_us <= self.latency_threshold_ms * 1000.0:
            return (1.0, 0.0)
        return (0.0, 1.0)

    def sample(self, ready: bool) -> dict[str, tuple[float, float]]:
        m = self.broker.metrics
        published = self._delta("published", float(m.published_msgs))
        refused = self._delta("refused", float(m.flow_publishes_refused))
        returned = self._delta("returned", float(m.returned_msgs))
        delivered = self._delta("delivered", float(m.delivered_msgs))
        dead = self._delta("dead", float(m.dead_lettered_msgs))
        expired = self._delta("expired", float(m.expired_msgs))
        samples = {
            "publish-success": (published, refused + returned),
            "delivery-success": (delivered, dead + expired),
            "readiness": (1.0, 0.0) if ready else (0.0, 1.0),
            "delivery-latency": self._latency_sample(
                m.publish_to_deliver_us),
        }
        registry = getattr(self.broker, "tenancy", None)
        if registry is not None:
            # tenant-scoped streams, keyed "<sli>@<tenant>" (the sample key
            # a tenant-scoped SLOSpec reads). Publish bad-events are the
            # tenant's quota/ACL refusals; the latency stream exists only
            # for tenants whose delivery-latency SLO attached a histogram.
            for name in sorted(registry.tenants):
                tenant = registry.tenants[name]
                samples[f"publish-success@{name}"] = (
                    self._delta(f"published@{name}",
                                float(tenant.published_total())),
                    self._delta(f"refused@{name}", float(tenant.refused)))
                samples[f"delivery-success@{name}"] = (
                    self._delta(f"delivered@{name}",
                                float(tenant.delivered_total())), 0.0)
                samples[f"readiness@{name}"] = samples["readiness"]
                if tenant.latency_hist is not None:
                    samples[f"delivery-latency@{name}"] = (
                        self._latency_sample(tenant.latency_hist, name))
        federation = getattr(self.broker, "federation", None)
        if federation is not None:
            # per-link streams reuse the tenant scoping machinery: a spec
            # with tenant="<link-name>" reads "federation-lag@<link>"; the
            # node-wide stream is judged on the worst link. Good iff the
            # link is up and its record lag is within budget — a down link
            # burns the budget even before the lag number catches up.
            worst_bad = 0.0
            for link in federation.links:
                bad = (link.state != "up"
                       or link.total_lag() > self.federation_lag_records)
                samples[f"federation-lag@{link.name}"] = (
                    (0.0, 1.0) if bad else (1.0, 0.0))
                worst_bad = max(worst_bad, float(bad))
            if federation.links:
                samples["federation-lag"] = (1.0 - worst_bad, worst_bad)
        return samples


def engine_from_config(config, interval_s: float = 1.0) -> SLOEngine:
    """Build the engine from ``chana.mq.slo.*`` (specs override defaults)."""
    raw = config.get("chana.mq.slo.specs")
    if raw:
        specs = specs_from_json(raw, interval_s)
    else:
        specs = default_slos(
            interval_s,
            objective=float(config.get("chana.mq.slo.objective") or 0.999),
            latency_ms=float(config.get("chana.mq.slo.latency-ms") or 250.0),
            fast_burn=float(config.get("chana.mq.slo.fast-burn") or 14.4),
            slow_burn=float(config.get("chana.mq.slo.slow-burn") or 6.0),
        )
    return SLOEngine(specs)


def attach_tenant_latency(engine: SLOEngine, registry) -> None:
    """Allocate per-tenant publish->deliver histograms for every
    delivery-latency spec that names a tenant (the delivery hot path only
    observes into a tenant histogram that exists). Call after building or
    replacing an engine while tenancy is enabled."""
    if registry is None:
        return
    for spec in engine.specs:
        if spec.tenant and spec.sli == "delivery-latency":
            tenant = registry.tenants.get(spec.tenant)
            if tenant is not None:
                tenant.attach_latency()
