"""Telemetry service: per-entity sampling, probes, health, and alerts.

One asyncio task per broker (``broker.telemetry``), ticking every
``chana.mq.telemetry.interval``. Each tick it

- measures event-loop lag (sleep overshoot: how late the timer actually
  fired) and its own tick duration — a tick longer than the interval
  counts as *saturated*, the signal that sampling is falling behind;
- samples every local queue and connection into fixed-slot
  :class:`EntityRings` (rates from the per-entity monotonic counters the
  hot paths maintain; gauges read directly). Replica vhosts never appear
  in ``broker.vhosts`` so the walk only sees entities this node owns;
- evaluates the alert rules vectorized over the queue matrix plus the
  node probes (loop lag, replication lag, store errors) and records
  fire/resolve transitions into metrics counters, structured logs, and
  the trace runtime (alerts tag captured traces exactly like chaos
  faults do, via ``note_chaos_fire("alert:<rule>")``).

The sampler walk is O(local entities) *off* the message path; the
message path itself pays only the integer increments added in
broker/entities.py and broker/connection.py.

Cluster view: ``cluster_payload`` pulls every alive peer's
``local_payload`` over the control-plane RPC (``telemetry.pull``), so
/admin/timeseries, /admin/health?scope=cluster and /admin/alerts serve a
whole-cluster answer from any node.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Hashable, Optional

import numpy as np

from .. import events as event_bus
from .. import trace
from ..slo import SLISampler, SLOEngine
from .alerts import AlertEngine, AlertRule, default_rules
from .health import evaluate_health
from .store import CONN_FIELDS, QUEUE_FIELDS, EntityRings

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker

log = logging.getLogger("chanamq.telemetry")


class TelemetryService:
    """Per-entity sampler + probes + health + alert engine."""

    def __init__(
        self,
        broker: "Broker",
        *,
        interval_s: float = 1.0,
        ring_ticks: int = 120,
        max_queues: int = 512,
        max_connections: int = 256,
        top_k: int = 4,
        rules: Optional[list[AlertRule]] = None,
        alerts_enabled: bool = True,
        loop_lag_ready_ms: float = 1000.0,
        repl_lag_ready: int = 10000,
        store_error_window: int = 30,
        slo: Optional[SLOEngine] = None,
        federation_lag_records: int = 1000,
    ) -> None:
        self.broker = broker
        self.interval_s = interval_s
        self.top_k = top_k
        self.queues = EntityRings(max_queues, ring_ticks, QUEUE_FIELDS)
        self.conns = EntityRings(max_connections, ring_ticks, CONN_FIELDS)
        self.engine = AlertEngine(
            rules if rules is not None else default_rules())
        self.alerts_enabled = alerts_enabled
        self.federation_lag_records = federation_lag_records
        # SLO engine rides the same tick (None: feature off); the sampler
        # turns broker counters into per-tick (good, bad) SLI deltas
        self.slo: Optional[SLOEngine] = None
        self.slo_sampler: Optional[SLISampler] = None
        if slo is not None:
            self.set_slo(slo)

        # readiness thresholds (health.py reads these off the service)
        self.loop_lag_ready_ms = loop_lag_ready_ms
        self.repl_lag_ready = repl_lag_ready
        self.store_error_window = store_error_window

        # probe state (latest tick)
        self.tick = 0
        self.loop_lag_ms = 0.0
        self.loop_lag_max_ms = 0.0
        self.tick_us = 0.0
        self.store_errors_recent = 0
        # cached one-word health verdict for log stamping ("ready" /
        # "not-ready"); logjson reads this on every line, so it must be
        # an attribute lookup, never a full health evaluation
        self.health_state = "ready"

        # per-entity monotonic-counter snapshots from the previous tick
        self._q_prev: dict[Hashable, tuple[int, int, int]] = {}
        self._c_prev: dict[Hashable, tuple[int, int, int]] = {}
        # store-error totals per tick, oldest first (windowed delta)
        self._store_err_totals: list[int] = []
        self._task: Optional[asyncio.Task] = None
        self._last = 0.0

    def set_slo(self, engine: SLOEngine) -> None:
        """Install (or replace: POST /admin/slo/configure) the SLO engine.
        A replacement starts with fresh rings — budgets are a property of
        the spec set, so they reset with it."""
        self.slo = engine
        threshold = 250.0
        for spec in engine.specs:
            if spec.sli == "delivery-latency":
                threshold = spec.threshold_ms
                break
        self.slo_sampler = SLISampler(
            self.broker, threshold,
            federation_lag_records=self.federation_lag_records)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._task is not None:
            return
        self._last = time.monotonic()
        self._task = asyncio.get_event_loop().create_task(self._run())
        self._task.add_done_callback(self._on_run_done)
        log.info(
            "telemetry on: interval=%.3gs ring=%d ticks, "
            "%d queue + %d connection slots, %d alert rules%s",
            self.interval_s, self.queues.ticks, self.queues.slots,
            self.conns.slots, len(self.engine.rules),
            "" if self.alerts_enabled else " (alerts disabled)")

    async def stop(self) -> None:
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):
            pass
        self._task = None

    @staticmethod
    def _on_run_done(task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            log.error("telemetry sampler died: %s", exc, exc_info=exc)

    async def _run(self) -> None:
        while True:
            target = time.monotonic() + self.interval_s
            await asyncio.sleep(self.interval_s)
            now = time.monotonic()
            # sleep overshoot = how long the event loop kept the timer
            # waiting beyond its deadline: the loop-lag probe
            lag_ms = max(0.0, (now - target) * 1000.0)
            self.loop_lag_ms = lag_ms
            self.loop_lag_max_ms = max(self.loop_lag_max_ms, lag_ms)
            try:
                self.sample_tick(now - self._last)
            except Exception:
                log.exception("telemetry tick failed")
            self._last = now

    # -- one tick ----------------------------------------------------------

    def sample_tick(self, dt_s: float) -> None:
        """Sample all entities, refresh probes, evaluate alerts. Public so
        tests (and the soak) can drive deterministic ticks without timers."""
        t0 = time.perf_counter()
        dt = max(dt_s, 1e-6)
        broker = self.broker
        metrics = broker.metrics
        self.tick += 1

        self._sample_queues(dt)
        self._sample_connections(dt)
        self._refresh_store_errors()

        probes = self.node_probes()
        if self.alerts_enabled:
            self._evaluate_alerts(probes)

        health = evaluate_health(broker, self)
        self.health_state = "ready" if health["ready"] else "not-ready"

        if self.slo is not None and self.slo_sampler is not None:
            self._evaluate_slo(bool(health["ready"]))

        self.tick_us = (time.perf_counter() - t0) * 1e6
        metrics.telemetry_ticks += 1
        if self.tick_us > self.interval_s * 1e6:
            metrics.telemetry_saturated_ticks += 1
        metrics.telemetry_evicted_entities = (
            self.queues.evicted + self.conns.evicted)
        metrics.telemetry_dropped_entities = (
            self.queues.dropped + self.conns.dropped)

    def _sample_queues(self, dt: float) -> None:
        live: set = set()
        vec = np.zeros(len(QUEUE_FIELDS), dtype=np.float32)
        for vhost in self.broker.vhosts.values():
            for queue in vhost.queues.values():
                key = (vhost.name, queue.name)
                live.add(key)
                slot = self.queues.lease(key)
                if slot is None:
                    continue
                pub, dlv, ack = (queue.n_published, queue.n_delivered,
                                 queue.n_acked)
                p_pub, p_dlv, p_ack = self._q_prev.get(key, (pub, dlv, ack))
                vec[0] = (pub - p_pub) / dt
                vec[1] = (dlv - p_dlv) / dt
                vec[2] = (ack - p_ack) / dt
                vec[3] = len(queue.messages)
                vec[4] = len(queue.outstanding)
                vec[5] = len(queue.consumers)
                vec[6] = queue.ready_bytes
                self._q_prev[key] = (pub, dlv, ack)
                self.queues.push(slot, vec)
        self.queues.retire_absent(live)
        for key in [k for k in self._q_prev if k not in live]:
            del self._q_prev[key]

    def _sample_connections(self, dt: float) -> None:
        live: set = set()
        vec = np.zeros(len(CONN_FIELDS), dtype=np.float32)
        for conn in self.broker.connections:
            key = conn.id
            live.add(key)
            slot = self.conns.lease(key)
            if slot is None:
                continue
            pub, dlv, ack = (conn.published_msgs, conn.delivered_msgs,
                             conn.acked_msgs)
            p_pub, p_dlv, p_ack = self._c_prev.get(key, (pub, dlv, ack))
            unacked = 0
            credit = 0
            for ch in conn.channels.values():
                n = len(ch.unacked)
                unacked += n
                if ch.prefetch_count_consumer:
                    credit += max(0, ch.prefetch_count_consumer - n)
            vec[0] = (pub - p_pub) / dt
            vec[1] = (dlv - p_dlv) / dt
            vec[2] = (ack - p_ack) / dt
            vec[3] = len(conn.channels)
            vec[4] = unacked
            vec[5] = credit
            self._c_prev[key] = (pub, dlv, ack)
            self.conns.push(slot, vec)
        self.conns.retire_absent(live)
        for key in [k for k in self._c_prev if k not in live]:
            del self._c_prev[key]

    def _refresh_store_errors(self) -> None:
        total = int(getattr(self.broker.store, "error_count", 0))
        totals = self._store_err_totals
        totals.append(total)
        if len(totals) > self.store_error_window:
            del totals[: len(totals) - self.store_error_window]
        self.store_errors_recent = total - totals[0]

    def node_probes(self) -> dict[str, float]:
        broker = self.broker
        repl_lag = 0.0
        cluster = broker.cluster
        if cluster is not None and cluster.replication is not None:
            repl_lag = float(cluster.replication.total_lag())
        flow = broker.flow
        return {
            "loop_lag_ms": self.loop_lag_ms,
            "repl_lag_events": repl_lag,
            "store_errors": float(self.store_errors_recent),
            "memory_stage": float(flow.stage) if flow is not None else 0.0,
            # stage floor pinned by the predictive control plane; the
            # control-prearm-stuck rule watches for a floor that never
            # relaxes (forecast stuck pessimistic / relax path broken)
            "control_floor": float(flow.floor) if flow is not None else 0.0,
            # 1.0 while a graceful drain has blown its evacuation budget
            # (queues stuck pinned/failing) — the drain-stuck rule fires on
            # it so an operator knows the decommission needs a hand
            "drain_overdue": (
                cluster.lifecycle.drain_overdue()
                if cluster is not None else 0.0),
        }

    def _evaluate_alerts(self, probes: dict[str, float]) -> None:
        keys, latest = self.queues.latest_matrix()
        events = self.engine.evaluate(
            self.tick, keys, latest,
            lambda w: self.queues.delta_matrix(w)[1],
            self.broker.trace_node, probes)
        if not events:
            return
        self.engine.record(events)
        metrics = self.broker.metrics
        for ev in events:
            if ev["event"] == "fired":
                metrics.alerts_fired += 1
                log.warning(
                    "alert fired: %s on %s (%s=%.6g, threshold %.6g, "
                    "severity %s)", ev["rule"], ev["entity"], ev["metric"],
                    ev["value"], ev["threshold"], ev["severity"])
                # tag captured traces in the fire window, same machinery
                # chaos faults use — a slow trace overlapping an alert
                # carries the alert name in its tags
                if trace.ACTIVE is not None:
                    trace.ACTIVE.note_chaos_fire(f"alert:{ev['rule']}")
            else:
                metrics.alerts_resolved += 1
                log.info("alert resolved: %s on %s after %d ticks",
                         ev["rule"], ev["entity"], ev["ticks"])
        bus = event_bus.ACTIVE
        if bus is not None:
            for ev in events:
                verb = "fired" if ev["event"] == "fired" else "cleared"
                bus.emit(f"alert.{verb}.{ev['rule']}", dict(ev))

    def _evaluate_slo(self, ready: bool) -> None:
        """One SLO tick: sample SLIs, evaluate burn rates, surface burn /
        clear transitions (metrics counter, structured log, event bus)."""
        samples = self.slo_sampler.sample(ready)
        slo_events = self.slo.evaluate(self.tick, samples)
        if not slo_events:
            return
        metrics = self.broker.metrics
        bus = event_bus.ACTIVE
        for ev in slo_events:
            if ev["event"] == "burn":
                metrics.slo_violations_total += 1
                log.warning(
                    "slo burn-rate: %s/%s burning (short=%.3g long=%.3g "
                    "threshold=%.3g budget_remaining=%.4f)",
                    ev["slo"], ev["pair"], ev["burn_short"], ev["burn_long"],
                    ev["threshold"], ev["budget_remaining"])
                if bus is not None:
                    bus.emit(f"slo.burn-rate.{ev['slo']}", dict(ev))
            else:
                log.info("slo cleared: %s/%s after %d ticks",
                         ev["slo"], ev["pair"], ev["ticks"])
                if bus is not None:
                    bus.emit(f"slo.cleared.{ev['slo']}", dict(ev))

    # -- reads: metrics / admin / forecaster -------------------------------

    def gauges(self) -> dict:
        """Merged into Broker.metrics_snapshot (Prometheus + /admin/metrics)."""
        return {
            "telemetry_loop_lag_ms": round(self.loop_lag_ms, 3),
            "telemetry_loop_lag_max_ms": round(self.loop_lag_max_ms, 3),
            "telemetry_tick_us": round(self.tick_us, 1),
            "telemetry_queue_entities": len(self.queues),
            "telemetry_conn_entities": len(self.conns),
            "alerts_firing": len(self.engine.firing),
        }

    def health(self) -> dict:
        return evaluate_health(self.broker, self)

    def local_payload(self, window: int, top: int = 0) -> dict:
        """JSON-safe single-node snapshot: the telemetry.pull RPC body and
        the per-node building block of every /admin cluster view. top > 0
        limits queue series to the top-N by publish+deliver rate (full
        key list still included so drilldowns can 404 correctly)."""
        q_keys, latest = self.queues.latest_matrix()
        selected = q_keys
        if top and len(q_keys) > top:
            rate = latest[:, 0] + latest[:, 1]  # publish + deliver
            order = np.argsort(-rate, kind="stable")[:top]
            selected = [q_keys[i] for i in sorted(order)]
        queues = []
        for key in selected:
            series = self.queues.series(key, window)
            queues.append({
                "vhost": key[0], "name": key[1],
                "series": [] if series is None else series.tolist(),
            })
        connections = []
        for key in self.conns.keys():
            series = self.conns.series(key, window)
            connections.append({
                "id": key,
                "series": [] if series is None else series.tolist(),
            })
        return {
            "node": self.broker.trace_node,
            "tick": self.tick,
            "interval_s": self.interval_s,
            "fields": {"queue": list(QUEUE_FIELDS),
                       "connection": list(CONN_FIELDS)},
            "queues": queues,
            "queue_keys": [[k[0], k[1]] for k in q_keys],
            "connections": connections,
            "tenants": self.top_tenants(top or 0),
            "probes": self.node_probes(),
            "alerts": self.engine.snapshot(),
            "slo": self.slo.snapshot() if self.slo is not None else None,
            "health": self.health(),
            "stats": {"queues": self.queues.stats(),
                      "connections": self.conns.stats(),
                      "tick_us": round(self.tick_us, 1)},
        }

    async def cluster_payload(self, window: int, top: int = 0) -> dict:
        """Whole-cluster view: this node's payload plus every alive peer's,
        pulled over the control-plane RPC. Peer failures degrade to an
        error entry instead of failing the whole view."""
        me = self.broker.trace_node
        nodes: dict[str, dict] = {me: self.local_payload(window, top)}
        cluster = self.broker.cluster
        if cluster is not None and cluster.membership is not None:
            for peer in cluster.membership.alive_members():
                if peer == cluster.name:
                    continue
                try:
                    nodes[peer] = await cluster._call(
                        peer, "telemetry.pull",
                        {"window": window, "top": top}, timeout_s=2.0)
                except Exception as exc:
                    nodes[peer] = {"node": peer,
                                   "error": f"pull failed: {type(exc).__name__}"}
        return {"nodes": nodes, "origin": me}

    # -- forecaster feature tap --------------------------------------------

    def topk_features(self, k: int) -> np.ndarray:
        """2k extra features: (depth, publish_rate) for each of the top-k
        queues by publish+deliver rate, zero-padded, rank-ordered. NOTE:
        rank-ordered slots change meaning whenever the top-K set churns —
        the forecaster therefore samples through models.telemetry.TopKSlots
        (identity-pinned slots with explicit eviction/reset) instead; this
        rank-ordered view remains for ad-hoc "busiest right now" reads."""
        out = np.zeros(2 * k, dtype=np.float32)
        keys, latest = self.queues.latest_matrix()
        if not keys or k <= 0:
            return out
        rate = latest[:, 0] + latest[:, 1]
        order = np.argsort(-rate, kind="stable")[:k]
        for i, row in enumerate(order):
            out[2 * i] = latest[row, 3]      # depth
            out[2 * i + 1] = latest[row, 0]  # publish_rate
        return out

    def top_tenants(self, k: int) -> list[dict]:
        """Per-tenant rows for /admin/timeseries: live tenant snapshots
        ordered by published+delivered traffic (top-K when k > 0, all
        tenants otherwise). Empty when tenancy is off."""
        registry = getattr(self.broker, "tenancy", None)
        if registry is None:
            return []
        rows = [registry.tenants[name].snapshot()
                for name in sorted(registry.tenants)]
        rows.sort(key=lambda r: (-(r["published"] + r["delivered"]),
                                 r["name"]))
        return rows[:k] if k > 0 else rows

    def top_queues(self, k: int) -> list[dict]:
        """Top-k queues by publish+deliver rate with their latest vectors
        (the /admin/timeseries?top=K summary row)."""
        keys, latest = self.queues.latest_matrix()
        if not keys:
            return []
        rate = latest[:, 0] + latest[:, 1]
        order = np.argsort(-rate, kind="stable")[:k]
        return [
            {"vhost": keys[i][0], "name": keys[i][1],
             **{f: float(latest[i, j])
                for j, f in enumerate(QUEUE_FIELDS)}}
            for i in order
        ]
