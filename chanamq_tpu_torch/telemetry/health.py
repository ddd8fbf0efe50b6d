"""Liveness / readiness evaluation with reasons.

Liveness is trivially true whenever the process can serve the request
(the event loop is running). Readiness is the load-balancer signal: a
node that is draining, whose event loop is lagging, whose store is
failing background writes, whose replication is far behind, or that has
lost cluster quorum should stop receiving new work — each check
contributes a human-readable reason so /admin/health explains *why*.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from ..broker.broker import Broker
    from .service import TelemetryService


def shard_check(broker: "Broker") -> "tuple[dict, list[str]] | None":
    """Shard-sibling liveness, usable with or without telemetry: a worker
    in a multi-process node is only ready while every sibling shard
    heartbeats (a dead sibling means part of the queue space is mid-
    re-hash; the LB should drain this node). None when not sharded."""
    shard_info = getattr(broker, "shard_info", None)
    cluster = broker.cluster
    if (shard_info is None or cluster is None
            or cluster.membership is None):
        return None
    siblings = set(cluster.uds_map)
    alive_set = set(cluster.membership.alive_members())
    dead = sorted(siblings - alive_set)
    check = {"ok": not dead, "self": shard_info["index"],
             "count": shard_info["count"], "dead_siblings": dead}
    reasons = ([f"shard sibling(s) down: {', '.join(dead)}"]
               if dead else [])
    return check, reasons


def flow_check(broker: "Broker") -> "tuple[dict, list[str]] | None":
    """Memory-pressure ladder state, usable with or without telemetry
    (the /admin/health fallback needs it too — a default-config broker at
    the refuse stage must not read as ready). The stage is always
    surfaced (so the LB / operator sees "throttle" building), but
    readiness only drops at the refuse stage — a throttling broker is
    still doing useful work, and flipping it not-ready would redirect
    load it is actively shedding. None when no watermark is configured."""
    flow = broker.flow
    if flow is None:
        return None
    from ..flow import STAGE_REFUSE

    refusing = flow.stage >= STAGE_REFUSE
    check = {
        "ok": not refusing, "stage": flow.stage,
        "stage_label": flow.label, "accounted_bytes": flow.total,
        "hard_limit": flow.hard_limit}
    reasons = ([f"memory pressure: stage {flow.label} "
                f"({flow.total} accounted / hard limit {flow.hard_limit})"]
               if refusing else [])
    return check, reasons


def evaluate_health(broker: "Broker", svc: "TelemetryService") -> dict:
    reasons: list[str] = []
    checks: dict[str, dict] = {}

    draining = bool(getattr(broker, "draining", False))
    checks["draining"] = {"ok": not draining}
    if draining:
        reasons.append("draining: shutdown in progress")

    lag_ms = svc.loop_lag_ms
    lag_ok = lag_ms <= svc.loop_lag_ready_ms
    checks["loop_lag"] = {
        "ok": lag_ok, "lag_ms": round(lag_ms, 3),
        "threshold_ms": svc.loop_lag_ready_ms}
    if not lag_ok:
        reasons.append(
            f"event-loop lag {lag_ms:.0f}ms > {svc.loop_lag_ready_ms:.0f}ms")

    # store errors: not-ready while background writes failed in the recent
    # sampling window (a single ancient failure must not wedge readiness
    # forever, so the service tracks a windowed delta, not the total)
    recent = svc.store_errors_recent
    total = int(getattr(broker.store, "error_count", 0))
    checks["store"] = {"ok": recent == 0, "recent_errors": recent,
                       "total_errors": total}
    if recent:
        reasons.append(f"store: {recent} background write failure(s) "
                       f"in the last {svc.store_error_window} ticks")

    pressure = flow_check(broker)
    if pressure is not None:
        checks["memory_pressure"], flow_reasons = pressure
        reasons.extend(flow_reasons)

    cluster = broker.cluster
    repl_lag = 0
    if cluster is not None and cluster.replication is not None:
        repl_lag = int(cluster.replication.total_lag())
    repl_ok = repl_lag <= svc.repl_lag_ready
    checks["replication"] = {
        "ok": repl_ok, "lag_events": repl_lag,
        "threshold_events": svc.repl_lag_ready}
    if not repl_ok:
        reasons.append(
            f"replication lag {repl_lag} events > {svc.repl_lag_ready}")

    if cluster is not None and cluster.membership is not None:
        alive = cluster.membership.alive_members()
        total_n = len(cluster.membership.members)
        # strict majority; a single-node "cluster" is always quorate
        quorate = total_n <= 1 or 2 * len(alive) > total_n
        checks["quorum"] = {
            "ok": quorate, "alive": len(alive), "members": total_n}
        if not quorate:
            reasons.append(
                f"cluster quorum lost ({len(alive)}/{total_n} alive)")

    shards = shard_check(broker)
    if shards is not None:
        checks["shards"], shard_reasons = shards
        reasons.extend(shard_reasons)

    payload = {
        "node": broker.trace_node,
        "live": True,
        "ready": not reasons,
        "reasons": reasons,
        "checks": checks,
    }
    # SLO stamp (informational — burning budgets mean the objective is at
    # risk, not that the node should stop taking traffic, so no reason is
    # added): which SLOs are burning and how much budget remains
    slo = getattr(svc, "slo", None)
    if slo is not None:
        payload["slo"] = slo.readiness_stamp()
    return payload
