"""Declarative alert rules, evaluated vectorized over the entity matrix.

Each tick the engine compares every active entity's series against every
rule in two numpy passes (level rules against the latest matrix, growth
rules against the delta matrix) — no per-entity Python loop until an
entity actually breaches. Hysteresis is tick-counted: a rule fires only
after ``for_ticks`` consecutive breaches and resolves only after
``clear_ticks`` consecutive OK ticks, so a gauge grazing its threshold
cannot flap an alert.

Determinism: evaluation is a pure function of the sampled series and the
rule set — no wall clock, no randomness — so under the seeded chaos soak
the same workload produces the same firings and the harness can assert
them exactly (the same bar chaos/plan.py sets for fault schedules).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .store import QUEUE_FIELDS


@dataclass(frozen=True)
class AlertRule:
    """One declarative threshold rule.

    scope "queue": metric is a QUEUE_FIELDS name, evaluated per queue.
    scope "node": metric is a node-probe name (loop_lag_ms,
    repl_lag_events, store_errors), evaluated once per tick.
    mode "level" compares the current value; mode "growth" compares the
    change over the last ``window`` ticks (backlog growth).
    require_positive lists fields that must be > 0 for a breach to count
    (consumer stall = zero deliver rate WHILE depth and consumers > 0).
    """

    name: str
    scope: str                     # "queue" | "node"
    metric: str
    threshold: float
    op: str = ">"                  # ">" | "<"
    mode: str = "level"            # "level" | "growth"
    window: int = 5                # growth lookback, ticks
    for_ticks: int = 2             # consecutive breaches before firing
    clear_ticks: int = 3           # consecutive OKs before resolving
    severity: str = "warning"
    require_positive: tuple[str, ...] = field(default_factory=tuple)


def default_rules(
    *,
    backlog_growth: float = 100.0,
    backlog_window: int = 5,
    stall_ticks: int = 3,
    repl_lag: float = 1000.0,
    loop_lag_ms: float = 250.0,
    memory_stage: float = 3.5,
    control_floor_ticks: int = 300,
    drain_stuck_ticks: int = 2,
) -> list[AlertRule]:
    """The built-in rules, thresholds from chana.mq.alerts.*.

    memory-pressure alerts on the flow ladder's REFUSE stage (stage 4 >
    3.5) by default — throttling (stage 2) is routine overload shedding
    and would be noisy; refusing publishes is operator-actionable."""
    return [
        AlertRule(
            name="backlog-growth", scope="queue", metric="depth",
            mode="growth", window=backlog_window, threshold=backlog_growth,
            for_ticks=2, severity="warning"),
        AlertRule(
            name="consumer-stall", scope="queue", metric="deliver_rate",
            op="<", threshold=1e-9, for_ticks=stall_ticks,
            require_positive=("depth", "consumers"), severity="critical"),
        AlertRule(
            name="replication-lag", scope="node", metric="repl_lag_events",
            threshold=repl_lag, for_ticks=2, severity="warning"),
        AlertRule(
            name="loop-lag", scope="node", metric="loop_lag_ms",
            threshold=loop_lag_ms, for_ticks=2, severity="critical"),
        AlertRule(
            name="memory-pressure", scope="node", metric="memory_stage",
            threshold=memory_stage, for_ticks=2, severity="critical"),
        # predictive-control watchdog: a pre-armed throttle floor is
        # supposed to relax within a spike's horizon; one pinned for this
        # many consecutive ticks means the forecast is stuck pessimistic
        # or the relax path is broken. The default (5 min at 1 s ticks)
        # keeps it inert in short soaks — it exists for real deployments.
        AlertRule(
            name="control-prearm-stuck", scope="node",
            metric="control_floor", threshold=0.5,
            for_ticks=max(1, control_floor_ticks), severity="warning"),
        # a graceful drain past its evacuation budget: queues are pinned
        # (streams, local consumers) or every handoff attempt is failing —
        # the node will sit in `draining` forever without intervention
        AlertRule(
            name="drain-stuck", scope="node", metric="drain_overdue",
            threshold=0.5, for_ticks=max(1, drain_stuck_ticks),
            severity="critical"),
    ]


class AlertEngine:
    """Tick-driven evaluator with per-(rule, entity) hysteresis state."""

    HISTORY = 256  # retained fire/resolve events for /admin/alerts

    def __init__(self, rules: list[AlertRule]) -> None:
        self.rules = list(rules)
        for rule in self.rules:
            if rule.scope == "queue" and rule.metric not in QUEUE_FIELDS:
                raise ValueError(
                    f"rule {rule.name!r}: unknown queue metric {rule.metric!r}")
        # (rule name, entity key) -> consecutive breach ticks (pre-fire)
        self._breach: dict[tuple, int] = {}
        # (rule name, entity key) -> consecutive OK ticks (pre-resolve)
        self._ok: dict[tuple, int] = {}
        # (rule name, entity key) -> {rule, entity, value, since_tick, ...}
        self.firing: dict[tuple, dict] = {}
        self.history: deque = deque(maxlen=self.HISTORY)
        self.fired_total = 0
        self.resolved_total = 0
        # every rule name that ever fired (the soak asserts this exactly)
        self.fired_rules: set[str] = set()

    # -- evaluation --------------------------------------------------------

    def evaluate(
        self,
        tick: int,
        queue_keys: list,
        latest: np.ndarray,
        deltas_for: "callable",
        node_entity: str,
        node_probes: dict[str, float],
    ) -> list[dict]:
        """One tick. latest is the (E, F) QUEUE_FIELDS matrix aligned with
        queue_keys; deltas_for(window) returns the aligned growth matrix.
        Returns the tick's transition events ({event: fired|resolved, ...}),
        in deterministic (rule order, sorted entity) order."""
        events: list[dict] = []
        for rule in self.rules:
            if rule.scope == "node":
                value = float(node_probes.get(rule.metric, 0.0))
                breach = (value > rule.threshold if rule.op == ">"
                          else value < rule.threshold)
                self._step(rule, node_entity, breach, value, tick, events)
                continue
            if not queue_keys:
                breached_keys: dict = {}
            else:
                col = QUEUE_FIELDS.index(rule.metric)
                if rule.mode == "growth":
                    values = deltas_for(rule.window)[:, col]
                else:
                    values = latest[:, col]
                mask = (values > rule.threshold if rule.op == ">"
                        else values < rule.threshold)
                for fname in rule.require_positive:
                    mask &= latest[:, QUEUE_FIELDS.index(fname)] > 0
                breached_keys = {
                    queue_keys[i]: float(values[i])
                    for i in np.nonzero(mask)[0]
                }
            # step breached entities plus everything already tracked for
            # this rule (their streaks must advance toward resolve)
            tracked = {k for (r, k) in list(self._breach) if r == rule.name}
            tracked |= {k for (r, k) in list(self.firing) if r == rule.name}
            for key in sorted(set(breached_keys) | tracked):
                self._step(rule, key, key in breached_keys,
                           breached_keys.get(key, 0.0), tick, events)
        return events

    def _step(
        self, rule: AlertRule, entity, breach: bool, value: float,
        tick: int, events: list[dict],
    ) -> None:
        fkey = (rule.name, entity)
        if breach:
            self._ok.pop(fkey, None)
            if fkey in self.firing:
                self.firing[fkey]["value"] = value
                self.firing[fkey]["ticks"] = tick - self.firing[fkey]["since_tick"]
                return
            streak = self._breach.get(fkey, 0) + 1
            if streak >= rule.for_ticks:
                self._breach.pop(fkey, None)
                info = {
                    "rule": rule.name, "scope": rule.scope,
                    "entity": self._entity_str(entity),
                    "metric": rule.metric, "value": value,
                    "threshold": rule.threshold, "severity": rule.severity,
                    "since_tick": tick, "ticks": 0,
                }
                self.firing[fkey] = info
                self.fired_total += 1
                self.fired_rules.add(rule.name)
                events.append({"event": "fired", **info})
            else:
                self._breach[fkey] = streak
            return
        # not breaching
        self._breach.pop(fkey, None)
        if fkey in self.firing:
            ok = self._ok.get(fkey, 0) + 1
            if ok >= rule.clear_ticks:
                info = self.firing.pop(fkey)
                self._ok.pop(fkey, None)
                self.resolved_total += 1
                events.append({"event": "resolved", **info,
                               "resolved_tick": tick})
            else:
                self._ok[fkey] = ok

    @staticmethod
    def _entity_str(entity) -> str:
        if isinstance(entity, tuple):
            return "/".join(str(p) for p in entity)
        return str(entity)

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict:
        firing = sorted(
            self.firing.values(),
            key=lambda i: (i["rule"], i["entity"]))
        return {
            "rules": [
                {
                    "name": r.name, "scope": r.scope, "metric": r.metric,
                    "op": r.op, "mode": r.mode, "threshold": r.threshold,
                    "for_ticks": r.for_ticks, "clear_ticks": r.clear_ticks,
                    "severity": r.severity,
                }
                for r in self.rules
            ],
            "firing": firing,
            "fired_total": self.fired_total,
            "resolved_total": self.resolved_total,
            "fired_rules": sorted(self.fired_rules),
            "recent": list(self.history),
        }

    def record(self, events: list[dict]) -> None:
        self.history.extend(events)
