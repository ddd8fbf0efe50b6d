"""ControlService: the predictive control plane's runtime half.

Sampling and actuation happen on the event loop; the decision evaluation
runs on a single-worker executor (the Arax split — accelerator/decision
work never blocks the serving path). Each tick:

  1. gather one ``ControlInputs`` snapshot on the loop (flow ladder
     state, gate-growth trend, forecaster output when fresh + trusted,
     per-queue telemetry, peer loads over the cluster control plane),
  2. evaluate off-loop (deterministic; see engine.py),
  3. apply each decision through existing actuators — the accountant's
     stage floor + per-connection publish credit for admission, cluster
     holdership handoff for rebalance, the cluster consume-credit window
     for prefetch — unless ``dry_run`` is set, in which case decisions
     are logged and counted but provably mutate nothing.

Every decision lands in a bounded log with its input snapshot; the log
serializes canonically (sorted keys, fixed float rounding) so two runs
over the same telemetry series compare byte-for-byte. ``/admin/control``
serves ``snapshot()`` and flips ``dry_run`` at runtime (the rollout
path: observe decisions in dry-run, then enable).
"""
from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from .. import events, trace
from ..flow import STAGE_THROTTLE
from .engine import ControlConfig, ControlEngine, ControlInputs, QueueInput

log = logging.getLogger(__name__)

# telemetry QUEUE_FIELDS column order (telemetry/service.py)
_Q_PUBLISH, _Q_DELIVER, _Q_ACK, _Q_DEPTH, _Q_UNACKED, _Q_CONSUMERS, \
    _Q_READY_BYTES = range(7)


class ControlService:
    def __init__(
        self,
        broker,
        *,
        interval_s: float = 1.0,
        dry_run: bool = True,
        admission: bool = True,
        rebalance: bool = True,
        prefetch: bool = True,
        horizon_s: float = 5.0,
        arm_ticks: int = 2,
        cooldown_s: float = 10.0,
        rebalance_cooldown_s: float = 30.0,
        credit_factor: float = 0.5,
        credit_min: int = 4096,
        rebalance_ratio: float = 1.5,
        rebalance_min_rate: float = 1024.0,
        prefetch_min: int = 8,
        prefetch_max: int = 256,
        log_size: int = 256,
        forecast_max_age_s: float = 10.0,
        forecast_error_gate: float = 0.5,
        join_window_s: float = 30.0,
    ) -> None:
        self.broker = broker
        self.interval_s = max(0.05, float(interval_s))
        self.dry_run = bool(dry_run)
        self.admission_enabled = bool(admission)
        self.rebalance_enabled = bool(rebalance)
        self.prefetch_enabled = bool(prefetch)
        self.forecast_max_age_s = float(forecast_max_age_s)
        self.forecast_error_gate = float(forecast_error_gate)
        ticks = lambda s: max(1, int(round(float(s) / self.interval_s)))
        self.cfg = ControlConfig(
            horizon_ticks=ticks(horizon_s),
            arm_ticks=max(1, int(arm_ticks)),
            cooldown_ticks=ticks(cooldown_s),
            credit_factor=float(credit_factor),
            credit_min=int(credit_min),
            rebalance_ratio=float(rebalance_ratio),
            rebalance_min_rate=float(rebalance_min_rate),
            rebalance_cooldown_ticks=ticks(rebalance_cooldown_s),
            prefetch_min=int(prefetch_min),
            prefetch_max=int(prefetch_max),
            prefetch_cooldown_ticks=ticks(cooldown_s),
        )
        self.engine = ControlEngine(self.cfg)
        self.tick = 0
        self.log: deque = deque(maxlen=max(16, int(log_size)))
        # inflow EWMA (bytes/s) — the load figure peers compare for
        # rebalancing, served over the `control.load` cluster RPC
        self.load_rate = 0.0
        self._last_gate_total: Optional[int] = None
        self._last_published_bytes: Optional[int] = None
        # original publish credit, saved at pre-arm so relax restores it
        self._orig_credit: Optional[int] = None
        # join-triggered rebalance: a member that came up recently is fed
        # to the engine as an explicit target for a bounded tick window
        self._join_window_ticks = ticks(join_window_s)
        self._join_target: Optional[str] = None
        self._join_deadline_tick = 0
        self._member_listener = None
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="control")
        broker.control = self

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        cluster = self.broker.cluster
        if cluster is not None and cluster.membership is not None:

            def _on_member(event: str, member) -> None:
                if event == "up" and member.name != cluster.name:
                    self.note_member_join(member.name)

            self._member_listener = _on_member
            cluster.membership.listeners.append(_on_member)
        self._task = asyncio.get_event_loop().create_task(self._run())
        log.info("control plane started (interval=%.2fs dry_run=%s)",
                 self.interval_s, self.dry_run)

    def note_member_join(self, name: str) -> None:
        """A member joined: make it a rebalance target for a bounded
        window so backlog drains onto it without waiting for this node's
        load to diverge. Joins observed before the first tick are boot
        convergence, not elasticity — ignored."""
        if not self.rebalance_enabled or self.tick < 1:
            return
        self._join_target = name
        self._join_deadline_tick = self.tick + self._join_window_ticks

    async def stop(self) -> None:
        self._stopping = True
        cluster = self.broker.cluster
        if self._member_listener is not None and cluster is not None \
                and cluster.membership is not None:
            try:
                cluster.membership.listeners.remove(self._member_listener)
            except ValueError:
                pass
            self._member_listener = None
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        self._executor.shutdown(wait=False)
        if self.broker.control is self:
            self.broker.control = None

    async def _run(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.interval_s)
            try:
                await self.step(self.interval_s)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.broker.metrics.control_errors += 1
                log.exception("control tick failed")

    # -- one control tick (public: soaks/tests drive it manually) ----------

    async def step(self, dt_s: float) -> list:
        broker = self.broker
        flow = broker.flow
        if flow is None:
            return []  # no ladder configured: nothing to project against
        broker.metrics.control_ticks += 1
        self.tick += 1
        inputs = self._gather(dt_s)
        if self.rebalance_enabled:
            inputs.peer_loads = await self._peer_loads()
        loop = asyncio.get_event_loop()
        decisions, suppressed = await loop.run_in_executor(
            self._executor, self.engine.evaluate, inputs)
        broker.metrics.control_suppressed += suppressed
        for decision in decisions:
            broker.metrics.control_decisions += 1
            applied = False
            if self.dry_run:
                broker.metrics.control_dry_run += 1
            else:
                try:
                    applied = await self._apply(decision)
                except Exception:
                    broker.metrics.control_errors += 1
                    log.exception("control decision %s failed to apply",
                                  decision["id"])
            if applied:
                broker.metrics.control_applied += 1
            entry = dict(decision)
            entry["applied"] = applied
            entry["dry_run"] = self.dry_run
            self.log.append(entry)
            bus = events.ACTIVE
            if bus is not None:
                bus.emit(f"control.decision.{decision['kind']}", entry)
            if trace.ACTIVE is not None:
                trace.ACTIVE.note_chaos_fire(
                    f"control:{decision['kind']}:{decision['id']}")
            log.info("control decision %s %s %s (applied=%s dry_run=%s)",
                     decision["id"], decision["kind"], decision["action"],
                     applied, self.dry_run)
        return decisions

    # -- input gathering (event loop side) ---------------------------------

    def _gather(self, dt_s: float) -> ControlInputs:
        broker = self.broker
        flow = broker.flow
        gate_total = flow.total - flow.components.get("held", 0)
        # observed resident growth: the reactive trend the engine falls
        # back on when no trusted forecast is available
        if self._last_gate_total is None or dt_s <= 0:
            net_rate = 0.0
        else:
            net_rate = (gate_total - self._last_gate_total) / dt_s
        self._last_gate_total = gate_total
        published = broker.metrics.published_bytes
        if self._last_published_bytes is not None and dt_s > 0:
            inst = max(0.0, (published - self._last_published_bytes) / dt_s)
            self.load_rate = 0.7 * self.load_rate + 0.3 * inst
        self._last_published_bytes = published
        forecast_net = self._forecast_net_rate()
        queues = self._queue_inputs() if (
            self.rebalance_enabled or self.prefetch_enabled) else ()
        cluster = broker.cluster
        consume_credit = None
        if self.prefetch_enabled and cluster is not None:
            consume_credit = cluster.consume_credit
        join_target = None
        if self._join_target is not None:
            membership = cluster.membership if cluster is not None else None
            expired = self.tick > self._join_deadline_tick
            gone = (membership is None
                    or self._join_target not in
                    membership.placement_members())
            if expired or gone:
                self._join_target = None
            else:
                join_target = self._join_target
        inputs = ControlInputs(
            tick=self.tick,
            interval_s=self.interval_s,
            stage=flow.stage,
            floor=flow.floor,
            gate_total=gate_total,
            enter_throttle=(flow.enter[STAGE_THROTTLE]
                            if self.admission_enabled else 0),
            exit_throttle=flow.exit[STAGE_THROTTLE],
            net_rate=net_rate,
            publish_credit=broker.flow_publish_credit,
            forecast_net_rate=forecast_net,
            queues=queues,
            node=broker.trace_node,
            self_load=self.load_rate,
            consume_credit=consume_credit,
            join_target=join_target,
        )
        return inputs

    def _forecast_net_rate(self) -> Optional[float]:
        """Forecast net inflow (bytes/s) iff the model output is fresh and
        its tracked accuracy passes the gate; None falls the engine back
        to the observed trend."""
        forecaster = self.broker.forecaster
        if forecaster is None or not getattr(forecaster, "forecast", None):
            return None
        updated = getattr(forecaster, "updated_at", None)
        if updated is None or \
                time.time() - updated > self.forecast_max_age_s:
            return None
        if not self._forecast_trusted(forecaster):
            return None
        fc = forecaster.forecast
        inflow = fc.get("publish_bytes_rate")
        outflow = fc.get("deliver_bytes_rate")
        if inflow is None or outflow is None:
            return None
        return float(inflow) - float(outflow)

    def _forecast_trusted(self, forecaster) -> bool:
        accuracy = getattr(forecaster, "accuracy", None)
        acc = accuracy() if callable(accuracy) else accuracy
        if not acc or not acc.get("scored"):
            return False
        mae = acc.get("mae") or {}
        err = mae.get("publish_bytes_rate")
        if err is None:
            return False
        scale = max(abs(self.load_rate), 1024.0)
        return err <= self.forecast_error_gate * scale

    def _queue_inputs(self) -> tuple:
        broker = self.broker
        telemetry = broker.telemetry
        if telemetry is None:
            return ()
        keys, latest = telemetry.queues.latest_matrix()
        if not keys:
            return ()
        slot_depths = self._forecast_slot_depths()
        out = []
        for i, key in enumerate(keys):
            vhost, name = key
            row = latest[i]
            out.append(QueueInput(
                vhost=vhost, name=name,
                depth=float(row[_Q_DEPTH]),
                publish_rate=float(row[_Q_PUBLISH]),
                deliver_rate=float(row[_Q_DELIVER]),
                ack_rate=float(row[_Q_ACK]),
                ready_bytes=float(row[_Q_READY_BYTES]),
                consumers=float(row[_Q_CONSUMERS]),
                movable=self._movable(vhost, name),
                forecast_depth=slot_depths.get(key),
            ))
        return tuple(out)

    def _forecast_slot_depths(self) -> dict:
        forecaster = self.broker.forecaster
        if forecaster is None or not getattr(forecaster, "forecast", None):
            return {}
        slots = getattr(forecaster, "slot_queues", None)
        if slots is None:
            return {}
        depths = {}
        for i, key in enumerate(slots()):
            if key is None:
                continue
            value = forecaster.forecast.get(f"top{i}_depth")
            if value is not None:
                depths[tuple(key)] = float(value)
        return depths

    def _movable(self, vhost_name: str, name: str) -> bool:
        """Safe-to-hand-off check: the queue's durable content must be
        recoverable by the target from the shared store and every
        attached consumer re-registrable from its origin node."""
        broker = self.broker
        cluster = broker.cluster
        if not self.rebalance_enabled or cluster is None:
            return False
        if (vhost_name, name) not in cluster.queue_metas:
            return False
        if not cluster.owns_queue(vhost_name, name):
            return False
        vhost = broker.vhosts.get(vhost_name)
        queue = vhost.queues.get(name) if vhost is not None else None
        if queue is None or queue.deleted or queue.is_stream:
            return False
        if queue.exclusive_owner is not None or queue.outstanding:
            return False
        from ..cluster.node import RemoteConsumer
        if any(not isinstance(c, RemoteConsumer) for c in queue.consumers):
            return False
        if queue.messages:
            if not queue.durable:
                return False
            if any(not qm.message.persisted for qm in queue.messages):
                return False
        return True

    async def _peer_loads(self) -> dict:
        cluster = self.broker.cluster
        if cluster is None or cluster.membership is None:
            return {}
        loads = {}
        for peer in cluster.membership.alive_members():
            if peer == cluster.name:
                continue
            try:
                reply = await cluster._call(peer, "control.load", {},
                                            timeout_s=1.0)
                loads[peer] = float(reply.get("load", 0.0))
            except Exception:
                continue  # degraded view; rebalance just sees fewer peers
        return loads

    # -- actuation ---------------------------------------------------------

    async def _apply(self, decision: dict) -> bool:
        kind = decision["kind"]
        action = decision["action"]
        broker = self.broker
        flow = broker.flow
        if kind == "admission.prearm":
            if not self.admission_enabled or flow is None:
                return False
            if self._orig_credit is None:
                self._orig_credit = broker.flow_publish_credit
            credit = int(action.get("publish_credit", 0))
            if credit > 0:
                broker.flow_publish_credit = credit
            flow.floor = STAGE_THROTTLE
            flow.reevaluate()
            return True
        if kind == "admission.relax":
            if flow is None:
                return False
            flow.floor = 0
            if self._orig_credit is not None:
                broker.flow_publish_credit = self._orig_credit
                self._orig_credit = None
            flow.reevaluate()
            return True
        if kind == "rebalance.move":
            cluster = broker.cluster
            if cluster is None or not self.rebalance_enabled:
                return False
            moved = await cluster.handoff_queue(
                str(action["vhost"]), str(action["name"]),
                str(action["target"]), decision=decision["id"])
            if action.get("join"):
                # one seeding move per observed join
                self._join_target = None
                if moved:
                    broker.metrics.lifecycle_join_rebalances += 1
            return moved
        if kind == "prefetch.tune":
            cluster = broker.cluster
            if cluster is None or not self.prefetch_enabled:
                return False
            cluster.consume_credit = max(1, int(action["consume_credit"]))
            return True
        return False

    # -- introspection -----------------------------------------------------

    def decision_log_bytes(self) -> bytes:
        """Canonical serialization of the full retained log — the form
        the soak byte-compares across same-seed runs."""
        return "\n".join(
            json.dumps(entry, sort_keys=True, separators=(",", ":"))
            for entry in self.log
        ).encode()

    def gauges(self) -> dict:
        """Merged into broker.metrics_snapshot() (/admin/metrics)."""
        flow = self.broker.flow
        return {
            "control_floor": flow.floor if flow is not None else 0,
            "control_armed": 1 if self.engine.snapshot()["armed"] else 0,
            "control_load_rate": round(self.load_rate, 1),
            "control_log_entries": len(self.log),
        }

    def snapshot(self, tail: int = 32) -> dict:
        flow = self.broker.flow
        metrics = self.broker.metrics
        return {
            "enabled": True,
            "dry_run": self.dry_run,
            "interval_s": self.interval_s,
            "tick": self.tick,
            "features": {
                "admission": self.admission_enabled,
                "rebalance": self.rebalance_enabled,
                "prefetch": self.prefetch_enabled,
            },
            "config": {
                "horizon_ticks": self.cfg.horizon_ticks,
                "arm_ticks": self.cfg.arm_ticks,
                "cooldown_ticks": self.cfg.cooldown_ticks,
                "credit_factor": self.cfg.credit_factor,
                "credit_min": self.cfg.credit_min,
                "rebalance_ratio": self.cfg.rebalance_ratio,
                "rebalance_cooldown_ticks": self.cfg.rebalance_cooldown_ticks,
                "prefetch_min": self.cfg.prefetch_min,
                "prefetch_max": self.cfg.prefetch_max,
            },
            "engine": self.engine.snapshot(),
            "flow": {
                "stage": flow.stage if flow is not None else 0,
                "floor": flow.floor if flow is not None else 0,
            },
            "load_rate": round(self.load_rate, 1),
            "counters": {
                "ticks": metrics.control_ticks,
                "decisions": metrics.control_decisions,
                "applied": metrics.control_applied,
                "suppressed": metrics.control_suppressed,
                "dry_run": metrics.control_dry_run,
                "errors": metrics.control_errors,
            },
            "log": list(self.log)[-max(0, tail):],
        }
