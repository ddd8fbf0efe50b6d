"""Predictive control plane tests: engine determinism, hysteresis and
cooldown, the accountant stage floor, dry-run's no-mutation guarantee,
apply/relax round-trips, identity-pinned forecast slots, forecast
accuracy tracking, cluster queue handoff, and the /admin/control surface.

The port's copy of ``tests/test_control.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import json

import numpy as np
import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.control import (
    ControlConfig, ControlEngine, ControlInputs, ControlService, QueueInput,
)
from chanamq_tpu_torch.flow import (
    MemoryAccountant, STAGE_NORMAL, STAGE_THROTTLE,
)
from chanamq_tpu_torch.models.telemetry import TopKSlots
from chanamq_tpu_torch.store.memory import MemoryStore

pytestmark = pytest.mark.asyncio

PROPS = BasicProperties()


def canonical(decisions: list) -> bytes:
    return b"\n".join(
        json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
        for d in decisions)


# ---------------------------------------------------------------------------
# pure engine
# ---------------------------------------------------------------------------


def ramp_inputs(tick: int, gate: int, net: float, *, floor: int = 0,
                stage: int = 0) -> ControlInputs:
    return ControlInputs(
        tick=tick, interval_s=1.0, stage=stage, floor=floor,
        gate_total=gate, enter_throttle=1000, exit_throttle=800,
        net_rate=net, publish_credit=16384)


async def test_engine_same_series_same_log():
    """The tentpole determinism contract: the engine is a pure function
    of the input series, so two engines fed the same snapshots emit
    byte-identical decision logs."""
    logs = []
    for _ in range(2):
        engine = ControlEngine(ControlConfig(
            horizon_ticks=5, arm_ticks=2, cooldown_ticks=3))
        out = []
        floor = 0   # mirrors the applier: prearm pins it, relax drops it
        gate = 0
        for t in range(1, 8):
            net = 120.0 if t > 1 else 0.0
            gate += int(net)
            decisions, _ = engine.evaluate(
                ramp_inputs(t, gate, net, floor=floor, stage=floor))
            out.extend(decisions)
            for d in decisions:
                floor = d["action"].get("floor", floor)
        for t in range(8, 14):  # drained: the relax side of the episode
            decisions, _ = engine.evaluate(
                ramp_inputs(t, 0, -700.0 if t == 8 else 0.0,
                            floor=floor, stage=floor))
            out.extend(decisions)
            for d in decisions:
                floor = d["action"].get("floor", floor)
        logs.append(canonical(out))
    assert logs[0] == logs[1]
    kinds = [json.loads(line)["kind"] for line in logs[0].split(b"\n")]
    assert kinds == ["admission.prearm", "admission.relax"]


async def test_engine_hysteresis_and_cooldown():
    engine = ControlEngine(ControlConfig(
        horizon_ticks=5, arm_ticks=2, cooldown_ticks=10))
    # one breaching tick is not enough (arm_ticks=2)
    decisions, suppressed = engine.evaluate(ramp_inputs(1, 900, 100.0))
    assert decisions == [] and suppressed == 0
    # second consecutive breach arms
    decisions, _ = engine.evaluate(ramp_inputs(2, 1000, 100.0))
    assert [d["kind"] for d in decisions] == ["admission.prearm"]
    assert decisions[0]["action"]["floor"] == STAGE_THROTTLE
    assert decisions[0]["action"]["publish_credit"] == 8192
    # a non-breaching tick resets the arm streak
    engine2 = ControlEngine(ControlConfig(horizon_ticks=5, arm_ticks=2))
    engine2.evaluate(ramp_inputs(1, 900, 100.0))
    engine2.evaluate(ramp_inputs(2, 100, 0.0))
    decisions, _ = engine2.evaluate(ramp_inputs(3, 900, 100.0))
    assert decisions == []
    # relax inside the cooldown window is suppressed, not emitted
    calm = ramp_inputs(3, 0, 0.0, floor=STAGE_THROTTLE,
                       stage=STAGE_THROTTLE)
    decisions, suppressed = engine.evaluate(calm)
    assert decisions == [] and suppressed == 0      # streak 1 of 2
    decisions, suppressed = engine.evaluate(
        ramp_inputs(4, 0, 0.0, floor=STAGE_THROTTLE, stage=STAGE_THROTTLE))
    assert decisions == [] and suppressed == 1      # armed but cooling down
    decisions, _ = engine.evaluate(
        ramp_inputs(12, 0, 0.0, floor=STAGE_THROTTLE, stage=STAGE_THROTTLE))
    assert [d["kind"] for d in decisions] == ["admission.relax"]
    assert decisions[0]["action"]["publish_credit"] == 16384


async def test_engine_forecast_source_preferred():
    engine = ControlEngine(ControlConfig(horizon_ticks=5, arm_ticks=1))
    inp = ramp_inputs(1, 100, 0.0)
    inp.forecast_net_rate = 500.0   # trend says flat, forecast says spike
    decisions, _ = engine.evaluate(inp)
    assert decisions and decisions[0]["inputs"]["source"] == "forecast"
    assert decisions[0]["inputs"]["net_rate"] == 500.0


async def test_engine_rebalance_and_prefetch():
    engine = ControlEngine(ControlConfig(
        arm_ticks=1, rebalance_ratio=1.5, rebalance_min_rate=10.0,
        prefetch_min=8, prefetch_max=64))
    queues = (
        QueueInput(vhost="/", name="busy", depth=50, publish_rate=900,
                   deliver_rate=100, ack_rate=10, ready_bytes=1e5,
                   consumers=1, movable=True),
        QueueInput(vhost="/", name="idle", depth=0, publish_rate=1,
                   deliver_rate=1, ack_rate=1, ready_bytes=0,
                   consumers=1, movable=True),
    )
    inp = ControlInputs(
        tick=1, interval_s=1.0, stage=0, floor=0, gate_total=0,
        enter_throttle=0, exit_throttle=0, net_rate=0.0, publish_credit=0,
        queues=queues, node="a", self_load=1000.0,
        peer_loads={"b": 10.0, "c": 30.0}, consume_credit=32)
    decisions, _ = engine.evaluate(inp)
    kinds = {d["kind"]: d for d in decisions}
    move = kinds["rebalance.move"]
    assert move["action"] == {"vhost": "/", "name": "busy", "target": "b"}
    assert move["inputs"]["loads"]["a"] == 1000.0
    # ack keeps pace with deliver on "idle" but "busy" lags badly ->
    # the lagging queue wins and the window shrinks
    tune = kinds["prefetch.tune"]
    assert tune["action"]["consume_credit"] == 16
    assert tune["inputs"]["reason"] == "ack-lag"


# ---------------------------------------------------------------------------
# accountant stage floor
# ---------------------------------------------------------------------------


async def test_accountant_floor_pins_and_releases():
    acc = MemoryAccountant(high_watermark=1000)
    stages = []
    acc.listeners.append(lambda old, new: stages.append((old, new)))
    acc.floor = STAGE_THROTTLE
    acc.reevaluate()
    assert acc.stage == STAGE_THROTTLE      # pinned with zero bytes
    assert stages == [(STAGE_NORMAL, STAGE_THROTTLE)]
    acc.add("bodies", 100)                  # stays at the floor
    assert acc.stage == STAGE_THROTTLE
    acc.floor = STAGE_NORMAL
    acc.reevaluate()
    assert acc.stage == STAGE_NORMAL        # cascades back down
    assert stages[-1] == (STAGE_THROTTLE, STAGE_NORMAL)
    assert acc.snapshot()["floor"] == STAGE_NORMAL


# ---------------------------------------------------------------------------
# service on a live broker
# ---------------------------------------------------------------------------


def spike_broker() -> Broker:
    return Broker(store=MemoryStore(), flow_high_watermark=1000,
                  flow_hard_limit=4000, flow_publish_credit=16384,
                  message_sweep_interval_s=3600.0, router_device="cpu")


def spike_control(broker: Broker, *, dry_run: bool) -> ControlService:
    return ControlService(
        broker, interval_s=1.0, dry_run=dry_run, admission=True,
        rebalance=False, prefetch=False, horizon_s=5.0, arm_ticks=2,
        cooldown_s=2.0, credit_factor=0.5, credit_min=4096)


async def drive_spike(broker: Broker, control: ControlService) -> None:
    """Deterministic episode: 5 growth ticks (+120 B/s), then a drain
    and 4 quiescent ticks — enough for prearm and relax to both fire."""
    for _ in range(5):
        broker.account_memory(120)
        await control.step(1.0)
    broker.account_memory(-600)
    for _ in range(4):
        await control.step(1.0)


async def test_service_applies_prearm_and_relax():
    broker = spike_broker()
    control = spike_control(broker, dry_run=False)
    try:
        for _ in range(4):
            broker.account_memory(120)
            await control.step(1.0)
        # tick 4: gate 480, net 120 -> projected 1080 crossed 1000 on
        # ticks 4+5; the pre-arm lands on the second breach
        broker.account_memory(120)
        await control.step(1.0)
        assert broker.flow.floor == STAGE_THROTTLE
        assert broker.flow.stage == STAGE_THROTTLE   # pinned early: gate 600
        assert broker.flow_publish_credit == 8192
        assert broker.metrics.control_applied == 1
        # drain, then quiesce: relax must restore both actuators
        broker.account_memory(-600)
        for _ in range(4):
            await control.step(1.0)
        assert broker.flow.floor == STAGE_NORMAL
        assert broker.flow.stage == STAGE_NORMAL
        assert broker.flow_publish_credit == 16384
        assert broker.metrics.control_applied == 2
        kinds = [e["kind"] for e in control.log]
        assert kinds == ["admission.prearm", "admission.relax"]
        assert all(e["applied"] for e in control.log)
    finally:
        await control.stop()


async def test_service_dry_run_mutates_nothing():
    broker = spike_broker()
    control = spike_control(broker, dry_run=True)
    try:
        floors = set()
        credits = set()
        for _ in range(5):
            broker.account_memory(120)
            await control.step(1.0)
            floors.add(broker.flow.floor)
            credits.add(broker.flow_publish_credit)
        broker.account_memory(-600)
        for _ in range(4):
            await control.step(1.0)
            floors.add(broker.flow.floor)
            credits.add(broker.flow_publish_credit)
        # decisions recorded and counted...
        kinds = [e["kind"] for e in control.log]
        assert kinds == ["admission.prearm", "admission.relax"]
        assert all(e["dry_run"] and not e["applied"] for e in control.log)
        assert broker.metrics.control_dry_run == 2
        assert broker.metrics.control_decisions == 2
        # ...but no actuator ever moved
        assert floors == {STAGE_NORMAL}
        assert credits == {16384}
        assert broker.metrics.control_applied == 0
    finally:
        await control.stop()


async def test_service_same_series_byte_identical_log():
    logs = []
    for _ in range(2):
        broker = spike_broker()
        control = spike_control(broker, dry_run=False)
        try:
            await drive_spike(broker, control)
            logs.append(control.decision_log_bytes())
        finally:
            await control.stop()
    assert logs[0] == logs[1]
    assert logs[0]  # non-trivial: prearm + relax present
    entries = [json.loads(line) for line in logs[0].split(b"\n")]
    assert [e["kind"] for e in entries] == \
        ["admission.prearm", "admission.relax"]
    # every entry carries its replayable input snapshot
    assert all("gate_total" in e["inputs"] and "projected" in e["inputs"]
               for e in entries)


async def test_service_gauges_and_snapshot():
    broker = spike_broker()
    control = spike_control(broker, dry_run=False)
    try:
        await drive_spike(broker, control)
        snap = control.snapshot(tail=8)
        assert snap["enabled"] and not snap["dry_run"]
        assert snap["counters"]["applied"] == 2
        assert snap["flow"] == {"stage": 0, "floor": 0}
        assert len(snap["log"]) == 2
        # the broker-wide metrics snapshot folds the control gauges in
        msnap = broker.metrics_snapshot()
        assert msnap["control_log_entries"] == 2
        assert msnap["control_floor"] == 0
        assert msnap["flow_stage_floor"] == 0
    finally:
        await control.stop()


# ---------------------------------------------------------------------------
# identity-pinned forecast slots (models/telemetry.py)
# ---------------------------------------------------------------------------


def matrix(rows: dict[tuple, list]) -> tuple[list, np.ndarray]:
    keys = list(rows)
    # QUEUE_FIELDS order: publish, deliver, ack, depth, unacked,
    # consumers, ready_bytes
    return keys, np.array(list(rows.values()), dtype=np.float64)


async def test_topk_slots_pin_evict_reset():
    slots = TopKSlots(2)
    a, b, c = ("/", "a"), ("/", "b"), ("/", "c")
    keys, latest = matrix({a: [10, 0, 0, 5, 0, 0, 0],
                           b: [5, 0, 0, 7, 0, 0, 0],
                           c: [1, 0, 0, 9, 0, 0, 0]})
    # fresh slots emit zeros for exactly one tick (the reset marker)
    out = slots.update(keys, latest)
    assert slots.slot_queues() == [a, b]
    assert out.tolist() == [0, 0, 0, 0]
    out = slots.update(keys, latest)
    assert out.tolist() == [5, 10, 7, 5]     # (depth, publish_rate) pairs
    # c overtakes b: b is evicted, c lands in the freed slot, and the
    # incumbent a KEEPS its slot even though c now outranks it
    keys, latest = matrix({a: [10, 0, 0, 5, 0, 0, 0],
                           b: [0, 0, 0, 7, 0, 0, 0],
                           c: [99, 0, 0, 9, 0, 0, 0]})
    out = slots.update(keys, latest)
    assert slots.slot_queues() == [a, c]
    assert out.tolist() == [5, 10, 0, 0]     # c's slot resets this tick
    out = slots.update(keys, latest)
    assert out.tolist() == [5, 10, 9, 99]
    # the binding (and therefore the feature layout) is deterministic
    twin = TopKSlots(2)
    keys0, latest0 = matrix({a: [10, 0, 0, 5, 0, 0, 0],
                             b: [5, 0, 0, 7, 0, 0, 0],
                             c: [1, 0, 0, 9, 0, 0, 0]})
    twin.update(keys0, latest0)
    twin.update(keys0, latest0)
    twin.update(keys, latest)
    assert twin.slot_queues() == slots.slot_queues()


async def test_topk_slots_vanished_queue_freed():
    slots = TopKSlots(2)
    a, b = ("/", "a"), ("/", "b")
    keys, latest = matrix({a: [10, 0, 0, 5, 0, 0, 0],
                           b: [5, 0, 0, 7, 0, 0, 0]})
    slots.update(keys, latest)
    keys, latest = matrix({b: [5, 0, 0, 7, 0, 0, 0]})  # a deleted
    slots.update(keys, latest)
    assert slots.slot_queues() == [None, b]
    assert slots.update(keys, latest).tolist() == [0, 0, 7, 5]


# ---------------------------------------------------------------------------
# forecast accuracy tracking (models/service.py)
# ---------------------------------------------------------------------------


async def test_forecast_accuracy_mae():
    from chanamq_tpu_torch.models.service import ForecastService

    broker = Broker(store=MemoryStore(), message_sweep_interval_s=3600.0,
                    router_device="cpu")
    svc = ForecastService(broker, device="cpu")
    assert svc.accuracy() is None            # nothing scored yet
    n = svc.n_features
    svc._pending_forecast = np.full(n, 10.0, dtype=np.float32)
    svc.score_tick(np.full(n, 13.0, dtype=np.float32))
    acc = svc.accuracy()
    assert acc["scored"] == 1
    name = svc.feature_names[0]
    assert acc["last_abs_error"][name] == pytest.approx(3.0)
    assert acc["mae"][name] == pytest.approx(3.0)
    # second sample: running MAE averages the two errors
    svc._pending_forecast = np.full(n, 10.0, dtype=np.float32)
    svc.score_tick(np.full(n, 9.0, dtype=np.float32))
    acc = svc.accuracy()
    assert acc["scored"] == 2
    assert acc["mae"][name] == pytest.approx(2.0)
    # a tick with no pending forecast scores nothing
    svc.score_tick(np.full(n, 100.0, dtype=np.float32))
    assert svc.accuracy()["scored"] == 2
    assert "accuracy" in svc.snapshot()


async def test_control_forecast_trust_gate():
    """An inaccurate or stale forecast must not steer admission."""
    broker = spike_broker()
    control = spike_control(broker, dry_run=True)
    try:
        class FakeForecaster:
            forecast = {"publish_bytes_rate": 5000.0,
                        "deliver_bytes_rate": 0.0}
            updated_at = None

            def accuracy(self):
                return self._acc

            def slot_queues(self):
                return []

        fake = FakeForecaster()
        broker.forecaster = fake
        import time as _time
        fake.updated_at = _time.time()
        fake._acc = {"scored": 5, "mae": {"publish_bytes_rate": 1e9}}
        assert control._forecast_net_rate() is None      # failed the gate
        fake._acc = {"scored": 5, "mae": {"publish_bytes_rate": 1.0}}
        assert control._forecast_net_rate() == pytest.approx(5000.0)
        fake.updated_at = _time.time() - 1e6             # stale
        assert control._forecast_net_rate() is None
    finally:
        broker.forecaster = None
        await control.stop()


# ---------------------------------------------------------------------------
# proactive rebalancing: cluster queue handoff
# ---------------------------------------------------------------------------


async def _start_cluster_pair(tmp_path):
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.cluster.node import ClusterNode
    from chanamq_tpu_torch.store.sqlite import SqliteStore

    store = str(tmp_path / "shared.db")
    nodes = []
    seeds: list = []
    for _ in range(2):
        server = BrokerServer(broker=Broker(store=SqliteStore(store), router_device="cpu"),
                              host="127.0.0.1", port=0, heartbeat_s=0)
        await server.start()
        cluster = ClusterNode(server.broker, "127.0.0.1", 0, list(seeds),
                              heartbeat_interval_s=0.1,
                              failure_timeout_s=0.8)
        await cluster.start()
        nodes.append((server, cluster))
        seeds = [nodes[0][1].name]
    for _ in range(100):
        if all(len(c.membership.alive_members()) == 2 for _, c in nodes):
            break
        await asyncio.sleep(0.05)
    assert all(len(c.membership.alive_members()) == 2 for _, c in nodes)
    return nodes


async def _stop_cluster(nodes):
    for server, cluster in nodes:
        await cluster.stop()
        await server.stop()


async def test_handoff_moves_durable_backlog(tmp_path):
    from chanamq_tpu_torch.client import AMQPClient

    nodes = await _start_cluster_pair(tmp_path)
    try:
        owner_name = nodes[0][1].queue_owner("/", "hq")
        owner = next(n for n in nodes if n[1].name == owner_name)
        other = next(n for n in nodes if n[1].name != owner_name)

        client = await AMQPClient.connect(
            "127.0.0.1", owner[0].bound_port)
        ch = await client.channel()
        await ch.confirm_select()
        await ch.queue_declare("hq", durable=True)
        for i in range(3):
            ch.basic_publish(b"h%d" % i, routing_key="hq",
                             properties=BasicProperties(delivery_mode=2))
        await ch.wait_unconfirmed_below(1, timeout=10)
        await asyncio.sleep(0.3)   # let the store writes settle

        resident_before = owner[0].broker.resident_bytes
        moved = await owner[1].handoff_queue("/", "hq", other[1].name)
        assert moved is True
        # holdership converges on every node
        for _ in range(100):
            if all(c.queue_owner("/", "hq") == other[1].name
                   for _, c in nodes):
                break
            await asyncio.sleep(0.05)
        assert all(c.queue_owner("/", "hq") == other[1].name
                   for _, c in nodes)
        # the origin dropped the queue and released its accounted bytes
        assert "hq" not in owner[0].broker.vhosts["/"].queues
        assert owner[0].broker.resident_bytes < resident_before
        # the target serves the full durable backlog (recovered from the
        # shared store), proxied transparently through the old owner
        ok = await ch.queue_declare("hq", passive=True)
        assert ok.message_count == 3
        msg = await ch.basic_get("hq")
        assert msg.body == b"h0"
        ch.basic_ack(msg.delivery_tag)
        await client.close()
    finally:
        await _stop_cluster(nodes)


async def test_handoff_refuses_unsafe_queues(tmp_path):
    from chanamq_tpu_torch.client import AMQPClient

    nodes = await _start_cluster_pair(tmp_path)
    try:
        owner_name = nodes[0][1].queue_owner("/", "uq")
        owner = next(n for n in nodes if n[1].name == owner_name)
        other = next(n for n in nodes if n[1].name != owner_name)
        client = await AMQPClient.connect(
            "127.0.0.1", owner[0].bound_port)
        ch = await client.channel()
        await ch.queue_declare("uq")          # transient
        ch.basic_publish(b"t0", routing_key="uq")
        await asyncio.sleep(0.3)
        # a transient backlog is NOT recoverable by the target: refused
        assert not await owner[1].handoff_queue("/", "uq", other[1].name)
        assert all(c.queue_owner("/", "uq") == owner[1].name
                   for _, c in nodes)
        # unknown target: refused
        await ch.queue_purge("uq")
        await asyncio.sleep(0.2)
        assert not await owner[1].handoff_queue("/", "uq", "nope")
        await client.close()
    finally:
        await _stop_cluster(nodes)


async def test_handoff_rebinds_remote_consumer(tmp_path):
    from chanamq_tpu_torch.client import AMQPClient

    nodes = await _start_cluster_pair(tmp_path)
    try:
        owner_name = nodes[0][1].queue_owner("/", "rq")
        owner = next(n for n in nodes if n[1].name == owner_name)
        other = next(n for n in nodes if n[1].name != owner_name)
        # consumer attaches through the NON-owner: the owner sees a
        # RemoteConsumer stub, the safe-to-move kind
        c_client = await AMQPClient.connect(
            "127.0.0.1", other[0].bound_port)
        cch = await c_client.channel()
        await cch.queue_declare("rq", durable=True)
        got = []

        def on_msg(msg):
            got.append(bytes(msg.body))
            cch.basic_ack(msg.delivery_tag)

        await cch.basic_consume("rq", on_msg)
        await asyncio.sleep(0.3)

        moved = await owner[1].handoff_queue("/", "rq", other[1].name)
        assert moved is True
        for _ in range(100):
            if all(c.queue_owner("/", "rq") == other[1].name
                   for _, c in nodes):
                break
            await asyncio.sleep(0.05)
        # after the move the consumer's node owns the queue; a publish
        # through the OLD owner must still reach the consumer
        p_client = await AMQPClient.connect(
            "127.0.0.1", owner[0].bound_port)
        pch = await p_client.channel()
        pch.basic_publish(b"after-move", routing_key="rq")
        for _ in range(100):
            if got:
                break
            await asyncio.sleep(0.05)
        assert got == [b"after-move"]
        await p_client.close()
        await c_client.close()
    finally:
        await _stop_cluster(nodes)


async def test_control_load_rpc(tmp_path):
    nodes = await _start_cluster_pair(tmp_path)
    try:
        reply = await nodes[0][1]._call(
            nodes[1][1].name, "control.load", {}, timeout_s=2.0)
        assert reply["node"] == nodes[1][1].name
        assert reply["load"] == 0.0
        # with a control service attached the RPC reports its EWMA
        control = ControlService(nodes[1][0].broker, rebalance=False,
                                 prefetch=False)
        control.load_rate = 123.5
        try:
            reply = await nodes[0][1]._call(
                nodes[1][1].name, "control.load", {}, timeout_s=2.0)
            assert reply["load"] == 123.5
        finally:
            await control.stop()
    finally:
        await _stop_cluster(nodes)


# ---------------------------------------------------------------------------
# /admin/control surface
# ---------------------------------------------------------------------------


async def _admin_req(port: int, path: str, method: str = "GET",
                     body: bytes = b"") -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = (f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    writer.write(head + body)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(262144), 5)
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), (json.loads(payload) if payload else {})


async def test_admin_control_endpoints():
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.rest.admin import AdminServer

    server = BrokerServer(broker=spike_broker(), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    control = None
    try:
        # disabled: GET reports it, configure conflicts
        status, body = await _admin_req(admin.bound_port, "/admin/control")
        assert status == 200 and body == {"enabled": False}
        status, _ = await _admin_req(
            admin.bound_port, "/admin/control/configure", "POST", b"{}")
        assert status == 409

        control = ControlService(server.broker, dry_run=True,
                                 rebalance=False, prefetch=False)
        await control.step(1.0)
        status, body = await _admin_req(
            admin.bound_port, "/admin/control?log=4")
        assert status == 200
        assert body["enabled"] and body["dry_run"]
        assert body["tick"] == 1
        assert body["counters"]["ticks"] == 1
        # the rollout flip: dry-run off at runtime, no restart
        status, body = await _admin_req(
            admin.bound_port, "/admin/control/configure", "POST",
            json.dumps({"dry-run": False, "rebalance": True}).encode())
        assert status == 200
        assert body["ok"] and body["dry_run"] is False
        assert body["features"]["rebalance"] is True
        assert control.dry_run is False

        # control counters + floor gauge land on the Prometheus surface
        status, _ = await _admin_req(admin.bound_port, "/admin/control")
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", admin.bound_port)
        writer.write(b"GET /metrics HTTP/1.1\r\n"
                     b"Host: localhost\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(262144), 5)
        writer.close()
        text = raw.decode(errors="replace")
        assert "chanamq_control_ticks" in text
        assert "# TYPE chanamq_control_decisions counter" in text
        assert "chanamq_control_floor" in text
    finally:
        if control is not None:
            await control.stop()
        await admin.stop()
        await server.stop()
