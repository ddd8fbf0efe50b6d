"""Overload-protection ladder (chanamq_tpu_torch/flow/): watermark hysteresis,
per-connection publish credit, Channel.Flow wire behavior, lazy body
paging, stage-4 publish refusal, readiness coupling, and the two scripted
scenarios (overload soak, connection churn).

The ladder tests drive pressure synchronously through the accountant's
``chaos`` component (``broker.flow.add("chaos", N)``): with no chaos plan
installed the sweep's _flow_tick leaves that component alone, so stage
transitions happen at a deterministic point in the test instead of riding
wall-clock tick timing.

The port's copy of ``tests/test_flow.py``: imports point at
``chanamq_tpu_torch``, every broker's router and every soak on the CPU;
the assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.chaos.plan import FaultPlan, FaultRule
from chanamq_tpu_torch.chaos.runtime import ChaosRuntime
from chanamq_tpu_torch.chaos.soak import (
    OVERLOAD_ALERT_RULES,
    run_connection_churn,
    run_overload_soak,
)
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.flow import (
    MemoryAccountant,
    STAGE_CLUSTER,
    STAGE_NORMAL,
    STAGE_PAGE,
    STAGE_REFUSE,
    STAGE_THROTTLE,
)
from chanamq_tpu_torch.store.memory import MemoryStore

pytestmark = pytest.mark.asyncio


async def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = asyncio.get_event_loop().time() + timeout
    while not predicate():
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError("condition not reached in time")
        await asyncio.sleep(interval)


async def start_broker(**kwargs):
    broker = Broker(store=MemoryStore(), router_device="cpu", **kwargs)
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    return broker, srv


# ---------------------------------------------------------------------------
# accountant unit behavior
# ---------------------------------------------------------------------------

async def test_accountant_thresholds_hysteresis_single_jump():
    """Derived thresholds, hysteresis gaps, and the one-listener-call-per-
    transition contract (a burst that crosses three stages fires ONE
    (old, new) event, not a cascade)."""
    acc = MemoryAccountant(high_watermark=1000, low_watermark=800)
    # derived: hard=2*high, refuse=0.9*hard, page=0.6*high,
    # cluster=(high+refuse)//2
    assert acc.enter == (0, 600, 1000, 1400, 1800)
    assert acc.hard_limit == 2000
    # every exit threshold scales its enter by low/high (stage 2 keeps the
    # exact legacy block-above-high / unblock-at-low contract)
    assert acc.exit == tuple(e * 800 // 1000 for e in acc.enter)

    events = []
    acc.listeners.append(lambda old, new: events.append((old, new)))

    acc.add("chaos", 1900)  # one burst past every enter threshold
    assert acc.stage == STAGE_REFUSE
    assert events == [(0, 4)]

    # hysteresis: below enter[4] but above exit[4]=1440 -> no flap
    acc.add("chaos", -200)
    assert acc.stage == STAGE_REFUSE and len(events) == 1

    # at/below exit[4] but above exit[3]=1120 -> exactly one step down
    acc.add("chaos", -300)
    assert acc.stage == STAGE_CLUSTER
    assert events[-1] == (4, 3)

    # full drain cascades to normal in ONE listener call
    acc.add("chaos", -1400)
    assert acc.stage == STAGE_NORMAL
    assert events[-1] == (3, 0)
    assert len(events) == 3
    assert acc.peak_total == 1900


async def test_accountant_held_excluded_from_gate_but_counted():
    """Parked publish bytes must never feed the gate that parked them
    (deadlock), but they ARE real memory: reported in total and peak."""
    acc = MemoryAccountant(high_watermark=1000)
    acc.add("held", 5000)  # way past every enter threshold
    assert acc.stage == STAGE_NORMAL
    assert acc.total == 5000 and acc.peak_total == 5000
    # non-held bytes still escalate normally on top
    acc.add("bodies", 1100)
    assert acc.stage == STAGE_THROTTLE
    acc.add("bodies", -1100)
    acc.add("held", -5000)
    assert acc.stage == STAGE_NORMAL and acc.total == 0


async def test_accountant_cluster_stall_bounded():
    """Stage >= 3 parks cluster pushes on a BOUNDED wait (pushback, not
    deadlock); below stage 3 the wait returns immediately."""
    acc = MemoryAccountant(high_watermark=1000)
    acc.add("chaos", 1500)  # cluster enter = 1400
    assert acc.stage == STAGE_CLUSTER
    loop = asyncio.get_event_loop()
    t0 = loop.time()
    await acc.cluster_stall(timeout=0.1)  # nothing releases it: times out
    assert loop.time() - t0 >= 0.09
    acc.add("chaos", -1500)
    assert acc.stage == STAGE_NORMAL
    t0 = loop.time()
    await acc.cluster_stall(timeout=5.0)  # event set: immediate
    assert loop.time() - t0 < 0.5


async def test_chaos_pressure_rule_window_deterministic():
    """A pressure rule is armed on matching invocations (after, until] and
    nowhere else; non-matching sites don't consume the window."""
    plan = FaultPlan(5, [FaultRule(
        name="mem", kind="pressure", sites=["flow.tick"],
        after=2, until=5, inflate_bytes=777)])
    rt = ChaosRuntime(plan)
    assert rt.decide("rpc.call") is None  # wrong site: no invocation burned
    fires = [rt.decide("flow.tick") for _ in range(8)]
    hits = [f for f in fires if f is not None]
    assert [f is not None for f in fires] == [
        False, False, True, True, True, False, False, False]
    assert all(f.kind == "pressure" and f.inflate_bytes == 777 for f in hits)


# ---------------------------------------------------------------------------
# wire behavior: channel.flow, publish credit, stage-4 refusal
# ---------------------------------------------------------------------------

async def test_channel_flow_stop_resume_on_wire():
    """Satellite (c): crossing the throttle stage sends Channel.Flow(
    active=false) to publisher channels only; deliveries and redeliveries
    keep flowing while throttled; dropping below the exit threshold sends
    Flow(active=true) and publishing works end-to-end again."""
    broker, srv = await start_broker(flow_high_watermark=64 * 1024)
    pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    pch = await pub.channel()
    await pch.queue_declare("fl_q")
    con = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    cch = await con.channel()
    received = []

    for i in range(5):
        pch.basic_publish(b"m%d" % i, routing_key="fl_q")
    queue = broker.vhosts["/"].queues["fl_q"]
    await wait_for(lambda: len(queue.messages) == 5)

    await cch.basic_qos(prefetch_count=10)
    await cch.basic_consume("fl_q", received.append, no_ack=False)
    await wait_for(lambda: len(received) == 5)

    # throttle: 80 KiB sits between enter[2]=64KiB and enter[3]
    broker.flow.add("chaos", 80 * 1024)
    assert broker.flow.stage == STAGE_THROTTLE
    await wait_for(lambda: pch.flow_events == [False])
    assert pch.flow_active is False
    # consumer-only connection is never flow-stopped (it IS the drain)
    assert cch.flow_events == [] and cch.flow_active is True

    # deliveries keep moving while throttled: requeue one -> redelivery
    cch.basic_nack(received[0].delivery_tag, requeue=True)
    await wait_for(lambda: len(received) == 6)
    assert received[5].redelivered and received[5].body == received[0].body
    for m in received[1:]:
        cch.basic_ack(m.delivery_tag)

    # drain the pressure below exit[2]: resume goes out to the survivors
    broker.flow.add("chaos", -80 * 1024)
    assert broker.flow.stage == STAGE_NORMAL
    await wait_for(lambda: pch.flow_events == [False, True])
    assert pch.flow_active is True
    assert broker.metrics.flow_throttles == 1
    assert broker.metrics.flow_resumes == 1

    pch.basic_publish(b"after", routing_key="fl_q")
    await wait_for(lambda: len(received) == 7)
    assert received[6].body == b"after"

    await pub.close()
    await con.close()
    await srv.stop()


async def test_publish_credit_spends_exactly_then_holds():
    """chana.mq.flow.publish-credit: the first gated publishes spend a
    byte allowance (body + flat overhead each) before the hard hold
    engages — credit 8192 at cost 2048/publish admits exactly 4."""
    broker, srv = await start_broker(
        flow_high_watermark=64 * 1024, flow_publish_credit=8192)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("cr_q")
    ch.basic_publish(b"warm", routing_key="cr_q")  # marks the connection
    queue = broker.vhosts["/"].queues["cr_q"]      # as a publisher
    await wait_for(lambda: len(queue.messages) == 1)

    broker.flow.add("chaos", 80 * 1024)  # close the gate (stage 2)
    assert broker.blocked

    body = b"z" * 1536  # held cost = 1536 + 512 overhead = 2048
    for _ in range(10):
        ch.basic_publish(body, routing_key="cr_q")
    # exactly 4 spend credit and execute; 5..10 park at the gate. The
    # client's auto-FlowOk (answering the throttle's Channel.Flow) rides
    # the same channel and parks FIFO behind them at flat overhead cost.
    await wait_for(lambda: broker.held_bytes == 6 * 2048 + 512)
    assert len(queue.messages) == 1 + 4
    await asyncio.sleep(0.2)  # no slow leak past the exhausted credit
    assert len(queue.messages) == 1 + 4

    # reopen: the held tail releases, everything lands, gauge drains
    broker.flow.add("chaos", -80 * 1024)
    await wait_for(lambda: len(queue.messages) == 11)
    await wait_for(lambda: broker.held_bytes == 0)
    assert broker.metrics.flow_hold_releases == 1
    assert broker.metrics.flow_hold_wait_ns > 0

    got = [await ch.basic_get("cr_q", no_ack=True) for _ in range(11)]
    assert [m.body for m in got] == [b"warm"] + [body] * 10
    await c.close()
    await srv.stop()


async def test_stage4_refuses_fresh_publishes_consumers_drain():
    """Past the refuse watermark a fresh publish gets a 406 channel close
    instead of parking (holding more bodies would march accounted memory
    toward the hard limit); consumers keep draining; once pressure drops
    a new channel publishes normally."""
    broker, srv = await start_broker(flow_high_watermark=64 * 1024)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("rf_q")
    for i in range(3):
        ch.basic_publish(b"pre%d" % i, routing_key="rf_q")
    queue = broker.vhosts["/"].queues["rf_q"]
    await wait_for(lambda: len(queue.messages) == 3)

    # refuse enter = 0.9 * hard = 117964 for high=64KiB; 125000 crosses it
    # while staying under the 128KiB hard limit
    broker.flow.add("chaos", 125_000)
    assert broker.flow.stage == STAGE_REFUSE
    assert broker.flow_refusing

    ch.basic_publish(b"refused", routing_key="rf_q")
    await wait_for(lambda: ch.closed)
    assert ch.close_reason.reply_code == 406
    assert "memory overload" in ch.close_reason.reply_text
    assert broker.metrics.flow_publishes_refused == 1
    assert not c.closed  # channel-level error: the connection survives

    # an independent consumer still drains under refusal (that drain is
    # exactly what de-escalates a real overload)
    con = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    cch = await con.channel()
    for i in range(3):
        m = await cch.basic_get("rf_q", no_ack=True)
        assert m is not None and m.body == b"pre%d" % i
    assert len(queue.messages) == 0

    broker.flow.add("chaos", -125_000)
    assert broker.flow.stage == STAGE_NORMAL
    ch2 = await c.channel()
    ch2.basic_publish(b"recovered", routing_key="rf_q")
    await wait_for(lambda: len(queue.messages) == 1)
    m = await cch.basic_get("rf_q", no_ack=True)
    assert m.body == b"recovered"

    await c.close()
    await con.close()
    await srv.stop()


# ---------------------------------------------------------------------------
# paging, prefetch-size, slow consumers
# ---------------------------------------------------------------------------

async def test_stage1_pages_bodies_to_pressure_cap():
    """Stage 1 shrinks the per-queue resident cap to flow.page-resident:
    the sweep pages queued bodies out (transient included) and gets reap
    hydrate them back intact once pressure clears."""
    broker, srv = await start_broker(
        queue_max_resident=8, flow_page_resident=2,
        message_sweep_interval_s=0.05, flow_high_watermark=64 * 1024)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("pg_q")
    n = 30
    bodies = [b"%05d" % i + b"x" * 1019 for i in range(n)]
    for body in bodies:
        ch.basic_publish(body, routing_key="pg_q")  # transient
    queue = broker.vhosts["/"].queues["pg_q"]
    await wait_for(lambda: len(queue.messages) == n)
    resident_before = broker.resident_bytes
    assert resident_before <= 9 * 1024  # base cap already pages past 8

    # 45000 sits between enter[1]=39321 and enter[2]=65536: page stage
    # only — no throttle, the publisher is untouched
    broker.flow.add("chaos", 45_000)
    assert broker.flow.stage == STAGE_PAGE
    assert broker.flow_paging and not broker.blocked
    await wait_for(lambda: broker.metrics.flow_paged_bodies > 0)
    await wait_for(lambda: broker.resident_bytes <= 4 * 1024)
    assert broker.metrics.flow_paged_bytes > 0

    broker.flow.add("chaos", -45_000)
    assert not broker.flow_paging
    for body in bodies:  # paged bodies hydrate back, in order, intact
        m = await ch.basic_get("pg_q", no_ack=True)
        assert m is not None and m.body == body
    await c.close()
    await srv.stop()


async def test_prefetch_size_budget_enforced():
    """Satellite (a): basic.qos prefetch_size is a BYTE budget — with a
    2500-byte window and 2048-byte bodies, manual-ack delivery goes one
    message at a time; an oversized body still goes through when nothing
    is unacked (RabbitMQ's let-one-through rule)."""
    broker, srv = await start_broker()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("ps_q")
    body = b"q" * 2048
    for _ in range(3):
        ch.basic_publish(body, routing_key="ps_q")
    queue = broker.vhosts["/"].queues["ps_q"]
    await wait_for(lambda: len(queue.messages) == 3)

    await ch.basic_qos(prefetch_size=2500)
    received = []
    await ch.basic_consume("ps_q", received.append, no_ack=False)
    await wait_for(lambda: len(received) == 1)
    await asyncio.sleep(0.2)  # a second delivery would breach the budget
    assert len(received) == 1
    ch.basic_ack(received[0].delivery_tag)
    await wait_for(lambda: len(received) == 2)
    await asyncio.sleep(0.1)
    assert len(received) == 2
    ch.basic_ack(received[1].delivery_tag)
    await wait_for(lambda: len(received) == 3)
    ch.basic_ack(received[2].delivery_tag)

    # oversized single message: delivered as long as nothing is unacked
    ch.basic_publish(b"B" * 3000, routing_key="ps_q")
    await wait_for(lambda: len(received) == 4)
    assert received[3].body == b"B" * 3000
    ch.basic_ack(received[3].delivery_tag)
    await c.close()
    await srv.stop()


async def test_slow_consumer_buffer_detection_and_reset():
    """chana.mq.flow.consumer-buffer: a consumer whose rendered-but-unsent
    delivery bytes exceed the bound stops taking (detected once per
    episode); the detection clears when the connection's output buffer
    drains to the kernel, and delivery continues."""
    broker, srv = await start_broker(flow_consumer_buffer=4096)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("sl_q")
    received = []
    await ch.basic_consume("sl_q", received.append, no_ack=True)
    queue = broker.vhosts["/"].queues["sl_q"]
    await wait_for(lambda: len(queue.consumers) == 1)
    consumer = queue.consumers[0]

    ch.basic_publish(b"d" * 512, routing_key="sl_q")
    await wait_for(lambda: len(received) == 1)

    # drive the admission check at a deterministic buffer level instead of
    # racing the writer loop's drain
    consumer.buffered_bytes = 5000
    assert consumer.can_take(100) is False
    assert consumer.slow is True
    assert broker.metrics.flow_slow_consumers == 1
    assert consumer.can_take(100) is False  # one detection per episode
    assert broker.metrics.flow_slow_consumers == 1

    # kernel drain resets the episode and re-opens admission
    consumer.channel.connection._reset_consumer_buffers()
    assert consumer.buffered_bytes == 0 and consumer.slow is False
    assert consumer.can_take(100) is True

    for i in range(5):  # end-to-end: delivery still flows after the episode
        ch.basic_publish(b"post%d" % i, routing_key="sl_q")
    await wait_for(lambda: len(received) == 6)
    assert [m.body for m in received[1:]] == [b"post%d" % i for i in range(5)]
    await c.close()
    await srv.stop()


# ---------------------------------------------------------------------------
# readiness coupling
# ---------------------------------------------------------------------------

async def test_health_surfaces_stage_not_ready_only_at_refuse():
    """Satellite (b): /admin/health always surfaces the ladder stage, but
    readiness only drops at refuse — a throttling broker is still doing
    useful work and must keep its traffic."""
    from chanamq_tpu_torch.rest.admin import AdminServer
    from chanamq_tpu_torch.telemetry import TelemetryService
    from chanamq_tpu_torch.telemetry.alerts import default_rules

    broker, srv = await start_broker(flow_high_watermark=64 * 1024)
    broker.telemetry = TelemetryService(
        broker, interval_s=1.0, ring_ticks=16, rules=default_rules())
    admin = AdminServer(broker, host="127.0.0.1", port=0)
    await admin.start()

    async def http_health():
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", admin.bound_port)
        writer.write(b"GET /admin/health HTTP/1.1\r\n\r\n")
        raw = await asyncio.wait_for(reader.read(-1), 10)
        writer.close()
        return raw.split(b"\r\n", 1)[0]

    out = broker.telemetry.health()
    assert out["ready"] is True
    mp = out["checks"]["memory_pressure"]
    assert mp["ok"] is True and mp["stage_label"] == "normal"
    assert (await http_health()).startswith(b"HTTP/1.1 200")

    broker.flow.add("chaos", 80 * 1024)  # throttle: degraded but READY
    out = broker.telemetry.health()
    assert out["ready"] is True
    assert out["checks"]["memory_pressure"]["stage_label"] == "throttle"

    broker.flow.add("chaos", 45_000)  # 125000 total: refuse -> NOT ready
    out = broker.telemetry.health()
    assert out["ready"] is False
    assert any("memory pressure" in r for r in out["reasons"])
    assert (await http_health()).startswith(b"HTTP/1.1 503")

    broker.flow.add("chaos", -125_000)
    assert broker.telemetry.health()["ready"] is True
    assert (await http_health()).startswith(b"HTTP/1.1 200")

    await admin.stop()
    await srv.stop()


async def test_health_fallback_without_telemetry_sees_pressure():
    """Telemetry is off by default — the /admin/health fallback must still
    surface the ladder and go 503 at refuse, or a default-config broker
    under overload keeps taking load-balanced traffic."""
    from chanamq_tpu_torch.rest.admin import AdminServer

    broker, srv = await start_broker(flow_high_watermark=64 * 1024)
    assert getattr(broker, "telemetry", None) is None
    admin = AdminServer(broker, host="127.0.0.1", port=0)
    await admin.start()

    async def http_health():
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", admin.bound_port)
        writer.write(b"GET /admin/health HTTP/1.1\r\n\r\n")
        raw = await asyncio.wait_for(reader.read(-1), 10)
        writer.close()
        import json
        return (raw.split(b"\r\n", 1)[0],
                json.loads(raw.split(b"\r\n\r\n", 1)[1]))

    status, out = await http_health()
    assert status.startswith(b"HTTP/1.1 200")
    assert out["checks"]["memory_pressure"]["stage_label"] == "normal"

    broker.flow.add("chaos", 125_000)  # refuse
    status, out = await http_health()
    assert status.startswith(b"HTTP/1.1 503")
    assert out["ready"] is False
    assert any("memory pressure" in r for r in out["reasons"])

    broker.flow.add("chaos", -125_000)
    status, _ = await http_health()
    assert status.startswith(b"HTTP/1.1 200")
    await admin.stop()
    await srv.stop()


# ---------------------------------------------------------------------------
# scripted scenarios
# ---------------------------------------------------------------------------

async def test_overload_soak_invariants():
    """The acceptance scenario end-to-end: scripted memory-pressure
    chaos pushes the broker to refuse; accounted bytes stay under the hard
    limit, nothing confirmed is lost, paging + refusals + the exact
    memory-pressure alert all happen, and the broker returns to normal
    with a full channel.flow resume."""
    report = await asyncio.wait_for(run_overload_soak(7, messages=96, device="cpu"), 120)
    assert report["violations"] == []
    assert report["under_hard_limit"] is True
    assert report["publishes_refused"] > 0
    assert report["paged_bodies"] > 0
    assert report["drained_under_refuse"] > 0
    assert report["confirmed"] == report["delivered_unique"] == 96
    assert report["duplicates"] == 0
    assert tuple(report["alerts"]["fired_rules"]) == OVERLOAD_ALERT_RULES
    assert report["final_stage"] == 0
    assert report["flow_resumes"] >= 1


async def test_connection_churn_leaks_nothing():
    """Satellite (f): connect/declare/publish/disconnect cycles — half of
    them abrupt transport aborts — leave zero accounted bytes behind."""
    report = await asyncio.wait_for(run_connection_churn(cycles=60, device="cpu"), 120)
    assert report["violations"] == []
    assert report["leaked_bytes"] == 0
    assert report["aborted"] == 30
    assert report["final_stage"] == 0
    assert report["live_queues"] == 0
