"""Inbound publisher backpressure + bounded memory under hostile load.

VERDICT r3 #2: a fast publisher of transient messages into a consumerless
queue must not grow RAM without bound. Two mechanisms compose:

- per-queue depth passivation pages transient bodies to the store
  (tests in test_passivation.py);
- the broker-wide memory gate stops READING publishing connections above
  chana.mq.memory.high-watermark and resumes below the low watermark,
  sending Connection.Blocked/Unblocked to capable clients (exceeds the
  reference, which never implemented them — README.md:10-22; its
  backpressure was akka-streams demand + TCP, SURVEY.md §7.3).

The port's copy of ``tests/test_backpressure.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.connection import AMQPConnection
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.store.sqlite import SqliteStore

pytestmark = pytest.mark.asyncio

BODY = b"z" * 1024


async def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = asyncio.get_event_loop().time() + timeout
    while not predicate():
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError("condition not reached in time")
        await asyncio.sleep(interval)


async def test_transient_flood_bounded_resident_no_disconnect(tmp_path):
    """The VERDICT acceptance test: flood transient messages into a
    consumerless queue; resident_bytes stays bounded, the connection stays
    up, and the gauge is visible via /admin/metrics."""
    broker = Broker(store=SqliteStore(str(tmp_path / "bp.db")),
                    queue_max_resident=8, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    admin = AdminServer(broker, host="127.0.0.1", port=0)
    await admin.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("flood_q", durable=True)

    n = 300
    for _ in range(n):
        ch.basic_publish(BODY, routing_key="flood_q")  # transient

    queue = broker.vhosts["/"].queues["flood_q"]
    await wait_for(lambda: len(queue.messages) == n)
    # bounded: at most watermark+1 resident bodies (plus slack for the
    # in-flight page-out pass), not n
    assert broker.resident_bytes <= 16 * len(BODY), broker.resident_bytes
    assert not c.closed  # no disconnect

    # the gauge is exported on /admin/metrics
    reader, writer = await asyncio.open_connection("127.0.0.1", admin.bound_port)
    writer.write(b"GET /admin/metrics HTTP/1.1\r\n\r\n")
    raw = await asyncio.wait_for(reader.read(-1), 10)
    writer.close()
    import json

    payload = json.loads(raw.split(b"\r\n\r\n", 1)[1])
    assert payload["resident_bytes"] == broker.resident_bytes
    assert payload["memory_blocked"] is False

    # everything is still consumable, in order, bodies intact
    got = 0
    while True:
        m = await ch.basic_get("flood_q", no_ack=True)
        if m is None:
            break
        assert m.body == BODY
        got += 1
    assert got == n
    await c.close()
    await admin.stop()
    await srv.stop()


async def test_memory_gate_blocks_and_unblocks_publisher(tmp_path):
    """Above the high watermark the broker stops reading the publisher and
    sends Connection.Blocked; after a consumer drains below the low
    watermark it resumes and sends Unblocked; nothing is lost."""
    broker = Broker(store=SqliteStore(str(tmp_path / "gate.db")),
                    queue_max_resident=0,          # passivation off: force
                    memory_high_watermark=20 * 1024,  # the gate to do the work
                    memory_low_watermark=4 * 1024, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()

    pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    pch = await pub.channel()
    await pch.queue_declare("gate_q")

    n = 120  # 120 KiB >> 20 KiB high watermark
    for _ in range(n):
        pch.basic_publish(BODY, routing_key="gate_q")

    await wait_for(lambda: broker.blocked)
    # capable client got Connection.Blocked
    await wait_for(lambda: pub.server_blocked)
    assert not pub.closed
    blocked_at = broker.resident_bytes
    assert blocked_at > broker.memory_high_watermark

    # a consumer-only connection is NOT gated: it can drain
    con = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    cch = await con.channel()
    received = []

    def cb(msg):
        received.append(msg)

    await cch.basic_consume("gate_q", cb, no_ack=True)
    # draining lowers resident bytes below low watermark -> gate reopens,
    # the parked publisher connection resumes reading, the rest flows
    await wait_for(lambda: len(received) == n, timeout=30)
    await wait_for(lambda: not broker.blocked)
    await wait_for(lambda: not pub.server_blocked)

    # the unblocked publisher works again end-to-end
    pch.basic_publish(b"after", routing_key="gate_q")
    await wait_for(lambda: len(received) == n + 1)
    assert received[-1].body == b"after"
    assert all(m.body == BODY for m in received[:n])

    await pub.close()
    await con.close()
    await srv.stop()


async def test_server_stop_while_publisher_gated(tmp_path):
    """Review regression: BrokerServer.stop() must not deadlock on a
    publisher parked at the memory gate (the bounded gate wait re-checks
    closing)."""
    broker = Broker(store=SqliteStore(str(tmp_path / "stop.db")),
                    queue_max_resident=0,
                    memory_high_watermark=8 * 1024,
                    memory_low_watermark=2 * 1024, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    pch = await pub.channel()
    await pch.queue_declare("stop_q")
    for _ in range(32):
        pch.basic_publish(BODY, routing_key="stop_q")
    await wait_for(lambda: broker.blocked)
    await asyncio.wait_for(srv.stop(), 10)  # used to hang forever
    await pub.close()


async def test_frozen_consumer_bounds_write_buffer():
    """Outbound backpressure (SURVEY §7.3): a consumer that stops reading
    must cap its connection's write buffer near WRITE_HIGH_WATERMARK —
    queue dispatch skips saturated connections and parks the backlog in
    the queue — and drain completely once the consumer resumes."""
    broker = Broker(router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c_cons = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    chc = await c_cons.channel()
    await chc.queue_declare("stall_q")
    await chc.basic_consume("stall_q", lambda m: None, no_ack=True)
    await asyncio.sleep(0.1)
    c_cons.reader._transport.pause_reading()  # freeze the consumer socket

    c_prod = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    chp = await c_prod.channel()
    await chp.confirm_select()
    body = b"z" * 10_000
    for i in range(1500):  # ~15 MB into a frozen consumer
        chp.basic_publish(body, routing_key="stall_q")
        if i % 500 == 499:
            await chp.wait_unconfirmed_below(1)
    await chp.wait_unconfirmed_below(1)
    bufs = [cn._out_bytes + cn._egress_bytes for cn in srv._connections]
    queue = broker.vhosts["/"].queues["stall_q"]
    assert max(bufs) < 6 * 1024 * 1024, f"write buffer unbounded: {bufs}"
    assert len(queue.messages) > 0

    c_cons.reader._transport.resume_reading()
    await wait_for(
        lambda: not queue.messages
        and all(cn._out_bytes + cn._egress_bytes == 0
                for cn in srv._connections), timeout=30)
    await c_prod.close()
    await c_cons.close()
    await srv.stop()


async def test_token_consumer_does_not_bypass_gate(tmp_path):
    """VERDICT r4 weak #2: a flooder holding one consumer on a dummy queue
    must still be stopped by the gate — publish commands are HELD at the
    connection (bounded), not executed, regardless of consumers. The flood
    stops being absorbed (published_msgs plateaus) while an independent
    consumer still drains; after the drain the gate reopens, the held
    publishes release, and everything lands."""
    broker = Broker(store=SqliteStore(str(tmp_path / "tok.db")),
                    queue_max_resident=0,          # passivation off: force
                    memory_high_watermark=20 * 1024,  # the gate to do the work
                    memory_low_watermark=4 * 1024, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()

    pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    pch = await pub.channel()
    await pch.queue_declare("flood_q")
    await pch.queue_declare("dummy_q")
    # the token consumer (the bypass vector): dummy queue, never a message
    await pch.basic_consume("dummy_q", lambda m: None, no_ack=True)

    n = 600  # 600 KiB >> 20 KiB high watermark, > PARK_BUF_MAX past it
    for _ in range(n):
        pch.basic_publish(BODY, routing_key="flood_q")

    await wait_for(lambda: broker.blocked)
    # the flooder kept publishing past the gate: its publishes are held
    await wait_for(lambda: any(c._held for c in srv._connections))
    await asyncio.sleep(0.5)
    absorbed = broker.metrics.published_msgs
    # held: nothing further executes despite the client still pushing
    await asyncio.sleep(0.5)
    assert broker.metrics.published_msgs == absorbed
    assert absorbed < n  # the flood did NOT fully land
    # resident stays near the watermark; held bodies are bounded and on
    # their own gauge
    assert broker.resident_bytes < 2 * broker.memory_high_watermark \
        + 2 * AMQPConnection.PARK_BUF_MAX
    # design bound: the cap is checked between read chunks, so worst case
    # is cap + one full chunk of holds (bodies + per-command overhead)
    assert 0 < broker.held_bytes <= 3 * AMQPConnection.PARK_BUF_MAX

    # an independent consumer drains below the low watermark -> unblock ->
    # the parked flood resumes and lands completely, nothing lost
    con = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    cch = await con.channel()
    received = []
    await cch.basic_consume("flood_q", received.append, no_ack=True)
    await wait_for(lambda: len(received) == n, timeout=30)
    assert all(m.body == BODY for m in received)
    await wait_for(lambda: broker.held_bytes == 0)

    await pub.close()
    await con.close()
    await srv.stop()


async def test_store_growth_gate(tmp_path):
    """VERDICT r4 weak #2 (second half): when page-out absorbs a transient
    flood, RAM stays flat but the store grows — chana.mq.store.max-bytes
    must close the gate, bound the store, and reopen after a drain."""
    broker = Broker(store=SqliteStore(str(tmp_path / "growth.db")),
                    queue_max_resident=4,          # page transient bodies out
                    memory_high_watermark=64 * 1024 * 1024,  # RAM gate idle
                    message_sweep_interval_s=0.05,
                    store_max_bytes=192 * 1024, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()

    pub = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    pch = await pub.channel()
    await pch.queue_declare("pg_q")

    n = 1500  # 1.5 MiB of transient bodies >> 192 KiB store cap

    async def flood() -> None:
        # paced: the store gate SAMPLES (one check per sweep tick), so a
        # single-burst flood can fully land between two samples — the gate
        # bounds sustained floods, not one unsampled burst
        for i in range(n):
            pch.basic_publish(BODY, routing_key="pg_q")
            if i % 50 == 49:
                await asyncio.sleep(0.02)

    flood_task = asyncio.create_task(flood())
    await wait_for(lambda: broker.blocked, timeout=15)
    assert broker._store_over and not broker._mem_over
    await asyncio.sleep(0.3)  # a few sweep samples while parked
    # bounded: cap + one sweep tick of unsampled flood + the in-flight read
    # chunk that was mid-processing at gate close + sqlite page overhead
    bound = (broker.store_max_bytes + AMQPConnection.PARK_BUF_MAX
             + 512 * 1024)
    assert broker.store_bytes < bound, broker.store_bytes
    assert broker.resident_bytes < 1024 * 1024  # page-out kept RAM flat

    # drain from another connection: deletes shrink live data (freelist),
    # the sweep sees it, the gate reopens, the rest of the flood lands
    con = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    cch = await con.channel()
    got = 0
    deadline = asyncio.get_event_loop().time() + 60
    while got < n:
        assert asyncio.get_event_loop().time() < deadline, got
        m = await cch.basic_get("pg_q", no_ack=True)
        if m is None:
            await asyncio.sleep(0.05)
            continue
        assert m.body == BODY
        got += 1
    await wait_for(lambda: not broker.blocked, timeout=15)
    assert got == n
    await flood_task

    await pub.close()
    await con.close()
    await srv.stop()


async def test_parked_dead_peer_reaped_healthy_survives(tmp_path):
    """VERDICT r4 weak #3: heartbeat reaping must keep working while the
    broker is blocked. A gated publisher whose peer goes silent is reaped
    within the normal 2x-interval deadline (non-publish frames keep being
    processed while publishes are held, so silence IS observable); a gated
    publisher that keeps heartbeating survives the whole block."""
    broker = Broker(store=SqliteStore(str(tmp_path / "reap.db")),
                    queue_max_resident=0,
                    memory_high_watermark=8 * 1024,
                    memory_low_watermark=2 * 1024, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=1)
    await srv.start()

    dead = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    dch = await dead.channel()
    live = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    lch = await live.channel()
    await dch.queue_declare("reap_q")
    for _ in range(16):  # 16 KiB > 8 KiB: closes the gate, parks both
        dch.basic_publish(BODY, routing_key="reap_q")
        lch.basic_publish(BODY, routing_key="reap_q")
    await wait_for(lambda: broker.blocked)

    # silent death: stop the dead client's heartbeats (socket stays open)
    dead._heartbeat_task.cancel()
    n_conns = len(srv._connections)
    # reaped within the 2x-interval deadline (+ scheduling slack)
    await wait_for(lambda: len(srv._connections) == n_conns - 1, timeout=8)
    # the healthy gated publisher survived the same window
    assert not live.closed
    assert any(c._has_published for c in srv._connections)

    await live.close()
    await srv.stop()


async def test_same_channel_worker_acks_drain_gate(tmp_path):
    """Review regression: a single-channel publish+consume (manual ack)
    client whose acks are the only drain must not deadlock the gate — acks
    pipelined behind held publishes are exempt from the per-channel hold
    (they settle prior deliveries, which commute with publishes)."""
    broker = Broker(store=SqliteStore(str(tmp_path / "worker.db")),
                    queue_max_resident=0,
                    memory_high_watermark=20 * 1024,
                    memory_low_watermark=4 * 1024, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()

    # the blocked episode can be short (acks drain fast locally): latch it
    # via the listener instead of polling the transient flag
    saw_blocked = []
    broker.blocked_listeners.add(saw_blocked.append)

    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("w_q")
    await ch.basic_qos(prefetch_count=50)
    received = []

    def on_msg(msg):
        received.append(msg)
        ch.basic_ack(msg.delivery_tag)  # ack on the SAME channel

    await ch.basic_consume("w_q", on_msg, no_ack=False)

    n = 400  # 400 KiB >> 20 KiB high watermark
    for _ in range(n):
        ch.basic_publish(BODY, routing_key="w_q")

    await wait_for(lambda: True in saw_blocked, timeout=10)
    # the acks keep flowing despite held publishes on the channel: the
    # gate reopens and every message lands and settles
    await wait_for(lambda: len(received) == n, timeout=30)
    await wait_for(lambda: not broker.blocked, timeout=10)
    await wait_for(lambda: broker.held_bytes == 0, timeout=10)
    queue = broker.vhosts["/"].queues["w_q"]
    await wait_for(lambda: not queue.outstanding and not queue.messages)

    await c.close()
    await srv.stop()
