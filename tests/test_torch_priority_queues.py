"""Priority queues (x-max-priority declare argument).

EXCEEDS the reference (no priority support; the rebuild's plain queues are
strict FIFO like the reference's). RabbitMQ semantics: ready messages order
by (priority desc, publish order within a level), message priorities clamp
to the queue maximum, and — unique to this rebuild's durability design —
because consumption leaves offset order, settles delete their queue-log
rows individually instead of relying on the lastConsumed watermark, and
recovery re-sorts whatever rows remain by recovered priority.

The port's copy of ``tests/test_priority_queues.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError
from chanamq_tpu_torch.store.sqlite import SqliteStore
from chanamq_tpu_torch.broker.broker import Broker

pytestmark = pytest.mark.asyncio


@pytest.fixture
async def server():
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    yield srv
    await srv.stop()


@pytest.fixture
async def client(server):
    c = await AMQPClient.connect("127.0.0.1", server.bound_port)
    yield c
    await c.close()


def prio(n):
    return BasicProperties(priority=n, delivery_mode=2)


async def drain_all(ch, queue):
    out = []
    while True:
        m = await ch.basic_get(queue, no_ack=True)
        if m is None:
            return out
        out.append(m)


async def test_delivery_order_by_priority_then_fifo(client):
    ch = await client.channel()
    await ch.queue_declare("pq", arguments={"x-max-priority": 10})
    sends = [(b"a0", 0), (b"b5", 5), (b"c0", 0), (b"d9", 9), (b"e5", 5),
             (b"f9", 9), (b"g1", 1)]
    for body, p in sends:
        ch.basic_publish(body, routing_key="pq", properties=prio(p))
    ch2 = await client.channel()
    await ch2.queue_declare("pq", passive=True)  # ordering barrier
    got = [m.body for m in await drain_all(ch, "pq")]
    # priority desc, FIFO within each level
    assert got == [b"d9", b"f9", b"b5", b"e5", b"g1", b"a0", b"c0"]


async def test_no_priority_messages_default_to_zero(client):
    ch = await client.channel()
    await ch.queue_declare("pq0", arguments={"x-max-priority": 5})
    ch.basic_publish(b"plain", routing_key="pq0")  # no priority property
    ch.basic_publish(b"high", routing_key="pq0", properties=prio(3))
    ch2 = await client.channel()
    await ch2.queue_declare("pq0", passive=True)
    got = [m.body for m in await drain_all(ch, "pq0")]
    assert got == [b"high", b"plain"]


async def test_priority_clamps_to_queue_maximum(client):
    ch = await client.channel()
    await ch.queue_declare("pqc", arguments={"x-max-priority": 4})
    ch.basic_publish(b"over", routing_key="pqc", properties=prio(200))
    ch.basic_publish(b"atmax", routing_key="pqc", properties=prio(4))
    ch2 = await client.channel()
    await ch2.queue_declare("pqc", passive=True)
    got = [m.body for m in await drain_all(ch, "pqc")]
    # 200 clamps to 4: same level as "atmax", so FIFO between them
    assert got == [b"over", b"atmax"]


async def test_consumer_delivery_follows_priority(client):
    """Push dispatch (not just basic.get) serves the ready set in priority
    order when messages are queued ahead of the consumer."""
    ch = await client.channel()
    await ch.queue_declare("pqd", arguments={"x-max-priority": 9})
    for body, p in ((b"low1", 1), (b"high", 9), (b"low2", 1)):
        ch.basic_publish(body, routing_key="pqd", properties=prio(p))
    ch2 = await client.channel()
    await ch2.queue_declare("pqd", passive=True)
    got = []
    done = asyncio.get_event_loop().create_future()

    def cb(m):
        got.append(m.body)
        if len(got) == 3 and not done.done():
            done.set_result(None)

    await ch.basic_consume("pqd", cb, no_ack=True)
    await asyncio.wait_for(done, 5)
    assert got == [b"high", b"low1", b"low2"]


async def test_nack_requeue_returns_to_priority_position(client):
    ch = await client.channel()
    await ch.queue_declare("pqr", arguments={"x-max-priority": 9})
    for body, p in ((b"h1", 9), (b"h2", 9), (b"low", 1)):
        ch.basic_publish(body, routing_key="pqr", properties=prio(p))
    ch2 = await client.channel()
    await ch2.queue_declare("pqr", passive=True)
    m = await ch.basic_get("pqr")
    assert m.body == b"h1"
    ch.basic_nack(m.delivery_tag, requeue=True)
    got = [x.body for x in await drain_all(ch, "pqr")]
    # h1 returns AHEAD of h2 (same priority, earlier offset), above low
    assert got == [b"h1", b"h2", b"low"]
    assert got and got[0] == b"h1"


async def test_durable_priority_queue_recovery(tmp_path):
    """Restart ordering + exactness: consumed-and-acked entries stay gone
    (per-row settles — the watermark cannot prune here), survivors recover
    into priority order."""
    db = str(tmp_path / "prio.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("pqd2", durable=True,
                           arguments={"x-max-priority": 9})
    sends = [(b"p0a", 0), (b"p9a", 9), (b"p5a", 5), (b"p9b", 9),
             (b"p0b", 0), (b"p5b", 5)]
    for body, p in sends:
        ch.basic_publish(body, routing_key="pqd2", properties=prio(p))
    await ch.wait_unconfirmed_below(1)
    # consume the two highest (p9a, p9b) and ack them
    for expect in (b"p9a", b"p9b"):
        m = await ch.basic_get("pqd2")
        assert m.body == expect
        ch.basic_ack(m.delivery_tag)
    await asyncio.sleep(0.1)  # let the row deletes flush
    await c.close()
    await srv.stop()

    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ok = await ch2.queue_declare("pqd2", durable=True, passive=True,
                                     arguments={"x-max-priority": 9})
        assert ok.message_count == 4
        got = [m.body for m in await drain_all(ch2, "pqd2")]
        assert got == [b"p5a", b"p5b", b"p0a", b"p0b"]
        await c2.close()
    finally:
        await srv2.stop()


async def test_unacked_priority_messages_recover(tmp_path):
    """Delivered-but-unacked entries come back after a restart, re-sorted
    into the priority order with the untouched backlog."""
    db = str(tmp_path / "priou.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("pqu", durable=True,
                           arguments={"x-max-priority": 9})
    for body, p in ((b"u9", 9), (b"u5", 5), (b"u0", 0)):
        ch.basic_publish(body, routing_key="pqu", properties=prio(p))
    await ch.wait_unconfirmed_below(1)
    m = await ch.basic_get("pqu")  # u9 delivered, NOT acked
    assert m.body == b"u9"
    await asyncio.sleep(0.1)
    await srv.stop()  # hard stop: unack outstanding

    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        got = [x.body for x in await drain_all(ch2, "pqu")]
        assert got == [b"u9", b"u5", b"u0"]
        await c2.close()
    finally:
        await srv2.stop()


async def test_priority_queue_validation(client):
    for args in ({"x-max-priority": 0}, {"x-max-priority": 256},
                 {"x-max-priority": "high"},
                 {"x-max-priority": 5, "x-queue-mode": "lazy"}):
        ch = await client.channel()
        with pytest.raises(ChannelClosedError) as exc_info:
            await ch.queue_declare("pq_bad", arguments=args)
        assert exc_info.value.reply_code == 406, args


async def test_priority_with_maxlen_and_dlx(client):
    """Cap + DLX still work on a priority queue: drop-head evicts the
    current front (highest priority first, documented) into the DLX."""
    ch = await client.channel()
    await ch.exchange_declare("pq_dlx", "fanout")
    await ch.queue_declare("pq_dead")
    await ch.queue_bind("pq_dead", "pq_dlx", "")
    await ch.queue_declare("pq_cap", arguments={
        "x-max-priority": 9, "x-max-length": 2,
        "x-dead-letter-exchange": "pq_dlx"})
    ch.basic_publish(b"m1", routing_key="pq_cap", properties=prio(9))
    ch.basic_publish(b"m2", routing_key="pq_cap", properties=prio(1))
    ch.basic_publish(b"m3", routing_key="pq_cap", properties=prio(5))
    ch2 = await client.channel()
    await ch2.queue_declare("pq_cap", passive=True)
    ok = await ch2.queue_declare("pq_cap", passive=True)
    assert ok.message_count == 2
    dead = None
    for _ in range(50):
        dead = await ch.basic_get("pq_dead", no_ack=True)
        if dead is not None:
            break
        await asyncio.sleep(0.02)
    assert dead is not None
    assert dead.properties.headers["x-death"][0]["reason"] == "maxlen"


async def test_ttl_expiry_on_priority_queue(client):
    ch = await client.channel()
    await ch.queue_declare("pq_ttl", arguments={
        "x-max-priority": 5, "x-message-ttl": 60})
    ch.basic_publish(b"gone", routing_key="pq_ttl", properties=prio(5))
    await asyncio.sleep(0.3)
    ok = await ch.queue_declare("pq_ttl", passive=True)
    assert ok.message_count == 0


async def test_priority_insert_above_tail_still_passivates(tmp_path):
    """A capped priority queue must keep passivating: a push that inserts
    ABOVE the tail (higher priority) is not mistaken for an overflow victim
    and still pages out beyond the resident watermark."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer as _BS

    broker = Broker(store=SqliteStore(str(tmp_path / "pp.db")),
                    queue_max_resident=4, router_device="cpu")
    srv = _BS(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare("pp_q", durable=True, arguments={
            "x-max-priority": 9, "x-max-length": 100})
        body = b"z" * 512
        # low-priority backlog past the watermark, then high-priority
        # inserts that land mid-queue (above the low tail)
        for i in range(20):
            ch.basic_publish(body, routing_key="pp_q", properties=prio(0))
        for i in range(20):
            ch.basic_publish(body, routing_key="pp_q", properties=prio(9))
        await ch.wait_unconfirmed_below(1)
        queue = broker.vhosts["/"].queues["pp_q"]
        assert len(queue.messages) == 40
        resident = sum(1 for qm in queue.messages
                       if qm.message.body is not None)
        assert resident <= 6, resident  # watermark held, both priorities
        # drains fully with hydration, highest priority first
        got = [m.body for m in await drain_all(ch, "pp_q")]
        assert len(got) == 40 and all(b == body for b in got)
        await c.close()
    finally:
        await srv.stop()


async def test_purge_clears_buffered_row_deletes(tmp_path):
    srv = BrokerServer(broker=Broker(store=SqliteStore(str(tmp_path / "pg.db")), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("pg_q", durable=True,
                               arguments={"x-max-priority": 5})
        for i in range(10):
            ch.basic_publish(b"x", routing_key="pg_q", properties=prio(1))
        await asyncio.sleep(0.05)
        assert await ch.queue_purge("pg_q") == 10
        queue = srv.broker.vhosts["/"].queues["pg_q"]
        assert queue._row_del_buf == []
        await c.close()
    finally:
        await srv.stop()


async def test_recovery_loads_bodies_for_priority_head(tmp_path):
    """After a restart over a deep priority backlog where the high
    priorities were published LAST (highest offsets), the sorted head must
    come back with bodies resident — dispatch serves it without a store
    stall."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer as _BS

    db = str(tmp_path / "ph.db")
    broker = Broker(store=SqliteStore(db), queue_max_resident=8,
                    router_device="cpu")
    srv = _BS(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("ph_q", durable=True,
                           arguments={"x-max-priority": 9})
    for i in range(30):
        ch.basic_publish(b"low-%02d" % i, routing_key="ph_q",
                         properties=prio(0))
    for i in range(5):
        ch.basic_publish(b"high-%d" % i, routing_key="ph_q",
                         properties=prio(9))
    await ch.wait_unconfirmed_below(1)
    await c.close()
    await srv.stop()

    broker2 = Broker(store=SqliteStore(db), queue_max_resident=8,
                     router_device="cpu")
    srv2 = _BS(broker=broker2, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        queue = broker2.vhosts["/"].queues["ph_q"]
        # the sorted head (the 5 highs + first lows) is resident
        head = list(queue.messages)[:8]
        assert all(qm.message.body is not None for qm in head), \
            [qm.message.body for qm in head]
        assert [qm.message.body for qm in head[:5]] == \
            [b"high-%d" % i for i in range(5)]
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        got = [m.body for m in await drain_all(ch2, "ph_q")]
        assert got[:5] == [b"high-%d" % i for i in range(5)]
        assert got[5:] == [b"low-%02d" % i for i in range(30)]
        await c2.close()
    finally:
        await srv2.stop()
