"""Message-body passivation / store hydration.

The reference pages inactive message bodies out to the store and
Promise-loads them back on Get (MessageEntity.scala:82-102 passivation timer
at :168-198, knob chana.mq.message.inactive). Here the analogue is
depth-based: beyond the per-queue resident watermark
(chana.mq.queue.max-resident), durable+persistent bodies are dropped from
RAM and hydrated back from the store before delivery — so a deep backlog in
a consumerless durable queue holds bounded memory.

The port's copy of ``tests/test_passivation.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.store.sqlite import SqliteStore

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)
WATERMARK = 8


@pytest.fixture
def db_path(tmp_path):
    return str(tmp_path / "broker.db")


async def start_server(db_path, max_resident=WATERMARK):
    broker = Broker(store=SqliteStore(db_path), queue_max_resident=max_resident,
                    router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    return srv


def resident_bodies(queue):
    return [qm for qm in queue.messages if qm.message.body is not None]


async def test_deep_backlog_bounded_then_consumed_in_order(db_path):
    """The VERDICT round-3 acceptance test: publish >> watermark persistent
    bodies into a consumerless durable queue, assert bounded resident bytes,
    then consume everything in order with bodies intact."""
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("deep_q", durable=True)

    n = 100
    body_size = 1024
    for i in range(n):
        ch.basic_publish((b"%04d" % i) + b"x" * (body_size - 4),
                         routing_key="deep_q", properties=PERSISTENT)
    await ch.wait_unconfirmed_below(1)

    queue = srv.broker.vhosts["/"].queues["deep_q"]
    assert len(queue.messages) == n
    resident = resident_bodies(queue)
    assert len(resident) <= WATERMARK + 1
    # the broker-level gauge reflects the bound (per-queue resident bodies
    # plus nothing else alive in this test)
    assert srv.broker.resident_bytes <= (WATERMARK + 1) * (body_size + 64)
    # passivated entries kept their QoS/store bookkeeping size
    assert all(qm.body_size == body_size for qm in queue.messages)

    # now consume everything: hydration must reattach bodies in order
    received = []
    done = asyncio.get_event_loop().create_future()

    def cb(msg):
        received.append(msg)
        ch.basic_ack(msg.delivery_tag)
        if len(received) >= n and not done.done():
            done.set_result(None)

    await ch.basic_consume("deep_q", cb)
    await asyncio.wait_for(done, 30)
    assert [m.body[:4] for m in received] == [b"%04d" % i for i in range(n)]
    assert all(len(m.body) == body_size for m in received)
    assert all(m.properties.delivery_mode == 2 for m in received)

    await c.close()
    await srv.stop()


async def test_basic_get_hydrates_passivated_head(db_path):
    srv = await start_server(db_path, max_resident=2)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("get_q", durable=True)
    for i in range(10):
        ch.basic_publish(b"msg-%d" % i, routing_key="get_q",
                         properties=PERSISTENT)
    await ch.wait_unconfirmed_below(1)
    queue = srv.broker.vhosts["/"].queues["get_q"]
    assert len(resident_bodies(queue)) <= 3
    for i in range(10):
        m = await ch.basic_get("get_q", no_ack=True)
        assert m is not None and m.body == b"msg-%d" % i
    assert await ch.basic_get("get_q") is None
    await c.close()
    await srv.stop()


async def test_dead_blob_skipped_not_crashed(db_path):
    """A passivated entry whose blob vanished from the store (manual delete /
    external TTL) is marked dead and skipped, not delivered as a crash."""
    srv = await start_server(db_path, max_resident=2)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("dead_q", durable=True)
    for i in range(6):
        ch.basic_publish(b"msg-%d" % i, routing_key="dead_q",
                         properties=PERSISTENT)
    await ch.wait_unconfirmed_below(1)
    queue = srv.broker.vhosts["/"].queues["dead_q"]
    # kill the blob of the first PASSIVATED entry behind the resident head
    victim = next(qm for qm in queue.messages if qm.message.body is None)
    await srv.broker.store.delete_message(victim.message.id)
    await srv.broker.store.flush()

    got = []
    while True:
        m = await ch.basic_get("dead_q", no_ack=True)
        if m is None:
            break
        got.append(m.body)
    expected = [b"msg-%d" % i for i in range(6)
                if i != victim.offset - 1]
    assert got == expected
    await c.close()
    await srv.stop()


@pytest.mark.parametrize("meta_chunk", [None, 7])
async def test_recovery_respects_resident_watermark(db_path, monkeypatch,
                                                    meta_chunk):
    """Restarting over a deep durable backlog must not reload every body
    into RAM — and must still deliver everything in order afterwards.

    meta_chunk=7 additionally forces recovery's metadata paging
    (RECOVER_META_CHUNK) across several chunk boundaries over the 30-deep
    backlog (VERDICT r3 weak #7: the transient meta dict must not
    double-hold the whole backlog; the reference streams per-entity via
    selectQueue)."""
    srv = await start_server(db_path, max_resident=4)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("rec_q", durable=True)
    for i in range(30):
        ch.basic_publish(b"m-%02d" % i, routing_key="rec_q",
                         properties=PERSISTENT)
    await ch.wait_unconfirmed_below(1)
    await c.close()
    await srv.stop()

    if meta_chunk is not None:
        monkeypatch.setattr(Broker, "RECOVER_META_CHUNK", meta_chunk)
    srv2 = await start_server(db_path, max_resident=4)
    queue = srv2.broker.vhosts["/"].queues["rec_q"]
    assert len(queue.messages) == 30
    assert len(resident_bodies(queue)) <= 4

    c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
    ch2 = await c2.channel()
    received = []
    done = asyncio.get_event_loop().create_future()

    def cb(msg):
        received.append(msg)
        ch2.basic_ack(msg.delivery_tag)
        if len(received) >= 30 and not done.done():
            done.set_result(None)

    await ch2.basic_consume("rec_q", cb)
    await asyncio.wait_for(done, 30)
    assert [m.body for m in received] == [b"m-%02d" % i for i in range(30)]
    await c2.close()
    await srv2.stop()


async def test_fanout_passivation_shares_body_safely(db_path):
    """Advisor round-3 high: a persistent message fanned out to multiple
    durable queues must survive one queue passivating the shared body —
    body_size is computed once at publish, and the sibling queue hydrates
    from the store like any passivated entry."""
    srv = await start_server(db_path, max_resident=4)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.exchange_declare("fan_x", "fanout", durable=True)
    await ch.queue_declare("fan_a", durable=True)
    await ch.queue_declare("fan_b", durable=True)
    await ch.queue_bind("fan_a", "fan_x", "")
    await ch.queue_bind("fan_b", "fan_x", "")

    n = 12  # well past max_resident=4: the advisor repro crashed on the 5th
    for i in range(n):
        ch.basic_publish(b"fan-%02d" % i, exchange="fan_x", routing_key="",
                         properties=PERSISTENT)
    await ch.wait_unconfirmed_below(1)

    qa = srv.broker.vhosts["/"].queues["fan_a"]
    qb = srv.broker.vhosts["/"].queues["fan_b"]
    assert len(qa.messages) == n and len(qb.messages) == n
    # every entry carries the true body size even where the shared body was
    # paged out by the sibling queue
    assert all(qm.body_size == 6 for qm in qa.messages)
    assert all(qm.body_size == 6 for qm in qb.messages)

    # both queues drain fully, in order, with hydrated bodies
    for qname in ("fan_a", "fan_b"):
        got = []
        while True:
            m = await ch.basic_get(qname, no_ack=True)
            if m is None:
                break
            got.append(m.body)
        assert got == [b"fan-%02d" % i for i in range(n)]
    await c.close()
    await srv.stop()


async def test_transient_bodies_page_out_and_drain_in_order(db_path):
    """VERDICT r3 #2b: transient bodies also page out past the watermark
    (the reference's ActiveCheckTick persists unconditionally before
    passivating, MessageEntity.scala:171-186) — bounded RAM, full in-order
    drain, and no durability promise attaches."""
    srv = await start_server(db_path, max_resident=2)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("mix_q", durable=True)
    for i in range(10):
        ch.basic_publish(b"t-%d" % i, routing_key="mix_q")  # delivery_mode 1
    await asyncio.sleep(0.2)
    queue = srv.broker.vhosts["/"].queues["mix_q"]
    assert len(queue.messages) == 10
    assert len(resident_bodies(queue)) <= 3  # deep tail paged out
    # paged, not persisted: no durability promise
    assert all(not qm.message.persisted for qm in queue.messages)
    got = []
    while True:
        m = await ch.basic_get("mix_q", no_ack=True)
        if m is None:
            break
        got.append(m.body)
    assert got == [b"t-%d" % i for i in range(10)]
    await c.close()
    await srv.stop()


async def test_paged_transients_not_resurrected_by_recovery(db_path):
    """Transient messages stay transient: paged-out blobs must not come
    back after a restart (the reference's HA contract — transients die with
    the node), and a clean shutdown removes the paged blobs themselves."""
    srv = await start_server(db_path, max_resident=2)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("tr_q", durable=True)
    for i in range(8):
        ch.basic_publish(b"x-%d" % i, routing_key="tr_q")
    await asyncio.sleep(0.2)
    queue = srv.broker.vhosts["/"].queues["tr_q"]
    paged_ids = [qm.message.id for qm in queue.messages if qm.message.paged]
    assert paged_ids  # some bodies really were paged out
    await c.close()
    await srv.stop()

    srv2 = await start_server(db_path, max_resident=2)
    queue2 = srv2.broker.vhosts["/"].queues["tr_q"]
    assert len(queue2.messages) == 0  # transients died with the process
    # clean shutdown deleted the paged blobs (no orphan accumulation)
    stored = await srv2.broker.store.select_messages(paged_ids)
    assert stored == {}
    await srv2.stop()


async def test_transient_paged_body_visible_to_inline_basic_get():
    """A paged transient body written fire-and-forget must be readable with
    ZERO event-loop yields in between: MemoryStore (the default, no --store)
    applies writes at call time, so a pipelined publish-past-watermark
    followed immediately by basic.get can't miss the blob and silently drop
    the message."""
    from chanamq_tpu_torch.store.memory import MemoryStore

    broker = Broker(store=MemoryStore(), queue_max_resident=2,
                    router_device="cpu")
    await broker.start()
    try:
        await broker.declare_queue("/", "q", durable=False)
        for i in range(6):
            await broker.publish(
                "/", "", "q", BasicProperties(delivery_mode=1), b"m%d" % i)
        queue = broker.vhost("/").queues["q"]
        # tail entries are paged (body in store only)
        assert any(qm.message.body is None for qm in queue.messages)
        got = []
        # same task, no awaits other than basic_get itself (whose store
        # read must see the eager write)
        for _ in range(6):
            qm = await queue.basic_get()
            assert qm is not None, f"paged message lost after {got}"
            got.append(bytes(qm.message.body))
            broker.unrefer(qm.message)
        assert got == [b"m%d" % i for i in range(6)]
    finally:
        await broker.stop()


async def test_basic_get_drain_does_not_retain_hydrated_bodies():
    """basic_get hydrates without the dispatch-path collector: the
    passivated deque must still shed settled entries, or a publish-burst →
    get-drain cycle retains every hydrated body forever (invisible to
    resident_bytes)."""
    from chanamq_tpu_torch.store.memory import MemoryStore

    broker = Broker(store=MemoryStore(), queue_max_resident=2,
                    router_device="cpu")
    await broker.start()
    try:
        await broker.declare_queue("/", "q", durable=False)
        queue = broker.vhost("/").queues["q"]
        for cycle in range(3):
            for i in range(20):
                await broker.publish(
                    "/", "", "q", BasicProperties(delivery_mode=1), b"x" * 512)
            while True:
                qm = await queue.basic_get()
                if qm is None:
                    break
                broker.unrefer(qm.message)
            assert len(queue._passivated) == 0, (cycle, len(queue._passivated))
        assert broker.resident_bytes == 0
    finally:
        await broker.stop()


async def test_expired_passivated_entries_leave_the_deque():
    """A consumerless TTL'd queue: expiry must prune the passivated deque
    too, or each burst pins dead Message objects (properties + header_raw)
    forever, invisible to resident_bytes."""
    from chanamq_tpu_torch.store.memory import MemoryStore

    broker = Broker(store=MemoryStore(), queue_max_resident=2,
                    message_sweep_interval_s=0, router_device="cpu")
    await broker.start()
    try:
        await broker.declare_queue("/", "q", durable=False,
                                   arguments={"x-message-ttl": 30})
        queue = broker.vhost("/").queues["q"]
        for i in range(20):
            await broker.publish(
                "/", "", "q", BasicProperties(delivery_mode=1), b"x" * 256)
        assert len(queue._passivated) > 0
        await asyncio.sleep(0.1)  # everything expires
        queue._expire_head()
        assert len(queue.messages) == 0
        assert len(queue._passivated) == 0
        assert broker.resident_bytes == 0
    finally:
        await broker.stop()


async def test_passivated_messages_dead_letter_with_hydrated_bodies(tmp_path):
    """A passivated (body paged out) message that expires in a DLX'd queue
    is hydrated from the store before forwarding: the dead-letter queue
    receives the FULL body, not an empty shell."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.sqlite import SqliteStore

    broker = Broker(store=SqliteStore(str(tmp_path / "pdlx.db")),
                    queue_max_resident=4, message_sweep_interval_s=0.1,
                    router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.exchange_declare("pdlx_ex", "fanout")
        await ch.queue_declare("pdlx_dlq")
        await ch.queue_bind("pdlx_dlq", "pdlx_ex", "")
        await ch.queue_declare("pdlx_q", arguments={
            "x-message-ttl": 300, "x-dead-letter-exchange": "pdlx_ex"})
        bodies = [b"deep-%03d" % i + b"x" * 100 for i in range(16)]
        for body in bodies:
            ch.basic_publish(body, routing_key="pdlx_q")
        # beyond max_resident=4 the tail pages out; wait for TTL + sweep
        await asyncio.sleep(0.1)
        assert srv.broker.resident_bytes < sum(len(b) for b in bodies)
        got = []
        deadline = asyncio.get_event_loop().time() + 8
        while (len(got) < len(bodies)
               and asyncio.get_event_loop().time() < deadline):
            m = await ch.basic_get("pdlx_dlq", no_ack=True)
            if m is None:
                await asyncio.sleep(0.05)
                continue
            got.append(m)
        assert sorted(m.body for m in got) == sorted(bodies)
        for m in got:
            assert m.properties.headers["x-death"][0]["reason"] == "expired"
        await c.close()
    finally:
        await srv.stop()


async def test_lazy_queue_mode_pages_aggressively(tmp_path):
    """x-queue-mode=lazy (RabbitMQ lazy queues, mapped onto passivation):
    bodies page out beyond a small resident head regardless of the
    broker-wide watermark, and consumption still delivers everything in
    order with full bodies."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.sqlite import SqliteStore

    # broker-wide passivation effectively off (huge watermark)
    broker = Broker(store=SqliteStore(str(tmp_path / "lazy.db")),
                    queue_max_resident=10**9, router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("lazy_q", arguments={"x-queue-mode": "lazy"})
        from chanamq_tpu_torch.broker.entities import Queue

        n = Queue.LAZY_RESIDENT + 200
        body = b"z" * 256
        for i in range(n):
            ch.basic_publish(i.to_bytes(4, "big") + body,
                             routing_key="lazy_q")
        await asyncio.sleep(0.2)
        # the deep tail paged out: resident bytes far below the full backlog
        assert broker.resident_bytes <= (Queue.LAZY_RESIDENT + 8) * 300, \
            broker.resident_bytes
        # ...and a plain (non-lazy) queue with the same broker keeps all:
        # assert on the DELTA so the lazy queue's resident head can't
        # satisfy the check by itself
        resident_before_eager = broker.resident_bytes
        await ch.queue_declare("eager_q")
        for i in range(50):
            ch.basic_publish(body, routing_key="eager_q")
        await asyncio.sleep(0.1)
        assert broker.resident_bytes - resident_before_eager >= 50 * 256
        # drain the lazy queue fully, in order, bodies intact
        got = 0
        deadline = asyncio.get_event_loop().time() + 15
        while got < n and asyncio.get_event_loop().time() < deadline:
            m = await ch.basic_get("lazy_q", no_ack=True)
            if m is None:
                await asyncio.sleep(0.02)
                continue
            assert int.from_bytes(m.body[:4], "big") == got
            assert m.body[4:] == body
            got += 1
        assert got == n
        await c.close()
    finally:
        await srv.stop()


async def test_queue_mode_validation():
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.client.client import ChannelClosedError

    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        with pytest.raises(ChannelClosedError) as exc_info:
            await ch.queue_declare("bad_mode_q",
                                   arguments={"x-queue-mode": "warp"})
        assert exc_info.value.reply_code == 406
        ch2 = await c.channel()
        await ch2.queue_declare("ok_mode_q",
                                arguments={"x-queue-mode": "default"})
        await c.close()
    finally:
        await srv.stop()


async def test_lazy_queue_recovery_honors_override(tmp_path):
    """Recovery of a durable lazy queue loads only the lazy resident head
    even when the broker-wide watermark is huge (the per-queue override
    applies at restart, not just at push time)."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.broker.entities import Queue
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.store.sqlite import SqliteStore

    db = str(tmp_path / "lazyrec.db")
    broker = Broker(store=SqliteStore(db), queue_max_resident=10**9,
                    router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    n = Queue.LAZY_RESIDENT + 300
    body = b"r" * 256
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("lzr_q", durable=True,
                               arguments={"x-queue-mode": "lazy"})
        for i in range(n):
            ch.basic_publish(i.to_bytes(4, "big") + body,
                             routing_key="lzr_q",
                             properties=BasicProperties(delivery_mode=2))
        ch2 = await c.channel()
        await ch2.queue_declare("lzr_q", passive=True)  # ordering barrier
        await c.close()
    finally:
        await srv.stop()

    broker2 = Broker(store=SqliteStore(db), queue_max_resident=10**9,
                     router_device="cpu")
    srv2 = BrokerServer(broker=broker2, host="127.0.0.1", port=0,
                        heartbeat_s=0)
    await srv2.start()
    try:
        # only ~the lazy head came back resident
        assert broker2.resident_bytes <= (Queue.LAZY_RESIDENT + 8) * 300, \
            broker2.resident_bytes
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch3 = await c2.channel()
        ok = await ch3.queue_declare("lzr_q", durable=True, passive=True,
                                     arguments={"x-queue-mode": "lazy"})
        assert ok.message_count == n
        # full drain, in order, bodies hydrated
        for i in range(n):
            m = None
            for _ in range(100):
                m = await ch3.basic_get("lzr_q", no_ack=True)
                if m is not None:
                    break
                await asyncio.sleep(0.02)
            assert m is not None and int.from_bytes(m.body[:4], "big") == i
        await c2.close()
    finally:
        await srv2.stop()
