"""End-to-end loopback conformance tests: in-repo client vs broker over real
sockets. The conformance gate of SURVEY.md §7.2 step 3 — equivalent flows to
the reference's SimplePublisher/SimpleConsumer plus the ack/nack/QoS/confirm/
TTL semantics the reference exercised manually.

The port's copy of ``tests/test_broker_loopback.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError
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


async def collect(n, timeout=5.0):
    """Helper returning (callback, awaitable-for-n-messages)."""
    received = []
    done = asyncio.get_event_loop().create_future()

    def cb(msg):
        received.append(msg)
        if len(received) >= n and not done.done():
            done.set_result(None)

    async def wait():
        await asyncio.wait_for(done, timeout)
        return received

    return cb, wait


async def test_handshake_and_server_properties(client):
    assert client.server_properties["product"] == "chanamq-tpu"


async def test_declare_publish_consume_autoack(client):
    ch = await client.channel()
    await ch.exchange_declare("test_ex", "direct", durable=True)
    ok = await ch.queue_declare("test_q", durable=True,
                                arguments={"x-message-ttl": 60000})
    assert ok.queue == "test_q"
    await ch.queue_bind("test_q", "test_ex", "quote")

    # the reference's SimplePublisher publishes 3 property shapes:
    # persistent, with-expiration, transient (SimplePublisher.scala:36-53)
    shapes = [
        BasicProperties(delivery_mode=2, content_type="text/plain"),
        BasicProperties(delivery_mode=1, expiration="30000"),
        BasicProperties(),
    ]
    cb, wait = await collect(len(shapes))
    await ch.basic_consume("test_q", cb, no_ack=True)
    for i, props in enumerate(shapes):
        ch.basic_publish(f"msg-{i}".encode(), exchange="test_ex",
                         routing_key="quote", properties=props)
    received = await wait()
    assert [m.body for m in received] == [b"msg-0", b"msg-1", b"msg-2"]
    assert received[0].properties.delivery_mode == 2
    assert received[0].exchange == "test_ex"
    assert received[0].routing_key == "quote"
    assert not received[0].redelivered


async def test_default_exchange_routes_by_queue_name(client):
    ch = await client.channel()
    await ch.queue_declare("direct_q")
    cb, wait = await collect(1)
    await ch.basic_consume("direct_q", cb, no_ack=True)
    ch.basic_publish(b"via-default", routing_key="direct_q")
    received = await wait()
    assert received[0].body == b"via-default"


async def test_basic_get_and_ack(client):
    ch = await client.channel()
    await ch.queue_declare("get_q")
    ch.basic_publish(b"one", routing_key="get_q")
    ch.basic_publish(b"two", routing_key="get_q")
    await asyncio.sleep(0.05)
    m1 = await ch.basic_get("get_q")
    assert m1.body == b"one"
    assert m1.message_count == 1  # one left
    ch.basic_ack(m1.delivery_tag)
    m2 = await ch.basic_get("get_q", no_ack=True)
    assert m2.body == b"two"
    m3 = await ch.basic_get("get_q")
    assert m3 is None  # get-empty


async def test_fanout_exchange(client):
    ch = await client.channel()
    await ch.exchange_declare("fan", "fanout")
    await ch.queue_declare("fan_q1")
    await ch.queue_declare("fan_q2")
    await ch.queue_bind("fan_q1", "fan", "")
    await ch.queue_bind("fan_q2", "fan", "ignored")
    ch.basic_publish(b"blast", exchange="fan", routing_key="anything")
    await asyncio.sleep(0.05)
    m1 = await ch.basic_get("fan_q1", no_ack=True)
    m2 = await ch.basic_get("fan_q2", no_ack=True)
    assert m1.body == b"blast" and m2.body == b"blast"


async def test_topic_exchange_wildcards(client):
    ch = await client.channel()
    await ch.exchange_declare("topics", "topic")
    for q, pattern in [
        ("t_star", "stock.*.nyse"),
        ("t_hash", "stock.#"),
        ("t_exact", "stock.ibm.nyse"),
    ]:
        await ch.queue_declare(q)
        await ch.queue_bind(q, "topics", pattern)
    ch.basic_publish(b"x", exchange="topics", routing_key="stock.ibm.nyse")
    await asyncio.sleep(0.05)
    assert (await ch.basic_get("t_star", no_ack=True)).body == b"x"
    assert (await ch.basic_get("t_hash", no_ack=True)).body == b"x"
    assert (await ch.basic_get("t_exact", no_ack=True)).body == b"x"
    # non-matching key
    ch.basic_publish(b"y", exchange="topics", routing_key="bond.ibm.nyse")
    await asyncio.sleep(0.05)
    assert await ch.basic_get("t_star", no_ack=True) is None
    assert await ch.basic_get("t_hash", no_ack=True) is None


async def test_headers_exchange(client):
    ch = await client.channel()
    await ch.exchange_declare("hx", "headers")
    await ch.queue_declare("h_all")
    await ch.queue_declare("h_any")
    await ch.queue_bind("h_all", "hx", "",
                        arguments={"x-match": "all", "type": "report", "fmt": "pdf"})
    await ch.queue_bind("h_any", "hx", "",
                        arguments={"x-match": "any", "type": "report", "fmt": "doc"})
    ch.basic_publish(
        b"m", exchange="hx",
        properties=BasicProperties(headers={"type": "report", "fmt": "pdf"}))
    await asyncio.sleep(0.05)
    assert (await ch.basic_get("h_all", no_ack=True)).body == b"m"
    assert (await ch.basic_get("h_any", no_ack=True)).body == b"m"  # type matched
    ch.basic_publish(
        b"n", exchange="hx",
        properties=BasicProperties(headers={"type": "memo", "fmt": "pdf"}))
    await asyncio.sleep(0.05)
    assert await ch.basic_get("h_all", no_ack=True) is None  # fmt ok, type no
    assert await ch.basic_get("h_any", no_ack=True) is None


async def test_ack_nack_requeue_redelivered(client):
    ch = await client.channel()
    await ch.queue_declare("ack_q")
    cb, wait = await collect(1)
    await ch.basic_consume("ack_q", cb)
    ch.basic_publish(b"payload", routing_key="ack_q")
    (first,) = await wait()
    assert not first.redelivered
    # nack with requeue -> redelivered copy arrives
    cb2, wait2 = await collect(2)
    # re-point the consumer callback list by consuming the redelivery
    received2 = []

    ch.basic_nack(first.delivery_tag, requeue=True)
    await asyncio.sleep(0.1)
    # the same consumer receives the redelivery (appended to first list)
    m = await ch.basic_get("ack_q")  # should be empty: consumer got it
    assert m is None


async def test_reject_without_requeue_drops(client):
    ch = await client.channel()
    await ch.queue_declare("rej_q")
    cb, wait = await collect(1)
    await ch.basic_consume("rej_q", cb)
    ch.basic_publish(b"bad", routing_key="rej_q")
    (msg,) = await wait()
    ch.basic_reject(msg.delivery_tag, requeue=False)
    await asyncio.sleep(0.05)
    ok = await ch.queue_declare("rej_q", passive=True)
    assert ok.message_count == 0


async def test_recover_requeue(client):
    ch = await client.channel()
    await ch.queue_declare("rec_q")
    received = []
    got2 = asyncio.get_event_loop().create_future()

    def cb(msg):
        received.append(msg)
        if len(received) == 2 and not got2.done():
            got2.set_result(None)

    await ch.basic_consume("rec_q", cb)
    ch.basic_publish(b"m", routing_key="rec_q")
    await asyncio.sleep(0.1)
    assert len(received) == 1
    await ch.basic_recover(requeue=True)
    await asyncio.wait_for(got2, 5)
    assert received[1].redelivered
    ch.basic_ack(received[1].delivery_tag)


async def test_qos_prefetch_limits_unacked(client):
    ch = await client.channel()
    await ch.queue_declare("qos_q")
    await ch.basic_qos(prefetch_count=2)
    received = []

    def cb(msg):
        received.append(msg)

    await ch.basic_consume("qos_q", cb)
    for i in range(5):
        ch.basic_publish(f"m{i}".encode(), routing_key="qos_q")
    await asyncio.sleep(0.2)
    assert len(received) == 2  # prefetch window full
    ch.basic_ack(received[0].delivery_tag)
    await asyncio.sleep(0.1)
    assert len(received) == 3  # one slot freed, one more delivered
    # ack all -> the rest flows
    ch.basic_ack(received[-1].delivery_tag, multiple=True)
    await asyncio.sleep(0.1)
    assert len(received) == 5


async def test_publisher_confirms(client):
    ch = await client.channel()
    await ch.confirm_select()
    await ch.queue_declare("conf_q")
    for i in range(10):
        await ch.basic_publish_confirmed(f"c{i}".encode(), routing_key="conf_q")
    assert not ch.unconfirmed
    ok = await ch.queue_declare("conf_q", passive=True)
    assert ok.message_count == 10


async def test_mandatory_unroutable_returns(client):
    ch = await client.channel()
    await ch.exchange_declare("mand_ex", "direct")
    ch.basic_publish(b"lost", exchange="mand_ex", routing_key="nowhere",
                     mandatory=True)
    await asyncio.sleep(0.1)
    assert len(ch.returns) == 1
    assert ch.returns[0].reply_code == 312  # NO_ROUTE
    assert ch.returns[0].body == b"lost"


async def test_immediate_no_consumers_returns(client):
    ch = await client.channel()
    await ch.queue_declare("imm_q")
    ch.basic_publish(b"now-or-never", routing_key="imm_q", immediate=True)
    await asyncio.sleep(0.1)
    assert len(ch.returns) == 1
    assert ch.returns[0].reply_code == 313  # NO_CONSUMERS


async def test_per_message_ttl_expires(client):
    ch = await client.channel()
    await ch.queue_declare("ttl_q")
    ch.basic_publish(b"fleeting", routing_key="ttl_q",
                     properties=BasicProperties(expiration="50"))
    await asyncio.sleep(0.02)
    ok = await ch.queue_declare("ttl_q", passive=True)
    assert ok.message_count == 1
    await asyncio.sleep(0.15)
    assert await ch.basic_get("ttl_q", no_ack=True) is None


async def test_queue_ttl_argument_expires(client):
    ch = await client.channel()
    await ch.queue_declare("qttl_q", arguments={"x-message-ttl": 50})
    ch.basic_publish(b"x", routing_key="qttl_q")
    await asyncio.sleep(0.2)
    assert await ch.basic_get("qttl_q", no_ack=True) is None


async def test_queue_purge_and_delete(client):
    ch = await client.channel()
    await ch.queue_declare("purge_q")
    for _ in range(3):
        ch.basic_publish(b"x", routing_key="purge_q")
    await asyncio.sleep(0.05)
    assert await ch.queue_purge("purge_q") == 3
    ch.basic_publish(b"y", routing_key="purge_q")
    await asyncio.sleep(0.05)
    assert await ch.queue_delete("purge_q") == 1
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.queue_declare("purge_q", passive=True)
    assert exc_info.value.reply_code == 404


async def test_exclusive_queue_locked_to_connection(server, client):
    ch = await client.channel()
    await ch.queue_declare("excl_q", exclusive=True)
    other = await AMQPClient.connect("127.0.0.1", server.bound_port)
    try:
        ch2 = await other.channel()
        with pytest.raises(ChannelClosedError) as exc_info:
            await ch2.queue_declare("excl_q", passive=True)
        assert exc_info.value.reply_code == 405  # RESOURCE_LOCKED
    finally:
        await other.close()


async def test_exclusive_queue_dies_with_connection(server, client):
    temp = await AMQPClient.connect("127.0.0.1", server.bound_port)
    ch = await temp.channel()
    await ch.queue_declare("ephemeral_q", exclusive=True)
    await temp.close()
    await asyncio.sleep(0.1)
    ch2 = await client.channel()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch2.queue_declare("ephemeral_q", passive=True)
    assert exc_info.value.reply_code == 404


async def test_auto_delete_queue_on_last_consumer_cancel(client):
    ch = await client.channel()
    await ch.queue_declare("auto_q", auto_delete=True)
    tag = await ch.basic_consume("auto_q", lambda m: None)
    await ch.basic_cancel(tag)
    await asyncio.sleep(0.1)
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.queue_declare("auto_q", passive=True)
    assert exc_info.value.reply_code == 404


async def test_unacked_requeued_on_channel_close(client):
    ch = await client.channel()
    await ch.queue_declare("requeue_q")
    cb, wait = await collect(1)
    await ch.basic_consume("requeue_q", cb)
    ch.basic_publish(b"inflight", routing_key="requeue_q")
    await wait()
    await ch.close()
    await asyncio.sleep(0.1)
    ch2 = await client.channel()
    msg = await ch2.basic_get("requeue_q", no_ack=True)
    assert msg is not None
    assert msg.body == b"inflight"
    assert msg.redelivered


async def test_channel_error_does_not_kill_connection(client):
    ch = await client.channel()
    with pytest.raises(ChannelClosedError):
        await ch.queue_declare("missing_q", passive=True)
    # connection still usable
    ch2 = await client.channel()
    ok = await ch2.queue_declare("alive_q")
    assert ok.queue == "alive_q"


async def test_large_message_fragmentation(server, client):
    ch = await client.channel()
    await ch.queue_declare("big_q")
    body = bytes(range(256)) * 4096  # 1 MiB >> frame_max 128 KiB
    cb, wait = await collect(1, timeout=10)
    await ch.basic_consume("big_q", cb, no_ack=True)
    ch.basic_publish(body, routing_key="big_q")
    received = await wait()
    assert received[0].body == body


async def test_multiple_vhosts_isolated(server):
    await server.broker.create_vhost("other")
    c1 = await AMQPClient.connect("127.0.0.1", server.bound_port, vhost="/")
    c2 = await AMQPClient.connect("127.0.0.1", server.bound_port, vhost="other")
    try:
        ch1 = await c1.channel()
        ch2 = await c2.channel()
        await ch1.queue_declare("shared_name")
        ch1.basic_publish(b"for-default", routing_key="shared_name")
        # same queue name in the other vhost is a different queue
        await ch2.queue_declare("shared_name")
        await asyncio.sleep(0.05)
        assert await ch2.basic_get("shared_name", no_ack=True) is None
    finally:
        await c1.close()
        await c2.close()


async def test_concurrent_consumers_round_robin(client):
    ch = await client.channel()
    await ch.queue_declare("rr_q")
    seen_by = {"a": 0, "b": 0}

    def make_cb(name):
        def cb(msg):
            seen_by[name] += 1
            ch.basic_ack(msg.delivery_tag)
        return cb

    await ch.basic_consume("rr_q", make_cb("a"))
    await ch.basic_consume("rr_q", make_cb("b"))
    for i in range(20):
        ch.basic_publish(b"x", routing_key="rr_q")
    await asyncio.sleep(0.3)
    assert seen_by["a"] + seen_by["b"] == 20
    assert seen_by["a"] == 10 and seen_by["b"] == 10  # fair round-robin


async def test_publish_cache_detects_props_mutation(client):
    """The client's publish-template cache must re-encode when a reused
    properties object is mutated between publishes (mutating a shared props
    object per message is a common client pattern)."""
    ch = await client.channel()
    await ch.queue_declare("mutq")
    props = BasicProperties(delivery_mode=1, correlation_id="a")
    ch.basic_publish(b"m1", routing_key="mutq", properties=props)
    props.delivery_mode = 2
    props.correlation_id = "b"
    ch.basic_publish(b"m2", routing_key="mutq", properties=props)
    await client.drain()
    m1 = await ch.basic_get("mutq", no_ack=True)
    m2 = await ch.basic_get("mutq", no_ack=True)
    assert m1.properties.delivery_mode == 1
    assert m1.properties.correlation_id == "a"
    assert m2.properties.delivery_mode == 2
    assert m2.properties.correlation_id == "b"


async def test_vhost_isolation(server):
    """Same-named queues and exchanges in different vhosts are fully
    separate (reference: VirtualHost model + entity ids prefixed with the
    vhost, VhostEntity.scala:20-131)."""
    await server.broker.create_vhost("tenant")
    ca = await AMQPClient.connect("127.0.0.1", server.bound_port)
    cb = await AMQPClient.connect("127.0.0.1", server.bound_port,
                                  vhost="tenant")
    cha, chb = await ca.channel(), await cb.channel()
    await cha.queue_declare("iso_q")
    await chb.queue_declare("iso_q")
    cha.basic_publish(b"for-root", routing_key="iso_q")
    chb.basic_publish(b"for-tenant", routing_key="iso_q")
    await asyncio.sleep(0.1)
    assert (await cha.basic_get("iso_q", no_ack=True)).body == b"for-root"
    assert (await chb.basic_get("iso_q", no_ack=True)).body == b"for-tenant"
    assert await cha.basic_get("iso_q", no_ack=True) is None
    assert await chb.basic_get("iso_q", no_ack=True) is None
    await cha.exchange_declare("iso_ex", "fanout")
    with pytest.raises(Exception):
        await chb.exchange_declare("iso_ex", "fanout", passive=True)
    await ca.close()
    await cb.close()


async def test_consumer_cancel_notify_on_queue_delete(client):
    """Deleting a queue under a live consumer sends a server-side
    Basic.Cancel to clients that announced consumer_cancel_notify
    (RabbitMQ extension; the reference never cancels)."""
    assert client.server_properties["capabilities"]["consumer_cancel_notify"]
    ch = await client.channel()
    await ch.queue_declare("ccn_q")
    tag = await ch.basic_consume("ccn_q", lambda m: None)
    ch2 = await client.channel()
    await ch2.queue_delete("ccn_q")
    for _ in range(50):
        if ch.cancelled_consumers:
            break
        await asyncio.sleep(0.02)
    assert ch.cancelled_consumers == [tag]


async def test_consumer_cancel_notify_across_connections(server):
    """The cancel notification reaches a consumer on a DIFFERENT connection
    than the one deleting the queue."""
    from chanamq_tpu_torch.client import AMQPClient as _C

    c1 = await _C.connect("127.0.0.1", server.bound_port)
    c2 = await _C.connect("127.0.0.1", server.bound_port)
    try:
        ch1 = await c1.channel()
        await ch1.queue_declare("ccn2_q")
        tag = await ch1.basic_consume("ccn2_q", lambda m: None)
        ch2 = await c2.channel()
        await ch2.queue_delete("ccn2_q")
        for _ in range(50):
            if ch1.cancelled_consumers:
                break
            await asyncio.sleep(0.02)
        assert ch1.cancelled_consumers == [tag]
    finally:
        await c1.close()
        await c2.close()


async def test_consumer_ack_timeout_closes_channel_and_requeues():
    """chana.mq.consumer.timeout (RabbitMQ consumer_timeout): a delivery
    unacked past the deadline closes the offending channel with 406 and
    requeues the messages; other channels are untouched."""
    from chanamq_tpu_torch.broker.broker import Broker

    broker = Broker(message_sweep_interval_s=0.1, consumer_timeout_ms=300,
                    router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        stuck = await c.channel()
        healthy = await c.channel()
        await stuck.queue_declare("at_q")
        got = []
        await stuck.basic_consume("at_q", got.append)  # never acks
        stuck.basic_publish(b"hung", routing_key="at_q")
        for _ in range(50):
            if got:
                break
            await asyncio.sleep(0.02)
        assert got, "delivery never arrived"
        # wait past timeout + sweep: the stuck channel dies with 406
        err = None
        for _ in range(100):
            try:
                await stuck.queue_declare("at_q", passive=True)
            except ChannelClosedError as exc:
                err = exc
                break
            await asyncio.sleep(0.05)
        assert err is not None and err.reply_code == 406
        assert "timeout" in err.reply_text
        # the message requeued and the healthy channel can take it
        m = None
        for _ in range(100):
            m = await healthy.basic_get("at_q", no_ack=True)
            if m is not None:
                break
            await asyncio.sleep(0.02)
        assert m is not None and m.body == b"hung" and m.redelivered
        await c.close()
    finally:
        await srv.stop()


async def test_prompt_acks_never_hit_ack_timeout():
    from chanamq_tpu_torch.broker.broker import Broker

    broker = Broker(message_sweep_interval_s=0.05, consumer_timeout_ms=400,
                    router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("ok_q")

        def on_msg(m):
            ch.basic_ack(m.delivery_tag)

        await ch.basic_consume("ok_q", on_msg)
        for _ in range(10):
            ch.basic_publish(b"quick", routing_key="ok_q")
            await asyncio.sleep(0.08)
        # channel survived well past the timeout window
        ok = await ch.queue_declare("ok_q", passive=True)
        assert ok.queue == "ok_q"
        await c.close()
    finally:
        await srv.stop()


async def test_ack_timeout_covers_tx_parked_settles():
    """A consumer that acks inside a transaction it never commits still
    pins the message — the ack timeout must see the tx-parked delivery and
    close the channel (implicit rollback requeues it)."""
    from chanamq_tpu_torch.broker.broker import Broker

    broker = Broker(message_sweep_interval_s=0.1, consumer_timeout_ms=300,
                    router_device="cpu")
    srv = BrokerServer(broker=broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("txat_q")
        ch.basic_publish(b"parked", routing_key="txat_q")
        msg = None
        for _ in range(50):
            msg = await ch.basic_get("txat_q")
            if msg is not None:
                break
            await asyncio.sleep(0.02)
        assert msg is not None
        await ch.tx_select()
        ch.basic_ack(msg.delivery_tag)  # parked in the tx, never committed
        err = None
        for _ in range(100):
            try:
                await ch.queue_declare("txat_q", passive=True)
            except ChannelClosedError as exc:
                err = exc
                break
            await asyncio.sleep(0.05)
        assert err is not None and err.reply_code == 406
        # implicit rollback requeued it
        ch2 = await c.channel()
        m = None
        for _ in range(100):
            m = await ch2.basic_get("txat_q", no_ack=True)
            if m is not None:
                break
            await asyncio.sleep(0.02)
        assert m is not None and m.body == b"parked" and m.redelivered
        await c.close()
    finally:
        await srv.stop()
