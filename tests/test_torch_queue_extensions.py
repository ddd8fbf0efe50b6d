"""Queue-argument extensions: dead-letter exchanges, length/byte caps with
drop-head overflow, and idle queue auto-expiry (x-expires).

All EXCEED the reference, whose only queue argument is x-message-ttl
(QueueEntity.scala:288-297). Semantics follow RabbitMQ: x-death headers
accumulate per (queue, reason), automatic deaths (expired/maxlen) never
cycle, per-message expiration is cleared on dead-lettering, and caps bound
READY messages with oldest-first drop.

The port's copy of ``tests/test_queue_extensions.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError

pytestmark = pytest.mark.asyncio


@pytest.fixture
async def server():
    srv = BrokerServer(broker=Broker(message_sweep_interval_s=0.1,
                                     router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    yield srv
    await srv.stop()


@pytest.fixture
async def client(server):
    c = await AMQPClient.connect("127.0.0.1", server.bound_port)
    yield c
    await c.close()


async def drain(ch, queue, n, timeout=3.0):
    out = []
    deadline = asyncio.get_event_loop().time() + timeout
    while len(out) < n and asyncio.get_event_loop().time() < deadline:
        msg = await ch.basic_get(queue, no_ack=True)
        if msg is None:
            await asyncio.sleep(0.02)
            continue
        out.append(msg)
    return out


async def declare_dlq(ch, dlq="dlq"):
    await ch.exchange_declare("dlx_ex", "fanout")
    await ch.queue_declare(dlq)
    await ch.queue_bind(dlq, "dlx_ex", "")


# -- max-length ------------------------------------------------------------


async def test_max_length_drops_oldest(client):
    ch = await client.channel()
    await ch.queue_declare("cap_q", arguments={"x-max-length": 3})
    for i in range(5):
        ch.basic_publish(b"m%d" % i, routing_key="cap_q")
    await asyncio.sleep(0.05)
    ok = await ch.queue_declare("cap_q", passive=True)
    assert ok.message_count == 3
    bodies = [m.body for m in await drain(ch, "cap_q", 3)]
    assert bodies == [b"m2", b"m3", b"m4"]


async def test_max_length_bytes_drops_oldest(client):
    ch = await client.channel()
    await ch.queue_declare("capb_q", arguments={"x-max-length-bytes": 250})
    for i in range(4):
        ch.basic_publish(bytes([48 + i]) * 100, routing_key="capb_q")
    await asyncio.sleep(0.05)
    ok = await ch.queue_declare("capb_q", passive=True)
    assert ok.message_count == 2  # 2x100 <= 250 < 3x100
    bodies = [m.body for m in await drain(ch, "capb_q", 2)]
    assert bodies == [b"2" * 100, b"3" * 100]


async def test_maxlen_overflow_dead_letters(client):
    ch = await client.channel()
    await declare_dlq(ch)
    await ch.queue_declare("capd_q", arguments={
        "x-max-length": 1, "x-dead-letter-exchange": "dlx_ex"})
    ch.basic_publish(b"first", routing_key="capd_q")
    ch.basic_publish(b"second", routing_key="capd_q")
    got = await drain(ch, "dlq", 1)
    assert [m.body for m in got] == [b"first"]
    death = got[0].properties.headers["x-death"][0]
    assert death["queue"] == "capd_q"
    assert death["reason"] == "maxlen"
    assert death["count"] == 1


# -- dead-letter on expiry and reject --------------------------------------


async def test_ttl_expiry_dead_letters_with_x_death(client):
    ch = await client.channel()
    await declare_dlq(ch)
    await ch.queue_declare("ttl_q", arguments={
        "x-message-ttl": 60, "x-dead-letter-exchange": "dlx_ex",
        "x-dead-letter-routing-key": "was-ttl"})
    ch.basic_publish(b"doomed", routing_key="ttl_q",
                     properties=BasicProperties(expiration="60"))
    got = await drain(ch, "dlq", 1)
    assert [m.body for m in got] == [b"doomed"]
    msg = got[0]
    assert msg.routing_key == "was-ttl"
    # expiration cleared so it cannot instantly re-expire in the DLQ
    assert msg.properties.expiration is None
    death = msg.properties.headers["x-death"][0]
    assert death["reason"] == "expired"
    assert death["queue"] == "ttl_q"
    assert death["routing-keys"] == ["ttl_q"]
    assert msg.properties.headers["x-first-death-reason"] == "expired"
    assert msg.properties.headers["x-first-death-queue"] == "ttl_q"


async def test_reject_dead_letters(client):
    ch = await client.channel()
    await declare_dlq(ch)
    await ch.queue_declare("rej_q", arguments={
        "x-dead-letter-exchange": "dlx_ex"})
    ch.basic_publish(b"bad", routing_key="rej_q")
    msg = await (await drain_one(ch, "rej_q"))
    ch.basic_reject(msg.delivery_tag, requeue=False)
    got = await drain(ch, "dlq", 1)
    assert [m.body for m in got] == [b"bad"]
    death = got[0].properties.headers["x-death"][0]
    assert death["reason"] == "rejected"


async def drain_one(ch, queue, timeout=3.0):
    async def inner():
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            msg = await ch.basic_get(queue)
            if msg is not None:
                return msg
            await asyncio.sleep(0.02)
        return None
    return inner()


async def test_nack_requeue_false_dead_letters_and_count_increments(client):
    """A reject cycle through the same queue increments the x-death count
    (client-driven rejects may legally cycle)."""
    ch = await client.channel()
    await ch.exchange_declare("back_ex", "fanout")
    await ch.queue_declare("cycle_q", arguments={
        "x-dead-letter-exchange": "back_ex"})
    await ch.queue_bind("cycle_q", "back_ex", "")  # DLX routes BACK to cycle_q
    ch.basic_publish(b"again", routing_key="cycle_q")
    for expected_count in (1, 2):
        msg = await (await drain_one(ch, "cycle_q"))
        assert msg is not None
        ch.basic_nack(msg.delivery_tag, requeue=False)
        await asyncio.sleep(0.1)
    msg = await (await drain_one(ch, "cycle_q"))
    assert msg is not None
    death = msg.properties.headers["x-death"][0]
    assert death["reason"] == "rejected" and death["count"] == 2


async def test_automatic_death_does_not_cycle(server, client):
    """expired/maxlen dead-letters that route back to the same queue drop on
    the second pass instead of looping forever."""
    ch = await client.channel()
    await ch.exchange_declare("loopback_ex", "fanout")
    await ch.queue_declare("loop_q", arguments={
        "x-message-ttl": 50, "x-dead-letter-exchange": "loopback_ex"})
    await ch.queue_bind("loop_q", "loopback_ex", "")
    ch.basic_publish(b"once-around", routing_key="loop_q")
    await asyncio.sleep(1.0)  # several sweep + TTL cycles
    # first expiry forwarded it back to loop_q (x-death count 1); there it
    # re-queued WITHOUT expiration... but queue TTL still applies, so the
    # second expiry sees the (loop_q, expired) entry and drops it
    ok = await ch.queue_declare("loop_q", passive=True)
    assert ok.message_count == 0
    assert server.broker.metrics.dead_lettered_msgs == 1


async def test_dlx_to_missing_exchange_drops(client):
    ch = await client.channel()
    await ch.queue_declare("noex_q", arguments={
        "x-max-length": 0, "x-dead-letter-exchange": "ghost_ex"})
    ch.basic_publish(b"void", routing_key="noex_q")
    await asyncio.sleep(0.1)
    ok = await ch.queue_declare("noex_q", passive=True)
    assert ok.message_count == 0  # dropped, broker healthy
    ch.basic_publish(b"still-works", routing_key="noex_q")
    await asyncio.sleep(0.05)


# -- x-expires -------------------------------------------------------------


async def test_queue_idle_expiry(client):
    ch = await client.channel()
    await ch.queue_declare("idle_q", arguments={"x-expires": 300})
    ch.basic_publish(b"x", routing_key="idle_q")
    await asyncio.sleep(1.0)  # > x-expires + sweep interval
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.queue_declare("idle_q", passive=True)
    assert exc_info.value.reply_code == 404


async def test_queue_with_consumer_does_not_idle_expire(client):
    ch = await client.channel()
    await ch.queue_declare("busy_q", arguments={"x-expires": 300})
    await ch.basic_consume("busy_q", lambda m: None)
    await asyncio.sleep(1.0)
    ok = await ch.queue_declare("busy_q", passive=True)
    assert ok.queue == "busy_q"  # alive: consumer pins it


async def test_use_resets_idle_clock(client):
    ch = await client.channel()
    await ch.queue_declare("pinged_q", arguments={"x-expires": 600})
    for _ in range(4):
        await asyncio.sleep(0.3)
        await ch.basic_get("pinged_q")  # use resets the clock
    ok = await ch.queue_declare("pinged_q", passive=True)
    assert ok.queue == "pinged_q"


# -- validation ------------------------------------------------------------


async def test_invalid_arguments_rejected(client):
    cases = [
        {"x-max-length": -1},
        {"x-max-length-bytes": "big"},
        {"x-expires": 0},
        {"x-dead-letter-exchange": 7},
        {"x-dead-letter-routing-key": "rk"},  # without x-dead-letter-exchange
        {"x-overflow": "reject-publish"},
    ]
    for args in cases:
        ch = await client.channel()
        with pytest.raises(ChannelClosedError) as exc_info:
            await ch.queue_declare("bad_q", arguments=args)
        assert exc_info.value.reply_code == 406, args


async def test_retry_topology_survives_multiple_passes(client):
    """Work queue -> TTL retry queue -> work queue: a history containing an
    explicit reject is a client-driven retry loop and must keep flowing
    (only FULLY automatic cycles are suppressed)."""
    ch = await client.channel()
    await ch.exchange_declare("work_dlx", "fanout")
    await ch.exchange_declare("retry_dlx", "fanout")
    await ch.queue_declare("work_q", arguments={
        "x-dead-letter-exchange": "work_dlx"})
    await ch.queue_declare("retry_q", arguments={
        "x-message-ttl": 60, "x-dead-letter-exchange": "retry_dlx"})
    await ch.queue_bind("retry_q", "work_dlx", "")
    await ch.queue_bind("work_q", "retry_dlx", "")

    ch.basic_publish(b"job", routing_key="work_q")
    for attempt in (1, 2, 3):
        msg = await (await drain_one(ch, "work_q", timeout=5.0))
        assert msg is not None, f"retry attempt {attempt} never redelivered"
        ch.basic_reject(msg.delivery_tag, requeue=False)
    # after 3 rejects the job has cycled work->retry->work 3 times; the
    # x-death history shows both the rejects and the retry-queue expiries
    msg = await (await drain_one(ch, "work_q", timeout=5.0))
    assert msg is not None
    deaths = {(d["queue"], d["reason"]): d["count"]
              for d in msg.properties.headers["x-death"]}
    assert deaths[("work_q", "rejected")] == 3
    assert deaths[("retry_q", "expired")] == 3


async def test_dlx_default_exchange_routes_to_named_queue(client):
    """x-dead-letter-exchange \"\" with a routing key is the standard
    RabbitMQ pattern for dead-lettering straight into a named queue via
    the default exchange."""
    ch = await client.channel()
    await ch.queue_declare("direct_dlq")
    await ch.queue_declare("dd_q", arguments={
        "x-dead-letter-exchange": "",
        "x-dead-letter-routing-key": "direct_dlq",
        "x-max-length": 0})
    ch.basic_publish(b"straight", routing_key="dd_q")
    got = await drain(ch, "direct_dlq", 1)
    assert [m.body for m in got] == [b"straight"]
    assert got[0].properties.headers["x-death"][0]["reason"] == "maxlen"


async def test_queue_extension_arguments_survive_restart(tmp_path):
    """Caps and DLX wiring on a durable queue are recovered from the store:
    after a restart the max-length still drops to the DLX."""
    from chanamq_tpu_torch.store.sqlite import SqliteStore

    db_path = str(tmp_path / "args.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.exchange_declare("ra_dlx", "fanout", durable=True)
        await ch.queue_declare("ra_dlq", durable=True)
        await ch.queue_bind("ra_dlq", "ra_dlx", "")
        await ch.queue_declare("ra_q", durable=True, arguments={
            "x-max-length": 1, "x-dead-letter-exchange": "ra_dlx"})
        await c.close()
    finally:
        await srv.stop()

    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ch2.basic_publish(b"one", routing_key="ra_q",
                          properties=BasicProperties(delivery_mode=2))
        ch2.basic_publish(b"two", routing_key="ra_q",
                          properties=BasicProperties(delivery_mode=2))
        got = await drain(ch2, "ra_dlq", 1)
        assert [m.body for m in got] == [b"one"]
        assert got[0].properties.headers["x-death"][0]["reason"] == "maxlen"
        ok = await ch2.queue_declare("ra_q", passive=True)
        assert ok.message_count == 1
        await c2.close()
    finally:
        await srv2.stop()


# -- consumer priorities (x-priority consume argument) ----------------------


async def test_consumer_priority_preferred_while_it_has_budget(server):
    """x-priority consumers are served first while they have prefetch
    budget; deliveries spill to lower priorities when the window is full
    (RabbitMQ consumer-priority semantics; the reference round-robins
    only)."""
    from chanamq_tpu_torch.client import AMQPClient as _C

    c_hi = await _C.connect("127.0.0.1", server.bound_port)
    c_lo = await _C.connect("127.0.0.1", server.bound_port)
    try:
        setup = await c_hi.channel()
        await setup.queue_declare("prio_q")

        hi_got, lo_got = [], []
        ch_hi = await c_hi.channel()
        await ch_hi.basic_qos(prefetch_count=2)
        await ch_hi.basic_consume("prio_q", hi_got.append,
                                  arguments={"x-priority": 10})
        ch_lo = await c_lo.channel()
        await ch_lo.basic_qos(prefetch_count=100)
        await ch_lo.basic_consume("prio_q", lo_got.append)

        for i in range(6):
            setup.basic_publish(b"p%d" % i, routing_key="prio_q")
        await asyncio.sleep(0.3)
        # high priority takes its full window of 2; the rest spill to low
        assert len(hi_got) == 2, (hi_got, lo_got)
        assert len(lo_got) == 4
        assert [m.body for m in hi_got] == [b"p0", b"p1"]
        # acking frees the window: the next message prefers high again
        for m in hi_got:
            ch_hi.basic_ack(m.delivery_tag)
        setup.basic_publish(b"p6", routing_key="prio_q")
        await asyncio.sleep(0.2)
        assert [m.body for m in hi_got[2:]] == [b"p6"]
    finally:
        await c_hi.close()
        await c_lo.close()


async def test_consumer_priority_invalid_argument_rejected(client):
    ch = await client.channel()
    await ch.queue_declare("prio_bad_q")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.basic_consume("prio_bad_q", lambda m: None,
                               arguments={"x-priority": "high"})
    assert exc_info.value.reply_code == 406


async def test_consumer_priority_round_robin_within_level(server):
    """Spills below a busy high-priority consumer still round-robin across
    ALL lower-level siblings (per-level rotation indexes)."""
    from chanamq_tpu_torch.client import AMQPClient as _C

    c_hi = await _C.connect("127.0.0.1", server.bound_port)
    c_lo = await _C.connect("127.0.0.1", server.bound_port)
    try:
        setup = await c_hi.channel()
        await setup.queue_declare("prio_rr_q")
        ch_hi = await c_hi.channel()
        await ch_hi.basic_qos(prefetch_count=1)
        hi_got = []
        await ch_hi.basic_consume("prio_rr_q", hi_got.append,
                                  arguments={"x-priority": 10})
        counts = {"a": 0, "b": 0, "c": 0}
        ch_lo = await c_lo.channel()
        for name in counts:
            def mk(n):
                return lambda m: counts.__setitem__(n, counts[n] + 1)
            await ch_lo.basic_consume("prio_rr_q", mk(name), no_ack=True,
                                      consumer_tag=f"lo-{name}")
        for i in range(10):
            setup.basic_publish(b"m%d" % i, routing_key="prio_rr_q")
        await asyncio.sleep(0.3)
        # high takes 1 (window full, never acked); 9 spill across a/b/c
        assert len(hi_got) == 1
        assert sum(counts.values()) == 9
        assert all(v >= 2 for v in counts.values()), counts
    finally:
        await c_hi.close()
        await c_lo.close()


# -- single-active consumer (x-single-active-consumer) ----------------------


async def test_single_active_consumer_exclusive_delivery_and_takeover(server):
    """SAC: only the longest-registered consumer receives; cancelling it
    hands the queue to the next registrant, and a consumer-connection
    death does the same."""
    from chanamq_tpu_torch.client import AMQPClient as _C

    c1 = await _C.connect("127.0.0.1", server.bound_port)
    c2 = await _C.connect("127.0.0.1", server.bound_port)
    c3 = await _C.connect("127.0.0.1", server.bound_port)
    try:
        setup = await c1.channel()
        await setup.queue_declare("sac_q", arguments={
            "x-single-active-consumer": True})
        a_got, b_got, c_got = [], [], []
        ch_a = await c1.channel()
        tag_a = await ch_a.basic_consume("sac_q", a_got.append, no_ack=True)
        ch_b = await c2.channel()
        await ch_b.basic_consume("sac_q", b_got.append, no_ack=True)
        ch_c = await c3.channel()
        await ch_c.basic_consume("sac_q", c_got.append, no_ack=True)

        for i in range(6):
            setup.basic_publish(b"m%d" % i, routing_key="sac_q")
        await asyncio.sleep(0.2)
        assert len(a_got) == 6 and not b_got and not c_got

        # cancel the active consumer: B takes over
        await ch_a.basic_cancel(tag_a)
        setup.basic_publish(b"next", routing_key="sac_q")
        await asyncio.sleep(0.2)
        assert [m.body for m in b_got] == [b"next"] and not c_got

        # kill B's connection: C takes over
        await c2.close()
        await asyncio.sleep(0.2)
        setup.basic_publish(b"last", routing_key="sac_q")
        await asyncio.sleep(0.2)
        assert [m.body for m in c_got] == [b"last"]
    finally:
        await c1.close()
        await c3.close()


async def test_single_active_consumer_validation(client):
    ch = await client.channel()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.queue_declare("sac_bad", arguments={
            "x-single-active-consumer": "yes"})
    assert exc_info.value.reply_code == 406


async def test_single_active_consumer_prefers_highest_priority(server):
    """SAC + x-priority: the ACTIVE consumer is the highest-priority one
    (RabbitMQ 3.12+ activation rule), even if registered later."""
    from chanamq_tpu_torch.client import AMQPClient as _C

    c1 = await _C.connect("127.0.0.1", server.bound_port)
    c2 = await _C.connect("127.0.0.1", server.bound_port)
    try:
        setup = await c1.channel()
        await setup.queue_declare("sacp_q", arguments={
            "x-single-active-consumer": True})
        low_got, high_got = [], []
        ch_low = await c1.channel()
        await ch_low.basic_consume("sacp_q", low_got.append, no_ack=True)
        ch_high = await c2.channel()
        tag_high = await ch_high.basic_consume(
            "sacp_q", high_got.append, no_ack=True,
            arguments={"x-priority": 10})
        for i in range(4):
            setup.basic_publish(b"p%d" % i, routing_key="sacp_q")
        await asyncio.sleep(0.2)
        assert len(high_got) == 4 and not low_got
        # cancelling the high-priority active hands back to the low one
        await ch_high.basic_cancel(tag_high)
        setup.basic_publish(b"after", routing_key="sacp_q")
        await asyncio.sleep(0.2)
        assert [m.body for m in low_got] == [b"after"]
    finally:
        await c1.close()
        await c2.close()
