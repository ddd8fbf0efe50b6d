"""Regression tests for broker defects found in review.

The port's copy of ``tests/test_broker_regressions.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp import methods as am
from chanamq_tpu_torch.amqp.frame import Frame
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


async def test_delete_queue_with_autodelete_exchange_does_not_crash(client):
    """Auto-delete exchange whose last binding dies with the queue: the
    queue delete must complete and the exchange must auto-delete."""
    ch = await client.channel()
    await ch.exchange_declare("auto_ex", "direct", auto_delete=True)
    await ch.queue_declare("only_q")
    await ch.queue_bind("only_q", "auto_ex", "k")
    count = await ch.queue_delete("only_q")  # used to RuntimeError server-side
    assert count == 0
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.exchange_declare("auto_ex", "direct", passive=True)
    assert exc_info.value.reply_code == 404


async def test_client_heartbeat_zero_not_timed_out():
    """A client negotiating heartbeat=0 must not be disconnected while idle,
    even when the server has a (tiny) configured heartbeat."""
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=1)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port, heartbeat=0)
        # client explicitly asked for heartbeat=0 in tune-ok
        assert c.heartbeat_s == 0
        await asyncio.sleep(2.5)  # > 2x server heartbeat interval
        ch = await c.channel()  # connection must still be alive
        ok = await ch.queue_declare("still_alive")
        assert ok.queue == "still_alive"
        await c.close()
    finally:
        await srv.stop()


async def test_pipelined_commands_after_soft_error_are_discarded(client):
    """Commands already pipelined on a channel that just got a soft
    Channel.Close must be discarded, not escalate to a connection error."""
    ch = await client.channel()
    # two commands in one write: first triggers 404, second is pipelined junk
    client._send_method(ch.id, am.Basic.Get(queue="missing_q"))
    client._send_method(ch.id, am.Queue.Declare(queue="pipelined_q"))
    await asyncio.sleep(0.2)
    assert ch.closed
    assert ch.close_reason.reply_code == 404
    # the connection survived; a fresh channel works
    ch2 = await client.channel()
    ok = await ch2.queue_declare("post_error_q")
    assert ok.queue == "post_error_q"


async def test_client_channel_ids_are_reused(server):
    c = await AMQPClient.connect("127.0.0.1", server.bound_port)
    try:
        c.channel_max = 8  # tiny budget: without reuse this exhausts fast
        for _ in range(50):
            ch = await c.channel()
            await ch.close()
        assert c._next_channel <= 3
    finally:
        await c.close()


async def test_async_fixture_with_request_param(request):
    """conftest shim must pass `request` through to async fixtures/tests."""
    assert request.node.name == "test_async_fixture_with_request_param"


async def test_confirms_flushed_before_pipelined_channel_close(client):
    """Publishes pipelined immediately ahead of Channel.Close in one TCP
    batch must still be confirmed before the close-ok (review regression:
    deferred coalesced confirms were dropped on close)."""
    ch = await client.channel()
    await ch.confirm_select()
    await ch.queue_declare("pc_q")
    # one write burst: 10 publishes + channel.close, no drain between
    for _ in range(10):
        ch.basic_publish(b"m", routing_key="pc_q")
    close_fut = asyncio.get_event_loop().create_task(ch.close())
    await asyncio.wait_for(close_fut, 5)
    # every publish was confirmed before the channel went away
    assert not ch.unconfirmed


async def test_wait_unconfirmed_wakes_on_close(server):
    """wait_unconfirmed_below must raise promptly when the channel dies,
    not sleep out its timeout."""
    c = await AMQPClient.connect("127.0.0.1", server.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    ch.basic_publish(b"m", exchange="missing_ex", routing_key="x")  # 404 soft error
    t0 = asyncio.get_event_loop().time()
    with pytest.raises((ChannelClosedError, asyncio.TimeoutError)):
        await ch.wait_unconfirmed_below(1, timeout=10)
    assert asyncio.get_event_loop().time() - t0 < 5  # woke early, not at timeout


async def test_nack_multiple_unknown_tag_is_channel_error(client):
    """ADVICE r3: an unknown nonzero tag with multiple=true that resolves no
    deliveries must raise PRECONDITION_FAILED like the single-tag path
    (RabbitMQ errors on unknown nonzero tags regardless of multiple)."""
    ch = await client.channel()
    await ch.queue_declare("nack_q")
    # no deliveries ever issued on this channel: tag 5 is above the range
    client._send_method(ch.id, am.Basic.Nack(
        delivery_tag=5, multiple=True, requeue=True))
    await asyncio.sleep(0.2)
    assert ch.closed
    assert ch.close_reason.reply_code == 406


async def test_ack_multiple_settled_range_is_noop(client):
    """A multiple ack whose covered tags are already settled is a legal
    no-op (tag within the issued range) — only above-range tags error."""
    ch = await client.channel()
    await ch.queue_declare("ack_q")
    ch.basic_publish(b"m1", routing_key="ack_q")
    m = None
    for _ in range(50):
        m = await ch.basic_get("ack_q")
        if m is not None:
            break
        await asyncio.sleep(0.02)
    assert m is not None
    ch.basic_ack(m.delivery_tag)
    # re-ack the same (settled) tag with multiple=true: inside issued range
    client._send_method(ch.id, am.Basic.Ack(
        delivery_tag=m.delivery_tag, multiple=True))
    await asyncio.sleep(0.2)
    assert not ch.closed
    # but an above-range multiple ack errors
    client._send_method(ch.id, am.Basic.Ack(delivery_tag=99, multiple=True))
    await asyncio.sleep(0.2)
    assert ch.closed
    assert ch.close_reason.reply_code == 406


async def test_reject_unknown_tag_is_channel_error(client):
    """Basic.Reject with an unknown tag follows the same RabbitMQ contract
    as Ack/Nack: PRECONDITION_FAILED, not a silent no-op."""
    ch = await client.channel()
    await ch.queue_declare("rej_q")
    client._send_method(ch.id, am.Basic.Reject(delivery_tag=3, requeue=True))
    await asyncio.sleep(0.2)
    assert ch.closed
    assert ch.close_reason.reply_code == 406


async def test_tiny_reads_force_fused_fallback(monkeypatch):
    """Every frame spanning multiple reads must route through the
    assembler fallback of the fused scan loop (connection._consume_scan):
    with 13-byte reads no publish triple is ever contained in one batch,
    and with varied body sizes (0, small, > frame-max) the stateful
    content machine sees every shape. Order and content must survive."""
    from chanamq_tpu_torch.broker.connection import AMQPConnection

    orig = AMQPConnection._read_chunk

    async def tiny_read(self):
        data = await self.reader.read(13)
        if not data:
            return await orig(self)  # raise ConnectionClosed the same way
        self._last_recv = asyncio.get_event_loop().time()
        return data

    monkeypatch.setattr(AMQPConnection, "_read_chunk", tiny_read)
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("tiny_q")
    bodies = [b"", b"x", b"hello world", bytes(range(256)) * 600,  # >128KB
              b"tail-%d" % 7]
    for body in bodies:
        ch.basic_publish(body, routing_key="tiny_q")
    await ch.wait_unconfirmed_below(1, timeout=30)
    got, done = [], asyncio.get_event_loop().create_future()

    def cb(m):
        got.append(m.body)
        ch.basic_ack(m.delivery_tag)
        if len(got) >= len(bodies) and not done.done():
            done.set_result(None)

    await ch.basic_consume("tiny_q", cb)
    await asyncio.wait_for(done, 30)
    assert got == bodies
    await c.close()
    await srv.stop()


async def test_interleaved_channel_content_frames(client):
    """Content frames of two channels interleaved on one connection (legal
    per AMQP §4.2.6 — interleaving is only forbidden WITHIN a channel):
    the fused scan loop must fall back to the per-channel assembler and
    deliver both messages intact."""
    ch1 = await client.channel()
    ch2 = await client.channel()
    await ch1.queue_declare("il_q")
    from chanamq_tpu_torch.amqp.command import AMQCommand

    f1 = AMQCommand(
        ch1.id, am.Basic.Publish(exchange="", routing_key="il_q"),
        body=b"from-ch1").render_frames(client.frame_max)
    f2 = AMQCommand(
        ch2.id, am.Basic.Publish(exchange="", routing_key="il_q"),
        body=b"from-ch2").render_frames(client.frame_max)
    # interleave: m1 m2 h1 h2 b1 b2 — one write so one scan batch sees all
    wire = b"".join(f.to_bytes() for f in
                    (f1[0], f2[0], f1[1], f2[1], f1[2], f2[2]))
    client._write(wire)
    got = []
    for _ in range(100):
        m = await ch1.basic_get("il_q", no_ack=True)
        if m is not None:
            got.append(m.body)
        if len(got) >= 2:
            break
        await asyncio.sleep(0.02)
    assert sorted(got) == [b"from-ch1", b"from-ch2"]


async def test_tiny_negotiated_frame_max_round_trip():
    """frame_max=4096 (near the spec minimum): every large body splits
    into dozens of frames in both directions; reassembly must be exact
    for varied sizes including one spanning ~25 frames."""
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0, frame_max=4096)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    assert c.frame_max == 4096
    ch = await c.channel()
    await ch.confirm_select()
    await ch.queue_declare("frag_q")
    bodies = [bytes([i % 256]) * (4000 + i * 997) for i in range(12)]
    bodies.append(bytes(range(256)) * 400)  # 102400 bytes
    got, done = [], asyncio.get_event_loop().create_future()

    def cb(m):
        got.append(m.body)
        ch.basic_ack(m.delivery_tag)
        if len(got) >= len(bodies) and not done.done():
            done.set_result(None)

    await ch.basic_consume("frag_q", cb)
    for body in bodies:
        ch.basic_publish(body, routing_key="frag_q")
    await ch.wait_unconfirmed_below(1)
    await asyncio.wait_for(done, 30)
    assert got == bodies
    await c.close()
    await srv.stop()


async def test_channel_max_enforced():
    """Opening more channels than the negotiated channel-max is refused
    with a connection error; existing channels keep working."""
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0, channel_max=4)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    chans = [await c.channel() for _ in range(4)]
    with pytest.raises(Exception):
        await c.channel()
    await chans[0].queue_declare("cm_q")
    chans[0].basic_publish(b"ok", routing_key="cm_q")
    m = await chans[0].basic_get("cm_q", no_ack=True)
    assert m is not None and m.body == b"ok"
    await c.close()
    await srv.stop()


async def test_oversized_declared_body_rejected():
    """A content header declaring a body beyond chana.mq.message.max-size
    must close the connection with FRAME_ERROR instead of buffering toward
    it — body chunks accumulate in the assembler BEFORE the memory
    backpressure gauge can see them, so the cap is the only bound
    (reference: FrameParser's message size limit, FrameParser.scala:67-158)."""
    import struct

    def raw_frame(t, ch, payload):
        return struct.pack(">BHI", t, ch, len(payload)) + payload + b"\xce"

    def raw_method(ch, cid, mid, args):
        return raw_frame(1, ch, struct.pack(">HH", cid, mid) + args)

    def sstr(s):
        b = s.encode()
        return bytes([len(b)]) + b

    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0, max_message_size=1024 * 1024)
    await srv.start()
    r, w = await asyncio.open_connection("127.0.0.1", srv.bound_port)
    w.write(b"AMQP\x00\x00\x09\x01")
    await r.read(4096)
    w.write(raw_method(0, 10, 11, struct.pack(">I", 0) + sstr("PLAIN")
                       + struct.pack(">I", 12) + b"\x00guest\x00guest"
                       + sstr("en_US")))
    await r.read(4096)
    w.write(raw_method(0, 10, 31, struct.pack(">HIH", 100, 131072, 0)))
    w.write(raw_method(0, 10, 40, sstr("/") + sstr("") + b"\x00"))
    await r.read(4096)
    w.write(raw_method(1, 20, 10, sstr("")))
    await r.read(4096)
    w.write(raw_method(1, 50, 10, struct.pack(">H", 0) + sstr("capq")
                       + b"\x00" + struct.pack(">I", 0)))
    await r.read(4096)
    # declare a body one byte over the 1 MiB cap
    w.write(raw_method(1, 60, 40, struct.pack(">H", 0) + sstr("")
                       + sstr("capq") + b"\x00")
            + raw_frame(2, 1, struct.pack(">HHQH", 60, 0,
                                          1024 * 1024 + 1, 0)))
    data = await asyncio.wait_for(r.read(4096), 5)
    assert data[7:11] == struct.pack(">HH", 10, 50)  # connection.close
    assert struct.unpack(">H", data[11:13])[0] == 501  # FRAME_ERROR
    w.close()

    # a body under the cap (over frame_max) is untouched
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("okq")
    ch.basic_publish(bytes(400_000), routing_key="okq")
    m = await ch.basic_get("okq", no_ack=True)
    assert m is not None and len(m.body) == 400_000
    await c.close()
    await srv.stop()


async def test_protocol_state_violations_rejected():
    """Out-of-order protocol moves get the spec's connection errors:
    publish before Connection.Open (503), content on an unopened channel
    (504), content frames on channel 0 (505), unknown class (503) — and
    the broker survives all of them."""
    import struct

    def raw_frame(t, ch, payload):
        return struct.pack(">BHI", t, ch, len(payload)) + payload + b"\xce"

    def raw_method(ch, cid, mid, args):
        return raw_frame(1, ch, struct.pack(">HH", cid, mid) + args)

    def sstr(s):
        b = s.encode()
        return bytes([len(b)]) + b

    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    port = srv.bound_port

    async def fresh(do_open=True, open_channel=False):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(b"AMQP\x00\x00\x09\x01")
        await r.read(4096)
        w.write(raw_method(0, 10, 11, struct.pack(">I", 0) + sstr("PLAIN")
                           + struct.pack(">I", 12) + b"\x00guest\x00guest"
                           + sstr("en_US")))
        await r.read(4096)
        w.write(raw_method(0, 10, 31, struct.pack(">HIH", 100, 131072, 0)))
        if do_open:
            w.write(raw_method(0, 10, 40, sstr("/") + sstr("") + b"\x00"))
            await r.read(4096)
        if open_channel:
            w.write(raw_method(1, 20, 10, sstr("")))
            await r.read(4096)
        return r, w

    async def expect_conn_close(r, code):
        data = await asyncio.wait_for(r.read(4096), 5)
        assert data[7:11] == struct.pack(">HH", 10, 50), data[:16].hex()
        assert struct.unpack(">H", data[11:13])[0] == code

    publish = (raw_method(1, 60, 40, struct.pack(">H", 0) + sstr("")
                          + sstr("x") + b"\x00")
               + raw_frame(2, 1, struct.pack(">HHQH", 60, 0, 1, 0))
               + raw_frame(3, 1, b"z"))

    r, w = await fresh(do_open=False)
    w.write(publish)
    await expect_conn_close(r, 503)  # command-invalid before open
    w.close()

    r, w = await fresh()
    w.write(publish)                 # channel 1 never opened
    await expect_conn_close(r, 504)
    w.close()

    r, w = await fresh()
    w.write(raw_frame(2, 0, struct.pack(">HHQH", 60, 0, 1, 0)))
    await expect_conn_close(r, 505)  # content on channel 0
    w.close()

    r, w = await fresh(open_channel=True)
    w.write(raw_method(1, 99, 10, b""))
    await expect_conn_close(r, 503)  # unknown class
    w.close()

    # broker healthy after every violation
    c = await AMQPClient.connect("127.0.0.1", port)
    ch = await c.channel()
    await ch.queue_declare("ps_q")
    ch.basic_publish(b"ok", routing_key="ps_q")
    assert (await ch.basic_get("ps_q", no_ack=True)).body == b"ok"
    await c.close()
    await srv.stop()


async def test_route_cache_invalidates_on_topology_churn(client):
    """The publish route cache must never serve a stale route: rebinding,
    unbinding, queue deletion and redeclaration mid-flow all take effect on
    the very next publish (topology epoch bump)."""
    ch = await client.channel()
    await ch.exchange_declare("rc_ex", "direct")
    await ch.queue_declare("rc_q1")
    await ch.queue_declare("rc_q2")
    await ch.queue_bind("rc_q1", "rc_ex", "k")

    async def get(q):
        for _ in range(50):
            msg = await ch.basic_get(q, no_ack=True)
            if msg is not None:
                return msg
            await asyncio.sleep(0.01)
        return None

    # warm the cache, then churn
    for _ in range(3):
        ch.basic_publish(b"warm", exchange="rc_ex", routing_key="k")
    await ch.queue_unbind("rc_q1", "rc_ex", "k")
    await ch.queue_bind("rc_q2", "rc_ex", "k")
    ch.basic_publish(b"moved", exchange="rc_ex", routing_key="k")
    assert (await get("rc_q2")).body == b"moved"
    await asyncio.sleep(0.05)
    # q1 got only the warmup messages, not the post-churn one
    bodies = []
    while True:
        m = await ch.basic_get("rc_q1", no_ack=True)
        if m is None:
            break
        bodies.append(m.body)
    assert bodies == [b"warm"] * 3

    # queue deletion invalidates a cached resolved-queue reference
    ch.basic_publish(b"pre-delete", exchange="rc_ex", routing_key="k")
    assert (await get("rc_q2")).body == b"pre-delete"
    await ch.queue_delete("rc_q2")
    ch.basic_publish(b"into-void", exchange="rc_ex", routing_key="k")
    await ch.queue_declare("rc_q2")
    await ch.queue_bind("rc_q2", "rc_ex", "k")
    ch.basic_publish(b"reborn", exchange="rc_ex", routing_key="k")
    assert (await get("rc_q2")).body == b"reborn"

    # default-exchange routes churn with queue lifecycle too
    await ch.queue_declare("rc_dq")
    ch.basic_publish(b"d1", routing_key="rc_dq")
    assert (await get("rc_dq")).body == b"d1"
    await ch.queue_delete("rc_dq")
    await ch.queue_declare("rc_dq")
    ch.basic_publish(b"d2", routing_key="rc_dq")
    assert (await get("rc_dq")).body == b"d2"


async def test_live_server_method_fuzz_stays_healthy():
    """Hostile-input hardening at the METHOD layer (the parser/assembler
    fuzz covers the frame layer): a seeded stream of random method frames —
    real class/method ids with garbage args, unknown ids, wrong-state
    methods, random channels — must only ever produce clean protocol
    closes, never a broker crash; after every hostile connection a fresh
    well-behaved client still gets full service."""
    import random
    import struct

    def raw_frame(t, ch, payload):
        return struct.pack(">BHI", t, ch, len(payload)) + payload + b"\xce"

    def raw_method(ch, cid, mid, args):
        return raw_frame(1, ch, struct.pack(">HH", cid, mid) + args)

    rng = random.Random(0xC0FFEE)
    srv = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                       port=0, heartbeat_s=0)
    await srv.start()
    port = srv.bound_port

    real_ids = [(10, 10), (10, 40), (20, 10), (20, 20), (40, 10), (40, 30),
                (50, 10), (50, 20), (60, 40), (60, 80), (60, 70), (85, 10),
                (90, 10), (90, 20), (90, 30), (8, 8), (99, 1), (60, 999)]

    async def hostile_session() -> None:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            writer.write(b"AMQP\x00\x00\x09\x01")
            # read Connection.Start, then skip the proper handshake for most
            # sessions: hostile frames straight into every protocol state
            await asyncio.wait_for(reader.readexactly(7), 5)
            if rng.random() < 0.5:
                # complete a minimal handshake half the time so the fuzz
                # also reaches the post-open dispatch states
                hdr = await asyncio.wait_for(reader.read(65536), 1)
                writer.write(raw_method(0, 10, 11,
                    b"\x00\x00\x00\x00" + b"\x05PLAIN"
                    + struct.pack(">I", 4) + b"\x00u\x00p" + b"\x05en_US"))
                writer.write(raw_method(0, 10, 31,
                    struct.pack(">HIH", 0, 131072, 0)))
                writer.write(raw_method(0, 10, 40, b"\x01/\x00\x00"))
                writer.write(raw_method(1, 20, 10, b"\x00"))
                await asyncio.sleep(0.05)
            for _ in range(30):
                cls, mid = rng.choice(real_ids)
                args = bytes(rng.randrange(256)
                             for _ in range(rng.randrange(0, 40)))
                channel = rng.choice([0, 1, 2, 7])
                ftype = rng.choice([1, 1, 1, 2, 3])
                if ftype == 1:
                    writer.write(raw_method(channel, cls, mid, args))
                else:
                    writer.write(raw_frame(ftype, channel, args))
                if rng.random() < 0.3:
                    await asyncio.sleep(0)
            await writer.drain()
            # server may close on us at any point; drain whatever comes
            try:
                await asyncio.wait_for(reader.read(262144), 0.5)
            except asyncio.TimeoutError:
                pass
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    try:
        for round_no in range(12):
            await hostile_session()
            # the broker shrugs it off: full service for a clean client
            c = await AMQPClient.connect("127.0.0.1", port)
            ch = await c.channel()
            await ch.queue_declare("fuzz_ok")
            ch.basic_publish(b"alive-%d" % round_no, routing_key="fuzz_ok")
            got = None
            for _ in range(50):
                got = await ch.basic_get("fuzz_ok", no_ack=True)
                if got is not None:
                    break
                await asyncio.sleep(0.02)
            assert got is not None and got.body == b"alive-%d" % round_no
            await c.close()
    finally:
        await srv.stop()
