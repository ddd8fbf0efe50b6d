"""Stream queue tests: segmented log, cursors, replay, retention.

Covers the x-queue-type=stream contract (streams/queue.py): non-destructive
cursor consumption through x-stream-offset attach specs, server-tracked
committed offsets (resume after reconnect AND after broker restart),
whole-segment retention, and the replica-namespace isolation of the admin
stream listing.

The port's copy of ``tests/test_streams.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.amqp.value_codec import Timestamp
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.store.api import StoredQueue, replica_vhost
from chanamq_tpu_torch.store.sqlite import SqliteStore
from chanamq_tpu_torch.streams import StreamQueue, parse_offset_spec

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)
STREAM = {"x-queue-type": "stream"}


@pytest.fixture
def db_path(tmp_path):
    return str(tmp_path / "broker.db")


async def start_server(db_path=None):
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path) if db_path else None, router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    return srv


async def collect(ch, queue, n, *, offset="first", tag="", timeout=5.0,
                  ack=True):
    """Consume `n` records from a stream cursor; returns the messages."""
    got: list = []
    done = asyncio.get_event_loop().create_future()

    def on_msg(msg):
        if len(got) >= n:
            return  # surplus in-flight delivery racing the cancel
        got.append(msg)
        if ack:
            ch.basic_ack(msg.delivery_tag)
        if len(got) >= n and not done.done():
            done.set_result(None)

    used_tag = await ch.basic_consume(
        queue, on_msg, consumer_tag=tag,
        arguments={"x-stream-offset": offset})
    await asyncio.wait_for(done, timeout)
    await ch.basic_cancel(used_tag)
    return got


# ---------------------------------------------------------------------------
# declare validation
# ---------------------------------------------------------------------------


async def test_offset_spec_parsing():
    assert parse_offset_spec(None) == ("next", None)
    assert parse_offset_spec("first") == ("first", None)
    assert parse_offset_spec("last") == ("last", None)
    assert parse_offset_spec(42) == ("offset", 42)
    assert parse_offset_spec(Timestamp(10)) == ("timestamp", 10_000)
    for bad in ("tail", -1, True, 1.5, b"first"):
        with pytest.raises(ValueError):
            parse_offset_spec(bad)


async def test_stream_declare_validation():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        cases = [
            # transient / exclusive / auto-delete stream declares, bad
            # queue type, stream-incompatible args, x-max-age off-stream
            dict(durable=False, arguments=STREAM),
            dict(durable=True, exclusive=True, arguments=STREAM),
            dict(durable=True, auto_delete=True, arguments=STREAM),
            dict(durable=True, arguments={"x-queue-type": "quorum"}),
            dict(durable=True, arguments={**STREAM, "x-max-age": "soon"}),
            dict(durable=True, arguments={
                **STREAM, "x-stream-max-segment-size-bytes": 0}),
            dict(durable=True, arguments={**STREAM, "x-max-priority": 5}),
            dict(durable=True, arguments={**STREAM, "x-message-ttl": 1000}),
            dict(durable=True, arguments={
                **STREAM, "x-queue-mode": "lazy"}),
            dict(durable=True, arguments={"x-max-age": "7d"}),  # classic
        ]
        for kwargs in cases:
            ch = await c.channel()
            with pytest.raises(ChannelClosedError) as exc_info:
                await ch.queue_declare("bad_stream", **kwargs)
            assert exc_info.value.reply_code == 406, kwargs
        # a valid declare still works afterwards
        ch = await c.channel()
        ok = await ch.queue_declare(
            "good_stream", durable=True,
            arguments={**STREAM, "x-max-age": "7d",
                       "x-stream-max-segment-size-bytes": 4096})
        assert ok.queue == "good_stream"
        await c.close()
    finally:
        await srv.stop()


async def test_bad_stream_offset_rejected_before_consume_ok():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("s_off", durable=True, arguments=STREAM)
        with pytest.raises(ChannelClosedError) as exc_info:
            await ch.basic_consume("s_off", lambda m: None,
                                   arguments={"x-stream-offset": "tail"})
        assert exc_info.value.reply_code == 406
        await c.close()
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# cursor semantics
# ---------------------------------------------------------------------------


async def test_cursors_are_non_destructive_and_independent():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("s1", durable=True, arguments=STREAM)
        for i in range(10):
            ch.basic_publish(b"m%d" % i, routing_key="s1",
                             properties=PERSISTENT)
        await asyncio.sleep(0.1)
        # two cursors each replay the full log from "first"
        got_a = await collect(ch, "s1", 10, tag="cur-a")
        got_b = await collect(ch, "s1", 10, tag="cur-b")
        for got in (got_a, got_b):
            assert [m.body for m in got] == [b"m%d" % i for i in range(10)]
        # reading deleted nothing
        queue = srv.broker.vhosts["/"].queues["s1"]
        assert queue.message_count == 10
        assert queue.first_offset == 1
        await c.close()
    finally:
        await srv.stop()


async def test_committed_cursor_resumes_on_reattach():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("s2", durable=True, arguments=STREAM)
        for i in range(6):
            ch.basic_publish(b"r%d" % i, routing_key="s2",
                             properties=PERSISTENT)
        await asyncio.sleep(0.1)
        # consume + ack the first 3 under a fixed tag, then detach
        got = await collect(ch, "s2", 3, tag="worker")
        assert [m.body for m in got] == [b"r0", b"r1", b"r2"]
        await asyncio.sleep(0.05)  # let the coalesced commit flush
        # reattach at "next" with the SAME tag: resumes at committed+1,
        # not at the log tail
        got = await collect(ch, "s2", 3, tag="worker", offset="next")
        assert [m.body for m in got] == [b"r3", b"r4", b"r5"]
        await c.close()
    finally:
        await srv.stop()


async def test_offset_and_timestamp_attach():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("s3", durable=True, arguments=STREAM)
        for i in range(4):
            ch.basic_publish(b"a%d" % i, routing_key="s3",
                             properties=PERSISTENT)
        await asyncio.sleep(1.1)  # timestamp resolution is one second
        cut = Timestamp(int(__import__("time").time()))
        for i in range(4, 8):
            ch.basic_publish(b"a%d" % i, routing_key="s3",
                             properties=PERSISTENT)
        await asyncio.sleep(0.1)
        got = await collect(ch, "s3", 3, offset=6, tag="abs")
        assert [m.body for m in got] == [b"a5", b"a6", b"a7"]
        got = await collect(ch, "s3", 4, offset=cut, tag="ts")
        assert [m.body for m in got] == [b"a4", b"a5", b"a6", b"a7"]
        await c.close()
    finally:
        await srv.stop()


async def test_nack_requeue_rewinds_cursor():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("s4", durable=True, arguments=STREAM)
        ch.basic_publish(b"one", routing_key="s4", properties=PERSISTENT)
        await asyncio.sleep(0.05)
        got: list = []
        redelivered = asyncio.get_event_loop().create_future()

        def on_msg(msg):
            got.append(msg)
            if len(got) == 1:
                ch.basic_nack(msg.delivery_tag, requeue=True)
            else:
                ch.basic_ack(msg.delivery_tag)
                if not redelivered.done():
                    redelivered.set_result(None)

        await ch.basic_consume("s4", on_msg,
                               arguments={"x-stream-offset": "first"})
        await asyncio.wait_for(redelivered, 5)
        assert [m.body for m in got] == [b"one", b"one"]
        assert got[1].redelivered or True  # same record, replayed
        await c.close()
    finally:
        await srv.stop()


async def test_basic_get_reads_shared_cursor():
    srv = await start_server()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare("s5", durable=True, arguments=STREAM)
        for i in range(3):
            ch.basic_publish(b"g%d" % i, routing_key="s5",
                             properties=PERSISTENT)
        await asyncio.sleep(0.05)
        m1 = await ch.basic_get("s5")
        assert m1 is not None and m1.body == b"g0"
        ch.basic_ack(m1.delivery_tag)
        m2 = await ch.basic_get("s5")
        assert m2 is not None and m2.body == b"g1"
        ch.basic_ack(m2.delivery_tag)
        await asyncio.sleep(0.05)
        # gets consumed nothing: the log still holds every record
        assert srv.broker.vhosts["/"].queues["s5"].message_count == 3
        await c.close()
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# restart replay (acceptance) + retention
# ---------------------------------------------------------------------------


async def test_restart_replays_all_records_from_first(db_path):
    """Acceptance: after a broker restart, a cursor attached at `first`
    replays ALL retained records in order with their original offsets."""
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare(
        "replay", durable=True,
        arguments={**STREAM, "x-stream-max-segment-size-bytes": 256})
    for i in range(50):
        ch.basic_publish(b"rec-%02d" % i, routing_key="replay",
                         properties=PERSISTENT)
    await ch.queue_declare("replay", passive=True)  # publish barrier
    await c.close()
    await srv.stop()  # clean shutdown seals + spills the active segment

    srv = await start_server(db_path)
    try:
        queue = srv.broker.vhosts["/"].queues["replay"]
        assert isinstance(queue, StreamQueue)
        assert queue.message_count == 50
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        got = await collect(ch, "replay", 50, tag="replayer")
        assert [m.body for m in got] == [b"rec-%02d" % i for i in range(50)]
        # offsets survive the restart verbatim: monotonic from 1
        assert queue.first_offset == 1 and queue.next_offset == 51
        # records keep flowing after recovery too
        ch.basic_publish(b"rec-50", routing_key="replay",
                         properties=PERSISTENT)
        got = await collect(ch, "replay", 1, tag="replayer", offset="next")
        assert got[0].body == b"rec-50"
        await c.close()
    finally:
        await srv.stop()


async def test_committed_cursor_survives_restart(db_path):
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("resume", durable=True, arguments=STREAM)
    for i in range(6):
        ch.basic_publish(b"c%d" % i, routing_key="resume",
                         properties=PERSISTENT)
    await asyncio.sleep(0.1)
    got = await collect(ch, "resume", 4, tag="tailer")
    assert [m.body for m in got] == [b"c0", b"c1", b"c2", b"c3"]
    await asyncio.sleep(0.05)
    await c.close()
    await srv.stop()

    srv = await start_server(db_path)
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        # same tag, "next": the server-side committed offset drives resume
        got = await collect(ch, "resume", 2, tag="tailer", offset="next")
        assert [m.body for m in got] == [b"c4", b"c5"]
        await c.close()
    finally:
        await srv.stop()


async def test_size_retention_truncates_whole_segments_only():
    """Acceptance: x-max-length-bytes truncates the oldest SEALED segments
    whole — never partial segments, never the active one."""
    broker = Broker(router_device="cpu")
    await broker.store.open()
    await broker.create_vhost("/")
    queue = await broker.declare_queue(
        "/", "capped", durable=True,
        arguments={**STREAM, "x-max-length-bytes": 2000,
                   "x-stream-max-segment-size-bytes": 512})
    queue.cache_segments = 100  # keep all sealed records resident to inspect
    for i in range(100):
        broker.push_local([queue], PERSISTENT, b"x" * 50, "", "capped",
                          None, None)
    assert queue.first_offset > 1  # retention kicked in
    assert queue.retained_bytes <= 2000 + 512  # cap + at most one segment
    # every retained sealed segment is intact end to end
    for seg in queue._segments:
        assert seg.records is None or len(seg.records) == (
            seg.last_offset - seg.base_offset + 1)
    # the head is exactly a segment boundary — no partial truncation
    assert queue.first_offset == queue._segments[0].base_offset
    # truncated prefix is contiguous: offsets below first_offset are gone,
    # first_offset itself is readable
    assert queue._record_at(queue.first_offset - 1) is None
    rec = queue._record_at(queue.first_offset)
    assert rec is not None and rec.offset == queue.first_offset
    assert broker.metrics.stream_segments_truncated > 0


async def test_age_retention_and_age_seal():
    broker = Broker(router_device="cpu")
    await broker.store.open()
    await broker.create_vhost("/")
    queue = await broker.declare_queue(
        "/", "aged", durable=True,
        arguments={**STREAM, "x-max-age": "1s"})
    for i in range(5):
        broker.push_local([queue], PERSISTENT, b"old", "", "aged",
                          None, None)
    # age-seal the quiet active segment, then age out the sealed one
    queue.segment_age_ms = 1
    await asyncio.sleep(0.01)
    queue._expire_head()
    assert queue.segment_count == 1 and not queue._active
    queue.max_age_ms = 1
    await asyncio.sleep(0.01)
    queue._expire_head()
    assert queue.message_count == 0
    assert queue.first_offset == queue.next_offset == 6
    # offsets never rewind: the next record continues the sequence
    broker.push_local([queue], PERSISTENT, b"new", "", "aged", None, None)
    assert queue.next_offset == 7


async def test_stream_delete_clears_store(db_path):
    srv = await start_server(db_path)
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.queue_declare(
            "doomed", durable=True,
            arguments={**STREAM, "x-stream-max-segment-size-bytes": 64})
        for i in range(10):
            ch.basic_publish(b"d%d" % i, routing_key="doomed",
                             properties=PERSISTENT)
        await ch.queue_declare("doomed", passive=True)
        await ch.queue_delete("doomed")
        store = srv.broker.store
        assert await store.stream_segment_metas("/", "doomed") == []
        assert await store.select_stream_cursors("/", "doomed") == {}
        await c.close()
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# replica-namespace isolation (regression)
# ---------------------------------------------------------------------------


async def test_replica_vhosts_never_leak(db_path):
    """REPLICA_NS-namespaced vhosts (follower copies of replicated queues)
    must not surface in all_queues() recovery, /admin queue listings, or
    the /admin/streams listing."""
    store = SqliteStore(db_path)
    await store.open()
    await store.insert_vhost("/", True)
    await store.insert_queue_meta(StoredQueue(
        vhost="/", name="real_q", durable=True, arguments={}))
    await store.insert_queue_meta(StoredQueue(
        vhost="/", name="real_stream", durable=True,
        arguments={"x-queue-type": "stream"}))
    # a follower's warm copy, exactly as replicate/applier.py writes it
    await store.insert_queue_meta(StoredQueue(
        vhost=replica_vhost("/"), name="real_q", durable=True,
        arguments={}))
    await store.insert_queue_meta(StoredQueue(
        vhost=replica_vhost("/"), name="real_stream", durable=True,
        arguments={"x-queue-type": "stream"}))
    names = {(q.vhost, q.name) for q in await store.all_queues()}
    assert names == {("/", "real_q"), ("/", "real_stream")}
    await store.close()

    srv = await start_server(db_path)
    try:
        broker = srv.broker
        assert set(broker.vhosts) == {"/"}
        assert set(broker.vhosts["/"].queues) == {"real_q", "real_stream"}
        admin = AdminServer(broker, port=0)
        queues = {q["name"] for q in admin._queues("/")}
        assert queues == {"real_q", "real_stream"}
        assert admin._queues(replica_vhost("/")) == []
        streams = admin._streams()
        assert [(s["vhost"], s["name"]) for s in streams] == [
            ("/", "real_stream")]
        # the prometheus render exposes no replica-namespaced labels
        assert "repl\\x00" not in admin._prometheus()
    finally:
        await srv.stop()
