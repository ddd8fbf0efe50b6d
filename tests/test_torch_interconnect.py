"""Cluster interconnect fast-path tests: binary codec roundtrips, data
stream request/response, frame_too_large resync, reconnect backoff,
per-call timeouts, push_many partial failure, and settle-batching ordering
vs. redelivery (zero loss / zero duplication in ack mode).

The port's copy of ``tests/test_interconnect.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster import dataplane as dp
from chanamq_tpu_torch.cluster.rpc import (
    KIND_DREQUEST,
    MAX_FRAME,
    RpcClient,
    RpcError,
    RpcServer,
    RpcTimeout,
    encode_data_frame,
)

from test_torch_cluster_broker import owner_and_other, start_cluster

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

async def test_push_many_codec_roundtrip_zero_copy():
    props = PERSISTENT.encode_header(5)
    parts = []
    parts.extend(dp.encode_push_record(
        "/", ["q1", "q2"], "ex", "rk", props, b"body1"))
    parts.extend(dp.encode_push_record(
        "vh", ["q3"], "", "q3", props, b"body2xx"))
    frame = b"".join([dp._U32.pack(2), *parts])
    view = memoryview(frame)
    records = list(dp.decode_push_many(view))
    assert len(records) == 2
    vhost, queues, exchange, rk, props_v, body_v = records[0]
    assert (vhost, queues, exchange, rk) == ("/", ["q1", "q2"], "ex", "rk")
    assert bytes(props_v) == props
    assert bytes(body_v) == b"body1"
    # zero-copy: the body view slices the frame buffer, no new bytes object
    assert isinstance(body_v, memoryview) and body_v.obj is frame
    vhost, queues, exchange, rk, props_v, body_v = records[1]
    assert (vhost, queues, exchange, rk) == ("vh", ["q3"], "", "q3")
    assert bytes(body_v) == b"body2xx"


async def test_settle_many_codec_roundtrip():
    entries = [
        ("/", "qa", "ack", "tag1", 3, [1, 2, 3]),
        ("/", "qb", "requeue", "", 0, [10]),
        ("vh", "qc", "drop", "tag2", 1, []),
    ]
    frame = b"".join([dp._U32.pack(len(entries))] + [
        dp.encode_settle_entry(*e) for e in entries])
    assert list(dp.decode_settle_many(memoryview(frame))) == [
        (v, q, op, t, c, o) for v, q, op, t, c, o in entries]


async def test_deliver_many_codec_roundtrip():
    props = BasicProperties().encode_header(3)
    records = []
    records.extend(dp.encode_deliver_record(
        7, True, 1234, 999_000, "ex", "rk", props, b"abc"))
    records.extend(dp.encode_deliver_record(
        8, False, 1235, None, "", "q", props, b""))
    frame = b"".join(
        [dp.encode_deliver_head("/", "dq", "ctag", 2), *records])
    vhost, queue, tag, it = dp.decode_deliver_many(memoryview(frame))
    assert (vhost, queue, tag) == ("/", "dq", "ctag")
    decoded = list(it)
    off, redel, mid, exp, ex, rk, props_v, body_v = decoded[0]
    assert (off, redel, mid, exp, ex, rk) == (7, True, 1234, 999_000, "ex", "rk")
    assert bytes(body_v) == b"abc" and bytes(props_v) == props
    off, redel, mid, exp, ex, rk, props_v, body_v = decoded[1]
    assert (off, redel, mid, exp, ex, rk) == (8, False, 1235, None, "", "q")
    assert bytes(body_v) == b""


# ---------------------------------------------------------------------------
# data stream + rpc hardening
# ---------------------------------------------------------------------------

async def test_data_stream_request_roundtrip_and_remote_error():
    server = RpcServer("127.0.0.1", 0)

    async def echo(view):
        return [b"echo:", bytes(view)]

    async def boom(view):
        raise RpcError("nope", "handler refused")

    server.register_binary(1, echo)
    server.register_binary(2, boom)
    await server.start()
    stream = dp.DataStream("127.0.0.1", server.bound_port)
    try:
        reply = await stream.request(1, [b"pay", b"load"])
        assert bytes(reply) == b"echo:payload"
        with pytest.raises(RpcError) as err:
            await stream.request(2, [b"x"])
        assert "handler refused" in str(err.value)
        # the error reply leaves the stream usable (no reconnect needed)
        assert bytes(await stream.request(1, [b"ok"])) == b"echo:ok"
    finally:
        await stream.close()
        await server.stop()


async def test_frame_too_large_closes_connection_then_recovers():
    server = RpcServer("127.0.0.1", 0)

    async def ping(payload):
        return {"pong": True}

    server.register("ping", ping)
    await server.start()
    try:
        # a raw peer announces an impossible frame: the server must drop
        # the connection (the stream can't be re-synced mid-frame)
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", server.bound_port)
        import struct
        writer.write(struct.pack(">I", MAX_FRAME + 1))
        await writer.drain()
        assert await reader.read(64) == b""  # server closed on us
        writer.close()
        # the listener itself survives: a well-behaved client still works
        client = RpcClient("127.0.0.1", server.bound_port)
        assert (await client.call("ping", {}))["pong"] is True
        await client.close()
    finally:
        await server.stop()


async def test_client_per_call_timeout():
    server = RpcServer("127.0.0.1", 0)

    async def slow(payload):
        await asyncio.sleep(30)
        return {}

    server.register("slow", slow)
    await server.start()
    client = RpcClient("127.0.0.1", server.bound_port, timeout_s=30)
    try:
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        with pytest.raises(RpcTimeout):
            await client.call("slow", {}, timeout_s=0.2)
        assert loop.time() - t0 < 5  # per-call override, not the 30s default
    finally:
        await client.close()
        await server.stop()


async def test_reconnect_backoff_fails_fast():
    # grab a port with nothing listening on it
    probe = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
    dead_port = probe.sockets[0].getsockname()[1]
    probe.close()
    await probe.wait_closed()

    client = RpcClient("127.0.0.1", dead_port, connect_timeout_s=0.5)
    with pytest.raises((RpcError, OSError)):
        await client.call("anything", {}, timeout_s=1)
    # backoff armed: the next attempt fails immediately, no dial
    loop = asyncio.get_event_loop()
    t0 = loop.time()
    with pytest.raises(RpcError) as err:
        await client.call("anything", {}, timeout_s=1)
    assert err.value.code == "backoff"
    assert loop.time() - t0 < 0.05
    await client.close()


# ---------------------------------------------------------------------------
# cluster-level contracts
# ---------------------------------------------------------------------------

async def test_push_many_partial_failure_keeps_rest(tmp_path):
    """One missing queue inside a data-plane batch must not drop or
    duplicate the other pushes riding the same micro-batch."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        owner, other = owner_and_other(nodes, "/", "pf_ok")
        client = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await client.channel()
        await ch.queue_declare("pf_ok", durable=True)

        props = PERSISTENT.encode_header(2)
        records = [
            (owner.name, ("/", ["pf_ok"], "", "pf_ok", props, b"m1")),
            # routed to a queue nobody ever declared: skipped on the owner
            (owner.name, ("/", ["pf_gone"], "", "pf_gone", props, b"mX")),
            (owner.name, ("/", ["pf_ok"], "", "pf_ok", props, b"m2")),
        ]
        failures = await other.cluster.push_batch(records)
        assert failures == []
        await asyncio.sleep(0.2)
        queue = owner.server.broker.vhosts["/"].queues["pf_ok"]
        assert [bytes(qm.message.body) for qm in queue.messages] == [b"m1", b"m2"]
        await client.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_settle_batch_ordering_vs_redelivery(tmp_path):
    """Acks buffered in the settle window must be applied on the owner
    before a consumer cancel requeues outstanding deliveries: the acked
    half never redelivers, the unacked half redelivers exactly once."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        owner, other = owner_and_other(nodes, "/", "sb_q")
        client = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await client.channel()
        await ch.queue_declare("sb_q", durable=True)
        for i in range(10):
            ch.basic_publish(f"sb{i}".encode(), routing_key="sb_q",
                             properties=PERSISTENT)

        got = []
        done = asyncio.get_event_loop().create_future()

        def on_msg(msg):
            got.append(msg)
            if len(got) == 10 and not done.done():
                done.set_result(None)

        tag = await ch.basic_consume("sb_q", on_msg)
        await asyncio.wait_for(done, 10)
        assert [m.body for m in got] == [f"sb{i}".encode() for i in range(10)]
        # ack the first half, then cancel in the SAME breath: the cancel's
        # control RPC must fence behind the buffered settle batch
        for msg in got[:5]:
            ch.basic_ack(msg.delivery_tag)
        await ch.basic_cancel(tag)
        await asyncio.sleep(0.5)

        queue = owner.server.broker.vhosts["/"].queues["sb_q"]
        assert len(queue.outstanding) == 0
        bodies = sorted(bytes(qm.message.body) for qm in queue.messages)
        # exactly the unacked half, once each — no loss, no duplication
        assert bodies == sorted(f"sb{i}".encode() for i in range(5, 10))
        assert all(qm.redelivered for qm in queue.messages)
        await client.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_interconnect_counters_and_admin_stats(tmp_path):
    nodes = await start_cluster(tmp_path, 2)
    try:
        owner, other = owner_and_other(nodes, "/", "ic_q")
        client = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await client.channel()
        await ch.queue_declare("ic_q")
        for i in range(50):
            ch.basic_publish(f"ic{i}".encode(), routing_key="ic_q")
        await asyncio.sleep(0.5)
        m_other = other.server.broker.metrics
        m_owner = owner.server.broker.metrics
        assert m_other.rpc_push_records == 50
        # micro-batching: far fewer batches than records
        assert 0 < m_other.rpc_push_batches < 50
        assert m_other.rpc_data_bytes_sent > 0
        assert m_owner.rpc_data_bytes_recv > 0
        plane = other.cluster.dataplane(owner.name)
        stats = plane.stats()
        assert stats["streams"] >= 1
        assert stats["buffered_push_records"] == 0  # all flushed
        await client.close()
    finally:
        for node in nodes:
            await node.stop()
