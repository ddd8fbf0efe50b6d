"""Exchange-to-exchange bindings (exchange.bind / exchange.unbind).

EXCEEDS the reference, which stubs Exchange.Bind/Unbind with TODO logs
(chana-mq-server .../engine/FrameStage.scala:1023-1027). Semantics follow
RabbitMQ's e2e extension: messages accepted by the source exchange flow to
bound destination exchanges, each hop re-matching the ORIGINAL routing
key/headers; the traversal is cycle-safe and a queue reachable via multiple
paths receives exactly one copy.

The port's copy of ``tests/test_exchange_bind.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio

import pytest

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


async def drain(ch, queue, n, timeout=2.0):
    out = []
    deadline = asyncio.get_event_loop().time() + timeout
    while len(out) < n and asyncio.get_event_loop().time() < deadline:
        msg = await ch.basic_get(queue, no_ack=True)
        if msg is None:
            await asyncio.sleep(0.02)
            continue
        out.append(msg)
    return out


async def test_capability_advertised(client):
    caps = client.server_properties["capabilities"]
    assert caps["exchange_exchange_bindings"] is True


async def test_direct_to_fanout_chain(client):
    ch = await client.channel()
    await ch.exchange_declare("src", "direct")
    await ch.exchange_declare("fan", "fanout")
    await ch.queue_declare("q_src")
    await ch.queue_declare("q_fan1")
    await ch.queue_declare("q_fan2")
    await ch.queue_bind("q_src", "src", "k")
    await ch.queue_bind("q_fan1", "fan", "")
    await ch.queue_bind("q_fan2", "fan", "")
    await ch.exchange_bind("fan", "src", "k")

    ch.basic_publish(b"hop", exchange="src", routing_key="k")
    assert [m.body for m in await drain(ch, "q_src", 1)] == [b"hop"]
    assert [m.body for m in await drain(ch, "q_fan1", 1)] == [b"hop"]
    assert [m.body for m in await drain(ch, "q_fan2", 1)] == [b"hop"]

    # a key the binding doesn't cover goes nowhere downstream
    ch.basic_publish(b"miss", exchange="src", routing_key="other")
    await asyncio.sleep(0.05)
    assert await ch.basic_get("q_fan1", no_ack=True) is None


async def test_queue_reached_via_two_paths_gets_one_copy(client):
    ch = await client.channel()
    await ch.exchange_declare("top", "fanout")
    await ch.exchange_declare("mid_a", "fanout")
    await ch.exchange_declare("mid_b", "fanout")
    await ch.queue_declare("q_diamond")
    await ch.exchange_bind("mid_a", "top", "")
    await ch.exchange_bind("mid_b", "top", "")
    await ch.queue_bind("q_diamond", "mid_a", "")
    await ch.queue_bind("q_diamond", "mid_b", "")

    ch.basic_publish(b"once", exchange="top", routing_key="")
    got = await drain(ch, "q_diamond", 1)
    assert [m.body for m in got] == [b"once"]
    await asyncio.sleep(0.05)
    assert await ch.basic_get("q_diamond", no_ack=True) is None


async def test_cycle_is_refused(client):
    """A bind that would close a directed cycle is refused at declare
    time with 406 PRECONDITION_FAILED (semantics/graph.py): the runtime
    walk is cycle-safe, but a cyclic graph blocks closure flattening and
    is almost certainly a client bug. The refusal must leave the
    existing acyclic binding fully functional."""
    ch = await client.channel()
    await ch.exchange_declare("loop_a", "fanout")
    await ch.exchange_declare("loop_b", "fanout")
    await ch.queue_declare("q_a")
    await ch.queue_declare("q_b")
    await ch.exchange_bind("loop_b", "loop_a", "")
    with pytest.raises(ChannelClosedError) as exc:
        await ch.exchange_bind("loop_a", "loop_b", "")  # closes the cycle
    assert "406" in str(exc.value)

    # the refusing channel closed; the surviving topology still routes
    ch2 = await client.channel()
    await ch2.queue_bind("q_a", "loop_a", "")
    await ch2.queue_bind("q_b", "loop_b", "")
    ch2.basic_publish(b"ring", exchange="loop_a", routing_key="")
    assert [m.body for m in await drain(ch2, "q_a", 1)] == [b"ring"]
    assert [m.body for m in await drain(ch2, "q_b", 1)] == [b"ring"]


async def test_self_bind_is_refused(client):
    ch = await client.channel()
    await ch.exchange_declare("self_x", "fanout")
    with pytest.raises(ChannelClosedError) as exc:
        await ch.exchange_bind("self_x", "self_x", "")
    assert "406" in str(exc.value)


async def test_unbind_stops_flow(client):
    ch = await client.channel()
    await ch.exchange_declare("u_src", "fanout")
    await ch.exchange_declare("u_dst", "fanout")
    await ch.queue_declare("q_u")
    await ch.exchange_bind("u_dst", "u_src", "")
    await ch.queue_bind("q_u", "u_dst", "")
    ch.basic_publish(b"before", exchange="u_src", routing_key="")
    assert [m.body for m in await drain(ch, "q_u", 1)] == [b"before"]
    await ch.exchange_unbind("u_dst", "u_src", "")
    ch.basic_publish(b"after", exchange="u_src", routing_key="")
    await asyncio.sleep(0.05)
    assert await ch.basic_get("q_u", no_ack=True) is None


async def test_deleting_destination_removes_binding(client):
    ch = await client.channel()
    await ch.exchange_declare("d_src", "fanout")
    await ch.exchange_declare("d_dst", "fanout")
    await ch.queue_declare("q_d")
    await ch.exchange_bind("d_dst", "d_src", "")
    await ch.queue_bind("q_d", "d_dst", "")
    await ch.exchange_delete("d_dst")
    # the source's e2e binding is swept: publish routes nowhere, no crash
    ch.basic_publish(b"orphan", exchange="d_src", routing_key="")
    await asyncio.sleep(0.05)
    srv_ex = None
    # and an if_unused delete of the source now succeeds
    await ch.exchange_delete("d_src", if_unused=True)
    assert srv_ex is None


async def test_if_unused_counts_e2e_bindings(client):
    ch = await client.channel()
    await ch.exchange_declare("iu_src", "fanout")
    await ch.exchange_declare("iu_dst", "fanout")
    await ch.exchange_bind("iu_dst", "iu_src", "")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.exchange_delete("iu_src", if_unused=True)
    assert exc_info.value.reply_code == 406


async def test_default_exchange_refused(client):
    ch = await client.channel()
    await ch.exchange_declare("any_ex", "fanout")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.exchange_bind("any_ex", "", "k")
    assert exc_info.value.reply_code == 403
    ch2 = await client.channel()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch2.exchange_bind("", "any_ex", "k")
    assert exc_info.value.reply_code == 403


async def test_bind_to_missing_exchange_is_404(client):
    ch = await client.channel()
    await ch.exchange_declare("only_src", "fanout")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.exchange_bind("ghost", "only_src", "")
    assert exc_info.value.reply_code == 404


async def test_internal_exchange_reachable_only_via_e2e(client):
    ch = await client.channel()
    await ch.exchange_declare("front", "fanout")
    await ch.exchange_declare("inner", "fanout", internal=True)
    await ch.queue_declare("q_inner")
    await ch.exchange_bind("inner", "front", "")
    await ch.queue_bind("q_inner", "inner", "")
    # direct publish to the internal exchange is refused
    ch.basic_publish(b"nope", exchange="inner", routing_key="")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.queue_declare("q_inner", passive=True)  # forces the error out
    assert exc_info.value.reply_code == 403
    # but the e2e hop delivers
    ch2 = await client.channel()
    ch2.basic_publish(b"via-front", exchange="front", routing_key="")
    got = await drain(ch2, "q_inner", 1)
    assert [m.body for m in got] == [b"via-front"]


async def test_topic_source_wildcards_apply_per_hop(client):
    ch = await client.channel()
    await ch.exchange_declare("t_src", "topic")
    await ch.exchange_declare("t_dst", "topic")
    await ch.queue_declare("q_t")
    await ch.exchange_bind("t_dst", "t_src", "stock.#")
    await ch.queue_bind("q_t", "t_dst", "stock.*.nyse")
    ch.basic_publish(b"m1", exchange="t_src", routing_key="stock.ibm.nyse")
    assert [m.body for m in await drain(ch, "q_t", 1)] == [b"m1"]
    # passes the first hop but not the second
    ch.basic_publish(b"m2", exchange="t_src", routing_key="stock.ibm.nasdaq")
    await asyncio.sleep(0.05)
    assert await ch.basic_get("q_t", no_ack=True) is None


async def test_auto_delete_source_survives_queue_delete_with_live_e2e_bind(client):
    """Deleting the last bound queue must NOT auto-delete a source exchange
    that still has a live e2e binding (is_unused covers both matchers on
    the queue-delete sweep too)."""
    ch = await client.channel()
    await ch.exchange_declare("ad_src", "fanout", auto_delete=True)
    await ch.exchange_declare("ad_dst", "fanout")
    await ch.queue_declare("q_ad")
    await ch.queue_declare("q_downstream")
    await ch.queue_bind("q_ad", "ad_src", "")
    await ch.exchange_bind("ad_dst", "ad_src", "")
    await ch.queue_bind("q_downstream", "ad_dst", "")
    await ch.queue_delete("q_ad")
    # the source is still alive and still routes through the e2e hop
    ch.basic_publish(b"alive", exchange="ad_src", routing_key="")
    got = await drain(ch, "q_downstream", 1)
    assert [m.body for m in got] == [b"alive"]


async def test_durable_e2e_binding_survives_restart(tmp_path):
    db_path = str(tmp_path / "exbind.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.exchange_declare("p_src", "direct", durable=True)
    await ch.exchange_declare("p_dst", "fanout", durable=True)
    await ch.queue_declare("q_p", durable=True)
    await ch.exchange_bind("p_dst", "p_src", "k")
    await ch.queue_bind("q_p", "p_dst", "")
    await c.close()
    await srv.stop()

    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ch2.basic_publish(b"revived", exchange="p_src", routing_key="k")
        got = await drain(ch2, "q_p", 1)
        assert [m.body for m in got] == [b"revived"]
        await c2.close()
    finally:
        await srv2.stop()


# -- alternate exchanges ----------------------------------------------------


async def test_alternate_exchange_catches_unroutable(client):
    ch = await client.channel()
    await ch.exchange_declare("ae_unrouted", "fanout")
    await ch.queue_declare("q_unrouted")
    await ch.queue_bind("q_unrouted", "ae_unrouted", "")
    await ch.exchange_declare("ae_main", "direct", arguments={
        "alternate-exchange": "ae_unrouted"})
    await ch.queue_declare("q_known")
    await ch.queue_bind("q_known", "ae_main", "known")

    ch.basic_publish(b"hit", exchange="ae_main", routing_key="known")
    ch.basic_publish(b"miss", exchange="ae_main", routing_key="other")
    assert [m.body for m in await drain(ch, "q_known", 1)] == [b"hit"]
    assert [m.body for m in await drain(ch, "q_unrouted", 1)] == [b"miss"]
    # the matched message did NOT also go to the alternate
    await asyncio.sleep(0.05)
    assert await ch.basic_get("q_unrouted", no_ack=True) is None


async def test_alternate_exchange_cycle_safe(client):
    ch = await client.channel()
    await ch.exchange_declare("ae_a", "direct",
                              arguments={"alternate-exchange": "ae_b"})
    await ch.exchange_declare("ae_b", "direct",
                              arguments={"alternate-exchange": "ae_a"})
    ch.basic_publish(b"nowhere", exchange="ae_a", routing_key="k")
    await asyncio.sleep(0.05)  # no hang, no crash
    ch2 = await client.channel()
    await ch2.queue_declare("ae_alive")
    ch2.basic_publish(b"ok", routing_key="ae_alive")
    assert (await drain(ch2, "ae_alive", 1))[0].body == b"ok"


async def test_alternate_exchange_suppresses_mandatory_return(client):
    """A message the alternate exchange routes counts as routed: no
    Basic.Return even with mandatory set (RabbitMQ semantics)."""
    ch = await client.channel()
    await ch.exchange_declare("ae_sink", "fanout")
    await ch.queue_declare("q_sink")
    await ch.queue_bind("q_sink", "ae_sink", "")
    await ch.exchange_declare("ae_mand", "direct", arguments={
        "alternate-exchange": "ae_sink"})
    ch.basic_publish(b"saved", exchange="ae_mand", routing_key="nope",
                     mandatory=True)
    assert [m.body for m in await drain(ch, "q_sink", 1)] == [b"saved"]
    await asyncio.sleep(0.05)
    assert ch.returns == []
    # but with no AE target bound, mandatory still returns
    await ch.queue_unbind("q_sink", "ae_sink", "")
    ch.basic_publish(b"lost", exchange="ae_mand", routing_key="nope",
                     mandatory=True)
    await asyncio.sleep(0.1)
    assert len(ch.returns) == 1 and ch.returns[0].reply_code == 312


async def test_alternate_exchange_survives_restart(tmp_path):
    db_path = str(tmp_path / "ae.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    try:
        c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
        ch = await c.channel()
        await ch.exchange_declare("ae_p_sink", "fanout", durable=True)
        await ch.queue_declare("q_p_sink", durable=True)
        await ch.queue_bind("q_p_sink", "ae_p_sink", "")
        await ch.exchange_declare("ae_p", "direct", durable=True, arguments={
            "alternate-exchange": "ae_p_sink"})
        await c.close()
    finally:
        await srv.stop()
    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ch2.basic_publish(b"after-restart", exchange="ae_p",
                          routing_key="unbound")
        got = await drain(ch2, "q_p_sink", 1)
        assert [m.body for m in got] == [b"after-restart"]
        await c2.close()
    finally:
        await srv2.stop()


async def test_alternate_exchange_inequivalent_redeclare_rejected(client):
    """Redeclaring with a different (or newly added) alternate-exchange is
    a 406, never a silent no-op the client mistakes for an active AE."""
    ch = await client.channel()
    await ch.exchange_declare("ae_eq", "direct")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.exchange_declare("ae_eq", "direct", arguments={
            "alternate-exchange": "somewhere"})
    assert exc_info.value.reply_code == 406
    # same settings redeclare still fine
    ch2 = await client.channel()
    await ch2.exchange_declare("ae_eq", "direct")
