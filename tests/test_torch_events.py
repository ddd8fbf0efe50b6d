"""Event bus + firehose: system-exchange lifecycle, O(1) unbound drops,
end-to-end consumption of internal events, firehose ordering/recursion
exclusions and flow-stage shedding, and cross-run determinism mod ts.

Module-gate hygiene: every test that installs the bus/firehose clears the
``events`` globals in a finally block — leaked gates would tap unrelated
tests' traffic.

The port's copy of ``tests/test_events.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import json
from types import SimpleNamespace

import pytest

from chanamq_tpu_torch import events
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError
from chanamq_tpu_torch.events import EVENT_EXCHANGE, TRACE_EXCHANGE, EventBus, Firehose
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.broker.broker import Broker

pytestmark = pytest.mark.asyncio


async def _server():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    return server


async def http_req(port: int, path: str) -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 20), 5)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(body) if body else {}


# ---------------------------------------------------------------------------
# system exchanges: predeclared, reserved
# ---------------------------------------------------------------------------


async def test_system_exchanges_predeclared_and_reserved():
    server = await _server()
    try:
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)

        # both system exchanges exist on the default vhost (passive ok)
        ch = await c.channel()
        await ch.exchange_declare(EVENT_EXCHANGE, passive=True)
        await ch.exchange_declare(TRACE_EXCHANGE, passive=True)

        # clients cannot (re)declare them: access-refused, channel closed
        with pytest.raises(ChannelClosedError) as exc:
            await ch.exchange_declare(EVENT_EXCHANGE, "topic")
        assert exc.value.reply_code == 403

        # ...nor delete them
        ch2 = await c.channel()
        with pytest.raises(ChannelClosedError) as exc:
            await ch2.exchange_delete(EVENT_EXCHANGE)
        assert exc.value.reply_code == 403
        ch3 = await c.channel()
        with pytest.raises(ChannelClosedError) as exc:
            await ch3.exchange_delete(TRACE_EXCHANGE)
        assert exc.value.reply_code == 403

        # but binding to them is ordinary Queue.Bind
        ch4 = await c.channel()
        await ch4.queue_declare("evq")
        await ch4.queue_bind("evq", EVENT_EXCHANGE, "alert.#")
        await c.close()
    finally:
        await server.stop()


# ---------------------------------------------------------------------------
# emission: O(1) drop unbound, envelope, end-to-end consume
# ---------------------------------------------------------------------------


async def test_emit_with_nothing_bound_is_o1_drop():
    server = await _server()
    try:
        broker = server.broker
        bus = EventBus(broker)
        m = broker.metrics
        before_pub = m.events_published_total
        assert bus.emit("alert.fired.x", {"rule": "x"}) is False
        assert m.events_dropped_total == 1
        assert m.events_published_total == before_pub
        # no message was built: seq never advanced, no queue grew
        assert bus.seq == 0
        assert broker.queue_depth == 0
    finally:
        await server.stop()


async def test_event_consume_end_to_end_envelope_wins():
    server = await _server()
    try:
        bus = EventBus(server.broker)
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("evq")
        await ch.queue_bind("evq", EVENT_EXCHANGE, "alert.#")
        got: list = []
        done = asyncio.Event()

        def on_msg(msg):
            got.append(msg)
            done.set()

        await ch.basic_consume("evq", on_msg, no_ack=True)

        # the alert payload carries its own "event" key ("fired") — the
        # envelope's routing-key stamp must win
        assert bus.emit("alert.fired.deep",
                        {"event": "fired", "rule": "deep"}) is True
        await asyncio.wait_for(done.wait(), 5)
        msg = got[0]
        assert msg.exchange == EVENT_EXCHANGE
        assert msg.routing_key == "alert.fired.deep"
        assert msg.properties.content_type == "application/json"
        assert msg.properties.app_id == "chanamq.events"
        body = json.loads(msg.body)
        assert body["event"] == "alert.fired.deep"
        assert body["rule"] == "deep"
        assert body["seq"] == 1 and body["node"] == "local"
        assert "ts" in body

        # a key outside the binding is dropped, not queued
        dropped_before = server.broker.metrics.events_dropped_total
        assert bus.emit("control.decision.scale", {"kind": "scale"}) is False
        assert server.broker.metrics.events_dropped_total == dropped_before + 1
        await c.close()
    finally:
        await server.stop()


async def test_queue_lifecycle_events_through_installed_bus():
    server = await _server()
    try:
        events.install(EventBus(server.broker))
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("sink")
        await ch.queue_bind("sink", EVENT_EXCHANGE, "queue.#")
        got: list = []

        def on_msg(msg):
            got.append(json.loads(msg.body))

        await ch.basic_consume("sink", on_msg, no_ack=True)
        await ch.queue_declare("watched", durable=True)
        await ch.queue_delete("watched")
        await asyncio.sleep(0.2)
        kinds = [(e["event"], e["queue"]) for e in got]
        assert ("queue.declared", "watched") in kinds
        assert ("queue.deleted", "watched") in kinds
        declared = next(e for e in got if e["event"] == "queue.declared"
                        and e["queue"] == "watched")
        assert declared["durable"] is True and declared["vhost"] == "/"
        await c.close()
    finally:
        events.clear()
        await server.stop()


# ---------------------------------------------------------------------------
# firehose: ordering, recursion exclusion, stage shedding
# ---------------------------------------------------------------------------


async def test_firehose_preserves_confirms_and_never_taps_itself():
    server = await _server()
    try:
        broker = server.broker
        events.install(None, Firehose(broker))
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("wq")
        await ch.queue_declare("tap")
        await ch.queue_bind("tap", TRACE_EXCHANGE, "#")

        # confirm ordering: N publishes through the tapped path must
        # confirm in publish order
        pub = await c.channel()
        await pub.confirm_select()
        order: list = []
        for i in range(20):
            seq = pub.basic_publish(f"m{i}".encode(), routing_key="wq")
            fut = asyncio.get_event_loop().create_future()
            pub._confirm_waiters[seq] = fut
            fut.add_done_callback(lambda _f, s=seq: order.append(s))
        await pub.wait_unconfirmed_below(1)
        await asyncio.sleep(0.1)
        assert order == sorted(order) and len(order) == 20

        # consume the work queue so deliver.<queue> taps flow too
        got_wq = asyncio.Event()
        n_wq = 0

        def on_wq(msg):
            nonlocal n_wq
            n_wq += 1
            if n_wq == 20:
                got_wq.set()

        await ch.basic_consume("wq", on_wq, no_ack=True)
        await asyncio.wait_for(got_wq.wait(), 5)

        # drain the tap queue (its own deliveries must NOT re-tap)
        taps: list = []

        def on_tap(msg):
            taps.append(msg)

        await ch.basic_consume("tap", on_tap, no_ack=True)
        await asyncio.sleep(0.3)

        keys = [t.routing_key for t in taps]
        assert keys.count("publish") == 20       # default exchange -> bare
        assert keys.count("deliver.wq") == 20
        # no recursion: nothing tapped from the system exchanges
        assert not [k for k in keys
                    if k.startswith(("publish.amq.chanamq",
                                     "deliver.tap"))]
        # counters settled exactly: 20 publish taps + 20 deliver taps,
        # and draining the tap queue added nothing
        published = broker.metrics.firehose_published_total
        assert published == 40
        await asyncio.sleep(0.2)
        assert broker.metrics.firehose_published_total == published
        # tap headers carry the provenance
        hdr = taps[0].properties.headers
        assert hdr["node"] == "local" and "routing_key" in hdr
        await c.close()
    finally:
        events.clear()
        await server.stop()


async def test_firehose_sheds_when_flow_stage_raised():
    server = await _server()
    try:
        broker = server.broker
        fh = Firehose(broker)
        events.install(None, fh)
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("wq")
        await ch.queue_declare("tap")
        await ch.queue_bind("tap", TRACE_EXCHANGE, "publish.#")

        # stub accountant: stage > 0 sheds; components/reevaluate satisfy
        # account_memory's synchronous pushes on the publish path
        broker.flow = SimpleNamespace(
            stage=1, components={}, reevaluate=lambda: None)
        dropped = broker.metrics.firehose_dropped_total
        ch.basic_publish(b"x", routing_key="wq")
        await asyncio.sleep(0.1)
        assert broker.metrics.firehose_dropped_total == dropped + 1
        assert broker.metrics.firehose_published_total == 0

        broker.flow = None  # stage cleared: taps resume
        ch.basic_publish(b"y", routing_key="wq")
        await asyncio.sleep(0.1)
        assert broker.metrics.firehose_published_total == 1
        await c.close()
    finally:
        events.clear()
        await server.stop()


async def test_firehose_idle_gate_tracks_trace_bindings():
    """The hot-path seams gate on ``tap_bindings`` — the trace matcher's
    live binding table. It must be resolved at construction, stay falsy
    while nothing is bound (enabled-but-unconsumed firehose = free), and
    flip truthy/falsy as tap queues bind and die, without re-resolution
    (the alias is the same object the matcher mutates)."""
    server = await _server()
    try:
        fh = Firehose(server.broker)
        assert fh.tap_bindings is not None and not fh.tap_bindings
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("tap")
        await ch.queue_bind("tap", TRACE_EXCHANGE, "#")
        assert fh.tap_bindings
        await ch.queue_delete("tap")  # unbinds everywhere, table drains
        assert not fh.tap_bindings
        await c.close()
    finally:
        await server.stop()


async def test_firehose_queue_filter():
    server = await _server()
    try:
        events.install(None, Firehose(server.broker, queue_filter="keep"))
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("keep-me")
        await ch.queue_declare("skip-me")
        await ch.queue_declare("tap")
        await ch.queue_bind("tap", TRACE_EXCHANGE, "#")
        ch.basic_publish(b"a", routing_key="keep-me")
        ch.basic_publish(b"b", routing_key="skip-me")
        await asyncio.sleep(0.1)
        assert server.broker.metrics.firehose_published_total == 1
        await c.close()
    finally:
        events.clear()
        await server.stop()


# ---------------------------------------------------------------------------
# determinism + admin surface
# ---------------------------------------------------------------------------


async def _scripted_run() -> list[dict]:
    """One broker, a scripted op sequence, the consumed event bodies."""
    server = await _server()
    try:
        events.install(EventBus(server.broker))
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("sink")
        for key in ("queue.#", "alert.#", "flow.#"):
            await ch.queue_bind("sink", EVENT_EXCHANGE, key)
        got: list = []

        def on_msg(msg):
            got.append(json.loads(msg.body))

        await ch.basic_consume("sink", on_msg, no_ack=True)
        await ch.queue_declare("q1")
        events.ACTIVE.emit("alert.fired.backlog", {"rule": "backlog"})
        events.ACTIVE.emit("flow.stage.2", {"stage": 2, "label": "throttle"})
        await ch.queue_delete("q1")
        events.ACTIVE.emit("alert.cleared.backlog", {"rule": "backlog"})
        await asyncio.sleep(0.2)
        await c.close()
        return got
    finally:
        events.clear()
        await server.stop()


async def test_event_stream_deterministic_mod_ts():
    """Two identical runs produce identical event sequences once wall-
    clock ``ts`` is masked — seq, keys, payloads and order all match."""
    first = await _scripted_run()
    second = await _scripted_run()

    def mask(evs):
        return [{k: v for k, v in e.items() if k != "ts"} for e in evs]

    assert len(first) == 5
    assert mask(first) == mask(second)
    assert [e["seq"] for e in first] == [1, 2, 3, 4, 5]


async def test_admin_events_endpoint():
    server = await _server()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        status, body = await http_req(admin.bound_port, "/admin/events")
        assert status == 200
        assert body["enabled"] is False and body["firehose_enabled"] is False

        events.install(EventBus(server.broker), Firehose(server.broker))
        server.broker.metrics.events_dropped_total += 3
        status, body = await http_req(admin.bound_port, "/admin/events")
        assert status == 200
        assert body["enabled"] is True and body["firehose_enabled"] is True
        assert body["events"]["dropped"] == 3
        assert body["bus"]["exchange"] == EVENT_EXCHANGE
    finally:
        events.clear()
        await admin.stop()
        await server.stop()
