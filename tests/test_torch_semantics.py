"""Advanced delivery semantics (chanamq_tpu_torch/semantics/): Tx atomicity on
the WAL commit boundary (one tx_batch frame, all-or-nothing under torn
writes), exchange-to-exchange closure flattening parity against the live
graph walk, delayed delivery via the broker timer wheel, per-message
priority ceiling clamping, TTL precedence, x-death monotonicity on DLX
retry cycles, and the deferred-fused-publish vs mandatory Basic.Return
ordering contract.

The port's copy of ``tests/test_semantics.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import os

import pytest

from chanamq_tpu_torch import events
from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.client.client import ChannelClosedError
from chanamq_tpu_torch.semantics import TimerWheel, parse_delay
from chanamq_tpu_torch.store.api import StoredMessage
from chanamq_tpu_torch.store.sqlite import SqliteStore
from chanamq_tpu_torch.wal import WalStore
from chanamq_tpu_torch.wal.segment import list_segments

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


class _BusStub:
    """Stands in for events.ACTIVE: records every emit for assertion."""

    def __init__(self):
        self.emits = []

    def emit(self, key, payload, vhost_name=None):
        self.emits.append((key, payload))

    def keys(self):
        return [k for k, _ in self.emits]


# ---------------------------------------------------------------------------
# Tx atomicity on the WAL commit boundary
# ---------------------------------------------------------------------------


def _wal(db_path: str) -> WalStore:
    return WalStore(SqliteStore(db_path), flush_ms=1.0,
                    checkpoint_ms=3_600_000.0)


def _msg(i: int) -> StoredMessage:
    return StoredMessage(id=i, properties_raw=b"\x01", body=b"body%d" % i,
                         exchange="ex", routing_key="rk", refer_count=1)


async def _crash(store: WalStore) -> None:
    store._commit_task.cancel()
    store._checkpoint_task.cancel()
    store._inner._closed = True
    store._executor.shutdown(wait=True)
    store._inner._executor.shutdown(wait=False)


def _wipe_index(db_path: str) -> None:
    import sqlite3
    db = sqlite3.connect(db_path)
    db.execute("DELETE FROM msgs")
    db.commit()
    db.close()


async def test_tx_batch_torn_frame_drops_whole_transaction(tmp_path):
    """SIGKILL mid-commit: a transaction is ONE tx_batch frame, so a torn
    tail drops every op in it — never a prefix. The pre-tx record written
    outside the scope survives untouched."""
    db_path = str(tmp_path / "torn.db")
    s = _wal(db_path)
    await s.open()
    lo = s.mark()
    s.insert_message_nowait(_msg(0))          # outside any tx
    s.tx_begin()
    for i in range(1, 4):
        s.insert_message_nowait(_msg(i))      # diverted into the tx scope
    lsn = s.tx_seal()
    await s.flush([(lo, lsn)])
    assert s.metrics.wal_tx_batches == 1
    assert s.metrics.wal_tx_batch_ops == 3
    await _crash(s)

    # tear the tail: the tx_batch frame was written last, so a short
    # truncation lands inside it and its CRC cannot verify
    segs = list_segments(s.dir)
    with open(segs[-1][1], "r+b") as f:
        f.truncate(f.seek(0, os.SEEK_END) - 3)
    _wipe_index(db_path)

    s2 = _wal(db_path)
    await s2.open()
    got = await s2.select_messages([0, 1, 2, 3])
    assert sorted(got) == [0]  # all-or-nothing: the whole tx vanished
    await s2.close()


async def test_tx_batch_intact_replays_every_op(tmp_path):
    """The durable case of the same boundary: an intact tx_batch frame
    replays every sub-op (publishes AND settles) on recovery."""
    db_path = str(tmp_path / "intact.db")
    s = _wal(db_path)
    await s.open()
    lo = s.mark()
    s.insert_message_nowait(_msg(0))
    s.tx_begin()
    for i in range(1, 4):
        s.insert_message_nowait(_msg(i))
    lsn = s.tx_seal()
    await s.flush([(lo, lsn)])
    await _crash(s)
    _wipe_index(db_path)

    s2 = _wal(db_path)
    await s2.open()
    got = await s2.select_messages([0, 1, 2, 3])
    assert sorted(got) == [0, 1, 2, 3]
    await s2.close()


async def test_tx_commit_is_atomic_across_restart(tmp_path):
    """End-to-end kill between Tx.Commit receipt and WAL commit: a
    restarted broker sees either every publish in the tx or none — here
    the committed tx (3 publishes + 1 ack) lands whole."""
    db_path = str(tmp_path / "tx_e2e.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path),
                                     router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("txa", durable=True)
    persistent = BasicProperties(delivery_mode=2)
    ch.basic_publish(b"seed", routing_key="txa", properties=persistent)
    msg = await ch.basic_get("txa")
    await ch.tx_select()
    for i in range(3):
        ch.basic_publish(b"tx%d" % i, routing_key="txa", properties=persistent)
    ch.basic_ack(msg.delivery_tag)
    await ch.tx_commit()
    await c.close()
    await srv.stop()

    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db_path),
                                      router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ok = await ch2.queue_declare("txa", durable=True, passive=True)
        assert ok.message_count == 3  # seed acked in-tx, 3 tx publishes kept
        bodies = [(await ch2.basic_get("txa", no_ack=True)).body
                  for _ in range(3)]
        assert bodies == [b"tx0", b"tx1", b"tx2"]
        await c2.close()
    finally:
        await srv2.stop()


async def test_tx_commit_and_rollback_emit_events(client):
    ch = await client.channel()
    await ch.queue_declare("txe")
    await ch.tx_select()
    stub = _BusStub()
    events.ACTIVE = stub
    try:
        ch.basic_publish(b"m", routing_key="txe")
        await ch.tx_commit()
        ch.basic_publish(b"m2", routing_key="txe")
        await ch.tx_rollback()
    finally:
        events.ACTIVE = None
    keys = stub.keys()
    assert "tx.committed" in keys and "tx.rolledback" in keys
    committed = dict(stub.emits)["tx.committed"]
    # transient store: no WAL scope, so the commit reports atomic=False
    # (the WAL-backed atomic path is covered by the restart tests above)
    assert committed["ops"] == 1 and committed["atomic"] is False


# ---------------------------------------------------------------------------
# exchange->exchange closure parity
# ---------------------------------------------------------------------------


async def test_e2e_chain_closure_matches_graph_walk():
    """3-deep bound-exchange chain: the flattened TensorRouter closure
    routes every key to exactly the set the live graph walk produces —
    verified by the router's own parity oracle (zero mismatches)."""
    broker = Broker(router_device="cpu")
    await broker.create_vhost("/")
    for name, kind in [("root", "fanout"), ("mid", "topic"),
                       ("leaf", "direct")]:
        await broker.declare_exchange("/", name, kind)
    for q in ("q_root", "q_mid", "q_leaf"):
        await broker.declare_queue("/", q)
    await broker.bind_queue("/", "q_root", "root", "")
    await broker.bind_queue("/", "q_mid", "mid", "a.*")
    await broker.bind_queue("/", "q_leaf", "leaf", "a.b")
    await broker.bind_exchange("/", "mid", "root", "")     # fanout hop
    await broker.bind_exchange("/", "leaf", "mid", "a.#")  # wildcard hop
    vhost = broker.vhost("/")
    router = broker.router
    router.min_batch = 1
    router.verify = True
    assert router.defer_ok("/", "root")  # the closure compiled
    props = BasicProperties()
    keys = ("a.b", "a.x", "b.c", "", "a.b.c", "a")
    entries = [("root", k, props, b"x", None, None, False) for k in keys]
    routes, _, _ = router.route_pending("/", entries)
    for k, qs in zip(keys, routes):
        assert {q.name for q in qs} == vhost.route("root", k, None)
    assert broker.metrics.router_parity_mismatches == 0
    assert broker.metrics.router_batches >= 1  # kernel path, not fallback

    # incremental recompile: unbinding a member invalidates the root's
    # snapshot through the closure dependency map
    await broker.unbind_exchange("/", "leaf", "mid", "a.#")
    routes, _, _ = router.route_pending(
        "/", [("root", "a.b", props, b"x", None, None, False)])
    assert ({q.name for q in routes[0]}
            == vhost.route("root", "a.b", None) == {"q_root", "q_mid"})
    assert broker.metrics.router_parity_mismatches == 0


async def test_e2e_uncompilable_closure_stays_on_walk():
    """Wildcard-over-wildcard cannot flatten: the root is not deferrable
    and per-message routing still matches the walk."""
    broker = Broker(router_device="cpu")
    await broker.create_vhost("/")
    await broker.declare_exchange("/", "src", "topic")
    await broker.declare_exchange("/", "dst", "topic")
    await broker.declare_queue("/", "q")
    await broker.bind_queue("/", "q", "dst", "a.*")
    await broker.bind_exchange("/", "dst", "src", "a.#")
    assert not broker.router.defer_ok("/", "src")
    vhost = broker.vhost("/")
    # the walk still routes correctly: both hops must match the ORIGINAL key
    assert vhost.route("src", "a.b", None) == {"q"}
    assert vhost.route("src", "a.b.c", None) == set()  # a.# yes, a.* no


# ---------------------------------------------------------------------------
# delayed delivery
# ---------------------------------------------------------------------------


def test_parse_delay_rejects_junk():
    assert parse_delay(None) is None
    assert parse_delay({}) is None
    assert parse_delay({"x-delay": 0}) is None
    assert parse_delay({"x-delay": -5}) is None
    assert parse_delay({"x-delay": True}) is None
    assert parse_delay({"x-delay": "100"}) is None
    assert parse_delay({"x-delay": 100}) == 100
    assert parse_delay({"x-delay": 1 << 40}) == (1 << 32) - 1  # clamped


def test_timer_wheel_multi_turn_entries():
    w = TimerWheel(tick_ms=10, slots=4)
    w.schedule(10, "near")    # due tick 1
    w.schedule(50, "far")     # due tick 5 -> same slot as tick 1
    assert len(w) == 2
    assert w.advance(1) == ["near"]   # the far entry stays for its turn
    assert len(w) == 1
    assert w.advance(3) == []
    assert w.advance(1) == ["far"]
    assert len(w) == 0


async def test_delayed_publish_parks_then_delivers(client):
    ch = await client.channel()
    await ch.queue_declare("dq")
    ch.basic_publish(b"later", routing_key="dq",
                     properties=BasicProperties(headers={"x-delay": 120}))
    ok = await ch.queue_declare("dq", passive=True)
    assert ok.message_count == 0  # parked, not enqueued
    got = await drain(ch, "dq", 1)
    assert [m.body for m in got] == [b"later"]
    # the header is stripped before fire so consumers never see x-delay
    assert (got[0].properties.headers or {}).get("x-delay") is None


async def test_delayed_message_outlives_queue_delete(server, client):
    """Routing happens at fire time: if the target queue is deleted while
    the message is parked, the fire routes against current topology —
    here it drops unroutably without disturbing the broker."""
    ch = await client.channel()
    await ch.queue_declare("ghost")
    ch.basic_publish(b"orphan", routing_key="ghost",
                     properties=BasicProperties(headers={"x-delay": 150}))
    await ch.queue_delete("ghost")
    broker = server.broker
    fired = broker.metrics.semantics_delay_fired
    deadline = asyncio.get_event_loop().time() + 3.0
    while (broker.metrics.semantics_delay_fired == fired
           and asyncio.get_event_loop().time() < deadline):
        await asyncio.sleep(0.02)
    assert broker.metrics.semantics_delay_fired == fired + 1
    assert len(broker.delay.wheel) == 0
    # parked-memory accounting fully released
    # broker stays healthy: a fresh queue round-trips
    await ch.queue_declare("ghost")
    ch.basic_publish(b"alive", routing_key="ghost")
    got = await drain(ch, "ghost", 1)
    assert [m.body for m in got] == [b"alive"]


async def test_delayed_publish_accounts_memory_while_parked(server, client):
    broker = server.broker
    ch = await client.channel()
    await ch.queue_declare("dmem")
    before = broker.resident_bytes
    body = b"z" * 4096
    ch.basic_publish(body, routing_key="dmem",
                     properties=BasicProperties(headers={"x-delay": 200}))
    ok = await ch.queue_declare("dmem", passive=True)
    assert ok.message_count == 0
    assert broker.resident_bytes >= before + len(body)
    got = await drain(ch, "dmem", 1)
    assert got[0].body == body


async def test_semantics_disabled_routes_x_delay_immediately():
    broker = Broker(semantics_enabled=False, router_device="cpu")
    await broker.create_vhost("/")
    await broker.declare_queue("/", "q")
    assert broker.delay is None
    routed, _ = broker.publish_sync(
        "/", "", "q", BasicProperties(headers={"x-delay": 60_000}), b"now")
    assert routed
    assert broker.vhost("/").queues["q"].message_count == 1  # no parking


# ---------------------------------------------------------------------------
# priority ceiling + TTL precedence + x-death monotonicity
# ---------------------------------------------------------------------------


async def test_priority_ceiling_clamps_not_errors(client):
    """priority > x-max-priority clamps to the ceiling (RabbitMQ rule):
    a 255-priority publish on a max-4 queue ranks equal to priority 4 and
    FIFO order breaks the tie."""
    ch = await client.channel()
    await ch.queue_declare("pq", arguments={"x-max-priority": 4})
    ch.basic_publish(b"low", routing_key="pq",
                     properties=BasicProperties(priority=1))
    ch.basic_publish(b"at-max", routing_key="pq",
                     properties=BasicProperties(priority=4))
    ch.basic_publish(b"clamped", routing_key="pq",
                     properties=BasicProperties(priority=255))
    got = await drain(ch, "pq", 3)
    # clamped (255->4) ties with at-max: FIFO within the band
    assert [m.body for m in got] == [b"at-max", b"clamped", b"low"]


async def test_per_message_ttl_beats_longer_queue_ttl(client):
    """Effective TTL is min(per-message, per-queue): a short expiration on
    a long-TTL queue expires fast; a long expiration on a short-TTL queue
    is bounded by the queue."""
    ch = await client.channel()
    await ch.exchange_declare("dlx_ttl", "fanout")
    await ch.queue_declare("dlq_ttl")
    await ch.queue_bind("dlq_ttl", "dlx_ttl", "")
    # long queue TTL, short message TTL
    await ch.queue_declare("ttl_a", arguments={
        "x-message-ttl": 60_000, "x-dead-letter-exchange": "dlx_ttl"})
    ch.basic_publish(b"msg-short", routing_key="ttl_a",
                     properties=BasicProperties(expiration="60"))
    got = await drain(ch, "dlq_ttl", 1)
    assert got[0].body == b"msg-short"
    assert got[0].properties.headers["x-death"][0]["reason"] == "expired"
    # short queue TTL, long message TTL
    await ch.queue_declare("ttl_b", arguments={
        "x-message-ttl": 60, "x-dead-letter-exchange": "dlx_ttl"})
    ch.basic_publish(b"queue-short", routing_key="ttl_b",
                     properties=BasicProperties(expiration="60000"))
    got = await drain(ch, "dlq_ttl", 1)
    assert got[0].body == b"queue-short"


async def test_x_death_count_monotonic_on_dlx_cycle(client):
    """Reject-driven DLX retry ring (work -> dlx -> work): the x-death
    count for (work, rejected) increments 1, 2, 3 — strictly monotonic,
    one increment per death, exactly-once per cycle."""
    ch = await client.channel()
    await ch.exchange_declare("retry_dlx", "fanout")
    await ch.queue_declare("work", arguments={
        "x-dead-letter-exchange": "retry_dlx"})
    await ch.queue_bind("work", "retry_dlx", "")
    ch.basic_publish(b"poison", routing_key="work")
    counts = []
    for expect in (1, 2, 3):
        msg = None
        deadline = asyncio.get_event_loop().time() + 3.0
        while msg is None and asyncio.get_event_loop().time() < deadline:
            msg = await ch.basic_get("work")
            if msg is None:
                await asyncio.sleep(0.02)
        assert msg is not None
        deaths = (msg.properties.headers or {}).get("x-death")
        if deaths is not None:
            entry = next(d for d in deaths
                         if d["queue"] == "work" and d["reason"] == "rejected")
            counts.append(entry["count"])
        ch.basic_reject(msg.delivery_tag, requeue=False)
    # after 3 rejects the message cycled 3 times; counts observed on
    # fetch are the deaths so far: [1, 2] (first fetch has no x-death yet)
    assert counts == [1, 2]
    msg = None
    deadline = asyncio.get_event_loop().time() + 3.0
    while msg is None and asyncio.get_event_loop().time() < deadline:
        msg = await ch.basic_get("work", no_ack=True)
        if msg is None:
            await asyncio.sleep(0.02)
    entry = next(d for d in msg.properties.headers["x-death"]
                 if d["queue"] == "work" and d["reason"] == "rejected")
    assert entry["count"] == 3


async def test_dead_letter_emits_event_and_metrics(server, client):
    broker = server.broker
    ch = await client.channel()
    await ch.exchange_declare("dlx_ev", "fanout")
    await ch.queue_declare("dlq_ev")
    await ch.queue_bind("dlq_ev", "dlx_ev", "")
    await ch.queue_declare("src_ev", arguments={
        "x-dead-letter-exchange": "dlx_ev"})
    ch.basic_publish(b"m", routing_key="src_ev")
    msg = await ch.basic_get("src_ev")
    stub = _BusStub()
    events.ACTIVE = stub
    before = broker.metrics.dlx_rejected
    try:
        ch.basic_reject(msg.delivery_tag, requeue=False)
        got = await drain(ch, "dlq_ev", 1)
    finally:
        events.ACTIVE = None
    assert got[0].body == b"m"
    assert broker.metrics.dlx_rejected == before + 1
    assert broker.metrics.dlx_published >= 1
    payload = dict(stub.emits)["message.dead_lettered"]
    assert payload["reason"] == "rejected" and payload["queue"] == "src_ev"


# ---------------------------------------------------------------------------
# deferred fused publish vs mandatory Basic.Return ordering
# ---------------------------------------------------------------------------


async def test_mandatory_return_does_not_overtake_deferred_batch(client):
    """Fused publishes may sit in the deferred route batch; a mandatory
    publish takes the generic path, which must flush that batch FIRST —
    so the Return renders after earlier publishes landed, and a routed
    mandatory publish keeps FIFO position behind them."""
    ch = await client.channel()
    await ch.queue_declare("ordq")
    # these are fused-path candidates (no mandatory bit)
    ch.basic_publish(b"one", routing_key="ordq")
    ch.basic_publish(b"two", routing_key="ordq")
    # mandatory + unroutable: generic path, must flush the batch first
    ch.basic_publish(b"void", routing_key="no.such.queue", mandatory=True)
    # mandatory + routed: lands strictly after one/two
    ch.basic_publish(b"three", routing_key="ordq", mandatory=True)
    deadline = asyncio.get_event_loop().time() + 3.0
    while not ch.returns and asyncio.get_event_loop().time() < deadline:
        await asyncio.sleep(0.02)
    assert len(ch.returns) == 1
    assert ch.returns[0].reply_code == 312  # NO_ROUTE
    ok = await ch.queue_declare("ordq", passive=True)
    assert ok.message_count == 3  # the deferred pair was not lost
    got = await drain(ch, "ordq", 3)
    assert [m.body for m in got] == [b"one", b"two", b"three"]


# ---------------------------------------------------------------------------
# cycle refusal keeps admin surface consistent
# ---------------------------------------------------------------------------


async def test_cycle_refusal_emits_event(server, client):
    ch = await client.channel()
    await ch.exchange_declare("ca", "fanout")
    await ch.exchange_declare("cb", "fanout")
    await ch.exchange_bind("cb", "ca", "")
    stub = _BusStub()
    events.ACTIVE = stub
    try:
        with pytest.raises(ChannelClosedError) as exc:
            await ch.exchange_bind("ca", "cb", "")
        assert "406" in str(exc.value)
    finally:
        events.ACTIVE = None
    payload = dict(stub.emits)["exchange.cycle_refused"]
    assert payload["source"] == "cb" and payload["destination"] == "ca"
