"""Transactional channel semantics (tx.select / tx.commit / tx.rollback).

EXCEEDS the reference, which stubs tx.* with TODO logs
(chana-mq-server .../engine/FrameStage.scala:1261-1272): here a tx channel
buffers publishes and ack/nack/reject in arrival order until commit replays
them behind the publisher-confirm durability barrier, or rollback discards
them (per 0-9-1: settled-in-tx deliveries return to unacked WITHOUT
automatic redelivery — basic.recover redelivers).

The port's copy of ``tests/test_tx.py``: imports point at
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

PERSISTENT = BasicProperties(delivery_mode=2)


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


async def test_tx_publish_buffers_until_commit(client):
    ch = await client.channel()
    await ch.queue_declare("txq")
    await ch.tx_select()
    ch.basic_publish(b"one", routing_key="txq")
    ch.basic_publish(b"two", routing_key="txq")
    # same connection, commands processed strictly in order: this passive
    # declare observes queue state after both publishes were buffered
    ch2 = await client.channel()
    ok = await ch2.queue_declare("txq", passive=True)
    assert ok.message_count == 0
    await ch.tx_commit()
    ok = await ch2.queue_declare("txq", passive=True)
    assert ok.message_count == 2
    # committed messages deliver in publish order
    assert (await ch2.basic_get("txq", no_ack=True)).body == b"one"
    assert (await ch2.basic_get("txq", no_ack=True)).body == b"two"


async def test_tx_rollback_discards_publishes(client):
    ch = await client.channel()
    await ch.queue_declare("txq_rb")
    await ch.tx_select()
    ch.basic_publish(b"gone", routing_key="txq_rb")
    await ch.tx_rollback()
    ch2 = await client.channel()
    ok = await ch2.queue_declare("txq_rb", passive=True)
    assert ok.message_count == 0
    # the channel is immediately usable in a fresh transaction
    ch.basic_publish(b"kept", routing_key="txq_rb")
    await ch.tx_commit()
    assert (await ch2.basic_get("txq_rb", no_ack=True)).body == b"kept"


async def test_tx_ack_applies_at_commit(server, client):
    ch = await client.channel()
    await ch.queue_declare("txq_ack")
    ch.basic_publish(b"m", routing_key="txq_ack")
    msg = await ch.basic_get("txq_ack")
    assert msg is not None and msg.body == b"m"
    await ch.tx_select()
    ch.basic_ack(msg.delivery_tag)
    await ch.tx_commit()
    # settled: closing the channel must NOT requeue the message
    await ch.close()
    ch2 = await client.channel()
    assert await ch2.basic_get("txq_ack") is None


async def test_tx_rollback_returns_ack_to_unacked(client):
    ch = await client.channel()
    await ch.queue_declare("txq_rb_ack")
    ch.basic_publish(b"m", routing_key="txq_rb_ack")
    msg = await ch.basic_get("txq_rb_ack")
    await ch.tx_select()
    ch.basic_ack(msg.delivery_tag)
    await ch.tx_rollback()
    # the ack was discarded: the delivery is unacked again (not redelivered
    # automatically, per the spec note on tx.rollback) — so the plain-mode
    # semantics apply: acking it again in a new tx works
    ch.basic_ack(msg.delivery_tag)
    await ch.tx_commit()
    await ch.close()
    ch2 = await client.channel()
    assert await ch2.basic_get("txq_rb_ack") is None


async def test_tx_rollback_then_channel_close_requeues(client):
    ch = await client.channel()
    await ch.queue_declare("txq_requeue")
    ch.basic_publish(b"m", routing_key="txq_requeue")
    msg = await ch.basic_get("txq_requeue")
    await ch.tx_select()
    ch.basic_ack(msg.delivery_tag)
    await ch.tx_rollback()
    # unacked again -> channel close requeues it
    await ch.close()
    ch2 = await client.channel()
    got = await ch2.basic_get("txq_requeue", no_ack=True)
    assert got is not None and got.body == b"m" and got.redelivered


async def test_tx_open_transaction_rolls_back_on_channel_close(client):
    ch = await client.channel()
    await ch.queue_declare("txq_close")
    ch.basic_publish(b"settled", routing_key="txq_close")
    msg = await ch.basic_get("txq_close")
    await ch.tx_select()
    ch.basic_publish(b"uncommitted", routing_key="txq_close")
    ch.basic_ack(msg.delivery_tag)
    await ch.close()  # implicit rollback: publish dropped, delivery requeued
    ch2 = await client.channel()
    ok = await ch2.queue_declare("txq_close", passive=True)
    assert ok.message_count == 1
    got = await ch2.basic_get("txq_close", no_ack=True)
    assert got.body == b"settled" and got.redelivered


async def test_tx_double_settle_in_tx_raises(client):
    ch = await client.channel()
    await ch.queue_declare("txq_double")
    ch.basic_publish(b"m", routing_key="txq_double")
    msg = await ch.basic_get("txq_double")
    await ch.tx_select()
    ch.basic_ack(msg.delivery_tag)
    # second settle of the same tag inside the tx: unknown tag -> 406
    ch.basic_ack(msg.delivery_tag)
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.tx_commit()
    assert exc_info.value.reply_code == 406


async def test_tx_nack_requeue_applies_at_commit(client):
    ch = await client.channel()
    await ch.queue_declare("txq_nack")
    ch.basic_publish(b"m", routing_key="txq_nack")
    msg = await ch.basic_get("txq_nack")
    await ch.tx_select()
    ch.basic_nack(msg.delivery_tag, requeue=True)
    ch2 = await client.channel()
    ok = await ch2.queue_declare("txq_nack", passive=True)
    assert ok.message_count == 0  # not requeued yet
    await ch.tx_commit()
    got = await ch2.basic_get("txq_nack", no_ack=True)
    assert got is not None and got.body == b"m" and got.redelivered


async def test_tx_reject_drop_applies_at_commit(client):
    ch = await client.channel()
    await ch.queue_declare("txq_rej")
    ch.basic_publish(b"m", routing_key="txq_rej")
    msg = await ch.basic_get("txq_rej")
    await ch.tx_select()
    ch.basic_reject(msg.delivery_tag, requeue=False)
    await ch.tx_commit()
    await ch.close()
    ch2 = await client.channel()
    assert await ch2.basic_get("txq_rej") is None


async def test_tx_and_confirm_mutually_exclusive(client):
    ch = await client.channel()
    await ch.confirm_select()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.tx_select()
    assert exc_info.value.reply_code == 406

    ch2 = await client.channel()
    await ch2.tx_select()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch2.confirm_select()
    assert exc_info.value.reply_code == 406


async def test_tx_commit_without_select_raises(client):
    ch = await client.channel()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.tx_commit()
    assert exc_info.value.reply_code == 406
    ch2 = await client.channel()
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch2.tx_rollback()
    assert exc_info.value.reply_code == 406


async def test_tx_empty_commit_and_rollback_ok(client):
    ch = await client.channel()
    await ch.tx_select()
    await ch.tx_commit()
    await ch.tx_rollback()
    await ch.tx_commit()


async def test_tx_mandatory_return_renders_at_commit(client):
    ch = await client.channel()
    await ch.tx_select()
    ch.basic_publish(b"nowhere", routing_key="no.such.queue", mandatory=True)
    # buffered: no Return yet (observe via an ordered round trip)
    await ch.tx_rollback()
    await asyncio.sleep(0.05)
    assert ch.returns == []
    ch.basic_publish(b"nowhere", routing_key="no.such.queue", mandatory=True)
    await ch.tx_commit()
    await asyncio.sleep(0.05)
    assert len(ch.returns) == 1
    assert ch.returns[0].reply_code == 312  # NO_ROUTE


async def test_tx_interleaved_publish_and_ack_order(client):
    """Ops replay in arrival order: publish, ack, publish inside one tx."""
    ch = await client.channel()
    await ch.queue_declare("txq_order")
    ch.basic_publish(b"first", routing_key="txq_order")
    msg = await ch.basic_get("txq_order")
    await ch.tx_select()
    ch.basic_publish(b"second", routing_key="txq_order")
    ch.basic_ack(msg.delivery_tag)
    ch.basic_publish(b"third", routing_key="txq_order")
    await ch.tx_commit()
    ch2 = await client.channel()
    assert (await ch2.basic_get("txq_order", no_ack=True)).body == b"second"
    assert (await ch2.basic_get("txq_order", no_ack=True)).body == b"third"
    assert await ch2.basic_get("txq_order") is None


async def test_tx_persistent_commit_survives_restart(tmp_path):
    """Tx.CommitOk is a durability barrier: a committed persistent publish
    to a durable queue survives a broker restart; an uncommitted one
    (connection died mid-tx) does not."""
    db_path = str(tmp_path / "tx.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("tx_durable", durable=True)
    await ch.tx_select()
    ch.basic_publish(b"committed", routing_key="tx_durable",
                     properties=PERSISTENT)
    await ch.tx_commit()
    ch.basic_publish(b"uncommitted", routing_key="tx_durable",
                     properties=PERSISTENT)
    # drive the publish onto the server before dropping the connection
    ch2 = await c.channel()
    await ch2.queue_declare("tx_durable", passive=True)
    await c.close()
    await srv.stop()

    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch3 = await c2.channel()
        ok = await ch3.queue_declare("tx_durable", durable=True, passive=True)
        assert ok.message_count == 1
        got = await ch3.basic_get("tx_durable", no_ack=True)
        assert got.body == b"committed"
        await c2.close()
    finally:
        await srv2.stop()


async def test_tx_partial_commit_failure_restores_parked_settles(client):
    """A replayed publish that fails mid-commit (deleted exchange) closes
    the channel — but parked settles ordered after it must NOT vanish: the
    deliveries return to unacked and the channel teardown requeues them."""
    ch = await client.channel()
    await ch.exchange_declare("tx_doomed_ex", "direct")
    await ch.queue_declare("txq_partial")
    ch.basic_publish(b"held", routing_key="txq_partial")
    msg = await ch.basic_get("txq_partial")
    await ch.tx_select()
    # buffered publish to an exchange that will be gone at commit time,
    # ordered BEFORE the ack
    ch.basic_publish(b"x", exchange="tx_doomed_ex", routing_key="k")
    ch.basic_ack(msg.delivery_tag)
    ch2 = await client.channel()
    await ch2.exchange_delete("tx_doomed_ex")
    with pytest.raises(ChannelClosedError) as exc_info:
        await ch.tx_commit()
    assert exc_info.value.reply_code == 404
    # the ack never applied and the delivery was requeued by the close
    await asyncio.sleep(0.05)
    got = await ch2.basic_get("txq_partial", no_ack=True)
    assert got is not None and got.body == b"held" and got.redelivered


async def test_tx_parked_settles_hold_global_prefetch_budget(client):
    """Stashing an ack inside a tx must not reopen the channel-global
    prefetch window before the commit applies it."""
    ch = await client.channel()
    await ch.queue_declare("txq_qos")
    await ch.basic_qos(prefetch_count=1, global_=True)
    ch.basic_publish(b"one", routing_key="txq_qos")
    ch.basic_publish(b"two", routing_key="txq_qos")
    cb_msgs = []
    await ch.basic_consume("txq_qos", cb_msgs.append)
    await asyncio.sleep(0.1)
    assert [m.body for m in cb_msgs] == [b"one"]  # window of 1
    await ch.tx_select()
    ch.basic_ack(cb_msgs[0].delivery_tag)
    ch2 = await client.channel()
    await ch2.queue_declare("txq_qos", passive=True)  # ordering barrier
    await asyncio.sleep(0.1)
    # the parked ack must NOT have opened the window
    assert [m.body for m in cb_msgs] == [b"one"]
    await ch.tx_commit()
    await asyncio.sleep(0.1)
    assert [m.body for m in cb_msgs] == [b"one", b"two"]


async def test_tx_buffered_publishes_count_against_memory_gauge(server, client):
    """A flood parked inside a never-committed tx is visible to the broker
    memory gauge (and thus the backpressure gate)."""
    broker = server.broker
    ch = await client.channel()
    await ch.queue_declare("txq_mem")
    await ch.tx_select()
    body = b"x" * 4096
    before = broker.resident_bytes
    for _ in range(8):
        ch.basic_publish(body, routing_key="txq_mem")
    ch2 = await client.channel()
    await ch2.queue_declare("txq_mem", passive=True)  # ordering barrier
    assert broker.resident_bytes >= before + 8 * len(body)
    await ch.tx_rollback()
    await ch2.queue_declare("txq_mem", passive=True)
    assert broker.resident_bytes == before


async def test_tx_commit_store_failure_never_sends_commit_ok(tmp_path):
    """Tx.CommitOk is a durability barrier: a store failure covering the
    commit's persistent writes must error the channel/connection instead of
    acknowledging — and the message must not silently survive as a ghost."""
    db_path = str(tmp_path / "txfail.db")
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    store = srv.broker.store
    orig_insert = store.insert_message_nowait

    def failing_insert(msg):
        if msg.routing_key == "tx_fail_q":
            store._submit_nowait(
                lambda db: db.execute("INSERT INTO no_such_table VALUES (1)"))
            return
        orig_insert(msg)

    store.insert_message_nowait = failing_insert
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("tx_fail_q", durable=True)
    await ch.tx_select()
    ch.basic_publish(b"doomed", routing_key="tx_fail_q",
                     properties=PERSISTENT)
    with pytest.raises(Exception):
        await ch.tx_commit()
    store.insert_message_nowait = orig_insert
    await c.close()
    await srv.stop()

    # after a restart, the failed commit left no durable ghost ready to
    # deliver a message the client was told (nothing) about
    srv2 = BrokerServer(broker=Broker(store=SqliteStore(db_path), router_device="cpu"),
                        host="127.0.0.1", port=0, heartbeat_s=0)
    await srv2.start()
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        got = await ch2.basic_get("tx_fail_q", no_ack=True)
        assert got is None
        await c2.close()
    finally:
        await srv2.stop()
