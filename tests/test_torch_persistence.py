"""Durability and recovery tests: SQLite store + broker restart.

The HA contract of the reference (README.md:47-49, recovery call stack
SURVEY.md §3.6): durable + persistent state survives broker death and is
recovered from the store on the next start.

The port's copy of ``tests/test_persistence.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU, and the
crash loop's broker process is a port node built by
``BrokerServer.from_config`` (``NODE``: the port has no ``main``); the
assertions are the reference's.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.store.api import StoredExchange, StoredMessage, StoredQueue
from chanamq_tpu_torch.store.sqlite import SqliteStore

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)

# a port node on 127.0.0.1:<port> over the store at <path>, its router
# on the CPU, served until killed: python -c NODE <port> <path>
NODE = (
    "import asyncio, sys\n"
    "from chanamq_tpu_torch.broker.server import BrokerServer\n"
    "from chanamq_tpu_torch.config import Config\n"
    "cfg = Config({'chana.mq.amqp.interface': '127.0.0.1',\n"
    "              'chana.mq.amqp.port': int(sys.argv[1]),\n"
    "              'chana.mq.store.path': sys.argv[2],\n"
    "              'chana.mq.router.device': 'cpu'})\n"
    "asyncio.run(BrokerServer.from_config(cfg).serve_forever())\n")


@pytest.fixture
def db_path(tmp_path):
    return str(tmp_path / "broker.db")


async def start_server(db_path):
    srv = BrokerServer(broker=Broker(store=SqliteStore(db_path),
                                     router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    return srv


# ---------------------------------------------------------------------------
# store unit tests
# ---------------------------------------------------------------------------


async def test_sqlite_message_roundtrip(db_path):
    store = SqliteStore(db_path)
    await store.open()
    msg = StoredMessage(id=7, properties_raw=b"\x01\x02", body=b"body",
                        exchange="ex", routing_key="rk", refer_count=2,
                        ttl_ms=5000)
    await store.insert_message(msg)
    got = await store.select_message(7)
    assert got == msg
    await store.update_message_refer_count(7, 1)
    assert (await store.select_message(7)).refer_count == 1
    await store.delete_message(7)
    assert await store.select_message(7) is None
    await store.close()


async def test_sqlite_queue_roundtrip(db_path):
    store = SqliteStore(db_path)
    await store.open()
    q = StoredQueue(vhost="/", name="q1", durable=True, ttl_ms=1000,
                    arguments={"x-message-ttl": 1000})
    await store.insert_queue_meta(q)
    await store.insert_queue_msg("/", "q1", 1, 100, 10, None)
    await store.insert_queue_msg("/", "q1", 2, 101, 20, 9999999999999)
    await store.insert_queue_unacks("/", "q1", [(99, 0, 5, None)])
    got = await store.select_queue("/", "q1")
    assert got.name == "q1"
    assert got.ttl_ms == 1000
    assert got.msgs == [(1, 100, 10, None), (2, 101, 20, 9999999999999)]
    assert got.unacks == {99: (0, 5, None)}
    # watermark advance prunes the log
    await store.update_queue_last_consumed("/", "q1", 1)
    got = await store.select_queue("/", "q1")
    assert got.last_consumed == 1
    assert got.msgs == [(2, 101, 20, 9999999999999)]
    await store.delete_queue_unacks("/", "q1", [99])
    assert (await store.select_queue("/", "q1")).unacks == {}
    await store.close()


async def test_sqlite_exchange_binds_roundtrip(db_path):
    store = SqliteStore(db_path)
    await store.open()
    await store.insert_exchange(StoredExchange(
        vhost="/", name="ex", type="topic", durable=True))
    await store.insert_bind("/", "ex", "q1", "a.*", None)
    await store.insert_bind("/", "ex", "q2", "a.#", {"x": 1})
    got = await store.select_exchange("/", "ex")
    assert got.type == "topic"
    assert sorted(got.binds) == [("a.#", "q2", {"x": 1}), ("a.*", "q1", None)]
    await store.delete_bind("/", "ex", "q1", "a.*")
    assert len((await store.select_exchange("/", "ex")).binds) == 1
    await store.delete_queue_binds("/", "q2")
    assert (await store.select_exchange("/", "ex")).binds == []
    await store.close()


async def test_sqlite_archive_on_delete(db_path):
    store = SqliteStore(db_path)
    await store.open()
    await store.insert_queue_meta(StoredQueue(vhost="/", name="dq", durable=True))
    await store.insert_queue_msg("/", "dq", 1, 500, 9, None)
    await store.archive_queue("/", "dq")
    await store.delete_queue("/", "dq")
    assert await store.select_queue("/", "dq") is None
    # archival copies exist (reference: *_deleted tables)
    def q(db):
        rows = db.execute("SELECT * FROM queue_msgs_deleted").fetchall()
        metas = db.execute("SELECT * FROM queue_metas_deleted").fetchall()
        return rows, metas
    rows, metas = await store._submit(q)
    assert len(rows) == 1 and rows[0][3] == 500
    assert len(metas) == 1
    await store.close()


# ---------------------------------------------------------------------------
# broker restart recovery
# ---------------------------------------------------------------------------


async def test_durable_entities_survive_restart(db_path):
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.exchange_declare("dur_ex", "topic", durable=True)
    await ch.queue_declare("dur_q", durable=True)
    await ch.queue_bind("dur_q", "dur_ex", "logs.#")
    for i in range(5):
        ch.basic_publish(f"p{i}".encode(), exchange="dur_ex",
                         routing_key="logs.app", properties=PERSISTENT)
    await asyncio.sleep(0.1)
    await c.close()
    await srv.stop()

    # new broker process-equivalent: fresh server over the same file
    srv2 = await start_server(db_path)
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ok = await ch2.queue_declare("dur_q", passive=True)
        assert ok.message_count == 5
        # the binding also survived: publish routes again
        ch2.basic_publish(b"p5", exchange="dur_ex", routing_key="logs.db",
                          properties=PERSISTENT)
        await asyncio.sleep(0.1)
        bodies = []
        for _ in range(6):
            m = await ch2.basic_get("dur_q", no_ack=True)
            bodies.append(m.body)
        assert bodies == [b"p0", b"p1", b"p2", b"p3", b"p4", b"p5"]
        await c2.close()
    finally:
        await srv2.stop()


async def test_transient_messages_do_not_survive_restart(db_path):
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("mix_q", durable=True)
    ch.basic_publish(b"persistent", routing_key="mix_q", properties=PERSISTENT)
    ch.basic_publish(b"transient", routing_key="mix_q")  # delivery_mode unset
    await asyncio.sleep(0.1)
    await c.close()
    await srv.stop()

    srv2 = await start_server(db_path)
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ok = await ch2.queue_declare("mix_q", passive=True)
        assert ok.message_count == 1
        m = await ch2.basic_get("mix_q", no_ack=True)
        assert m.body == b"persistent"
        await c2.close()
    finally:
        await srv2.stop()


async def test_unacked_messages_recovered_after_crash(db_path):
    """Deliver without ack, kill the broker: the message must come back
    (redeliverable) after restart — the reference's unack table reload."""
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("crash_q", durable=True)
    got = []
    await ch.basic_consume("crash_q", lambda m: got.append(m))  # no ack sent
    ch.basic_publish(b"inflight", routing_key="crash_q", properties=PERSISTENT)
    await asyncio.sleep(0.2)
    assert len(got) == 1
    # crash: no clean client close, no ack
    await srv.stop()

    srv2 = await start_server(db_path)
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ok = await ch2.queue_declare("crash_q", passive=True)
        assert ok.message_count == 1
        m = await ch2.basic_get("crash_q", no_ack=True)
        assert m.body == b"inflight"
        await c2.close()
    finally:
        await srv2.stop()


async def test_unacked_survive_double_crash(db_path):
    """Review regression: recovery converts unack rows back into queue-log
    rows, so a second crash before redelivery still retains the message."""
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("dd_q", durable=True)
    got = []
    await ch.basic_consume("dd_q", lambda m: got.append(m))
    ch.basic_publish(b"sticky", routing_key="dd_q", properties=PERSISTENT)
    await asyncio.sleep(0.2)
    await srv.stop()  # crash 1 with message unacked

    srv2 = await start_server(db_path)
    await srv2.stop()  # crash 2 before anyone consumed

    srv3 = await start_server(db_path)
    try:
        c3 = await AMQPClient.connect("127.0.0.1", srv3.bound_port)
        ch3 = await c3.channel()
        m = await ch3.basic_get("dd_q", no_ack=True)
        assert m is not None and m.body == b"sticky"
        await c3.close()
    finally:
        await srv3.stop()


async def test_acked_messages_not_recovered(db_path):
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("done_q", durable=True)
    ch.basic_publish(b"done", routing_key="done_q", properties=PERSISTENT)
    await asyncio.sleep(0.1)
    m = await ch.basic_get("done_q")
    ch.basic_ack(m.delivery_tag)
    await asyncio.sleep(0.1)
    await c.close()
    await srv.stop()

    srv2 = await start_server(db_path)
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        ok = await ch2.queue_declare("done_q", passive=True)
        assert ok.message_count == 0
        await c2.close()
    finally:
        await srv2.stop()


async def test_deleted_queue_not_recovered(db_path):
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.queue_declare("gone_q", durable=True)
    ch.basic_publish(b"x", routing_key="gone_q", properties=PERSISTENT)
    await asyncio.sleep(0.1)
    await ch.queue_delete("gone_q")
    await c.close()
    await srv.stop()

    srv2 = await start_server(db_path)
    try:
        c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
        ch2 = await c2.channel()
        from chanamq_tpu_torch.client.client import ChannelClosedError

        with pytest.raises(ChannelClosedError):
            await ch2.queue_declare("gone_q", passive=True)
        await c2.close()
    finally:
        await srv2.stop()


async def test_vhosts_survive_restart(db_path):
    srv = await start_server(db_path)
    await srv.broker.create_vhost("tenant-a")
    await srv.stop()
    srv2 = await start_server(db_path)
    try:
        c = await AMQPClient.connect("127.0.0.1", srv2.bound_port, vhost="tenant-a")
        ch = await c.channel()
        ok = await ch.queue_declare("t_q")
        assert ok.queue == "t_q"
        await c.close()
    finally:
        await srv2.stop()


async def test_message_refcount_deleted_when_all_queues_ack(db_path):
    """A message fanned to 2 durable queues is deleted from the store only
    after both copies are consumed (reference: MessageEntity refcount)."""
    srv = await start_server(db_path)
    c = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    ch = await c.channel()
    await ch.exchange_declare("fan2", "fanout", durable=True)
    await ch.queue_declare("f_q1", durable=True)
    await ch.queue_declare("f_q2", durable=True)
    await ch.queue_bind("f_q1", "fan2", "")
    await ch.queue_bind("f_q2", "fan2", "")
    ch.basic_publish(b"shared", exchange="fan2", properties=PERSISTENT)
    await asyncio.sleep(0.1)
    store = srv.broker.store

    m1 = await ch.basic_get("f_q1", no_ack=True)
    assert m1.body == b"shared"
    await asyncio.sleep(0.1)
    msgs = await store._submit(lambda db: db.execute("SELECT id FROM msgs").fetchall())
    assert len(msgs) == 1  # still referenced by f_q2

    m2 = await ch.basic_get("f_q2", no_ack=True)
    await asyncio.sleep(0.1)
    msgs = await store._submit(lambda db: db.execute("SELECT id FROM msgs").fetchall())
    assert msgs == []  # refcount hit zero -> blob deleted

    await c.close()
    await srv.stop()


async def test_flush_barrier_surfaces_covered_write_failure(db_path):
    """flush() is the confirm durability barrier: a fire-and-forget write
    that fails inside the batch must fail the barrier, not just a log line
    (otherwise a publisher confirm could paper over a lost persistent
    message)."""
    store = SqliteStore(db_path)
    await store.open()
    # fire-and-forget failing op (single statement against a missing table)
    bad = store._submit(
        lambda db: db.execute("INSERT INTO no_such_table VALUES (1)"),
        guard=False)
    bad.add_done_callback(lambda f: f.exception())  # consume, like store_bg
    with pytest.raises(Exception):
        await store.flush()
    # the store keeps working afterwards; a clean barrier passes
    await store.insert_message(StoredMessage(
        id=1, properties_raw=b"", body=b"x", exchange="", routing_key="q",
        refer_count=1))
    await store.flush()
    assert (await store.select_message(1)) is not None
    await store.close()


async def test_flush_idle_fast_path_surfaces_earlier_failure(db_path):
    """ADVICE r2: a fire-and-forget write that fails in a batch completing
    BEFORE flush() is called must still fail the next barrier — the idle
    fast path must not return an already-done success future over an
    unreported failure."""
    store = SqliteStore(db_path)
    await store.open()
    bad = store._submit(
        lambda db: db.execute("INSERT INTO no_such_table VALUES (1)"),
        guard=False)
    bad.add_done_callback(lambda f: f.exception())  # consume, like store_bg
    # let the failing batch fully complete so flush() takes the fast path
    for _ in range(50):
        await asyncio.sleep(0.01)
        if not store._pending and not store._batch_in_flight:
            break
    assert not store._pending and not store._batch_in_flight
    with pytest.raises(Exception):
        await store.flush()
    # reported once; the store keeps working and a clean barrier passes
    await store.flush()
    await store.close()


async def test_flush_attribution_two_confirm_publishers(db_path):
    """VERDICT r3 #6: with two confirm-mode connections, a store failure on
    B's insert must fail ONLY B's durability barrier — A gets a clean
    confirm, and A's barrier must not consume the failure report out from
    under B's (the round-3 consume-once scar)."""
    srv = await start_server(db_path)
    store = srv.broker.store
    orig_insert = store.insert_message_nowait

    def failing_insert(msg):
        if msg.routing_key == "qb":
            store._submit_nowait(
                lambda db: db.execute("INSERT INTO no_such_table VALUES (1)"))
            return
        orig_insert(msg)

    store.insert_message_nowait = failing_insert
    a = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    b = await AMQPClient.connect("127.0.0.1", srv.bound_port)
    cha = await a.channel()
    chb = await b.channel()
    await cha.confirm_select()
    await chb.confirm_select()
    await cha.queue_declare("qa", durable=True)
    await chb.queue_declare("qb", durable=True)

    # both publishes race into the same group-commit window
    chb.basic_publish(b"lost", routing_key="qb", properties=PERSISTENT)
    cha.basic_publish(b"kept", routing_key="qa", properties=PERSISTENT)

    # A's barrier covers only A's writes: clean confirm
    await cha.wait_unconfirmed_below(1, timeout=10)
    # B must never see a confirm for the lost message: its barrier raises
    # and the server drops the connection
    with pytest.raises(Exception):
        await chb.wait_unconfirmed_below(1, timeout=10)
    assert len(chb.unconfirmed) == 1  # the publish was never confirmed

    # A's message really is durable
    store.insert_message_nowait = orig_insert
    await a.close()
    await b.close()
    await srv.stop()
    srv2 = await start_server(db_path)
    c2 = await AMQPClient.connect("127.0.0.1", srv2.bound_port)
    ch2 = await c2.channel()
    got = await ch2.basic_get("qa", no_ack=True)
    assert got is not None and got.body == b"kept"
    await c2.close()
    await srv2.stop()


async def test_group_commit_batches_many_writes(db_path):
    """Writes enqueued in one tick commit together and all resolve."""
    store = SqliteStore(db_path)
    await store.open()
    futs = [store.insert_message(StoredMessage(
        id=i, properties_raw=b"", body=b"b", exchange="", routing_key="q",
        refer_count=1)) for i in range(500)]
    await asyncio.gather(*futs)
    for i in (0, 250, 499):
        assert (await store.select_message(i)) is not None
    await store.close()


# ---------------------------------------------------------------------------
# store API contract: metas strip bodies; MemoryStore writes are eager
# ---------------------------------------------------------------------------


async def test_select_message_metas_strips_bodies_for_any_backend(db_path):
    """select_message_metas must never return bodies: recovery counts on
    rebuilding deep backlogs without blob bytes in RAM, for every backend
    (the SQLite override also skips the blob read; the base default strips
    after the fact so third-party stores keep the contract)."""
    from chanamq_tpu_torch.store.memory import MemoryStore

    for store in (MemoryStore(), SqliteStore(db_path)):
        await store.open()
        await store.insert_message(StoredMessage(
            id=11, properties_raw=b"\x01", body=b"blob-bytes",
            exchange="ex", routing_key="rk", refer_count=1))
        metas = await store.select_message_metas([11])
        assert metas[11].body is None, type(store).__name__
        assert metas[11].refer_count == 1
        # and the stored row is untouched (stripping hit a copy)
        full = await store.select_message(11)
        assert full.body == b"blob-bytes", type(store).__name__
        await store.close()


async def test_memory_store_writes_apply_at_call_time():
    """MemoryStore writes take effect at call time (program order == store
    order, like SqliteStore._submit): a read issued with ZERO event-loop
    yields after a fire-and-forget write must see it — the broker's paged
    transient bodies depend on this (store_bg(insert) then an inline
    basic_get read)."""
    from chanamq_tpu_torch.store.memory import MemoryStore

    store = MemoryStore()
    await store.open()
    aw = store.insert_message(StoredMessage(
        id=5, properties_raw=b"", body=b"x", exchange="e",
        routing_key="r", refer_count=1))
    # no await of the write yet — read anyway
    got = await store.select_message(5)
    assert got is not None and got.body == b"x"
    await aw  # completed awaitable is still awaitable
    del_aw = store.delete_message(5)
    assert await store.select_message(5) is None
    await del_aw


async def test_store_synchronous_knob(tmp_path):
    """chana.mq.store.synchronous plumbs through config to the PRAGMA:
    FULL fsyncs every group commit (power-loss durability), NORMAL is the
    WAL default (process-crash durability). Bad values fail fast."""
    from chanamq_tpu_torch.config import Config
    from chanamq_tpu_torch.broker.server import BrokerServer

    cfg = Config({
        "chana.mq.store.path": str(tmp_path / "full.db"),
        "chana.mq.store.synchronous": "FULL",
        "chana.mq.amqp.port": 0,
        "chana.mq.router.device": "cpu",
    })
    srv = BrokerServer.from_config(cfg)
    await srv.start()
    assert srv.broker.store.synchronous == "FULL"
    # PRAGMA actually applied on the open connection (2 == FULL)
    level = await srv.broker.store._submit(
        lambda db: db.execute("PRAGMA synchronous").fetchone()[0])
    assert level == 2, level
    await srv.stop()

    with pytest.raises(ValueError):
        SqliteStore(str(tmp_path / "bad.db"), synchronous="SOMETIMES")


async def test_sigkill_crash_loop_loses_no_confirmed_message(tmp_path):
    """Single-node durability under repeated hard crashes: a confirm-mode
    publisher records every CONFIRMED persistent message; SIGKILL the broker
    process mid-flow three times; after the final recovery, every confirmed
    message is present exactly once, in order (confirms may lag — unconfirmed
    messages may or may not survive, but confirmed ones MUST)."""
    import signal
    import socket
    import subprocess
    import sys

    db = str(tmp_path / "crash.db")
    port_holder = {}

    async def start_broker():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-c", NODE, str(port), db],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for _ in range(150):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"broker died at startup (rc={proc.returncode})")
            try:
                _, w = await asyncio.open_connection("127.0.0.1", port)
                w.close()
                break
            except OSError:
                await asyncio.sleep(0.05)
        else:
            proc.kill()
            raise RuntimeError("broker never came up")
        port_holder["port"] = port
        return proc

    confirmed: list[int] = []
    seq = 0

    async def publish_some(n):
        """Publish n persistent messages; record exactly the seqs whose
        confirm arrived (tags are 1-based per fresh channel, and this
        broker never Basic.Nacks — a failed barrier hard-closes instead —
        so a tag absent from ch.unconfirmed IS a durable confirm)."""
        nonlocal seq
        c = await AMQPClient.connect("127.0.0.1", port_holder["port"])
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare("crash_q", durable=True)
        tag_to_seq = {}
        for _ in range(n):
            tag = ch.basic_publish(seq.to_bytes(8, "big"),
                                   routing_key="crash_q",
                                   properties=PERSISTENT)
            tag_to_seq[tag] = seq
            seq += 1
        try:
            await ch.wait_unconfirmed_below(1, timeout=10)
        except Exception:
            pass  # crash raced the confirms; count what actually arrived
        pending = set(ch.unconfirmed)
        confirmed.extend(s for t, s in tag_to_seq.items() if t not in pending)
        try:
            await c.close()
        except Exception:
            pass

    proc = await start_broker()
    try:
        for round_no in range(3):
            await publish_some(400)
            # crash mid-life: some publishes of the NEXT burst race the kill
            burst = asyncio.create_task(publish_some(200))
            await asyncio.sleep(0.05)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
            try:
                await asyncio.wait_for(burst, timeout=10)
            except asyncio.TimeoutError:
                burst.cancel()
            except (OSError, ConnectionError):
                pass  # connect lost the race with the kill: nothing published
            proc = await start_broker()
        # final recovery: drain and check every confirmed id is present
        # exactly once, in order
        c = await AMQPClient.connect("127.0.0.1", port_holder["port"])
        ch = await c.channel()
        got = []
        while True:
            m = await ch.basic_get("crash_q", no_ack=True)
            if m is None:
                break
            got.append(int.from_bytes(m.body, "big"))
        confirmed_set = set(confirmed)
        present = [g for g in got if g in confirmed_set]
        assert len(got) == len(set(got)), "duplicate delivery after recovery"
        assert confirmed_set.issubset(set(got)), (
            f"lost {sorted(confirmed_set - set(got))[:10]} confirmed messages")
        assert present == sorted(present), "confirmed messages out of order"
        await c.close()
    finally:
        try:
            proc.kill()
            proc.wait(timeout=5)
        except Exception:
            pass
