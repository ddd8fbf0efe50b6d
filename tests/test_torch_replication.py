"""Queue replication (chanamq_tpu_torch/replicate/): owner-side log sequencing
and batch framing, follower-side gap-triggered resync, and the end-to-end
failover contract — with chana.mq.replicate.factor=2 + sync=true on
PRIVATE per-node stores (nothing shared), killing the owner mid
publish/consume loses no confirmed persistent message, the surviving
replica promotes, and the consumer resumes.

The port's copy of ``tests/test_replication.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import json

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster.hashring import HashRing
from chanamq_tpu_torch.cluster.node import ClusterNode
from chanamq_tpu_torch.replicate import QueueRepLog, ReplicationManager
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.store.api import replica_vhost
from chanamq_tpu_torch.store.memory import MemoryStore
from chanamq_tpu_torch.utils.metrics import Metrics

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)


# ---------------------------------------------------------------------------
# fakes for unit-level tests (no sockets: the manager/applier only see
# duck-typed node/membership/client objects)
# ---------------------------------------------------------------------------


class FakeBroker:
    def __init__(self):
        self.store = MemoryStore()
        self.metrics = Metrics()
        self.vhosts = {}

    def store_bg(self, aw):
        pass  # MemoryStore writes apply at call time; the handle is inert


class FakeRpc:
    def __init__(self):
        self.handlers = {}

    def register(self, method, handler):
        self.handlers[method] = handler


class FakeMembership:
    def __init__(self, alive):
        self.alive = set(alive)
        self.clients = {}

    def is_alive(self, name):
        return name in self.alive

    def alive_members(self):
        return sorted(self.alive)

    def client(self, name):
        return self.clients[name]


class FakeClient:
    """Records repl.* calls; replies are canned per method."""

    def __init__(self):
        self.calls = []
        self.replies = {}

    async def call(self, method, payload, timeout_s=None):
        self.calls.append((method, payload))
        reply = self.replies.get(method)
        if callable(reply):
            return reply(payload)
        if reply is None:
            raise AssertionError(f"unexpected rpc {method}")
        return reply


class FakeNode:
    def __init__(self, name="n1", alive=("n1", "n2")):
        self.name = name
        self.broker = FakeBroker()
        self.rpc = FakeRpc()
        self.ring = HashRing(list(alive), 8)
        self.membership = FakeMembership(alive)
        self.epochs = {}

    def queue_epoch(self, vhost, name):
        return self.epochs.get((vhost, name), 0)


def make_manager(**kw):
    node = FakeNode()
    kw.setdefault("factor", 2)
    manager = ReplicationManager(node, **kw)
    return node, manager


# ---------------------------------------------------------------------------
# unit: log sequencing
# ---------------------------------------------------------------------------


async def test_log_sequencing_and_lag():
    node, manager = make_manager()
    log = QueueRepLog("/", "q", manager)
    log.followers["n2"] = 0
    node.membership.clients["n2"] = client = FakeClient()
    client.replies["repl.append"] = lambda p: {
        "applied": p["events"][-1]["s"]}
    for i in range(5):
        log.append("watermark", {"wm": i})
    # sequences are assigned monotonically from 1 in append order
    assert log.seq == 5
    for _ in range(100):
        if not log.pending and (log._ship_task is None or log._ship_task.done()):
            break
        await asyncio.sleep(0.01)
    seqs = [e["s"] for _m, p in client.calls for e in p["events"]]
    assert seqs == [1, 2, 3, 4, 5]
    assert log.followers["n2"] == 5
    assert log.live_ack_floor() == 5 and log.lag() == 0
    # a dead follower stops counting against the floor
    log.followers["n2"] = 2
    assert log.lag() == 3
    node.membership.alive.discard("n2")
    assert log.lag() == 0


# ---------------------------------------------------------------------------
# unit: batch framing
# ---------------------------------------------------------------------------


async def test_batch_framing_respects_batch_max():
    node, manager = make_manager(batch_max=4)
    log = QueueRepLog("/", "q", manager)
    log.followers["n2"] = 0
    node.membership.clients["n2"] = client = FakeClient()
    client.replies["repl.append"] = lambda p: {
        "applied": p["events"][-1]["s"]}
    # append everything before the ship task gets a tick: one burst
    for i in range(10):
        log.append("watermark", {"wm": i})
    for _ in range(100):
        if log.followers["n2"] == 10:
            break
        await asyncio.sleep(0.01)
    batches = [p for m, p in client.calls if m == "repl.append"]
    assert [len(p["events"]) for p in batches] == [4, 4, 2]
    # frames are contiguous: each base is the previous batch's end + 1
    assert [p["base"] for p in batches] == [1, 5, 9]
    for p in batches:
        assert p["owner"] == "n1" and p["vhost"] == "/" and p["queue"] == "q"
        assert [e["s"] for e in p["events"]] == list(
            range(p["base"], p["base"] + len(p["events"])))
    assert node.broker.metrics.repl_batches_shipped == 3
    assert node.broker.metrics.repl_events_shipped == 10


# ---------------------------------------------------------------------------
# unit: gap triggers resync from the owner's store
# ---------------------------------------------------------------------------


async def test_gap_triggers_resync():
    node, manager = make_manager()
    applier = manager.applier
    owner_client = FakeClient()
    node.membership.clients["owner"] = owner_client
    node.membership.alive.add("owner")

    # in-sequence batch applies cleanly
    reply = await applier.h_append({
        "vhost": "/", "queue": "q", "owner": "owner", "base": 1,
        "events": [
            {"s": 1, "op": "enqueue", "o": 1, "m": 11, "z": 3, "e": None,
             "body": b"abc", "props": b"", "ex": "", "rk": "", "ttl": None},
        ],
        "acks": {},
    })
    assert reply == {"applied": 1}
    copy = applier.copies[("/", "q")]
    assert copy.rows == {1: (11, 3, None)}

    # the owner's store snapshot the gapped follower will pull
    # snapshot covers everything through seq 5 (the store reflects all the
    # events this follower missed; the owner reports its current head)
    owner_client.replies["repl.resync"] = {
        "seq": 5, "durable": True, "ttl": None, "args": "{}", "wm": 1,
        "rows": [[2, 22, 3, None], [3, 33, 3, None]], "more": False,
        "unacks": [[11, 1, 3, None]],
    }
    owner_client.replies["repl.fetch"] = lambda p: {
        "msgs": [[mid, b"", b"blob", "", "", None] for mid in p["ids"]]}

    # gapped batch (base 6 > applied 1 + 1): buffered, resync kicks off
    reply = await applier.h_append({
        "vhost": "/", "queue": "q", "owner": "owner", "base": 6,
        "events": [{"s": 6, "op": "watermark", "wm": 2}],
        "acks": {},
    })
    assert reply == {"applied": 1}
    for _ in range(200):
        if not copy.resyncing and copy.applied_seq >= 6:
            break
        await asyncio.sleep(0.01)
    # snapshot installed at seq 5, then the buffered batch replayed on top
    assert copy.applied_seq == 6
    assert copy.unacks == {11: (1, 3, None)}
    assert copy.wm == 2
    assert copy.rows == {3: (33, 3, None)}  # row 2 consumed by wm=2
    assert node.broker.metrics.repl_resyncs == 1
    assert any(m == "repl.resync" for m, _ in owner_client.calls)
    # the replica namespace holds the warm copy in the local store
    sq = await node.broker.store.select_queue(replica_vhost("/"), "q")
    assert sq is not None and sq.last_consumed == 2
    # replica namespaces stay invisible to recovery
    assert await node.broker.store.all_queues() == []


async def test_owner_change_discards_stale_copy():
    node, manager = make_manager()
    applier = manager.applier
    await applier.h_append({
        "vhost": "/", "queue": "q", "owner": "a", "base": 1,
        "events": [
            {"s": 1, "op": "enqueue", "o": 1, "m": 5, "z": 1, "e": None,
             "body": b"x", "props": b"", "ex": "", "rk": "", "ttl": None}],
        "acks": {},
    })
    assert applier.copies[("/", "q")].owner == "a"
    # a batch from a different owner supersedes the old copy wholesale
    await applier.h_append({
        "vhost": "/", "queue": "q", "owner": "b", "base": 1,
        "events": [{"s": 1, "op": "meta", "durable": True, "ttl": None,
                    "args": "{}", "wm": 0, "backlog": 0}],
        "acks": {},
    })
    copy = applier.copies[("/", "q")]
    assert copy.owner == "b" and copy.rows == {} and copy.applied_seq == 1


# ---------------------------------------------------------------------------
# end-to-end: failover promotion with zero confirmed-message loss
# ---------------------------------------------------------------------------


class Node:
    def __init__(self, server, cluster):
        self.server = server
        self.cluster = cluster

    @property
    def port(self):
        return self.server.bound_port

    @property
    def name(self):
        return self.cluster.name

    async def stop(self):
        await self.cluster.stop()
        await self.server.stop()


async def start_node(seeds):
    """One in-process node with a PRIVATE MemoryStore: surviving the
    owner's death then proves replication, not shared-store recovery."""
    server = BrokerServer(broker=Broker(store=MemoryStore(), router_device="cpu"),
                          host="127.0.0.1", port=0, heartbeat_s=0)
    await server.start()
    cluster = ClusterNode(server.broker, "127.0.0.1", 0, seeds,
                          heartbeat_interval_s=0.1, failure_timeout_s=0.8,
                          replicate_factor=2, replicate_sync=True,
                          replicate_ack_timeout_ms=2000)
    await cluster.start()
    return Node(server, cluster)


async def admin_get(broker, path):
    admin = AdminServer(broker, port=0)
    await admin.start()
    try:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", admin.bound_port)
        writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 5)
        writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        assert b"200 OK" in head.splitlines()[0]
        return json.loads(body)
    finally:
        await admin.stop()


async def test_failover_promotion_zero_confirmed_loss():
    total = 30
    first = await start_node([])
    second = await start_node([first.name])
    nodes = [first, second]
    for _ in range(100):
        if all(len(n.cluster.membership.alive_members()) == 2 for n in nodes):
            break
        await asyncio.sleep(0.05)
    try:
        owner_name = first.cluster.queue_owner("/", "ha_q")
        owner = next(n for n in nodes if n.name == owner_name)
        survivor = next(n for n in nodes if n.name != owner_name)

        # client rides the SURVIVOR so it outlives the owner
        client = await AMQPClient.connect("127.0.0.1", survivor.port)
        ch = await client.channel()
        await ch.confirm_select()
        await ch.queue_declare("ha_q", durable=True)

        got = {}
        done = asyncio.get_event_loop().create_future()

        def on_msg(msg):
            got[bytes(msg.body)] = None
            ch.basic_ack(msg.delivery_tag)
            if len(got) == total and not done.done():
                done.set_result(None)

        await ch.basic_consume("ha_q", on_msg)

        # publish the first half and require every confirm before the kill:
        # with sync=true a released confirm means the replica acked
        for i in range(total // 2):
            ch.basic_publish(b"m%02d" % i, routing_key="ha_q",
                             properties=PERSISTENT)
        await ch.wait_unconfirmed_below(1, timeout=30)

        # the survivor's warm copy is visible through /admin/replication
        status = await admin_get(survivor.server.broker, "/admin/replication")
        entry = status["queues"]["//ha_q"]
        if entry.get("role") == "follower":
            assert entry["applied_seq"] > 0
        owner_status = await admin_get(
            owner.server.broker, "/admin/replication")
        owner_entry = owner_status["queues"]["//ha_q"]
        assert owner_entry["role"] == "owner"
        assert survivor.name in owner_entry["followers"]
        assert "lag" in owner_entry

        # kill the owner mid-consume (deliveries are in flight, some unacked)
        await owner.stop()

        # wait for failure detection + promotion on the survivor (a publish
        # into the not-yet-detected window would tear the connection down on
        # the escalated remote-push failure, as the confirm contract demands)
        for _ in range(200):
            if (owner.name not in survivor.cluster.membership.alive_members()
                    and survivor.server.broker.metrics.repl_promotions == 1
                    and "ha_q" in survivor.server.broker.vhosts["/"].queues):
                break
            await asyncio.sleep(0.05)
        assert survivor.server.broker.metrics.repl_promotions == 1

        # publish the second half through the survivor, now the owner
        for i in range(total // 2, total):
            ch.basic_publish(b"m%02d" % i, routing_key="ha_q",
                             properties=PERSISTENT)
        await asyncio.wait_for(done, 30)
        # zero loss: every confirmed persistent message was delivered
        assert sorted(got) == [b"m%02d" % i for i in range(total)]
        await ch.wait_unconfirmed_below(1, timeout=30)

        assert survivor.server.broker.metrics.repl_promotions == 1
        status = await admin_get(survivor.server.broker, "/admin/replication")
        assert status["queues"]["//ha_q"]["role"] == "owner"
        # drained queue: nothing outstanding on the promoted copy
        await asyncio.sleep(0.3)
        queue = survivor.server.broker.vhosts["/"].queues["ha_q"]
        assert len(queue.messages) == 0 and len(queue.outstanding) == 0
        await client.close()
    finally:
        for node in nodes:
            try:
                await node.stop()
            except Exception:
                pass
