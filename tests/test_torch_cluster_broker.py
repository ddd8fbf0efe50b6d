"""Multi-node broker cluster tests: location transparency, remote consume,
metadata replication, and the HA contract (durable messages survive node
death by recovery from the shared store — reference README.md:47-49,
SURVEY.md §3.6).

The port's copy of ``tests/test_cluster_broker.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.

The two-process case boots the port's node
(``python -m chanamq_tpu_torch.broker.server``) with
``chana.mq.router.device`` ``cpu``.
"""

import asyncio

import pytest

from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster.node import ClusterNode
from chanamq_tpu_torch.store.sqlite import SqliteStore

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)


class Node:
    """One in-process broker node with its cluster extension."""

    def __init__(self, server: BrokerServer, cluster: ClusterNode) -> None:
        self.server = server
        self.cluster = cluster

    @property
    def port(self) -> int:
        return self.server.bound_port

    @property
    def name(self) -> str:
        return self.cluster.name

    async def stop(self) -> None:
        await self.cluster.stop()
        await self.server.stop()


async def start_node(store_path, seeds, failure_timeout_s=0.8) -> Node:
    server = BrokerServer(broker=Broker(store=SqliteStore(store_path), router_device="cpu"),
                          host="127.0.0.1", port=0, heartbeat_s=0)
    await server.start()
    cluster = ClusterNode(server.broker, "127.0.0.1", 0, seeds,
                          heartbeat_interval_s=0.1,
                          failure_timeout_s=failure_timeout_s)
    await cluster.start()
    return Node(server, cluster)


async def start_cluster(tmp_path, n=3, failure_timeout_s=0.8):
    """n nodes sharing one store file (the Cassandra-analogue shared store)."""
    store = str(tmp_path / "shared.db")
    first = await start_node(store, [], failure_timeout_s)
    nodes = [first]
    for _ in range(n - 1):
        nodes.append(await start_node(store, [first.name], failure_timeout_s))
    # wait for full membership convergence on every node
    for _ in range(100):
        if all(len(node.cluster.membership.alive_members()) == n for node in nodes):
            break
        await asyncio.sleep(0.05)
    assert all(len(node.cluster.membership.alive_members()) == n for node in nodes)
    return nodes


def owner_and_other(nodes, vhost, queue_name):
    owner_name = nodes[0].cluster.queue_owner(vhost, queue_name)
    owner = next(node for node in nodes if node.name == owner_name)
    other = next(node for node in nodes if node.name != owner_name)
    return owner, other


async def test_queue_ops_location_transparent(tmp_path):
    nodes = await start_cluster(tmp_path, 3)
    try:
        owner, other = owner_and_other(nodes, "/", "cq")
        # declare via a NON-owner node: proxied to the owner
        c = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await c.channel()
        ok = await ch.queue_declare("cq", durable=True)
        assert ok.queue == "cq"
        # the owner actually holds it
        assert "cq" in owner.server.broker.vhosts["/"].queues
        assert "cq" not in other.server.broker.vhosts["/"].queues

        # publish via yet another non-owner: routed + pushed over RPC
        ch.basic_publish(b"m1", routing_key="cq", properties=PERSISTENT)
        await asyncio.sleep(0.3)
        ok = await ch.queue_declare("cq", passive=True)
        assert ok.message_count == 1

        # basic.get through the non-owner fetches from the owner
        msg = await ch.basic_get("cq")
        assert msg.body == b"m1"
        ch.basic_ack(msg.delivery_tag)
        await asyncio.sleep(0.2)
        assert (await ch.queue_declare("cq", passive=True)).message_count == 0

        # purge + delete through the non-owner
        ch.basic_publish(b"m2", routing_key="cq")
        await asyncio.sleep(0.2)
        assert await ch.queue_purge("cq") == 1
        assert await ch.queue_delete("cq") == 0
        await asyncio.sleep(0.2)
        assert ("/," "cq") not in owner.cluster.queue_metas
        await c.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_remote_consume_streams_deliveries(tmp_path):
    nodes = await start_cluster(tmp_path, 2)
    try:
        owner, other = owner_and_other(nodes, "/", "stream_q")
        # consumer connects to the NON-owner node
        consumer_client = await AMQPClient.connect("127.0.0.1", other.port)
        cch = await consumer_client.channel()
        await cch.queue_declare("stream_q")
        got = []
        done = asyncio.get_event_loop().create_future()

        def on_msg(msg):
            got.append(msg)
            cch.basic_ack(msg.delivery_tag)
            if len(got) == 20 and not done.done():
                done.set_result(None)

        await cch.basic_consume("stream_q", on_msg)

        # producer connects to the OWNER node
        producer_client = await AMQPClient.connect("127.0.0.1", owner.port)
        pch = await producer_client.channel()
        for i in range(20):
            pch.basic_publish(f"s{i}".encode(), routing_key="stream_q")
        await asyncio.wait_for(done, 10)
        assert [m.body for m in got] == [f"s{i}".encode() for i in range(20)]
        # acks settled back to the owner: nothing outstanding
        await asyncio.sleep(0.3)
        queue = owner.server.broker.vhosts["/"].queues["stream_q"]
        assert len(queue.outstanding) == 0
        await producer_client.close()
        await consumer_client.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_exchange_metadata_replicated(tmp_path):
    nodes = await start_cluster(tmp_path, 3)
    try:
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.exchange_declare("reps", "topic", durable=True)
        await ch0.queue_declare("rep_q", durable=True)
        await ch0.queue_bind("rep_q", "reps", "a.#")
        await asyncio.sleep(0.3)
        # every node sees the exchange and the binding in its local matcher
        for node in nodes:
            vhost = node.server.broker.vhosts["/"]
            assert "reps" in vhost.exchanges
            assert vhost.exchanges["reps"].route("a.b") == {"rep_q"}
        # publish from the last node routes through its local matcher
        c2 = await AMQPClient.connect("127.0.0.1", nodes[2].port)
        ch2 = await c2.channel()
        ch2.basic_publish(b"routed", exchange="reps", routing_key="a.b.c",
                          properties=PERSISTENT)
        await asyncio.sleep(0.3)
        ok = await ch2.queue_declare("rep_q", passive=True)
        assert ok.message_count == 1
        await c0.close()
        await c2.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_failover_durable_messages_survive_node_death(tmp_path):
    """The HA contract: kill the owner under load; durable+persistent
    messages recover from the shared store on the new owner."""
    nodes = await start_cluster(tmp_path, 3)
    survivors = []
    try:
        owner, other = owner_and_other(nodes, "/", "ha_q")
        survivors = [n for n in nodes if n is not owner]
        c = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await c.channel()
        await ch.queue_declare("ha_q", durable=True)
        for i in range(10):
            ch.basic_publish(f"ha{i}".encode(), routing_key="ha_q",
                             properties=PERSISTENT)
        await asyncio.sleep(0.5)
        assert (await ch.queue_declare("ha_q", passive=True)).message_count == 10

        # kill the owner node (no clean shutdown of its queues)
        await owner.stop()
        # wait for the survivors to mark it down
        for _ in range(100):
            if all(owner.name not in s.cluster.membership.alive_members()
                   for s in survivors):
                break
            await asyncio.sleep(0.05)

        # the queue re-activates on its new owner from the shared store
        for _ in range(50):
            try:
                ok = await ch.queue_declare("ha_q", passive=True)
                if ok.message_count == 10:
                    break
            except Exception:
                ch = await c.channel()
            await asyncio.sleep(0.1)
        ok = await ch.queue_declare("ha_q", passive=True)
        assert ok.message_count == 10
        bodies = []
        for _ in range(10):
            msg = await ch.basic_get("ha_q", no_ack=True)
            bodies.append(msg.body)
        assert bodies == [f"ha{i}".encode() for i in range(10)]
        await c.close()
    finally:
        for node in survivors:
            await node.stop()


async def test_consumer_reregisters_after_owner_death(tmp_path):
    """A consumer attached via a surviving node keeps consuming after the
    queue's owner dies: the origin re-registers it with the new owner."""
    nodes = await start_cluster(tmp_path, 3)
    survivors = []
    try:
        owner, other = owner_and_other(nodes, "/", "resub_q")
        survivors = [n for n in nodes if n is not owner]
        c = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await c.channel()
        await ch.queue_declare("resub_q", durable=True)
        got = []

        def on_msg(msg):
            got.append(msg)
            ch.basic_ack(msg.delivery_tag)

        await ch.basic_consume("resub_q", on_msg)
        ch.basic_publish(b"before", routing_key="resub_q", properties=PERSISTENT)
        for _ in range(50):
            if got:
                break
            await asyncio.sleep(0.1)
        assert [m.body for m in got] == [b"before"]

        await owner.stop()
        for _ in range(100):
            if all(owner.name not in s.cluster.membership.alive_members()
                   for s in survivors):
                break
            await asyncio.sleep(0.05)
        # give re-registration a moment, then publish again via the origin
        await asyncio.sleep(1.0)
        ch.basic_publish(b"after", routing_key="resub_q", properties=PERSISTENT)
        for _ in range(100):
            if len(got) == 2:
                break
            await asyncio.sleep(0.1)
        assert [m.body for m in got] == [b"before", b"after"]
        await c.close()
    finally:
        for node in survivors:
            await node.stop()


async def test_cluster_worker_ids_unique(tmp_path):
    nodes = await start_cluster(tmp_path, 3)
    try:
        ids = {node.server.broker.idgen.worker_id for node in nodes}
        assert len(ids) == 3  # every node leased a distinct worker id
    finally:
        for node in nodes:
            await node.stop()


async def test_join_churn_no_loss_no_duplication(tmp_path):
    """A node JOINING under live durable traffic (ring reshuffle with no
    death): every published message is delivered exactly once and the
    consumer keeps consuming. The holder discipline makes this true — the
    serving node stays the routing target through the reshuffle instead of
    the new ring owner activating a second copy from the shared store
    (SURVEY.md §3.6 shard-rebalancing analogue).

    The failure timeout is raised to 3s for this test: node startup on a
    loaded single-core host can stall heartbeats past a 0.8s timeout,
    tripping the (by-design) spurious-failure path — this test is about
    the no-death reshuffle, the failover tests own the death path."""
    nodes = await start_cluster(tmp_path, 2, failure_timeout_s=3.0)
    joined = None
    try:
        c_prod = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        pch = await c_prod.channel()
        await pch.confirm_select()
        await pch.queue_declare("churn_q", durable=True)

        c_cons = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        cch = await c_cons.channel()
        got = []

        def on_msg(msg):
            got.append(bytes(msg.body))
            cch.basic_ack(msg.delivery_tag)

        await cch.basic_consume("churn_q", on_msg)

        total = 60
        published = 0

        async def publish_half(n):
            nonlocal published
            for _ in range(n):
                pch.basic_publish(b"c%03d" % published, routing_key="churn_q",
                                  properties=PERSISTENT)
                published += 1
                await asyncio.sleep(0.01)
            await pch.wait_unconfirmed_below(1, timeout=10)

        # spread of idle queues to evidence the reshuffle below (the
        # joiner takes ~1/3 of ring keys, so some of these must move)
        for i in range(16):
            await pch.queue_declare(f"spread_{i}", durable=True)
        serving_before = nodes[0].cluster.queue_owner("/", "churn_q")
        ring_before = {
            f"spread_{i}": nodes[0].cluster.ring.owner_entity(
                "q", "/", f"spread_{i}")
            for i in range(16)
        }

        # first half of the traffic on the 2-node ring
        await publish_half(total // 3)

        # a third node joins mid-traffic: ring reshuffles with no death
        store = str(tmp_path / "shared.db")
        join_task = asyncio.get_event_loop().create_task(
            start_node(store, [nodes[0].name], 3.0))
        await publish_half(total // 3)
        joined = await join_task
        # wait for 3-way membership convergence
        for _ in range(100):
            if all(len(n.cluster.membership.alive_members()) == 3
                   for n in (*nodes, joined)):
                break
            await asyncio.sleep(0.05)
        assert len(joined.cluster.membership.alive_members()) == 3

        # the ring really reshuffled (some idle queues moved to new owners)
        moved = [
            name for name, owner in ring_before.items()
            if nodes[0].cluster.ring.owner_entity("q", "/", name) != owner
        ]
        assert moved, "join did not reshuffle the ring — test is vacuous"
        # ...but the live traffic queue stays pinned to its serving node:
        # every node (including the joiner) routes churn_q to the holder
        await asyncio.sleep(0.3)  # let holder metas replicate to the joiner
        for node in (*nodes, joined):
            assert node.cluster.queue_owner("/", "churn_q") == serving_before

        # remaining traffic on the reshuffled ring
        await publish_half(total - published)

        for _ in range(200):
            if len(got) >= total:
                break
            await asyncio.sleep(0.05)
        expect = [b"c%03d" % i for i in range(total)]
        assert sorted(got) == expect, (
            f"lost={set(expect) - set(got)} dup={len(got) - len(set(got))}")
        assert got == expect  # FIFO order preserved across the join

        # and the queue is fully drained everywhere: no second copy holds
        # residual messages on any node
        await asyncio.sleep(0.3)
        for node in (*nodes, joined):
            vq = node.server.broker.vhosts["/"].queues.get("churn_q")
            if vq is not None:
                assert len(vq.messages) == 0 and len(vq.outstanding) == 0
        await c_prod.close()
        await c_cons.close()
    finally:
        for node in nodes:
            await node.stop()
        if joined is not None:
            await joined.stop()


async def test_pipelined_remote_publish_order_and_confirms(tmp_path):
    """Plain clustered publishes pipeline through one queue.push_many RPC
    per owner per read batch (broker.py _publish_clustered pending path):
    a burst published via a NON-owner must arrive complete and in order on
    the owner, publisher confirms must release only after the owner
    accepted the batch, and a mandatory publish mid-burst must drain the
    buffered pipeline first so per-queue FIFO holds."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        owner, other = owner_and_other(nodes, "/", "pipe_q")
        c = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare("pipe_q", durable=True)
        n = 400
        for i in range(n):
            if i == 200:
                # mandatory publish forces an inline remote push: the
                # buffered 0..199 must be drained before it goes out
                ch.basic_publish(b"m-%03d" % i, routing_key="pipe_q",
                                 properties=PERSISTENT, mandatory=True)
            else:
                ch.basic_publish(b"m-%03d" % i, routing_key="pipe_q",
                                 properties=PERSISTENT)
        await ch.wait_unconfirmed_below(1, timeout=60)
        q = owner.server.broker.vhosts["/"].queues["pipe_q"]
        assert len(q.messages) == n
        assert [qm.message.body for qm in q.messages] == \
            [b"m-%03d" % i for i in range(n)]

        # consume from the owner side: everything flows back out in order
        c2 = await AMQPClient.connect("127.0.0.1", owner.port)
        ch2 = await c2.channel()
        got, done = [], asyncio.get_event_loop().create_future()

        def cb(m):
            got.append(m.body)
            ch2.basic_ack(m.delivery_tag)
            if len(got) >= n and not done.done():
                done.set_result(None)

        await ch2.basic_consume("pipe_q", cb)
        await asyncio.wait_for(done, 30)
        assert got == [b"m-%03d" % i for i in range(n)]
        await c2.close()
        await c.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_remote_ack_then_cancel_not_inverted(tmp_path):
    """Settle coalescing (cluster/node.py settle_bg) must never let a
    cancel overtake an ack buffered in the same read batch: the owner
    would requeue the just-acked delivery and redeliver it. The drain-
    before-RPC rule in ClusterNode._call pins the order."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        owner, other = owner_and_other(nodes, "/", "ac_q")
        c = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await c.channel()
        await ch.queue_declare("ac_q")
        cp = await AMQPClient.connect("127.0.0.1", owner.port)
        chp = await cp.channel()
        await chp.confirm_select()

        got, first = [], asyncio.get_event_loop().create_future()

        def cb(m):
            got.append(m)
            if not first.done():
                first.set_result(None)

        await ch.basic_consume("ac_q", cb)
        chp.basic_publish(b"only", routing_key="ac_q")
        await chp.wait_unconfirmed_below(1)
        await asyncio.wait_for(first, 15)
        ch.basic_ack(got[0].delivery_tag)
        await ch.basic_cancel(got[0].consumer_tag)
        await asyncio.sleep(0.5)
        q = owner.server.broker.vhosts["/"].queues["ac_q"]
        assert not q.outstanding
        assert len(q.messages) == 0
        assert await ch.basic_get("ac_q", no_ack=True) is None
        await c.close()
        await cp.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_two_process_cluster_end_to_end(tmp_path):
    """The full multi-host shape, no in-process shortcuts: two REAL broker
    processes booted from config (run_node: AMQP listener + cluster layer),
    gossiping over real sockets, sharing one store. A client on node A
    publishes into a queue owned by whichever node the ring picks; a client
    on the OTHER node consumes it all back. Validates the config-driven
    cluster wiring (server.from_config + ClusterNode seeds) that the
    in-process tests bypass."""
    import json as jsonlib
    import socket
    import subprocess
    import sys

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    store = str(tmp_path / "shared.db")
    a_amqp, a_cluster = free_port(), free_port()
    b_amqp, b_cluster = free_port(), free_port()

    a_admin, b_admin = free_port(), free_port()

    def node_cfg(amqp_port, cluster_port, admin_port, seeds):
        return {
            "chana.mq.amqp.interface": "127.0.0.1",
            "chana.mq.amqp.port": amqp_port,
            "chana.mq.admin.enabled": True,
            "chana.mq.admin.interface": "127.0.0.1",
            "chana.mq.admin.port": admin_port,
            "chana.mq.store.path": store,
            "chana.mq.cluster.enabled": True,
            "chana.mq.cluster.host": "127.0.0.1",
            "chana.mq.cluster.port": cluster_port,
            "chana.mq.cluster.seeds": seeds,
            "chana.mq.cluster.heartbeat-interval": "200ms",
            "chana.mq.cluster.failure-timeout": "5s",
            "chana.mq.router.device": "cpu",
        }

    async def admin_cluster(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /admin/cluster HTTP/1.1\r\nHost: x\r\n\r\n")
        # the admin server closes after responding: read to EOF
        raw = await asyncio.wait_for(reader.read(-1), 5)
        writer.close()
        return jsonlib.loads(raw.partition(b"\r\n\r\n")[2])

    procs = []
    logs = []
    try:
        for amqp_port, cluster_port, admin_port, seeds in (
                (a_amqp, a_cluster, a_admin, []),
                (b_amqp, b_cluster, b_admin, [f"127.0.0.1:{a_cluster}"])):
            cfg_path = tmp_path / f"node{amqp_port}.json"
            cfg_path.write_text(jsonlib.dumps(
                node_cfg(amqp_port, cluster_port, admin_port, seeds)))
            log_file = open(tmp_path / f"node{amqp_port}.log", "w")
            logs.append(log_file)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
                 "--config", str(cfg_path), "--log-level", "WARNING"],
                stdout=log_file, stderr=subprocess.STDOUT))

        def check_alive():
            from pathlib import Path

            for proc, log_file in zip(procs, logs):
                if proc.poll() is not None:
                    log_file.flush()
                    tail = Path(log_file.name).read_text()[-1500:]
                    raise RuntimeError(
                        f"node died rc={proc.returncode}: {tail}")

        # converge: both processes report 2 alive members over admin HTTP
        for _ in range(150):
            check_alive()
            try:
                va = await admin_cluster(a_admin)
                vb = await admin_cluster(b_admin)
                if (va.get("enabled") and vb.get("enabled")
                        and len(va["alive"]) == 2 and len(vb["alive"]) == 2):
                    break
            except (OSError, ValueError, asyncio.TimeoutError):
                pass
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError("2-process membership never converged")

        ca = await AMQPClient.connect("127.0.0.1", a_amqp)
        cha = await ca.channel()
        await cha.confirm_select()
        await cha.queue_declare("xp_q", durable=True)
        # queue metadata replicates asynchronously: wait until BOTH nodes
        # know the queue before the second client touches it
        for _ in range(100):
            va = await admin_cluster(a_admin)
            vb = await admin_cluster(b_admin)
            if va.get("known_queues") and vb.get("known_queues"):
                break
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError("queue metadata never replicated to B")
        cb = await AMQPClient.connect("127.0.0.1", b_amqp)
        chb = await cb.channel()
        await chb.queue_declare("xp_q", durable=True)

        n = 200
        for i in range(n):
            cha.basic_publish(b"xp-%03d" % i, routing_key="xp_q",
                              properties=PERSISTENT)
        await cha.wait_unconfirmed_below(1, timeout=60)

        got, done = [], asyncio.get_event_loop().create_future()

        def cb_msg(m):
            got.append(m.body)
            chb.basic_ack(m.delivery_tag)
            if len(got) >= n and not done.done():
                done.set_result(None)

        await chb.basic_consume("xp_q", cb_msg)
        await asyncio.wait_for(done, 60)
        assert got == [b"xp-%03d" % i for i in range(n)]
        await ca.close()
        await cb.close()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        for log_file in logs:
            log_file.close()


async def test_origin_death_requeues_outstanding(tmp_path):
    """A remote consumer's ORIGIN node dies with deliveries unacked: the
    owner's membership down-event must requeue them
    (ClusterNode._drop_origin_consumers) so a consumer elsewhere gets
    every message — nothing stays stuck outstanding."""
    nodes = await start_cluster(tmp_path, 3)
    try:
        owner, _ = owner_and_other(nodes, "/", "org_q")
        origin = next(n for n in nodes if n.name != owner.name)
        third = next(n for n in nodes
                     if n.name not in (owner.name, origin.name))

        c_prod = await AMQPClient.connect("127.0.0.1", owner.port)
        chp = await c_prod.channel()
        await chp.confirm_select()
        await chp.queue_declare("org_q", durable=True)
        c_cons = await AMQPClient.connect("127.0.0.1", origin.port)
        chc = await c_cons.channel()
        got = []
        await chc.basic_consume("org_q", lambda m: got.append(m))  # no acks
        for i in range(12):
            chp.basic_publish(b"o-%02d" % i, routing_key="org_q",
                              properties=PERSISTENT)
        await chp.wait_unconfirmed_below(1)
        for _ in range(100):
            if len(got) >= 12:
                break
            await asyncio.sleep(0.05)
        assert len(got) == 12  # all delivered to the doomed origin, unacked

        await origin.stop()  # origin dies with everything outstanding
        q = owner.server.broker.vhosts["/"].queues["org_q"]
        for _ in range(200):
            if not q.outstanding and len(q.messages) == 12:
                break
            await asyncio.sleep(0.05)
        assert not q.outstanding
        assert len(q.messages) == 12  # requeued, redelivery-ready

        c2 = await AMQPClient.connect("127.0.0.1", third.port)
        ch2 = await c2.channel()
        got2, done = [], asyncio.get_event_loop().create_future()

        def cb(m):
            got2.append(m.body)
            ch2.basic_ack(m.delivery_tag)
            if len(got2) >= 12 and not done.done():
                done.set_result(None)

        await ch2.basic_consume("org_q", cb)
        await asyncio.wait_for(done, 30)
        assert sorted(got2) == [b"o-%02d" % i for i in range(12)]
        await c_prod.close()
        await c2.close()
    finally:
        for node in nodes:
            try:
                await node.stop()
            except Exception:
                pass


async def test_double_failover_zero_loss(tmp_path):
    """Kill the queue's owner TWICE in succession (each time re-resolving
    the new owner from the ring): every confirmed persistent message must
    survive both failovers via shared-store recovery and drain completely
    from the last survivor."""
    nodes = await start_cluster(tmp_path, 3)
    live = list(nodes)
    total = 0
    try:
        for wave in range(2):
            owner_name = live[0].cluster.queue_owner("/", "drill_q")
            owner = next(n for n in live if n.name == owner_name)
            survivor = next(n for n in live if n.name != owner_name)
            c = await AMQPClient.connect("127.0.0.1", survivor.port)
            ch = await c.channel()
            await ch.confirm_select()
            await ch.queue_declare("drill_q", durable=True)
            for i in range(50):
                ch.basic_publish(b"w%d-%02d" % (wave, i),
                                 routing_key="drill_q", properties=PERSISTENT)
            await ch.wait_unconfirmed_below(1)
            total += 50
            await c.close()
            await owner.stop()
            live.remove(owner)
            for _ in range(100):
                if all(owner_name not in n.cluster.membership.alive_members()
                       for n in live):
                    break
                await asyncio.sleep(0.05)
            c = await AMQPClient.connect("127.0.0.1", live[0].port)
            ch = await c.channel()
            ok = None
            for _ in range(100):
                try:
                    ok = await ch.queue_declare("drill_q", passive=True)
                    if ok.message_count == total:
                        break
                except Exception:
                    ch = await c.channel()
                await asyncio.sleep(0.1)
            assert ok is not None and ok.message_count == total
            await c.close()

        c = await AMQPClient.connect("127.0.0.1", live[0].port)
        ch = await c.channel()
        got = 0
        while True:
            m = await ch.basic_get("drill_q")
            if m is None:
                break
            ch.basic_ack(m.delivery_tag)
            got += 1
        assert got == total
        await c.close()
    finally:
        for node in live:
            try:
                await node.stop()
            except Exception:
                pass


async def test_exchange_to_exchange_binds_replicated(tmp_path):
    """e2e bindings replicate cluster-wide (exbind meta events + the join
    snapshot): a publish entering at any node routes through the full
    exchange graph, and unbind replicates too."""
    nodes = await start_cluster(tmp_path, 3)
    try:
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.exchange_declare("g_src", "direct", durable=True)
        await ch0.exchange_declare("g_dst", "fanout", durable=True)
        await ch0.queue_declare("g_q", durable=True)
        await ch0.exchange_bind("g_dst", "g_src", "k")
        await ch0.queue_bind("g_q", "g_dst", "")
        await asyncio.sleep(0.3)
        # every node's local routing sees the graph
        for node in nodes:
            vhost = node.server.broker.vhosts["/"]
            assert vhost.route("g_src", "k") == {"g_q"}, node.name
        # publish entering at node 2 flows through the replicated graph
        c2 = await AMQPClient.connect("127.0.0.1", nodes[2].port)
        ch2 = await c2.channel()
        ch2.basic_publish(b"graph", exchange="g_src", routing_key="k",
                          properties=PERSISTENT)
        await asyncio.sleep(0.3)
        ok = await ch2.queue_declare("g_q", passive=True)
        assert ok.message_count == 1
        # unbind replicates: post-unbind publishes route nowhere
        await ch0.exchange_unbind("g_dst", "g_src", "k")
        await asyncio.sleep(0.3)
        for node in nodes:
            vhost = node.server.broker.vhosts["/"]
            assert vhost.route("g_src", "k") == set(), node.name
        # a node joining AFTER the bind existed learns it from the snapshot
        await ch0.exchange_bind("g_dst", "g_src", "k2")
        await asyncio.sleep(0.3)
        joiner = await start_node(str(tmp_path / "shared.db"), [nodes[0].name])
        nodes.append(joiner)
        await asyncio.sleep(0.5)
        vhost = joiner.server.broker.vhosts["/"]
        assert vhost.route("g_src", "k2") == {"g_q"}
        await c0.close()
        await c2.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_remote_consumer_cancel_notify_on_queue_delete(tmp_path):
    """Owner-side queue death under a remote consumer propagates a
    consumer.cancelled event to the origin, which deregisters the stub and
    sends the client a Basic.Cancel."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        # find a queue name owned by node 1 so node 0 consumes remotely
        name = None
        for i in range(100):
            cand = f"rccn_q{i}"
            if nodes[0].cluster.queue_owner("/", cand) == nodes[1].name:
                name = cand
                break
        assert name is not None
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.queue_declare(name, durable=True)
        tag = await ch0.basic_consume(name, lambda m: None)
        await asyncio.sleep(0.2)
        # delete via the owner node directly
        c1 = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        ch1 = await c1.channel()
        await ch1.queue_delete(name)
        for _ in range(100):
            if ch0.cancelled_consumers:
                break
            await asyncio.sleep(0.02)
        assert ch0.cancelled_consumers == [tag]
        await c0.close()
        await c1.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_tx_commit_over_remotely_owned_queue(tmp_path):
    """tx.commit replays publishes into remotely-owned queues through the
    pipelined push path and CommitOk arrives only after the owner accepted
    them (strict barrier)."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        name = None
        for i in range(100):
            cand = f"txc_q{i}"
            if nodes[0].cluster.queue_owner("/", cand) == nodes[1].name:
                name = cand
                break
        assert name is not None
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.queue_declare(name, durable=True)
        await ch0.tx_select()
        for i in range(20):
            ch0.basic_publish(b"tx%02d" % i, routing_key=name,
                              properties=PERSISTENT)
        # buffered: owner sees nothing yet
        c1 = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        ch1 = await c1.channel()
        ok = await ch1.queue_declare(name, passive=True)
        assert ok.message_count == 0
        await ch0.tx_commit()
        ok = await ch1.queue_declare(name, passive=True)
        assert ok.message_count == 20
        # rollback path drops cleanly too
        ch0.basic_publish(b"never", routing_key=name, properties=PERSISTENT)
        await ch0.tx_rollback()
        ok = await ch1.queue_declare(name, passive=True)
        assert ok.message_count == 20
        got = await ch1.basic_get(name, no_ack=True)
        assert got is not None and got.body == b"tx00"
        await c0.close()
        await c1.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_remote_consumer_priority_honored_by_owner(tmp_path):
    """x-priority forwarded over the consume RPC: the owner's dispatch
    prefers the remote high-priority consumer over a local default one."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        name = None
        for i in range(100):
            cand = f"prio_rc_q{i}"
            if nodes[0].cluster.queue_owner("/", cand) == nodes[1].name:
                name = cand
                break
        assert name is not None
        # origin-side high-priority consumer (remote to the owner)
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.queue_declare(name, durable=True)
        hi_got, lo_got = [], []
        await ch0.basic_consume(name, hi_got.append, no_ack=True,
                                arguments={"x-priority": 7})
        # owner-local default-priority consumer
        c1 = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        ch1 = await c1.channel()
        await ch1.basic_consume(name, lo_got.append, no_ack=True)
        await asyncio.sleep(0.2)
        for i in range(8):
            ch1.basic_publish(b"p%d" % i, routing_key=name,
                              properties=PERSISTENT)
        await asyncio.sleep(0.5)
        # the remote high-priority consumer (credit window >> 8) gets all
        assert len(hi_got) == 8, (len(hi_got), len(lo_got))
        assert lo_got == []
        await c0.close()
        await c1.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_alternate_exchange_to_default_reaches_remote_queue(tmp_path):
    """AE "" fallback must see clustered queues that exist on the publishing
    node only as replicated metadata (the default-exchange implicit binding
    consults cluster.queue_metas, not just local queues)."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        name = None
        for i in range(100):
            cand = f"ae_remote_q{i}"
            if nodes[0].cluster.queue_owner("/", cand) == nodes[1].name:
                name = cand
                break
        assert name is not None
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.queue_declare(name, durable=True)
        await ch0.exchange_declare("ae_cluster_ex", "direct", arguments={
            "alternate-exchange": ""})
        await asyncio.sleep(0.2)
        # unroutable on the exchange; the AE "" must route by queue name to
        # the node-1-owned queue
        ch0.basic_publish(b"fell-to-remote", exchange="ae_cluster_ex",
                          routing_key=name, properties=PERSISTENT)
        await asyncio.sleep(0.4)
        c1 = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        ch1 = await c1.channel()
        ok = await ch1.queue_declare(name, passive=True)
        assert ok.message_count == 1
        got = await ch1.basic_get(name, no_ack=True)
        assert got is not None and got.body == b"fell-to-remote"
        await c0.close()
        await c1.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_priority_queue_ordering_on_remote_owner(tmp_path):
    """x-max-priority replicates with the queue metadata: publishes routed
    to a remote owner are ordered by priority there, and a consumer on the
    origin node receives them highest-first."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        name = None
        for i in range(100):
            cand = f"pr_rc_q{i}"
            if nodes[0].cluster.queue_owner("/", cand) == nodes[1].name:
                name = cand
                break
        assert name is not None
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.queue_declare(name, durable=True,
                                arguments={"x-max-priority": 9})
        await asyncio.sleep(0.2)
        for body, p in ((b"low-a", 1), (b"high-a", 9), (b"low-b", 1),
                        (b"high-b", 9)):
            ch0.basic_publish(body, routing_key=name, properties=BasicProperties(
                priority=p, delivery_mode=2))
        # ordering barrier via the owner
        c1 = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        ch1 = await c1.channel()
        for _ in range(100):
            ok = await ch1.queue_declare(name, passive=True)
            if ok.message_count == 4:
                break
            await asyncio.sleep(0.02)
        assert ok.message_count == 4
        got = []
        done = asyncio.get_event_loop().create_future()

        def cb(m):
            got.append(m.body)
            if len(got) == 4 and not done.done():
                done.set_result(None)

        await ch0.basic_consume(name, cb, no_ack=True)
        await asyncio.wait_for(done, 10)
        assert got == [b"high-a", b"high-b", b"low-a", b"low-b"]
        await c0.close()
        await c1.close()
    finally:
        for node in nodes:
            await node.stop()


async def test_ack_timeout_fires_for_remote_consumers(tmp_path):
    """The ack-timeout sweep walks channel unacked maps, so a stuck
    consumer of a REMOTELY-owned queue is timed out by its origin node
    like any local consumer."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        for node in nodes:
            node.server.broker.consumer_timeout_ms = 400
        name = None
        for i in range(100):
            cand = f"at_rc_q{i}"
            if nodes[0].cluster.queue_owner("/", cand) == nodes[1].name:
                name = cand
                break
        assert name is not None
        c0 = await AMQPClient.connect("127.0.0.1", nodes[0].port)
        ch0 = await c0.channel()
        await ch0.queue_declare(name, durable=True)
        got = []
        await ch0.basic_consume(name, got.append)  # never acks
        ch0.basic_publish(b"stuck-remote", routing_key=name,
                          properties=PERSISTENT)
        for _ in range(100):
            if got:
                break
            await asyncio.sleep(0.02)
        assert got, "remote delivery never arrived"
        # origin sweep (1s default interval) times the channel out
        from chanamq_tpu_torch.client.client import ChannelClosedError

        err = None
        for _ in range(120):
            try:
                await ch0.queue_declare(name, passive=True)
            except ChannelClosedError as exc:
                err = exc
                break
            await asyncio.sleep(0.05)
        assert err is not None and err.reply_code == 406, err
        await c0.close()
    finally:
        for node in nodes:
            await node.stop()
