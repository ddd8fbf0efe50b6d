"""Where the port's cluster layer differs from the reference's copy.

- A clustered port node routes its fused publishes through its router in
  batches (the reference's clustered node routes each publish through its
  matchers, so its router never runs): the same routed sets, per-queue
  counts and delivery order as the oracle, with router batches counted.
- Snowflake worker ids stay distinct with private stores. The reference
  leases them from the leader's store, which counts on its own when the
  stores are private, so nodes can share an id and two owners' message
  ids then meet in a follower's store (the replication deployment loses
  and mixes messages on failover). The port gossips each node's id and
  moves the higher-named of two clashing nodes to a free one.
- A data stream writes its frames in the order the requests were made.
  The reference's lets a request made just after the stream connected
  write before earlier ones still queued on the connect lock, so one
  publisher's first pushes to a peer could reach a queue out of order.
- An RPC server's stop closes a connection whose handler starts after the
  stop began. The reference's handler then read forever while its peer
  kept the connection open, and ``stop()`` waited for it forever (the
  membership tests hung under load).
- The WAL's read barrier yields on a finished drain. The reference's
  spins on it (awaiting a finished task does not yield, so the drain's
  creator never resumes to clear it), which hung a follower's event loop
  under replication reads, and the cluster marked the node down.
"""

import asyncio
import os
import socket
import subprocess
import sys

import pytest
import torch

import chip_smoke
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster.membership import Membership
from chanamq_tpu_torch.cluster import dataplane as dp
from chanamq_tpu_torch.cluster.node import ClusterNode
from chanamq_tpu_torch.cluster.rpc import RpcServer
from chanamq_tpu_torch.store.memory import MemoryStore

pytestmark = pytest.mark.asyncio


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


async def start_nodes(n: int, *, streams: int = 2,
                      heartbeat_s: float = 0.1) -> list:
    """``n`` in-process port nodes, each with a private memory store, all
    seeded with the first; returns (server, cluster) pairs once every
    node sees every member alive."""
    nodes: list = []
    seeds: list = []
    for _ in range(n):
        server = BrokerServer(
            broker=Broker(store=MemoryStore(), router_device="cpu"),
            host="127.0.0.1", port=0, heartbeat_s=0)
        await server.start()
        cluster = ClusterNode(server.broker, "127.0.0.1", 0, seeds,
                              heartbeat_interval_s=heartbeat_s,
                              failure_timeout_s=2.0, streams=streams)
        await cluster.start()
        nodes.append((server, cluster))
        seeds = [nodes[0][1].name]
    for _ in range(200):
        if all(len(c.membership.alive_members()) == n for _, c in nodes):
            break
        await asyncio.sleep(0.05)
    assert all(len(c.membership.alive_members()) == n for _, c in nodes)
    return nodes


async def stop_nodes(nodes) -> None:
    for server, cluster in nodes:
        await cluster.stop()
        await server.stop()


@pytest.mark.parametrize("lease", ["leased", "leased-again", "all-one"])
async def test_private_stores_settle_on_distinct_worker_ids(lease,
                                                            monkeypatch):
    """Three nodes with private stores; with ``all-one`` every lease
    returns 1, as three private stores would at their first lease."""
    if lease == "all-one":
        async def one(self, uuid):
            return 1

        monkeypatch.setattr(ClusterNode, "acquire_worker_id", one)
    nodes = await start_nodes(3)
    try:
        await asyncio.sleep(0.5)  # a few heartbeats of direct contact
        ids = [s.broker.idgen.worker_id for s, _ in nodes]
        assert len(set(ids)) == 3, ids
        for _, cluster in nodes:
            assert cluster.membership.worker_id \
                == cluster.broker.idgen.worker_id
            peers = {name: wid for name, wid
                     in cluster.membership.peer_worker_ids.items()}
            assert set(peers.values()) == set(ids) - {
                cluster.broker.idgen.worker_id}
    finally:
        await stop_nodes(nodes)


def test_worker_id_clash_moves_the_higher_name():
    moved = []
    low = Membership("10.0.0.1:1", [], RpcServer("127.0.0.1", 0))
    high = Membership("10.0.0.2:1", [], RpcServer("127.0.0.1", 0))
    for m in (low, high):
        m.worker_id = 5
        m.on_worker_id_clash = lambda m=m: moved.append(m.self_name)
    low._note_worker_id(high._view())
    high._note_worker_id(low._view())
    assert moved == ["10.0.0.2:1"]
    assert low.peer_worker_ids == {"10.0.0.2:1": 5}
    # a view with no worker id (a reference node's) changes nothing
    view = low._view()
    del view["worker_id"]
    high._note_worker_id(view)
    assert moved == ["10.0.0.2:1"]


async def test_clustered_node_routes_through_its_router():
    """Two port nodes, one data-plane stream each way; publishers on both
    nodes, into queues either node owns: counts and per-publisher order
    equal the oracle, and each node routed its publishes in router
    batches."""
    wl = chip_smoke.Workload(5, n_queues=128, n_patterns=32, n_keys=256,
                             n_header_sets=64, n_topic=800, n_headers=400,
                             publishers=2)
    nodes = await start_nodes(2, streams=1)
    clients = []
    try:
        setup = await AMQPClient.connect("127.0.0.1",
                                         nodes[0][0].bound_port)
        clients.append(setup)
        ch = await setup.channel()
        await ch.exchange_declare("rx.topic", "topic")
        await ch.exchange_declare("rx.headers", "headers")
        for q in wl.queues:
            await ch.queue_declare(q)
        for pat, q in wl.topic_bindings:
            await ch.queue_bind(q, "rx.topic", pat)
        for q, args in wl.headers_bindings:
            await ch.queue_bind(q, "rx.headers", "", arguments=args)
        for _ in range(200):
            if all(len(c.queue_metas) == len(wl.queues) for _, c in nodes):
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.3)

        async def publish(p: int) -> None:
            c = await AMQPClient.connect("127.0.0.1", nodes[p][0].bound_port)
            clients.append(c)
            pch = await c.channel()
            await pch.confirm_select()
            for i, (kind, x) in enumerate(wl.streams[p]):
                if kind == "t":
                    pch.basic_publish(wl.body(p, i), exchange="rx.topic",
                                      routing_key=x)
                else:
                    pch.basic_publish(wl.body(p, i), exchange="rx.headers",
                                      properties=wl.header_props[x])
            await pch.wait_unconfirmed_below(1, timeout=60)

        await asyncio.gather(publish(0), publish(1))
        for server, _ in nodes:
            assert server.broker.metrics.router_batches > 0

        def owner_queue(q):
            for server, cluster in nodes:
                if cluster.queue_owner("/", q) == cluster.name:
                    return server.broker.vhosts["/"].queues[q]

        for _ in range(200):
            if all(owner_queue(q).message_count == len(wl.expected[q])
                   for q in wl.queues):
                break
            await asyncio.sleep(0.05)
        got: dict = {q: [] for q in wl.queues if wl.expected[q]}
        c = await AMQPClient.connect("127.0.0.1", nodes[1][0].bound_port)
        clients.append(c)
        cch = await c.channel()
        for q in got:
            await cch.basic_consume(q, got[q].append, no_ack=True)
        want = sum(len(wl.expected[q]) for q in got)
        for _ in range(400):
            if sum(len(v) for v in got.values()) >= want:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.2)
        res = chip_smoke.hold_deliveries(wl, got)
        assert res == {"lost": 0, "duplicated": 0, "reordered_streams": 0,
                       "altered": 0, "deliveries": want}
    finally:
        for c in clients:
            try:
                await c.close()
            except Exception:
                pass
        await stop_nodes(nodes)


def test_wal_read_barrier_yields_on_a_finished_drain(tmp_path):
    """A read arriving after a drain task finished, before its creator
    cleared the slot, must let the creator run: the barrier returns once
    the slot is clear. Run in a child with a time limit, since the fault
    spins the event loop forever."""
    code = f"""
import asyncio
from chanamq_tpu_torch.store.sqlite import SqliteStore
from chanamq_tpu_torch.wal import WalStore

async def main():
    store = WalStore(SqliteStore({str(tmp_path / "x.db")!r}))
    loop = asyncio.get_running_loop()

    async def drained():
        return None

    task = loop.create_task(drained())
    await asyncio.sleep(0)
    assert task.done()
    store._drain_task = task  # finished; its creator has not resumed
    loop.call_soon(setattr, store, "_drain_task", None)
    await asyncio.wait_for(store._settle(), 5)
    await asyncio.wait_for(store._drain(), 5)
    assert store._drain_task is None

asyncio.run(main())
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


async def test_data_stream_writes_in_request_order():
    """Ten requests made while the stream dials, ten more made the moment
    it is connected (before the first ten leave the connect lock): the
    peer receives all twenty in the order they were made."""
    server = RpcServer("127.0.0.1", 0)
    got: list = []

    async def record(view):
        got.append(bytes(view))
        return []

    server.register_binary(7, record)
    await server.start()
    stream = dp.DataStream("127.0.0.1", server.bound_port)
    loop = asyncio.get_running_loop()
    later: list = []
    read_loop = stream._read_loop

    def connected(reader, writer):
        later.extend(loop.create_task(stream.request(7, [b"%03d" % i]))
                     for i in range(10, 20))
        return read_loop(reader, writer)

    stream._read_loop = connected
    try:
        first = [loop.create_task(stream.request(7, [b"%03d" % i]))
                 for i in range(10)]
        await asyncio.wait_for(asyncio.gather(*first), 10)
        await asyncio.wait_for(asyncio.gather(*later), 10)
        assert len(later) == 10
        assert got == [b"%03d" % i for i in range(20)]
    finally:
        await stream.close()
        await server.stop()


async def test_rpc_server_stop_closes_a_connection_handled_late():
    """A connection accepted as the server stops, its handler running only
    after ``stop()`` closed the writers it knew: the handler closes the
    connection at once instead of reading it, so ``stop()`` returns."""
    server = RpcServer("127.0.0.1", 0)
    await server.start()
    ours, peer = socket.socketpair()
    try:
        reader, writer = await asyncio.open_connection(sock=ours)
        stopping = asyncio.get_running_loop().create_task(server.stop())
        await asyncio.sleep(0)  # stop() has begun
        await asyncio.wait_for(server._on_client(reader, writer), 2)
        assert writer.is_closing()
        await asyncio.wait_for(stopping, 5)
    finally:
        peer.close()
