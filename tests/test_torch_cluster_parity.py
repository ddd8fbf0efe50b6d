"""A mixed cluster: one reference node and one port node.

The reference node (``chanamq_tpu``) runs as its own tests run it (its
router on JAX on the CPU); the port node (``chanamq_tpu_torch``) routes on
``cpu``. Both live in this event loop and talk over real sockets:

- membership converges, and both nodes name the same owner for every
  queue; ``HashRing`` places 4,096 queue names alike in both packages for
  three member sets;
- the same push, settle and deliver batches encode to the same data-plane
  bytes in both packages;
- publishes through each node into queues the other owns (64 topic
  patterns and 64 headers bindings over 256 queues, 2,000 messages) reach
  the queues a single-node oracle routes them to: per-queue counts and
  delivered sequences equal, with identical bodies;
- with ``replicate.factor`` 2, ``replicate.sync`` true and a private store
  each, killing either node loses no confirmed message;
- a federation link from a port upstream to a reference downstream, and
  the reverse, mirrors the same stream records.

A failure here is a fault of the port.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

import chip_smoke
from chanamq_tpu.amqp.properties import BasicProperties as RefProps
from chanamq_tpu.broker.matchers import HeadersMatcher as RefHeaders
from chanamq_tpu.broker.matchers import TopicMatcher as RefTopic
from chanamq_tpu.broker.server import BrokerServer as RefServer
from chanamq_tpu.cluster import dataplane as ref_dp
from chanamq_tpu.cluster import rpc as ref_rpc
from chanamq_tpu.cluster.hashring import HashRing as RefRing
from chanamq_tpu.cluster.node import ClusterNode as RefCluster
from chanamq_tpu.federation import FederationService as RefFederation
from chanamq_tpu.store.memory import MemoryStore as RefMemoryStore
from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster import dataplane as port_dp
from chanamq_tpu_torch.cluster import rpc as port_rpc
from chanamq_tpu_torch.cluster.hashring import HashRing
from chanamq_tpu_torch.cluster.node import ClusterNode
from chanamq_tpu_torch.federation import FederationService
from chanamq_tpu_torch.store.memory import MemoryStore

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)
STREAM_SMALL = {"x-queue-type": "stream",
                "x-stream-max-segment-size-bytes": 256}
PACKAGES = ("ref", "port")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's router runs torch on the CPU beside other test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Node:
    def __init__(self, pkg: str, server, cluster) -> None:
        self.pkg, self.server, self.cluster = pkg, server, cluster

    @property
    def port(self) -> int:
        return self.server.bound_port

    @property
    def name(self) -> str:
        return self.cluster.name

    @property
    def broker(self):
        return self.server.broker

    async def stop(self) -> None:
        await self.cluster.stop()
        await self.server.stop()


async def start_node(pkg: str, seeds: list, *, replicate: bool = False,
                     streams: int = 2) -> Node:
    """One in-process node of ``pkg`` with a private memory store; with
    ``replicate``, factor 2 and sync (the replication tests' settings);
    ``streams`` data-plane streams to each peer."""
    if pkg == "ref":
        server = RefServer(host="127.0.0.1", port=0, heartbeat_s=0,
                           store=RefMemoryStore())
        cluster_cls = RefCluster
    else:
        server = BrokerServer(
            broker=Broker(store=MemoryStore(), router_device="cpu"),
            host="127.0.0.1", port=0, heartbeat_s=0)
        cluster_cls = ClusterNode
    await server.start()
    extra = ({"replicate_factor": 2, "replicate_sync": True,
              "replicate_ack_timeout_ms": 2000} if replicate else {})
    # a 2 s failure timeout: failover is detected within the tests'
    # waits, and a node slowed by other test files is not taken for dead
    cluster = cluster_cls(server.broker, "127.0.0.1", 0, seeds,
                          heartbeat_interval_s=0.1, failure_timeout_s=2.0,
                          streams=streams, **extra)
    await cluster.start()
    return Node(pkg, server, cluster)


async def start_mixed(first: str = "ref", *, replicate: bool = False,
                      streams: int = 2) -> "list[Node]":
    """A two-node cluster: ``first``'s package seeds the other's."""
    a = await start_node(first, [], replicate=replicate, streams=streams)
    other = "port" if first == "ref" else "ref"
    b = await start_node(other, [a.name], replicate=replicate,
                         streams=streams)
    nodes = [a, b]
    for _ in range(200):
        if all(len(n.cluster.membership.alive_members()) == 2 for n in nodes):
            break
        await asyncio.sleep(0.05)
    assert all(sorted(n.cluster.membership.alive_members())
               == sorted([a.name, b.name]) for n in nodes)
    return nodes


async def stop_all(nodes) -> None:
    for node in nodes:
        try:
            await node.stop()
        except Exception:
            pass


async def until(predicate, what: str, timeout_s: float = 30.0) -> None:
    deadline = asyncio.get_running_loop().time() + timeout_s
    while not predicate():
        assert asyncio.get_running_loop().time() < deadline, \
            f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


# -- placement and wire bytes ---------------------------------------------------

QUEUE_NAMES = [f"q{i:04d}" for i in range(4096)]
MEMBER_SETS = (
    ["127.0.0.1:25672", "127.0.0.1:25673"],
    ["10.0.0.1:25672", "10.0.0.2:25672", "10.0.0.3:25672"],
    [f"node{i}.mq:5{i:04d}" for i in range(5)],
)


@pytest.mark.parametrize("members", range(len(MEMBER_SETS)))
def test_hashring_placement_matches_reference(members):
    names = MEMBER_SETS[members]
    port, ref = HashRing(names, 64), RefRing(names, 64)
    for q in QUEUE_NAMES:
        assert (port.owner_entity("queue", "/", q)
                == ref.owner_entity("queue", "/", q))
        assert (port.preference_entity("queue", "/", q, 2)
                == ref.preference_entity("queue", "/", q, 2))
    # every member owns some of the names: the comparison is not trivial
    assert {port.owner_entity("queue", "/", q) for q in QUEUE_NAMES} \
        == set(names)


def _push_batch(dp, props_cls, rng: np.random.Generator) -> bytes:
    parts = []
    n = 64
    for i in range(n):
        queues = [f"q{int(x):04d}" for x in rng.integers(0, 4096,
                                                          rng.integers(1, 5))]
        props = props_cls(delivery_mode=int(rng.integers(1, 3)),
                          headers={"h": f"v{i}"} if i % 3 == 0 else None)
        body = rng.integers(0, 256, int(rng.integers(0, 600)),
                            dtype=np.uint8).tobytes()
        parts += dp.encode_push_record(
            "/" if i % 2 else "vh", queues, "ex.topic" if i % 4 else "",
            f"a.b{i}", props.encode_header(len(body)), body)
    return b"".join([dp._U32.pack(n), *parts])


def _settle_batch(dp, rng: np.random.Generator) -> bytes:
    entries = [("/", f"q{i}", ("ack", "drop", "requeue")[i % 3], f"t{i}",
                int(rng.integers(0, 1 << 16)),
                [int(x) for x in rng.integers(0, 1 << 40,
                                              int(rng.integers(0, 9)))])
               for i in range(32)]
    return b"".join([dp._U32.pack(len(entries))]
                    + [dp.encode_settle_entry(*e) for e in entries])


def _deliver_batch(dp, props_cls, rng: np.random.Generator) -> bytes:
    records = []
    for i in range(32):
        body = rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        records += dp.encode_deliver_record(
            i, bool(i % 2), 1000 + i, None if i % 3 else 99_000 + i,
            "ex", f"rk{i % 5}", props_cls().encode_header(len(body)), body)
    return b"".join([dp.encode_deliver_head("/", "dq", "ctag", 32),
                     *records])


def test_data_plane_bytes_match_reference():
    """The same batches through each package's codec: identical frames,
    and each package decodes the other's."""
    frames = {}
    for pkg, dp, props, rpc in (("port", port_dp, BasicProperties, port_rpc),
                                ("ref", ref_dp, RefProps, ref_rpc)):
        rng = np.random.default_rng(7)
        push = _push_batch(dp, props, rng)
        frames[pkg] = {
            "push": push, "settle": _settle_batch(dp, rng),
            "deliver": _deliver_batch(dp, props, rng),
            "frame": b"".join(rpc.encode_data_frame(
                9, rpc.KIND_DREQUEST, dp.METHOD_PUSH_MANY, [push]))}
    assert frames["port"] == frames["ref"]
    push = memoryview(frames["ref"]["push"])
    assert [tuple(bytes(x) if isinstance(x, memoryview) else x for x in r)
            for r in port_dp.decode_push_many(push)] == [
        tuple(bytes(x) if isinstance(x, memoryview) else x for x in r)
        for r in ref_dp.decode_push_many(push)]
    settle = memoryview(frames["port"]["settle"])
    assert list(ref_dp.decode_settle_many(settle)) == list(
        port_dp.decode_settle_many(settle))


# -- a mixed cluster ------------------------------------------------------------


@pytest.mark.parametrize("first", PACKAGES)
async def test_mixed_membership_converges_and_owners_agree(first):
    nodes = await start_mixed(first)
    try:
        owners = {n.pkg: [n.cluster.queue_owner("/", q) for q in QUEUE_NAMES]
                  for n in nodes}
        assert owners["port"] == owners["ref"]
        assert set(owners["port"]) == {n.name for n in nodes}
    finally:
        await stop_all(nodes)


# a third of the node path's stream, its topic : headers mix, two publishers
WORKLOAD = dict(n_queues=256, n_patterns=64, n_keys=512, n_header_sets=128,
                n_topic=1334, n_headers=666, publishers=2)


def _reference_oracle(wl) -> dict:
    """The routes of every key and header set by the reference's own
    matchers: the single-node oracle the mixed cluster is held to."""
    topic, headers = RefTopic(), RefHeaders()
    for pat, q in wl.topic_bindings:
        topic.bind(pat, q)
    for q, args in wl.headers_bindings:
        headers.bind("", q, args)
    expected: dict = {q: [] for q in wl.queues}
    for p, items in enumerate(wl.streams):
        for i, (kind, x) in enumerate(items):
            route = (topic.route(x) if kind == "t" else
                     headers.route("", wl.header_props[x].headers))
            for q in route:
                expected[q].append((p, i))
    return expected


async def test_mixed_cluster_routes_like_one_node():
    """Publisher 0 on the reference node, publisher 1 on the port node,
    each routing with its own router into queues either node owns. One
    data-plane stream to each peer: with two (the default) a fan-out push
    record rides the stream of its first queue, so both packages alike
    can reorder one publisher's messages within a queue."""
    wl = chip_smoke.Workload(3, **WORKLOAD)
    expected = _reference_oracle(wl)
    assert expected == wl.expected
    nodes = await start_mixed("ref", streams=1)
    clients = []
    try:
        setup = await AMQPClient.connect("127.0.0.1", nodes[1].port)
        clients.append(setup)
        ch = await setup.channel()
        await ch.exchange_declare("px.topic", "topic")
        await ch.exchange_declare("px.headers", "headers")
        for q in wl.queues:
            await ch.queue_declare(q)
        for pat, q in wl.topic_bindings:
            await ch.queue_bind(q, "px.topic", pat)
        for q, args in wl.headers_bindings:
            await ch.queue_bind(q, "px.headers", "", arguments=args)
        owned = {n.pkg: [q for q in wl.queues
                         if n.cluster.queue_owner("/", q) == n.name]
                 for n in nodes}
        assert owned["ref"] and owned["port"]
        # both nodes know every queue and binding before traffic starts
        await until(lambda: all(len(n.cluster.queue_metas) == len(wl.queues)
                                for n in nodes), "queue metadata")
        await asyncio.sleep(0.3)

        async def publish(p: int, node: Node) -> None:
            c = await AMQPClient.connect("127.0.0.1", node.port)
            clients.append(c)
            pch = await c.channel()
            await pch.confirm_select()
            for i, (kind, x) in enumerate(wl.streams[p]):
                if kind == "t":
                    pch.basic_publish(wl.body(p, i), exchange="px.topic",
                                      routing_key=x)
                else:
                    pch.basic_publish(wl.body(p, i), exchange="px.headers",
                                      properties=wl.header_props[x])
            await pch.wait_unconfirmed_below(1, timeout=120)

        await asyncio.gather(publish(0, nodes[0]), publish(1, nodes[1]))
        assert wl.n_messages == 2000

        # per-queue counts at each queue's owner
        def counts_ok() -> bool:
            return all(
                n.broker.vhosts["/"].queues[q].message_count
                == len(expected[q]) for n in nodes for q in owned[n.pkg])

        await until(counts_ok, "per-queue counts equal to the oracle")
        # the port's node routed its publisher's batches through its router
        # (the reference's clustered node routes each through its matchers)
        assert nodes[1].pkg == "port"
        assert nodes[1].broker.metrics.router_batches > 0

        # drain every busy queue through the node that does NOT own it
        got: dict = {q: [] for q in wl.queues if expected[q]}
        for n in nodes:
            c = await AMQPClient.connect("127.0.0.1", n.port)
            clients.append(c)
            cch = await c.channel()
            for q in owned["port" if n.pkg == "ref" else "ref"]:
                if q in got:
                    await cch.basic_consume(q, got[q].append, no_ack=True)
        await until(lambda: all(len(got[q]) >= len(expected[q])
                                for q in got), "every delivery")
        await asyncio.sleep(0.2)  # nothing more may arrive
        for q, msgs in got.items():
            seen = [tuple(int(x) for x in m.body.split(b":", 2)[:2])
                    for m in msgs]
            want = expected[q]
            assert sorted(seen) == sorted(want), q
            for p in range(wl.publishers):
                assert ([i for pp, i in seen if pp == p]
                        == [i for pp, i in want if pp == p]), (q, p)
            assert all(m.body == wl.body(p, i)
                       for m, (p, i) in zip(msgs, seen)), q
    finally:
        for c in clients:
            try:
                await c.close()
            except Exception:
                pass
        await stop_all(nodes)


@pytest.mark.parametrize("victim", PACKAGES)
async def test_mixed_failover_zero_confirmed_loss(victim):
    """``replicate.factor`` 2 with ``sync``, a private store each: the
    ``victim``'s queues are promoted on the survivor after it dies, and
    every confirmed persistent message is delivered there once."""
    nodes = await start_mixed("ref", replicate=True)
    dead = next(n for n in nodes if n.pkg == victim)
    survivor = next(n for n in nodes if n.pkg != victim)
    queues = [q for q in (f"ha{i}" for i in range(400))
              if dead.cluster.queue_owner("/", q) == dead.name][:12]
    per_queue = 25
    client = None
    try:
        client = await AMQPClient.connect("127.0.0.1", survivor.port)
        ch = await client.channel()
        await ch.confirm_select()
        for q in queues:
            await ch.queue_declare(q, durable=True)
        for i in range(per_queue):
            for q in queues:
                ch.basic_publish(b"%s:%03d" % (q.encode(), i),
                                 routing_key=q, properties=PERSISTENT)
        # sync replication: a released confirm means the replica acked
        await ch.wait_unconfirmed_below(1, timeout=60)
        await dead.stop()
        await until(lambda: (
            dead.name not in survivor.cluster.membership.alive_members()
            and survivor.broker.metrics.repl_promotions == len(queues)
            and all(q in survivor.broker.vhosts["/"].queues
                    for q in queues)), "promotion of every queue")
        got: dict = {q: [] for q in queues}
        for q in queues:
            await ch.basic_consume(q, lambda m, _q=q: got[_q].append(
                bytes(m.body)), no_ack=True)
        await until(lambda: all(len(v) >= per_queue for v in got.values()),
                    "every confirmed message")
        await asyncio.sleep(0.2)
        for q in queues:
            assert got[q] == [b"%s:%03d" % (q.encode(), i)
                              for i in range(per_queue)], q
    finally:
        if client is not None:
            try:
                await client.close()
            except Exception:
                pass
        await stop_all(nodes)


# -- federation across packages -------------------------------------------------


async def _fed_node(pkg: str, **kwargs):
    if pkg == "ref":
        srv = RefServer(host="127.0.0.1", port=0, heartbeat_s=0,
                        store=RefMemoryStore())
        await srv.start()
        fed = RefFederation(srv.broker, port=0, **kwargs)
    else:
        srv = BrokerServer(
            broker=Broker(store=MemoryStore(), router_device="cpu"),
            host="127.0.0.1", port=0, heartbeat_s=0)
        await srv.start()
        fed = FederationService(srv.broker, port=0, **kwargs)
    await fed.start()
    return srv, fed


async def _read_stream(port: int, queue: str, n: int) -> list:
    """The first ``n`` records of stream ``queue``: body and headers."""
    client = await AMQPClient.connect("127.0.0.1", port)
    ch = await client.channel()
    await ch.basic_qos(prefetch_count=64)
    got: list = []
    done = asyncio.get_running_loop().create_future()

    def on_msg(msg) -> None:
        if len(got) < n:
            got.append((bytes(msg.body), msg.properties.delivery_mode,
                        dict(msg.properties.headers or {})))
            ch.basic_ack(msg.delivery_tag)
            if len(got) == n and not done.done():
                done.set_result(None)

    await ch.basic_consume(queue, on_msg,
                           arguments={"x-stream-offset": "first"})
    await asyncio.wait_for(done, 15)
    await client.close()
    return got


async def _federate(upstream: str, downstream: str) -> "tuple[list, list]":
    """Publish 40 records into stream ``fq`` on ``upstream`` with a link
    to ``downstream``; returns the records both hold up to the sealed
    tail."""
    b_srv, fed_b = await _fed_node(downstream, node_name="cluster-b")
    a_srv, fed_a = await _fed_node(
        upstream, node_name="cluster-a", retry_s=0.05, idle_s=0.02,
        links=[{"name": "to-b", "host": "127.0.0.1", "port": fed_b.port,
                "queues": ["fq"], "exchanges": []}])
    try:
        client = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await client.channel()
        await ch.confirm_select()
        await ch.queue_declare("fq", durable=True, arguments=STREAM_SMALL)
        rng = random.Random(11)
        for i in range(40):
            props = BasicProperties(delivery_mode=2, headers={
                "i": i, "tag": rng.choice(["x", "y", "z"])})
            ch.basic_publish(b"r%03d:" % i + bytes(rng.randrange(256)
                                                   for _ in range(i % 17)),
                             routing_key="fq", properties=props)
        await ch.wait_unconfirmed_below(1, timeout=15)
        await client.close()
        sealed = a_srv.broker.get_queue("/", "fq")._active_base
        assert sealed > 1, "expected at least one sealed segment"
        await until(lambda: (
            "fq" in b_srv.broker.vhosts["/"].queues
            and b_srv.broker.vhosts["/"].queues["fq"].next_offset >= sealed),
            "mirror catch-up")
        origin = await _read_stream(a_srv.bound_port, "fq", sealed - 1)
        mirror = await _read_stream(b_srv.bound_port, "fq", sealed - 1)
        return origin, mirror
    finally:
        await fed_a.stop()
        await a_srv.stop()
        await fed_b.stop()
        await b_srv.stop()


async def test_federation_across_packages_mirrors_the_same_records():
    runs = {(up, down): await _federate(up, down)
            for up, down in (("port", "ref"), ("ref", "port"))}
    for origin, mirror in runs.values():
        assert mirror == origin and len(origin) >= 10
    assert runs[("port", "ref")] == runs[("ref", "port")]
