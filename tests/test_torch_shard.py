"""Per-core shard subsystem tests (chanamq_tpu_torch/shard/): topology layout,
supervisor env forwarding and restart budget, RPC + data plane over Unix
sockets (frame kinds 4/5/6), trace trailers across the intra-node hop,
chaos data.* seams on UDS, fd handoff, the shard Prometheus label,
shard-liveness readiness, and the UDS chaos soak invariants.

The port's copy of ``tests/test_shard.py``: imports point at
``chanamq_tpu_torch``, every broker's router and the soak on the CPU;
the assertions are the reference's.
"""

import asyncio
import os
import sys
import tempfile

import pytest

from chanamq_tpu_torch import chaos, trace
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.chaos.plan import FaultPlan, FaultRule
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster.node import ClusterNode
from chanamq_tpu_torch.cluster.rpc import RpcClient, RpcServer, UdsTransport
from chanamq_tpu_torch.config import Config
from chanamq_tpu_torch.shard import ShardTopology, resolve_count
from chanamq_tpu_torch.shard.handoff import HandoffAcceptor, HandoffReceiver
from chanamq_tpu_torch.shard.supervisor import ShardSupervisor, child_env
from chanamq_tpu_torch.store.memory import MemoryStore
from chanamq_tpu_torch.trace import INTRA_SHARD_HOP, STAGES, TraceRuntime

pytestmark = pytest.mark.asyncio


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    trace.clear()
    chaos.clear()


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def _config(values=None):
    return Config(values or {}, env={})


async def test_resolve_count_auto_and_explicit():
    assert resolve_count(_config({"chana.mq.shard.count": 3})) == 3
    auto = resolve_count(_config({"chana.mq.shard.count": 0}))
    assert auto == (os.cpu_count() or 1)
    assert resolve_count(_config()) == 1  # default: sharding off


async def test_topology_layout(tmp_path):
    topo = ShardTopology(count=3, host="127.0.0.1", base_port=7000,
                         dir=str(tmp_path))
    assert topo.names() == ["127.0.0.1:7000", "127.0.0.1:7001",
                            "127.0.0.1:7002"]
    assert topo.uds_path(1) == os.path.join(str(tmp_path), "shard-1.sock")
    assert topo.handoff_path(2) == os.path.join(
        str(tmp_path), "handoff-2.sock")
    # self excluded; every sibling mapped to its socket
    assert topo.uds_map_for(1) == {
        "127.0.0.1:7000": topo.uds_path(0),
        "127.0.0.1:7002": topo.uds_path(2),
    }
    assert topo.seeds_for(0, external=["10.0.0.9:7000"]) == [
        "127.0.0.1:7001", "127.0.0.1:7002", "10.0.0.9:7000"]


async def test_topology_from_env_recovers_base_port(tmp_path):
    # the supervisor overrode this worker's cluster.port to base + index;
    # the worker must recover the base by subtraction
    config = _config({"chana.mq.cluster.host": "127.0.0.1",
                      "chana.mq.cluster.port": 7002})
    topo = ShardTopology.from_env(
        config, 2,
        environ={"CHANAMQ_SHARD_COUNT": "3",
                 "CHANAMQ_SHARD_DIR": str(tmp_path)})
    assert topo.base_port == 7000 and topo.count == 3
    assert topo.name(2) == "127.0.0.1:7002"
    assert topo.uds_map_for(2) == {
        "127.0.0.1:7000": topo.uds_path(0),
        "127.0.0.1:7001": topo.uds_path(1),
    }


async def test_child_env_layers_per_shard_values(tmp_path):
    config = _config({
        "chana.mq.cluster.host": "127.0.0.1",
        "chana.mq.cluster.port": 7100,
        "chana.mq.cluster.seeds": ["10.0.0.9:7100"],
        "chana.mq.admin.enabled": True,
        "chana.mq.admin.port": 15700,
        "chana.mq.store.path": str(tmp_path / "node.db"),
        "chana.mq.shard.heartbeat-interval": "200ms",
        "chana.mq.shard.failure-timeout": "1.5s",
    })
    topo = ShardTopology(count=2, host="127.0.0.1", base_port=7100,
                         dir=str(tmp_path))
    env = child_env(config, topo, 1, restarts=4)
    assert env["CHANAMQ_SHARD_INDEX"] == "1"
    assert env["CHANAMQ_SHARD_COUNT"] == "2"
    assert env["CHANAMQ_SHARD_DIR"] == str(tmp_path)
    assert env["CHANAMQ_SHARD_RESTARTS"] == "4"
    assert env["CHANAMQ_CLUSTER_ENABLED"] == "true"
    assert env["CHANAMQ_CLUSTER_PORT"] == "7101"
    # siblings first, then the cross-machine seed from the config
    assert env["CHANAMQ_CLUSTER_SEEDS"] == "127.0.0.1:7100,10.0.0.9:7100"
    assert env["CHANAMQ_CLUSTER_HEARTBEAT_INTERVAL"] == "200ms"
    assert env["CHANAMQ_CLUSTER_FAILURE_TIMEOUT"] == "1.5s"
    assert env["CHANAMQ_ADMIN_PORT"] == "15701"
    assert env["CHANAMQ_STORE_PATH"] == str(tmp_path / "node.db") + ".shard1"


async def test_supervisor_restart_budget(monkeypatch, tmp_path):
    """A worker that keeps dying is respawned max-restarts times, then
    left down — the watcher must not spin."""
    config = _config({
        "chana.mq.shard.count": 2,
        "chana.mq.shard.dir": str(tmp_path),
        "chana.mq.shard.restart-backoff": "10ms",
        "chana.mq.shard.max-restarts": 2,
    })
    sup = ShardSupervisor(config)

    async def fake_spawn(index):
        return await asyncio.create_subprocess_exec(
            sys.executable, "-c", "pass",
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.DEVNULL)

    monkeypatch.setattr(sup, "_spawn", fake_spawn)
    await asyncio.wait_for(sup._supervise(0), 30)
    assert sup.restarts[0] == 3  # budget (2) exhausted on the 3rd exit


# ---------------------------------------------------------------------------
# Unix-socket control + data plane
# ---------------------------------------------------------------------------


async def test_rpc_over_uds_and_unlink(tmp_path):
    path = os.path.join(str(tmp_path), "s.sock")
    server = RpcServer("127.0.0.1", 0, uds_path=path)
    async def echo(payload):
        return {"got": payload["x"]}

    server.register("echo", echo)
    await server.start()
    client = RpcClient(UdsTransport(path, peer="127.0.0.1:7000"))
    try:
        assert os.path.exists(path)
        result = await client.call("echo", {"x": 41})
        assert result == {"got": 41}
        # the transport's chaos identity is the member name, not the path
        assert client.transport.peer == "127.0.0.1:7000"
        assert client.transport.kind == "uds"
    finally:
        await client.close()
        await server.stop()
    assert not os.path.exists(path)  # stale socket unlinked on stop


async def _start_uds_pair(sock_dir):
    """Two in-process nodes whose control + data planes ride Unix sockets
    (the sibling-shard wiring, minus the supervisor)."""
    a_path = os.path.join(sock_dir, "a.sock")
    b_path = os.path.join(sock_dir, "b.sock")

    async def one(seeds, uds_path):
        srv = BrokerServer(broker=Broker(store=MemoryStore(), router_device="cpu"),
                           host="127.0.0.1", port=0, heartbeat_s=0)
        await srv.start()
        cl = ClusterNode(srv.broker, "127.0.0.1", 0, seeds,
                         heartbeat_interval_s=0.1, failure_timeout_s=0.8,
                         uds_path=uds_path)
        await cl.start()
        return srv, cl

    a_srv, a_cl = await one([], a_path)
    b_srv, b_cl = await one([a_cl.name], b_path)
    # ephemeral cluster ports: names are only known post-start, so the
    # sibling map is patched in afterwards (the supervisor precomputes it)
    a_cl.uds_map[b_cl.name] = b_path
    b_cl.uds_map[a_cl.name] = a_path
    for _ in range(100):
        if (len(a_cl.membership.alive_members()) == 2
                and len(b_cl.membership.alive_members()) == 2):
            break
        await asyncio.sleep(0.05)
    assert len(a_cl.membership.alive_members()) == 2
    return (a_srv, a_cl), (b_srv, b_cl)


async def _stop_pair(a, b):
    for srv, cl in (b, a):
        await cl.stop()
        await srv.stop()


def _owned_by(cluster, owner_name, prefix):
    return next(f"{prefix}{i}" for i in range(200)
                if cluster.queue_owner("/", f"{prefix}{i}") == owner_name)


async def test_uds_dataplane_push_deliver_settle():
    """Publish via the non-owner, consume remotely, manual-ack: all three
    binary frame kinds (push 4 / settle 6 / deliver 5) must ride the UDS
    transport, with the cross-shard push counted."""
    sock_dir = tempfile.mkdtemp(prefix="shard-test-")
    a, b = await _start_uds_pair(sock_dir)
    (a_srv, a_cl), (b_srv, b_cl) = a, b
    try:
        qn = _owned_by(a_cl, b_cl.name, "sq")
        c = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn)
        for _ in range(100):  # owner's meta broadcast is fire-and-forget
            if ("/", qn) in a_cl.queue_metas:
                break
            await asyncio.sleep(0.05)
        got = asyncio.get_event_loop().create_future()

        def on_msg(m):
            if not got.done():
                got.set_result((bytes(m.body), m.delivery_tag))

        await ch.basic_consume(qn, on_msg, no_ack=False)
        ch.basic_publish(b"over-uds", routing_key=qn)
        await ch.wait_unconfirmed_below(1, timeout=10)
        body, tag = await asyncio.wait_for(got, 10)
        assert body == b"over-uds"
        ch.basic_ack(tag)
        for _ in range(100):  # settle is batched; give the flusher a beat
            if a_srv.broker.metrics.rpc_settle_records >= 1:
                break
            await asyncio.sleep(0.05)
        await c.close()

        plane = a_cl.dataplane(b_cl.name)
        assert plane.transport.kind == "uds"
        assert plane.intra_node is True
        assert plane.stats()["transport"] == "uds"
        am, bm = a_srv.broker.metrics, b_srv.broker.metrics
        assert am.rpc_push_records >= 1  # kind 4, A -> B
        assert am.shard_cross_pushes >= 1  # counted as an intra-node hop
        assert bm.rpc_deliver_records >= 1  # kind 5, B -> A
        assert am.rpc_settle_records >= 1  # kind 6, A -> B
    finally:
        await _stop_pair(a, b)


async def test_trace_trailer_survives_intra_node_hop():
    """A sampled publish crossing shards over UDS must stitch into one
    trace spanning both workers and carry the intra-shard-hop span."""
    sock_dir = tempfile.mkdtemp(prefix="shard-test-")
    a, b = await _start_uds_pair(sock_dir)
    (a_srv, a_cl), (b_srv, b_cl) = a, b
    try:
        rt = trace.install(TraceRuntime(
            sample_rate=1.0, metrics=a_srv.broker.metrics, node=a_cl.name))
        qn = _owned_by(a_cl, b_cl.name, "tq")
        c = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn)
        for _ in range(100):
            if ("/", qn) in a_cl.queue_metas:
                break
            await asyncio.sleep(0.05)
        got = asyncio.get_event_loop().create_future()
        await ch.basic_consume(
            qn, lambda m: got.done() or got.set_result(bytes(m.body)),
            no_ack=True)
        ch.basic_publish(b"traced", routing_key=qn)
        await ch.wait_unconfirmed_below(1, timeout=10)
        assert await asyncio.wait_for(got, 10) == b"traced"
        await c.close()

        for _ in range(100):
            if rt.ring:
                break
            await asyncio.sleep(0.05)
        stitched = rt.find(rt.ring[-1].trace_id)
        d = stitched.to_dict()
        assert len(d["nodes"]) == 2, d
        span = stitched.slots[INTRA_SHARD_HOP]
        assert span is not None, (STAGES[INTRA_SHARD_HOP], d)
        assert span[2] == a_cl.name  # stamped by the pushing side
        lo, hi = stitched.bounds_ns()
        assert lo <= span[0] <= span[1] <= hi
    finally:
        await _stop_pair(a, b)


async def test_chaos_data_seams_fire_on_uds():
    """Node-scoped chaos rules must hit UDS peers: the transport carries
    the sibling's member name, so `peer=<name>` matches even though no
    TCP endpoint is involved."""
    sock_dir = tempfile.mkdtemp(prefix="shard-test-")
    a, b = await _start_uds_pair(sock_dir)
    (a_srv, a_cl), (b_srv, b_cl) = a, b
    try:
        runtime = chaos.install(FaultPlan(seed=3, rules=[
            FaultRule(name="uds-lat", kind="latency", sites=["data.*"],
                      peer=b_cl.name),
        ]), metrics=a_srv.broker.metrics)
        qn = _owned_by(a_cl, b_cl.name, "cq")
        c = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await c.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn)
        for _ in range(100):
            if ("/", qn) in a_cl.queue_metas:
                break
            await asyncio.sleep(0.05)
        ch.basic_publish(b"chaoted", routing_key=qn)
        await ch.wait_unconfirmed_below(1, timeout=10)
        await c.close()
        status = runtime.status()
        fired = {e["rule"] for e in status["fire_log_tail"]}
        assert "uds-lat" in fired, status
        assert a_srv.broker.metrics.chaos_fires >= 1
    finally:
        await _stop_pair(a, b)


# ---------------------------------------------------------------------------
# fd handoff (reuse-port fallback)
# ---------------------------------------------------------------------------


class _FakeBrokerServer:
    def __init__(self):
        self.served = 0

    async def _on_client(self, reader, writer):
        data = await reader.readexactly(5)
        writer.write(b"pong:" + data)
        await writer.drain()
        self.served += 1
        writer.close()


async def test_handoff_acceptor_to_receiver_roundtrip():
    """A client accepted by the supervisor's TCP listener is shipped over
    SCM_RIGHTS and served by the worker's event loop — bytes flow both
    ways on the original connection."""
    sock_dir = tempfile.mkdtemp(prefix="shard-test-")
    feed_path = os.path.join(sock_dir, "handoff-0.sock")
    fake = _FakeBrokerServer()
    receiver = HandoffReceiver(fake, feed_path)
    await receiver.start()
    acceptor = HandoffAcceptor("127.0.0.1", 0, [feed_path])
    await acceptor.start()
    try:
        for i in range(3):  # several clients: the feed socket is reused
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", acceptor.bound_port)
            writer.write(b"hello")
            await writer.drain()
            resp = await asyncio.wait_for(reader.readexactly(10), 5)
            assert resp == b"pong:hello"
            writer.close()
        assert acceptor.dispatched == 3
        assert acceptor.dropped == 0
        for _ in range(100):
            if receiver.adopted == 3 and fake.served == 3:
                break
            await asyncio.sleep(0.05)
        assert receiver.adopted == 3 and fake.served == 3
    finally:
        await acceptor.stop()
        await receiver.stop()
    assert not os.path.exists(feed_path)


# ---------------------------------------------------------------------------
# observability: shard label, shard readiness
# ---------------------------------------------------------------------------


async def test_prometheus_shard_label_and_counters():
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.rest.admin import AdminServer

    broker = Broker(router_device="cpu")
    await broker.start()
    try:
        admin = AdminServer(broker, port=0)
        # unsharded: plain series names, no label
        assert "chanamq_published_msgs 0" in admin._prometheus()
        broker.shard_info = {"index": 1, "count": 2,
                             "name": "127.0.0.1:7001"}
        broker.metrics.shard_cross_pushes = 7
        text = admin._prometheus()
        assert 'chanamq_published_msgs{shard="1"} 0' in text
        assert 'chanamq_shard_cross_pushes{shard="1"} 7' in text
        assert "# TYPE chanamq_shard_cross_pushes counter" in text
        assert "# TYPE chanamq_shard_handoffs counter" in text
        assert "# TYPE chanamq_shard_restarts counter" in text
    finally:
        await broker.stop()


async def test_readiness_flags_dead_shard_sibling():
    from chanamq_tpu_torch.telemetry import TelemetryService
    from chanamq_tpu_torch.telemetry.health import evaluate_health

    sock_dir = tempfile.mkdtemp(prefix="shard-test-")
    a, b = await _start_uds_pair(sock_dir)
    (a_srv, a_cl), (b_srv, b_cl) = a, b
    b_stopped = False
    try:
        a_srv.broker.shard_info = {"index": 0, "count": 2, "name": a_cl.name}
        svc = TelemetryService(a_srv.broker)
        report = evaluate_health(a_srv.broker, svc)
        assert report["checks"]["shards"]["ok"] is True
        assert report["checks"]["shards"]["dead_siblings"] == []

        await b_cl.stop()
        await b_srv.stop()
        b_stopped = True
        for _ in range(100):
            if b_cl.name not in a_cl.membership.alive_members():
                break
            await asyncio.sleep(0.05)
        report = evaluate_health(a_srv.broker, svc)
        shards = report["checks"]["shards"]
        assert shards["ok"] is False
        assert shards["dead_siblings"] == [b_cl.name]
        assert any("shard sibling" in r for r in report["reasons"])
        assert report["ready"] is False

        # the /admin/health fallback (telemetry disabled — the default)
        # must surface the same check: sibling liveness only needs
        # membership, and an LB probing a sharded worker without
        # telemetry still has to see it drain
        from chanamq_tpu_torch.rest.admin import AdminServer, _Response

        admin = AdminServer(a_srv.broker, port=0)
        resp = await admin._health({})
        assert isinstance(resp, _Response) and "503" in resp.status
        body = resp.payload
        assert body["checks"]["shards"]["dead_siblings"] == [b_cl.name]
        assert body["ready"] is False
    finally:
        if not b_stopped:
            await b_cl.stop()
            await b_srv.stop()
        await a_cl.stop()
        await a_srv.stop()


# ---------------------------------------------------------------------------
# chaos soak over UDS
# ---------------------------------------------------------------------------


async def test_soak_uds_no_loss_and_rehash_per_survivor():
    """The seeded soak with the interconnect on Unix sockets: the default
    plan's owner crash must cost zero confirmed messages and re-hash
    ownership exactly once on each of the two survivors."""
    from chanamq_tpu_torch.chaos.soak import run_soak

    report = await asyncio.wait_for(
        run_soak(42, messages=60, uds=True, device="cpu"), timeout=120)
    assert report["violations"] == [], report["violations"]
    assert report["interconnect"] == "uds"
    assert report["handoffs"] == 2
    assert report["confirmed"] > 0
