"""End-to-end message tracing (chanamq_tpu_torch/trace/): sampling determinism,
wire blob + trailer codec, cross-node stitching over the binary data plane
(memoryview bodies untouched), ring eviction, slow capture, chaos-fire
tagging, admin endpoint shapes, and the sampled-tracing overhead claim
(slow-marked).

The port's copy of ``tests/test_trace.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU (the overhead
claim's spawned brokers through ``CHANAMQ_ROUTER_DEVICE``); the
assertions are the reference's.
"""

import asyncio
import json
import time
from urllib.parse import quote

import pytest

from chanamq_tpu_torch import chaos, trace
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.chaos.plan import FaultPlan, FaultRule
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.config import Config
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.trace import (
    CLUSTER_PUSH, DELIVER, ENQUEUE, INGRESS_PARSE, REMOTE_APPLY, ROUTE,
    SETTLE, STAGES, Trace, TraceRuntime, decode_trailer, encode_trailer,
)
from chanamq_tpu_torch.utils.metrics import Metrics
from chanamq_tpu_torch.broker.broker import Broker

from test_torch_cluster_broker import start_cluster

pytestmark = pytest.mark.asyncio


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    trace.clear()
    chaos.clear()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


async def test_sampling_deterministic_per_seed():
    rt1 = TraceRuntime(sample_rate=0.3, seed=7)
    rt2 = TraceRuntime(sample_rate=0.3, seed=7)
    d1 = [rt1.begin_publish() is not None for _ in range(200)]
    d2 = [rt2.begin_publish() is not None for _ in range(200)]
    assert d1 == d2
    assert any(d1) and not all(d1)  # a 0.3 rate samples some, not all
    # a different seed draws a different subset
    rt3 = TraceRuntime(sample_rate=0.3, seed=8)
    assert [rt3.begin_publish() is not None for _ in range(200)] != d1


async def test_sampling_consumes_one_draw_regardless_of_rate():
    # same seed, different rates: after N publishes both RNGs must sit at
    # the same stream position, so rate changes never reshuffle later
    # sampling decisions of a seeded run
    rt_none = TraceRuntime(sample_rate=0.0, seed=7)
    rt_all = TraceRuntime(sample_rate=1.0, seed=7)
    for _ in range(200):
        assert rt_none.begin_publish() is None
        assert rt_all.begin_publish() is not None
    assert rt_none._rng.random() == rt_all._rng.random()


async def test_enable_from_config_inherits_chaos_seed(tmp_path):
    config = Config({"chana.mq.trace.enabled": True,
                     "chana.mq.chaos.seed": 123})
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    try:
        rt = trace.enable_from_config(config, server.broker)
        assert rt is trace.ACTIVE and rt.seed == 123
        assert server.broker.trace_enabled is True
        trace.clear()
        # an installed chaos plan's seed wins over the config default
        chaos.install(FaultPlan(seed=77, rules=[
            FaultRule(name="r", kind="latency", sites=["none"],
                      probability=0.0)]))
        rt = trace.enable_from_config(config, server.broker)
        assert rt.seed == 77
    finally:
        await server.stop()


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


async def test_blob_roundtrip_and_trailer():
    tr = Trace("nodeA:1#42", "nodeA:1")
    tr.span(INGRESS_PARSE, 100, 250, "nodeA:1")
    tr.span(ROUTE, 250, 300, "nodeA:1")
    tr.tag_chaos("slow-store")
    back = Trace.from_blob(tr.to_blob())
    assert back.trace_id == tr.trace_id and back.origin == tr.origin
    assert back.slots[INGRESS_PARSE] == (100, 250, "nodeA:1")
    assert back.slots[ROUTE] == (250, 300, "nodeA:1")
    assert back.chaos_rules == ["slow-store"]

    tr2 = Trace("nodeA:1#43", "nodeA:1")
    tr2.span(ENQUEUE, 7, 9, "nodeB:1")
    payload = b"\x00recordbytes" + encode_trailer([(0, tr), (3, tr2)])
    got = decode_trailer(payload)
    assert sorted(got) == [0, 3]
    assert got[0].trace_id == "nodeA:1#42"
    assert got[3].slots[ENQUEUE] == (7, 9, "nodeB:1")
    # payloads without a trailer (or too short) decode to None, even when
    # the tail happens to contain arbitrary bytes
    assert decode_trailer(b"\x00recordbytes") is None
    assert decode_trailer(b"") is None


# ---------------------------------------------------------------------------
# cross-node stitching over the data plane
# ---------------------------------------------------------------------------


async def test_cross_node_trace_stitching(tmp_path):
    """Publish via the NON-owner with sample-rate 1.0: the trace must ride
    the push trailer to the owner, come back on the deliver trailer, and
    finish as ONE stitched trace spanning both nodes — with the message
    body delivered byte-identical (the trailer never perturbs the
    zero-copy record decode)."""
    nodes = await start_cluster(tmp_path, 2)
    try:
        qn = next(f"tq{i}" for i in range(200)
                  if nodes[0].cluster.queue_owner("/", f"tq{i}")
                  != nodes[0].name)
        other = nodes[0]  # non-owner of qn by construction
        rt = trace.install(TraceRuntime(
            sample_rate=1.0, metrics=other.server.broker.metrics,
            node=other.name))

        body = b"\xde\xad" + bytes(range(256))
        client = await AMQPClient.connect("127.0.0.1", other.port)
        ch = await client.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn)
        for _ in range(100):  # owner's meta broadcast is fire-and-forget
            if ("/", qn) in other.cluster.queue_metas:
                break
            await asyncio.sleep(0.05)
        got = asyncio.get_event_loop().create_future()
        await ch.basic_consume(qn, lambda m: got.done()
                               or got.set_result(bytes(m.body)),
                               no_ack=True)
        ch.basic_publish(body, routing_key=qn)
        await ch.wait_unconfirmed_below(1, timeout=10)
        assert await asyncio.wait_for(got, 10) == body
        await client.close()

        for _ in range(100):  # settle lands via the async deliver path
            if rt.ring:
                break
            await asyncio.sleep(0.05)
        tr = rt.ring[-1]
        stitched = rt.find(tr.trace_id)
        d = stitched.to_dict()
        assert len(d["nodes"]) == 2, d
        for stage in (INGRESS_PARSE, ROUTE, CLUSTER_PUSH, REMOTE_APPLY,
                      DELIVER, SETTLE):
            assert stitched.slots[stage] is not None, (STAGES[stage], d)
        # monotone: every span sits inside the trace bounds
        lo, hi = stitched.bounds_ns()
        assert all(lo <= s[0] <= s[1] <= hi
                   for s in stitched.slots if s is not None)
        # the owner-side stages carry the owner's node tag
        owner_name = nodes[0].cluster.queue_owner("/", qn)
        assert stitched.slots[REMOTE_APPLY][2] == owner_name
        assert stitched.slots[INGRESS_PARSE][2] == other.name
        assert other.server.broker.metrics.trace_ctx_sent > 0
        assert other.server.broker.metrics.trace_ctx_recv > 0
    finally:
        trace.clear()
        for node in nodes:
            await node.stop()


# ---------------------------------------------------------------------------
# rings: eviction + slow capture + chaos tagging
# ---------------------------------------------------------------------------


async def test_ring_eviction_keeps_newest():
    rt = TraceRuntime(sample_rate=1.0, ring_size=4, metrics=Metrics())
    ids = []
    for _ in range(10):
        tr = rt.begin_publish()
        ids.append(tr.trace_id)
        rt.finish(tr)
    assert len(rt.ring) == 4
    assert [t.trace_id for t in rt.ring] == ids[-4:]
    assert rt.metrics.trace_completed == 10
    # parked traces that never finish are capped too (lost flushes must
    # not leak memory); the cap overflow is accounted
    for i in range(rt._inflight_cap + 5):
        rt.park(Trace(f"lost#{i}", "n"))
    assert len(rt._inflight) == rt._inflight_cap
    assert rt.metrics.trace_evicted == 5


async def test_slow_capture_threshold():
    m = Metrics()
    rt = TraceRuntime(sample_rate=1.0, slow_ms=1.0, metrics=m)
    fast = rt.begin_publish()
    rt.finish(fast)  # ingress span only: far under 1 ms
    slow = rt.begin_publish()
    t0 = time.perf_counter_ns()
    slow.span(DELIVER, t0, t0 + 5_000_000, "n")  # 5 ms
    rt.finish(slow)
    assert [t.trace_id for t in rt.slow] == [slow.trace_id]
    assert m.trace_slow == 1 and m.trace_completed == 2
    # per-stage histogram observed the deliver duration (~5000 us)
    h = m.trace_stage_us["trace_deliver_us"]
    assert h.count == 1 and 4_000 <= h.total_us <= 6_000


async def test_chaos_fire_tags_trace():
    m = Metrics()
    rt = TraceRuntime(sample_rate=1.0, metrics=m)
    trace.install(rt)
    chaos.install(FaultPlan(seed=1, rules=[
        FaultRule(name="always-lag", kind="latency", sites=["store.*"],
                  probability=1.0, delay_ms=0)]), metrics=m)
    try:
        tr = rt.begin_publish()
        await chaos.ACTIVE.fire("store.enqueue")  # tags via current
        rt.current = None
        rt.finish(tr)
        assert tr.chaos_rules == ["always-lag"]
        assert list(rt.slow) == [tr]  # chaos-touched => always captured
        assert m.trace_chaos_tagged == 1

        # a fire OFF the publish path still tags traces whose time window
        # covers it (fault -> latency causality)
        tr2 = rt.begin_publish()
        rt.current = None
        await chaos.ACTIVE.fire("store.flush")
        tr2.span(SETTLE, tr2.slots[INGRESS_PARSE][0],
                 time.perf_counter_ns(), "n")
        rt.finish(tr2)
        assert "always-lag" in tr2.chaos_rules
    finally:
        chaos.clear()
        trace.clear()


# ---------------------------------------------------------------------------
# admin surface
# ---------------------------------------------------------------------------


async def _http(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    writer.write(head + body)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), 10)
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    return status, json.loads(payload) if payload else None


async def test_admin_trace_endpoints():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        # not installed: the listing endpoint still answers
        status, body = await _http(admin.bound_port, "GET", "/admin/traces")
        assert status == 200
        assert body == {"enabled": False, "installed": False}

        rt = trace.install(TraceRuntime(
            sample_rate=1.0, metrics=server.broker.metrics, node="n1"))
        tr = rt.begin_publish()
        rt.finish(tr)
        status, body = await _http(admin.bound_port, "GET", "/admin/traces")
        assert status == 200 and body["installed"] is True
        assert body["node"] == "n1" and body["sample_rate"] == 1.0
        assert body["completed_in_ring"] == 1
        assert body["recent"][0]["id"] == tr.trace_id
        assert "trace_ingress_parse_us" in body["stage_latency_us"]

        # detail: the id contains '#', so it rides urlencoded
        status, body = await _http(
            admin.bound_port, "GET",
            f"/admin/traces/{quote(tr.trace_id, safe='')}")
        assert status == 200
        assert body["id"] == tr.trace_id and body["finished"] is True
        assert "ingress-parse" in body["stages"]

        status, body = await _http(
            admin.bound_port, "GET", "/admin/traces/nope%23404")
        assert status == 404
        assert "no trace" in body["error"]

        status, body = await _http(
            admin.bound_port, "POST", "/admin/traces", b"{}")
        assert status == 405 and body == {"error": "use GET"}

        # /admin/metrics carries the trace counters + stage percentiles
        status, body = await _http(admin.bound_port, "GET", "/admin/metrics")
        assert status == 200 and body["trace_sampled"] == 1
        assert "trace_ingress_parse_p99_us" in body
        assert body["connections_open"] == (
            body["connections_opened"] - body["connections_closed"])
    finally:
        trace.clear()
        await admin.stop()
        await server.stop()


async def test_prometheus_cumulative_histograms():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        h = server.broker.metrics.publish_to_deliver_us
        for us in (3, 15, 15, 40_000_000):  # last one overflows all bounds
            h.observe_us(us)
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", admin.bound_port)
        writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(-1), 10)
        writer.close()
        text = raw.partition(b"\r\n\r\n")[2].decode()
        lines = text.splitlines()
        assert ("# TYPE chanamq_publish_to_deliver_us histogram") in lines
        bucket = {}
        for line in lines:
            if line.startswith("chanamq_publish_to_deliver_us_bucket"):
                le = line.split('le="')[1].split('"')[0]
                bucket[le] = int(line.rsplit(" ", 1)[1])
        # cumulative: counts only grow along the bounds, +Inf == count
        assert bucket["5"] == 1 and bucket["20"] == 3
        assert bucket["10000000"] == 3 and bucket["+Inf"] == 4
        assert "chanamq_publish_to_deliver_us_count 4" in lines
        assert f"chanamq_publish_to_deliver_us_sum {h.total_us}" in lines
        # counters got their proper TYPE line
        assert "# TYPE chanamq_trace_sampled counter" in lines
    finally:
        await admin.stop()
        await server.stop()


# ---------------------------------------------------------------------------
# overhead claim (slow: two 5 s bench runs)
# ---------------------------------------------------------------------------


@pytest.mark.slow
async def test_trace_overhead_under_two_percent():
    """The headline claim: the 1% default sample rate costs <=2%
    throughput on the saturated transient/autoAck spec."""
    from chanamq_tpu_torch import bench

    cpu = {"CHANAMQ_ROUTER_DEVICE": "cpu"}

    # run_spec drives its load generator with asyncio.run, which cannot
    # nest inside this (asyncio-marked) test's running loop — hop each
    # run onto a worker thread so it gets a loop of its own
    base = await asyncio.to_thread(
        bench.run_spec, "transient_autoack_3p3c", extra_env=cpu)
    traced = await asyncio.to_thread(
        bench.run_spec, "transient_autoack_3p3c", extra_env={
            **cpu,
            "CHANAMQ_TRACE_ENABLED": "true",
            "CHANAMQ_TRACE_SAMPLE_RATE": "0.01"})
    assert "error" not in base, base
    assert "error" not in traced, traced
    assert traced["delivered_per_s"] >= base["delivered_per_s"] * 0.98, (
        base, traced)
