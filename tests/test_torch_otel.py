"""End-to-end causal tracing (chanamq_tpu_torch/otel/): W3C traceparent
parsing + propagation, forced sampling vs the seeded RNG, blob-v2
compatibility, OTLP span rendering + the background exporter, pull-mode
/admin/otel/spans, /admin/traces filtering, OpenMetrics exemplars, the
cross-cluster joined span tree over a federation link, and the JSON log
join key.

The port's copy of ``tests/test_otel.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import json
import re

import pytest

from chanamq_tpu_torch import trace
from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.otel.context import (
    W3CContext, derive_trace_id, extract, format_traceparent,
    parse_traceparent, stamp_headers,
)
from chanamq_tpu_torch.otel.export import (
    OtelExporter, default_resource, resource_spans, span_count,
)
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.store.memory import MemoryStore
from chanamq_tpu_torch.trace import (
    DELIVER, ENQUEUE, REMOTE_APPLY, SETTLE, Trace, TraceRuntime,
)
from chanamq_tpu_torch.utils.metrics import Metrics
from chanamq_tpu_torch.broker.broker import Broker

from test_torch_federation import (
    PERSISTENT, STREAM_SMALL, collect, eventually, start_pair, stop_pair,
)
from test_torch_trace import _http

pytestmark = pytest.mark.asyncio

TID = "0af7651916cd43dd8448eb211c80319c"
SPAN = "b7ad6b7169203331"
TRACEPARENT = f"00-{TID}-{SPAN}-01"


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    trace.clear()


# ---------------------------------------------------------------------------
# traceparent parsing
# ---------------------------------------------------------------------------


async def test_traceparent_parse_table():
    ok = parse_traceparent(TRACEPARENT)
    assert ok == (TID, SPAN, 0x01)
    # bytes arrive from raw AMQP header decode paths
    assert parse_traceparent(TRACEPARENT.encode()) == ok
    # a future version may append fields; version 00 may not
    assert parse_traceparent(f"01-{TID}-{SPAN}-01-extra") == (TID, SPAN, 1)
    for bad in (
        None, "", "garbage", 42,
        f"ff-{TID}-{SPAN}-01",            # version ff is forbidden
        f"00-{'0' * 32}-{SPAN}-01",       # all-zero trace id
        f"00-{TID}-{'0' * 16}-01",        # all-zero span id
        f"00-{TID[:30]}-{SPAN}-01",       # short trace id
        f"00-{TID}-{SPAN[:14]}-01",       # short span id
        f"00-{TID.upper()}-{SPAN}-01",    # uppercase hex is invalid
        f"00-{'zz' * 16}-{SPAN}-01",      # non-hex
        f"00-{TID}-{SPAN}-01-extra",      # version 00 with extra field
        f"0x-{TID}-{SPAN}-01",
    ):
        assert parse_traceparent(bad) is None, bad


async def test_extract_and_format_roundtrip():
    got = extract({"traceparent": TRACEPARENT, "tracestate": "k=v"})
    assert got == (TID, SPAN, 0x01, "k=v")
    assert extract({"traceparent": "junk"}) is None
    assert extract({}) is None and extract(None) is None
    assert format_traceparent(TID, SPAN, 0x01) == TRACEPARENT
    # derived ids are stable and never the forbidden all-zero value
    assert derive_trace_id("n#1") == derive_trace_id("n#1")
    assert derive_trace_id("n#1") != derive_trace_id("n#2")
    assert int(derive_trace_id("n#1"), 16) != 0


async def test_stamp_headers_copy_on_write():
    ctx = W3CContext(TID, SPAN, "c0c0c0c0c0c0c0c0", flags=1)
    props = BasicProperties(headers={"traceparent": TRACEPARENT, "k": "v"})
    out, changed = stamp_headers(props, ctx)
    assert changed and out is not props
    # the cached/shared original is never mutated (connection.py shares
    # decoded BasicProperties across identical header bytes)
    assert props.headers["traceparent"] == TRACEPARENT
    assert out.headers["traceparent"] == ctx.outgoing
    assert out.headers["k"] == "v"
    # idempotent: an already-stamped property set passes through
    again, changed2 = stamp_headers(out, ctx)
    assert not changed2 and again is out


# ---------------------------------------------------------------------------
# forced sampling vs the seeded RNG
# ---------------------------------------------------------------------------


async def test_forced_samples_never_perturb_seeded_sequence():
    """The determinism gate: a headerless run and a run interleaved with
    propagated publishes must make draw-for-draw identical sampling
    decisions (forced traces use a separate counter + derived ids)."""
    rt1 = TraceRuntime(sample_rate=0.5, seed=42)
    plain = [rt1.begin_publish() is not None for _ in range(100)]
    rt2 = TraceRuntime(sample_rate=0.5, seed=42, metrics=Metrics())
    headers = {"traceparent": TRACEPARENT}
    mixed = []
    for i in range(100):
        if i % 3 == 0:
            forced = rt2.begin_publish(headers=headers)
            assert forced is not None and forced.w3c is not None
            assert forced.w3c.trace_id == TID
            assert forced.w3c.parent_span_id == SPAN
            assert forced.w3c.flags & 0x01
        mixed.append(rt2.begin_publish() is not None)
    assert mixed == plain
    assert rt2.metrics.otel_forced_samples == 34
    # malformed headers fall through to the seeded path untouched
    rt3 = TraceRuntime(sample_rate=0.5, seed=42)
    bad = {"traceparent": "not-a-context"}
    assert [rt3.begin_publish(headers=bad) is not None
            for _ in range(100)] == plain


async def test_distinct_root_spans_per_forced_publish():
    rt = TraceRuntime(sample_rate=0.0, seed=1)
    a = rt.begin_publish(headers={"traceparent": TRACEPARENT})
    b = rt.begin_publish(headers={"traceparent": TRACEPARENT})
    assert a.w3c.root_span_id != b.w3c.root_span_id
    assert a.w3c.trace_id == b.w3c.trace_id == TID


# ---------------------------------------------------------------------------
# blob v2
# ---------------------------------------------------------------------------


async def test_blob_v2_roundtrip_and_v1_compat():
    rt = TraceRuntime(sample_rate=0.0)
    tr = rt.begin_publish(headers={
        "traceparent": TRACEPARENT, "tracestate": "vendor=1"})
    tr.attr("exchange", "ex")
    tr.attr("queue", "q1,q2")
    back = Trace.from_blob(tr.to_blob())
    assert back.w3c is not None
    assert back.w3c.trace_id == TID
    assert back.w3c.parent_span_id == SPAN
    assert back.w3c.root_span_id == tr.w3c.root_span_id
    assert back.w3c.tracestate == "vendor=1"
    assert back.attrs == {"exchange": "ex", "queue": "q1,q2"}
    # a seeded (no-w3c, no-attrs) trace roundtrips too
    plain = Trace("n#7", "n")
    got = Trace.from_blob(plain.to_blob())
    assert got.w3c is None and not got.attrs
    # a hand-built v1 blob (the wire before W3C context) still decodes: version
    # byte 0x01, ss id, ss origin, zero spans, zero chaos tags
    v1 = b"\x01" + bytes((3,)) + b"n#1" + bytes((1,)) + b"n" \
        + b"\x00" + b"\x00"
    old = Trace.from_blob(v1)
    assert old.trace_id == "n#1" and old.origin == "n"
    assert old.w3c is None and not old.attrs


# ---------------------------------------------------------------------------
# single-broker propagation: publish in, delivery out
# ---------------------------------------------------------------------------


async def _deliver_roundtrip(publish_headers):
    """Publish one message through a live broker with tracing installed
    (seeded rate 0: only a propagated context can sample) and return
    (delivered message, runtime)."""
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    rt = trace.install(TraceRuntime(
        sample_rate=0.0, metrics=server.broker.metrics, node="n1"))
    try:
        client = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await client.channel()
        await ch.queue_declare("oq")
        got = asyncio.get_event_loop().create_future()
        await ch.basic_consume("oq", lambda m: got.done()
                               or got.set_result(m), no_ack=True)
        ch.basic_publish(b"payload", routing_key="oq",
                         properties=BasicProperties(
                             headers=dict(publish_headers)))
        msg = await asyncio.wait_for(got, 10)
        await client.close()
        return msg, rt
    finally:
        await server.stop()


async def test_propagated_publish_restamps_delivery():
    msg, rt = await _deliver_roundtrip({"traceparent": TRACEPARENT,
                                        "tracestate": "k=v"})
    for _ in range(100):
        if rt.ring:
            break
        await asyncio.sleep(0.02)
    tr = rt.ring[-1]
    assert tr.w3c is not None and tr.w3c.trace_id == TID
    # the delivery carries the BROKER's outgoing context: same trace id,
    # the broker's root span as parent, tracestate passed through
    out = msg.properties.headers["traceparent"]
    assert out == f"00-{TID}-{tr.w3c.root_span_id}-01"
    assert out != TRACEPARENT
    assert msg.properties.headers["tracestate"] == "k=v"
    assert bytes(msg.body) == b"payload"
    # full pipeline captured, attrs stamped for the query layer
    for stage in (ENQUEUE, DELIVER, SETTLE):
        assert tr.slots[stage] is not None
    assert tr.attrs["queue"] == "oq" and tr.attrs["vhost"] == "/"
    assert rt.metrics.otel_forced_samples == 1


async def test_malformed_traceparent_never_breaks_publish():
    msg, rt = await _deliver_roundtrip({"traceparent": "00-bogus",
                                        "other": "kept"})
    assert bytes(msg.body) == b"payload"
    # not sampled (rate 0, context invalid), header passed through as-is
    assert msg.properties.headers["traceparent"] == "00-bogus"
    assert msg.properties.headers["other"] == "kept"
    assert not rt.ring and rt.metrics.otel_forced_samples == 0


# ---------------------------------------------------------------------------
# OTLP render + exporter
# ---------------------------------------------------------------------------


def _finished_forced_trace(rt):
    tr = rt.begin_publish(headers={"traceparent": TRACEPARENT})
    rt.current = None
    rt.finish(tr)
    return tr


async def test_resource_spans_shape():
    rt = TraceRuntime(sample_rate=0.0, metrics=Metrics())
    tr = _finished_forced_trace(rt)
    doc = resource_spans([tr], {"service.name": "chanamq-tpu",
                                "chanamq.node": "n1"})
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert span_count(doc) == len(spans) >= 2
    root = next(s for s in spans if s["name"] == "broker")
    assert root["traceId"] == TID
    assert root["parentSpanId"] == SPAN
    assert root["spanId"] == tr.w3c.root_span_id
    for child in spans:
        if child is root:
            continue
        assert child["parentSpanId"] == root["spanId"]
        assert child["traceId"] == TID
        assert int(child["startTimeUnixNano"]) <= \
            int(child["endTimeUnixNano"])
    # the document is pure JSON (OTLP/HTTP collectors eat it directly)
    json.dumps(doc)
    # a seeded trace exports a parentless root under a derived trace id
    seeded = Trace("n1#9", "n1")
    seeded.span(ENQUEUE, 10, 20, "n1")
    sdoc = resource_spans([seeded], {"service.name": "x"})
    sroot = sdoc["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert sroot["traceId"] == derive_trace_id("n1#9")
    assert "parentSpanId" not in sroot


class _StubCollector:
    """Minimal OTLP/HTTP collector: accepts POST /v1/traces, records
    the JSON bodies, answers the configured status."""

    def __init__(self, status=b"200 OK"):
        self.status = status
        self.docs = []
        self.server = None

    async def start(self):
        self.server = await asyncio.start_server(
            self._handle, "127.0.0.1", 0)
        return self.server.sockets[0].getsockname()[1]

    async def stop(self):
        self.server.close()
        await self.server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
            length = int(re.search(
                rb"Content-Length: (\d+)", head).group(1))
            self.docs.append(json.loads(await reader.readexactly(length)))
            writer.write(b"HTTP/1.1 " + self.status
                         + b"\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
        finally:
            writer.close()


async def test_exporter_posts_otlp_batches():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    rt = trace.install(TraceRuntime(
        sample_rate=0.0, metrics=server.broker.metrics, node="n1"))
    collector = _StubCollector()
    port = await collector.start()
    otel = OtelExporter(
        server.broker, endpoint=f"http://127.0.0.1:{port}/v1/traces",
        flush_ms=20, max_batch=8)
    await otel.start()
    try:
        assert rt.export_hook == otel.on_trace  # bound methods: ==, not is
        for _ in range(3):
            _finished_forced_trace(rt)  # finish() fans into the hook
        await eventually(lambda: collector.docs, what="otlp post")
        doc = collector.docs[0]
        spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert all(s["traceId"] == TID for s in spans)
        res = {a["key"]: a["value"] for a in
               doc["resourceSpans"][0]["resource"]["attributes"]}
        assert res["service.name"] == {"stringValue": "chanamq-tpu"}
        m = server.broker.metrics
        assert m.otel_batches_sent >= 1
        assert m.otel_spans_exported >= 6  # 3 roots + >=1 stage each
        assert m.otel_export_errors == 0
        assert otel.queue_depth() == 0
    finally:
        await otel.stop()
        await collector.stop()
        await server.stop()
    assert rt.export_hook is None  # stop() disarms its own hook


async def test_exporter_requeues_on_collector_failure():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    rt = trace.install(TraceRuntime(
        sample_rate=0.0, metrics=server.broker.metrics, node="n1"))
    # port 1 refuses instantly: every flush fails fast through the
    # ReconnectBackoff and the batch goes back to the head of the queue
    otel = OtelExporter(server.broker,
                        endpoint="http://127.0.0.1:1/v1/traces",
                        flush_ms=20)
    await otel.start()
    try:
        _finished_forced_trace(rt)
        await eventually(
            lambda: server.broker.metrics.otel_export_errors >= 1,
            what="export failure")
        assert otel.queue_depth() == 1  # requeued, not dropped
        assert server.broker.metrics.otel_batches_sent == 0
        assert otel.status()["backoff"]["consecutive_failures"] >= 1
    finally:
        await otel.stop()
        await server.stop()


async def test_exporter_sheds_when_full():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    rt = trace.install(TraceRuntime(
        sample_rate=0.0, metrics=server.broker.metrics, node="n1"))
    otel = OtelExporter(server.broker, queue_size=2)  # collector-less
    await otel.start()
    try:
        for _ in range(5):
            _finished_forced_trace(rt)
        assert otel.queue_depth() == 2
        assert server.broker.metrics.otel_spans_shed == 3
    finally:
        await otel.stop()
        await server.stop()


# ---------------------------------------------------------------------------
# admin surface: pull export, trace query, exemplars
# ---------------------------------------------------------------------------


async def test_admin_otel_spans_pull():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        status, _ = await _http(admin.bound_port, "GET",
                                "/admin/otel/spans")
        assert status == 409  # tracing not installed
        rt = trace.install(TraceRuntime(
            sample_rate=0.0, metrics=server.broker.metrics, node="n1"))
        # no exporter: the rings serve the render
        _finished_forced_trace(rt)
        status, doc = await _http(admin.bound_port, "GET",
                                  "/admin/otel/spans")
        assert status == 200 and span_count(doc) >= 2
        # with the exporter installed the pull drains its queue
        otel = OtelExporter(server.broker)
        await otel.start()
        server.broker.otel = otel
        _finished_forced_trace(rt)
        assert otel.queue_depth() == 1
        status, doc = await _http(admin.bound_port, "GET",
                                  "/admin/otel/spans?limit=10")
        assert status == 200 and span_count(doc) >= 2
        assert otel.queue_depth() == 0
        assert server.broker.metrics.otel_pull_served == 1
        # drained: the next pull returns an empty document
        status, doc = await _http(admin.bound_port, "GET",
                                  "/admin/otel/spans")
        assert status == 200 and span_count(doc) == 0
        await otel.stop()
        server.broker.otel = None
    finally:
        await admin.stop()
        await server.stop()


async def test_admin_traces_filtering_and_otlp():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    rt = trace.install(TraceRuntime(
        sample_rate=1.0, metrics=server.broker.metrics, node="n1"))
    try:
        for i, (ex, q) in enumerate(
                [("orders", "q1"), ("orders", "q2"), ("audit", "q1")]):
            tr = rt.begin_publish()
            tr.attr("exchange", ex)
            tr.attr("queue", f"{q},shared")
            tr.attr("vhost", "/")
            rt.current = None
            rt.finish(tr)
        status, body = await _http(admin.bound_port, "GET",
                                   "/admin/traces?exchange=orders")
        assert status == 200 and body["matched"] == 2
        assert all(t["attrs"]["exchange"] == "orders"
                   for t in body["traces"])
        # queue filter matches any member of the comma-joined fanout set
        status, body = await _http(admin.bound_port, "GET",
                                   "/admin/traces?queue=shared")
        assert status == 200 and body["matched"] == 3
        status, body = await _http(
            admin.bound_port, "GET",
            "/admin/traces?queue=q1&exchange=audit")
        assert status == 200 and body["matched"] == 1
        status, body = await _http(admin.bound_port, "GET",
                                   "/admin/traces?vhost=missing")
        assert status == 200 and body["matched"] == 0
        # min_duration_us alone also selects the filtered view
        status, body = await _http(
            admin.bound_port, "GET",
            "/admin/traces?min_duration_us=999999999")
        assert status == 200 and body["matched"] == 0
        # ?format=otlp renders the matched set as one OTLP document
        status, doc = await _http(
            admin.bound_port, "GET",
            "/admin/traces?exchange=orders&format=otlp")
        assert status == 200 and "resourceSpans" in doc
        assert span_count(doc) >= 2
        # the unfiltered listing keeps its historical shape
        status, body = await _http(admin.bound_port, "GET",
                                   "/admin/traces")
        assert status == 200 and "recent" in body
        assert "stage_latency_us" in body and "traces" not in body
        # bad limit is a 400, not a 500
        status, body = await _http(admin.bound_port, "GET",
                                   "/admin/traces?exchange=x&limit=nope")
        assert status == 400
    finally:
        await admin.stop()
        await server.stop()


_EXEMPLAR_RE = re.compile(
    r'^chanamq_[a-z0-9_]+_bucket\{le="[^"]+"\} \d+ '
    r'# \{trace_id="[0-9a-f]{32}"\} [0-9.]+(e[+-]?\d+)? \d+(\.\d+)?$')


async def _scrape(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), 10)
    writer.close()
    return raw.partition(b"\r\n\r\n")[2].decode()


async def test_openmetrics_exemplars():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    rt = trace.install(TraceRuntime(
        sample_rate=0.0, metrics=server.broker.metrics, node="n1"))
    try:
        tr = _finished_forced_trace(rt)
        server.broker.metrics.publish_to_deliver_us.observe_us(
            tr.total_us)
        text = await _scrape(admin.bound_port,
                             "/metrics?format=openmetrics")
        lines = text.splitlines()
        assert lines[-1] == "# EOF"
        exemplar_lines = [l for l in lines if " # {" in l]
        assert exemplar_lines, "expected at least one exemplar"
        for line in exemplar_lines:
            assert _EXEMPLAR_RE.match(line), line
        # the propagated W3C trace id is the join key on every family
        # this trace populated
        assert any(f'trace_id="{TID}"' in l for l in exemplar_lines)
        # the plain scrape is untouched: no exemplars, no EOF marker
        plain = await _scrape(admin.bound_port, "/metrics")
        assert " # {" not in plain and "# EOF" not in plain
        # exemplar-covered families are exactly: supported or exempt
        # (the lint's runtime contract, also enforced by metrics_lint)
        assert "publish_to_deliver_us" in AdminServer._EXEMPLAR_FAMILIES
        assert not (AdminServer._EXEMPLAR_FAMILIES
                    & AdminServer._EXEMPLAR_EXEMPT)
    finally:
        await admin.stop()
        await server.stop()


# ---------------------------------------------------------------------------
# log join key
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# cross-cluster: one joined span tree over a federation link
# ---------------------------------------------------------------------------


async def test_federated_trace_joins_one_span_tree():
    """The acceptance walk: a client publishes with a
    traceparent on cluster A; the segment ships over the federation
    link; a consumer on cluster B receives it. The origin trace and the
    mirror trace must render as ONE OTLP tree under the client's trace
    id: client span -> origin broker root -> (stages) and origin root ->
    mirror root -> remote-apply/deliver."""
    a_srv, fed_a, b_srv, fed_b = await start_pair()
    rt = trace.install(TraceRuntime(
        sample_rate=0.0, metrics=a_srv.broker.metrics, node="cluster-a"))
    try:
        conn = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await conn.channel()
        await ch.confirm_select()
        await ch.queue_declare("fq", durable=True, arguments=STREAM_SMALL)
        props = BasicProperties(
            delivery_mode=2, headers={"traceparent": TRACEPARENT})
        for i in range(30):
            ch.basic_publish(f"f{i:06d}".encode(), routing_key="fq",
                             properties=props)
        await ch.wait_unconfirmed_below(1, timeout=15)
        sealed_tail = a_srv.broker.get_queue("/", "fq")._active_base
        assert sealed_tail > 1, "expected at least one sealed segment"
        await eventually(
            lambda: ("fq" in b_srv.broker.vhosts["/"].queues
                     and b_srv.broker.vhosts["/"].queues["fq"].next_offset
                     >= sealed_tail),
            what="mirror catch-up")
        b_queue = b_srv.broker.vhosts["/"].queues["fq"]
        # the apply path lifted the shipped contexts into mirror traces
        assert b_queue.fed_traces
        assert b_srv.broker.metrics.trace_ctx_recv >= sealed_tail - 1
        # stream-side origin traces completed at append (records are
        # copies; nothing settles the publish Message)
        origins = [t for t in rt.ring if t.slots[ENQUEUE] is not None
                   and t.slots[REMOTE_APPLY] is None]
        assert origins and all(t.w3c.trace_id == TID for t in origins)

        b_conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        b_ch = await b_conn.channel()
        await b_ch.basic_qos(prefetch_count=64)
        got = await collect(b_ch, "fq", sealed_tail - 1)
        # the mirrored record still carries the ORIGIN's outgoing
        # traceparent (same trace id end to end)
        out = got[0].properties.headers["traceparent"]
        assert out.startswith(f"00-{TID}-") and out != TRACEPARENT
        await eventually(
            lambda: any(t.slots[REMOTE_APPLY] is not None
                        for t in rt.ring),
            what="mirror trace settle")
        mirrors = [t for t in rt.ring
                   if t.slots[REMOTE_APPLY] is not None]
        mirror = mirrors[0]
        assert mirror.w3c.trace_id == TID
        assert mirror.attrs["federated"] == "1"
        assert mirror.attrs["queue"] == "fq"
        assert mirror.slots[DELIVER] is not None  # consumer leg captured
        # THE join: the mirror's parent is some origin trace's root span
        origin_roots = {t.w3c.root_span_id for t in origins}
        assert mirror.w3c.parent_span_id in origin_roots
        origin = next(t for t in origins
                      if t.w3c.root_span_id == mirror.w3c.parent_span_id)
        # render both halves as one OTLP document and walk the tree:
        # producer -> origin root -> mirror root, all one trace id
        doc = resource_spans([origin, mirror],
                             default_resource(a_srv.broker))
        spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert {s["traceId"] for s in spans} == {TID}
        by_id = {s["spanId"]: s for s in spans}
        mirror_root = by_id[mirror.w3c.root_span_id]
        origin_root = by_id[origin.w3c.root_span_id]
        assert mirror_root["parentSpanId"] == origin_root["spanId"]
        assert origin_root["parentSpanId"] == SPAN  # the producer's span
        # every stage span hangs off its half's root
        for s in spans:
            if s["spanId"] in (origin_root["spanId"],
                               mirror_root["spanId"]):
                continue
            assert s["parentSpanId"] in (origin_root["spanId"],
                                         mirror_root["spanId"])
        await b_conn.close()
        await conn.close()
    finally:
        trace.clear()
        await stop_pair(a_srv, fed_a, b_srv, fed_b)


# ---------------------------------------------------------------------------
# log join key
# ---------------------------------------------------------------------------


async def test_logjson_carries_w3c_trace_id():
    import logging

    from chanamq_tpu_torch.utils.logjson import JsonLogFormatter

    rt = trace.install(TraceRuntime(sample_rate=1.0, node="n1"))
    fmt = JsonLogFormatter()
    rec = logging.LogRecord("t", logging.INFO, "f", 1, "hello", None, None)
    # seeded sample: internal trace id only, no W3C join key
    rt.begin_publish()
    out = json.loads(fmt.format(rec))
    assert "trace" in out and "trace_id" not in out
    # propagated context: both ids appear
    rt.begin_publish(headers={"traceparent": TRACEPARENT})
    out = json.loads(fmt.format(rec))
    assert "trace" in out and out["trace_id"] == TID
    rt.current = None
    out = json.loads(fmt.format(rec))
    assert "trace" not in out and "trace_id" not in out
