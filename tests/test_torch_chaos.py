"""Fault-injection subsystem tests: deterministic plans, seam injection,
the /admin/chaos surface, reconnect backoff (jitter + admin state), the
mid-batch confirm-chain abort and promotion-during-ship regressions, and
the full seeded 3-node chaos soak.

The port's copy of ``tests/test_chaos.py``: imports point at
``chanamq_tpu_torch``, every broker's router and every soak on the CPU;
the assertions are the reference's.
"""

import asyncio
import json

import pytest

from chanamq_tpu_torch import chaos
from chanamq_tpu_torch.amqp.properties import BasicProperties
from chanamq_tpu_torch.broker.broker import Broker
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.chaos import ChaosStore, FaultPlan, FaultRule, _LazyRuntime
from chanamq_tpu_torch.chaos.soak import run_soak
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.cluster.node import ClusterNode
from chanamq_tpu_torch.cluster.rpc import ReconnectBackoff, RpcClient, RpcError
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.store.memory import MemoryStore
from chanamq_tpu_torch.utils.metrics import Metrics

pytestmark = pytest.mark.asyncio

PERSISTENT = BasicProperties(delivery_mode=2)


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos.clear()


# ---------------------------------------------------------------------------
# FaultPlan determinism + trigger semantics
# ---------------------------------------------------------------------------

def _prob_plan(seed):
    return FaultPlan(seed, [
        FaultRule(name="maybe", kind="latency", sites=["x.*"],
                  probability=0.4, delay_ms=1),
    ])


def test_same_seed_same_decision_sequence():
    p1, p2 = _prob_plan(99), _prob_plan(99)
    seq1 = [p1.decide("x.op") is not None for _ in range(200)]
    seq2 = [p2.decide("x.op") is not None for _ in range(200)]
    assert seq1 == seq2
    assert any(seq1) and not all(seq1)  # probability actually gated draws
    assert p1.fingerprint() == p2.fingerprint()


def test_different_seed_different_schedule():
    seq1 = [_prob_plan(1).decide("x.op") is not None for _ in range(200)]
    p2 = _prob_plan(2)
    seq2 = [p2.decide("x.op") is not None for _ in range(200)]
    assert seq1 != seq2
    assert _prob_plan(1).fingerprint() != p2.fingerprint()


def test_fingerprint_ignores_endpoint_bindings():
    """Ephemeral host:port targets must not break same-seed reproduction."""
    def plan(port):
        return FaultPlan(5, [FaultRule(
            name="part", kind="partition", sites=["data.send"],
            nodes=[f"127.0.0.1:{port}"])])
    assert plan(1111).fingerprint() == plan(2222).fingerprint()


def test_count_window_and_site_triggers():
    plan = FaultPlan(0, [
        FaultRule(name="once", kind="error", sites=["a"], count=1),
        FaultRule(name="windowed", kind="drop", sites=["b"],
                  after=2, until=4),
    ])
    # count: fires exactly once despite always-eligible probability
    fires = [plan.decide("a") is not None for _ in range(5)]
    assert fires == [True, False, False, False, False]
    # window [after, until): armed only for matching invocations 3..4
    fires = [plan.decide("b") is not None for _ in range(6)]
    assert fires == [False, False, True, True, False, False]
    # site mismatch never counts an invocation
    assert plan.decide("c") is None
    counters = plan.counters()
    assert counters["once"] == {"kind": "error", "invocations": 5, "fires": 1}
    assert counters["windowed"]["fires"] == 2


def test_peer_glob_and_partition_ctx():
    plan = FaultPlan(0, [
        FaultRule(name="peered", kind="error", sites=["s"], peer="10.0.*"),
        FaultRule(name="part", kind="partition", sites=["s"],
                  nodes=["1.2.3.4:9"]),
    ])
    assert plan.decide("s", peer="10.0.0.5") is not None  # peered matches
    assert plan.decide("s", peer="1.2.3.4:9") is not None  # partition node
    assert plan.decide("s", peer="192.168.0.1") is None


def test_plan_round_trips_through_json():
    plan = FaultPlan(3, [FaultRule(name="r", kind="disconnect",
                                   sites=["rpc.*"], probability=0.5,
                                   count=2, after=1, delay_ms=7)])
    clone = FaultPlan.from_dict(json.loads(json.dumps(plan.to_dict())))
    assert clone.fingerprint() == plan.fingerprint()
    with pytest.raises(ValueError):
        FaultRule(name="bad", kind="nope")
    with pytest.raises(ValueError):
        FaultPlan(0, [FaultRule(name="dup", kind="drop"),
                      FaultRule(name="dup", kind="drop")])


# ---------------------------------------------------------------------------
# Runtime hook + metrics + store seam
# ---------------------------------------------------------------------------

async def test_install_clear_and_metrics_accounting():
    assert chaos.ACTIVE is None
    metrics = Metrics()
    runtime = chaos.install(FaultPlan(0, [
        FaultRule(name="err", kind="error", sites=["s"], count=2),
        FaultRule(name="lat", kind="latency", sites=["t"], count=1),
    ]), metrics=metrics)
    assert chaos.ACTIVE is runtime
    with pytest.raises(OSError):
        await runtime.fire("s")
    await runtime.fire("t")  # latency: slept (0ms) in place, no raise
    assert metrics.chaos_fires == 2
    assert metrics.chaos_errors == 1 and metrics.chaos_latency == 1
    status = runtime.status()
    assert status["total_fires"] == 2
    assert [e["rule"] for e in status["fire_log_tail"]] == ["err", "lat"]
    chaos.clear()
    assert chaos.ACTIVE is None


async def test_chaos_store_injects_and_passes_through():
    inner = MemoryStore()
    await inner.open()
    store = ChaosStore(inner, _LazyRuntime())
    # no plan installed: pure delegation
    await store.insert_vhost("v1")
    assert ("v1", True) in await store.all_vhosts()
    chaos.install(FaultPlan(0, [
        FaultRule(name="read-err", kind="error", sites=["store.read"],
                  count=1),
        FaultRule(name="write-drop", kind="drop", sites=["store.write"],
                  count=1),
    ]))
    with pytest.raises(OSError):
        await store.all_vhosts()
    await store.insert_vhost("v2")  # dropped: silently did nothing
    assert ("v2", True) not in await store.all_vhosts()
    await store.insert_vhost("v3")  # drop count exhausted: lands
    assert ("v3", True) in await store.all_vhosts()
    chaos.clear()
    await store.flush()  # flush barrier delegates cleanly with chaos off
    await inner.close()


# ---------------------------------------------------------------------------
# Satellite: ReconnectBackoff decorrelated jitter
# ---------------------------------------------------------------------------

async def test_backoff_jitter_envelope():
    backoff = ReconnectBackoff(base_s=0.1, max_s=5.0)
    prev = backoff.base_s
    for n in range(1, 12):
        backoff.failed()
        delay = backoff._delay_s
        assert backoff.base_s <= delay <= min(5.0, prev * 3) + 1e-9
        assert backoff.failures == n
        prev = max(delay, backoff.base_s)
    with pytest.raises(RpcError):
        backoff.check()
    backoff.succeeded()
    # dial success clears only the suppression window; the delay and
    # failure count survive until enough clean calls round-trip
    backoff.check()  # no longer suppressed...
    assert backoff.failures == 11  # ...but history is not forgiven yet
    for _ in range(backoff.clean_reset_calls):
        backoff.note_clean()
    assert backoff.state() == {"delay_s": 0.0, "consecutive_failures": 0}


async def test_backoff_flapping_peer_keeps_delay():
    """A peer that accepts the dial then drops every call must not get its
    backoff zeroed by the dial alone — that was a tight reconnect loop."""
    backoff = ReconnectBackoff(base_s=0.1, max_s=5.0, clean_reset_calls=4)
    for _ in range(5):
        backoff.failed()      # dial refused a few times
    for _ in range(3):
        backoff.succeeded()   # dial lands...
        backoff.note_clean()  # ...one call round-trips...
        backoff.failed()      # ...then the peer drops the connection
    # the jittered delay may wander, but it is never zeroed mid-flap and
    # the failure streak keeps compounding across the fake recoveries
    assert backoff._delay_s >= backoff.base_s
    assert backoff.failures == 8
    # sustained health: a full run of clean calls resets to base
    backoff.succeeded()
    for _ in range(4):
        backoff.note_clean()
    assert backoff.state() == {"delay_s": 0.0, "consecutive_failures": 0}
    # and a healthy-from-birth backoff never counts clean calls
    fresh = ReconnectBackoff(clean_reset_calls=2)
    for _ in range(10):
        fresh.note_clean()
    assert fresh._clean_calls == 0


async def test_backoff_jitter_spreads_clients():
    """The point of decorrelation: two clients failing in lockstep must not
    share a delay sequence (with the unseeded module RNG)."""
    seqs = []
    for _ in range(2):
        backoff = ReconnectBackoff(base_s=0.05, max_s=60.0)
        for _ in range(8):
            backoff.failed()
        seqs.append(backoff._delay_s)
    # 8 compounding uniform draws: collision is ~impossible
    assert seqs[0] != seqs[1]


async def test_backoff_deterministic_when_chaos_seeded():
    def run():
        chaos.install(FaultPlan(77, [
            FaultRule(name="idle", kind="latency", sites=["nowhere"])]))
        backoff = ReconnectBackoff(base_s=0.1, max_s=5.0)
        seq = []
        for _ in range(6):
            backoff.failed()
            seq.append(backoff._delay_s)
        chaos.clear()
        return seq
    assert run() == run()


# ---------------------------------------------------------------------------
# Satellite: backoff state in /admin/cluster; /admin/chaos endpoints
# ---------------------------------------------------------------------------

async def _admin_request(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
        f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0].decode(), json.loads(payload)


async def _start_pair(**kwargs):
    async def one(seeds):
        srv = BrokerServer(broker=Broker(store=MemoryStore(), router_device="cpu"),
                           host="127.0.0.1", port=0, heartbeat_s=0)
        await srv.start()
        cl = ClusterNode(srv.broker, "127.0.0.1", 0, seeds,
                         heartbeat_interval_s=0.1, failure_timeout_s=0.8,
                         **kwargs)
        await cl.start()
        return srv, cl

    a_srv, a_cl = await one([])
    b_srv, b_cl = await one([a_cl.name])
    for _ in range(100):
        if (len(a_cl.membership.alive_members()) == 2
                and len(b_cl.membership.alive_members()) == 2):
            break
        await asyncio.sleep(0.05)
    else:
        raise RuntimeError("membership did not converge")
    return a_srv, a_cl, b_srv, b_cl


async def _stop_all(*parts):
    for part in parts:
        if part is not None:
            try:
                await part.stop()
            except Exception:
                pass


async def test_admin_cluster_reports_backoff_state(tmp_path):
    a_srv, a_cl, b_srv, b_cl = await _start_pair()
    admin = AdminServer(b_srv.broker, port=0)
    await admin.start()
    conn = None
    try:
        qn = next(f"aq{i}" for i in range(200)
                  if a_cl.queue_owner("/", f"aq{i}") == a_cl.name)
        conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        ch = await conn.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn, durable=True)
        await ch.basic_publish_confirmed(b"x", routing_key=qn, timeout=10)

        status, payload = await _admin_request(
            admin.bound_port, "GET", "/admin/cluster")
        assert status.startswith("HTTP/1.1 200")
        inter = payload["interconnect"]
        # data plane: every stream reports its backoff posture
        assert inter["peers"], "remote publish should have opened a plane"
        for stats in inter["peers"].values():
            for st in stats["backoff"]:
                assert set(st) == {"delay_s", "consecutive_failures",
                                   "last_error"}
        # control plane: gossip clients report theirs too
        assert inter["control"]
        for st in inter["control"].values():
            assert st["consecutive_failures"] == 0
    finally:
        if conn is not None:
            await conn.close()
        await admin.stop()
        await _stop_all(b_cl, b_srv, a_cl, a_srv)


async def test_rpc_client_records_last_error():
    # a port with nothing listening: dial fails, state must say so
    probe = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
    port = probe.sockets[0].getsockname()[1]
    probe.close()
    await probe.wait_closed()
    client = RpcClient("127.0.0.1", port, connect_timeout_s=0.5)
    with pytest.raises((RpcError, OSError)):
        await client.call("ping", {}, timeout_s=1)
    state = client.backoff_state()
    assert state["consecutive_failures"] >= 1
    assert state["delay_s"] > 0
    assert state["last_error"]
    await client.close()


async def test_admin_chaos_endpoints():
    srv = BrokerServer(broker=Broker(store=MemoryStore(), router_device="cpu"),
                       host="127.0.0.1", port=0, heartbeat_s=0)
    await srv.start()
    admin = AdminServer(srv.broker, port=0)
    await admin.start()
    try:
        # not chaos-capable: install refused
        body = json.dumps({"seed": 11, "rules": [
            {"name": "lat", "kind": "latency", "sites": ["s"],
             "delay_ms": 1}]}).encode()
        status, payload = await _admin_request(
            admin.bound_port, "POST", "/admin/chaos/install", body)
        assert status.startswith("HTTP/1.1 409")
        assert "chaos disabled" in payload["error"]

        srv.broker.chaos_enabled = True
        status, payload = await _admin_request(
            admin.bound_port, "POST", "/admin/chaos/install", body)
        assert status.startswith("HTTP/1.1 200")
        assert payload["seed"] == 11 and payload["rules"] == ["lat"]
        fingerprint = payload["fingerprint"]

        await chaos.ACTIVE.fire("s")
        status, payload = await _admin_request(
            admin.bound_port, "GET", "/admin/chaos")
        assert payload["enabled"] and payload["installed"]
        assert payload["fingerprint"] == fingerprint
        assert payload["rules"]["lat"]["fires"] == 1
        assert payload["total_fires"] == 1

        # chaos_* land in the Prometheus scrape as counters
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", admin.bound_port)
        writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        scrape = (await reader.read()).decode()
        writer.close()
        assert "# TYPE chanamq_chaos_fires counter" in scrape
        assert "chanamq_chaos_fires 1" in scrape

        status, payload = await _admin_request(
            admin.bound_port, "POST", "/admin/chaos/clear")
        assert payload == {"ok": True, "total_fires": 1}
        assert chaos.ACTIVE is None
        status, payload = await _admin_request(
            admin.bound_port, "GET", "/admin/chaos")
        assert payload == {"enabled": True, "installed": False}

        # wrong verb on a known chaos path: 405, not 404
        status, payload = await _admin_request(
            admin.bound_port, "GET", "/admin/chaos/clear")
        assert status.startswith("HTTP/1.1 405")
    finally:
        await admin.stop()
        await srv.stop()


# ---------------------------------------------------------------------------
# Regression: mid-batch transport failure under the pipelined confirm chain
# ---------------------------------------------------------------------------

async def test_midbatch_send_failure_aborts_confirm_chain():
    """A transport fault in the middle of a pipelined push_many burst must
    abort the ordered confirm chain: the client sees a prefix of confirms
    then a dead connection — never a confirm for an unpushed message, and
    never a deadlocked confirm wait."""
    a_srv, a_cl, b_srv, b_cl = await _start_pair()
    conn = drain_conn = None
    try:
        qn = next(f"mq{i}" for i in range(200)
                  if a_cl.queue_owner("/", f"mq{i}") == a_cl.name)
        conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        ch = await conn.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn, durable=True)
        for _ in range(100):
            if ("/", qn) in b_cl.queue_metas:
                break
            await asyncio.sleep(0.05)

        # first data.send passes, the second dies mid-pipeline
        chaos.install(FaultPlan(1, [FaultRule(
            name="mid", kind="error", sites=["data.send"],
            after=1, count=1)]))

        n = 400
        async def burst():
            for i in range(n):
                ch.basic_publish(f"b{i:05d}".encode(), routing_key=qn,
                                 properties=PERSISTENT)
                if i == n // 2:
                    # split the burst across flush windows so the fault
                    # lands between batches of one confirm chain
                    await asyncio.sleep(0.02)
            await ch.wait_unconfirmed_below(1, timeout=20)

        # no deadlock: the burst either confirms fully (fault hit a settle
        # frame instead) or fails fast with the aborted connection
        aborted = False
        try:
            await asyncio.wait_for(burst(), 30)
        except Exception:
            aborted = True
        confirmed = n - len(ch.unconfirmed)
        fired = chaos.ACTIVE.plan.counters()["mid"]["fires"]
        assert fired == 1, "fault rule must have fired mid-burst"
        assert aborted, "a mid-batch send failure must abort the connection"
        assert confirmed < n, "no false confirm for the failed batch"
        chaos.clear()

        # every confirm the client DID receive is a real stored message:
        # drain the queue and check prefix containment
        drain_conn = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        dch = await drain_conn.channel()
        got = set()
        done = asyncio.Event()

        def cb(msg):
            got.add(bytes(msg.body).decode())
            done.set()

        await dch.basic_consume(qn, cb, no_ack=True)
        while True:
            done.clear()
            try:
                await asyncio.wait_for(done.wait(), 1.0)
            except asyncio.TimeoutError:
                break
        expected_prefix = {f"b{i:05d}" for i in range(confirmed)}
        assert expected_prefix <= got
    finally:
        chaos.clear()
        for c in (conn, drain_conn):
            if c is not None:
                try:
                    await c.close()
                except Exception:
                    pass
        await _stop_all(b_cl, b_srv, a_cl, a_srv)


# ---------------------------------------------------------------------------
# Regression: promotion while the mutation-log ship is in flight
# ---------------------------------------------------------------------------

async def test_promotion_after_dropped_ship_batch_heals_via_resync():
    """Drop the owner's first ship batch mid-flight: the follower must
    gap-detect on the next batch and resync (trigger not lost), and after
    the owner dies the promoted replica must hold every confirmed message
    exactly once (no torn batch applied)."""
    a_srv, a_cl, b_srv, b_cl = await _start_pair(
        replicate_factor=2, replicate_sync=True,
        replicate_ack_timeout_ms=500)
    conn = None
    try:
        qn = next(f"pq{i}" for i in range(200)
                  if a_cl.queue_owner("/", f"pq{i}") == a_cl.name)
        chaos.install(FaultPlan(2, [FaultRule(
            name="drop-ship", kind="drop", sites=["repl.ship"], count=1)]))

        conn = await AMQPClient.connect("127.0.0.1", a_srv.bound_port)
        ch = await conn.channel()
        await ch.confirm_select()
        await ch.queue_declare(qn, durable=True)
        bodies = [f"r{i}".encode() for i in range(5)]
        for body in bodies:
            # first confirm rides the dropped batch: it gates on the sync
            # barrier's ack timeout, then proceeds (follower will resync)
            await ch.basic_publish_confirmed(
                body, routing_key=qn, properties=PERSISTENT, timeout=10)

        # follower heals: gap detected on the next batch -> wholesale resync
        owner_log = a_cl.replication._logs[("/", qn)]
        for _ in range(200):
            copies = b_cl.replication.applier.copies
            if copies and all(c.applied_seq >= owner_log.seq
                              for c in copies.values()):
                break
            await asyncio.sleep(0.05)
        else:
            raise AssertionError("follower never caught up after drop")
        assert b_srv.broker.metrics.repl_resyncs >= 1, \
            "gap-detect resync trigger was lost"
        chaos.clear()
        await conn.close()
        conn = None

        # owner dies abruptly; B must promote and serve the full set
        await _stop_all(a_cl, a_srv)
        for _ in range(100):
            if b_srv.broker.metrics.repl_promotions == 1:
                break
            await asyncio.sleep(0.05)
        assert b_srv.broker.metrics.repl_promotions == 1

        conn = await AMQPClient.connect("127.0.0.1", b_srv.bound_port)
        ch = await conn.channel()
        got = []
        done = asyncio.Event()

        def cb(msg):
            got.append(bytes(msg.body).decode())
            if len(got) >= len(bodies):
                done.set()

        await ch.basic_consume(qn, cb, no_ack=True)
        await asyncio.wait_for(done.wait(), 10)
        await asyncio.sleep(0.3)  # a torn apply would surface extras here
        assert sorted(got) == sorted(b.decode() for b in bodies)
    finally:
        chaos.clear()
        if conn is not None:
            try:
                await conn.close()
            except Exception:
                pass
        await _stop_all(b_cl, b_srv, a_cl, a_srv)


# ---------------------------------------------------------------------------
# The seeded soak: every invariant under partition + crash + slow store
# ---------------------------------------------------------------------------

async def test_seeded_soak_holds_all_invariants():
    report = await asyncio.wait_for(
        run_soak(42, messages=80, stream_records=30, device="cpu"), timeout=120)
    assert report["violations"] == []
    assert report["crashed"] is True
    assert report["promotions"] == 1
    assert report["confirmed"] == 80
    assert report["delivered_unique"] == 80
    assert report["post_settle_duplicates"] == 0
    assert report["stream"]["contiguous"] is True
    # health gate: all three nodes reported ready before load was offered
    assert all(report["health_gate"].values())
    assert len(report["health_gate"]) == 3
    # the replica holder promotes; both survivors re-hash once each
    assert report["handoffs"] == 2
    # the scripted alert phase fired exactly the expected rules
    from chanamq_tpu_torch.chaos.soak import EXPECTED_ALERT_RULES
    assert tuple(report["alerts"]["fired_rules"]) == EXPECTED_ALERT_RULES
    # reproducibility: the installed plan's schedule is seed-determined
    from chanamq_tpu_torch.chaos.soak import default_plan
    assert (default_plan(42, "any:1", 80).fingerprint()
            == report["fingerprint"])
