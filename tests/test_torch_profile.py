"""Continuous profiling: cost ledger, sampler/watchdog/GC hooks, admin
surface, and the bench-trajectory regression verdict.

Covers the profiling subsystem end to end: the fixed-stage
accumulators against a hand-driven oracle, the ``ACTIVE is None``
disabled path, folded-stack sampling of a synthetic busy loop, the
event-loop stall watchdog (capture + ring + counter + structured log
line), GC pause attribution, the /admin/profile route conventions
alongside the telemetry ones, Prometheus export, and the pure
``regress_evaluate`` verdict on doctored trajectory records.

The port's copy of ``tests/test_profile.py``: imports point at
``chanamq_tpu_torch`` (the verdict cases at the port's
``chanamq_tpu_torch.bench``), every broker's router on the CPU; the
assertions are the reference's. The folded-stack case names this file.
"""

import asyncio
import gc
import json
import logging
import threading
import time

import pytest

from chanamq_tpu_torch import bench, profile
from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.profile.runtime import ProfileRuntime
from chanamq_tpu_torch.profile.sampler import fold_stack
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.utils.logjson import JsonLogFormatter
from chanamq_tpu_torch.utils.metrics import Metrics
from chanamq_tpu_torch.broker.broker import Broker

pytestmark = pytest.mark.asyncio


async def http_req(port: int, path: str, method: str = "GET") -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 20), 5)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    return status, json.loads(body) if body else {}


async def http_req_text(port: int, path: str) -> tuple[int, str, str]:
    """GET returning (status, content-type, body-text) for text routes."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 20), 5)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    ctype = ""
    for line in lines[1:]:
        if line.lower().startswith("content-type:"):
            ctype = line.split(":", 1)[1].strip()
    return int(lines[0].split()[1]), ctype, body.decode()


# ---------------------------------------------------------------------------
# ledger accumulators vs oracle
# ---------------------------------------------------------------------------


def test_ledger_matches_oracle():
    rt = ProfileRuntime(gc_hook=False)
    # drive the accumulators the way the seams do and keep a dict oracle
    oracle_ns = {}
    oracle_calls = {}
    plan = [
        (profile.ROUTE, 1500, 3),
        (profile.ENQUEUE, 2500, 3),
        (profile.ROUTE, 700, 1),
        (profile.WAL_APPEND, 9000, 1),
        (profile.DISPATCH, 50_000, 1),
        (profile.DELIVER, 50_000, 4),  # shares the dispatch window
    ]
    for stage, dt, calls in plan:
        rt.note(stage, dt, calls)
        oracle_ns[stage] = oracle_ns.get(stage, 0) + dt
        oracle_calls[stage] = oracle_calls.get(stage, 0) + calls
    for stage, want in oracle_ns.items():
        assert int(rt.stage_ns[stage]) == want
        assert int(rt.stage_calls[stage]) == oracle_calls[stage]
    snap = rt.snapshot()
    route = snap["stages"]["route"]
    assert route["ns"] == 2200 and route["calls"] == 4
    assert route["us_per_call"] == round(2200 / 4 / 1000.0, 3)
    # busy = top-level windows only; fine stages must not inflate it
    assert snap["busy_ns"] == 50_000
    # subsystem rollup sums the fine stages only, never top-level or GC
    assert snap["subsystems"]["router"]["ns"] == 2200
    assert snap["subsystems"]["wal"]["ns"] == 9000
    # enqueue + deliver only: the 50 µs dispatch window itself stays out
    assert snap["subsystems"]["broker"]["ns"] == 2500 + 50_000


def test_ledger_hand_timed_window():
    """A real timed busy window lands in the right stage within a loose
    tolerance (the accumulator is exact; the tolerance covers the timer
    reads around the busy loop)."""
    rt = ProfileRuntime(gc_hook=False)
    t0 = time.perf_counter_ns()
    deadline = t0 + 20_000_000  # 20 ms
    x = 0
    while time.perf_counter_ns() < deadline:
        x += 1
    dt = time.perf_counter_ns() - t0
    rt.note(profile.SETTLE, dt)
    got = int(rt.stage_ns[profile.SETTLE])
    assert got == dt
    assert 15_000_000 < got < 500_000_000
    detail = rt.stage_detail("settle")
    assert detail["calls"] == 1 and detail["ns"] == dt
    assert rt.stage_detail("not-a-stage") is None


def test_disabled_path_and_clear():
    # the module gate defaults to off: seams see None and skip everything
    assert profile.ACTIVE is None
    rt = profile.install(ProfileRuntime(gc_hook=False))
    assert profile.ACTIVE is rt
    prof = profile.ACTIVE
    if prof is not None:  # the exact seam shape used on hot paths
        prof.stage_ns[profile.ROUTE] += 10
        prof.stage_calls[profile.ROUTE] += 1
    assert int(rt.stage_ns[profile.ROUTE]) == 10
    profile.clear()
    assert profile.ACTIVE is None
    # cleared: the seam gate short-circuits, nothing accumulates anywhere
    prof = profile.ACTIVE
    assert prof is None


def test_stage_table_shape():
    # append-only contract: indices are load-bearing for Prometheus series
    assert profile.STAGES.index("route") == profile.ROUTE
    assert profile.STAGES.index("ingress-cycle") == profile.INGRESS_CYCLE
    assert len(profile.STAGES) == len(profile.SUBSYSTEMS)
    assert profile.TOP_LEVEL <= set(range(len(profile.STAGES)))
    assert profile.GC not in profile.TOP_LEVEL


# ---------------------------------------------------------------------------
# sampler: folded stacks + watchdog + GC
# ---------------------------------------------------------------------------


def _busy_ms(ms: float) -> None:
    deadline = time.perf_counter() + ms / 1000.0
    while time.perf_counter() < deadline:
        pass


def test_fold_stack_format():
    import sys

    frame = sys._getframe()
    folded = fold_stack(frame)
    parts = folded.split(";")
    assert parts, folded
    # leaf is this function, rendered as `name (file:line)`
    assert parts[-1].startswith("test_fold_stack_format (")
    assert "test_torch_profile.py:" in parts[-1]


def test_sampler_folds_busy_thread_stacks():
    rt = ProfileRuntime(sample_hz=200, slow_callback_ms=0, gc_hook=False)
    rt.start()  # no running loop: ledger + sampler only
    # repoint the sampler at a synthetic "loop" thread we keep busy
    # (start() stamps the caller's thread id, so repoint afterwards)
    ready = threading.Event()
    stop = threading.Event()

    def pinned_loop():
        ready.set()
        while not stop.is_set():
            _busy_ms(1)

    t = threading.Thread(target=pinned_loop, daemon=True)
    t.start()
    ready.wait(5)
    rt.loop_thread_id = t.ident
    try:
        deadline = time.time() + 5
        while time.time() < deadline and rt.sampler.samples < 10:
            time.sleep(0.02)
        assert rt.sampler.samples >= 10
        collapsed = rt.collapsed()
        assert collapsed
        stack, _, count = collapsed.splitlines()[0].rpartition(" ")
        assert int(count) >= 1 and ";" in stack
        assert any("pinned_loop" in ln or "_busy_ms" in ln
                   for ln in collapsed.splitlines())
        snap = rt.snapshot()
        assert snap["sampler"]["samples"] == rt.sampler.samples
        assert snap["sampler"]["distinct_stacks"] >= 1
    finally:
        stop.set()
        rt.stop()
        t.join(5)


async def test_watchdog_captures_slow_callback(caplog):
    rt = ProfileRuntime(sample_hz=0, slow_callback_ms=40, ring_size=8,
                        gc_hook=False)
    rt.start()
    try:
        await asyncio.sleep(0.05)  # let the heartbeat establish a beat
        with caplog.at_level(logging.WARNING, logger="chanamq.profile"):
            _busy_ms(300)  # pin the loop well past threshold + 2 ticks
            # yield so the heartbeat resumes and the episode closes
            deadline = time.time() + 5
            while time.time() < deadline and rt.sampler.slow_count == 0:
                await asyncio.sleep(0.02)
        assert rt.sampler.slow_count >= 1
        entry = rt.sampler.ring[-1]
        assert entry["duration_ms"] >= 40
        assert entry["stack"]  # the offending callback got a name
        snap = rt.snapshot()
        assert snap["slow_callbacks"]["count"] == rt.sampler.slow_count
        assert snap["slow_callbacks"]["recent"]
        # the structured log line carried the folded stack via extra=data
        recs = [r for r in caplog.records if r.name == "chanamq.profile"]
        assert recs and getattr(recs[-1], "data")["stack"] == entry["stack"]
    finally:
        rt.stop()


def test_watchdog_bumps_metric_counter():
    m = Metrics()
    rt = ProfileRuntime(metrics=m, sample_hz=0, slow_callback_ms=40,
                        gc_hook=False)
    rt.sampler = None
    from chanamq_tpu_torch.profile.sampler import Sampler

    s = Sampler(rt)
    rt.sampler = s
    s._stall_beat = 1
    s._stall_max_ns = 50_000_000
    s._stall_stack = "a;b;c"
    s._finish_stall()
    assert s.slow_count == 1
    assert m.profile_slow_callbacks_total == 1
    assert m.snapshot()["profile_slow_callbacks_total"] == 1


def test_gc_pause_capture():
    m = Metrics()
    rt = ProfileRuntime(metrics=m, gc_hook=True)
    rt.start()
    try:
        before = rt.gc_pauses
        gc.collect()
        assert rt.gc_pauses > before
        assert rt.gc_pause_ns > 0
        assert int(rt.stage_calls[profile.GC]) == rt.gc_pauses
        assert int(rt.stage_ns[profile.GC]) == rt.gc_pause_ns
        assert rt.gc_max_pause_ns <= rt.gc_pause_ns
        assert m.profile_gc_pauses_total == rt.gc_pauses
        snap = rt.snapshot()
        assert snap["gc"]["pauses"] == rt.gc_pauses
    finally:
        rt.stop()
    # stop() unhooks: further collections no longer accumulate
    after = rt.gc_pauses
    gc.collect()
    assert rt.gc_pauses == after


def test_logjson_merges_data_dict():
    fmt = JsonLogFormatter()
    rec = logging.LogRecord("chanamq.profile", logging.WARNING, __file__, 1,
                            "slow event-loop callback: %.1f ms", (51.2,), None)
    rec.data = {"node": "n1:5672", "duration_ms": 51.2, "stack": "a;b 1"}
    out = json.loads(fmt.format(rec))
    assert out["node"] == "n1:5672"
    assert out["duration_ms"] == 51.2
    assert out["stack"] == "a;b 1"
    assert out["msg"].startswith("slow event-loop callback")


# ---------------------------------------------------------------------------
# admin surface (the telemetry routes' conventions)
# ---------------------------------------------------------------------------


@pytest.fixture
async def profile_stack():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    rt = ProfileRuntime(metrics=server.broker.metrics, sample_hz=100,
                        slow_callback_ms=0, broker=server.broker)
    server.broker.profile = rt
    profile.install(rt)
    rt.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    yield server, admin, rt
    profile.clear()
    server.broker.profile = None
    await admin.stop()
    await server.stop()


async def test_admin_profile_get_and_405(profile_stack):
    server, admin, rt = profile_stack
    # traffic so the ledger has something: publish through a real client
    c = await AMQPClient.connect("127.0.0.1", server.bound_port)
    ch = await c.channel()
    await ch.queue_declare("pq")
    for i in range(30):
        ch.basic_publish(b"x" * 64, routing_key="pq")
    await asyncio.sleep(0.2)
    await c.close()

    status, snap = await http_req(admin.bound_port, "/admin/profile")
    assert status == 200
    assert set(snap["stages"]) == set(profile.STAGES)
    assert snap["stages"]["route"]["calls"] >= 30
    assert snap["stages"]["enqueue"]["calls"] >= 30
    assert snap["busy_ns"] > 0 and snap["loop_cpu_ns"] > 0
    assert snap["node"] == server.broker.trace_node

    status, body = await http_req(admin.bound_port, "/admin/profile", "POST")
    assert status == 405 and body == {"error": "use GET"}

    status, det = await http_req(admin.bound_port, "/admin/profile/stage/route")
    assert status == 200 and det["stage"] == "route" and det["calls"] >= 30
    status, body = await http_req(
        admin.bound_port, "/admin/profile/stage/nope")
    assert status == 404 and "unknown stage" in body["error"]


async def test_admin_profile_stacks_text(profile_stack):
    server, admin, rt = profile_stack
    deadline = time.time() + 5
    while time.time() < deadline and rt.sampler.samples < 5:
        await asyncio.sleep(0.02)
    status, ctype, text = await http_req_text(
        admin.bound_port, "/admin/profile/stacks")
    assert status == 200
    assert ctype.startswith("text/plain")
    assert text.strip()
    stack, _, count = text.splitlines()[0].rpartition(" ")
    assert int(count) >= 1 and ";" in stack


async def test_admin_profile_disabled_409():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        for path in ("/admin/profile", "/admin/profile/stacks",
                     "/admin/profile/stage/route"):
            status, body = await http_req(admin.bound_port, path)
            assert status == 409, path
            assert "disabled" in body["error"], path
    finally:
        await admin.stop()
        await server.stop()


async def test_admin_profile_stacks_409_without_sampler():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    rt = ProfileRuntime(sample_hz=0, slow_callback_ms=0, gc_hook=False,
                        broker=server.broker)
    server.broker.profile = rt
    rt.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        status, body = await http_req(admin.bound_port,
                                      "/admin/profile/stacks")
        assert status == 409 and "sample-hz" in body["error"]
        # the snapshot itself still serves fine without the sampler
        status, snap = await http_req(admin.bound_port, "/admin/profile")
        assert status == 200 and snap["sampler"]["hz"] == 0
    finally:
        rt.stop()
        server.broker.profile = None
        await admin.stop()
        await server.stop()


async def test_prometheus_profile_series(profile_stack):
    server, admin, rt = profile_stack
    rt.note(profile.ROUTE, 12345, 7)
    status, ctype, text = await http_req_text(admin.bound_port, "/metrics")
    assert status == 200
    assert 'chanamq_profile_stage_ns_total{stage="route"}' in text
    assert 'chanamq_profile_stage_calls_total{stage="route"}' in text
    for name in profile.STAGES:
        assert f'stage="{name}"' in text, name
    assert "chanamq_profile_samples_total" in text
    assert "chanamq_profile_gc_pauses_total" in text


# ---------------------------------------------------------------------------
# regression verdict on doctored trajectory records
# ---------------------------------------------------------------------------


def _rec(wall, cpu, scenario="s"):
    return {"scenario": scenario, "us_per_msg": wall, "cpu_us_per_msg": cpu}


def test_regress_both_over_fails():
    v = bench.regress_evaluate(_rec(130.0, 23.0), _rec(100.0, 20.0))
    assert v["wall_over"] and v["cpu_over"] and v["regressed"]


def test_regress_single_band_noise_passes():
    # wall spiked (steal burst) but CPU held: not a regression
    v = bench.regress_evaluate(_rec(130.0, 20.5), _rec(100.0, 20.0))
    assert v["wall_over"] and not v["cpu_over"] and not v["regressed"]
    # CPU crept but wall held: not a regression either
    v = bench.regress_evaluate(_rec(105.0, 25.0), _rec(100.0, 20.0))
    assert v["cpu_over"] and not v["wall_over"] and not v["regressed"]


def test_regress_wall_only_fallback():
    # old baseline without the CPU ledger: wall alone decides
    v = bench.regress_evaluate(_rec(130.0, 23.0),
                               {"scenario": "s", "us_per_msg": 100.0})
    assert v["regressed"]
    v = bench.regress_evaluate(_rec(115.0, 23.0),
                               {"scenario": "s", "us_per_msg": 100.0})
    assert not v["regressed"]


def test_regress_boundary_is_strict():
    # exactly at the band edge is NOT over — strictly greater regresses
    v = bench.regress_evaluate(_rec(120.0, 22.0), _rec(100.0, 20.0))
    assert not v["wall_over"] and not v["cpu_over"] and not v["regressed"]


def test_trajectory_baseline_env_matching(tmp_path):
    env = bench._env_fingerprint()
    path = tmp_path / "traj.jsonl"
    other = dict(env, cores=(env["cores"] or 0) + 64)
    lines = [
        {"scenario": "s", "us_per_msg": 10.0, "env": env, "ts": 1},
        {"scenario": "s", "us_per_msg": 99.0, "env": other, "ts": 2},
        {"scenario": "t", "us_per_msg": 55.0, "env": env, "ts": 3},
        {"scenario": "s", "us_per_msg": 12.0, "env": env, "ts": 4},
    ]
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
        f.write("not json\n")  # corrupt tail lines are skipped, not fatal
    base = bench.trajectory_baseline("s", str(path))
    # latest matching-env line for the scenario wins
    assert base["ts"] == 4 and base["us_per_msg"] == 12.0
    assert bench.trajectory_baseline("missing", str(path)) is None
    assert bench.trajectory_baseline("s", str(tmp_path / "ghost")) is None
