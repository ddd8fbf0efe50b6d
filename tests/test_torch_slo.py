"""SLO engine: burn-rate math vs hand-computed oracles, window pairs,
budgets, spec parsing, the SLI sampler's counter deltas, determinism, and
the /admin/slo surface (configure + status + Prometheus series).

The engine contract under test is the AlertEngine/ControlEngine one:
``evaluate(tick, samples)`` is a pure function of the per-tick (good, bad)
streams, so every assertion here is exact — no tolerances beyond float
rounding.

The port's copy of ``tests/test_slo.py``: imports point at
``chanamq_tpu_torch``, every broker's router on the CPU; the
assertions are the reference's.
"""

import asyncio
import json

import pytest

from chanamq_tpu_torch.broker.server import BrokerServer
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.rest.admin import AdminServer
from chanamq_tpu_torch.slo import (
    SLISampler, SLOEngine, SLOSpec, default_slos, specs_from_json,
)
from chanamq_tpu_torch.slo.engine import COARSE, FINE
from chanamq_tpu_torch.telemetry import TelemetryService
from chanamq_tpu_torch.utils.metrics import Metrics
from chanamq_tpu_torch.broker.broker import Broker

pytestmark = pytest.mark.asyncio


async def http_req(port: int, path: str, method: str = "GET",
                   body: dict = None) -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 20), 5)
    writer.close()
    head, _, resp = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    return status, json.loads(resp) if resp else {}


async def http_text(port: int, path: str) -> tuple[int, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 22), 5)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


# ---------------------------------------------------------------------------
# burn-rate math vs hand-computed oracle
# ---------------------------------------------------------------------------


def _spec(**kw) -> SLOSpec:
    base = dict(name="t", sli="publish-success", objective=0.99,
                fast_windows=(4, 8), slow_windows=(8, 16),
                fast_burn=10.0, slow_burn=5.0, budget_window=16)
    base.update(kw)
    return SLOSpec(**base)


def test_burn_rate_static_oracle():
    # burn = (bad/total) / (1 - objective), by hand:
    # 5 bad of 100 at objective 0.99 -> 0.05 / 0.01 = 5.0
    assert SLOEngine.burn_rate(95, 5, 0.99) == pytest.approx(5.0)
    # burning exactly at budget rate: bad fraction == error budget
    assert SLOEngine.burn_rate(999, 1, 0.999) == pytest.approx(1.0)
    # no traffic is not a burn
    assert SLOEngine.burn_rate(0, 0, 0.999) == 0.0
    # total loss at 0.999: 1.0 / 0.001 = 1000
    assert SLOEngine.burn_rate(0, 7, 0.999) == pytest.approx(1000.0)


def test_window_burns_vs_oracle_across_pairs():
    """Feed a known per-tick series and check every window's burn against
    a sum computed by hand here (oracle = trailing-window sums)."""
    spec = _spec()
    engine = SLOEngine([spec])
    series = [(10, 0), (10, 0), (8, 2), (10, 0), (5, 5),
              (10, 0), (10, 0), (9, 1), (10, 0), (10, 0)]
    for tick, (good, bad) in enumerate(series, start=1):
        engine.evaluate(tick, {"publish-success": (good, bad)})

    status = engine.slo_status(spec)

    def oracle(window: int) -> float:
        tail = series[-window:]
        good = sum(g for g, _ in tail)
        bad = sum(b for _, b in tail)
        return (bad / (good + bad)) / (1 - spec.objective)

    assert status["burn"]["fast_short"]["burn_rate"] == pytest.approx(
        oracle(4), abs=1e-4)    # last 4 ticks: 1 bad / 39 -> 2.5641
    assert status["burn"]["fast_long"]["burn_rate"] == pytest.approx(
        oracle(8), abs=1e-4)    # last 8 ticks: 6 bad / 74+6
    assert status["burn"]["slow_short"]["burn_rate"] == pytest.approx(
        oracle(8), abs=1e-4)
    assert status["burn"]["slow_long"]["burn_rate"] == pytest.approx(
        oracle(10), abs=1e-4)   # 16-tick window clipped to the 10 fed
    # and the numbers are really different across windows (the test would
    # be vacuous if every window degenerated to the same total)
    assert (status["burn"]["fast_short"]["burn_rate"]
            != status["burn"]["fast_long"]["burn_rate"])


def test_multi_window_pair_fires_and_clears():
    """A pair fires only when BOTH windows burn over threshold, and
    clears when the short window recovers (long may still be hot)."""
    spec = _spec(fast_windows=(2, 6), fast_burn=10.0,
                 slow_windows=(6, 12), slow_burn=1e9)  # slow pair inert
    engine = SLOEngine([spec])
    events = []
    # ticks 1-2 clean, 3-4 total loss, 5+ clean again
    series = [(10, 0), (10, 0), (0, 10), (0, 10),
              (10, 0), (10, 0), (10, 0), (10, 0)]
    for tick, sample in enumerate(series, start=1):
        events.extend(engine.evaluate(
            tick, {"publish-success": sample}))

    burns = [e for e in events if e["event"] == "burn"]
    clears = [e for e in events if e["event"] == "clear"]
    assert len(burns) == 1 and len(clears) == 1
    # short window (2) is pure loss at tick 4 -> burn 100; long window (6)
    # at tick 3 is 10/30 err -> 33.3 > 10, so both windows agree at tick 3
    # already: short at tick 3 = 10/20 -> 50 > 10. Fire tick 3.
    assert burns[0]["since_tick"] == 3
    assert burns[0]["pair"] == "fast"
    # clears once the short window is clean: at tick 6 the last 2 ticks
    # are (10,0),(10,0) -> burn 0 <= 10 (tick 5's short still holds tick 4
    # loss: 10/20 -> 50, stays firing)
    assert clears[0]["cleared_tick"] == 6
    assert engine.fired_total == 1 and engine.cleared_total == 1
    assert engine.violations[spec.name] == 1
    assert not engine.firing


def test_budget_remaining_oracle():
    spec = _spec(objective=0.9, budget_window=10)
    engine = SLOEngine([spec])
    # 100 events, 5 bad; allowed = (1 - 0.9) * 100 = 10 -> 50% left
    for tick in range(1, 6):
        engine.evaluate(tick, {"publish-success": (19, 1)})
    assert engine.budget_remaining(spec) == pytest.approx(0.5)
    # no traffic at all = untouched budget
    fresh = SLOEngine([_spec()])
    fresh.evaluate(1, {})
    assert fresh.budget_remaining(fresh.specs[0]) == 1.0


def test_coarse_ring_beyond_fine_horizon():
    """Windows larger than the fine ring fall back to the coarse ring,
    quantized to its stride — deterministically, not approximately."""
    spec = _spec(fast_windows=(4, 8), slow_windows=(8, 16),
                 budget_window=FINE + 4 * COARSE)
    engine = SLOEngine([spec])
    ticks = FINE + 2 * COARSE
    for tick in range(1, ticks + 1):
        engine.evaluate(tick, {"publish-success": (1.0, 1.0)})
    track = engine._tracks[spec.name]
    window = FINE + COARSE  # beyond the fine horizon
    good, bad = track.window(ticks, window)
    # quantization error is bounded by one coarse stride, and good == bad
    # throughout so the split must be exact
    assert good == bad
    assert abs(good - window) <= COARSE
    # the same call is bit-stable (pure function of pushed state)
    assert track.window(ticks, window) == (good, bad)


def test_evaluate_is_deterministic_across_runs():
    """Two engines fed the same series emit identical event lists — the
    two-same-seed-soaks bar, without the soak."""
    series = [
        {"publish-success": (10, 0), "readiness": (1, 0)},
        {"publish-success": (0, 10), "readiness": (0, 1)},
        {"publish-success": (0, 10), "readiness": (0, 1)},
        {"publish-success": (10, 0), "readiness": (1, 0)},
        {"publish-success": (10, 0), "readiness": (1, 0)},
    ] * 3

    def run() -> list:
        engine = SLOEngine([
            _spec(name="pub", fast_windows=(2, 4), fast_burn=5.0,
                  slow_windows=(4, 8), slow_burn=5.0),
            _spec(name="ready", sli="readiness", fast_windows=(2, 4),
                  fast_burn=5.0, slow_windows=(4, 8), slow_burn=5.0),
        ])
        out = []
        for tick, sample in enumerate(series, start=1):
            out.extend(engine.evaluate(tick, sample))
        return out

    first, second = run(), run()
    assert first == second
    assert any(e["event"] == "burn" for e in first)


# ---------------------------------------------------------------------------
# spec parsing + defaults
# ---------------------------------------------------------------------------


def test_default_slos_scale_with_interval():
    specs = default_slos(0.5)
    by_name = {s.name: s for s in specs}
    assert set(by_name) == {"publish-availability", "delivery-success",
                            "readiness", "delivery-latency-p99"}
    # 5 m / 1 h at 0.5 s ticks
    assert by_name["readiness"].fast_windows == (600, 7200)
    assert by_name["readiness"].slow_windows == (43200, 518400)


def test_specs_from_json_seconds_and_validation():
    specs = specs_from_json([{
        "name": "pub", "sli": "publish-success", "objective": 0.95,
        "fast_windows_s": [10, 60], "slow_windows_s": [60, 300],
        "budget_window_s": 300,
    }], interval_s=2.0)
    assert specs[0].fast_windows == (5, 30)
    assert specs[0].budget_window == 150
    with pytest.raises(ValueError):
        specs_from_json([{"name": "x", "sli": "nope"}])
    with pytest.raises(ValueError):
        specs_from_json([{"name": "x", "objective": 1.5}])
    with pytest.raises(ValueError):  # short > long
        specs_from_json([{"name": "x", "fast_windows": [10, 2]}])
    with pytest.raises(ValueError):  # nameless
        specs_from_json([{}])
    with pytest.raises(ValueError):  # duplicate names refuse at the engine
        SLOEngine([_spec(), _spec()])


# ---------------------------------------------------------------------------
# SLI sampler: counter deltas, not absolutes
# ---------------------------------------------------------------------------


class _FakeBroker:
    def __init__(self):
        self.metrics = Metrics()


def test_sli_sampler_deltas():
    broker = _FakeBroker()
    sampler = SLISampler(broker, 250.0)
    m = broker.metrics
    m.published_msgs = 100
    m.delivered_msgs = 50
    # first sample establishes the baseline: deltas are zero
    s0 = sampler.sample(ready=True)
    assert s0["publish-success"] == (0.0, 0.0)
    assert s0["readiness"] == (1.0, 0.0)
    m.published_msgs += 30
    m.flow_publishes_refused += 2
    m.delivered_msgs += 10
    m.dead_lettered_msgs += 1
    s1 = sampler.sample(ready=False)
    assert s1["publish-success"] == (30.0, 2.0)
    assert s1["delivery-success"] == (10.0, 1.0)
    assert s1["readiness"] == (0.0, 1.0)
    # no latency observations yet -> no latency sample
    assert s1["delivery-latency"] == (0.0, 0.0)


def test_sli_sampler_latency_delta_buckets():
    broker = _FakeBroker()
    sampler = SLISampler(broker, latency_threshold_ms=1.0)  # 1000 us
    hist = broker.metrics.publish_to_deliver_us
    sampler.sample(ready=True)  # baseline buckets
    for _ in range(100):
        hist.observe_us(100)  # all fast
    assert sampler.sample(True)["delivery-latency"] == (1.0, 0.0)
    for _ in range(100):
        hist.observe_us(50_000)  # this tick is slow...
    assert sampler.sample(True)["delivery-latency"] == (0.0, 1.0)
    for _ in range(100):
        hist.observe_us(100)  # ...but the next recovers: deltas, not totals
    assert sampler.sample(True)["delivery-latency"] == (1.0, 0.0)


# ---------------------------------------------------------------------------
# admin surface
# ---------------------------------------------------------------------------


async def test_admin_slo_surface_and_prometheus():
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    admin = AdminServer(server.broker, port=0)
    await admin.start()
    try:
        # SLO disabled: a stable 409, not a 500
        svc = TelemetryService(server.broker, interval_s=1.0)
        server.broker.telemetry = svc
        status, body = await http_req(admin.bound_port, "/admin/slo")
        assert status == 409 and "slo disabled" in body["error"]

        # configure with an explicit spec set
        status, body = await http_req(
            admin.bound_port, "/admin/slo/configure", "POST",
            {"specs": [{"name": "ready", "sli": "readiness",
                        "objective": 0.99, "fast_windows": [2, 4],
                        "slow_windows": [4, 8], "budget_window": 16}]})
        assert status == 200 and body["slos"] == ["ready"]

        # drive deterministic ticks: 3 not-ready in a row burns
        svc.health_state = "ready"
        for _ in range(3):
            svc.slo.evaluate(svc.slo.tick + 1,
                             {"readiness": (0.0, 1.0)})
        status, body = await http_req(
            admin.bound_port, "/admin/slo?scope=local")
        assert status == 200
        ready = body["slos"][0]
        assert ready["name"] == "ready"
        assert ready["budget_remaining"] < 0  # pure loss overspends
        assert ready["burning"] == ["fast", "slow"]
        assert body["fired_total"] == 2

        # bad spec: stable 400
        status, body = await http_req(
            admin.bound_port, "/admin/slo/configure", "POST",
            {"specs": [{"name": "x", "sli": "nope"}]})
        assert status == 400

        # empty body restores the defaults
        status, body = await http_req(
            admin.bound_port, "/admin/slo/configure", "POST", {})
        assert status == 200 and len(body["slos"]) == 4

        # Prometheus series are present per SLO
        status, text = await http_text(admin.bound_port, "/metrics")
        assert status == 200
        assert "chanamq_slo_violations_total" in text
        assert 'chanamq_slo_budget_remaining{slo="readiness"' in text
        assert 'window="fast"' in text and 'window="slow"' in text

        # the readiness payload carries the SLO stamp
        status, body = await http_req(admin.bound_port, "/admin/health")
        assert body["slo"] == {"burning": [], "budget_remaining": {
            s.name: 1.0 for s in svc.slo.specs}}
    finally:
        await admin.stop()
        await server.stop()


async def test_telemetry_tick_drives_slo_and_emits(caplog):
    """sample_tick runs the SLI sampler + engine when an SLO engine is
    installed; the burn bumps slo_violations_total."""
    server = BrokerServer(broker=Broker(router_device="cpu"), host="127.0.0.1",
                          port=0, heartbeat_s=0)
    await server.start()
    try:
        broker = server.broker
        svc = TelemetryService(broker, interval_s=1.0)
        broker.telemetry = svc
        svc.set_slo(SLOEngine([
            SLOSpec("ready", "readiness", objective=0.999,
                    fast_windows=(2, 3), slow_windows=(3, 6),
                    fast_burn=10.0, slow_burn=10.0, budget_window=8),
        ]))
        c = await AMQPClient.connect("127.0.0.1", server.bound_port)
        ch = await c.channel()
        await ch.queue_declare("slo-q")
        ch.basic_publish(b"x", routing_key="slo-q")
        await asyncio.sleep(0.05)

        # healthy ticks: no violation
        svc.sample_tick(1.0)
        assert broker.metrics.slo_violations_total == 0
        # force not-ready ticks by draining the broker
        broker.draining = True
        for _ in range(3):
            svc.sample_tick(1.0)
        assert broker.metrics.slo_violations_total >= 1
        assert svc.slo.fired_total >= 1
        broker.draining = False
        await c.close()
    finally:
        await server.stop()
