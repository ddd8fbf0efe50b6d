"""The ops surface's pure parts against the reference's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages'
copies and must give equal outputs, exactly (every one of these is host
code with no device and no float reordering):

- ``control.ControlEngine``: the decision log and suppressed counts over
  a scripted ``ControlInputs`` series, and the engine's final state;
- ``slo.SLOEngine``: burn/clear events and every window's burn rate each
  tick;
- ``telemetry.AlertEngine``: fired/resolved events and the firing state
  over queue matrices and node probes;
- ``tenancy.TenantRegistry``: quota refusals, token-bucket and
  memory-share gate decisions and snapshots over a scripted load;
- ``otel.export.resource_spans``: the OTLP JSON document for the same
  traces;
- ``utils.logjson.JsonLogFormatter``: the JSON log line for the same
  records, timestamps masked.
"""

import json
import logging
import sys
import types

import numpy as np
import pytest

from chanamq_tpu import control as ref_control
from chanamq_tpu import tenancy as ref_tenancy
from chanamq_tpu import trace as ref_trace
from chanamq_tpu.otel import context as ref_context
from chanamq_tpu.otel import export as ref_export
from chanamq_tpu.slo import engine as ref_slo
from chanamq_tpu.telemetry import alerts as ref_alerts
from chanamq_tpu.telemetry import store as ref_store
from chanamq_tpu.utils import logjson as ref_logjson
from chanamq_tpu_torch import control as port_control
from chanamq_tpu_torch import tenancy as port_tenancy
from chanamq_tpu_torch import trace as port_trace
from chanamq_tpu_torch.otel import context as port_context
from chanamq_tpu_torch.otel import export as port_export
from chanamq_tpu_torch.slo import engine as port_slo
from chanamq_tpu_torch.telemetry import alerts as port_alerts
from chanamq_tpu_torch.telemetry import store as port_store
from chanamq_tpu_torch.utils import logjson as port_logjson

SEEDS = (0, 1, 2)
TICKS = 300


# -- control ----------------------------------------------------------------


def _control_script(seed: int) -> "list[dict]":
    """A control tick series: a gate that ramps past the throttle band and
    drains, forecasts that come and go, peers that diverge, consumers
    that lag and keep up."""
    rng = np.random.default_rng(seed)
    enter, exit_ = 1_000_000, 600_000
    gate = 0.0
    ticks = []
    for tick in range(TICKS):
        phase = (tick // 40) % 3
        net = float(rng.normal((200_000, -250_000, 5_000)[phase], 40_000))
        gate = max(0.0, gate + net * 0.25)
        queues = []
        for i in range(int(rng.integers(0, 5))):
            deliver = float(rng.choice([0.0, rng.uniform(10, 500)]))
            queues.append(dict(
                vhost="/" if i % 2 else "t1", name=f"q{i}",
                depth=float(rng.integers(0, 200)),
                publish_rate=float(rng.uniform(0, 5000)),
                deliver_rate=deliver,
                ack_rate=float(deliver * rng.uniform(0.2, 1.0)),
                ready_bytes=float(rng.integers(0, 1 << 20)),
                consumers=float(rng.integers(0, 3)),
                movable=bool(rng.random() < 0.5),
                forecast_depth=(None if rng.random() < 0.5
                                else float(rng.uniform(0, 100)))))
        peers = ({} if rng.random() < 0.3 else
                 {f"n{j}": float(rng.uniform(0, 4000)) for j in range(2)})
        ticks.append(dict(
            tick=tick, interval_s=0.25,
            stage=int(rng.choice([0, 1, 2], p=[0.6, 0.3, 0.1])),
            floor=int(rng.choice([0, 2], p=[0.95, 0.05])),
            gate_total=int(gate),
            enter_throttle=enter, exit_throttle=exit_, net_rate=net,
            publish_credit=int(rng.choice([0, 65536, 262144])),
            forecast_net_rate=(None if rng.random() < 0.6
                               else float(rng.normal(40_000, 50_000))),
            queues=queues, node="local",
            self_load=float(rng.uniform(0, 12000)), peer_loads=peers,
            consume_credit=(None if rng.random() < 0.2
                            else int(rng.choice([8, 32, 128, 256]))),
            join_target=("n0" if peers and rng.random() < 0.05 else None)))
    return ticks


def _run_control(mod, script):
    engine = mod.ControlEngine(mod.ControlConfig(
        horizon_ticks=5, arm_ticks=2, cooldown_ticks=6,
        rebalance_cooldown_ticks=12, prefetch_cooldown_ticks=4))
    log = []
    for raw in script:
        queues = tuple(mod.QueueInput(**q) for q in raw["queues"])
        inp = mod.ControlInputs(**{**raw, "queues": queues})
        log.append(engine.evaluate(inp))
    return log, engine.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_control_engine_decisions_match_reference(seed):
    script = _control_script(seed)
    port_log, port_state = _run_control(port_control, script)
    ref_log, ref_state = _run_control(ref_control, script)
    assert port_log == ref_log
    assert port_state == ref_state
    kinds = {d["kind"] for decisions, _ in port_log for d in decisions}
    # the script exercises every decision kind
    assert {"admission.prearm", "admission.relax", "rebalance.move",
            "prefetch.tune"} <= kinds, kinds


# -- SLOs --------------------------------------------------------------------


def _slo_specs(mod):
    return [
        mod.SLOSpec("publish", "publish-success", objective=0.99,
                    fast_windows=(5, 30), slow_windows=(20, 120),
                    fast_burn=8.0, slow_burn=3.0, budget_window=200),
        mod.SLOSpec("latency", "delivery-latency", objective=0.95,
                    fast_windows=(4, 16), slow_windows=(16, 64),
                    budget_window=100, severity="warning"),
        mod.SLOSpec("tenant-publish", "publish-success", objective=0.999,
                    fast_windows=(3, 12), slow_windows=(12, 48),
                    budget_window=150, tenant="acme"),
    ]


def _slo_samples(seed: int) -> "list[dict]":
    rng = np.random.default_rng(seed)
    out = []
    for tick in range(TICKS):
        burst = (tick // 25) % 4 == 1  # a bad stretch every 100 ticks
        bad_p = 0.3 if burst else 0.002
        samples = {}
        for key in ("publish-success", "delivery-latency",
                    "publish-success@acme"):
            total = int(rng.integers(0, 400))
            bad = int(rng.binomial(total, bad_p))
            samples[key] = (float(total - bad), float(bad))
        out.append(samples)
    return out


def _run_slo(mod, samples):
    engine = mod.SLOEngine(_slo_specs(mod))
    trail = []
    for tick, sample in enumerate(samples, start=1):
        events = engine.evaluate(tick, sample)
        burns = {s.name: {k: v["burn_rate"]
                          for k, v in engine.slo_status(s)["burn"].items()}
                 for s in engine.specs}
        trail.append((events, burns, engine.readiness_stamp()))
    return trail, engine.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_burn_rates_match_reference(seed):
    samples = _slo_samples(seed)
    port_trail, port_snap = _run_slo(port_slo, samples)
    ref_trail, ref_snap = _run_slo(ref_slo, samples)
    assert port_trail == ref_trail
    assert port_snap == ref_snap
    assert port_snap["fired_total"] > 0 and port_snap["cleared_total"] > 0


# -- alerts ------------------------------------------------------------------


def _alert_script(seed: int, fields: tuple):
    rng = np.random.default_rng(seed)
    keys = [("/", f"q{i}") for i in range(6)]
    depth = np.zeros(len(keys))
    history = []
    script = []
    for tick in range(TICKS):
        grow = rng.random(len(keys)) < ((tick // 30) % 2) * 0.8
        depth = np.maximum(0, depth + np.where(
            grow, rng.integers(50, 300, len(keys)),
            -rng.integers(0, 200, len(keys))))
        latest = rng.uniform(0, 50, (len(keys), len(fields))).astype(
            np.float32)
        latest[:, fields.index("depth")] = depth
        stalled = rng.random(len(keys)) < 0.3
        latest[stalled, fields.index("deliver_rate")] = 0.0
        history.append(latest.copy())
        probes = {
            "loop_lag_ms": float(rng.choice([5.0, 400.0], p=[0.8, 0.2])),
            "repl_lag_events": float(rng.uniform(0, 1500)),
            "memory_stage": float(rng.choice([0, 2, 4], p=[0.7, 0.2, 0.1])),
            "control_floor": float(rng.random() < 0.5),
            "drain_overdue": 0.0,
            "store_errors": 0.0,
        }
        # the queue set changes: one queue comes and goes
        n = len(keys) - (1 if (tick // 50) % 2 else 0)
        script.append((tick, keys[:n], [h[:n] for h in history[-8:]],
                       probes))
    return script


def _run_alerts(mod, store_mod, script):
    engine = mod.AlertEngine(mod.default_rules(
        backlog_growth=150.0, backlog_window=3, stall_ticks=2,
        repl_lag=1000.0, loop_lag_ms=250.0, memory_stage=3.5,
        control_floor_ticks=4, drain_stuck_ticks=2))
    trail = []
    for tick, keys, recent, probes in script:
        latest = recent[-1]

        def deltas_for(window, recent=recent):
            back = recent[max(0, len(recent) - 1 - window)]
            return recent[-1] - back

        events = engine.evaluate(tick, list(keys), latest, deltas_for,
                                 "local", probes)
        engine.record(events)
        trail.append(events)
    return trail, engine.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_alert_engine_firing_state_matches_reference(seed):
    assert port_store.QUEUE_FIELDS == ref_store.QUEUE_FIELDS
    script = _alert_script(seed, port_store.QUEUE_FIELDS)
    port_trail, port_snap = _run_alerts(port_alerts, port_store, script)
    ref_trail, ref_snap = _run_alerts(ref_alerts, ref_store, script)
    assert port_trail == ref_trail
    assert port_snap == ref_snap
    assert port_snap["fired_total"] > 0 and port_snap["resolved_total"] > 0
    assert {"backlog-growth", "consumer-stall", "loop-lag"} <= set(
        port_snap["fired_rules"])


# -- tenancy -----------------------------------------------------------------


def _fake_broker(vhosts):
    metrics = types.SimpleNamespace(tenancy_quota_refusals_total=0,
                                    tenancy_throttles_total=0,
                                    tenancy_resumes_total=0)
    return types.SimpleNamespace(
        vhosts={name: types.SimpleNamespace(queues={}, exchanges={})
                for name in vhosts},
        metrics=metrics, memory_high_watermark=1 << 20)


TENANTS = {
    "acme": {"vhosts": ["acme"], "users": {"ann": "pw"},
             "quota": {"max-queues": 5, "publish-rate": 4096,
                       "publish-burst": 8192, "memory-share": 0.25}},
    "beta": {"vhosts": ["beta", "beta2"], "users": {"bob": "pw"},
             "acls": {"bob": {"beta": ["read", "write"]}},
             "quota": {"max-queues": 3, "max-connections": 2,
                       "memory-share": 0.5}},
    "free": {"vhosts": ["free"], "quota": {"publish-rate": 1000}},
}


def _run_tenancy(mod, seed):
    rng = np.random.default_rng(seed)
    broker = _fake_broker(["acme", "beta", "beta2", "free", "/"])
    registry = mod.TenantRegistry(broker)
    for name in sorted(TENANTS):
        registry.define(name, json.loads(json.dumps(TENANTS[name])))
    trail = []
    for step in range(TICKS):
        vhost = str(rng.choice(["acme", "beta", "beta2", "free", "/"]))
        decision = {"vhost": vhost}
        decision["queue"] = registry.queue_refusal(vhost)
        if decision["queue"] is None and rng.random() < 0.3:
            qn = f"q{step}"
            broker.vhosts[vhost].queues[qn] = types.SimpleNamespace(
                ready_bytes=0)
        if rng.random() < 0.1 and broker.vhosts[vhost].queues:
            victim = sorted(broker.vhosts[vhost].queues)[0]
            del broker.vhosts[vhost].queues[victim]
        for queue in broker.vhosts[vhost].queues.values():
            queue.ready_bytes = max(0, queue.ready_bytes + int(
                rng.integers(-90_000, 90_000)))
        decision["connection"] = registry.connection_refusal(vhost)
        decision["binding"] = registry.binding_refusal(vhost)
        tenant = registry.by_vhost.get(vhost)
        if tenant is not None and tenant.rated:
            for _ in range(int(rng.integers(0, 4))):
                tenant.spend(int(rng.integers(50, 1500)))
            decision["credit"] = tenant.take_credit(
                int(rng.choice([0, 512, 4096])))
        if tenant is not None:
            decision["acl"] = tenant.acl_for(
                str(rng.choice(["ann", "bob", "eve"])), vhost)
        registry.tick(float(rng.choice([0.05, 0.1, 0.25])))
        trail.append(decision)
    return trail, registry.decision_log, registry.snapshot(), vars(
        broker.metrics)


@pytest.mark.parametrize("seed", SEEDS)
def test_tenant_registry_quota_decisions_match_reference(seed):
    port = _run_tenancy(port_tenancy, seed)
    ref = _run_tenancy(ref_tenancy, seed)
    assert port == ref
    trail, log, _, metrics = port
    assert any(d["queue"] for d in trail)
    assert {e["reason"] for e in log} >= {"publish-rate", "memory-share"}
    assert metrics["tenancy_resumes_total"] > 0


@pytest.mark.parametrize("bad", [
    {"vhosts": []},
    {"vhosts": ["x"], "quota": {"publish-burst": 10}},
    {"vhosts": ["x"], "quota": {"memory-share": 1.5}},
    {"vhosts": ["x"], "quota": {"max-queues": -1}},
    {"vhosts": ["x"], "colour": "red"},
])
def test_tenant_spec_refusals_match_reference(bad):
    errors = []
    for mod in (port_tenancy, ref_tenancy):
        registry = mod.TenantRegistry(_fake_broker(["x"]))
        with pytest.raises(mod.TenancyError) as exc:
            registry.define("t", json.loads(json.dumps(bad)))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


# -- otel --------------------------------------------------------------------


def _traces(trace_mod, context_mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    base = 1_000_000_000
    for i in range(8):
        tr = trace_mod.Trace(f"local#{i}", "local" if i % 3 else "n1:5672")
        t = base + int(rng.integers(0, 10_000))
        for stage in range(len(trace_mod.STAGES)):
            if rng.random() < 0.6:
                dur = int(rng.integers(0, 50_000))
                tr.span(stage, t, t + dur, str(rng.choice(["local", "n2"])))
                t += dur
        if rng.random() < 0.5:
            tr.attr("exchange", "amq.topic")
            tr.attr("queue", f"q{i}")
            tr.attr("size", int(rng.integers(0, 4096)))
            tr.attr("persistent", bool(rng.random() < 0.5))
        if rng.random() < 0.3:
            tr.tag_chaos("latency-1")
        if i % 2:
            tid = "".join(rng.choice(list("0123456789abcdef"), 32))
            parent = "".join(rng.choice(list("0123456789abcdef"), 16))
            tr.w3c = context_mod.W3CContext(
                tid, parent, context_mod.derive_span_id(tid, "root", str(i)))
        out.append(tr)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_otel_resource_spans_match_reference(seed):
    assert port_trace.STAGES == ref_trace.STAGES
    broker = types.SimpleNamespace(trace_node="n1:5672",
                                   shard_info={"index": 0})
    docs = []
    for trace_mod, context_mod, export in (
            (port_trace, port_context, port_export),
            (ref_trace, ref_context, ref_export)):
        traces = _traces(trace_mod, context_mod, seed)
        docs.append(export.resource_spans(
            traces, export.default_resource(broker), offset_ns=12345))
    assert docs[0] == docs[1]
    assert port_export.span_count(docs[0]) > 8


# -- logjson -----------------------------------------------------------------


def _records(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(20):
        level = int(rng.choice([logging.DEBUG, logging.INFO,
                                logging.WARNING, logging.ERROR]))
        record = logging.LogRecord(
            f"chanamq.test{i % 3}", level, __file__, i,
            "msg %d: %s", (i, "ünïcode" if i % 4 == 0 else "x"), None)
        if rng.random() < 0.3:
            record.data = {"duration_ms": float(rng.uniform(0, 100)),
                           "stack": "a;b;c"}
        if i % 7 == 0:
            try:
                raise ValueError(f"boom {i}")
            except ValueError:
                record.exc_info = sys.exc_info()
        out.append((record, bool(rng.random() < 0.5)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_logjson_lines_match_reference(seed, monkeypatch):
    lines = []
    for logjson, trace_mod, context_mod in (
            (port_logjson, port_trace, port_context),
            (ref_logjson, ref_trace, ref_context)):
        broker = types.SimpleNamespace(
            trace_node="n1:5672",
            telemetry=types.SimpleNamespace(health_state="degraded"))
        fmt = logjson.JsonLogFormatter(broker)
        tr = trace_mod.Trace("n1:5672#7", "n1:5672")
        tr.w3c = context_mod.W3CContext("ab" * 16, "cd" * 8, "ef" * 8)
        out = []
        for record, traced in _records(seed):
            monkeypatch.setattr(
                trace_mod, "ACTIVE",
                types.SimpleNamespace(current=tr) if traced else None)
            doc = json.loads(fmt.format(record))
            assert isinstance(doc.pop("ts"), float)
            if "exc" in doc:  # the traceback names this file's lines
                doc["exc"] = doc["exc"].splitlines()[-1]
            out.append(doc)
        lines.append(out)
    assert lines[0] == lines[1]
    assert any("trace_id" in d for d in lines[0])
