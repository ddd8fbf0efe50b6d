"""The port's node entry point against the reference's.

- ``python -m chanamq_tpu_torch.broker.server --config ...`` boots a
  single node on the CPU (router and forecaster on ``cpu``, window 8)
  with admin, telemetry, SLO, control, tenancy (one tenant) and the
  forecaster, and chaos, tracing, OTLP, profiling, events and JSON logs
  on too; under publish load it serves a finite forecast at
  ``/admin/forecast``, the ``chanamq_forecast*`` gauges on ``/metrics``,
  answers ``/admin/health`` with 200, its control engine ticks, and
  SIGTERM exits 0;
- the reference's node (``python -m chanamq_tpu.broker.server``, JAX on
  the CPU), booted from the same config file beside it and given the same
  traffic, returns the same key sets from ``/admin/forecast``,
  ``/admin/health``, ``/admin/overview``, ``/admin/control`` and every
  other admin view a single node serves (``ADMIN_VIEWS``), the same
  metric names in the same order on ``/metrics``, and, after the same
  scripted declares, identical JSON from ``/admin/queues/<vhost>`` and
  ``/admin/exchanges/<vhost>``;
- a config that needs a layer the port lacks (cluster, federation,
  shards) and a ``cuda`` device on a host with no card fail at boot with
  ``ConfigError``, before any listener opens.
"""

import asyncio
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from chanamq_tpu_torch.broker.server import run_node
from chanamq_tpu_torch.client import AMQPClient
from chanamq_tpu_torch.config import Config, ConfigError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("chanamq_tpu_torch", "chanamq_tpu")
# every key the reference reads too; the device key (the router's and
# the forecaster's) is the port's and the reference ignores it
NODE_CONFIG = {
    "chana.mq.amqp.interface": "127.0.0.1",
    "chana.mq.router.device": "cpu",
    "chana.mq.forecast.enabled": True,
    "chana.mq.forecast.window": 8,
    "chana.mq.forecast.interval": "100ms",
    "chana.mq.forecast.train-interval": "1s",
    "chana.mq.telemetry.enabled": True,
    "chana.mq.telemetry.interval": "250ms",
    "chana.mq.slo.enabled": True,
    "chana.mq.control.enabled": True,
    "chana.mq.control.interval": "250ms",
    # every other single-node layer run_node can boot
    "chana.mq.chaos.enabled": True,
    "chana.mq.trace.enabled": True,
    "chana.mq.otel.enabled": True,
    "chana.mq.profile.enabled": True,
    "chana.mq.events.enabled": True,
    "chana.mq.log.json": True,
    "chana.mq.tenant.enabled": True,
    "chana.mq.tenant.tenants": {
        "acme": {"vhosts": ["acme"],
                 "quota": {"max-queues": 8, "publish-rate": 1 << 20}}},
}
ADMIN_VIEWS = ("/admin/forecast", "/admin/health", "/admin/overview",
               "/admin/control", "/admin/metrics", "/admin/slo",
               "/admin/alerts", "/admin/timeseries", "/admin/tenants",
               "/admin/traces", "/admin/otel/spans", "/admin/profile",
               "/admin/events", "/admin/chaos", "/admin/streams",
               "/admin/cluster", "/admin/federation", "/admin/replication",
               "/admin/drain")
ENTITY_VIEWS = ("/admin/queues/%2F", "/admin/exchanges/%2F")
BOOT_TIMEOUT_S = 60.0
FORECAST_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _get(port: int, path: str) -> "tuple[int, str]":
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _key_paths(obj, prefix: str = "") -> "set[str]":
    """Every key path through nested dicts (list contents are data)."""
    out: set = set()
    if isinstance(obj, dict):
        for key, value in obj.items():
            path = f"{prefix}/{key}"
            out.add(path)
            out |= _key_paths(value, path)
    return out


def _metric_names(text: str) -> "list[str]":
    """Sample names in exposition order, one entry per run of a name."""
    names: list = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if not names or names[-1] != name:
            names.append(name)
    return names


async def _declare(port: int):
    """The scripted declares both nodes get; returns the open client and
    its channel."""
    client = await AMQPClient.connect("127.0.0.1", port)
    ch = await client.channel()
    await ch.exchange_declare("ex.topic", "topic", durable=True)
    await ch.exchange_declare("ex.headers", "headers")
    await ch.exchange_declare("ex.fanout", "fanout", auto_delete=True)
    await ch.queue_declare("q.durable", durable=True)
    await ch.queue_declare("q.capped", arguments={"x-max-length": 10,
                                                  "x-message-ttl": 60000})
    await ch.queue_declare("q.stream", durable=True,
                           arguments={"x-queue-type": "stream"})
    await ch.queue_bind("q.durable", "ex.topic", "orders.*.eu")
    await ch.queue_bind("q.capped", "ex.topic", "orders.#")
    await ch.queue_bind("q.capped", "ex.headers", "",
                        arguments={"x-match": "any", "region": "eu"})
    await ch.queue_bind("q.durable", "ex.fanout", "")
    return client, ch


async def _drive(nodes: dict) -> dict:
    out: dict = {}
    conns = {pkg: await _declare(node["amqp"]) for pkg, node in nodes.items()}
    for pkg, node in nodes.items():
        out[pkg] = {path: (await asyncio.to_thread(_get, node["admin"],
                                                   path))[1]
                    for path in ENTITY_VIEWS}
    received: dict = {}
    for pkg, (_, ch) in conns.items():
        await ch.queue_declare("load")
        received[pkg] = []
        await ch.basic_consume("load", received[pkg].append, no_ack=True)
    # the same load on both: 40 ticks of 20 publishes
    for _ in range(40):
        for _, ch in conns.values():
            for _ in range(20):
                ch.basic_publish(b"x" * 256, routing_key="load")
        await asyncio.sleep(0.05)
    # wait until each node has a forecast that has been scored once, so
    # both expose the accuracy keys and gauges
    deadline = time.monotonic() + FORECAST_TIMEOUT_S
    for pkg, node in nodes.items():
        while True:
            _, body = await asyncio.to_thread(_get, node["admin"],
                                              "/admin/forecast")
            snap = json.loads(body)
            if (snap.get("forecast") is not None
                    and snap.get("rounds", 0) >= 2
                    and snap.get("accuracy", {}).get("scored", 0) >= 1):
                break
            assert snap.get("error") is None, (pkg, snap["error"])
            assert time.monotonic() < deadline, (pkg, snap)
            await asyncio.sleep(0.2)
    for pkg, node in nodes.items():
        for path in ADMIN_VIEWS + ("/metrics",):
            status, body = await asyncio.to_thread(_get, node["admin"], path)
            out[pkg][path] = body
            out[pkg]["status " + path] = status
        # the control engine keeps ticking
        out[pkg]["control later"] = json.loads((await asyncio.to_thread(
            _get, node["admin"], "/admin/control"))[1])
        while out[pkg]["control later"]["tick"] <= json.loads(
                out[pkg]["/admin/control"])["tick"]:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.1)
            out[pkg]["control later"] = json.loads((await asyncio.to_thread(
                _get, node["admin"], "/admin/control"))[1])
        out[pkg]["received"] = len(received[pkg])
    for client, _ in conns.values():
        await client.close()
    return out


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Both nodes booted through ``main`` from one config file, driven the
    same way, then stopped by SIGTERM; yields what each served and how
    each exited."""
    path = tmp_path_factory.mktemp("node") / "node.json"
    path.write_text(json.dumps(NODE_CONFIG))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs: dict = {}
    try:
        for pkg in PACKAGES:
            amqp, admin = _free_port(), _free_port()
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.broker.server",
                 "--config", str(path), "--port", str(amqp),
                 "--admin-port", str(admin), "--log-level", "WARNING"],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE)
            procs[pkg] = {"proc": proc, "amqp": amqp, "admin": admin}
        deadline = time.monotonic() + BOOT_TIMEOUT_S
        for pkg, node in procs.items():
            while True:
                assert node["proc"].poll() is None, (
                    pkg, node["proc"].stderr.read().decode())
                try:
                    _get(node["admin"], "/admin/overview")
                    break
                except OSError:
                    assert time.monotonic() < deadline, pkg
                    time.sleep(0.1)
        out = asyncio.run(_drive(procs))
        for pkg, node in procs.items():
            t0 = time.monotonic()
            node["proc"].send_signal(signal.SIGTERM)
            out[pkg]["exit"] = node["proc"].wait(timeout=30)
            out[pkg]["exit_s"] = time.monotonic() - t0
            out[pkg]["stderr"] = node["proc"].stderr.read().decode()
        yield out
    finally:
        for node in procs.values():
            if node["proc"].poll() is None:
                node["proc"].kill()
                node["proc"].wait()
            node["proc"].stderr.close()


def test_port_node_serves_the_forecast(nodes):
    port = nodes["chanamq_tpu_torch"]
    snap = json.loads(port["/admin/forecast"])
    assert snap["enabled"] is True and snap["error"] is None
    assert snap["rounds"] >= 2 and snap["window"] == 8
    assert math.isfinite(snap["loss"])
    assert snap["forecast"] and all(
        math.isfinite(v) for v in snap["forecast"].values())
    assert port["received"] == 800


def test_port_node_serves_forecast_gauges(nodes):
    text = nodes["chanamq_tpu_torch"]["/metrics"]
    assert 'chanamq_forecast{feature="publish_rate"}' in text
    assert "chanamq_forecast_loss" in text


def test_port_node_health_and_control(nodes):
    port = nodes["chanamq_tpu_torch"]
    assert port["status /admin/health"] == 200
    control = json.loads(port["/admin/control"])
    assert control["enabled"] is True and control["dry_run"] is True
    assert port["control later"]["tick"] > control["tick"]


def test_port_node_exits_zero_on_sigterm(nodes):
    port = nodes["chanamq_tpu_torch"]
    assert port["exit"] == 0, port["stderr"]
    assert port["exit_s"] < 30


@pytest.mark.parametrize("path", ADMIN_VIEWS)
def test_admin_key_sets_match_reference(nodes, path):
    port = json.loads(nodes["chanamq_tpu_torch"][path])
    ref = json.loads(nodes["chanamq_tpu"][path])
    assert _key_paths(port) == _key_paths(ref)
    assert (nodes["chanamq_tpu_torch"]["status " + path]
            == nodes["chanamq_tpu"]["status " + path])


def test_metric_names_match_reference(nodes):
    port = _metric_names(nodes["chanamq_tpu_torch"]["/metrics"])
    ref = _metric_names(nodes["chanamq_tpu"]["/metrics"])
    assert port == ref
    assert "chanamq_forecast_loss" in port


@pytest.mark.parametrize("path", ENTITY_VIEWS)
def test_entity_json_matches_reference(nodes, path):
    port = nodes["chanamq_tpu_torch"][path]
    assert json.loads(port)  # not an empty listing
    assert port == nodes["chanamq_tpu"][path]


def test_reference_node_exits_zero_on_sigterm(nodes):
    ref = nodes["chanamq_tpu"]
    assert ref["exit"] == 0, ref["stderr"]


# -- refused at boot ------------------------------------------------------------

REFUSED = {
    "cluster": ({"chana.mq.cluster.enabled": True}, {},
                "chana.mq.cluster.enabled"),
    "federation": ({"chana.mq.federation.enabled": True}, {},
                   "chana.mq.federation.enabled"),
    "shard-count": ({"chana.mq.shard.count": 2}, {}, "chana.mq.shard.count"),
    "shard-index": ({}, {"CHANAMQ_SHARD_INDEX": "0"}, "CHANAMQ_SHARD_INDEX"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
async def test_unported_layer_refused_at_boot(case, monkeypatch):
    overrides, environ, named = REFUSED[case]
    for key, value in environ.items():
        monkeypatch.setenv(key, value)
    amqp = _free_port()
    cfg = Config({"chana.mq.amqp.interface": "127.0.0.1",
                  "chana.mq.amqp.port": amqp,
                  "chana.mq.admin.port": _free_port(),
                  "chana.mq.router.device": "cpu", **overrides}, env={})
    with pytest.raises(ConfigError, match=named):
        await run_node(cfg)
    with pytest.raises(OSError):  # no listener was opened
        socket.create_connection(("127.0.0.1", amqp), timeout=1).close()


# the layers that run on the node's device: the router's kernels alone,
# and the forecaster alone (the router on the Python backend)
DEVICE_USERS = {
    "forecaster": {"chana.mq.forecast.enabled": True,
                   "chana.mq.router.backend": "python"},
    "router": {},
}


@pytest.mark.parametrize("user", sorted(DEVICE_USERS))
async def test_cuda_device_without_card_refused_at_boot(user):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the cuda device boots")
    amqp = _free_port()
    cfg = Config({"chana.mq.amqp.interface": "127.0.0.1",
                  "chana.mq.amqp.port": amqp,
                  "chana.mq.admin.port": _free_port(),
                  "chana.mq.router.device": "cuda", **DEVICE_USERS[user]},
                 env={})
    with pytest.raises(ConfigError, match="chana.mq.router.device"):
        await run_node(cfg)
    with pytest.raises(OSError):  # no listener was opened
        socket.create_connection(("127.0.0.1", amqp), timeout=1).close()


@pytest.mark.parametrize("user", sorted(DEVICE_USERS))
async def test_card_index_out_of_range_refused_at_boot(user, monkeypatch):
    """A host with one card (stood in for on the CPU): ``cuda:1`` is
    refused at boot, before the forecaster could fail each round."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    amqp = _free_port()
    cfg = Config({"chana.mq.amqp.interface": "127.0.0.1",
                  "chana.mq.amqp.port": amqp,
                  "chana.mq.admin.port": _free_port(),
                  "chana.mq.router.device": "cuda:1", **DEVICE_USERS[user]},
                 env={})
    with pytest.raises(ConfigError, match="sees 1 CUDA device"):
        await run_node(cfg)
    with pytest.raises(OSError):  # no listener was opened
        socket.create_connection(("127.0.0.1", amqp), timeout=1).close()


async def test_device_not_read_when_nothing_runs_on_it(monkeypatch):
    """Nothing runs on the node's device when the router is on the Python
    backend and the forecaster is off: the key is not read at boot."""
    from chanamq_tpu_torch.broker import server as srv

    cfg = Config({"chana.mq.router.backend": "python",
                  "chana.mq.router.device": "cuda:7"}, env={})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv._refuse_unported(cfg)  # raises nothing


def test_main_refuses_a_cluster_config(tmp_path):
    """What an operator sees: ``main`` exits non-zero with the
    ConfigError naming the key, and serves nothing."""
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({"chana.mq.cluster.enabled": True,
                                "chana.mq.router.device": "cpu"}))
    proc = subprocess.run(
        [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
         "--config", str(path), "--port", str(_free_port()),
         "--admin-port", str(_free_port())],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "ConfigError" in proc.stderr
    assert "chana.mq.cluster.enabled" in proc.stderr


def test_chip_smoke_node_phase_rehearsal(monkeypatch):
    """chip_smoke's [node] phase on the CPU at a small size: the node
    started through ``main`` in a child, its queues held to the oracle,
    its forecaster's rounds, gauges, health and control served, SIGTERM
    exit 0, no kernel launched, and the last forecast replayed through
    the plain path on the parameters that made it."""
    import chip_smoke

    # the child trains on the CPU: one torch thread, beside other tests
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    res = chip_smoke.phase_node(
        torch.device("cpu"), 0, n_queues=64, n_patterns=16, n_keys=200,
        n_header_sets=32, n_topic=400, n_headers=200, window=128,
        min_rounds=2)
    assert res["messages"] == 600 and res["exit"] == 0
    assert res["deliveries"] > 600
    child = res["child"]
    assert child["services"] == 1 and child["forwards"] >= 2
    assert set(child["launches"]) >= set(chip_smoke.NODE_KERNELS)
    assert not any(child["launches"].values())
    assert (child["replay_last_abs_err"] <= child["replay_max_abs_err"]
            <= chip_smoke.FORWARD_LIMIT)
    assert res["forecast"]["rounds"] >= 2
    # the first trained round's forward and backward calls, each replayed
    # against its plain version (the update's plain version ran: no
    # launch to keep on the CPU), as often as a step calls each
    steps = child["kept_steps"]
    assert steps == child["steps_per_round"] == 20
    per_step = child["step_calls"]
    assert per_step["causal_attention_bwd"] == 2  # one call a layer
    assert {k: v["calls"] for k, v in child["replay"].items()} == {
        k: v * steps for k, v in per_step.items()
        if k not in ("sum_of_squares", "momentum_sgd")}
    assert all(v["max_abs_err"] == 0.0 for v in child["replay"].values())
    assert "16x64x192" in child["replay"]["causal_attention"]["shapes"]
    assert 0 <= res["exit_s"] <= 30
