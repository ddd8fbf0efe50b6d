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
  other admin view a single node serves (``ADMIN_VIEWS``), but for the
  port's own additions (``PORT_ONLY``: the forecast service's kernel
  launch counts, backbone and routing counters, and its profile stages
  and round ring), the same
  metric names in the same order on ``/metrics`` (the forecast stages'
  series after the reference's stages), and, after the same
  scripted declares, identical JSON from ``/admin/queues/<vhost>`` and
  ``/admin/exchanges/<vhost>``;
- the cluster, federation and shard layers boot from config: a one-node
  cluster and federation with no links in this process, a shard worker
  under ``CHANAMQ_SHARD_INDEX``, and through ``main`` a two-node cluster
  and a shard supervisor with two workers, all on the CPU;
- a ``cuda`` device on a host with no card (or ``cuda:N`` past the
  count) fails at boot with ``ConfigError``, before any listener opens:
  in a shard supervisor before it spawns a worker, in a cluster node
  before its cluster port opens.
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
# the key paths the port adds to the reference's views: the forecaster
# wrappers' launches (and of those the attention forwards on the
# warpgroup kernel, and the backward calls on the long-window pair) on
# /admin/forecast, and on /admin/profile the
# forecast service's stages, their subsystem and the ring of its rounds
FORECAST_STAGES = ("forecast-round", "forecast-batch", "train-step",
                   "train-forward", "train-backward", "train-update",
                   "forecast-wait", "forecast-predict", "mla-attention",
                   "moe-route", "moe-dispatch", "moe-experts",
                   "moe-combine")
PORT_ONLY = {
    "/admin/forecast": {"/kernel_launches", "/warpgroup_launches",
                        "/bwd_warpgroup_launches", "/backbone", "/moonlight_launches",
                        "/moe_routed_rows", "/moe_max_expert_rows"},
    "/admin/profile": {
        f"/stages/{stage}{key}" for stage in FORECAST_STAGES
        for key in ("", "/subsystem", "/ns", "/calls", "/us_per_call",
                    "/top_level")}
    | {"/subsystems/forecast", "/subsystems/forecast/ns",
       "/subsystems/forecast/calls", "/forecast", "/forecast/rounds"},
}
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
    assert _key_paths(port) == _key_paths(ref) | PORT_ONLY.get(path, set())
    assert (nodes["chanamq_tpu_torch"]["status " + path]
            == nodes["chanamq_tpu"]["status " + path])


def test_metric_names_match_reference(nodes):
    """The reference's names in its order; the port's profile stage
    series carry its forecast stages after the reference's stages."""
    port = _metric_names(nodes["chanamq_tpu_torch"]["/metrics"])
    ref = _metric_names(nodes["chanamq_tpu"]["/metrics"])
    stages_end = 1 + max(i for i, name in enumerate(ref)
                         if name == "chanamq_profile_stage_calls_total")
    assert port == ref[:stages_end] + [
        "chanamq_profile_stage_ns_total",
        "chanamq_profile_stage_calls_total"] * len(FORECAST_STAGES) \
        + ref[stages_end:]
    assert "chanamq_forecast_loss" in port


@pytest.mark.parametrize("path", ENTITY_VIEWS)
def test_entity_json_matches_reference(nodes, path):
    port = nodes["chanamq_tpu_torch"][path]
    assert json.loads(port)  # not an empty listing
    assert port == nodes["chanamq_tpu"][path]


def test_reference_node_exits_zero_on_sigterm(nodes):
    ref = nodes["chanamq_tpu"]
    assert ref["exit"] == 0, ref["stderr"]


# -- the cluster, federation and shard layers boot ---------------------------


def _free_ports(n: int) -> int:
    """The first of ``n`` consecutive free ports (a shard's cluster and
    admin ports are a base + its index)."""
    for _ in range(200):
        base = _free_port()
        if base + n > 65535:
            continue
        try:
            probes = []
            for i in range(n):
                probe = socket.socket()
                probes.append(probe)
                probe.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for probe in probes:
                probe.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def _config(**overrides) -> dict:
    return {"chana.mq.amqp.interface": "127.0.0.1",
            "chana.mq.amqp.port": _free_port(),
            "chana.mq.admin.port": _free_port(),
            "chana.mq.router.device": "cpu", **overrides}


async def _until(predicate, what: str, timeout_s: float = BOOT_TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            got = await predicate()
            if got:
                return got
        except (OSError, ValueError, KeyError):
            pass
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.05)


async def _admin(port: int, path: str):
    status, body = await asyncio.to_thread(_get, port, path)
    return status, json.loads(body)


def _joined(view: dict, n: int) -> bool:
    """``/admin/cluster`` shows ``n`` members alive and active: a seed
    counts as alive before any contact, a member turns active only once
    it has exchanged a heartbeat with the cluster."""
    members = view.get("members", {}).values()
    return len(view.get("alive", [])) == n and len(members) == n and all(
        m["lifecycle"] == "active" for m in members)


async def _round_trip(port: int, queue: str, n: int = 20,
                      admins: tuple = ()) -> list:
    """Declare ``queue`` on the node at ``port``, publish ``n`` confirmed
    messages into it and consume them back; returns their bodies. With
    ``admins``, first wait until each of those nodes knows the queue (its
    owner may be another node, whose declare reaches the rest after)."""
    client = await AMQPClient.connect("127.0.0.1", port)
    ch = await client.channel()
    await ch.confirm_select()
    await ch.queue_declare(queue)

    async def known():
        for admin in admins:
            _, view = await _admin(admin, "/admin/cluster")
            if view["known_queues"] < 1:
                return False
        return True

    await _until(known, f"queue {queue} on every node")
    for i in range(n):
        ch.basic_publish(b"m%03d" % i, routing_key=queue)
    await ch.wait_unconfirmed_below(1, timeout=30)
    got: list = []
    done = asyncio.get_running_loop().create_future()

    def on_message(msg) -> None:
        got.append(bytes(msg.body))
        if len(got) == n and not done.done():
            done.set_result(None)

    await ch.basic_consume(queue, on_message, no_ack=True)
    await asyncio.wait_for(done, 30)
    await client.close()
    return got


async def _boot_in_process(cfg: dict):
    """``run_node`` on ``cfg`` in this event loop, once its admin API
    answers; cancelling the task runs its teardown."""
    task = asyncio.get_running_loop().create_task(
        run_node(Config(cfg, env={})))

    async def up():
        assert not task.done(), task.result()
        return (await _admin(cfg["chana.mq.admin.port"],
                             "/admin/overview"))[0] == 200

    await _until(up, "the node's admin API")
    return task


async def _stop_in_process(task) -> None:
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task


async def test_one_node_cluster_boots():
    """``chana.mq.cluster.enabled`` with no seeds: a cluster of one that
    owns every queue, serves ``/admin/cluster`` and routes on the CPU."""
    cluster_port = _free_port()
    cfg = _config(**{"chana.mq.cluster.enabled": True,
                     "chana.mq.cluster.port": cluster_port})
    task = await _boot_in_process(cfg)
    try:
        status, view = await _admin(cfg["chana.mq.admin.port"],
                                    "/admin/cluster")
        assert status == 200 and view["enabled"] is True
        assert view["self"] == f"127.0.0.1:{cluster_port}"
        assert view["alive"] == [view["self"]]
        got = await _round_trip(cfg["chana.mq.amqp.port"], "c1")
        assert got == [b"m%03d" % i for i in range(20)]
        _, view = await _admin(cfg["chana.mq.admin.port"], "/admin/cluster")
        assert view["owned_queues"] == view["known_queues"] == 1
    finally:
        await _stop_in_process(task)
    with pytest.raises(OSError):  # the cluster port closed with the node
        socket.create_connection(("127.0.0.1", cluster_port),
                                 timeout=1).close()


async def test_router_warmed_before_the_cluster_starts(monkeypatch):
    """``run_node`` warms the router's device (a card's context and the
    kernel library; nothing on the CPU) before the cluster layer starts,
    so a node's first kernel batch cannot stall its loop past the
    failure timeout while peers watch it."""
    from chanamq_tpu_torch.cluster import node as cluster_node
    from chanamq_tpu_torch.router.engine import TensorRouter

    order: list = []
    warm, start = TensorRouter.warm, cluster_node.ClusterNode.start

    def warming(self):
        order.append("warm")
        warm(self)

    async def starting(self):
        order.append("cluster")
        await start(self)

    monkeypatch.setattr(TensorRouter, "warm", warming)
    monkeypatch.setattr(cluster_node.ClusterNode, "start", starting)
    cfg = _config(**{"chana.mq.cluster.enabled": True,
                     "chana.mq.cluster.port": _free_port()})
    task = await _boot_in_process(cfg)
    try:
        assert order == ["warm", "cluster"]
    finally:
        await _stop_in_process(task)


async def test_federation_with_no_links_boots():
    """``chana.mq.federation.enabled`` with no links: the listener runs,
    ``/admin/federation`` answers with no link, and the node serves."""
    cfg = _config(**{"chana.mq.federation.enabled": True})
    task = await _boot_in_process(cfg)
    try:
        status, view = await _admin(cfg["chana.mq.admin.port"],
                                    "/admin/federation")
        assert status == 200 and view["links"] == []
        assert await _round_trip(cfg["chana.mq.amqp.port"], "f1", 5) == [
            b"m%03d" % i for i in range(5)]
    finally:
        await _stop_in_process(task)


async def test_shard_worker_boots_under_shard_index(tmp_path, monkeypatch):
    """A worker as the supervisor starts it (``CHANAMQ_SHARD_INDEX`` and
    its siblings' layout): shard wiring on a cluster node with its Unix
    socket, the shard label on ``/metrics``, its sibling not up yet."""
    base = _free_ports(2)
    for key, value in {"CHANAMQ_SHARD_INDEX": "1", "CHANAMQ_SHARD_COUNT": "2",
                       "CHANAMQ_SHARD_DIR": str(tmp_path),
                       "CHANAMQ_SHARD_RESTARTS": "0"}.items():
        monkeypatch.setenv(key, value)
    cfg = _config(**{"chana.mq.cluster.enabled": True,
                     "chana.mq.cluster.port": base + 1,
                     "chana.mq.cluster.seeds": [f"127.0.0.1:{base}"]})
    task = await _boot_in_process(cfg)
    try:
        _, view = await _admin(cfg["chana.mq.admin.port"], "/admin/cluster")
        assert view["shard"] == {"index": 1, "count": 2,
                                 "name": f"127.0.0.1:{base + 1}"}
        assert view["shard_siblings"] == {
            f"127.0.0.1:{base}": str(tmp_path / "shard-0.sock")}
        assert (tmp_path / "shard-1.sock").exists()
        _, text = await asyncio.to_thread(_get, cfg["chana.mq.admin.port"],
                                          "/metrics")
        assert 'shard="1"' in text
    finally:
        await _stop_in_process(task)


def _spawn_main(cfg: dict, path) -> subprocess.Popen:
    """``main`` on ``cfg`` in a child, in a session of its own so that
    ``_reap`` also ends the workers a shard supervisor spawned."""
    path.write_text(json.dumps(cfg))
    return subprocess.Popen(
        [sys.executable, "-m", "chanamq_tpu_torch.broker.server",
         "--config", str(path), "--log-level", "WARNING"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        start_new_session=True)


def _reap(proc: subprocess.Popen) -> None:
    """Kill whatever of ``proc``'s session is left (a failed test's
    supervisor and its workers) and close its pipe."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()
    proc.stderr.close()


def _sigterm(proc: subprocess.Popen) -> int:
    proc.send_signal(signal.SIGTERM)
    return proc.wait(timeout=30)


async def test_main_boots_a_two_node_cluster(tmp_path):
    """Two nodes through ``main``, the second seeded with the first: both
    see two members alive, a queue declared on one is served through the
    other, and SIGTERM exits both 0."""
    cluster = [_free_port(), _free_port()]
    cfgs = [_config(**{"chana.mq.admin.enabled": True,
                       "chana.mq.cluster.enabled": True,
                       "chana.mq.cluster.port": cluster[i],
                       "chana.mq.cluster.heartbeat-interval": "200ms",
                       "chana.mq.cluster.seeds": (
                           [f"127.0.0.1:{cluster[0]}"] if i else [])})
            for i in range(2)]
    procs = [_spawn_main(cfg, tmp_path / f"node{i}.json")
             for i, cfg in enumerate(cfgs)]
    try:
        async def converged():
            for proc, cfg in zip(procs, cfgs):
                assert proc.poll() is None, proc.stderr.read().decode()
                _, view = await _admin(cfg["chana.mq.admin.port"],
                                       "/admin/cluster")
                if not _joined(view, 2):
                    return False
            return True

        await _until(converged, "two members alive on both nodes")
        client = await AMQPClient.connect("127.0.0.1",
                                          cfgs[0]["chana.mq.amqp.port"])
        ch = await client.channel()
        await ch.queue_declare("two")
        await client.close()

        async def known():
            _, view = await _admin(cfgs[1]["chana.mq.admin.port"],
                                   "/admin/cluster")
            return view["known_queues"] == 1

        await _until(known, "the queue's metadata on the second node")
        got = await _round_trip(cfgs[1]["chana.mq.amqp.port"], "two", 10)
        assert got == [b"m%03d" % i for i in range(10)]
        assert [await asyncio.to_thread(_sigterm, p) for p in procs] == [0, 0]
    finally:
        for proc in procs:
            _reap(proc)


async def test_main_boots_a_shard_supervisor_and_two_workers(tmp_path):
    """``chana.mq.shard.count`` 2 through ``main``: the supervisor spawns
    two workers of the port (``chanamq_tpu_torch.broker.server``) on
    the CPU, each with its admin port at the base + its index, sharing
    the AMQP port; they form a cluster of two, a client is served, and
    SIGTERM to the supervisor exits 0 with both workers gone."""
    cluster, admin = _free_ports(2), _free_ports(2)
    # the shards' failure timeout (1.5 s by default) raised for a host
    # that runs other test files beside this one
    cfg = _config(**{"chana.mq.admin.enabled": True,
                     "chana.mq.admin.port": admin,
                     "chana.mq.cluster.port": cluster,
                     "chana.mq.shard.count": 2,
                     "chana.mq.shard.failure-timeout": "10s",
                     "chana.mq.shard.dir": str(tmp_path / "shards")})
    proc = _spawn_main(cfg, tmp_path / "node.json")
    try:
        async def workers_up():
            assert proc.poll() is None, proc.stderr.read().decode()
            views = [(await _admin(admin + i, "/admin/cluster"))[1]
                     for i in range(2)]
            if all(_joined(v, 2) for v in views):
                return views
            return None

        views = await _until(workers_up, "both workers clustered")
        assert [v["shard"]["index"] for v in views] == [0, 1]
        assert [v["shard"]["count"] for v in views] == [2, 2]
        got = await _round_trip(cfg["chana.mq.amqp.port"], "s1", 10,
                                admins=(admin, admin + 1))
        assert got == [b"m%03d" % i for i in range(10)]
        assert await asyncio.to_thread(_sigterm, proc) == 0
        for i in range(2):  # the workers went with the supervisor
            with pytest.raises(OSError):
                _get(admin + i, "/admin/overview")
    finally:
        _reap(proc)


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


async def test_shard_supervisor_on_cuda_without_card_refused(monkeypatch):
    """``chana.mq.shard.count`` 2 on ``cuda`` with no card: the
    supervisor refuses once, before it spawns any worker."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the cuda device boots")
    from chanamq_tpu_torch.shard import supervisor

    spawned: list = []

    async def spawn(self, index):
        spawned.append(index)
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(supervisor.ShardSupervisor, "_spawn", spawn)
    monkeypatch.delenv("CHANAMQ_SHARD_INDEX", raising=False)
    cfg = _config(**{"chana.mq.router.device": "cuda",
                     "chana.mq.shard.count": 2})
    with pytest.raises(ConfigError, match="chana.mq.router.device"):
        await run_node(Config(cfg, env={}))
    assert spawned == []


async def test_cluster_node_on_cuda_without_card_refused(monkeypatch):
    """A cluster node on ``cuda`` with no card is refused before its
    cluster port opens (no ``ClusterNode`` is started)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the cuda device boots")
    from chanamq_tpu_torch.cluster import node as cluster_node

    started: list = []

    async def start(self):
        started.append(self)

    monkeypatch.setattr(cluster_node.ClusterNode, "start", start)
    cluster_port = _free_port()
    cfg = _config(**{"chana.mq.router.device": "cuda",
                     "chana.mq.cluster.enabled": True,
                     "chana.mq.cluster.port": cluster_port})
    with pytest.raises(ConfigError, match="chana.mq.router.device"):
        await run_node(Config(cfg, env={}))
    assert started == []
    for port in (cluster_port, cfg["chana.mq.amqp.port"]):
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=1).close()


async def test_device_not_read_when_nothing_runs_on_it(monkeypatch):
    """Nothing runs on the node's device when the router is on the Python
    backend and the forecaster is off: the key is not read at boot."""
    from chanamq_tpu_torch.broker import server as srv

    cfg = Config({"chana.mq.router.backend": "python",
                  "chana.mq.router.device": "cuda:7"}, env={})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv._check_device(cfg)  # raises nothing


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


# the main path's workload cut to a CPU rehearsal
REHEARSAL_SIZES = dict(n_queues=64, n_patterns=16, n_keys=200,
                       n_header_sets=32, n_topic=400, n_headers=200,
                       window=128)


def test_chip_smoke_cluster_phase_rehearsal(monkeypatch):
    """chip_smoke's [cluster] phase on the CPU at a small size: three port
    nodes through ``main`` in children, replicated with sync and a private
    store each; the owner of the most queues SIGKILLed after the last
    confirm, every queue it held promoted on the survivors and every
    queue drained against the oracle, no kernel launched (the plain
    versions run on the CPU) and every kept router call replayed, SIGTERM
    exit 0."""
    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = chip_smoke.phase_cluster(torch.device("cpu"), 0,
                                   **REHEARSAL_SIZES)
    assert res["messages"] == 600 and res["exit"] == [0, 0]
    assert res["deliveries"] == res["expected_deliveries"] > 600
    assert (res["lost"], res["duplicated"], res["reordered_streams"],
            res["altered"]) == (0, 0, 0, 0)
    assert sum(res["promotions"]) == res["promoted_queues"] \
        == res["owned"][res["victim"]] > 0
    assert res["served_from_promoted"] > 0
    assert sorted(res["alive"] + [res["victim"]]) == [0, 1, 2]
    for child in res["children"]:
        assert child["launches"] == {"topic_match": 0, "headers_match": 0}
        assert "replay_error" not in child
        assert sum(r["calls"] for r in child["replay"].values()) > 0
    # each survivor routed its publishers' batches through its router
    assert all(after["router_batches"] > 0 for after in res["after"])
    assert all(0 <= s <= 30 for s in res["exit_s"])


def test_chip_smoke_shard_phase_rehearsal(monkeypatch):
    """chip_smoke's [shard] phase on the CPU at a small size: the
    supervisor through ``main`` in a child spawns four workers of the
    port, one publisher on each; every queue's count at its owner against
    the oracle, every queue drained against it, router batches on every
    worker and cross-shard pushes, SIGTERM exit 0 with every worker
    gone."""
    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = chip_smoke.phase_shard(torch.device("cpu"), 0, **REHEARSAL_SIZES)
    assert res["messages"] == 600 and res["exit"] == 0
    assert res["deliveries"] == res["expected_deliveries"] > 600
    assert (res["lost"], res["duplicated"], res["reordered_streams"],
            res["altered"]) == (0, 0, 0, 0)
    assert len(res["workers"]) == chip_smoke.SHARDS
    assert res["workers_left"] == []
    assert all(b > 0 for b in res["router_batches"])
    assert sum(res["cross_pushes"]) > 0
    assert len(res["children"]) == chip_smoke.SHARDS
    for child in res["children"]:
        assert child["launches"] == {"topic_match": 0, "headers_match": 0}
        assert "replay_error" not in child
    assert 0 <= res["exit_s"] <= 30
