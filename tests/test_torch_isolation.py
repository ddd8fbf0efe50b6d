"""The port stands alone: ``chanamq_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package, name no module of the
JAX package in a string (a process the port spawns runs the port), and
the default router device is the card, never a silent CPU."""

import ast
import asyncio
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "chanamq_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "chanamq_tpu")


def test_no_jax_or_reference_imports_in_sources():
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 60
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module and _forbidden(node.module):
                    bad.append((path, node.module))
    assert bad == []


# a dotted module name of the JAX package (``chanamq_tpu.broker.server``,
# as ``-m`` or ``import_module`` would take it) or the package itself;
# file paths (``chanamq_tpu/router/compile.py:289``, what a kernel
# replaces) are not module names
REFERENCE_MODULE = re.compile(
    r"(?<![\w/.])chanamq_tpu(?:\.\w+)+|^chanamq_tpu$")


def test_no_string_names_a_reference_module():
    assert REFERENCE_MODULE.search("-m chanamq_tpu.broker.server")
    assert REFERENCE_MODULE.search("chanamq_tpu")
    assert not REFERENCE_MODULE.search("chanamq_tpu_torch.broker.server")
    assert not REFERENCE_MODULE.search("chanamq_tpu/router/compile.py:289")
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                bad += [(path, node.lineno, m.group(0))
                        for m in REFERENCE_MODULE.finditer(node.value)]
    assert bad == []


def test_shard_supervisor_spawns_the_port(tmp_path, monkeypatch):
    """A shard worker is the port's server module, run by this Python."""
    from chanamq_tpu_torch.config import Config
    from chanamq_tpu_torch.shard import supervisor

    argv: list = []

    async def exec_(*args, **kwargs):
        argv.append(args)
        raise OSError("not spawned in this test")

    monkeypatch.setattr(supervisor.asyncio, "create_subprocess_exec", exec_)
    sup = supervisor.ShardSupervisor(Config(
        {"chana.mq.shard.count": 2, "chana.mq.shard.dir": str(tmp_path)},
        env={}))
    loop = asyncio.new_event_loop()
    try:
        with pytest.raises(OSError):
            loop.run_until_complete(sup._spawn(1))
    finally:
        loop.close()
    assert argv[0][:3] == (sys.executable, "-m",
                           "chanamq_tpu_torch.broker.server")


def test_bench_spawns_the_port(monkeypatch):
    """The bench's broker is the port's server module and its producer
    and consumer roles are the port's bench module, run by this Python."""
    from chanamq_tpu_torch import bench

    argv: list = []

    def popen(args, *a, **k):
        argv.append(list(args))
        raise OSError("not spawned in this test")

    monkeypatch.setattr(bench.subprocess, "Popen", popen)
    with pytest.raises(OSError):
        bench.run_spec("transient_autoack_3p3c")
    with pytest.raises(OSError):
        bench._spawn_store_broker(1, "x.db", {}, None)
    assert argv[0][:3] == [sys.executable, "-m",
                           "chanamq_tpu_torch.broker.server"]
    assert argv[1][:3] == [sys.executable, "-m",
                           "chanamq_tpu_torch.broker.server"]
    with open(bench.__file__) as f:
        tree = ast.parse(f.read())
    roles = [node for node in ast.walk(tree) if isinstance(node, ast.List)
             and any(isinstance(e, ast.Constant) and e.value == "--role"
                     for e in node.elts)]
    assert len(roles) >= 6
    for node in roles:
        head = [e.value if isinstance(e, ast.Constant) else None
                for e in node.elts[1:4]]
        assert head == ["-m", "chanamq_tpu_torch.bench", "--role"], head
    assert os.path.dirname(bench.TRAJECTORY_PATH) == REPO
    assert os.path.basename(bench.TRAJECTORY_PATH) \
        != "BENCH_trajectory.jsonl"


def test_every_soak_broker_takes_the_runners_device():
    """Every ``Broker`` the soak builds is given the runner's device, and
    every ``BrokerServer`` a broker so built."""
    from chanamq_tpu_torch.chaos import soak

    with open(soak.__file__) as f:
        tree = ast.parse(f.read())
    brokers = servers = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Name):
            continue
        kwargs = {k.arg: k.value for k in node.keywords}
        if node.func.id == "Broker":
            brokers += 1
            assert isinstance(kwargs.get("router_device"), ast.Name) \
                and kwargs["router_device"].id == "device", node.lineno
        elif node.func.id == "BrokerServer":
            servers += 1
            assert "broker" in kwargs and "store" not in kwargs, node.lineno
    assert brokers >= 12 and servers >= 12


def test_soak_runner_on_the_cpu_builds_no_cuda_broker(monkeypatch):
    """A soak runner given ``device="cpu"`` builds every broker on the CPU
    and creates no CUDA context."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.chaos import soak

    devices: list = []
    real_init = Broker.__init__

    def init(self, *args, **kwargs):
        devices.append(kwargs.get("router_device", "cuda"))
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(Broker, "__init__", init)
    report = asyncio.run(soak.run_connection_churn(4, device="cpu"))
    assert report["violations"] == []
    assert devices == ["cpu"]
    assert not torch.cuda.is_initialized()


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import sys\n"
        "import chanamq_tpu_torch.broker.server\n"
        "import chanamq_tpu_torch.broker.broker\n"
        "import chanamq_tpu_torch.client\n"
        "import chanamq_tpu_torch.router.engine\n"
        "import chanamq_tpu_torch.config\n"
        "import chanamq_tpu_torch.models.service\n"
        "import chanamq_tpu_torch.models.forecaster\n"
        "import chanamq_tpu_torch.kernels.forecaster\n"
        "import chanamq_tpu_torch.kernels.update\n"
        "import chanamq_tpu_torch.parallel.mesh\n"
        "import chanamq_tpu_torch.wal.engine\n"
        "import chanamq_tpu_torch.wal.tier\n"
        "import chanamq_tpu_torch.rest.admin\n"
        "import chanamq_tpu_torch.tenancy\n"
        "import chanamq_tpu_torch.slo\n"
        "import chanamq_tpu_torch.telemetry\n"
        "import chanamq_tpu_torch.control\n"
        "import chanamq_tpu_torch.otel.export\n"
        "import chanamq_tpu_torch.cluster.rpc\n"
        "import chanamq_tpu_torch.cluster.node\n"
        "import chanamq_tpu_torch.cluster.lifecycle\n"
        "import chanamq_tpu_torch.replicate\n"
        "import chanamq_tpu_torch.shard.supervisor\n"
        "import chanamq_tpu_torch.shard.handoff\n"
        "import chanamq_tpu_torch.federation\n"
        "import chanamq_tpu_torch.utils.logjson\n"
        "import chanamq_tpu_torch.chaos.soak\n"
        "import chanamq_tpu_torch.bench\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chanamq_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_config_routes_on_cuda_or_raises(event_loop):
    """With default config the router's tables go to the card. Without a
    card, building them raises; nothing runs on the CPU instead."""
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.config import DEFAULTS
    from chanamq_tpu_torch.router import compile as rcompile

    assert DEFAULTS["chana.mq.router.backend"] == "torch"
    assert DEFAULTS["chana.mq.router.device"] == "cuda"
    broker = Broker()
    router = broker.router
    assert router.backend == "torch" and router.device.type == "cuda"
    ce = rcompile.compile_exchange("topic", [("a.*", "q", None)])
    items = [("a.b", None)]
    if torch.cuda.is_available():
        got = rcompile.route_batch(ce, items, router.backend, router.device)
        assert got == [frozenset({"q"})]
        assert ce._device_tables[0] == router.device
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            rcompile.route_batch(ce, items, router.backend, router.device)
        assert ce._device_tables is None
    event_loop.run_until_complete(broker.stop())


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the repository exits non-zero
    and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        script.write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
