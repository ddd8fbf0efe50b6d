"""The port stands alone: ``chanamq_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package, and the default router
device is the card, never a silent CPU."""

import ast
import os
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
    assert len(sources) > 50
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


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import sys\n"
        "import chanamq_tpu_torch.broker.server\n"
        "import chanamq_tpu_torch.broker.broker\n"
        "import chanamq_tpu_torch.client\n"
        "import chanamq_tpu_torch.router.engine\n"
        "import chanamq_tpu_torch.config\n"
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
