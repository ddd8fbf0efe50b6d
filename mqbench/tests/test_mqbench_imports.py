"""The benchmark stands apart from JAX and, where it measures, from the
program: no module under ``mqbench/`` imports ``jax``, ``jaxlib`` or the
JAX package ``chanamq_tpu``; the plain references and the frozen copies
import nothing of ``chanamq_tpu_torch`` either; nothing reads the JAX
package's harness or its results; and a run leaves none of them loaded.
Top-level names are compared whole: ``chanamq_tpu_torch`` is not
``chanamq_tpu``.

Run: ``python -m pytest mqbench/tests -q`` from the repository's root.
"""

import ast
import os
import re
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX = {"jax", "jaxlib", "flax", "chanamq_tpu"}
STANDALONE = ("reference", "frozen")
NOT_READ = re.compile(r"(?<![\w.])bench\.py|BENCH_(r\d|trajectory|torch)"
                      r"|MULTICHIP_r|BASELINE\.json")


def _sources():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    sources = list(_sources())
    assert len(sources) > 20
    bad = {p: _imports(p) & JAX for p in sources if _imports(p) & JAX}
    assert not bad, bad


def test_references_and_frozen_copies_import_nothing_of_the_program():
    bad = {}
    for p in _sources():
        rel = os.path.relpath(p, BENCH).split(os.sep)
        if rel[0] in STANDALONE:
            found = _imports(p) & (JAX | {"chanamq_tpu_torch"})
            if found:
                bad[p] = found
    assert not bad, bad


def test_nothing_names_the_jax_packages_harness_or_results():
    bad = []
    for p in _sources():
        if os.path.basename(p) == os.path.basename(__file__):
            continue
        with open(p) as f:
            text = f.read()
        bad += [(p, m.group(0)) for m in NOT_READ.finditer(text)]
    assert not bad, bad


def test_no_module_shadows_a_name_the_tests_import():
    names = {os.path.splitext(f)[0] for f in os.listdir(BENCH)}
    assert not names & {"bench", "chip_smoke"}, names


def test_a_run_leaves_no_jax_module_loaded():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(BENCH, 'tests')!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from test_mqbench_reference import tiny_forecast_spec, "
        "tiny_router_spec\n"
        "from mqbench import harness\n"
        "from mqbench.drivers import forecast_rounds, amqp_node\n"
        "forecast_rounds.run(tiny_forecast_spec(seconds=0.2))\n"
        "amqp_node.run(tiny_router_spec('router-caps.hot-keys', "
        "seconds=0.5))\n"
        "print('LOADED', harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
