"""A configuration, a cell and a per-layer metric are added by adding
files and ``BENCHMARK.json`` entries alone: in a copy of ``mqbench/`` and
``BENCHMARK.json``, a new configuration file, traffic file, metric module
and entries make a cell that the harness lists, loads and runs, with its
new metric in the traced run's line, and no file that was there changes.

Run: ``python -m pytest mqbench/tests -q`` from the repository's root.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL = "tiny-forecaster.w16"


def _digests(top: str) -> dict:
    out = {}
    for root, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_from_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "mqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(str(tmp_path))
    b = tmp_path / "mqbench"
    config = json.loads((b / "configs" / "forecaster-flagship.json").read_text())
    config["model"].update(d_model=32, n_heads=4, d_ff=64, n_layers=2)
    (b / "configs" / "tiny-forecaster.json").write_text(json.dumps(config))
    traffic = json.loads(
        (b / "traffic" / "forecaster-flagship.w64.json").read_text())
    traffic.update(window=16, history=200, batch=4, steps_per_round=4,
                   trace_seconds=0.3)
    (b / "traffic" / f"{CELL}.json").write_text(json.dumps(traffic))
    (b / "metrics" / "rounds_per_s.py").write_text(
        "def read(r):\n"
        "    return r['rounds'] / r['window_s'] if r.get('rounds') else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-forecaster", "source": "arXiv:1706.03762",
        "file": "mqbench/configs/tiny-forecaster.json", "reduced": [],
        "why": "a test's configuration"})
    bench["workloads"].append({
        "name": CELL, "config": "tiny-forecaster", "traffic": CELL,
        "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "round_ms":
            m["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": "rounds_per_s", "unit": "rounds/s", "better": "higher",
        "source": "host_clock", "layer": "forecast service",
        "moves": "round_ms", "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in ("BENCHMARK.json",):
        before.pop(path)
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from mqbench import harness\n"
        f"assert harness.BENCH_DIR == {str(b)!r}\n"
        f"bench = harness.load_benchmark({str(tmp_path)!r})\n"
        f"assert {CELL!r} in [w['name'] for w in bench['workloads']]\n"
        "for trace in (False, True):\n"
        f"    out = harness.run_cell({CELL!r}, 7, 0.3, trace, "
        f"started=time.perf_counter(), device='cpu', root={str(tmp_path)!r})\n"
        "    print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = (json.loads(line) for line in
                     res.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"round_ms", "setup_s"}
    assert traced["metrics"]["rounds_per_s"]["value"] > 0
    after = _digests(str(tmp_path))
    assert {p: after.get(p) for p in before} == before
