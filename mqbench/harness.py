"""What every cell's run shares: ``BENCHMARK.json`` and the files it names,
the card's check, the profiler's reading, and the result line.

A run is ``run_cell``: it finds the cell, its configuration and traffic
files and its driver (``drivers/<config's driver>.py``), lets the driver
set up, measure and check, takes the per-layer metrics from
``metrics/<name>.py`` in a traced run, and returns the result object that
``run.py`` prints. Nothing here knows a cell, a configuration or a metric
by name.
"""

from __future__ import annotations

import bisect
import heapq
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Callable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "chanamq_tpu")


class BenchError(Exception):
    """A run that cannot give a result: no card, a missing file, an
    unknown name."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: str = ROOT) -> tuple:
    """(cell, configuration entry, configuration file, traffic file)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        traffic = json.load(f)
    return cell, entry, config, traffic


def load_driver(name: str):
    return importlib.import_module(f"mqbench.drivers.{name}")


def load_metric(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``: readings -> value or None."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"mqbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric is the cell's where its ``workloads`` lists the cell, or,
    without the key, where the cell reports the end-to-end metric it
    moves (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


@dataclasses.dataclass
class Spec:
    """What a driver is given: the cell, its configuration and traffic,
    the run's seed, window and trace switch, the device, and the
    process's start on the host clock (``perf_counter``)."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def query_card():
    """``nvidia-smi``'s reading of the card's name, power limit, draw,
    clocks and temperature, started now and read by ``card_notes``: it
    runs beside the set-up, not in it."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        return exc


def card_notes(query) -> None:
    """The card's reading and the host's usable cores, on standard
    error."""
    log(f"[host] usable cores {len(os.sched_getaffinity(0))}")
    if isinstance(query, Exception):
        out = f"nvidia-smi unavailable: {query}"
    else:
        try:
            out = query.communicate(timeout=30)[0].strip()
        except subprocess.TimeoutExpired:
            query.kill()
            out = query.communicate()[0].strip() + " (timed out)"
    log(f"[card] {out}")


# -- the profiler's reading -------------------------------------------------


def start_profiler():
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def annotated(fn, name: str):
    """``fn`` inside a profiler span ``name``: a benchmark span around a
    call into a layer, for a traced run."""
    import torch

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _merge(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


WINDOW_SPAN = "mqbench.window"


def trace_summary(prof) -> dict:
    """The device's work in a stopped profiler's window, the span that the
    driver opened as ``WINDOW_SPAN`` around it: busy seconds (the union of
    kernel and copy intervals), each kernel name's launches and seconds in the window and
    every launch's seconds over the whole trace in order, the ten longest
    device operations by name, and the idle gaps summed by the host work
    that covered them (``_attribute``)."""
    from torch.autograd import DeviceType

    # user annotations (``record_function``) also appear on the device's
    # side of the trace, spanning the work they wrapped: not device work
    events = [e for e in prof.events()
              if not (e.device_type == DeviceType.CUDA
                      and (getattr(e, "is_user_annotation", False)
                           or e.name.startswith("mqbench.")))]
    spans = [e.time_range for e in events if e.name == WINDOW_SPAN
             and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise BenchError(f"{len(spans)} {WINDOW_SPAN} spans in the trace")
    t0_us, t1_us = spans[0].start, spans[0].end
    device, host = [], []
    launches: dict = {}
    for e in sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        launches.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e6)
    for e in events:
        if e.name == WINDOW_SPAN:
            continue
        a, b = e.time_range.start, e.time_range.end
        if b < t0_us or a > t1_us:
            continue
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, max(a, t0_us), min(b, t1_us)))
        elif e.device_type == DeviceType.CPU:
            host.append((a, b, e.name))
    kernels: dict = {}
    for name, a, b in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy = _merge([(a, b) for _, a, b in device])
    gaps, last = [], t0_us
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1_us > last:
        gaps.append((last, t1_us))
    by_host = _attribute(gaps, host)
    for a, b, name in sorted(host, key=lambda h: h[0] - h[1])[:3]:
        log(f"[trace] long host event {name[:80]!r} {(b - a) / 1e6:.6f} s "
            f"from {(a - t0_us) / 1e6:.6f} s into the window")
    ops = sorted(((n, v[1]) for n, v in kernels.items()),
                 key=lambda kv: -kv[1])
    return {
        "window_s": (t1_us - t0_us) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {n: {"launches": v[0], "seconds": v[1]}
                    for n, v in kernels.items()},
        "launch_seconds": launches,
        "device_ops": [[n[:160], s] for n, s in ops[:10]],
        "idle_gaps": [[n, s] for n, s in sorted(
            by_host.items(), key=lambda kv: -kv[1])[:10]],
    }


OUTSIDE = "host: outside traced ops"


def _attribute(gaps: list, host: list) -> dict:
    """Seconds of device idle by what the host was doing: each stretch of
    a gap goes to the shortest host event (a traced op or a benchmark
    span) that covers it, and to ``OUTSIDE`` where none does."""
    host.sort()
    starts = [h[0] for h in host]
    longest = [h for h in host if h[1] - h[0] > 2000.0]
    out: dict = {}

    def add(name: str, us: float) -> None:
        out[name] = out.get(name, 0.0) + us / 1e6

    for a, b in gaps:
        lo = bisect.bisect_left(starts, a)
        hi = bisect.bisect_left(starts, b)
        cands = {ev for ev in host[max(0, lo - 256):hi] + longest
                 if ev[1] > a and ev[0] < b}
        points = sorted([(max(a, ev[0]), 1, ev) for ev in cands]
                        + [(min(b, ev[1]), 0, ev) for ev in cands])
        active: list = []   # heap of (duration, start, end, name)
        ended: set = set()
        prev = a
        for x, starting, ev in points:
            while active and active[0][1:3] in ended:
                heapq.heappop(active)
            if x > prev:
                add(active[0][3] if active else OUTSIDE, x - prev)
                prev = x
            if starting:
                heapq.heappush(active, (ev[1] - ev[0], ev[0], ev[1],
                                        ev[2][:120]))
            else:
                ended.add((ev[0], ev[1]))
        if b > prev:
            add(OUTSIDE, b - prev)
    return out


# -- a run ------------------------------------------------------------------


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(out: dict) -> bool:
    """A driver's run is correct when the driver found nothing wrong and
    every compared number is within its limit."""
    return bool(out["correct"]) and all(v <= lim for _, v, lim in
                                        out["checks"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             started: float, device: str = "cuda",
             root: str = ROOT) -> dict:
    """One run of one cell: the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, and with ``trace`` ``breakdown``),
    the compared numbers beside their limits under ``checks``, last."""
    bench = load_benchmark(root)
    cell, _, config, traffic = find_cell(bench, workload, root)
    query = None
    if device.startswith("cuda"):
        query = query_card()
        check_card(cell["chips"])
    try:
        driver = load_driver(config["driver"])
        out = driver.run(Spec(cell=cell, config=config, traffic=traffic,
                              seed=int(seed), seconds=float(seconds),
                              trace=bool(trace), device=device,
                              started=started))
    finally:
        if query is not None:
            card_notes(query)
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules of JAX or the JAX package loaded: {found}")
    reported = set(out["end_to_end"]) | {"setup_s"}
    metrics: dict = {}
    if not trace:
        for m in bench["end_to_end"]:
            if not applies(m, workload, reported):
                continue
            value = out["setup_s"] if m["name"] == "setup_s" \
                else out["end_to_end"].get(m["name"])
            if value is None:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, workload, reported):
                continue
            value = load_metric(m["name"])(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = out["checks"]
    correct = judge(out)
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": out["device_kind"], "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["readings"].get("trace") is not None:
        t = out["readings"]["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result
