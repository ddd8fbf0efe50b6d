"""The plain references and both drivers on the CPU, at tiny sizes.

- The reference matchers against an enumeration of small tables (a
  second, independent topic matcher) and against the program's matchers.
- Each driver runs end to end on the CPU, the program's kernels in their
  plain versions, and comes out correct against the reference.
- The control: the forecaster's reference in the program's place at
  float8 fails one of the cell's limits.

Run: ``python -m pytest mqbench/tests -q`` from the repository's root.
"""

import itertools
import json
import os
import random
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mqbench import harness  # noqa: E402
from mqbench.reference.matchers import HeadersMatcher, TopicMatcher  # noqa: E402

FORECAST_CELL = "forecaster-flagship.w2048"
ROUTER_CELLS = ("router-caps.unique-keys", "router-caps.hot-keys")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _topic_matches(pattern: list, words: list) -> bool:
    """Pattern against key by dynamic programming over (pattern, key)
    prefixes."""
    ok = [[False] * (len(words) + 1) for _ in range(len(pattern) + 1)]
    ok[0][0] = True
    for i, tok in enumerate(pattern, 1):
        for j in range(len(words) + 1):
            if tok == "#":
                ok[i][j] = ok[i - 1][j] or (j > 0 and ok[i][j - 1])
            elif j > 0:
                ok[i][j] = ok[i - 1][j - 1] and tok in ("*", words[j - 1])
    return ok[len(pattern)][len(words)]


def test_topic_matcher_against_enumeration():
    toks = ["a", "b", "*", "#"]
    patterns = [".".join(p) for n in range(1, 4)
                for p in itertools.product(toks, repeat=n)]
    m = TopicMatcher()
    for i, pat in enumerate(patterns):
        m.bind(pat, f"q{i}")
    for n in range(1, 5):
        for key in itertools.product(["a", "b", "c"], repeat=n):
            want = {f"q{i}" for i, pat in enumerate(patterns)
                    if _topic_matches(pat.split("."), list(key))}
            assert m.route(".".join(key)) == want, key


def test_matchers_agree_with_the_program():
    from chanamq_tpu_torch.broker.matchers import (
        HeadersMatcher as ProgHeaders, TopicMatcher as ProgTopic)

    rng = random.Random(5)
    vocab = ["w0", "w1", "w2", "w3"]
    topic, prog_topic = TopicMatcher(), ProgTopic()
    for i in range(200):
        toks = [rng.choice(vocab + ["*", "#"]) for _ in range(rng.randint(1, 4))]
        topic.bind(".".join(toks), f"q{i}")
        prog_topic.bind(".".join(toks), f"q{i}")
    for _ in range(500):
        key = ".".join(rng.choice(vocab + ["x"])
                       for _ in range(rng.randint(1, 5)))
        assert topic.route(key) == set(prog_topic.route(key)), key
    headers, prog_headers = HeadersMatcher(), ProgHeaders()
    names, values = ["h0", "h1", "h2"], ["v0", "v1"]
    for i in range(60):
        args = {h: rng.choice(values)
                for h in rng.sample(names, rng.randint(1, 3))}
        args["x-match"] = rng.choice(["all", "any"])
        headers.bind(f"q{i}", args)
        prog_headers.bind("", f"q{i}", args)
    for _ in range(300):
        hs = {h: rng.choice(values)
              for h in rng.sample(names, rng.randint(0, 3))}
        assert headers.route(hs) == set(prog_headers.route("", hs)), hs


def tiny_forecast_spec(seed: int = 2**31 + 99, seconds: float = 0.3,
                       trace: bool = False) -> harness.Spec:
    bench = harness.load_benchmark()
    cell, _, config, traffic = harness.find_cell(bench, FORECAST_CELL)
    config = json.loads(json.dumps(config))
    config["model"].update(d_model=32, n_heads=4, d_ff=64, n_layers=2)
    traffic = dict(traffic, window=16, history=200, batch=4,
                   steps_per_round=4, trace_seconds=seconds)
    return harness.Spec(cell=cell, config=config, traffic=traffic,
                        seed=seed, seconds=seconds, trace=trace,
                        device="cpu", started=time.perf_counter())


def tiny_router_spec(name: str, seed: int = 2**31 + 7,
                     seconds: float = 1.0, trace: bool = False):
    # the router cells' files, which BENCHMARK.json does not list yet
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "router-caps.json")) as f:
        config = json.load(f)
    with open(os.path.join(harness.BENCH_DIR, "traffic",
                           f"{name}.json")) as f:
        traffic = json.load(f)
    cell = {"name": name, "config": "router-caps", "traffic": name,
            "chips": 1}
    config["topology"].update(n_queues=128, n_patterns=32,
                              header_bindings=16, header_sets=32, pool=32)
    traffic = dict(traffic, messages_per_publisher=2000, warmup_s=0.5,
                   check_sample=1000, publishers=2, consumers=2)
    return harness.Spec(cell=cell, config=config, traffic=traffic,
                        seed=seed, seconds=seconds, trace=trace,
                        device="cpu", started=time.perf_counter())


def test_forecast_driver_is_correct_on_the_cpu():
    from mqbench.drivers import forecast_rounds

    out = forecast_rounds.run(tiny_forecast_spec())
    assert harness.judge(out), out["checks"]
    assert out["attempted"] >= 1 and out["end_to_end"]["round_ms"] > 0


@pytest.mark.parametrize("cell", ROUTER_CELLS)
def test_router_driver_is_correct_on_the_cpu(cell):
    from mqbench.drivers import amqp_node

    out = amqp_node.run(tiny_router_spec(cell))
    assert harness.judge(out), out["checks"]
    assert out["attempted"] > 0


def test_forecast_control_fails_a_limit():
    from mqbench.drivers import forecast_rounds

    spec = tiny_forecast_spec()
    got = forecast_rounds.calibration(spec, "control")
    limits = spec.traffic["limits"]
    assert any(got[n] > lim for n, lim in limits.items()), got


def test_router_control_fails():
    from mqbench.drivers import amqp_node

    got = amqp_node.calibration(tiny_router_spec(ROUTER_CELLS[0]), "control")
    assert got["routed_set_mismatches"] > 0, got
