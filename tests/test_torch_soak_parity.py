"""The port's soak and bench harness against the reference's, on the same
seeds: ``chanamq_tpu_torch/chaos/soak.py`` and
``chanamq_tpu_torch/bench.py`` beside ``chanamq_tpu/chaos/soak.py`` and
the repo's ``bench.py``.

- The seeded plans (``default_plan``, ``overload_plan``,
  ``control_spike_sizes``) are equal, fingerprints included.
- The chaos soak and the overload soak give zero violations in both
  packages, the same plan fingerprint, and the same confirmed and
  delivered counts (the port's brokers route on the CPU, the
  reference's through JAX on the CPU).
- The bench's regression verdict and baseline lookup agree on the same
  records.
- ``--route``'s binding and key corpora are equal, and the port's torch
  backend on the CPU routes every key to the reference's JAX backend's
  set (and the trie's) at 1,000 and 10,000 bindings.
"""

import asyncio
import json
import random

import pytest
import torch

import bench as ref_bench
from chanamq_tpu.chaos import soak as ref_soak
from chanamq_tpu.router import compile as ref_compile
from chanamq_tpu_torch import bench as port_bench
from chanamq_tpu_torch.chaos import soak as port_soak
from chanamq_tpu_torch.router import compile as port_compile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_plan(a, b) -> None:
    assert a.seed == b.seed
    assert a.to_dict() == b.to_dict()
    assert a.fingerprint() == b.fingerprint()
    assert a.schedule_preview() == b.schedule_preview()


@pytest.mark.parametrize("messages", [60, 160])
def test_default_plans_equal(messages):
    owner = "127.0.0.1:23001"
    _same_plan(ref_soak.default_plan(42, owner, messages),
               port_soak.default_plan(42, owner, messages))


def test_overload_plans_and_spike_sizes_equal():
    _same_plan(ref_soak.overload_plan(7), port_soak.overload_plan(7))
    assert ref_soak.control_spike_sizes(7) == port_soak.control_spike_sizes(7)
    assert ref_soak.EXPECTED_ALERT_RULES == port_soak.EXPECTED_ALERT_RULES


SOAK_KEYS = ("seed", "messages", "fingerprint", "confirmed",
             "delivered_unique", "promotions", "handoffs", "crashed",
             "interconnect", "store", "stream", "post_settle_duplicates",
             "violations")


def test_chaos_soak_same_in_both_packages():
    ref = asyncio.run(asyncio.wait_for(
        ref_soak.run_soak(42, messages=60), 120))
    port = asyncio.run(asyncio.wait_for(
        port_soak.run_soak(42, messages=60, device="cpu"), 120))
    assert ref["violations"] == [] and port["violations"] == []
    assert {k: port[k] for k in SOAK_KEYS} == {k: ref[k] for k in SOAK_KEYS}
    assert port["chaos"]["fingerprint"] == ref["chaos"]["fingerprint"]
    for report in (ref, port):
        assert report["key_shared"]["per_key_ordered"] is True
    assert port["key_shared"]["records"] == ref["key_shared"]["records"]


OVERLOAD_KEYS = ("seed", "messages", "fingerprint", "confirmed",
                 "delivered_unique", "hard_limit", "low_watermark",
                 "under_hard_limit", "final_stage", "violations")


def test_overload_soak_same_in_both_packages():
    ref = asyncio.run(asyncio.wait_for(
        ref_soak.run_overload_soak(7, messages=96), 120))
    port = asyncio.run(asyncio.wait_for(
        port_soak.run_overload_soak(7, messages=96, device="cpu"), 120))
    assert ref["violations"] == [] and port["violations"] == []
    assert {k: port[k] for k in OVERLOAD_KEYS} \
        == {k: ref[k] for k in OVERLOAD_KEYS}
    assert port["alerts"]["fired_rules"] == ref["alerts"]["fired_rules"]


def _records():
    """Pairs of (current, base) trajectory records around both bands."""
    rng = random.Random(3)
    pairs = []
    for _ in range(200):
        base = {"scenario": "s", "us_per_msg": rng.uniform(5, 50),
                "rev": "abc", "ts": 1}
        if rng.random() < 0.8:
            base["cpu_us_per_msg"] = rng.uniform(1, 20)
        cur = {"scenario": "s",
               "us_per_msg": base["us_per_msg"] * rng.uniform(0.8, 1.4),
               "cpu_us_per_msg": (rng.uniform(1, 30)
                                  if rng.random() < 0.9 else None)}
        pairs.append((cur, base))
    pairs.append(({"scenario": "s", "us_per_msg": 120.0,
                   "cpu_us_per_msg": 22.0},
                  {"scenario": "s", "us_per_msg": 100.0,
                   "cpu_us_per_msg": 20.0}))
    return pairs


def test_regress_verdicts_equal():
    for cur, base in _records():
        assert port_bench.regress_evaluate(cur, base) \
            == ref_bench.regress_evaluate(cur, base)
        assert port_bench.regress_evaluate(cur, base, 0.05, 0.05) \
            == ref_bench.regress_evaluate(cur, base, 0.05, 0.05)


def test_trajectory_baselines_equal(tmp_path):
    env = ref_bench._env_fingerprint()
    assert port_bench._env_fingerprint() == env
    path = tmp_path / "traj.jsonl"
    other = dict(env, cores=(env["cores"] or 0) + 64)
    with open(path, "w") as f:
        for i, (scenario, e) in enumerate([
                ("s", env), ("s", other), ("t", env), ("s", env),
                ("t", dict(env, native=not env["native"])), ("u", env)]):
            f.write(json.dumps({"scenario": scenario, "us_per_msg": i,
                                "env": e, "ts": i}) + "\n")
        f.write("{half a line\n")
    for scenario in ("s", "t", "u", "missing"):
        ref_stats, port_stats = {}, {}
        assert port_bench.trajectory_baseline(
            scenario, str(path), port_stats) == ref_bench.trajectory_baseline(
            scenario, str(path), ref_stats)
        assert port_stats == ref_stats == {"corrupt_lines": 1}
    assert port_bench.trajectory_baseline("s", str(tmp_path / "none")) \
        is None


@pytest.mark.parametrize("n", [1_000, 10_000])
def test_route_corpus_and_routed_sets_equal(n):
    """``--route``'s corpus at ``n`` bindings (its quick key count, drawn
    from the same seeded generator state as the bench's), every key
    routed by the port's torch backend on the CPU, by the reference's
    JAX backend and by the trie."""
    ref_m = ref_bench._route_build_matcher(n)
    port_m = port_bench._route_build_matcher(n)
    assert port_m.bindings() == ref_m.bindings()
    ref_rng, port_rng = random.Random(8), random.Random(8)
    for size in (1_000, 10_000):
        ref_keys = ref_bench._route_keys(size, 2048, ref_rng)
        port_keys = port_bench._route_keys(size, 2048, port_rng)
        assert port_keys == ref_keys
        if size == n:
            break
    items = [(k, None) for k in port_keys]
    ref_ce = ref_compile.compile_exchange("topic", ref_m.bindings())
    port_ce = port_compile.compile_exchange("topic", port_m.bindings())
    assert port_ce.kernel_rows == ref_ce.kernel_rows
    batch = 512
    ref_got, port_got = [], []
    for i in range(0, len(items), batch):
        ref_got += ref_compile.route_batch(ref_ce, items[i:i + batch], "jax")
        port_got += port_compile.route_batch(
            port_ce, items[i:i + batch], "torch", device="cpu")
    assert [set(g) for g in port_got] == [set(g) for g in ref_got]
    assert [set(g) for g in port_got] == [port_m.route(k) for k in port_keys]
