"""``chip_smoke.py``'s bench-harness phases rehearsed on the CPU at small
sizes: ``[bench-route]`` (the route spec at ``--quick`` sizes, every
router call kept and replayed), ``[bench]`` (a PerfTest spec with its
broker a ``--cluster-child`` process reporting its router counters) and
``[soak]`` (two short soak runs, every broker on the CPU). On the CPU
the wrappers run their plain versions, so no kernel launches.
"""

import pytest
import torch

import chip_smoke

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_route_phase_rehearsal():
    res = chip_smoke.phase_bench_route(CPU, quick=True)
    assert set(res["sizes"]) == {"1000", "10000"}
    for size in res["sizes"].values():
        assert size["parity_mismatches"] == 0
        assert size["batched_torch_us_per_msg"] > 0
    assert res["launches"] == {"topic_match": 0, "headers_match": 0}
    assert res["path"]["topic_match"]["calls"] > 0
    assert res["path"]["topic_match"]["max_abs_err"] == 0
    assert res["key_shared_fanout"]["deliveries"] == 20 * 100
    chip_smoke.log_bench_route(res, {"smi": "cpu"})


def test_bench_phase_rehearsal():
    res = chip_smoke.phase_bench(CPU, specs=("topic_3p3c_wildcards",),
                                 seconds=1.0)
    row = res["topic_3p3c_wildcards"]
    assert row["delivered"] > 0
    broker = row["broker"]
    assert broker["router"]["device"] == "cpu"
    assert broker["router"]["batches"] > 0
    assert broker["launches"] == {"topic_match": 0, "headers_match": 0}
    chip_smoke.log_bench(res, {"smi": "cpu"})


def test_soak_phase_rehearsal():
    runs = (("churn", "run_connection_churn", 20, {}, 120),
            ("tenant-churn", "run_tenant_churn", 200, {}, 120))
    res = chip_smoke.phase_soak(CPU, runs)
    assert set(res) == {"churn", "tenant-churn"}
    for row in res.values():
        assert row["violations"] == []
        assert row["launches"] == {"topic_match": 0, "headers_match": 0}
    chip_smoke.log_soak(res, {"smi": "cpu"})
