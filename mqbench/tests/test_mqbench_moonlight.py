"""The Moonlight cell's reference and driver on the CPU, at a tiny size.

- The benchmark's copy of the reference (``mqbench/reference/
  moonlight.py``) and the tests' copy (``tests/moonlight_reference.py``)
  agree: the same forward, loss and gradients on the same parameters.
- The driver runs end to end on the CPU, the program's kernels in their
  plain versions, and comes out correct against the reference.
- Each of its calibration kinds but ``program`` (the control at float8,
  and the faults: half of each batch, steps that leave the state
  unchanged, each token's sixth routed expert or the shared experts left
  out) fails one of the cell's limits; and the same faults planted under
  the timed path turn a run's ``correct`` false.

Run: ``python -m pytest mqbench/tests -q`` from the repository's root.
"""

import importlib.util
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mqbench import harness  # noqa: E402
from mqbench.reference import moonlight as bench_ref  # noqa: E402

CELL = "moonlight-forecaster.w2048"
TINY = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
            intermediate_size=128, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            num_hidden_layers=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_spec(seed: int = 2**31 + 5, seconds: float = 0.3,
              trace: bool = False) -> harness.Spec:
    bench = harness.load_benchmark()
    cell, _, config, traffic = harness.find_cell(bench, CELL)
    config = json.loads(json.dumps(config))
    config.update(TINY)
    traffic = dict(traffic, window=16, history=200, batch=4,
                   steps_per_round=4, trace_seconds=seconds)
    return harness.Spec(cell=cell, config=config, traffic=traffic,
                        seed=seed, seconds=seconds, trace=trace,
                        device="cpu", started=time.perf_counter())


def _tests_copy():
    path = os.path.join(ROOT, "tests", "moonlight_reference.py")
    spec = importlib.util.spec_from_file_location("moonlight_reference_t",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_two_reference_copies_agree():
    from mqbench.drivers import forecast_rounds_moonlight as drv

    other = _tests_copy()
    spec = tiny_spec()
    cfg = drv.model_cfg(spec.config, spec.traffic)
    assert bench_ref.param_shapes(cfg) == other.param_shapes(cfg)
    params = drv.params(7, bench_ref.param_shapes(cfg), "cpu")
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, cfg["seq_len"], 8, generator=gen)
    y = torch.randn(2, 8, generator=gen)
    out = []
    for mod in (bench_ref, other):
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        loss = torch.mean((mod.forward(leaves, x, cfg) - y) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_driver_is_correct_on_the_cpu():
    from mqbench.drivers import forecast_rounds_moonlight as drv

    out = drv.run(tiny_spec())
    assert harness.judge(out), out["checks"]
    assert out["attempted"] >= 1 and out["end_to_end"]["round_ms"] > 0
    moe = out["readings"]["moe"]
    assert moe["routed_rows"] == 2 * 4 * 16 * 2 * out["readings"]["steps"]


@pytest.mark.parametrize("kind", ["control", "half_batch", "unchanged",
                                  "drop_sixth", "drop_shared"])
def test_calibration_kinds_fail_a_limit(kind):
    from mqbench.drivers import forecast_rounds_moonlight as drv

    spec = tiny_spec()
    got = drv.calibration(spec, kind)
    limits = spec.traffic["limits"]
    assert any(got[n] > lim for n, lim in limits.items()), (kind, got)


def _drop_sixth(real):
    def route_weights(scores, idx, scale):
        w = real(scores, idx, scale)
        low = torch.gather(scores, 1, idx).argmin(-1, keepdim=True)
        return w.scatter(1, low, 0.0)
    return route_weights


def _no_shared(real):
    def combine(ys, w, d, shared, residual):
        return real(ys, w, d, shared * 0, residual)
    return combine


@pytest.mark.parametrize("field,fault", [("route_weights", _drop_sixth),
                                         ("combine", _no_shared)])
def test_mixture_faults_under_the_timed_path_are_caught(monkeypatch, field,
                                                        fault):
    from chanamq_tpu_torch.kernels import moonlight as mk

    from mqbench.drivers import forecast_rounds_moonlight as drv

    monkeypatch.setattr(mk, "KERNELS", mk.KERNELS._replace(
        **{field: fault(getattr(mk.KERNELS, field))}))
    from chanamq_tpu_torch.models import moonlight as moon
    monkeypatch.setattr(moon.forward, "__kwdefaults__",
                        {**moon.forward.__kwdefaults__, "ops": mk.KERNELS})
    monkeypatch.setattr(moon.loss_fn, "__kwdefaults__",
                        {**moon.loss_fn.__kwdefaults__, "ops": mk.KERNELS})
    monkeypatch.setattr(moon.make_train_step, "__kwdefaults__",
                        {**moon.make_train_step.__kwdefaults__,
                         "ops": mk.KERNELS})
    assert not harness.judge(drv.run(tiny_spec()))


def test_unchanged_steps_are_caught(monkeypatch):
    from chanamq_tpu_torch.models import moonlight as moon

    from mqbench.drivers import forecast_rounds_moonlight as drv

    def make(cfg, lr=1e-3, clip_norm=1.0, **kw):
        def step(params, momentum, batch):
            return params, momentum, moon.loss_fn(params, batch,
                                                  cfg).detach()
        return step

    monkeypatch.setattr(moon, "make_train_step", make)
    assert not harness.judge(drv.run(tiny_spec()))
