"""Entry kind ``forecast_rounds_moonlight``: the forecast service's training
rounds with the Moonlight backbone (``chanamq_tpu_torch/models/
moonlight.py``), Moonlight-16B-A3B's block at its published widths.

As ``forecast_rounds``: set-up makes the telemetry history and the float32
parameters from the seed, builds one ``ForecastService`` with
``model_kwargs={"backbone": "moonlight", ...}`` from the configuration's
widths and the traffic's window, batch and steps a round, gives it the
parameters (``_torch_setup``), and runs its first round through ``_round``,
which also warms every shape. The window then runs ``_round`` back to back
until ``seconds`` have passed: ``round_ms`` is the window's length over the
rounds completed in it. A traced run traces a window of at most the
traffic's ``trace_seconds``; its readings add the service's routing
counters over the window.

At 2.42 B parameters a whole copy of the state is 9.7 GB, so the first
round keeps, instead of copies, what ``reference/compare.py`` reads of
them: each leaf's norm (float64) of the clipped gradient after the first
step and of its change over the first three steps (the start drawn again
from the seed, a leaf at a time). The comparison then runs on trees of
those norms, which give ``compare.training_numbers`` its numbers exactly.
After the window, with the peak memory read and the program's state
freed, the plain reference (``mqbench/reference/moonlight.py``) runs the
first round from the same inputs, and those numbers decide ``correct``
against the traffic file's ``limits``. The window's routed rows are
logged beside top-k x tokens x expert layers x steps; they are the
dispatch's own count of the router's choices, equal to that by
construction, so they are no check: a row that never reached the grouped
products or the combine shows in ``grad_gap`` (the sixth expert left out
fails it at every calibration seed).

Routing is discrete, and at bf16 two runs of the reference that differ in
summation order alone choose other experts for 2-15% of a layer's tokens,
which moves the loss by up to 6% and a leaf's gradient by up to 14% (three
seeds on the card): as much as float8 activations do. So the reference
follows the program's expert choices (each mixture layer's, in order, as
``dispatch`` took them) and ``route_gap`` holds those choices to the
reference's own scores: a choice may fall short of the reference's top k
only by what rounding moves a score.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np

from mqbench import forecast_inputs, harness
from mqbench.reference import compare
from mqbench.reference import moonlight as ref

KEEP_STEPS = 3
# the service's model_kwargs from the configuration's keys
_WIDTHS = {"d_model": "hidden_size", "n_heads": "num_attention_heads",
           "qk_nope": "qk_nope_head_dim", "qk_rope": "qk_rope_head_dim",
           "v_dim": "v_head_dim", "kv_rank": "kv_lora_rank",
           "d_ff": "intermediate_size", "expert_ff": "moe_intermediate_size",
           "n_experts": "n_routed_experts", "top_k": "num_experts_per_tok",
           "n_shared": "n_shared_experts", "n_layers": "num_hidden_layers",
           "first_dense": "first_k_dense_replace",
           "route_scale": "routed_scaling_factor",
           "rope_theta": "rope_theta", "eps": "rms_norm_eps"}


def model_cfg(config: dict, traffic: dict) -> dict:
    """The reference's configuration dict."""
    cfg = {k: config[v] for k, v in _WIDTHS.items()}
    cfg.update(n_features=config["model"]["n_features"],
               seq_len=traffic["window"],
               kv_eps=config["model"]["kv_layernorm_eps"])
    return cfg


def params(seed: int, shapes: dict, device):
    """Float32 parameters ``{name: tensor}`` on ``device`` from ``seed``:
    each matrix normal with ``1/sqrt(fan_in)`` (its second-last
    dimension), drawn a leaf at a time in ``shapes`` order by one
    ``torch.Generator``; biases 0, norm scales 1."""
    return dict(_draw(seed, shapes, device))


def _draw(seed: int, shapes: dict, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed & forecast_inputs.SEED_MASK)
    for name, shape in shapes.items():
        if name.endswith("/bias"):
            yield name, torch.zeros(shape, device=device)
        elif name.endswith("/scale"):
            yield name, torch.ones(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            yield name, t.mul_(np.float32(1.0 / np.sqrt(shape[-2])))


def _norm(t) -> float:
    return float(t.double().norm())


class Observer:
    """What the comparison reads of a round, kept as norms: the clipped
    gradient's after step 1 (the momentum then) and each leaf's change
    over the first ``keep`` steps (the start drawn again from ``seed``)."""

    def __init__(self, seed: int, shapes: dict, device,
                 keep: int = KEEP_STEPS) -> None:
        self.seed, self.shapes, self.device, self.keep = (seed, shapes,
                                                          device, keep)
        self.grads: Optional[dict] = None
        self.change: Optional[dict] = None

    def __call__(self, k: int, params: dict, momentum: dict) -> None:
        if k == 1:
            self.grads = {n: _norm(m) for n, m in momentum.items()}
        if k == self.keep:
            self.change = {n: _norm(params[n] - start) for n, start in
                           _draw(self.seed, self.shapes, self.device)}


class Keeper:
    """A train step that feeds an ``Observer`` and keeps the first
    ``keep`` losses (device tensors, read after the round)."""

    def __init__(self, step, observer: Observer) -> None:
        self.step, self.observer, self.k = step, observer, 0
        self.losses: list = []

    def __call__(self, params, momentum, batch):
        out = self.step(params, momentum, batch)
        self.k += 1
        if self.k <= self.observer.keep:
            self.losses.append(out[2].detach().clone())
        self.observer(self.k, params, momentum)
        return out


def build_service(spec: harness.Spec, cfg: dict, history: np.ndarray):
    """The service with the seed's parameters, before any round."""
    from chanamq_tpu_torch.models.service import ForecastService

    t = spec.traffic
    svc = ForecastService(
        None, seq_len=cfg["seq_len"], history=len(history),
        batch=t["batch"], steps_per_round=t["steps_per_round"],
        lr=spec.config["train"]["lr"],
        model_kwargs={"backbone": "moonlight",
                      **{k: cfg[k] for k in list(_WIDTHS) + ["kv_eps"]}},
        device=spec.device)
    svc._torch_state = svc._torch_setup(
        params(spec.seed, ref.param_shapes(cfg), spec.device))
    return svc


def _tree(values: dict):
    import torch

    return {n: torch.tensor([v], dtype=torch.float64)
            for n, v in values.items()}


def _kept(losses: list, observer: Observer, forecast, std=None) -> dict:
    """A round's readings as ``compare.training_numbers`` takes them: the
    norms as one-element trees (with a zero start, a change's norm is its
    own)."""
    out = {"losses": [float(x) for x in losses],
           "grads": _tree(observer.grads), "params": _tree(observer.change),
           "forecast": np.asarray(forecast)}
    if std is not None:
        out["std"] = std
    return out


def first_round(spec: harness.Spec, cfg: dict, svc,
                history: np.ndarray) -> dict:
    """The service's first round, kept as norms, its forecast, and every
    expert choice it made (``routes``: each mixture layer's ``[rows,
    top_k]`` as the program's ``dispatch`` took it, in order)."""
    from chanamq_tpu_torch.kernels import moonlight as kernels

    state = svc._torch_state
    observer = Observer(spec.seed, ref.param_shapes(cfg), spec.device)
    keeper = state["step"] = Keeper(state["step"], observer)
    routes: list = []
    dispatch = kernels.dispatch

    def recorded(idx, n_experts):
        routes.append(idx.detach().clone())
        return dispatch(idx, n_experts)

    kernels.dispatch = recorded
    try:
        _, _, forecast = svc._round(history)
    finally:
        state["step"] = keeper.step
        kernels.dispatch = dispatch
    out = _kept(keeper.losses, observer,
                [forecast[n] for n in svc.feature_names])
    out["routes"] = routes
    return out


def reference_round(spec: harness.Spec, cfg: dict, history: np.ndarray,
                    act: str = "bf16", rows: Optional[int] = None,
                    update: bool = True, drop: Optional[str] = None,
                    routes: Optional[list] = None) -> dict:
    """The reference's first round from the seed's parameters, kept as
    norms (``drop``, ``rows`` and ``update`` are its faults), its expert
    choices (``routes``: its own, or those given, which it follows) and
    the given choices' ``margin`` against its own scores
    (``reference/moonlight.py``'s ``Routes``)."""
    import torch

    ref.set_precision()
    shapes = ref.param_shapes(cfg)
    observer = Observer(spec.seed, shapes, spec.device)
    chosen = ref.Routes(routes)
    p = params(spec.seed, shapes, spec.device)
    got = ref.first_round(
        p, history, cfg, batch=spec.traffic["batch"],
        steps=spec.traffic["steps_per_round"],
        lr=spec.config["train"]["lr"], keep_steps=KEEP_STEPS, act=act,
        rows=rows, update=update, drop=drop, observe=observer,
        routes=chosen, device=spec.device)
    del p
    if spec.device.startswith("cuda"):
        torch.cuda.empty_cache()
    out = _kept(got["losses"], observer, got["forecast"], got["std"])
    out.update(routes=chosen.taken, margin=chosen.margin)
    return out


def numbers(spec: harness.Spec, cfg: dict, history: np.ndarray,
            prog: dict) -> dict:
    """The comparison's numbers of ``prog`` against the reference that
    follows ``prog``'s expert choices: ``compare.training_numbers`` and
    ``route_gap``, the largest shortfall of those choices against the
    reference's own scores (sigmoid units; 0 where each is a top k)."""
    want = reference_round(spec, cfg, history, routes=prog["routes"])
    zero = _tree(dict.fromkeys(want["grads"], 0.0))
    got = compare.training_numbers(prog, want, zero)
    got["route_gap"] = want["margin"]
    return got


FAULTS = {"half_batch": "train on half of each batch",
          "unchanged": "steps that leave the state unchanged",
          "drop_sixth": "each token's sixth routed expert left out",
          "drop_shared": "the shared experts left out"}


def calibration(spec: harness.Spec, kind: str) -> dict:
    """One seed's numbers for setting the limits: ``program`` (the
    service's first round, as a run compares it), ``control`` (the
    reference in the program's place, its activations at float8), or one
    of ``FAULTS`` (the reference with that fault); each compared with the
    reference following its expert choices."""
    import torch

    cfg = model_cfg(spec.config, spec.traffic)
    history = forecast_inputs.history(spec.seed, spec.traffic)
    if kind == "program":
        svc = build_service(spec, cfg, history)
        prog = first_round(spec, cfg, svc, history)
        svc._torch_state = None
        del svc
        gc.collect()
    elif kind == "control":
        prog = reference_round(spec, cfg, history, act="fp8")
    elif kind == "half_batch":
        prog = reference_round(spec, cfg, history,
                               rows=spec.traffic["batch"] // 2)
    elif kind == "unchanged":
        prog = reference_round(spec, cfg, history, update=False)
    elif kind == "drop_sixth":
        prog = reference_round(spec, cfg, history, drop="sixth")
    elif kind == "drop_shared":
        prog = reference_round(spec, cfg, history, drop="shared")
    else:
        raise ValueError(f"unknown calibration {kind!r}")
    if spec.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return numbers(spec, cfg, history, prog)


def _counters(svc) -> tuple:
    return svc.moe_routed_rows, svc.moe_max_rows_sum


def run(spec: harness.Spec) -> dict:
    import torch

    cfg = model_cfg(spec.config, spec.traffic)
    cuda = spec.device.startswith("cuda")
    marks = [("start", time.perf_counter())]
    history = forecast_inputs.history(spec.seed, spec.traffic)
    svc = build_service(spec, cfg, history)
    marks.append(("inputs and service", time.perf_counter()))
    prog = first_round(spec, cfg, svc, history)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("first round", time.perf_counter()))
    setup_s = time.perf_counter() - spec.started
    harness.log(f"[setup] before the driver {marks[0][1] - spec.started:.3f}"
                " s, " + ", ".join(f"{name} {b - a:.3f} s" for (_, a),
                                   (name, b) in zip(marks, marks[1:])))

    seconds = spec.seconds
    prof = None
    if spec.trace:
        seconds = min(seconds, spec.traffic["trace_seconds"])
        state = svc._torch_state
        state["step"] = harness.annotated(state["step"],
                                          "mqbench.train_step")
        state["forward"] = harness.annotated(state["forward"],
                                             "mqbench.forecast_forward")
        prof = harness.start_profiler()
    rounds, failed, ends = 0, 0, []
    before = _counters(svc)
    gc0 = [g["collections"] for g in gc.get_stats()]
    with torch.profiler.record_function(harness.WINDOW_SPAN):
        began = time.time()
        t0 = time.perf_counter()
        while True:
            _, loss, forecast = svc._round(history)
            rounds += 1
            if loss is None or forecast is None or not np.isfinite(loss):
                failed += 1
            ends.append(time.perf_counter())
            window_s = ends[-1] - t0
            if window_s >= seconds:
                break
    each = np.diff([t0] + ends) * 1e3
    collections = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    harness.log(f"[forecast] round ms min {each.min():.3f} median "
                f"{np.median(each):.3f} max {each.max():.3f}; garbage "
                f"collections by generation {collections}")
    harness.log(f"[forecast] window began at {began:.3f} s (Unix); each "
                f"round's ms {[round(float(x), 1) for x in each]}")
    steps = rounds * spec.traffic["steps_per_round"]
    moe_layers = cfg["n_layers"] - cfg["first_dense"]
    routed, max_sum = (a - b for a, b in zip(_counters(svc), before))
    expected = (cfg["top_k"] * spec.traffic["batch"] * cfg["seq_len"]
                * moe_layers * steps)
    readings = {"window_s": window_s, "rounds": rounds, "steps": steps,
                "batch": spec.traffic["batch"], "cfg": cfg, "trace": None,
                "moe": {"routed_rows": routed, "max_rows_sum": max_sum,
                        "layer_steps": moe_layers * steps,
                        "n_experts": cfg["n_experts"]}}
    harness.log(f"[moe] window: {routed} routed rows ({expected} expected), "
                f"largest expert groups summed {max_sum} over "
                f"{moe_layers * steps} layer-steps, the largest "
                f"{svc.moe_max_expert_rows}")
    if prof is not None:
        prof.stop()
        readings["trace"] = harness.trace_summary(prof)
        del prof
        for name, k in sorted(readings["trace"]["kernels"].items(),
                              key=lambda kv: -kv[1]["seconds"]):
            harness.log(f"[kernel] {k['seconds']:.6f} s {k['launches']} "
                        f"launches {name[:120]}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    harness.log(f"[forecast] {rounds} rounds in {window_s:.6f} s, "
                f"setup {setup_s:.6f} s, first losses {prog['losses']}, "
                f"memory peak {peak} B")

    svc._torch_state = None
    del svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = numbers(spec, cfg, history, prog)
    limits = spec.traffic["limits"]
    checks = [(name, got[name], limits[name]) for name in limits]
    return {"setup_s": setup_s,
            "end_to_end": {"round_ms": window_s * 1e3 / rounds},
            "attempted": rounds, "failed": failed, "correct": failed == 0,
            "checks": checks, "memory_peak_bytes": peak,
            "device_kind": kind, "readings": readings}
