"""Entry kind ``forecast_rounds``: the forecast service's training rounds.

Set-up makes the telemetry history and the float32 parameters from the
seed (``forecast_inputs``), builds one ``ForecastService``
(``chanamq_tpu_torch/models/service.py``) with the configuration's model
and the traffic's window, batch and steps a round, gives it the
parameters (``_torch_setup``), and runs its first round through
``_round``, the call its worker thread makes, keeping each of the first
three steps' loss, the momentum after the first step and the parameters
after the third. That first round also warms every shape the window uses.
The window then runs ``_round`` on the same service back to back until
``seconds`` have passed: ``round_ms`` is the window's length over the
rounds completed in it. A traced run traces a window of at most the
traffic's ``trace_seconds``.

After the window, with the peak memory read and the program's state
freed, the plain reference (``mqbench/reference/forecaster.py``) runs the
first round from the same inputs, and ``reference/compare.py``'s numbers
decide ``correct`` against the traffic file's ``limits``.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np

from mqbench import forecast_inputs, harness
from mqbench.reference import compare
from mqbench.reference import forecaster as ref

KEEP_STEPS = 3


def model_cfg(config: dict, traffic: dict) -> dict:
    m = config["model"]
    return {"n_features": m["n_features"], "seq_len": traffic["window"],
            "d_model": m["d_model"], "n_heads": m["n_heads"],
            "d_ff": m["d_ff"], "n_layers": m["n_layers"]}


class Keeper:
    """A train step that keeps what the comparison reads: each of the
    first ``keep`` losses, the momentum after the first step and the
    parameters after step ``keep``, as copies on the device."""

    def __init__(self, step, keep: int = KEEP_STEPS) -> None:
        self.step, self.keep, self.k = step, keep, 0
        self.losses: list = []
        self.grads: Optional[dict] = None
        self.params: Optional[dict] = None

    def __call__(self, params, momentum, batch):
        out = self.step(params, momentum, batch)
        self.k += 1
        if self.k <= self.keep:
            self.losses.append(out[2].detach().clone())
        if self.k == 1:
            self.grads = {n: m.detach().clone() for n, m in momentum.items()}
        if self.k == self.keep:
            self.params = {n: p.detach().clone() for n, p in params.items()}
        return out


def build_service(spec: harness.Spec, cfg: dict, history: np.ndarray):
    """The service with the seed's parameters, before any round."""
    from chanamq_tpu_torch.models.service import ForecastService

    t = spec.traffic
    # the service reads its broker only when it samples ticks; the rounds
    # run on the history given to them
    svc = ForecastService(
        None, seq_len=cfg["seq_len"], history=len(history),
        batch=t["batch"], steps_per_round=t["steps_per_round"],
        lr=spec.config["train"]["lr"],
        model_kwargs={k: cfg[k] for k in
                      ("d_model", "n_heads", "d_ff", "n_layers")},
        device=spec.device)
    params = forecast_inputs.params(spec.seed, ref.param_shapes(cfg),
                                    spec.device)
    svc._torch_state = svc._torch_setup(params)
    return svc


def first_round(svc, history: np.ndarray) -> dict:
    """The service's first round, kept: its losses, first gradient,
    parameters after three steps, and forecast."""
    state = svc._torch_state
    keeper = state["step"] = Keeper(state["step"])
    try:
        _, _, forecast = svc._round(history)
    finally:
        state["step"] = keeper.step
    return {"losses": [float(x) for x in keeper.losses],
            "grads": keeper.grads, "params": keeper.params,
            "forecast": np.array([forecast[n] for n in svc.feature_names])}


def reference_round(spec: harness.Spec, cfg: dict, history: np.ndarray,
                    act: str = "bf16", rows: Optional[int] = None,
                    update: bool = True) -> dict:
    """The reference's first round from the seed's parameters."""
    ref.set_precision()
    params = forecast_inputs.params(spec.seed, ref.param_shapes(cfg),
                                    spec.device)
    return ref.first_round(
        params, history, cfg, batch=spec.traffic["batch"],
        steps=spec.traffic["steps_per_round"],
        lr=spec.config["train"]["lr"], keep_steps=KEEP_STEPS, act=act,
        rows=rows, update=update, device=spec.device)


def numbers(spec: harness.Spec, cfg: dict, history: np.ndarray,
            prog: dict) -> dict:
    """The comparison's numbers of ``prog`` against the reference."""
    want = reference_round(spec, cfg, history)
    start = forecast_inputs.params(spec.seed, ref.param_shapes(cfg),
                                   spec.device)
    return compare.training_numbers(prog, want, start)


def calibration(spec: harness.Spec, kind: str) -> dict:
    """One seed's numbers for setting the limits: ``program`` (the
    service's first round, as a run compares it), ``control`` (the
    reference in the program's place, its activations at float8),
    ``half_batch`` (the reference training on half of each batch, the
    mean over the rest) or ``unchanged`` (the reference's steps leaving
    the parameters and momentum as they were)."""
    import torch

    cfg = model_cfg(spec.config, spec.traffic)
    history = forecast_inputs.history(spec.seed, spec.traffic)
    if kind == "program":
        svc = build_service(spec, cfg, history)
        prog = first_round(svc, history)
        svc._torch_state = None
        del svc
    elif kind == "control":
        prog = reference_round(spec, cfg, history, act="fp8")
    elif kind == "half_batch":
        prog = reference_round(spec, cfg, history,
                               rows=spec.traffic["batch"] // 2)
    elif kind == "unchanged":
        prog = reference_round(spec, cfg, history, update=False)
    else:
        raise ValueError(f"unknown calibration {kind!r}")
    if spec.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return numbers(spec, cfg, history, prog)


def run(spec: harness.Spec) -> dict:
    import torch

    cfg = model_cfg(spec.config, spec.traffic)
    cuda = spec.device.startswith("cuda")
    marks = [("start", time.perf_counter())]
    history = forecast_inputs.history(spec.seed, spec.traffic)
    svc = build_service(spec, cfg, history)
    marks.append(("inputs and service", time.perf_counter()))
    prog = first_round(svc, history)
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
    readings = {"window_s": window_s, "rounds": rounds,
                "steps": rounds * spec.traffic["steps_per_round"],
                "batch": spec.traffic["batch"], "cfg": cfg, "trace": None}
    if prof is not None:
        prof.stop()
        readings["trace"] = harness.trace_summary(prof)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    harness.log(f"[forecast] {rounds} rounds in {window_s:.6f} s, "
                f"setup {setup_s:.6f} s, first losses {prog['losses']}")

    svc._torch_state = None
    del svc
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
