"""The port's forecast service (``chanamq_tpu_torch.models.service`` and
``.telemetry``) against the JAX package's, on the CPU, and a rehearsal of
``chip_smoke.py``'s forecaster phases at a tiny size.

- the telemetry copies (ring, sampler, training batch, normalization,
  top-K slots) give the reference's outputs on the same inputs;
- slice parity: one history array goes through both services' ``_round``
  over three rounds with training on, the port's model carrying the JAX
  service's own ``init_params(PRNGKey(0))`` across through numpy. In
  bf16 the forecasts agree within the forward limit, 0.1 in normalized
  units (see tests/test_torch_forecaster.py), plus what the trained
  parameters' differences add (0.05: the train steps' bf16 gradients
  differ by under 1%, see tests/test_torch_forecaster_train.py, and lr
  1e-3 keeps what they move small), which de-normalization scales by each
  feature's std; the losses within 2% of the reference's. In float32 the
  forecasts agree within 1e-4 and the losses within 1e-5 of themselves;
- the forecast after a trained round reads the trained weights;
- the reference's observed-traffic test on the port's BrokerServer,
  client and admin API with ``device="cpu"``, training with the
  reference's ``steps_per_round=5``, and its disabled-forecaster case;
- the defaults are the reference's (20 steps a round, lr 1e-3);
- with a profile runtime installed, a round records its ``forecast``
  stages once each and the ``train-*`` stages once a step, spans nested
  in their parents under one round id, each with a profiler range of its
  name in a torch profiler's trace; with none installed it
  records nothing and returns the same numbers bit for bit; the
  service's ``kernel_launches`` gains the forecaster wrappers' launches.
"""

import asyncio
import json
import types

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from chanamq_tpu.models import forecaster as ref_fc
from chanamq_tpu.models import telemetry as ref_tm
from chanamq_tpu.models.service import ForecastService as RefService
from chanamq_tpu_torch import profile
from chanamq_tpu_torch.broker.broker import Broker as PortBroker
from chanamq_tpu_torch.broker.server import BrokerServer as PortServer
from chanamq_tpu_torch.client import AMQPClient as PortClient
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.models import forecaster as port_fc
from chanamq_tpu_torch.models import telemetry as port_tm
from chanamq_tpu_torch.models.service import ForecastService as PortService
from chanamq_tpu_torch.rest.admin import AdminServer as PortAdmin

FORWARD_LIMIT = 0.1  # bf16 forward, normalized units
TINY_MODEL = {"d_model": 32, "n_heads": 4, "d_ff": 64, "n_layers": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside other test files on every core, and their
    training rounds are small: one torch thread keeps them from crowding
    out their neighbours' timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _history(n: int, seed: int) -> np.ndarray:
    """Telemetry-like history: non-negative rates and gauges with bursts,
    and one constant column (the std floor)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    base = np.array([2000, 1900, 50, 10, 4, 1e6, 9e5, 1990], np.float64)
    wave = 1 + 0.5 * np.sin(t * np.array([0.05, 0.07, 0.11, 0.13, 0, 0.05,
                                          0.07, 0.05]))
    h = base * wave * (1 + 0.1 * rng.normal(size=(n, 8)))
    h[:, 4] = 4.0
    return np.maximum(h, 0).astype(np.float32)


# -- telemetry copies ----------------------------------------------------------


def test_features_are_the_reference_features():
    assert port_tm.FEATURES == ref_tm.FEATURES
    assert port_tm.N_FEATURES == ref_tm.N_FEATURES


def test_ring_matches_reference():
    rings = (ref_tm.TelemetryRing(capacity=10),
             port_tm.TelemetryRing(capacity=10))
    assert all(r.window(4) is None and r.latest() is None for r in rings)
    rng = np.random.default_rng(0)
    for i in range(25):
        vec = rng.normal(size=ref_tm.N_FEATURES).astype(np.float32)
        for r in rings:
            r.push(vec)
        a, b = rings
        assert (len(a), a.count) == (len(b), b.count)
        np.testing.assert_array_equal(a.history(), b.history())
        np.testing.assert_array_equal(a.latest(), b.latest())
        if i >= 3:
            np.testing.assert_array_equal(a.window(4), b.window(4))
    assert len(rings[1]) == 10 and rings[1].count == 25


def test_sample_matches_reference():
    metrics = types.SimpleNamespace(
        published_msgs=100, delivered_msgs=90, published_bytes=51200,
        delivered_bytes=46080, confirmed_msgs=99)
    broker = types.SimpleNamespace(metrics=metrics, queue_depth=7,
                                   queue_unacked=3, queue_consumers=2)
    prev_r, prev_p = ref_tm.counter_state(broker), port_tm.counter_state(
        broker)
    assert prev_r == prev_p
    metrics.published_msgs, metrics.published_bytes = 300, 153600
    metrics.delivered_msgs, metrics.confirmed_msgs = 250, 290
    for dt in (0.5, 0.0):  # 0 takes the 1e-6 floor
        want, snap_r = ref_tm.sample(broker, prev_r, dt)
        got, snap_p = port_tm.sample(broker, prev_p, dt)
        np.testing.assert_array_equal(got, want)
        assert snap_p == snap_r


def test_training_batch_and_normalization_match_reference():
    history = _history(300, 1)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for seq_len, batch in ((16, 8), (64, 16), (299, 3)):
        want = ref_tm.training_batch(history, seq_len, batch, a)
        got = port_tm.training_batch(history, seq_len, batch, b)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    assert ref_tm.training_batch(history[:16], 16, 4, a) is None
    assert port_tm.training_batch(history[:16], 16, 4, b) is None
    assert a.bit_generator.state == b.bit_generator.state
    for w, g in zip(ref_tm.normalization(history),
                    port_tm.normalization(history)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_topk_slots_match_reference():
    ref_slots, port_slots = ref_tm.TopKSlots(3), port_tm.TopKSlots(3)
    rng = np.random.default_rng(3)
    queues = [("/", f"q{i}") for i in range(6)]
    for tick in range(40):
        live = [q for q in queues if rng.random() < 0.8]
        latest = rng.uniform(0, 100, size=(len(live), 6)).astype(np.float32)
        if tick % 7 == 0:
            live, latest = [], np.zeros((0, 6), np.float32)
        want = ref_slots.update(list(live), latest)
        got = port_slots.update(list(live), latest)
        np.testing.assert_array_equal(got, want)
        assert port_slots.slot_queues() == ref_slots.slot_queues()
    assert port_tm.TopKSlots(0).update([], np.zeros((0, 6))).shape == (0,)


# -- slice parity: one history through both services --------------------------


TRAINED_LIMIT = {"bfloat16": FORWARD_LIMIT + 0.05, "float32": 1e-4}
LOSS_RTOL = {"bfloat16": 0.02, "float32": 1e-5}


@pytest.mark.parametrize("model_kwargs,dtype", [
    (None, "bfloat16"), (TINY_MODEL, "bfloat16"), (TINY_MODEL, "float32")],
    ids=["compact-default", "tiny", "tiny-float32"])
def test_round_matches_reference_service(model_kwargs, dtype):
    """Both services' ``_round`` on the same histories, three rounds of 5
    train steps each: the same steps, losses and forecasts within the
    limits the module docstring states, the same draws from the numpy
    generator, and the reference's clamp at 0."""
    import jax.numpy as jnp

    kw = dict(interval_s=1.0, seq_len=16, history=512, batch=8,
              steps_per_round=5)
    model = dict(model_kwargs or {})
    ref_svc = RefService(types.SimpleNamespace(), **kw, model_kwargs=dict(
        model, dtype=getattr(jnp, dtype)))
    port_svc = PortService(types.SimpleNamespace(), device="cpu", **kw,
                           model_kwargs=dict(model,
                                             dtype=getattr(torch, dtype)))
    jcfg = ref_fc.ForecasterConfig(
        n_features=ref_svc.n_features, seq_len=16, **ref_svc.model_kwargs)
    params = ref_fc.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = port_fc.ForecasterConfig(
        n_features=port_svc.n_features, seq_len=16,
        **port_svc.model_kwargs)
    port_svc._torch_state = port_svc._torch_setup(port_fc.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, tcfg, "cpu"))
    assert port_svc._torch_state["cfg"] == tcfg
    for n, seed in ((200, 0), (512, 1), (17, 2)):
        history = _history(n, seed)
        ref_steps, ref_loss, want = ref_svc._round(history)
        steps, loss, got = port_svc._round(history)
        assert steps == ref_steps == (5 if n > 16 else 0)
        if steps:
            assert abs(loss - ref_loss) <= LOSS_RTOL[dtype] * ref_loss
        else:
            assert loss is ref_loss is None
        assert list(got) == list(want) == list(port_tm.FEATURES)
        _, std = port_tm.normalization(history)
        for i, name in enumerate(port_tm.FEATURES):
            assert got[name] >= 0.0 and np.isfinite(got[name])
            assert abs(got[name] - want[name]) <= \
                TRAINED_LIMIT[dtype] * std[i], \
                (name, got[name], want[name], std[i])
        assert (port_svc._np_rng.bit_generator.state
                == ref_svc._np_rng.bit_generator.state)


def test_forecast_reads_the_trained_weights():
    """After a round that trained, the forecast runs the updated
    parameters cast afresh, not the weights cast before training: the
    service's forward equals a forward on freshly cast trained
    parameters and differs from one on the untrained weights."""
    svc = PortService(types.SimpleNamespace(), seq_len=8, history=64,
                      batch=4, steps_per_round=3, model_kwargs=TINY_MODEL,
                      device="cpu")
    svc._torch_state = state = svc._torch_setup()
    cfg = state["cfg"]
    untrained = {k: v.clone() for k, v in state["params"].items()}
    stale = state["weights"]
    history = _history(40, 3)
    steps, loss, _ = svc._round(history)
    assert steps == 3 and np.isfinite(loss)
    assert not torch.equal(state["params"]["layer0/mlp/w1"],
                           untrained["layer0/mlp/w1"])
    fresh = port_fc.cast_weights(state["params"], cfg)
    assert all(torch.equal(state["weights"][k], fresh[k]) for k in fresh)
    mean, std = port_tm.normalization(history)
    window = ((history - mean) / std)[-8:][None].astype(np.float32)
    x = torch.from_numpy(window)
    got = state["forward"](window)
    assert np.array_equal(got, port_fc.forward(state["params"], x, cfg,
                                               weights=fresh).numpy())
    assert not np.array_equal(got, port_fc.forward(
        state["params"], x, cfg, weights=stale).numpy())


def test_round_refuses_nonfinite_loss():
    """A loss that is not finite raises and drops the state, as the
    reference's divergence check does; the next round starts clean."""
    svc = PortService(types.SimpleNamespace(), seq_len=8, history=64,
                      batch=4, steps_per_round=2, model_kwargs=TINY_MODEL,
                      device="cpu")
    state = svc._torch_setup()
    state["params"]["embed/kernel"][0, 0] = float("inf")
    svc._torch_state = state
    with pytest.raises(RuntimeError, match="diverged"):
        svc._round(_history(40, 0))
    assert svc._torch_state is None
    steps, loss, forecast = svc._round(_history(40, 0))
    assert steps == 2 and np.isfinite(loss)
    assert all(np.isfinite(v) for v in forecast.values())


def test_round_refuses_nonfinite_forecast():
    """A poisoned model raises and drops its state, as the reference's
    divergence check does."""
    svc = PortService(types.SimpleNamespace(), seq_len=8, history=64,
                      steps_per_round=0, model_kwargs=TINY_MODEL,
                      device="cpu")
    state = svc._torch_setup()
    state["params"]["out/bias"][0] = float("nan")
    svc._torch_state = state
    with pytest.raises(RuntimeError, match="diverged"):
        svc._round(_history(40, 0))
    assert svc._torch_state is None
    _, _, forecast = svc._round(_history(40, 0))  # a fresh model serves
    assert all(np.isfinite(v) for v in forecast.values())


def test_defaults_match_reference():
    """The port's service trains by default as the reference's does: 20
    steps a round at lr 1e-3 (and the same batch, window and intervals);
    only ``device`` is the port's own."""
    import inspect

    broker = types.SimpleNamespace()
    port_svc, ref_svc = PortService(broker), RefService(broker)
    assert (port_svc.steps_per_round, port_svc.lr) == (20, 1e-3)
    assert (port_svc.steps_per_round, port_svc.lr) == (ref_svc.steps_per_round,
                                                       ref_svc.lr)
    ref_params = inspect.signature(RefService).parameters
    port_params = inspect.signature(PortService).parameters
    assert set(port_params) - set(ref_params) == {"device"}
    for name, p in ref_params.items():
        assert port_params[name].default == p.default, name


def test_default_device_is_the_card():
    """``device`` defaults to cuda; without a card the first round raises
    rather than forecasting on the CPU."""
    svc = PortService(types.SimpleNamespace(), seq_len=8, history=64,
                      steps_per_round=0, model_kwargs=TINY_MODEL)
    assert svc.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            svc._round(_history(40, 0))
        assert svc._torch_state is None


# -- the round's spans (profile/) and launch count ---------------------------

ROUND_STAGES = ("forecast-round", "forecast-batch", "forecast-wait",
                "forecast-predict")
STEP_STAGES = ("train-step", "train-forward", "train-backward",
               "train-update")


def _tiny_service(steps: int = 3) -> PortService:
    svc = PortService(types.SimpleNamespace(), seq_len=8, history=64,
                      batch=4, steps_per_round=steps,
                      model_kwargs=TINY_MODEL, device="cpu")
    svc._torch_state = svc._torch_setup()
    return svc


@pytest.fixture
def runtime():
    rt = profile.install(profile.ProfileRuntime(gc_hook=False))
    yield rt
    profile.clear()


def test_round_records_its_stages_and_spans(runtime):
    """One round with a runtime installed: each round stage once, each
    step stage once a step, in the ledger and in one ring entry whose
    spans share its id and lie inside their parents."""
    svc = _tiny_service(steps=3)
    svc._round(_history(40, 0))
    calls = {name: int(runtime.stage_calls[profile.STAGES.index(name)])
             for name in ROUND_STAGES + STEP_STAGES}
    assert calls == {**dict.fromkeys(ROUND_STAGES, 1),
                     **dict.fromkeys(STEP_STAGES, 3)}
    snap = runtime.snapshot()
    assert snap["subsystems"]["forecast"] == {
        "ns": snap["stages"]["forecast-round"]["ns"], "calls": 1}
    (entry,) = snap["forecast"]["rounds"]
    spans = entry["spans"]
    assert [s["stage"] for s in spans] == (
        ["forecast-round", "forecast-batch"] + list(STEP_STAGES) * 3
        + ["forecast-wait", "forecast-predict"])
    for s in spans:
        ns = snap["stages"][s["stage"]]["ns"]
        assert 0 < s["end_ns"] - s["start_ns"] <= ns
    (whole,) = [s for s in spans if s["parent"] is None]
    assert whole["stage"] == "forecast-round" and whole["step"] is None
    for s in spans:
        if s["parent"] is None:
            continue
        (parent,) = [p for p in spans if p["stage"] == s["parent"]
                     and p["step"] == (s["step"] if s["parent"]
                                       == "train-step" else None)]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"], (s, parent)
    assert [s["step"] for s in spans if s["stage"] in STEP_STAGES] == \
        [i for i in range(3) for _ in STEP_STAGES]
    # the next round's spans come under a new id
    svc._round(_history(40, 1))
    ids = [e["round"] for e in runtime.snapshot()["forecast"]["rounds"]]
    assert len(ids) == len(set(ids)) == 2


def test_round_ring_keeps_the_last_rounds():
    rt = profile.install(profile.ProfileRuntime(gc_hook=False, ring_size=2))
    try:
        svc = _tiny_service(steps=1)
        for seed in range(3):
            svc._round(_history(40, seed))
    finally:
        profile.clear()
    rounds = rt.snapshot()["forecast"]["rounds"]
    assert [e["round"] for e in rounds] == [2, 3]
    assert int(rt.stage_calls[profile.FORECAST_ROUND]) == 3


def test_round_without_profile_records_nothing_and_matches():
    """With the runtime cleared a round records nothing (ledger, ring,
    profiler ranges) and gives bit for bit what the traced round gives
    from the same state."""
    rt = profile.install(profile.ProfileRuntime(gc_hook=False))
    traced = _tiny_service()
    want = traced._round(_history(40, 0))
    profile.clear()
    before = (rt.stage_ns.copy(), rt.stage_calls.copy())
    plain = _tiny_service()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = plain._round(_history(40, 0))
    assert profile.ACTIVE is None
    assert (rt.stage_ns == before[0]).all()
    assert (rt.stage_calls == before[1]).all()
    assert len(rt.snapshot()["forecast"]["rounds"]) == 1
    assert not [e for e in prof.events() if e.name in profile.STAGES]
    assert got[0] == want[0] == 3
    assert np.float32(got[1]).tobytes() == np.float32(want[1]).tobytes()
    assert list(got[2]) == list(want[2])
    assert all(np.float64(got[2][k]).tobytes()
               == np.float64(want[2][k]).tobytes() for k in want[2])
    for name, p in traced._torch_state["params"].items():
        assert torch.equal(plain._torch_state["params"][name], p), name


def test_round_spans_match_the_profiler_ranges(runtime):
    """Under ``torch.profiler`` each ring span has a host event of its
    stage's name (the span's profiler range), in the same order and
    nesting, lasting as long within 5% or 50 µs."""
    svc = _tiny_service(steps=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        svc._round(_history(40, 0))  # warms the profiler's first ranges
        svc._round(_history(40, 1))
    first, entry = runtime.snapshot()["forecast"]["rounds"]
    spans = entry["spans"]
    events = sorted((e for e in prof.events() if e.name in profile.STAGES),
                    key=lambda e: e.time_range.start)[len(first["spans"]):]
    assert [e.name for e in events] == [s["stage"] for s in spans]
    for e, s in zip(events, spans):
        parent = e.cpu_parent
        while parent is not None and parent.name not in profile.STAGES:
            parent = parent.cpu_parent
        assert (parent.name if parent is not None else None) == s["parent"]
        ring_us = (s["end_ns"] - s["start_ns"]) / 1e3
        traced_us = e.time_range.end - e.time_range.start
        assert abs(traced_us - ring_us) <= max(0.05 * ring_us, 50.0), \
            (s["stage"], traced_us, ring_us)


def test_round_counts_the_wrappers_launches(monkeypatch):
    """``kernel_launches`` gains the change in the forecaster wrappers'
    ``launches`` over each round (on the CPU the plain versions launch
    nothing, so the step here counts as the card's wrappers would)."""
    svc = _tiny_service(steps=2)
    wrappers = (fk.layernorm, fk.causal_attention, fk.layernorm_bwd,
                fk.causal_attention_bwd, fk.gelu_tanh_bwd,
                fk.products.bf16_product, fk.products.f32_product,
                fk.update.clip_momentum_sgd)
    step = svc._torch_state["step"]

    def counted_step(*args):
        for i, w in enumerate(wrappers):
            monkeypatch.setattr(w, "launches", w.launches + i + 1)
        return step(*args)

    svc._torch_state["step"] = counted_step
    assert svc.snapshot()["kernel_launches"] == 0
    before = fk.launch_count()
    svc._round(_history(40, 0))
    per_step = sum(range(1, len(wrappers) + 1))
    assert fk.launch_count() - before == 2 * per_step
    assert svc.snapshot()["kernel_launches"] == 2 * per_step
    svc._round(_history(40, 1))
    assert svc.snapshot()["kernel_launches"] == 4 * per_step



def test_round_counts_the_warpgroup_launches(monkeypatch):
    """``warpgroup_launches`` gains the change in the attention wrapper's
    ``warpgroup_launches`` over each round (the forwards the long-window
    kernel ran), beside ``kernel_launches``."""
    svc = _tiny_service(steps=2)
    step = svc._torch_state["step"]

    def counted_step(*args):
        monkeypatch.setattr(fk.causal_attention, "warpgroup_launches",
                            fk.causal_attention.warpgroup_launches + 3)
        return step(*args)

    svc._torch_state["step"] = counted_step
    assert svc.snapshot()["warpgroup_launches"] == 0
    svc._round(_history(40, 0))
    assert svc.snapshot()["warpgroup_launches"] == 6
    svc._round(_history(40, 1))
    assert svc.snapshot()["warpgroup_launches"] == 12


def test_stand_ins_carry_the_attention_counters():
    """``chip_smoke.standing_in`` hands a stood-in wrapper's counters to
    its stand-in and back: the attention wrappers count their launches and
    their long-window calls on their module's name, which the stand-in
    holds meanwhile (the backward's on every call, either pair)."""
    bwd = fk.causal_attention_bwd
    before = (bwd.launches, bwd.warpgroup_launches)
    with chip_smoke.standing_in({"causal_attention_bwd": fk},
                                lambda name, fn: (lambda *a: fn(*a))):
        stand_in = fk.causal_attention_bwd
        assert stand_in is not bwd
        assert (stand_in.launches, stand_in.warpgroup_launches) == before
        stand_in.launches += 2
        stand_in.warpgroup_launches += 1
    assert fk.causal_attention_bwd is bwd
    assert (bwd.launches, bwd.warpgroup_launches) == (before[0] + 2,
                                                      before[1] + 1)
    bwd.launches, bwd.warpgroup_launches = before


def test_round_counts_the_backward_warpgroup_launches(monkeypatch):
    """``bwd_warpgroup_launches`` gains the change in the attention
    backward wrapper's ``warpgroup_launches`` over each round (the calls
    the long-window pair ran), apart from the forwards'."""
    svc = _tiny_service(steps=2)
    step = svc._torch_state["step"]

    def counted_step(*args):
        monkeypatch.setattr(fk.causal_attention_bwd, "warpgroup_launches",
                            fk.causal_attention_bwd.warpgroup_launches + 2)
        return step(*args)

    svc._torch_state["step"] = counted_step
    assert svc.snapshot()["bwd_warpgroup_launches"] == 0
    svc._round(_history(40, 0))
    assert svc.snapshot()["bwd_warpgroup_launches"] == 4
    assert svc.snapshot()["warpgroup_launches"] == 0
    svc._round(_history(40, 1))
    assert svc.snapshot()["bwd_warpgroup_launches"] == 8

# -- end to end: the port's broker under load -> forecast ---------------------


async def _http_get(port: int, path: str) -> tuple[str, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), 10)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return head.decode("latin-1").split("\r\n")[0], body


async def test_forecast_from_observed_traffic():
    """The reference's test_forecast_from_observed_traffic on the port's
    server, client and admin API, training with its
    ``steps_per_round=5``: the sampler sees the real traffic, the model
    trains to a finite loss, and ``GET /admin/forecast`` and ``/metrics``
    serve a finite, non-negative next-tick forecast."""
    server = PortServer(PortBroker(router_device="cpu"), host="127.0.0.1",
                        port=0, heartbeat_s=0)
    await server.start()
    admin = PortAdmin(server.broker, port=0)
    await admin.start()
    forecaster = PortService(
        server.broker, interval_s=0.02, train_interval_s=0.2, seq_len=8,
        history=4096, batch=8, steps_per_round=5, model_kwargs=TINY_MODEL,
        device="cpu")
    await forecaster.start()
    assert server.broker.forecaster is forecaster
    client = await PortClient.connect("127.0.0.1", server.bound_port)
    try:
        ch = await client.channel()
        await ch.queue_declare("fcst_q")
        received = []
        await ch.basic_consume("fcst_q", received.append, no_ack=True)

        async def load() -> None:
            for _ in range(60):
                for _ in range(20):
                    ch.basic_publish(
                        b"x" * 512, exchange="", routing_key="fcst_q")
                await asyncio.sleep(0.01)

        load_task = asyncio.create_task(load())
        deadline = asyncio.get_event_loop().time() + 60
        while forecaster.forecast is None:
            assert asyncio.get_event_loop().time() < deadline, \
                forecaster.last_error
            await asyncio.sleep(0.05)
        await load_task

        snap = forecaster.snapshot()
        assert snap["error"] is None
        assert snap["trained_steps"] >= 5 and snap["trained_steps"] % 5 == 0
        assert np.isfinite(snap["loss"])
        history = forecaster.ring.history()
        assert history[:, port_tm.FEATURES.index("publish_rate")].max() > 0
        assert history[:, port_tm.FEATURES.index("deliver_rate")].max() > 0
        assert snap["samples"] >= 9
        forecast = snap["forecast"]
        assert set(forecast) == set(port_tm.FEATURES)
        for name, value in forecast.items():
            assert np.isfinite(value), (name, value)
            assert value >= 0.0

        status, body = await _http_get(admin.bound_port, "/admin/forecast")
        assert status.endswith("200 OK")
        payload = json.loads(body)
        assert payload["enabled"] is True
        forecast = payload["forecast"]
        assert set(forecast) == set(port_tm.FEATURES)
        for name, value in forecast.items():
            assert np.isfinite(value), (name, value)
            assert value >= 0.0
        assert payload["loss"] is not None and np.isfinite(payload["loss"])

        status, body = await _http_get(admin.bound_port, "/metrics")
        assert status.endswith("200 OK")
        text = body.decode()
        assert 'chanamq_forecast{feature="publish_rate"}' in text
        assert "chanamq_forecast_loss" in text
        assert len(received) > 0
    finally:
        await client.close()
        await forecaster.stop()
        await admin.stop()
        await server.stop()
    assert server.broker.forecaster is None


async def test_admin_forecast_disabled_reports_enabled_false():
    server = PortServer(PortBroker(router_device="cpu"), host="127.0.0.1",
                        port=0, heartbeat_s=0)
    await server.start()
    admin = PortAdmin(server.broker, port=0)
    await admin.start()
    try:
        status, body = await _http_get(admin.bound_port, "/admin/forecast")
        assert status.endswith("200 OK")
        assert json.loads(body) == {"enabled": False}
    finally:
        await admin.stop()
        await server.stop()


# -- chip_smoke rehearsals -----------------------------------------------------


def test_chip_smoke_forecaster_kernel_phase_rehearsal():
    """chip_smoke's forecaster kernel phase on the CPU at a tiny width:
    every kernel's plain path within its limit, with its bound."""
    cfg = port_fc.ForecasterConfig(seq_len=8, **TINY_MODEL)
    res = chip_smoke.phase_forecaster_kernels(torch.device("cpu"), 0, cfg,
                                              batches=(1, 3))
    assert set(res) == set(chip_smoke.FORECASTER_KERNELS)
    for rows in res.values():
        assert set(rows) == {1, 3}
        for row in rows.values():
            assert row["max_abs_err"] <= row["limit"]
            assert row["bound_ms"] > 0
            assert row["bound_by"] in ("bytes", "operations")
            assert "ms" not in row  # times come from a card only


def test_chip_smoke_layernorm_extra_batches_rehearsal():
    """The forecaster kernel phase with layernorm also at the training
    batch: layernorm rows at every batch, the other kernels' at the
    forward's batches only, whose inputs the extra batch does not move."""
    cfg = port_fc.ForecasterConfig(seq_len=8, **TINY_MODEL)
    cpu = torch.device("cpu")
    res = chip_smoke.phase_forecaster_kernels(cpu, 0, cfg, batches=(1, 3),
                                              layernorm_batches=(1, 2, 3))
    plain = chip_smoke.phase_forecaster_kernels(cpu, 0, cfg, batches=(1, 3))
    assert set(res["layernorm"]) == {1, 2, 3}
    assert set(res["causal_attention"]) == set(res["gelu_tanh"]) == {1, 3}
    for name, rows in plain.items():
        for b, row in rows.items():
            assert res[name][b] == row
    assert chip_smoke.LAYERNORM_BATCHES == (1, 16, 32)


def test_chip_smoke_forecaster_work_counts_by_hand():
    """The bytes and operations behind the forecaster bounds, by hand."""
    bf = torch.bfloat16
    x = torch.zeros(2, 4, 16, dtype=bf)
    nbytes, ops, _ = chip_smoke.forecaster_work(
        "layernorm", (x, torch.ones(16)))
    assert (nbytes, ops) == (2 * 128 * 2 + 16 * 4, 7 * 128)
    nbytes, ops, _ = chip_smoke.forecaster_work("gelu_tanh", (x,))
    assert (nbytes, ops) == (2 * 128 * 2, 9 * 128)
    # B=1, T=4, 2 heads of 8: 10 causal pairs a head, 2 products of 2*8
    qkv = torch.zeros(1, 4, 48, dtype=bf)
    nbytes, ops, seconds = chip_smoke.forecaster_work(
        "causal_attention", (qkv, 2))
    pairs = 2 * 10
    assert nbytes == (4 * 48 + 4 * 16) * 2
    assert ops == pairs * (2 * 2 * 8 + 5)
    assert seconds == pytest.approx(
        pairs * 32 / chip_smoke.BF16_TC_FLOPS_PER_S
        + pairs * 5 / chip_smoke.F32_FLOPS_PER_S)
    assert chip_smoke.bf16_ulp(3.0) == 2.0 ** -6
    assert chip_smoke.bf16_ulp(1.0) == 2.0 ** -7


def test_chip_smoke_forward_phase_rehearsal():
    cfg = port_fc.ForecasterConfig(seq_len=8, **TINY_MODEL)
    res = chip_smoke.phase_forward(torch.device("cpu"), 0, cfg,
                                   batches=(1, 2))
    for row in res.values():
        assert row["max_abs_err"] <= row["limit"] == chip_smoke.FORWARD_LIMIT
        assert "host_ms" not in row


def test_chip_smoke_forecast_phase_rehearsal():
    """chip_smoke's forecast path on the CPU at a tiny width: forecasts
    from observed traffic, every forward replayed through the plain
    path, and one call of each op a layer per forward (the CPU counts no
    launch; the card run checks launches = forwards x (2, 1, 1) a
    layer)."""
    before = fk.layernorm.launches
    res = chip_smoke.phase_forecast(
        torch.device("cpu"), model_kwargs=TINY_MODEL, seq_len=8,
        min_rounds=2)
    assert res["rounds"] >= 2 and res["forwards"] >= res["rounds"]
    assert res["replay_max_abs_err"] <= chip_smoke.FORWARD_LIMIT
    assert res["max_publish_rate"] > 0 and res["published"] > 0
    assert res["cfg"].d_model == 32 and res["cfg"].seq_len == 8
    assert all(v >= 0 for v in res["forecast"].values())
    stats = res["ms_per_forward"]
    assert stats["n"] == res["forwards"] - 1  # the first is apart
    assert 0 < stats["median"] <= stats["p90"] <= stats["p99"] <= stats["max"]
    assert res["ms_first_forward"] > 0
    assert fk.layernorm.launches == before


def test_chip_smoke_train_kernel_phase_rehearsal():
    """chip_smoke's training kernel phase on the CPU at a tiny width: each
    backward's plain path within its limit, the update exact at the
    scale it computed with the clip active, and a bound for each."""
    cfg = port_fc.ForecasterConfig(seq_len=8, **TINY_MODEL)
    res = chip_smoke.phase_train_kernels(torch.device("cpu"), 0, cfg,
                                         batches=(1, 3))
    assert set(res) == set(chip_smoke.TRAIN_KERNELS)
    for name, rows in res.items():
        assert set(rows) == {1, 3}
        for row in rows.values():
            assert row["max_abs_err"] <= row["limit"]
            assert row["bound_ms"] > 0 and "ms" not in row
    update = res["clip_momentum_sgd"][1]
    assert update["max_abs_err"] == 0.0 and 0 < update["scale"] < 1
    assert res["layernorm_bwd"][3]["dscale_err"] <= \
        res["layernorm_bwd"][3]["dscale_limit"]


def test_chip_smoke_long_window_phase_rehearsal():
    """chip_smoke's long-window attention phase on the CPU at a tiny size:
    windows of more than one ring slot, both kernels' plain paths within
    their limits and the same bits twice, with a bound for each."""
    res = chip_smoke.phase_long_windows(torch.device("cpu"), 0,
                                        windows=(70, 131), widths=(2, 16),
                                        bwd_batch=2)
    assert set(res) == {(70, 2), (70, 16), (131, 2), (131, 16)}
    for rows in res.values():
        assert set(rows) == {"causal_attention", "causal_attention_bwd"}
        for row in rows.values():
            assert row["max_abs_err"] <= row["limit"]
            assert row["bound_ms"] > 0 and "ms" not in row


def test_chip_smoke_init_phase_rehearsal():
    res = chip_smoke.phase_init(torch.device("cpu"))
    assert res["tensors"] == 29
    assert res["values"] == sum(
        int(np.prod(s)) for s in port_fc.param_shapes(
            port_fc.ForecasterConfig()).values())


def test_chip_smoke_train_work_counts_by_hand():
    """The bytes and operations behind the training kernels' bounds."""
    bf = torch.bfloat16
    x = torch.zeros(2, 4, 16, dtype=bf)
    nbytes, ops, _ = chip_smoke.train_work(
        "layernorm_bwd", (x, x, torch.ones(16)))
    assert (nbytes, ops) == (3 * 128 * 2 + 2 * 16 * 4, 17 * 128)
    nbytes, ops, _ = chip_smoke.train_work("gelu_tanh_bwd", (x, x))
    assert (nbytes, ops) == (3 * 128 * 2, 16 * 128)
    qkv = torch.zeros(1, 4, 48, dtype=bf)
    nbytes, ops, _ = chip_smoke.train_work(
        "causal_attention_bwd", (qkv, torch.zeros(1, 4, 16, dtype=bf), 2))
    assert nbytes == (2 * 4 * 48 + 4 * 16) * 2
    assert ops == 2 * 10 * (5 * 2 * 8 + 8)
    params = [torch.zeros(3, 5), torch.zeros(7)]
    nbytes, ops, _ = chip_smoke.train_work(
        "clip_momentum_sgd", (params, params, params, 1e-3, 1.0))
    assert (nbytes, ops) == (5 * 4 * 22, 7 * 22)


def test_chip_smoke_train_phase_rehearsal():
    """chip_smoke's train phase on the CPU at a tiny width: the step
    through the kernels' plain versions against the step through plain
    autograd, every tree within its limit, and the loss falls."""
    cfg = port_fc.ForecasterConfig(seq_len=8, **TINY_MODEL)
    res = chip_smoke.phase_train(torch.device("cpu"), 0, cfg, batch=4,
                                 steps=5)
    assert len(res["losses"]) == 5 and res["losses"][-1] < res["losses"][0]
    assert set(res["trees"]) == {1, 5}
    for trees in res["trees"].values():
        assert set(trees) == set(port_fc.param_shapes(cfg))
        for tree in trees.values():
            for err, limit in tree.values():
                assert err <= limit
    assert "host_ms" not in res
    per_step = chip_smoke.train_per_step(cfg)
    # attention's backward is two launches a call: its row pass and its
    # main kernel; GELU's forward rides in w1's epilogue; the bf16
    # products are the forward's 1 + 4 a layer, then a dX and a dW each
    # but the embed's dX (its input is the data); the head, its dX and dW
    assert per_step == {"layernorm": 4, "causal_attention": 2,
                        "gelu_tanh": 0, "layernorm_bwd": 4,
                        "causal_attention_bwd": 4, "gelu_tanh_bwd": 2,
                        "bf16_product": 9 + 17, "f32_product": 3,
                        "clip_momentum_sgd": 2}


def test_chip_smoke_forecast_train_phase_rehearsal():
    """chip_smoke's training forecast path on the CPU at a tiny width:
    rounds of train steps beside the loaded broker, finite losses, every
    forward replayed on the parameters it forwarded, and the round and
    step times with the first apart."""
    res = chip_smoke.phase_forecast(
        torch.device("cpu"), model_kwargs=TINY_MODEL, seq_len=8,
        min_rounds=3, steps_per_round=4, batch=4)
    assert res["rounds"] >= 3 and res["steps"] >= 4 * res["rounds"]
    assert np.isfinite(res["loss"])
    assert res["replay_max_abs_err"] <= chip_smoke.FORWARD_LIMIT
    for kind in ("ms_per_round", "ms_per_step"):
        stats = res[kind]
        assert stats["first"] > 0 and stats["n"] >= 2
        assert 0 < stats["median"] <= stats["p99"] <= stats["max"]
    assert res["ms_per_step"]["n"] <= res["steps"] - 1


def test_chip_smoke_forecast_topk_phase_rehearsal():
    """chip_smoke's ``[forecast-topk]`` on the CPU at a tiny width: the
    service at queue-top-k 1 trains and forecasts on 10 features (the
    embed's K not a multiple of 8), every forward replayed."""
    res = chip_smoke.phase_forecast(
        torch.device("cpu"), model_kwargs=TINY_MODEL, seq_len=8,
        min_rounds=2, steps_per_round=2, batch=4, queue_top_k=1)
    assert res["cfg"].n_features == chip_smoke.TOPK_FEATURES
    assert res["rounds"] >= 2 and res["steps"] >= 2 * res["rounds"]
    assert np.isfinite(res["loss"])
    assert res["replay_max_abs_err"] <= chip_smoke.FORWARD_LIMIT
    assert len(res["forecast"]) == chip_smoke.TOPK_FEATURES


def test_chip_smoke_products_work_by_hand():
    """The bytes and least time behind the bound of forward's products."""
    cfg = port_fc.ForecasterConfig(seq_len=4, d_model=8, n_heads=2, d_ff=16,
                                   n_layers=1, n_features=3)
    nbytes, seconds = chip_smoke.products_work(cfg, 2)
    rows = 8
    shapes = [(rows, 3, 8), (rows, 8, 24), (rows, 8, 8), (rows, 8, 16),
              (rows, 16, 8)]
    want = sum(2 * (m * k + k * n + m * n) for m, k, n in shapes)
    want += 4 * (2 * 8 + 8 * 3 + 2 * 3)
    assert nbytes == want
    flops = sum(2 * m * k * n for m, k, n in shapes)
    assert seconds == pytest.approx(max(
        want / chip_smoke.HBM_BYTES_PER_S,
        flops / chip_smoke.BF16_TC_FLOPS_PER_S
        + 2 * 2 * 8 * 3 / chip_smoke.F32_FLOPS_PER_S))
