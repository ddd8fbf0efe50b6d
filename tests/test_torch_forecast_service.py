"""The port's forecast service (``chanamq_tpu_torch.models.service`` and
``.telemetry``) against the JAX package's, on the CPU, and a rehearsal of
``chip_smoke.py``'s forecaster phases at a tiny size.

- the telemetry copies (ring, sampler, training batch, normalization,
  top-K slots) give the reference's outputs on the same inputs;
- slice parity: one history array goes through both services' ``_round``
  (no training), the port's model carrying the JAX service's own
  ``init_params(PRNGKey(0))`` across through numpy; the forecasts agree
  within the bf16 forward limit, 0.1 in normalized units (see
  tests/test_torch_forecaster.py), which de-normalization scales by each
  feature's std;
- the reference's observed-traffic test on the port's BrokerServer and
  client with ``device="cpu"``;
- training (``steps_per_round > 0``) is refused, not skipped.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from chanamq_tpu.models import forecaster as ref_fc
from chanamq_tpu.models import telemetry as ref_tm
from chanamq_tpu.models.service import ForecastService as RefService
from chanamq_tpu_torch.broker.broker import Broker as PortBroker
from chanamq_tpu_torch.broker.server import BrokerServer as PortServer
from chanamq_tpu_torch.client import AMQPClient as PortClient
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.models import forecaster as port_fc
from chanamq_tpu_torch.models import telemetry as port_tm
from chanamq_tpu_torch.models.service import ForecastService as PortService

FORWARD_LIMIT = 0.1  # bf16 forward, normalized units
TINY_MODEL = {"d_model": 32, "n_heads": 4, "d_ff": 64, "n_layers": 2}


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


@pytest.mark.parametrize("model_kwargs", [None, TINY_MODEL],
                         ids=["compact-default", "tiny"])
def test_round_matches_reference_service(model_kwargs):
    """Both services' ``_round`` on the same histories, no training: the
    same forecast within the bf16 limit, the same draws from the numpy
    generator, and the reference's clamp at 0."""
    kw = dict(interval_s=1.0, seq_len=16, history=512, batch=8,
              steps_per_round=0, model_kwargs=model_kwargs)
    ref_svc = RefService(types.SimpleNamespace(), **kw)
    port_svc = PortService(types.SimpleNamespace(), device="cpu", **kw)
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
        assert (steps, loss) == (ref_steps, ref_loss) == (0, None)
        assert list(got) == list(want) == list(port_tm.FEATURES)
        _, std = port_tm.normalization(history)
        for i, name in enumerate(port_tm.FEATURES):
            assert got[name] >= 0.0 and np.isfinite(got[name])
            assert abs(got[name] - want[name]) <= FORWARD_LIMIT * std[i], \
                (name, got[name], want[name], std[i])
        assert (port_svc._np_rng.bit_generator.state
                == ref_svc._np_rng.bit_generator.state)


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


def test_training_is_refused():
    """Training is not ported: any ``steps_per_round`` but 0 raises, and
    the reference's ``lr`` is not taken; the default serves without
    training."""
    broker = types.SimpleNamespace()
    for steps in (20, 1):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PortService(broker, steps_per_round=steps, device="cpu")
    with pytest.raises(TypeError):
        PortService(broker, lr=1e-3)
    assert PortService(broker).steps_per_round == 0


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


# -- end to end: the port's broker under load -> forecast ---------------------


async def test_forecast_from_observed_traffic():
    """The reference's test_forecast_from_observed_traffic on the port's
    server and client, without training and without the admin API: the
    sampler sees the real traffic and the service serves a finite,
    non-negative next-tick forecast."""
    server = PortServer(PortBroker(router_device="cpu"), host="127.0.0.1",
                        port=0, heartbeat_s=0)
    await server.start()
    forecaster = PortService(
        server.broker, interval_s=0.02, train_interval_s=0.2, seq_len=8,
        history=4096, batch=8, steps_per_round=0, model_kwargs=TINY_MODEL,
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
        assert snap["trained_steps"] == 0 and snap["loss"] is None
        history = forecaster.ring.history()
        assert history[:, port_tm.FEATURES.index("publish_rate")].max() > 0
        assert history[:, port_tm.FEATURES.index("deliver_rate")].max() > 0
        assert snap["samples"] >= 9
        forecast = snap["forecast"]
        assert set(forecast) == set(port_tm.FEATURES)
        for name, value in forecast.items():
            assert np.isfinite(value), (name, value)
            assert value >= 0.0
        assert len(received) > 0
    finally:
        await client.close()
        await forecaster.stop()
        await server.stop()
    assert server.broker.forecaster is None


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
