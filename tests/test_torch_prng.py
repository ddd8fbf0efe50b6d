"""The port's numpy threefry (``chanamq_tpu_torch.models.prng``) against
``jax.random``, and the port's default model against the reference's.

- ``prng.key`` and ``prng.split`` equal ``jax.random.PRNGKey`` and
  ``jax.random.split`` bit for bit, for several keys and counts;
- ``prng.normal`` is within 4 float32 ulp of ``jax.random.normal``, for
  several keys and shapes. The uniform draw under it is exact; only
  erfinv's ``log1p`` differs from XLA's, in about one value in a hundred;
- the port's default ``init_params(0, cfg)`` is within the same 4 ulp of
  the reference's ``init_params(PRNGKey(0), cfg)``, at the flagship width
  and at the service's compact default, with zeros and ones exact;
- both services, each with its untouched defaults (the compact model,
  window 64, 20 train steps a round on a batch of 16, lr 1e-3, its own
  default weights), run one ``_round`` on one history: the same steps,
  the loss within 2% and the forecast within the bf16 limit of
  tests/test_torch_forecast_service.py (0.1 for the forward, plus 0.05 for
  what 20 train steps' bf16 gradients move, in normalized units, which
  de-normalization scales by each feature's std).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chanamq_tpu.models import forecaster as ref_fc
from chanamq_tpu.models.service import ForecastService as RefService
from chanamq_tpu_torch.models import forecaster as port_fc
from chanamq_tpu_torch.models import prng
from chanamq_tpu_torch.models import telemetry as port_tm
from chanamq_tpu_torch.models.service import ForecastService as PortService

ULP_LIMIT = 4  # prng.normal against jax.random.normal, float32 ulp
TRAINED_LIMIT = 0.1 + 0.05  # bf16 forecast, normalized units
LOSS_RTOL = 0.02

SEEDS = (0, 1, 7, 42, 2**31 - 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The service round trains 20 steps: one torch thread keeps it from
    crowding out neighbouring test files' timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference in units of the last place of ``want``."""
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    return float((np.abs(got.astype(np.float64) - want)
                  / np.spacing(np.abs(want))).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_are_jax_bit_for_bit(seed):
    want_key = np.asarray(jax.random.PRNGKey(seed))
    assert np.array_equal(prng.key(seed), want_key)
    for n in (1, 2, 3, 28, 1000):
        got = prng.split(prng.key(seed), n)
        assert got.dtype == np.uint32 and got.shape == (n, 2)
        assert np.array_equal(got, np.asarray(jax.random.split(
            jax.random.PRNGKey(seed), n)))
    # a split key splits on as JAX's does
    sub = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 4))[3]
    assert np.array_equal(prng.split(sub, 5),
                          np.asarray(jax.random.split(sub, 5)))


def test_key_refuses_seeds_out_of_range():
    with pytest.raises(ValueError):
        prng.key(-1)
    with pytest.raises(ValueError):
        prng.key(2**64)
    assert np.array_equal(prng.key(2**32 + 5), np.array([1, 5], np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 2), (64, 256),
                                   (256, 768)])
def test_normal_within_ulps_of_jax(seed, shape):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 3))[2]
    want = np.asarray(jax.random.normal(k, shape))
    got = prng.normal(k, shape)
    assert _ulps(got, want) <= ULP_LIMIT
    # the uniform draw under it is exact
    lo = np.nextafter(np.float32(-1), np.float32(0))
    assert np.array_equal(
        prng.uniform(k, shape, lo, 1.0),
        np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, 1.0)))


def test_erfinv_edges():
    x = np.array([-1.0, 0.0, 1.0], np.float32)
    got = prng.erfinv(x)
    assert got[0] == -np.inf and got[1] == 0.0 and got[2] == np.inf


COMPACT = {"d_model": 64, "n_heads": 4, "d_ff": 256, "n_layers": 2}


@pytest.mark.parametrize("model_kwargs", [{}, COMPACT],
                         ids=["flagship", "compact"])
def test_default_init_params_are_the_reference_draw(model_kwargs):
    jcfg = ref_fc.ForecasterConfig(**model_kwargs)
    tcfg = port_fc.ForecasterConfig(**model_kwargs)
    want = {k: np.asarray(v)
            for k, v in ref_fc.init_params(jax.random.PRNGKey(0),
                                           jcfg).items()}
    got = port_fc.init_params(0, tcfg, "cpu")
    assert list(got) == list(want)
    for name, arr in want.items():
        g = got[name].numpy()
        if name.endswith(("/bias", "/scale")):
            assert np.array_equal(g, arr), name
        else:
            assert _ulps(g, arr) <= ULP_LIMIT, name
    # a key and its seed are one source
    again = port_fc.init_params(prng.key(0), tcfg, "cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def _history(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    base = np.array([2000, 1900, 50, 10, 4, 1e6, 9e5, 1990], np.float64)
    wave = 1 + 0.5 * np.sin(t * np.array([0.05, 0.07, 0.11, 0.13, 0, 0.05,
                                          0.07, 0.05]))
    h = base * wave * (1 + 0.1 * rng.normal(size=(n, 8)))
    h[:, 4] = 4.0
    return np.maximum(h, 0).astype(np.float32)


def test_untouched_default_services_agree():
    """Neither service is given parameters: each draws its own default
    model, and the port's must be the reference's for the two to agree."""
    broker = types.SimpleNamespace()
    ref_svc = RefService(broker)
    port_svc = PortService(broker, device="cpu")
    history = _history(600, 5)
    ref_steps, ref_loss, want = ref_svc._round(history)
    steps, loss, got = port_svc._round(history)
    assert steps == ref_steps == 20
    assert abs(loss - ref_loss) <= LOSS_RTOL * ref_loss
    _, std = port_tm.normalization(history)
    for i, name in enumerate(port_tm.FEATURES):
        assert np.isfinite(got[name]) and got[name] >= 0.0
        assert abs(got[name] - want[name]) <= TRAINED_LIMIT * std[i], \
            (name, got[name], want[name], std[i])
