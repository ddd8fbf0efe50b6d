"""The port's forecaster (``chanamq_tpu_torch.models.forecaster`` and the
plain versions of its kernels) against the JAX package's, on the CPU.

The same numpy inputs, made from fixed seeds, go through the JAX function
(on the CPU) and the port's counterpart, with the JAX package's own
``init_params(PRNGKey(0))`` carried across by ``params_from_numpy``. On CPU
tensors the kernel wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerances, max abs error:
- float32: 1e-4. The same arithmetic in float32 with sums taken in another
  order; a forward differs by about 1e-6 (3e-6 at the flagship width).
- bfloat16, forward: 0.1, on outputs up to about 5. Both round to bf16
  after every step, and a value whose float32 sum lands on the other side
  of a bf16 rounding boundary moves by one bf16 step (1/64 at 2-4); such
  steps carry through the layers (measured 0.031).
- bfloat16, one op: two bf16 steps at the op's largest output. An op
  rounds once (attention: three times, q . k, the weights and the output),
  so a differing float32 sum moves an output by one step; JAX also
  computes GELU in bf16 with bf16 constants, which costs about one more.
- the loss: what the forward limit allows, 2 * limit * sqrt(loss) +
  limit**2 (|pred - y| averages at most sqrt(loss)).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chanamq_tpu.models import forecaster as ref
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.models import forecaster as port
from test_torch_kernels_gpu import (
    jax_forward, jax_kernel_inputs, jax_kernel_outputs, jax_op_limit,
    kernel_args_for_jax,
)

SMALL = dict(seq_len=8, d_model=32, n_heads=4, d_ff=64, n_layers=2)
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def bf16_steps(n: float, want: np.ndarray) -> float:
    """``n`` bf16 steps at the largest magnitude in ``want``."""
    top = float(np.abs(want).max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def op_tol(dtype: str, want: np.ndarray) -> float:
    return 1e-4 if dtype == "float32" else bf16_steps(2, want)


def configs(dtype: str, **kw):
    jdt, tdt = DTYPES[dtype]
    return (ref.ForecasterConfig(dtype=jdt, **kw),
            port.ForecasterConfig(dtype=tdt, **kw))


def carried(jcfg, tcfg):
    """The JAX package's init_params(PRNGKey(0)) and the same numbers as
    the port's parameters on the CPU."""
    params = ref.init_params(jax.random.PRNGKey(0), jcfg)
    as_np = {k: np.asarray(v) for k, v in params.items()}
    return params, port.params_from_numpy(as_np, tcfg, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 8, 32)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    want = np.asarray(ref._layernorm(jnp.asarray(x, jdt),
                                     jnp.asarray(scale))).astype(np.float32)
    got = fk.layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=op_tol(dtype, want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_matches_jax(dtype):
    """qkv product -> causal_attention -> proj product against the
    reference's _attention, on the carried-across layer-0 weights."""
    jcfg, tcfg = configs(dtype, **SMALL)
    params, tparams = carried(jcfg, tcfg)
    a = np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32)
    want = np.asarray(ref._attention(
        jnp.asarray(a, jcfg.dtype), params["layer0/attn/qkv"],
        params["layer0/attn/proj"], jcfg)).astype(np.float32)
    ta = torch.from_numpy(a).to(tcfg.dtype)
    fused = torch.matmul(ta, tparams["layer0/attn/qkv"].to(tcfg.dtype))
    att = fk.causal_attention(fused, tcfg.n_heads)
    assert att.shape == (2, 8, 32) and att.dtype == tcfg.dtype
    got = torch.matmul(att, tparams["layer0/attn/proj"].to(tcfg.dtype))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=op_tol(dtype, want))


def test_attention_is_causal():
    """A change to a later position's q, k or v leaves every earlier
    output as it was."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(1, 8, 96)).astype(np.float32))
    base = fk.causal_attention(qkv, 4)
    bumped = qkv.clone()
    bumped[:, 5:] += 1.0
    out = fk.causal_attention(bumped, 4)
    assert torch.equal(out[:, :5], base[:, :5])
    assert not torch.equal(out[:, 5:], base[:, 5:])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = (np.random.default_rng(4).normal(size=(2, 8, 64)) * 2).astype(
        np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jdt))).astype(np.float32)
    got = fk.gelu_tanh(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=op_tol(dtype, want))
    # the tanh form, not torch's default erf form
    erf = torch.nn.functional.gelu(torch.from_numpy(x).double())
    assert float((got.double() - erf).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(dtype):
    jcfg, tcfg = configs(dtype, **SMALL)
    params, tparams = carried(jcfg, tcfg)
    x = np.random.default_rng(5).normal(size=(4, 8, 8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: ref.forward(p, x, jcfg))(
        params, x))
    got = port.forward(tparams, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FORWARD_TOL[dtype])
    # weights cast once give the same numbers as weights cast in the call
    weights = port.cast_weights(tparams, tcfg)
    again = port.forward(tparams, torch.from_numpy(x), tcfg, weights=weights)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_matches_jax(dtype):
    jcfg, tcfg = configs(dtype, **SMALL)
    params, tparams = carried(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 8, 8)).astype(np.float32)
    y = rng.normal(size=(4, 8)).astype(np.float32)
    want = float(ref.loss_fn(params, (x, y), jcfg))
    got = port.loss_fn(tparams, (torch.from_numpy(x), torch.from_numpy(y)),
                       tcfg)
    assert got.shape == () and got.dtype == torch.float32
    limit = FORWARD_TOL[dtype]
    assert abs(float(got) - want) <= 2 * limit * math.sqrt(want) + limit**2


def test_flagship_forward_matches_jax_bf16():
    """ForecasterConfig() itself (window 64, d_model 256, 4 heads, d_ff
    1024, 4 layers) at batch 2 in bf16."""
    tcfg = port.ForecasterConfig()
    assert tcfg.dtype == torch.bfloat16
    # the JAX side as the card test computes it
    params, x, want = jax_forward(2)
    got = port.forward(port.params_from_numpy(params, tcfg, "cpu"),
                       torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FORWARD_TOL["bfloat16"])


def test_init_params_names_shapes_and_scales():
    for kw in (SMALL, {}):
        jcfg, tcfg = configs("bfloat16", **kw)
        want = ref.init_params(jax.random.PRNGKey(0), jcfg)
        got = port.init_params(0, tcfg, "cpu")
        assert list(got) == list(want)
        for name, arr in want.items():
            assert tuple(got[name].shape) == arr.shape, name
            assert got[name].dtype == torch.float32
        again = port.init_params(0, tcfg, "cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)
    # zero biases, unit scales, fan-in scaled normals
    assert float(got["embed/bias"].abs().max()) == 0.0
    assert torch.equal(got["layer0/ln1/scale"], torch.ones(256))
    std = float(got["layer0/mlp/w2"].std())
    assert abs(std - 1 / math.sqrt(1024)) < 0.05 / math.sqrt(1024)


def test_params_from_numpy_checks_names_and_shapes():
    _, tcfg = configs("bfloat16", **SMALL)
    good = {k: v.numpy() for k, v in port.init_params(
        1, tcfg, "cpu").items()}
    got = port.params_from_numpy(good, tcfg, "cpu")
    assert all(np.array_equal(got[k].numpy(), good[k]) for k in good)
    missing = dict(good)
    del missing["layer1/mlp/w2"]
    with pytest.raises(ValueError, match="layer1/mlp/w2"):
        port.params_from_numpy(missing, tcfg, "cpu")
    wrong = dict(good, **{"pos": np.zeros((9, 32), np.float32)})
    with pytest.raises(ValueError, match="pos"):
        port.params_from_numpy(wrong, tcfg, "cpu")


def test_synthetic_batch():
    _, tcfg = configs("bfloat16", **SMALL)
    x, y = port.synthetic_batch(np.random.default_rng(0), tcfg, 3, "cpu")
    assert x.shape == (3, 8, 8) and y.shape == (3, 8)
    assert x.dtype == y.dtype == torch.float32
    # sin(...) + 1.5 with 5% noise
    assert 0.0 < float(x.min()) and float(x.max()) < 3.0
    x2, _ = port.synthetic_batch(np.random.default_rng(0), tcfg, 3, "cpu")
    assert torch.equal(x, x2)
    assert torch.isfinite(port.forward(
        port.init_params(0, tcfg, "cpu"),
        x, tcfg)).all()


def test_plain_ops_are_the_cpu_path():
    """On CPU tensors the wrappers are their plain versions and count no
    launch; ``ops=PLAIN`` gives the same forward."""
    _, tcfg = configs("bfloat16", **SMALL)
    params = port.init_params(2, tcfg, "cpu")
    x, _ = port.synthetic_batch(np.random.default_rng(2), tcfg, 2, "cpu")
    before = (fk.layernorm.launches, fk.causal_attention.launches,
              fk.gelu_tanh.launches)
    got = port.forward(params, x, tcfg)
    assert torch.equal(got, port.forward(params, x, tcfg, ops=fk.PLAIN))
    assert (fk.layernorm.launches, fk.causal_attention.launches,
            fk.gelu_tanh.launches) == before


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version: it
    goes to the kernel's checks, which refuse a device with no kernel and
    a dtype the kernel does not take."""
    x = torch.zeros(2, 8, 32, dtype=torch.bfloat16, device="meta")
    scale = torch.ones(32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fk.layernorm(x, scale)
    with pytest.raises(ValueError, match="no kernel"):
        fk.causal_attention(torch.zeros(2, 8, 96, device="meta"), 4)
    with pytest.raises(ValueError, match="no kernel"):
        fk.gelu_tanh(x)
    # nor does a CPU tensor handed to a kernel's own launch path
    cpu = torch.zeros(2, 8, 96, dtype=torch.bfloat16)
    for call in (lambda: fk.prepare_layernorm(cpu, torch.ones(96)),
                 lambda: fk.prepare_causal_attention(cpu, 4),
                 lambda: fk.prepare_gelu_tanh(cpu)):
        with pytest.raises(ValueError, match="no kernel"):
            call()



# -- the card tests' JAX comparisons, rehearsed on the CPU ----------------------


@pytest.mark.parametrize("name", ["layernorm", "causal_attention",
                                  "gelu_tanh"])
def test_plain_ops_match_the_card_tests_jax_outputs(name):
    """``tests/test_torch_kernels_gpu.py`` holds each kernel to the JAX
    package's outputs at the flagship shapes; here the plain versions
    meet the same outputs and limits on the CPU."""
    inputs = jax_kernel_inputs()
    outputs = jax_kernel_outputs(inputs)
    got = getattr(fk, name)(*kernel_args_for_jax(name, inputs, outputs,
                                                 "cpu"))
    want = outputs[name]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= jax_op_limit(want), err


def test_card_tests_inputs_round_alike():
    """torch and JAX round the card tests' float32 inputs to the same bf16
    bits, so the card and the reference start from one input."""
    inputs = jax_kernel_inputs()
    for name in ("ln_x", "attn_a", "gelu_x"):
        from_jax = np.asarray(jnp.asarray(inputs[name], jnp.bfloat16)).view(
            np.uint16)
        from_torch = torch.from_numpy(inputs[name]).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
        assert np.array_equal(from_jax, from_torch), name

