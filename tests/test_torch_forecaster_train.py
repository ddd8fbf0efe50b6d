"""The port's train step (``chanamq_tpu_torch.models.forecaster``'s
``make_train_step``, the backward passes of ``kernels/forecaster.py`` and
the update of ``kernels/update.py``) against the JAX package's, on the CPU.

The same numpy inputs, made from fixed seeds, go through the JAX function
(``jax.vjp`` of the reference's op, its jitted ``step``) and the port's
counterpart, with the JAX package's own ``init_params(PRNGKey(0))`` and
momentum carried across by ``params_from_numpy``. On CPU tensors the
kernel wrappers run their plain versions, so ``KERNELS`` differentiates
through the explicit backward formulas the CUDA kernels compute, and
``PLAIN`` through torch autograd of the plain forward; both are held
against JAX. The CUDA kernels themselves are held against those plain
versions on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).

Tolerances, max abs error:
- float32: 1e-5 of the tensor's largest value, for each op's vjp and for
  the loss, every gradient, and the parameters and momentum after 1 and 5
  steps (measured: 5e-7 for a gradient, 1.8e-6 after 5 steps). The same
  arithmetic, sums taken in another order.
- bfloat16, one op's vjp: ``OP_STEPS`` bf16 steps at the output's
  largest value. Layernorm and attention round where the reference
  rounds, so a float32 sum taken in another order moves a value by about
  a step. JAX differentiates GELU op by op in bf16 with bf16 constants
  (about ten roundings; measured 4.1 steps from the float64 derivative),
  the port in float32 rounded once (0.5 steps): six steps, and the test
  shows the port is the exact side.
- bfloat16, the step: each gradient and each momentum tree within
  ``GRAD_STEPS`` bf16 steps (3 * 2^-7 = 2.3%) of its largest value
  (measured 0.6%), except ``embed/bias`` and ``pos``, whose reference
  gradients are bf16-accumulated sums (see ``test_bias_gradients``); the
  parameters within what their momentum differences allow (each step
  moves a parameter by lr times its momentum).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chanamq_tpu.models import forecaster as ref
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.kernels import update as upd
from chanamq_tpu_torch.models import forecaster as port

SMALL = dict(seq_len=8, d_model=32, n_heads=4, d_ff=64, n_layers=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
OPS = {"kernels": fk.KERNELS, "plain": fk.PLAIN}
F32_RTOL = 1e-5
# bf16 steps at the largest value, one op's vjp against jax.vjp
OP_STEPS = {"layernorm": 2.0, "attention": 2.0, "gelu": 6.0}
GRAD_STEPS = 3.0
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside other test files on every core; torch's
    CPU ops here are small, so one thread each keeps them from crowding
    out their neighbours' timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_steps(n: float, want) -> float:
    """``n`` bf16 steps at the largest magnitude in ``want``."""
    top = float(np.abs(np.asarray(want, np.float64)).max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def assert_close(got, want, tol, what=""):
    got = got.detach().double().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def op_tol(dtype: str, op: str, want) -> float:
    if dtype == "float32":
        return F32_RTOL * float(np.abs(_np(want)).max())
    return bf16_steps(OP_STEPS[op], want)


def configs(dtype: str, **kw):
    jdt, tdt = DTYPES[dtype]
    return (ref.ForecasterConfig(dtype=jdt, **kw),
            port.ForecasterConfig(dtype=tdt, **kw))


def carried(jcfg, tcfg):
    params = ref.init_params(jax.random.PRNGKey(0), jcfg)
    return params, port.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, tcfg, "cpu")


def leaf(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).requires_grad_()


# -- each op's vjp ---------------------------------------------------------------


@pytest.mark.parametrize("ops", list(OPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_vjp_matches_jax(dtype, ops):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 8, 32)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 32)).astype(np.float32)
    _, vjp = jax.vjp(ref._layernorm, jnp.asarray(x, jdt), jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy, jdt))
    tx, ts = leaf(x, tdt), torch.from_numpy(scale).requires_grad_()
    out = OPS[ops].layernorm(tx, ts)
    dx, ds = torch.autograd.grad(out, (tx, ts), torch.from_numpy(dy).to(tdt))
    assert dx.dtype == tdt and ds.dtype == torch.float32
    assert_close(dx, want_dx, op_tol(dtype, "layernorm", want_dx), "dx")
    assert_close(ds, want_ds, op_tol(dtype, "layernorm", want_ds), "dscale")


@pytest.mark.parametrize("ops", list(OPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_vjp_matches_jax(dtype, ops):
    """qkv product -> attention core -> identity proj against jax.vjp of
    the reference's ``_attention`` with an identity ``proj`` (a product
    with one non-zero term changes no bf16 value), for the cotangents of
    the activations and of the qkv weights."""
    jcfg, tcfg = configs(dtype, **SMALL)
    rng = np.random.default_rng(12)
    a = rng.normal(size=(2, 8, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 96)) / math.sqrt(32)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 32)).astype(np.float32)
    eye = np.eye(32, dtype=np.float32)
    _, vjp = jax.vjp(lambda a, w: ref._attention(a, w, eye, jcfg),
                     jnp.asarray(a, jcfg.dtype), jnp.asarray(w))
    want_da, want_dw = vjp(jnp.asarray(dy, jcfg.dtype))
    ta, tw = leaf(a, tcfg.dtype), torch.from_numpy(w).requires_grad_()
    fused = torch.matmul(ta, tw.to(tcfg.dtype))
    out = torch.matmul(OPS[ops].causal_attention(fused, tcfg.n_heads),
                       torch.from_numpy(eye).to(tcfg.dtype))
    da, dw = torch.autograd.grad(out, (ta, tw),
                                 torch.from_numpy(dy).to(tcfg.dtype))
    assert_close(da, want_da, op_tol(dtype, "attention", want_da), "da")
    assert_close(dw, want_dw, op_tol(dtype, "attention", want_dw), "dw")


@pytest.mark.parametrize("ops", list(OPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_vjp_matches_jax(dtype, ops):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(13)
    x = (rng.normal(size=(2, 8, 64)) * 2).astype(np.float32)
    dy = rng.normal(size=(2, 8, 64)).astype(np.float32)
    _, vjp = jax.vjp(jax.nn.gelu, jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(dy, jdt))
    tx = leaf(x, tdt)
    (got,) = torch.autograd.grad(OPS[ops].gelu_tanh(tx), (tx,),
                                 torch.from_numpy(dy).to(tdt))
    assert got.dtype == tdt
    assert_close(got, want, op_tol(dtype, "gelu", want))
    # the float64 derivative at the same bf16 inputs
    xd = torch.from_numpy(x).to(tdt).double()
    k = math.sqrt(2 / math.pi)
    t = torch.tanh(k * (xd + 0.044715 * xd ** 3))
    exact = torch.from_numpy(dy).to(tdt).double() * (
        0.5 * (1 + t) + 0.5 * xd * (1 - t * t) * k * (1 + 3 * 0.044715 * xd ** 2))
    port_tol = (F32_RTOL * float(exact.abs().max()) if dtype == "float32"
                else bf16_steps(1, exact.numpy()))
    assert_close(got, exact.numpy(), port_tol, "against float64")


@pytest.mark.parametrize("op", ["layernorm", "causal_attention", "gelu_tanh"])
def test_backward_formulas_match_autograd(op):
    """The explicit backward each kernel computes (``*_bwd_ref``) is the
    derivative torch autograd takes of the plain forward. Both compute in
    float32 inside whatever the input's dtype (float64 here, so nothing
    rounds on the way in or out): within 1e-5 of the largest value."""
    rng = np.random.default_rng(14)
    if op == "layernorm":
        x = torch.from_numpy(rng.normal(size=(3, 5, 16)) * 2 + 0.5).requires_grad_()
        scale = torch.from_numpy(1 + 0.1 * rng.normal(size=16)).requires_grad_()
        dy = torch.from_numpy(rng.normal(size=(3, 5, 16)))
        want = torch.autograd.grad(fk.layernorm_ref(x, scale), (x, scale), dy)
        got = fk.layernorm_bwd_ref(dy, x.detach(), scale.detach())
    elif op == "causal_attention":
        qkv = torch.from_numpy(rng.normal(size=(2, 7, 48))).requires_grad_()
        dy = torch.from_numpy(rng.normal(size=(2, 7, 16)))
        want = torch.autograd.grad(fk.causal_attention_ref(qkv, 2), (qkv,),
                                   dy)
        got = (fk.causal_attention_bwd_ref(qkv.detach(), dy, 2),)
    else:
        x = torch.from_numpy(rng.normal(size=(4, 33)) * 2).requires_grad_()
        dy = torch.from_numpy(rng.normal(size=(4, 33)))
        want = torch.autograd.grad(fk.gelu_tanh_ref(x), (x,), dy)
        got = (fk.gelu_tanh_bwd_ref(dy, x.detach()),)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w.numpy(), F32_RTOL * float(w.abs().max()))


# -- the train step against the reference's jitted step --------------------------


def _trees_close(dtype, got: dict, want: dict, what: str, special=()):
    for name, w in want.items():
        if name in special:
            continue
        w = np.asarray(w)
        tol = (F32_RTOL * float(np.abs(w).max()) if dtype == "float32"
               else bf16_steps(GRAD_STEPS, w))
        assert_close(got[name], w, tol, f"{what} {name}")


CLIPS = {"clipped": 1.0, "unclipped": 1e6}


def compare_train_steps(jcfg, tcfg, params, tparams, x, y, clip_norm,
                        steps=(1, 5)) -> dict:
    """Step the reference's jitted ``step`` (on the CPU) and the port's
    ``make_train_step`` (on ``tparams``' device) from one state on one
    batch, and hold the loss, the momentum and the parameters after each
    step in ``steps`` to the limits the module docstring states. In bf16,
    ``embed/bias`` and ``pos`` are held after the first step to
    ``bias_gradient_bounds`` (times each side's clip scale, plus what the
    two scales' difference moves), and ``embed/bias`` after later steps
    to 1.5 times the first step's bound relative to its largest value
    (the momentum is a 0.9-weighted sum of gradients that each err about
    as the first did). Returns, for each kind, the largest error relative
    to its limit, with its step and tree."""
    dtype = "float32" if tcfg.dtype == torch.float32 else "bfloat16"
    device = next(iter(tparams.values())).device
    batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    bias = s_k = s_r = g_k = None
    if dtype == "bfloat16":
        bias, g_k, g_r, _ = bias_gradient_bounds(jcfg, tcfg, params,
                                                 tparams, x, y)
        s_k, s_r = clip_scale(g_k, clip_norm), clip_scale(g_r, clip_norm)
    jstep = jax.jit(ref.make_train_step(jcfg, lr=LR, clip_norm=clip_norm))
    tstep = port.make_train_step(tcfg, lr=LR, clip_norm=clip_norm)
    jp, jm = params, ref.init_momentum(params)
    tp, tm = tparams, port.init_momentum(tparams)
    dm_sum = {k: 0.0 for k in tp}
    worst: dict = {}

    def held(kind, got, want, limit, name=""):
        err = np.abs(_np(got).astype(np.float64) - np.asarray(want, np.float64))
        ratio = float((err / limit).max())
        assert ratio <= 1.0, (kind, n, name, float(err.max()), ratio)
        worst[kind] = max(worst.get(kind, (0.0,)), (ratio, n, name))

    rel_bias = None
    for n in range(1, max(steps) + 1):
        jp, jm, jl = jstep(jp, jm, (x, y))
        tp2, tm2, tl = tstep(tp, tm, batch)
        assert tp2 is tp and tm2 is tm  # updated in place
        if n == 1:  # the forward limits of tests/test_torch_forecaster.py
            tol = (F32_RTOL * float(jl) if dtype == "float32"
                   else 2 * 0.1 * math.sqrt(float(jl)) + 0.01)
            held("loss", float(tl), float(jl), tol)
        for k in tp:
            dm_sum[k] += float(np.abs(_np(tm[k]) - np.asarray(jm[k])).max())
        if n not in steps:
            continue
        for k in tp:
            w_m, w_p = np.asarray(jm[k]), np.asarray(jp[k])
            if dtype == "float32":
                held("momentum", tm[k], w_m, F32_RTOL * np.abs(w_m).max(), k)
                held("params", tp[k], w_p, F32_RTOL * np.abs(w_p).max(), k)
                continue
            limit = bf16_steps(GRAD_STEPS, w_m)
            if k in bias and n == 1:
                # m = g * s: the gradient bound at the reference's scale,
                # plus the port's gradient times the scales' difference
                limit = (s_r * bias[k][0] + np.abs(_np(g_k[k])) * abs(
                    s_k - s_r) + 2.0 ** -20 * np.abs(w_m))
                if k == "embed/bias":
                    rel_bias = float((bias[k][0] * s_r).max()) / float(
                        np.abs(w_m).max())
            elif k == "embed/bias":
                limit = 1.5 * rel_bias * float(np.abs(w_m).max())
            held("momentum", tm[k], w_m, limit, k)
            held("params", tp[k], w_p, LR * (1 + 2.0 ** -20) * dm_sum[k]
                 + 8 * n * 2.0 ** -24 * float(np.abs(w_p).max()), k)
    return worst


def clip_scale(grads: dict, clip_norm) -> float:
    """The reference's clip scale for these gradients, in float64."""
    if clip_norm is None:
        return 1.0
    sq = sum(float(np.sum(np.square(_np(g).astype(np.float64))))
             for g in grads.values())
    return min(1.0, clip_norm / math.sqrt(sq + 1e-12))


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_step_matches_jax(dtype, clip):
    """Loss, every gradient, and the parameters and momentum after 1 and 5
    steps of ``make_train_step`` against the reference's jitted ``step``
    on one ``synthetic_batch`` (B = 16), with the clip active (global norm
    above 1: s < 1) and not (s = 1), within the limits of
    ``compare_train_steps``."""
    jcfg, tcfg = configs(dtype, **SMALL)
    params, tparams = carried(jcfg, tcfg)
    x, y = (np.array(a) for a in ref.synthetic_batch(
        jax.random.PRNGKey(1), jcfg, 16))
    clip_norm = CLIPS[clip]
    want_grads = jax.jit(jax.grad(lambda p: ref.loss_fn(p, (x, y), jcfg)))(
        params)
    leaves = {k: v.detach().requires_grad_() for k, v in tparams.items()}
    loss = port.loss_fn(leaves, (torch.from_numpy(x), torch.from_numpy(y)),
                        tcfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    special = () if dtype == "float32" else ("embed/bias", "pos")
    _trees_close(dtype, grads, want_grads, "grad", special)
    scale = clip_scale(want_grads, clip_norm)
    assert (scale < 1.0) if clip == "clipped" else (scale == 1.0)
    compare_train_steps(jcfg, tcfg, params, tparams, x, y, clip_norm)


def bias_gradient_bounds(jcfg, tcfg, params, tparams, x, y,
                         ops=fk.KERNELS) -> dict:
    """For ``embed/bias`` and ``pos`` in bf16: the elementwise bound on
    ``|g_port - g_ref|``, derived, after checking which side is exact.

    Both gradients are the transpose of a broadcast add: sums of the bf16
    cotangent ``dh`` of the embedded activations over (batch, time) and
    over batch. The reference reduces in bf16 (``lax.reduce`` accumulates
    in the operand's type), so each partial sum rounds to 8 significant
    bits; the port's sum (torch's ``sum_to_size``) accumulates in float32
    and rounds once. Both ``dh`` are read by differentiating with respect
    to a full-shape ``embed/bias`` (the forward broadcasts it alike).

    - The port's gradient is within one bf16 step of a float64 sum of its
      own ``dh`` (the reference's is its bf16 reduction of its own ``dh``:
      ``test_bias_gradients`` shows that on this JAX).
    - So the two differ by at most (the triangle inequality, whatever
      order the reference sums in): the sum of ``|dh_port - dh_ref|`` over
      the reduced axes (the cotangents' own bf16 differences) + the
      reference's accumulation error, ``|g_ref - sum64(dh_ref)|`` + one
      bf16 step of the port's rounding.

    Returns ({name: (bound array, reference error, port error, one bf16
    step)}, the port's gradients, the reference's gradients, the
    reference's ``dh``), the port's side computed on ``tparams``'
    device."""
    device = next(iter(tparams.values())).device
    b, t, d = x.shape[0], jcfg.seq_len, jcfg.d_model
    full = np.zeros((b, t, d), np.float32)
    grad_fn = jax.jit(jax.grad(lambda p: ref.loss_fn(p, (x, y), jcfg)))
    grads = grad_fn(params)
    dh_ref = np.asarray(grad_fn(dict(
        params, **{"embed/bias": jnp.asarray(full)}))["embed/bias"],
        np.float64)
    batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    leaves = {k: v.detach().requires_grad_() for k, v in tparams.items()}
    g_port = dict(zip(leaves, torch.autograd.grad(
        port.loss_fn(leaves, batch, tcfg, ops=ops), list(leaves.values()))))
    bias = torch.from_numpy(full).to(device).requires_grad_()
    (dh_port,) = torch.autograd.grad(port.loss_fn(
        dict(tparams, **{"embed/bias": bias}), batch, tcfg, ops=ops), (bias,))
    dh_port = dh_port.double().cpu().numpy()
    out = {}
    for name, axes in (("embed/bias", (0, 1)), ("pos", (0,))):
        want = np.asarray(grads[name], np.float64)
        exact_port = dh_port.sum(axes)
        step = bf16_steps(1, exact_port)
        port_err = float(np.abs(_np(g_port[name]) - exact_port).max())
        assert port_err <= step, (name, port_err, step)
        ref_err = float(np.abs(want - dh_ref.sum(axes)).max())
        bound = np.abs(dh_port - dh_ref).sum(axes) + ref_err + step
        got = _np(g_port[name]).astype(np.float64)
        assert (np.abs(got - want) <= bound).all(), name
        out[name] = (bound, ref_err, port_err, step)
    return out, g_port, grads, dh_ref


def test_bias_gradients():
    """Which side is exact for ``embed/bias`` and ``pos`` in bf16, at the
    flagship width, where the reference's error is largest (~21% of the
    gradient): the reference's gradients are exactly its bf16 reductions
    (``lax.reduce`` in bf16) of its own ``dh``, ``bias_gradient_bounds``'
    checks hold, and the reference's accumulation error is several bf16
    steps of the sum while the port's is within one."""
    jcfg, tcfg = configs("bfloat16")
    params, tparams = carried(jcfg, tcfg)
    x, y = (np.asarray(a) for a in ref.synthetic_batch(
        jax.random.PRNGKey(1), jcfg, 16))
    bounds, _, grads, dh_ref = bias_gradient_bounds(jcfg, tcfg, params,
                                                    tparams, x, y)
    dh_bf16 = jnp.asarray(dh_ref, jnp.bfloat16)
    zero = jnp.asarray(0, jnp.bfloat16)
    for name, axes in (("embed/bias", (0, 1)), ("pos", (0,))):
        assert np.array_equal(np.asarray(grads[name]), np.asarray(
            jax.lax.reduce(dh_bf16, zero, jax.lax.add, axes), np.float32))
    _, ref_err, port_err, step = bounds["embed/bias"]
    assert ref_err > 4 * step >= 4 * port_err, (ref_err, port_err, step)


# -- the update -------------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 1e6, None], ids=["active", "inactive",
                                                        "none"])
def test_update_scale(clip):
    """The plain update's clip scale is the reference's formula: below 1
    when the global norm is above ``clip``, exactly 1 when it is not and
    when there is no clip; and given a scale it uses that one."""
    rng = np.random.default_rng(15)
    grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((4, 5), (7,), (3, 2, 2))]
    params = [torch.ones_like(g) for g in grads]
    momentum = [torch.full_like(g, 0.5) for g in grads]
    sq = sum(float(np.sum(np.square(g.numpy()), dtype=np.float32))
             for g in grads)
    s = upd.clip_momentum_sgd(params, momentum, grads, LR, clip)
    if clip == 1.0:
        assert float(s) == pytest.approx(1.0 / math.sqrt(sq), rel=1e-6)
        assert float(s) < 1.0
    else:
        assert float(s) == 1.0
    for p, m, g in zip(params, momentum, grads):
        want_m = np.float32(0.9) * np.float32(0.5) + g.numpy() * np.float32(
            float(s))
        assert np.array_equal(m.numpy(), want_m.astype(np.float32))
        assert np.array_equal(p.numpy(), (np.float32(1) - np.float32(LR)
                                          * want_m).astype(np.float32))
    given = torch.tensor(0.25)
    p2 = [torch.ones_like(g) for g in grads]
    m2 = [torch.zeros_like(g) for g in grads]
    assert float(upd.clip_momentum_sgd_ref(p2, m2, grads, LR, clip,
                                           scale=given)) == 0.25
    assert all(torch.equal(m, g * 0.25) for m, g in zip(m2, grads))


@pytest.mark.parametrize("clip", [1.0, 1e6, None], ids=["active", "inactive",
                                                        "none"])
def test_update_split_launches(clip):
    """The update's two launches apart, as the sharded step calls them
    (``sum_of_squares`` into a caller's buffer, then ``momentum_sgd`` from
    a caller's ``sq``): two lists' sums added by the caller give the whole
    sum to float32 rounding, and the update from that ``sq`` changes the
    same bits as ``clip_momentum_sgd_ref`` at that ``sq``'s scale. Each
    wrapper counts no launch on the CPU."""
    rng = np.random.default_rng(16)
    grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((4, 5), (7,), (3, 2, 2), (6, 3))]
    params = [torch.from_numpy(rng.normal(size=g.shape).astype(np.float32))
              for g in grads]
    momentum = [torch.full_like(g, 0.25) for g in grads]
    counts = (upd.sum_of_squares.launches, upd.momentum_sgd.launches)
    parts = [torch.empty(1), torch.empty(1)]
    assert upd.sum_of_squares(grads[:1], parts[0]) is parts[0]
    upd.sum_of_squares(grads[1:], parts[1])
    sq = parts[0] + parts[1]
    whole = float(upd.sum_of_squares_ref(grads))
    assert float(sq) == pytest.approx(whole, rel=1e-6)
    p1, m1 = [p.clone() for p in params], [m.clone() for m in momentum]
    s = upd.momentum_sgd(p1, m1, grads, LR, sq, clip)
    want_s = 1.0 if clip is None else min(1.0, clip / math.sqrt(float(sq)))
    assert float(s) == pytest.approx(want_s, rel=1e-6)
    p2, m2 = [p.clone() for p in params], [m.clone() for m in momentum]
    upd.clip_momentum_sgd_ref(p2, m2, grads, LR, clip, scale=s)
    for a, b in zip(p1 + m1, p2 + m2):
        assert torch.equal(a, b)
    assert (upd.sum_of_squares.launches, upd.momentum_sgd.launches) == counts


def test_update_refuses_off_the_cpu():
    """Tensors that are not on the CPU go to the kernel's checks, never the
    plain version."""
    meta = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        upd.clip_momentum_sgd(meta, meta, meta, LR)
    cpu = [torch.zeros(4)]
    with pytest.raises(ValueError, match="no kernel"):
        upd.prepare_clip_momentum_sgd(cpu, cpu, cpu, LR)
    with pytest.raises(ValueError, match="no kernel"):
        upd.prepare_sum_of_squares(cpu, torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel"):
        upd.prepare_momentum_sgd(cpu, cpu, cpu, LR, torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel"):
        upd.momentum_sgd(meta, meta, meta, LR, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="one length"):
        upd.prepare_clip_momentum_sgd(cpu, cpu, [], LR)


def test_backward_wrappers_launch_or_raise_off_the_cpu():
    bf = torch.bfloat16
    x = torch.zeros(2, 8, 32, dtype=bf, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fk.layernorm_bwd(x, x, torch.ones(32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fk.causal_attention_bwd(torch.zeros(2, 8, 96, dtype=bf,
                                            device="meta"), x, 4)
    with pytest.raises(ValueError, match="no kernel"):
        fk.gelu_tanh_bwd(x, x)
    cpu = torch.zeros(2, 8, 96, dtype=bf)
    for call in (lambda: fk.prepare_layernorm_bwd(cpu, cpu, torch.ones(96)),
                 lambda: fk.prepare_causal_attention_bwd(cpu, cpu[..., :32],
                                                         4),
                 lambda: fk.prepare_gelu_tanh_bwd(cpu, cpu)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


# -- the step's own contract -------------------------------------------------------


def test_step_casts_the_weights_every_step():
    """The step updates the parameter tensors in place and casts them
    inside its graph on every step: a second step sees the first's
    update, and a forward after it equals one on freshly cast weights."""
    _, tcfg = configs("bfloat16", **SMALL)
    params = port.init_params(3, tcfg, "cpu")
    before = {k: v.clone() for k, v in params.items()}
    ids = {k: id(v) for k, v in params.items()}
    momentum = port.init_momentum(params)
    x, y = port.synthetic_batch(np.random.default_rng(3), tcfg, 4, "cpu")
    step = port.make_train_step(tcfg)
    _, _, l1 = step(params, momentum, (x, y))
    assert {k: id(v) for k, v in params.items()} == ids
    assert all(not v.requires_grad for v in params.values())
    assert not torch.equal(params["layer0/attn/qkv"],
                           before["layer0/attn/qkv"])
    # the loss a step returns is the loss of the parameters it started from
    assert float(l1) == float(port.loss_fn(before, (x, y), tcfg))
    after_one = {k: v.clone() for k, v in params.items()}
    _, _, l2 = step(params, momentum, (x, y))
    assert float(l2) == float(port.loss_fn(after_one, (x, y), tcfg))
    got = port.forward(params, x, tcfg)
    assert torch.equal(got, port.forward(
        params, x, tcfg, weights=port.cast_weights(params, tcfg)))
    assert float(l2) < float(l1)


def test_loss_falls_over_twenty_steps():
    """The reference's 20 steps at lr 1e-3 on one batch: the loss falls,
    through the kernels' formulas and through plain autograd alike, and
    the two paths stay within the bf16 limits of one another."""
    _, tcfg = configs("bfloat16", **SMALL)
    x, y = port.synthetic_batch(np.random.default_rng(4), tcfg, 16, "cpu")
    out = {}
    for name, ops in OPS.items():
        params = port.init_params(4, tcfg, "cpu")
        momentum = port.init_momentum(params)
        step = port.make_train_step(tcfg, ops=ops)
        losses = [float(step(params, momentum, (x, y))[2])
                  for _ in range(20)]
        assert all(np.isfinite(losses)) and losses[-1] < 0.75 * losses[0]
        out[name] = (losses, params)
    assert abs(out["kernels"][0][-1] - out["plain"][0][-1]) <= 0.05 * \
        out["plain"][0][-1]


def test_momentum_crosses_from_numpy():
    """A JAX momentum tree crosses by ``params_from_numpy`` as the
    parameters do, so both packages step from one state."""
    jcfg, tcfg = configs("float32", **SMALL)
    params = ref.init_params(jax.random.PRNGKey(0), jcfg)
    x, y = (np.asarray(a) for a in ref.synthetic_batch(
        jax.random.PRNGKey(1), jcfg, 4))
    _, jm, _ = jax.jit(ref.make_train_step(jcfg))(
        params, ref.init_momentum(params), (x, y))
    tm = port.params_from_numpy({k: np.asarray(v) for k, v in jm.items()},
                                tcfg, "cpu")
    assert all(np.array_equal(tm[k].numpy(), np.asarray(jm[k])) for k in jm)
    zero = port.init_momentum(port.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, tcfg, "cpu"))
    assert all(float(v.abs().max()) == 0.0 and v.dtype == torch.float32
               for v in zero.values())
