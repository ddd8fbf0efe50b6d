"""The forecaster's matrix products (``chanamq_tpu_torch.kernels.products``:
``Product``, ``ProductGelu``, ``Head`` and the wrappers under them)
against the JAX package's expressions, on the CPU.

The same numpy inputs, made from fixed seeds, go through the reference's
own expression for each product site of ``chanamq_tpu/models/
forecaster.py::forward`` (``jnp.einsum`` of the activation and the weight
cast to the activation's dtype; ``h +`` it; ``jax.nn.gelu`` of it; the
float32 head ``last @ W``) and through the port's op, and their
gradients through ``jax.vjp`` and torch autograd. On CPU tensors the
wrappers run their plain versions; the CUDA kernels are held against
those on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``'s ``[products]``).

Tolerances, max abs error:
- float32: ``F32_RTOL`` (1e-5) of the largest sum of the terms'
  magnitudes (``|a| @ |b|``), for each output and each gradient: the same
  float32 products summed in another order.
- bfloat16, a product (the embed, qkv, and every gradient of a product
  whose cotangent both sides share): one bf16 step at the output's
  largest value. Both round the float32 sum once (measured: equal).
- bfloat16, an epilogue (the residual add, GELU): two steps at the larger
  of the largest output and the largest product: the product may already
  be a step apart, and the epilogue rounds again. JAX computes GELU in
  bf16 with bf16 constants, which costs about one step more: three.
- bfloat16, the gradients through GELU: the cotangent of the product
  (GELU's backward) differs by up to ``GELU_STEPS`` steps of its largest
  value (JAX differentiates GELU op by op in bf16;
  ``tests/test_torch_forecaster_train.py``), and a product sums those
  differences: within that many steps times the largest sum of the other
  operand's magnitudes, plus one step of the output.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from chanamq_tpu_torch.kernels import build
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.kernels import products as pk
from chanamq_tpu_torch.models import forecaster as port

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
OPS = {"kernels": fk.KERNELS, "plain": fk.PLAIN}
F32_RTOL = 1e-5
GELU_STEPS = 6.0
SMALL = dict(seq_len=8, d_model=32, n_heads=4, d_ff=64, n_layers=2)
# (batch, window, K, N) of the bf16 sites: the embed (K = n_features: 8,
# and 10 at queue-top-k 1), a qkv, and a w2
SHAPES = [(2, 8, 8, 32), (2, 8, 32, 96), (3, 5, 64, 32), (2, 8, 10, 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside other test files on every core; one torch
    thread keeps them from crowding out their neighbours' timing-sensitive
    tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def steps(n: float, *arrays) -> float:
    """``n`` bf16 steps at the largest magnitude in ``arrays``."""
    top = max(float(np.abs(np.asarray(a, np.float64)).max()) for a in arrays)
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def terms(a: np.ndarray, b: np.ndarray) -> float:
    """The largest sum of the terms' magnitudes of ``a @ b`` (2-D)."""
    return float((np.abs(np.asarray(a, np.float64))
                  @ np.abs(np.asarray(b, np.float64))).max())


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().cpu().numpy()
    return np.asarray(t, np.float64)


def assert_close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def inputs(seed: int, b: int, t: int, k: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(b, t, k)).astype(np.float32),
            "w": (rng.normal(size=(k, n)) / math.sqrt(k)).astype(np.float32),
            "h": rng.normal(size=(b, t, n)).astype(np.float32),
            "dy": rng.normal(size=(b, t, n)).astype(np.float32)}


def jax_site(site: str, jdt):
    """The reference's expression for a site (forecaster.py:106-118):
    ``f(x, w[, h])`` with the weight cast to the activations' dtype."""
    def product(x, w):
        return jnp.einsum("btd,de->bte", x, w.astype(jdt))
    if site == "product":
        return product
    if site == "gelu":
        return lambda x, w: jax.nn.gelu(product(x, w))
    return lambda x, w, h: h + product(x, w)


def port_site(site: str, ops):
    if site == "product":
        return ops.product
    if site == "gelu":
        return ops.product_gelu
    return lambda x, w, h: ops.product(x, w, h)


# -- each site against the reference ----------------------------------------------


@pytest.mark.parametrize("ops", list(OPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", ["product", "residual", "gelu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_site_matches_jax(shape, site, dtype, ops):
    jdt, tdt = DTYPES[dtype]
    d = inputs(sum(shape), *shape)
    args = [d["x"], d["w"]] + ([d["h"]] if site == "residual" else [])
    # the reference casts the float32 weight to the activations' dtype
    want = np.asarray(jax_site(site, jdt)(
        *(jnp.asarray(a) if a is d["w"] else jnp.asarray(a, jdt)
          for a in args)), np.float32)
    targs = [torch.from_numpy(a).to(tdt) for a in args]
    got = port_site(site, OPS[ops])(*targs)
    assert got.dtype == tdt and got.shape == want.shape
    x2 = _np(targs[0]).reshape(-1, shape[2])
    if dtype == "float32":
        tol = F32_RTOL * terms(x2, _np(targs[1]))
    elif site == "product":
        tol = steps(1, want)
    else:
        plain = _np(pk.bf16_product_ref(targs[0].reshape(-1, shape[2]),
                                        targs[1]))
        tol = steps(3 if site == "gelu" else 2, want, plain)
    assert_close(got, want, tol, site)


@pytest.mark.parametrize("ops", list(OPS))
def test_head_matches_jax(ops):
    rng = np.random.default_rng(5)
    last = rng.normal(size=(3, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 8)) / math.sqrt(32)).astype(np.float32)
    want = np.asarray(jnp.asarray(last) @ jnp.asarray(w))
    got = OPS[ops].head(torch.from_numpy(last), torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert_close(got, want, F32_RTOL * terms(last, w))


# -- each Function's gradients against jax.vjp ---------------------------------


@pytest.mark.parametrize("ops", list(OPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", ["product", "residual", "gelu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_site_vjp_matches_jax(shape, site, dtype, ops):
    """dX, dW (the weight a float32 leaf cast inside, as the train step
    casts it) and the residual's cotangent, against ``jax.vjp`` of the
    reference's expression."""
    jdt, tdt = DTYPES[dtype]
    _, _, k, n = shape
    d = inputs(sum(shape) + 1, *shape)
    jargs = [jnp.asarray(d["x"], jdt), jnp.asarray(d["w"])] + (
        [jnp.asarray(d["h"], jdt)] if site == "residual" else [])
    _, vjp = jax.vjp(jax_site(site, jdt), *jargs)
    want = vjp(jnp.asarray(d["dy"], jdt))
    leaves = [torch.from_numpy(d["x"]).to(tdt).requires_grad_(),
              torch.from_numpy(d["w"]).requires_grad_()] + (
        [torch.from_numpy(d["h"]).to(tdt).requires_grad_()]
        if site == "residual" else [])
    out = port_site(site, OPS[ops])(leaves[0], leaves[1].to(tdt),
                                    *leaves[2:])
    dy = torch.from_numpy(d["dy"]).to(tdt)
    got = torch.autograd.grad(out, leaves, dy)
    x2 = _np(leaves[0].detach().to(tdt)).reshape(-1, k)
    w2 = _np(leaves[1].detach().to(tdt))
    dy2 = _np(dy).reshape(-1, n)
    if site == "gelu":
        u = leaves[0].detach().to(tdt).reshape(-1, k)
        pre = pk.bf16_product_ref(u, leaves[1].detach().to(tdt))
        dy2 = _np(fk.gelu_tanh_bwd_ref(dy.reshape(-1, n), pre))
    # dx = dy2 w^T, dw = x^T dy2; with GELU dy2 is the product's cotangent,
    # GELU_STEPS steps apart in bf16, and each output sums those
    # differences over a row of w (dx) or a column of x (dw)
    for name, g, w_, f32_terms, spread_sum in (
            ("dx", got[0], want[0], terms(dy2, w2.T),
             np.abs(w2).sum(axis=1).max()),
            ("dw", got[1], want[1], terms(x2.T, dy2),
             np.abs(x2).sum(axis=0).max())):
        if dtype == "float32":
            tol = F32_RTOL * f32_terms
        elif site != "gelu":
            tol = steps(1, w_)
        else:
            tol = steps(GELU_STEPS, dy2) * float(spread_sum) + steps(1, w_)
        assert g.dtype == (tdt if name == "dx" else torch.float32)
        assert_close(g, w_, tol, name)
    if site == "residual":
        assert torch.equal(got[2], dy)
        assert float(np.abs(_np(want[2]) - _np(dy)).max()) == 0.0


@pytest.mark.parametrize("ops", list(OPS))
def test_head_vjp_matches_jax(ops):
    rng = np.random.default_rng(6)
    last = rng.normal(size=(3, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 8)) / math.sqrt(32)).astype(np.float32)
    dy = rng.normal(size=(3, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: a @ b, jnp.asarray(last), jnp.asarray(w))
    want_dl, want_dw = vjp(jnp.asarray(dy))
    tl = torch.from_numpy(last).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    dl, dw = torch.autograd.grad(OPS[ops].head(tl, tw), (tl, tw),
                                 torch.from_numpy(dy))
    assert_close(dl, want_dl, F32_RTOL * terms(dy, w.T))
    assert_close(dw, want_dw, F32_RTOL * terms(last.T, dy))


def test_embed_input_gets_no_gradient():
    """The embed's input is the data: its product computes dW alone, one
    call of the wrapper in the backward."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    w.requires_grad_()
    out = fk.KERNELS.product(x.bfloat16(), w.bfloat16())
    calls = []
    real = pk.bf16_product
    pk.bf16_product = lambda *a: calls.append(a[2]) or real(*a)
    try:
        (dw,) = torch.autograd.grad(out, (w,), torch.ones_like(out))
    finally:
        pk.bf16_product = real
    assert calls == ["tn"] and dw.shape == (8, 16)


# -- the forward and the step through either op set ------------------------------


def _small(dtype=torch.bfloat16):
    return port.ForecasterConfig(dtype=dtype, **SMALL)


def test_forward_takes_every_product_through_its_ops():
    """A forward calls ``ops.product`` 1 + 4 a layer times (the embed; qkv,
    proj, w1 through ``product_gelu``, w2), the residual in proj's and
    w2's epilogue, and the head once; ``gelu_tanh`` never."""
    cfg = _small()
    params = port.init_params(3, cfg, "cpu")
    x, _ = port.synthetic_batch(np.random.default_rng(3), cfg, 2, "cpu")
    calls = {"product": [], "product_gelu": 0, "head": 0, "gelu_tanh": 0}

    def product(x, w, residual=None):
        calls["product"].append(residual is not None)
        return fk.KERNELS.product(x, w, residual)

    def count(name):
        def fn(*a):
            calls[name] += 1
            return getattr(fk.KERNELS, name)(*a)
        return fn

    ops = fk.KERNELS._replace(product=product, **{
        k: count(k) for k in ("product_gelu", "head", "gelu_tanh")})
    got = port.forward(params, x, cfg, ops=ops)
    assert torch.equal(got, port.forward(params, x, cfg))
    layers = cfg.n_layers
    assert len(calls["product"]) == 1 + 3 * layers
    assert sum(calls["product"]) == 2 * layers
    assert (calls["product_gelu"], calls["head"], calls["gelu_tanh"]) == (
        layers, 1, 0)


def test_tensor_parallel_adds_after_leave():
    """Where ``tp.leave`` is not the identity (a tp rank, whose row-split
    product is a partial sum), the residual is added after it, outside the
    epilogue; with a leave that changes nothing, the forward is the one-
    device forward bit for bit (the epilogue rounds where the add does)."""
    cfg = _small()
    params = port.init_params(4, cfg, "cpu")
    x, _ = port.synthetic_batch(np.random.default_rng(4), cfg, 2, "cpu")
    residuals = []

    def product(x, w, residual=None):
        residuals.append(residual is not None)
        return fk.KERNELS.product(x, w, residual)

    tp = port.TensorParallel(cfg.n_heads, lambda t: t, lambda t: t * 1)
    got = port.forward(params, x, cfg, tp=tp,
                       ops=fk.KERNELS._replace(product=product))
    assert not any(residuals)
    assert torch.equal(got, port.forward(params, x, cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_and_plain_op_sets_give_the_same_step(dtype):
    """``make_train_step`` through ``KERNELS`` (each product's explicit
    backward) and through ``PLAIN`` (torch autograd of the plain
    versions), from one state on one batch, 3 steps: every tree within
    ``chip_smoke.tree_limits`` after each, the same losses within the
    forward's limit."""
    _assert_same_step(_small(dtype), 5)


def _assert_same_step(cfg, seed: int) -> None:
    params = port.init_params(seed, cfg, "cpu")
    data = port.synthetic_batch(np.random.default_rng(seed), cfg, 4, "cpu")
    p_k = {k: v.clone() for k, v in params.items()}
    p_r = {k: v.clone() for k, v in params.items()}
    m_k, m_r = port.init_momentum(p_k), port.init_momentum(p_r)
    kern = port.make_train_step(cfg, ops=fk.KERNELS)
    plain = port.make_train_step(cfg, ops=fk.PLAIN)
    dm_sum: dict = {}
    for step in range(1, 4):
        _, _, lk = kern(p_k, m_k, data)
        _, _, lr = plain(p_r, m_r, data)
        assert abs(float(lk) - float(lr)) <= chip_smoke.FORWARD_LIMIT
        trees = chip_smoke.tree_limits(p_k, p_r, m_k, m_r, 1e-3, dm_sum,
                                       step)
        bad = {(n, kind): v for n, t in trees.items()
               for kind, v in t.items() if not v[0] <= v[1]}
        assert not bad, (step, bad)


def test_op_sets_give_the_same_step_at_ragged_features():
    """The same as above at 10 features (the service at queue-top-k 1),
    whose embed has K = 10 and its dW M = 10, in bf16."""
    _assert_same_step(port.ForecasterConfig(n_features=10, **SMALL), 6)


# -- what the kernels refuse --------------------------------------------------------


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version, and
    the launch counts stay at 0 for CPU calls."""
    before = (pk.bf16_product.launches, pk.f32_product.launches)
    meta = torch.zeros(64, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pk.bf16_product(meta, torch.zeros(256, 64, dtype=torch.bfloat16,
                                          device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        pk.f32_product(meta.float(), torch.zeros(256, 8, device="meta"))
    cpu = torch.zeros(64, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        pk.prepare_bf16_product(cpu, cpu.t().contiguous())
    pk.bf16_product(cpu, cpu.t().contiguous())
    pk.f32_product(cpu.float(), cpu.float().t())
    assert (pk.bf16_product.launches, pk.f32_product.launches) == before


@pytest.fixture
def checks_on_the_cpu(monkeypatch):
    """The kernels' own checks (``prepare_*``) run on CPU tensors: the
    device check passes them, and every case below is refused before the
    library would be built."""
    monkeypatch.setattr(build, "cuda_device", lambda name, t: t.device)
    monkeypatch.setattr(pk, "library", lambda: pytest.fail(
        "a refused call reached the library"))


BAD = {
    "float32 operands": (TypeError, lambda bf: (
        torch.zeros(64, 256), torch.zeros(256, 64))),
    "bf16 head": (TypeError, None),
    "non-contiguous b": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf),
        torch.zeros(64, 256, dtype=bf).t())),
    "N not a multiple of 8": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf), torch.zeros(256, 60, dtype=bf))),
    "a layout the kernel lacks": (ValueError, lambda bf: (
        torch.zeros(256, 64, dtype=bf), torch.zeros(64, 256, dtype=bf),
        "tt")),
    "operands that do not meet": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf), torch.zeros(248, 64, dtype=bf))),
    "an epilogue outside nn": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf), torch.zeros(64, 256, dtype=bf),
        "nt", None, True)),
    "GELU and a residual": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf), torch.zeros(256, 64, dtype=bf),
        "nn", torch.zeros(64, 64, dtype=bf), True)),
    "a residual of another shape": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf), torch.zeros(256, 64, dtype=bf),
        "nn", torch.zeros(64, 56, dtype=bf))),
    "a kept pre-activation without GELU": (ValueError, lambda bf: (
        torch.zeros(64, 256, dtype=bf), torch.zeros(256, 64, dtype=bf),
        "nn", None, False, True)),
    "not 16-byte aligned": (ValueError, lambda bf: (
        torch.zeros(64 * 256 + 1, dtype=bf)[1:].view(64, 256),
        torch.zeros(256, 64, dtype=bf))),
}


@pytest.mark.parametrize("case", list(BAD))
def test_kernel_checks_refuse(checks_on_the_cpu, case):
    err, make = BAD[case]
    if make is None:  # the float32 kernel takes float32 only
        with pytest.raises(err):
            pk.prepare_f32_product(torch.zeros(2, 256, dtype=torch.bfloat16),
                                   torch.zeros(256, 8, dtype=torch.bfloat16))
        return
    with pytest.raises(err):
        pk.prepare_bf16_product(*make(torch.bfloat16))


class _ReachedTheLibrary(Exception):
    pass


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_kernel_checks_take_ragged_rows(checks_on_the_cpu, monkeypatch,
                                        layout):
    """A K (or, in ``tn``, an M) that is not a multiple of 8 passes the
    checks: the feature count at queue-top-k 1 is 10, the embed's K and
    its dW's M."""
    def reached():
        raise _ReachedTheLibrary
    monkeypatch.setattr(pk, "library", reached)
    bf = torch.bfloat16
    a, b = {"nn": ((64, 10), (10, 64)), "nt": ((64, 10), (64, 10)),
            "tn": ((64, 10), (64, 256))}[layout]
    with pytest.raises(_ReachedTheLibrary):
        pk.prepare_bf16_product(torch.zeros(a, dtype=bf),
                                torch.zeros(b, dtype=bf), layout)


def test_product_limits_by_hand():
    """``chip_smoke``'s limits and work counts for the products: one bf16
    step of the output, two of the larger magnitude with an epilogue; the
    head's relative limit of its terms; the bytes and operations."""
    bf = torch.bfloat16
    a = torch.full((4, 16), 0.5, dtype=bf)
    b = torch.full((16, 8), 0.25, dtype=bf)
    want = pk.bf16_product_ref(a, b)  # every value 2.0
    assert chip_smoke.product_limit("bf16_product", (a, b, "nn"),
                                    want) == 2.0 ** -6
    h = torch.full((4, 8), 5.0, dtype=bf)
    out = pk.bf16_product_ref(a, b, "nn", h)  # 7.0
    assert chip_smoke.product_limit("bf16_product", (a, b, "nn", h), out,
                                    want) == 2 * 2.0 ** -5
    f = (a.float(), b.float(), "nn")
    assert chip_smoke.product_limit("f32_product", f, None) == \
        pytest.approx(chip_smoke.HEAD_RTOL * 2.0)
    nbytes, ops, _ = chip_smoke.product_work("bf16_product",
                                             (a, b, "nn", h))
    assert nbytes == 2 * (4 * 16 + 16 * 8 + 4 * 8) + 2 * 4 * 8
    assert ops == 2 * 4 * 8 * 16 + 4 * 8
    nbytes, ops, _ = chip_smoke.product_work(
        "bf16_product", (a, b, "nn", None, True, True))
    assert nbytes == 2 * (4 * 16 + 16 * 8 + 2 * 4 * 8)
    assert ops == 2 * 4 * 8 * 16 + 9 * 4 * 8
    nbytes, ops, _ = chip_smoke.product_work("f32_product", f)
    assert (nbytes, ops) == (4 * (4 * 16 + 16 * 8 + 4 * 8), 2 * 4 * 8 * 16)


def test_chip_smoke_products_phase_rehearsal():
    """chip_smoke's [products] phase on the CPU at a tiny width: every
    site, layout and epilogue within its limit (on the CPU the wrapper is
    its plain version: exactly), with its bound; the flagship's forward
    and gradient batches, the compact model and a tp = 4 rank."""
    cfg = port.ForecasterConfig(seq_len=8, d_model=32, n_heads=4, d_ff=64,
                                n_layers=1)
    res = chip_smoke.phase_products(torch.device("cpu"), 0, cfg,
                                    batches=(1, 2), grad_batches=(2,))
    sites = {(label, site) for label, site, _ in res}
    assert {("flagship", s) for s in ("embed", "qkv", "proj+residual",
                                      "w1+gelu", "w2+residual", "head",
                                      "embed dW", "qkv dX", "w2 dW",
                                      "w1+gelu keeping preact",
                                      "head dX", "head dW")} <= sites
    assert {label for label, _ in sites} == {"flagship", "compact", "tp4",
                                             "topk1"}
    embed = res[("topk1", "embed dW", chip_smoke.TRAIN_BATCHES[0])]
    assert embed["shape"].startswith(f"{chip_smoke.TRAIN_BATCHES[0] * 8}x"
                                     f"{chip_smoke.TOPK_FEATURES} tn")
    for row in res.values():
        assert row["max_abs_err"] == 0.0 and row["bound_ms"] > 0
        assert "ms" not in row  # times come from a card only
        if row["kernel"] == "bf16_product":  # each site's plan
            a0, a1, layout, b0, b1 = re.match(
                r"(\d+)x(\d+) (\w+) (\d+)x(\d+)", row["shape"]).groups()
            m, k = (int(a1), int(a0)) if layout[0] == "t" else (int(a0),
                                                                 int(a1))
            n = int(b0) if layout[1] == "t" else int(b1)
            assert (row["tile"], row["splits"]) == (pk.tile_rows(m, n, k),
                                                    pk.split_k(m, n, k))
    tp4 = res[("tp4", "qkv", chip_smoke.TRAIN_BATCHES[0])]
    assert tp4["shape"].endswith(f"32x{3 * 32 // 4}")


# -- the bf16 kernel's launch plan ----------------------------------------------


def _flagship_sites(b: int) -> dict:
    """{site: (M, N, K)} of every flagship bf16 product at batch ``b``:
    the forward's (nn) and the gradients' dX (nt) and dW (tn)."""
    cfg = port.ForecasterConfig()
    rows, d, f, nf = b * cfg.seq_len, cfg.d_model, cfg.d_ff, cfg.n_features
    out = {}
    for site, (k, n) in {"embed": (nf, d), "qkv": (d, 3 * d),
                         "proj": (d, d), "w1": (d, f), "w2": (f, d)}.items():
        out[site] = (rows, n, k)
        if site != "embed":
            out[f"{site} dX"] = (rows, k, n)
        out[f"{site} dW"] = (k, n, rows)
    return out


PLAN_SHAPES = sorted({(m, n, k) for b in (1, 16, 32)
                      for m, n, k in _flagship_sites(b).values()}
                     | {(m, n, k) for m in (1, 8, 10, 63, 65, 2048)
                        for n in (8, 24, 768)
                        for k in (8, 10, 16, 1000, 2048)})


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_split_k_is_a_plan_of_the_shape(m, n, k):
    """``split_k`` and ``tile_rows`` are pure functions of the shape: the
    same answer twice, a 64- or 128-row tile, 1 to ``MAX_SPLITS`` blocks,
    and, when K is split, every block's share at least two 64-deep ring
    stages."""
    s, tile = pk.split_k(m, n, k), pk.tile_rows(m, n, k)
    assert (s, tile) == (pk.split_k(m, n, k), pk.tile_rows(m, n, k))
    assert tile in (64, 128) and 1 <= s <= pk.MAX_SPLITS
    stages = -(-k // pk.K_STAGE)
    if s > 1:
        assert stages // s >= 2, (m, n, k, s)
        # the split never takes the tiles past one wave of the card
        assert -(-m // tile) * -(-n // tile) * s <= pk.SMS


@pytest.mark.parametrize("b", [1, 16, 32])
def test_split_k_fills_the_card_where_the_tiles_do_not(b):
    """At the flagship's shapes: no split where the output tiles alone
    fill the card; K split for w2 at B = 1 (four 64 x 64 tiles, K =
    1,024) and for every weight gradient at the training batches (K = B
    * T rows)."""
    for site, (m, n, k) in _flagship_sites(b).items():
        tile = pk.tile_rows(m, n, k)
        tiles = -(-m // tile) * -(-n // tile)
        s = pk.split_k(m, n, k)
        if tiles >= pk.SMS:
            assert s == 1, site
        if (b == 1 and site == "w2") or (b > 1 and site.endswith("dW")):
            assert s > 1, (site, b, s)


def test_prepare_refuses_a_split_the_kernel_lacks(checks_on_the_cpu):
    bf = torch.bfloat16
    for s in (0, pk.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            pk.prepare_bf16_product(torch.zeros(64, 256, dtype=bf),
                                    torch.zeros(256, 64, dtype=bf),
                                    splits=s)
