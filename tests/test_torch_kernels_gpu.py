"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the router match kernels, the forecaster's layernorm, causal
attention, tanh-GELU and matrix products (forward, gradients, the GELU
and residual epilogues, the float32 head), their backward passes and the
train step's clipped momentum update. Marked ``gpu``; skipped where no CUDA device is
present. Run on a machine with a card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

(``--junitxml`` keeps each JAX comparison's measured error as a test
property.)

Each router kernel is also held against the JAX package's own kernel body
(``_topic_kernel(np, ...)``, ``_headers_kernel(np, ...)``) on the same
numpy inputs. The outputs are integer bitmasks, so the comparison is exact,
at every instance (1, 2 and 4 messages a block) and at odd shapes: one
message, rows not a multiple of 32, one mask word, no row and every row
matching, a headers table of one pair id and one of 4,096.
Each forecaster kernel is held to its plain version within
``chip_smoke.forecaster_limit`` (one bf16 step at the largest output, two
for attention: the same float32 math summed in another order), and the
whole forward through the kernels to the forward through the plain
versions within ``chip_smoke.FORWARD_LIMIT``.

The attention forward's warpgroup kernel, which its wrapper takes from
T = 128 at head widths that are multiples of 16 up to 128, is held at the
flagship's training call and forecast, ragged windows and widths 16, 32
and 128, its row statistics and output fed to the backward, and its launch
counter at T = 2,048 and T = 64. The backward's long-window pair, which
its wrapper takes at the same shapes, is held at the flagship's training
call, at latent attention's widths (q and k 192, v 128), at T = 128 and at
ragged windows of 200 and 257 rows, twice for the same bits, with its
launch counter, its shared memory against the library's and its build's
register report (no spill, no serialized wgmma).

Both attention kernels and the layernorm backward are also launched twice
on the same inputs and must give the same bits, the attention kernels also
at windows past the limits they had when they held a head whole (T = 400,
897, 1,024 and 2,048 at head widths 16 and 64), and the launch geometry the
wrappers compute (``kernels/forecaster.py``'s ``attention_geometry`` and
``layernorm_geometry``, held on the CPU by
``tests/test_torch_attention_tiles.py`` and
``tests/test_torch_layernorm_rows.py``) must equal what the C libraries
compute. Both layernorm kernels are also held at every row geometry (one
row to a ragged 2,049, widths 8 to 1,024), and the layernorm backward's
kept counter over 100 calls.

The training kernels are held to their plain versions within
``chip_smoke.hold_train_kernel``'s limits (the update bit for bit at the
kernel's clip scale), and the flagship train step through the kernels to
the JAX package's jitted ``step`` within the limits the CPU tests hold the
plain versions to (``tests/test_torch_forecaster_train.py``).

The forecaster kernels and the kernel-path forward are also held against
the JAX package's own functions (``_layernorm``, ``_attention``,
``jax.nn.gelu``, the jitted ``forward`` on its ``init_params(PRNGKey(0))``)
run on the CPU beside the card, on the same numpy-made inputs.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from chanamq_tpu.router import compile as ref_compile
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.kernels import products as pk
from chanamq_tpu_torch.kernels import router_match as rm
from chanamq_tpu_torch.kernels import update as upd
from chanamq_tpu_torch.models import forecaster as port_fc
from chanamq_tpu_torch.router.tables import tables_from_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# (N rows, W mask words, B messages, token widths): the router's caps at
# full token widths, the shapes chip_smoke's main path gives the kernels
# (topic P=8, S=4; headers 512 rows over 16 mask words, R=4, H=8), odd
# sizes, and one table wider than a block's 512 threads so the row loop
# runs three times
TOPIC_SHAPES = [(512, 128, 1024, 8, 8), (512, 128, 16, 8, 8),
                (512, 128, 512, 8, 4), (37, 3, 5, 8, 8), (1, 1, 1, 2, 2),
                (1500, 7, 33, 8, 8)]
HEADERS_SHAPES = [(512, 128, 1024, 8, 16), (512, 128, 16, 8, 16),
                  (512, 16, 512, 4, 8), (37, 3, 5, 8, 16), (1, 1, 1, 2, 2),
                  (1500, 7, 33, 8, 16)]


def _hold_router(name: str, args, b: int, w: int) -> torch.Tensor:
    """One call ``(table, *messages)`` through the wrapper (one launch)
    and through each messages-a-block instance of the kernel, every word
    equal to the plain version's. Returns the wrapper's output."""
    kern = getattr(rm, name)
    ref = getattr(rm, f"{name}_ref")
    prepare = getattr(rm, f"prepare_{name}")
    before = kern.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = ref(*args)
    assert got.dtype == torch.int32 and got.shape == (b, w)
    assert torch.equal(got, want)
    for mb in rm.MSGS_PER_BLOCK:
        out, launch = prepare(*args, mb=mb)
        launch()
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"{mb} messages a block"
    return got


@pytest.mark.parametrize("n,w,b,p,s", TOPIC_SHAPES)
def test_topic_kernel_matches_plain(cuda, n, w, b, p, s):
    rng = np.random.default_rng(n * 1000 + w)
    table = chip_smoke.topic_tables(rng, n, w, p, s)
    t = tables_from_numpy(table, cuda)
    msg_np = chip_smoke.topic_messages(rng, table, b)
    msg = [torch.from_numpy(a).to(cuda) for a in msg_np]
    got = _hold_router("topic_match", (t, *msg), b, w)
    # and the JAX package's own kernel body on the same numpy inputs
    ref = ref_compile._topic_kernel(
        np, table["pre"], table["suf"], table["plen"], table["slen"],
        table["has_hash"], table["masks"], *msg_np)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref)


@pytest.mark.parametrize("n,w,b,r,h", HEADERS_SHAPES)
def test_headers_kernel_matches_plain(cuda, n, w, b, r, h):
    rng = np.random.default_rng(n * 1000 + w + 1)
    table = chip_smoke.headers_tables(rng, n, w, r)
    t = tables_from_numpy(table, cuda)
    pids_np = chip_smoke.headers_messages(rng, table, b, h)
    got = _hold_router("headers_match",
                       (t, torch.from_numpy(pids_np).to(cuda)), b, w)
    ref = ref_compile._headers_kernel(
        np, table["req"], table["rcount"], table["is_all"], table["masks"],
        pids_np)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref)


ODD_ROUTER_CASES = ["one-message", "rows-not-a-multiple-of-32",
                    "one-mask-word", "no-row-matches", "every-row-matches"]


def _random_masks(rng, n: int, w: int) -> np.ndarray:
    masks = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
    return (masks & rng.integers(0, 2**32, size=(n, w),
                                 dtype=np.uint64)).astype(np.uint32)


def _literal_topic_table(rng, n: int, w: int, cell: int) -> dict:
    """Rows of one word, ``cell`` (STAR) or a literal each, no '#'."""
    pre = np.full((n, 8), chip_smoke.PAD, np.int32)
    pre[:, 0] = cell if cell == chip_smoke.STAR else rng.integers(0, 64, n)
    return {"pre": pre, "suf": np.full((n, 8), chip_smoke.PAD, np.int32),
            "plen": np.ones(n, np.int32), "slen": np.zeros(n, np.int32),
            "has_hash": np.zeros(n, bool), "masks": _random_masks(rng, n, w)}


@pytest.mark.parametrize("case", ODD_ROUTER_CASES)
def test_topic_kernel_odd_shapes(cuda, case):
    rng = np.random.default_rng(len(case))
    n, w, b = {"one-message": (512, 128, 1),
               "rows-not-a-multiple-of-32": (45, 5, 16),
               "one-mask-word": (64, 1, 16)}.get(case, (96, 3, 16))
    if case in ("no-row-matches", "every-row-matches"):
        star = case == "every-row-matches"
        table = _literal_topic_table(rng, n, w, chip_smoke.STAR if star
                                     else 0)
        # one-word keys; out of vocabulary where no row may match
        pre_m = np.full((b, 8), chip_smoke.MISS, np.int32)
        if star:
            pre_m[:, 0] = rng.integers(0, 64, b)
        msgs = (pre_m, pre_m.copy(), np.ones(b, np.int32))
    else:
        table = chip_smoke.topic_tables(rng, n, w)
        msgs = tuple(a[:b] for a in chip_smoke.topic_messages(
            rng, table, max(b, 16)))
    t = tables_from_numpy(table, cuda)
    got = _hold_router("topic_match",
                       (t, *(torch.from_numpy(a).to(cuda) for a in msgs)),
                       b, w)
    every = np.bitwise_or.reduce(table["masks"], axis=0).view(np.int32)
    if case == "no-row-matches":
        assert not got.any()
    elif case == "every-row-matches":
        assert (got.cpu().numpy() == every[None, :]).all()


@pytest.mark.parametrize("case", ODD_ROUTER_CASES + ["one-pair-id",
                                                      "pair-ids-at-caps"])
def test_headers_kernel_odd_shapes(cuda, case):
    rng = np.random.default_rng(len(case) + 100)
    n, w, b = {"one-message": (512, 128, 1),
               "rows-not-a-multiple-of-32": (45, 5, 16),
               "one-mask-word": (64, 1, 16),
               "pair-ids-at-caps": (512, 128, 64)}.get(case, (96, 3, 16))
    pad, miss = chip_smoke.PAD, chip_smoke.MISS
    if case in ("no-row-matches", "every-row-matches", "one-pair-id"):
        # every row requires id 0 (all or any): messages without it match
        # none, messages with it match every row; 0 is the only id
        req = np.full((n, 8), pad, np.int32)
        req[:, 0] = 0
        table = {"req": req, "rcount": np.ones(n, np.int32),
                 "is_all": rng.random(n) < 0.5,
                 "masks": _random_masks(rng, n, w)}
        pids = np.full((b, 16), miss, np.int32)
        if case != "no-row-matches":
            pids[:, 3] = 0
            pids[::2, 5] = 7  # an id past the table's: in no row
    elif case == "pair-ids-at-caps":
        # 4,096 distinct pair ids, every id of the router's caps (N R)
        req = rng.permutation(n * 8).astype(np.int32).reshape(n, 8)
        k = rng.integers(1, 9, n)
        req[np.arange(8)[None, :] >= k[:, None]] = pad
        table = {"req": req, "rcount": k.astype(np.int32),
                 "is_all": rng.random(n) < 0.5,
                 "masks": _random_masks(rng, n, w)}
        pids = np.full((b, 16), miss, np.int32)
        for i in range(b):
            row = req[rng.integers(0, n)]
            got_ids = [int(x) for x in row if x != pad][:int(
                rng.integers(1, 9))]
            got_ids += [int(x) for x in rng.integers(0, n * 8 + 64, 16 -
                                                     len(got_ids))]
            pids[i, :len(got_ids)] = got_ids[:16]
    else:
        table = chip_smoke.headers_tables(rng, n, w)
        pids = chip_smoke.headers_messages(rng, table, max(b, 16))[:b]
    t = tables_from_numpy(table, cuda)
    if case == "pair-ids-at-caps":
        assert t.vocab == n * 8
    elif case == "one-pair-id":
        assert t.vocab == 1
    got = _hold_router("headers_match",
                       (t, torch.from_numpy(pids).to(cuda)), b, w)
    ref = ref_compile._headers_kernel(
        np, table["req"], table["rcount"], table["is_all"], table["masks"],
        pids)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref)
    every = np.bitwise_or.reduce(table["masks"], axis=0).view(np.int32)
    if case == "no-row-matches":
        assert not got.any()
    elif case == "every-row-matches":
        assert (got.cpu().numpy() == every[None, :]).all()


def test_kernel_rejects_bad_input(cuda):
    table = chip_smoke.topic_tables(np.random.default_rng(0), 8, 1)
    t = tables_from_numpy(table, cuda)
    pre_m, suf_m, mlen = (torch.from_numpy(a).to(cuda) for a in
                          chip_smoke.topic_messages(
                              np.random.default_rng(1), table, 4))
    with pytest.raises(TypeError):
        rm.topic_match(t, pre_m.long(), suf_m, mlen)
    with pytest.raises(ValueError):
        rm.topic_match(t, pre_m.cpu(), suf_m, mlen)
    with pytest.raises(ValueError):  # a message of another token width
        rm.topic_match(t, pre_m[:, :3].contiguous(), suf_m, mlen)
    with pytest.raises(TypeError):  # the table is checked at upload
        rm.topic_table(t.pre.long(), t.suf, t.plen, t.slen, t.has_hash,
                       t.masks)


# (B, T, d_model, heads, d_ff): the flagship at the service's batch and
# __graft_entry__'s, the tests' small config, odd batch and window, a head
# width of 6 (odd pairs a row), and a window of 200 at head width 128
# (above 48 KB of shared memory)
FORECASTER_SHAPES = [(1, 64, 256, 4, 1024), (32, 64, 256, 4, 1024),
                     (2, 8, 32, 4, 64), (3, 33, 64, 2, 100),
                     (2, 17, 12, 2, 25), (1, 200, 256, 2, 8)]


@pytest.mark.parametrize("b,t,d,heads,f", FORECASTER_SHAPES)
def test_forecaster_kernels_match_plain(cuda, b, t, d, heads, f):
    cfg = port_fc.ForecasterConfig(seq_len=t, d_model=d, n_heads=heads,
                                   d_ff=f)
    gen = torch.Generator().manual_seed(b * 1000 + t)
    inputs = chip_smoke.forecaster_inputs(gen, cfg, b, cuda)
    for name in chip_smoke.FORECASTER_KERNELS:
        args = inputs[name]
        if name == "layernorm" and d % 8:
            with pytest.raises(ValueError):
                fk.layernorm(*args)
            continue
        kern = getattr(fk, name)
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        want = getattr(fk, f"{name}_ref")(*args)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= chip_smoke.forecaster_limit(name, want), (name, err)


@pytest.mark.parametrize("b", [1, 32])
def test_forecaster_forward_matches_plain(cuda, b):
    port_fc.set_matmul_precision()
    cfg = port_fc.ForecasterConfig()
    params = port_fc.init_params(0, cfg, cuda)
    x, _ = port_fc.synthetic_batch(np.random.default_rng(b), cfg, b, cuda)
    counted = (fk.layernorm, fk.causal_attention, fk.gelu_tanh,
               pk.bf16_product, pk.f32_product)
    before = tuple(w.launches for w in counted)
    got = port_fc.forward(params, x, cfg)
    torch.cuda.synchronize()
    # GELU rides in w1's epilogue: no standalone GELU launch; 17 bf16
    # products (the embed, four a layer) and the float32 head
    assert tuple(w.launches for w in counted) == tuple(
        n + k for n, k in zip(before, (8, 4, 0, 17, 1)))
    want = port_fc.forward(params, x, cfg, ops=fk.PLAIN)
    assert got.shape == (b, 8) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= chip_smoke.FORWARD_LIMIT


def test_forecaster_kernels_reject_bad_input(cuda):
    x = torch.zeros(2, 64, 256, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):  # bf16 only
        fk.layernorm(x, torch.ones(256, device=cuda))
    with pytest.raises(TypeError):
        fk.gelu_tanh(x)
    with pytest.raises(ValueError):  # scale on the wrong device
        fk.layernorm(x.bfloat16(), torch.ones(256))
    with pytest.raises(ValueError):  # not [B, T, 3 * heads * head_dim]
        fk.causal_attention(torch.zeros(2, 64, 100, dtype=torch.bfloat16,
                                        device=cuda), 4)
    with pytest.raises(ValueError):  # not contiguous
        fk.gelu_tanh(torch.zeros(64, 32, dtype=torch.bfloat16,
                                 device=cuda).t())



# -- the forecaster against the JAX package -------------------------------------


# the forward's batches: the service's window, and __graft_entry__'s batch
JAX_FORWARD_BATCHES = (1, 32)
# against the JAX package, max abs error: two bf16 steps at the op's
# largest output (one from a float32 sum taken in another order, one more
# as JAX computes GELU in bf16 with bf16 constants), and for the forward
# the limit the CPU tests hold the plain path to
JAX_OP_STEPS = 2


def jax_kernel_inputs() -> dict:
    """The kernels' inputs at the service's flagship shapes (batch 1),
    float32 numpy from a fixed seed: ``ln_x`` and ``ln_scale``; ``attn_a``
    and ``attn_w``, whose bf16 product the reference's ``_attention``
    forms; ``gelu_x``. The bf16 inputs are these rounded to bf16, by torch
    and by JAX alike."""
    rng = np.random.default_rng(2024)
    cfg = port_fc.ForecasterConfig()
    t, d, f = cfg.seq_len, cfg.d_model, cfg.d_ff

    def normal(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.normal(size=shape)).astype(np.float32)

    return {"ln_x": normal(1, t, d, std=2.0, mean=0.5),
            "ln_scale": normal(d, std=0.1, mean=1.0),
            "attn_a": normal(1, t, d),
            "attn_w": normal(d, 3 * d, std=d ** -0.5),
            "gelu_x": normal(1, t, f, std=2.0)}


def _bf16_from_jax(a) -> torch.Tensor:
    bits = np.asarray(a).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def jax_kernel_outputs(inputs: dict) -> dict:
    """The JAX package's functions on ``inputs``, on the CPU, as bf16 CPU
    tensors: ``_layernorm``; the fused qkv product (``fused``) and
    ``_attention``'s core, which is ``_attention`` with an identity
    ``proj`` (a product with one non-zero term changes no bf16 value);
    ``jax.nn.gelu``."""
    import jax
    import jax.numpy as jnp

    from chanamq_tpu.models import forecaster as ref

    cfg = ref.ForecasterConfig()
    bf16 = jnp.bfloat16
    a = jnp.asarray(inputs["attn_a"], bf16)
    w = jnp.asarray(inputs["attn_w"])
    out = {
        "layernorm": ref._layernorm(jnp.asarray(inputs["ln_x"], bf16),
                                    jnp.asarray(inputs["ln_scale"])),
        # the expression _attention's first line evaluates
        "fused": jnp.einsum("btd,de->bte", a, w.astype(bf16)),
        "causal_attention": ref._attention(
            a, w, jnp.eye(cfg.d_model, dtype=jnp.float32), cfg),
        "gelu_tanh": jax.nn.gelu(jnp.asarray(inputs["gelu_x"], bf16)),
    }
    return {k: _bf16_from_jax(v) for k, v in out.items()}


def jax_forward(b: int) -> tuple:
    """The JAX package's flagship ``forward`` (jitted, on the CPU) on its
    own ``init_params(PRNGKey(0))`` and a window of ``b`` from a numpy
    seed. Returns (parameters as numpy, x, the forecast)."""
    import jax

    from chanamq_tpu.models import forecaster as ref

    cfg = ref.ForecasterConfig()
    params = ref.init_params(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(b).normal(
        size=(b, cfg.seq_len, cfg.n_features)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: ref.forward(p, x, cfg))(
        params, x))
    return {k: np.asarray(v) for k, v in params.items()}, x, want


def kernel_args_for_jax(name: str, inputs: dict, outputs: dict,
                        device) -> tuple:
    """A forecaster kernel's arguments for ``jax_kernel_inputs()``: the
    attention takes the reference's own fused product, so both sides
    start from the same bits."""
    bf16 = torch.bfloat16
    if name == "layernorm":
        return (torch.from_numpy(inputs["ln_x"]).to(device, bf16),
                torch.from_numpy(inputs["ln_scale"]).to(device))
    if name == "causal_attention":
        return (outputs["fused"].to(device),
                port_fc.ForecasterConfig().n_heads)
    return (torch.from_numpy(inputs["gelu_x"]).to(device, bf16),)


def jax_op_limit(want: torch.Tensor) -> float:
    return JAX_OP_STEPS * chip_smoke.bf16_ulp(
        float(want.float().abs().max()))


@pytest.mark.parametrize("name", chip_smoke.FORECASTER_KERNELS)
def test_forecaster_kernels_match_jax(cuda, record_property, name):
    """Each kernel on the card against the JAX package's function on the
    same bf16 inputs at the service's flagship shapes."""
    inputs = jax_kernel_inputs()
    outputs = jax_kernel_outputs(inputs)
    kern = getattr(fk, name)
    before = kern.launches
    got = kern(*kernel_args_for_jax(name, inputs, outputs, cuda))
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = outputs[name]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = float((got.cpu().float() - want.float()).abs().max())
    record_property("max_abs_err", err)
    record_property("limit", jax_op_limit(want))
    assert err <= jax_op_limit(want), (name, err)


@pytest.mark.parametrize("b", JAX_FORWARD_BATCHES)
def test_forecaster_forward_matches_jax(cuda, record_property, b):
    """The flagship forward through the kernels on the card against the
    JAX package's jitted forward on the CPU, on the JAX package's
    ``init_params(PRNGKey(0))`` carried across by ``params_from_numpy``."""
    port_fc.set_matmul_precision()
    params, x, want = jax_forward(b)
    cfg = port_fc.ForecasterConfig()
    got = port_fc.forward(port_fc.params_from_numpy(params, cfg, cuda),
                          torch.from_numpy(x).to(cuda), cfg)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float(np.abs(got.cpu().numpy() - want).max())
    record_property("max_abs_err", err)
    record_property("max_abs_out", float(np.abs(want).max()))
    assert err <= chip_smoke.FORWARD_LIMIT, err


def test_forward_refuses_reduced_precision_products(cuda):
    """With torch's default bf16 reductions the products would not
    accumulate in float32 as the reference's do: forward raises."""
    cfg = port_fc.ForecasterConfig(seq_len=8, d_model=32, n_heads=4,
                                   d_ff=64, n_layers=1)
    params = port_fc.init_params(0, cfg, cuda)
    x = torch.zeros(1, 8, 8, device=cuda)
    flags = torch.backends.cuda.matmul
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        with pytest.raises(RuntimeError, match="set_matmul_precision"):
            port_fc.forward(params, x, cfg)
    finally:
        port_fc.set_matmul_precision()
    assert torch.isfinite(port_fc.forward(params, x, cfg)).all()


# -- the matrix products ----------------------------------------------------------


COMPACT = {"d_model": 64, "n_heads": 4, "d_ff": 256, "n_layers": 2}
# (config, batch, tp ranks): the flagship's forward batches (M = 64 and
# 2,048) and training batch, a tp = 4 rank's shapes (qkv 192 columns,
# proj K = 64, w1 256 columns, w2 K = 256), the compact default model at
# its long window (M = 1,024) and at B = 64 there (M = 65,536), rows
# that are not whole tiles (M = 15, 1), and feature counts that are not a
# multiple of 8 (the embed's K and its dW's M: 10 at queue-top-k 1, 14 at
# 3, 3)
PRODUCT_CASES = [({}, 1, 1), ({}, 32, 1), ({}, 16, 1), ({}, 16, 4),
                 ({**COMPACT, "seq_len": 1024}, 1, 1),
                 ({**COMPACT, "seq_len": 1024}, 64, 1),
                 ({"seq_len": 5}, 3, 1), ({"seq_len": 1}, 1, 1),
                 ({"n_features": 10}, 1, 1), ({"n_features": 10}, 16, 1),
                 ({**COMPACT, "n_features": 14, "seq_len": 5}, 3, 1),
                 ({**COMPACT, "n_features": 3}, 2, 1)]


@pytest.mark.parametrize("grads", [False, True])
@pytest.mark.parametrize("kw,b,tp", PRODUCT_CASES)
def test_products_match_plain(cuda, kw, b, tp, grads):
    """Every product site, layout and epilogue (``chip_smoke.product_sites``:
    the forward's, or the gradients' with w1's GELU keeping its
    pre-activation) against its plain version within
    ``chip_smoke.product_limit``, one launch a call, and the same bits
    from a second launch."""
    cfg = port_fc.ForecasterConfig(**kw)
    gen = torch.Generator().manual_seed(b * 10 + tp)
    sites = chip_smoke.product_sites(gen, cfg, b, cuda, tp=tp, grads=grads)
    for site, (name, args) in sites.items():
        kern = getattr(pk, name)
        before = kern.launches
        chip_smoke.hold_product(name, args, timed=False)
        torch.cuda.synchronize()
        assert kern.launches == before + 1, site
        first, again = kern(*args), kern(*args)
        for x, y in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (first, again))):
            assert torch.equal(x, y), site


# The bf16 kernel's edges: rows around its 64- and 128-row tiles (one,
# eight, ten, 63, 65, 2,048), columns under and over a 64-wide block, K
# under one 16-deep wgmma step, under and over its 64-deep stages and
# splits; rows of 10, 63 and 65 values (not a multiple of 16 bytes) come
# through the staging the kernel does by hand in place of TMA
EDGE_M = [1, 8, 10, 63, 65, 2048]
EDGE_N = [8, 24, 768]
EDGE_K = [8, 10, 16, 1000, 2048]
# (layout, epilogue arguments after the layout) of every instance
EDGE_CALLS = [("nn", ()), ("nn", ("residual",)), ("nn", (None, True)),
              ("nn", (None, True, True)), ("nt", ()), ("tn", ())]


@pytest.mark.parametrize("splits", [1, 2, 8, None])
@pytest.mark.parametrize("m", EDGE_M)
def test_products_at_the_design_edges(cuda, m, splits):
    """Every layout and epilogue of the bf16 kernel at M = ``m`` over
    ``EDGE_N`` x ``EDGE_K``, with K split over 1, 2 or 8 blocks of a
    cluster (``prepare_bf16_product``'s test-only ``splits``) or as the
    wrapper plans it (None): within ``chip_smoke.product_limit`` of the
    plain version, and two launches give the same bits."""
    port_fc.set_matmul_precision()  # the plain versions in float32
    gen = torch.Generator().manual_seed(m * 10 + (splits or 0))

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(cuda)

    for n in EDGE_N:
        for k in EDGE_K:
            for layout, extra in EDGE_CALLS:
                a = randn(k, m) if layout == "tn" else randn(m, k)
                b = randn(n, k) if layout == "nt" else randn(k, n)
                extra = tuple(randn(m, n) if e == "residual" else e
                              for e in extra)
                args = (a, b, layout, *extra)
                what = f"M={m} N={n} K={k} {layout} {extra[1:]} S={splits}"
                outs, launch = pk.prepare_bf16_product(*args, splits=splits)
                outs = outs if isinstance(outs, tuple) else (outs,)
                launch()
                first = [o.clone() for o in outs]
                launch()
                torch.cuda.synchronize()
                for x, y in zip(first, outs):
                    assert torch.equal(x, y), what
                want = pk.bf16_product_ref(*args)
                want = want if isinstance(want, tuple) else (want,)
                plain = (pk.bf16_product_ref(a, b, layout)
                         if extra and extra[0] is not None or len(extra) > 1
                         else None)
                err = (first[0].float() - want[0].float()).abs().max()
                limit = chip_smoke.product_limit("bf16_product", args,
                                                 want[0], plain)
                assert float(err) <= limit, (what, float(err), limit)
                if len(want) == 2:  # the kept pre-activation
                    err = (first[1].float() - want[1].float()).abs().max()
                    assert float(err) <= chip_smoke.product_limit(
                        "bf16_product", args, want[1]), what


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
@pytest.mark.parametrize("k", [1, 8, 33, 64, 100, 128, 256, 300])
def test_head_kernel_sums_over_lanes(cuda, k, layout):
    """The float32 kernel at every lane group K gives (one lane under 64,
    groups of 8 and 16, a whole warp; a lane's last terms short at 100 and
    300): within
    ``chip_smoke.product_limit`` of the plain version, the same bits from
    two launches."""
    port_fc.set_matmul_precision()
    gen = torch.Generator().manual_seed(k)
    m, n = 5, 8
    a = torch.randn((k, m) if layout == "tn" else (m, k), generator=gen)
    b = torch.randn((n, k) if layout == "nt" else (k, n), generator=gen)
    args = (a.to(cuda), b.to(cuda), layout)
    got, again = pk.f32_product(*args), pk.f32_product(*args)
    assert torch.equal(got, again)
    want = pk.f32_product_ref(*args)
    assert float((got - want).abs().max()) <= chip_smoke.product_limit(
        "f32_product", args, want)


def test_products_reject_bad_input(cuda):
    bf16 = torch.bfloat16
    a = torch.zeros(64, 256, dtype=bf16, device=cuda)
    w = torch.zeros(256, 768, dtype=bf16, device=cuda)
    with pytest.raises(TypeError):  # bf16 only
        pk.bf16_product(a.float(), w.float())
    with pytest.raises(TypeError):  # float32 only
        pk.f32_product(a, w)
    with pytest.raises(ValueError):  # not contiguous
        pk.bf16_product(a, w.t().contiguous().t())
    with pytest.raises(ValueError):  # N not a multiple of 8
        pk.bf16_product(a, w[:, :12].contiguous())
    with pytest.raises(ValueError):  # a layout the kernel lacks
        pk.bf16_product(a, w.t().contiguous(), "tt")
    with pytest.raises(ValueError):  # an epilogue in another layout
        pk.bf16_product(a, w.t().contiguous(), "nt", None, True)
    with pytest.raises(ValueError):  # a residual of another shape
        pk.bf16_product(a, w, "nn", a)
    with pytest.raises(ValueError):  # not 16-byte aligned
        pk.bf16_product(torch.zeros(64 * 256 + 1, dtype=bf16,
                                    device=cuda)[1:].view(64, 256), w)
    with pytest.raises(ValueError):  # operands that do not meet
        pk.f32_product(torch.zeros(2, 256, device=cuda),
                       torch.zeros(255, 8, device=cuda))
    with pytest.raises(ValueError):  # on the CPU a kernel's own path
        pk.prepare_bf16_product(a.cpu(), w.cpu())


def test_forecast_service_at_queue_top_k_1(cuda):
    """The service at queue-top-k 1 (10 features: the embed's K and its
    dW's M not a multiple of 8) trains and forecasts on the card through
    the product kernels, every forward replayed against the plain path
    (``chip_smoke.py``'s ``[forecast-topk]``, at fewer rounds)."""
    before = pk.bf16_product.launches
    res = chip_smoke.phase_forecast(
        cuda, model_kwargs=dict(COMPACT), interval_s=0.005,
        steps_per_round=4, batch=4, min_rounds=2, queue_top_k=1,
        timeout_s=120.0)
    assert res["cfg"].n_features == chip_smoke.TOPK_FEATURES
    assert res["steps"] >= 4 and np.isfinite(res["loss"])
    assert res["replay_max_abs_err"] <= chip_smoke.FORWARD_LIMIT
    assert pk.bf16_product.launches > before


# -- the training kernels --------------------------------------------------------


# (B, T, d_model, heads, d_ff): the flagship at the service's training batch
# and __graft_entry__'s, the tests' small config, odd batch and window, a
# head width of 6 (odd pairs a row), three heads of 8 at an odd window,
# a window of 100 at head width 128 (above 48 KB of shared memory), and
# the flagship at a batch of 1, where the attention backward's split into
# tiles carries the whole parallelism (16 blocks)
TRAIN_SHAPES = [(16, 64, 256, 4, 1024), (32, 64, 256, 4, 1024),
                (2, 8, 32, 4, 64), (3, 33, 64, 2, 100), (2, 17, 12, 2, 25),
                (1, 13, 24, 3, 8), (1, 100, 128, 1, 8),
                (1, 64, 256, 4, 1024)]


@pytest.mark.parametrize("b,t,d,heads,f", TRAIN_SHAPES)
def test_train_kernels_match_plain(cuda, b, t, d, heads, f):
    """Each training kernel against its plain version within
    ``chip_smoke.hold_train_kernel``'s limits (the update bit for bit at
    the kernel's scale, with the clip active), one launch each (two for
    attention's backward, its row pass and its main kernel; two for
    the update)."""
    cfg = port_fc.ForecasterConfig(seq_len=t, d_model=d, n_heads=heads,
                                   d_ff=f)
    gen = torch.Generator().manual_seed(b * 1000 + t + 1)
    inputs = chip_smoke.train_inputs(gen, cfg, b, cuda)
    counted = chip_smoke.counted_wrappers()
    for name in chip_smoke.TRAIN_KERNELS:
        args = inputs[name]
        if name == "layernorm_bwd" and d % 8:
            with pytest.raises(ValueError):
                fk.layernorm_bwd(*args)
            continue
        before = counted[name].launches
        chip_smoke.hold_train_kernel(name, args, timed=False)
        torch.cuda.synchronize()
        assert counted[name].launches == before + {
            "clip_momentum_sgd": 2,
            "causal_attention_bwd": fk.ATT_BWD_LAUNCHES}.get(name, 1)


# (B, T, d_model, heads): the flagship forward (the service's batch), the
# flagship backward (the training batch), and an odd shape (head width 6,
# two tiles, the last one ragged)
DETERMINISM_SHAPES = [(1, 64, 256, 4), (16, 64, 256, 4), (2, 17, 12, 2)]


@pytest.mark.parametrize("b,t,d,heads", DETERMINISM_SHAPES)
def test_attention_kernels_are_deterministic(cuda, b, t, d, heads):
    """Two launches of each attention kernel on the same inputs give the
    same bits: no float atomics, every sum in a fixed order."""
    cfg = port_fc.ForecasterConfig(seq_len=t, d_model=d, n_heads=heads,
                                   d_ff=4 * d)
    gen = torch.Generator().manual_seed(b * 1000 + t + 2)
    qkv, dout, _, stats, _ = chip_smoke.train_inputs(gen, cfg, b, cuda)[
        "causal_attention_bwd"]
    # the forward's row statistics: its two planes (the third is the
    # backward row pass's)
    kept = 2 * stats.numel() // fk.ATT_STATS
    outs = [(fk.causal_attention(qkv, heads),
             fk.causal_attention_with_stats(qkv, heads)[1][:kept],
             fk.causal_attention_bwd(qkv, dout, heads, stats))
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*outs):
        assert torch.equal(first, second)
    # the forward gives the same bits whether it keeps the statistics or
    # not, and the backward's main kernel on four warps or on eight
    assert torch.equal(outs[0][0],
                       fk.causal_attention_with_stats(qkv, heads)[0])
    for warps in (4, 8):
        dqkv, launch = fk.prepare_causal_attention_bwd(qkv, dout, heads,
                                                       stats, warps=warps)
        launch()
        torch.cuda.synchronize()
        assert torch.equal(dqkv, outs[0][2]), warps


# windows past every limit the kernels had when they held a head whole
# (T > 320 at head width 64 in the backward, T > 896 at width 16), at the
# flagship's head width and the service's compact default's
LONG_WINDOWS = [400, 897, 1024, 2048]


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("t", LONG_WINDOWS)
def test_attention_kernels_take_any_window(cuda, t, hd):
    """Both attention kernels at long windows against their plain versions
    within chip_smoke's limits (the forward at B = 1, the backward at
    B = 16 below T = 2,048 and B = 4 at it), one launch of the forward
    and two of the backward a call, and two calls giving the same
    bits."""
    cfg = port_fc.ForecasterConfig(seq_len=t, d_model=4 * hd, n_heads=4,
                                   d_ff=16 * hd)
    gen = torch.Generator().manual_seed(t * 100 + hd)
    qkv = chip_smoke.forecaster_inputs(gen, cfg, 1, cuda)[
        "causal_attention"]
    before = fk.causal_attention.launches
    chip_smoke.hold_forecaster("causal_attention", qkv, timed=False)
    assert fk.causal_attention.launches == before + 1
    b = 16 if t < 2048 else 4
    bwd = chip_smoke.train_inputs(gen, cfg, b, cuda)["causal_attention_bwd"]
    before = fk.causal_attention_bwd.launches
    chip_smoke.hold_train_kernel("causal_attention_bwd", bwd, timed=False)
    assert fk.causal_attention_bwd.launches == before + fk.ATT_BWD_LAUNCHES
    for fn, args in ((fk.causal_attention, qkv), (fk.causal_attention_bwd,
                                                  bwd)):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


# (T, head width) of heads too wide for slots of four tiles: two tiles a
# slot (384, 512, 576) or one (592, 880), at windows of one slot, of a few
# and of many; and, in windows of one tile, heads too wide even for that
# (a ring of one slot: 1,000 and the widest, 1,776)
WIDE_HEADS = [(64, 384), (16, 512), (130, 576), (100, 592), (32, 880),
              (9, 1000), (16, 1776)]


@pytest.mark.parametrize("t,hd", WIDE_HEADS)
def test_attention_kernels_take_wide_heads(cuda, t, hd):
    """Both attention kernels at head widths whose ring slots hold two
    tiles or one, or whose ring has one slot (the backward's rings then
    its own tiles), against their plain versions within chip_smoke's
    limits (two heads; the forward at B = 1, the backward at B = 2), and
    two calls giving the same bits."""
    cfg = port_fc.ForecasterConfig(seq_len=t, d_model=2 * hd, n_heads=2,
                                   d_ff=8)
    g = fk.attention_geometry(t, hd)
    assert g.stage < fk.ATT_WARPS and (g.slots == 1) == (hd > 880)
    gen = torch.Generator().manual_seed(t * 1000 + hd)
    qkv = chip_smoke.forecaster_inputs(gen, cfg, 1, cuda)[
        "causal_attention"]
    chip_smoke.hold_forecaster("causal_attention", qkv, timed=False)
    bf16 = torch.bfloat16
    bwd = chip_smoke.attention_bwd_inputs(
        torch.randn(2, t, 6 * hd, generator=gen).to(bf16).to(cuda),
        torch.randn(2, t, 2 * hd, generator=gen).to(bf16).to(cuda), 2)
    chip_smoke.hold_train_kernel("causal_attention_bwd", bwd, timed=False)
    for fn, args in ((fk.causal_attention, qkv), (fk.causal_attention_bwd,
                                                  bwd)):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_attention_geometry_matches_launchers(cuda):
    """The shared memory ``attention_geometry`` gives each kernel is what
    its C library computes, at every shape these tests run (the launchers
    refuse a geometry that differs from their own)."""
    lib, tlib = fk.library(), fk.train_library()
    shapes = [(t, 4 * hd, 4) for t in LONG_WINDOWS for hd in (16, 64)] + [
        (t, 2 * hd, 2) for t, hd in WIDE_HEADS]
    for t, d, heads in [s[1:4] for s in FORECASTER_SHAPES + TRAIN_SHAPES] \
            + shapes:
        g = fk.attention_geometry(t, d // heads)
        assert lib.chana_causal_attention_smem(t, d // heads) == g.fwd_smem
        assert tlib.chana_causal_attention_bwd_smem(t, d // heads) == \
            g.bwd_smem
        assert tlib.chana_causal_attention_bwd_stats_smem(t, d // heads) \
            == g.stats_smem


# (B, T, head width, heads) the warpgroup kernel takes: the flagship's
# training call and its forecast (B = 1), ragged windows of 400 and 897
# rows, and head widths 16, 32 and 128
WARPGROUP_SHAPES = [(16, 2048, 64, 4), (1, 2048, 64, 4), (2, 400, 64, 4),
                    (2, 897, 64, 4), (16, 1024, 16, 4), (4, 600, 32, 4),
                    (2, 1000, 128, 2)]


@pytest.mark.parametrize("b,t,hd,heads", WARPGROUP_SHAPES)
def test_warpgroup_attention_matches_plain(cuda, b, t, hd, heads):
    """The long-window forward, which the wrapper takes from the shape,
    against ``causal_attention_ref`` within ``chip_smoke``'s attention
    limit; two launches and the launch that keeps the statistics give the
    same bits; those statistics and that output, fed to the backward (the
    long-window pair), give dqkv within its limit of
    ``causal_attention_bwd_ref``. Each call counts as one launch of the
    forward and one of the warpgroup kernel."""
    g = fk.attention_warpgroup_geometry(b, t, hd, heads)
    assert g is not None and g.blocks == b * heads * -(-t // fk.WG_ROWS)
    cfg = port_fc.ForecasterConfig(seq_len=t, d_model=heads * hd,
                                   n_heads=heads, d_ff=8)
    gen = torch.Generator().manual_seed(t * 10 + hd + b)
    qkv, _ = args = chip_smoke.forecaster_inputs(gen, cfg, b, cuda)[
        "causal_attention"]
    before = (fk.causal_attention.launches,
              fk.causal_attention.warpgroup_launches)
    chip_smoke.hold_forecaster("causal_attention", args, timed=False)
    assert (fk.causal_attention.launches,
            fk.causal_attention.warpgroup_launches) == tuple(
                n + 1 for n in before)
    first, second = fk.causal_attention(*args), fk.causal_attention(*args)
    out, stats = fk.causal_attention_with_stats(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, out)
    dout = torch.randn(b, t, heads * hd, generator=gen).to(
        torch.bfloat16).to(cuda)
    chip_smoke.hold_train_kernel("causal_attention_bwd",
                                 (qkv, dout, heads, stats, out), timed=False)


@pytest.mark.parametrize("hd,heads", [(64, 4), (32, 4), (128, 2)])
def test_warpgroup_attention_keeps_the_16_row_statistics(cuda, hd, heads):
    """At a window both kernels take (forced through ``warpgroup``), the
    warpgroup kernel's row maxima equal the 16-row kernel's and its sums
    lie within float32 rounding of theirs (a running sum, rescaled at
    every new max), rows past T included; the outputs agree within the
    attention limit. Widths 32 and 128 divide the logits by sqrt(HD), not
    a power of two."""
    b, t = 2, 400
    gen = torch.Generator().manual_seed(17 + hd)
    qkv = torch.randn(b, t, 3 * heads * hd, generator=gen).to(
        torch.bfloat16).to(cuda)
    got = {}
    for warpgroup in (False, True):
        (out, stats), launch = fk.prepare_causal_attention(
            qkv, heads, keep_stats=True, warpgroup=warpgroup)
        assert launch.warpgroup == warpgroup
        launch()
        got[warpgroup] = out, stats.view(fk.ATT_STATS, -1)[:2]
    torch.cuda.synchronize()
    want = fk.causal_attention_ref(qkv, heads)
    out, (m, l) = got[True]
    assert torch.equal(m, got[False][1][0])
    torch.testing.assert_close(l, got[False][1][1], rtol=1e-5, atol=0)
    err = float((out.float() - want.float()).abs().max())
    assert err <= chip_smoke.forecaster_limit("causal_attention", want)


def test_warpgroup_attention_wide_logit_spans(cuda):
    """Rows whose logits span more than ``kQuotientSpan`` (64) form their
    weights with the division itself, the others with the row's
    reciprocal: with every other row's q scaled by 40 (logits spanning
    hundreds there), both within every warp, the kernel holds to the plain
    version within the attention limit, and its row maxima equal the
    16-row kernel's."""
    b, t, hd, heads = 2, 300, 64, 2
    gen = torch.Generator().manual_seed(23)
    qkv = torch.randn(b, t, 3 * heads * hd, generator=gen)
    qkv[:, ::2, :heads * hd] *= 40
    qkv = qkv.to(torch.bfloat16).to(cuda)
    got = {}
    for warpgroup in (False, True):
        (out, stats), launch = fk.prepare_causal_attention(
            qkv, heads, keep_stats=True, warpgroup=warpgroup)
        launch()
        got[warpgroup] = out, stats.view(fk.ATT_STATS, -1)[:2]
    torch.cuda.synchronize()
    want = fk.causal_attention_ref(qkv, heads)
    out, (m, l) = got[True]
    assert torch.equal(m, got[False][1][0])
    torch.testing.assert_close(l, got[False][1][1], rtol=1e-5, atol=0)
    err = float((out.float() - want.float()).abs().max())
    assert err <= chip_smoke.forecaster_limit("causal_attention", want)


def test_warpgroup_launches_count_only_long_windows(cuda):
    """``warpgroup_launches`` rises with a forward at T = 2,048 and stays
    where it is at T = 64, where the 16-row kernel runs; ``launches``
    counts both."""
    bf16 = torch.bfloat16
    for t, taken in ((2048, 1), (64, 0)):
        qkv = torch.zeros(1, t, 3 * 256, dtype=bf16, device=cuda)
        before = (fk.causal_attention.launches,
                  fk.causal_attention.warpgroup_launches)
        fk.causal_attention(qkv, 4)
        fk.causal_attention_with_stats(qkv, 4)
        assert (fk.causal_attention.launches,
                fk.causal_attention.warpgroup_launches) == (
                    before[0] + 2, before[1] + 2 * taken)


def test_warpgroup_geometry_matches_launcher(cuda):
    """The shared memory ``attention_warpgroup_geometry`` gives is what
    the C library computes, at every head width it takes; a width it does
    not take gives 0."""
    lib = fk.library()
    for hd in range(16, fk.WG_MAX_HD + 1, 16):
        assert lib.chana_causal_attention_warpgroup_smem(hd) == \
            fk.WarpgroupGeometry.of(1, 2048, hd, 4).smem
    for hd in (8, 24, 144):
        assert lib.chana_causal_attention_warpgroup_smem(hd) == 0


# (B, T, q and k head width, heads, v width) of the backward's long-window
# pair: the flagship's training call, latent attention's (Moonlight's 16
# heads, q and k 192, v 128; B = 1 keeps it short), the shortest window,
# ragged windows of 200 rows at width 32 and of 257 (a last block of one
# row), and width 128 (two boxes)
WG_BWD_SHAPES = [(16, 2048, 64, 4, 64), (1, 2048, 192, 16, 128),
                 (2, 128, 64, 4, 64), (2, 200, 32, 2, 32),
                 (2, 257, 64, 1, 64), (1, 400, 128, 2, 128)]


@pytest.mark.parametrize("b,t,hd,heads,hdv", WG_BWD_SHAPES)
def test_warpgroup_backward_matches_plain(cuda, b, t, hd, heads, hdv):
    """The long-window backward pair, which the wrapper takes from the
    shape, on the statistics and output of the forward, against
    ``causal_attention_bwd_ref`` within ``chip_smoke``'s limit (four bf16
    steps at the largest output), latent attention's v heads zero past
    128; two calls give the same bits; a call counts two launches and one
    long-window call."""
    assert fk.attention_warpgroup_geometry(
        b, t, hd, heads, None if hdv == hd else hdv) is not None
    gen = torch.Generator().manual_seed(t * 10 + hd + b)
    qkv = torch.randn(b, t, 3 * heads * hd, generator=gen)
    qkv.view(b, t, 3, heads, hd)[:, :, 2, :, hdv:] = 0
    qkv = qkv.to(torch.bfloat16).to(cuda)
    out, stats = fk.causal_attention_with_stats(
        qkv, heads, None if hdv == hd else hdv)
    dout = torch.randn(b, t, heads * hdv, generator=gen).to(
        torch.bfloat16).to(cuda)
    args = (qkv, dout, heads, stats, out)
    before = (fk.causal_attention_bwd.launches,
              fk.causal_attention_bwd.warpgroup_launches)
    row = chip_smoke.hold_train_kernel("causal_attention_bwd", args,
                                       timed=False)
    first, second = (fk.causal_attention_bwd(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert (fk.causal_attention_bwd.launches,
            fk.causal_attention_bwd.warpgroup_launches) == (
                before[0] + 3 * fk.ATT_BWD_LAUNCHES, before[1] + 3)
    assert torch.equal(first, second)
    assert row["max_abs_err"] <= row["limit"]
    # the v heads' columns past the values are zeros
    assert not first.view(b, t, 3, heads, hd)[:, :, 2, :, hdv:].any()


def test_warpgroup_backward_counts_only_long_windows(cuda):
    """``causal_attention_bwd.warpgroup_launches`` counts every backward
    call through the training op from T = 128 and none at T = 64, where
    the 16-row pair runs; ``launches`` counts two launches either way."""
    bf16 = torch.bfloat16
    for t, taken in ((2048, 1), (128, 1), (64, 0)):
        qkv = torch.randn(2, t, 3 * 256, device=cuda).to(bf16)
        leaf = qkv.requires_grad_()
        got = fk.CausalAttention.apply(leaf, 4)
        before = (fk.causal_attention_bwd.launches,
                  fk.causal_attention_bwd.warpgroup_launches)
        torch.autograd.grad(got, leaf, torch.ones_like(got))
        torch.cuda.synchronize()
        assert (fk.causal_attention_bwd.launches,
                fk.causal_attention_bwd.warpgroup_launches) == (
                    before[0] + fk.ATT_BWD_LAUNCHES, before[1] + taken)


def test_warpgroup_backward_agrees_with_the_16_row_pair(cuda):
    """At a window both pairs take (forced through ``warpgroup``), the
    long-window pair and the 16-row pair each hold to the plain version
    within the limit, and to each other within twice it: D from the
    output in place of the 16-row pair's sum over the prefix."""
    b, t, hd, heads = 2, 300, 64, 2
    gen = torch.Generator().manual_seed(31)
    qkv = torch.randn(b, t, 3 * heads * hd, generator=gen).to(
        torch.bfloat16).to(cuda)
    dout = torch.randn(b, t, heads * hd, generator=gen).to(
        torch.bfloat16).to(cuda)
    out, stats = fk.causal_attention_with_stats(qkv, heads)
    want = fk.causal_attention_bwd_ref(qkv, dout, heads)
    limit = chip_smoke.TRAIN_STEPS["causal_attention_bwd"] * \
        chip_smoke.bf16_ulp(float(want.float().abs().max()))
    got = {}
    for warpgroup in (False, True):
        dqkv, launch = fk.prepare_causal_attention_bwd(
            qkv, dout, heads, stats.clone(), out, warpgroup=warpgroup)
        assert launch.warpgroup == warpgroup
        launch()
        got[warpgroup] = dqkv
    torch.cuda.synchronize()
    for dqkv in got.values():
        assert float((dqkv.float() - want.float()).abs().max()) <= limit
    assert float((got[True].float() - got[False].float()).abs().max()) <= \
        2 * limit


def test_warpgroup_backward_geometry_matches_launcher(cuda):
    """The shared memory ``WarpgroupBwdGeometry`` gives each kernel of the
    pair is what the C library computes, at every width pair it takes; a
    width it does not take gives 0."""
    tlib = fk.train_library()
    pairs = [(hd, hd) for hd in range(16, fk.WG_MAX_HD + 1, 16)] + [
        fk.WG_KV_WIDTHS]
    for hd, hdv in pairs:
        g = fk.WarpgroupBwdGeometry.of(1, 2048, hd, 4, hdv)
        assert tlib.chana_causal_attention_bwd_warpgroup_smem(
            hd, hdv, 0) == g.dq_smem
        assert tlib.chana_causal_attention_bwd_warpgroup_smem(
            hd, hdv, 1) == g.dkv_smem
    for hd, hdv in ((8, 8), (24, 24), (144, 144), (192, 192), (128, 64)):
        for dkv in (0, 1):
            assert tlib.chana_causal_attention_bwd_warpgroup_smem(
                hd, hdv, dkv) == 0


def test_warpgroup_backward_builds_without_spills(cuda, record_property):
    """The build's register report (``-Xptxas -v``) for each instance of
    both kernels of the pair: no spill, and no wgmma that ptxas
    serializes (its warnings name the function). The report is kept as a
    test property."""
    from chanamq_tpu_torch.kernels import build

    log = build.load("forecaster_train")[1].log
    for kernel in chip_smoke.WG_BWD_KERNELS:
        assert chip_smoke.ptxas_spills(log, kernel) == 0, kernel
        assert not [ln for ln in log.splitlines()
                    if "wgmma" in ln.lower() and kernel in ln], kernel
    report, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = any(f"{k}_kernel" in line
                         for k in chip_smoke.WG_BWD_KERNELS)
        if inside and re.search(r"entry|registers|spill", line):
            report.append(line.strip())
    assert len([ln for ln in report if "registers" in ln]) >= 6
    record_property("ptxas", "\n".join(report))


# (rows, width) for the layernorm kernels: one row and 7 rows (a single
# block), the service's forecast (B = 1: 8 blocks, one cluster), 130 rows
# (17 blocks, three clusters, the grid padded to 24), the training batch
# (B = 16: 128 blocks, 16 clusters), a ragged 2,049 rows (257 blocks
# padded to 264), many blocks (4,500 rows at a width of 512: 563 blocks;
# 16,384 rows: 2,048 blocks), the narrowest width at one and many rows,
# and the widest (64 KB of shared memory in the backward) at one, a few
# and a ragged 2,049 rows
LAYERNORM_SHAPES = [(1, 256), (7, 256), (64, 256), (130, 256), (1024, 256),
                    (2049, 256), (4500, 512), (16384, 256), (1, 8),
                    (1024, 8), (1, 1024), (130, 1024), (2049, 1024)]


def _layernorm_inputs(rows: int, d: int, device, seed: int) -> tuple:
    """(dy, x, scale) as ``chip_smoke.train_inputs`` makes them: x offset so
    the mean matters, a scale near 1."""
    gen = torch.Generator().manual_seed(seed)
    dy = torch.randn(rows, d, generator=gen).to(torch.bfloat16).to(device)
    x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(
        torch.bfloat16).to(device)
    return dy, x, (1 + 0.1 * torch.randn(d, generator=gen)).to(device)


def _dscale_limit(dy: torch.Tensor, x: torch.Tensor) -> float:
    """The float32 error of dscale's sum over its rows
    (``chip_smoke.hold_train_kernel``'s rows * 2^-24 of the largest
    column's sum of |dy * xhat|) and of each term's xhat (4 * 2^-24 of it:
    a sum of one row has no rounding of its own, but the kernel's rsqrtf
    and statistics put a few ulp in xhat)."""
    x32 = x.float()
    xhat = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
        x32.var(-1, unbiased=False, keepdim=True) + fk.EPS)
    terms = (dy.float() * xhat).abs().sum(0)
    return (x.shape[0] + 4) * 2.0 ** -24 * float(terms.max())


@pytest.mark.parametrize("rows,d", LAYERNORM_SHAPES)
def test_layernorm_kernels_at_odd_rows(cuda, rows, d):
    """Both layernorm kernels against their plain versions at every
    geometry: y and dx within one bf16 step at the largest output, dscale
    within ``_dscale_limit``; one launch each."""
    dy, x, scale = _layernorm_inputs(rows, d, cuda, rows * 10 + d)
    before = (fk.layernorm.launches, fk.layernorm_bwd.launches)
    y = fk.layernorm(x, scale)
    dx, ds = fk.layernorm_bwd(dy, x, scale)
    torch.cuda.synchronize()
    assert (fk.layernorm.launches, fk.layernorm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_y = fk.layernorm_ref(x, scale)
    want_dx, want_ds = fk.layernorm_bwd_ref(dy, x, scale)
    for got, want in ((y, want_y), (dx, want_dx)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        assert err <= chip_smoke.bf16_ulp(float(want.float().abs().max()))
    assert float((ds - want_ds).abs().max()) <= _dscale_limit(dy, x)


@pytest.mark.parametrize("rows,d", [(1024, 256), (2049, 256), (2049, 1024),
                                    (7, 256), (16384, 256)])
def test_layernorm_bwd_is_deterministic(cuda, rows, d):
    """Two launches of the layernorm backward on the same inputs give the
    same dx and dscale bits: no float atomics, every sum in a fixed order
    (the clusters' and the last block's included)."""
    dy, x, scale = _layernorm_inputs(rows, d, cuda, rows + d + 3)
    first = fk.layernorm_bwd(dy, x, scale)
    second = fk.layernorm_bwd(dy, x, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_layernorm_geometry_matches_launchers(cuda):
    """Both libraries compute the geometry ``layernorm_geometry`` gives at
    every shape these tests run, refuse the widths it refuses, and each
    launcher refuses a geometry other than its own."""
    import ctypes

    libs = (fk.library(), fk.train_library())
    out = (ctypes.c_int * 5)()
    for rows, d in LAYERNORM_SHAPES + [(2048, 256)]:
        g = fk.layernorm_geometry(rows, d)
        for lib in libs:
            assert lib.chana_layernorm_geometry(rows, d, out) == 1
            assert tuple(out) == tuple(g)
    for lib in libs:
        assert lib.chana_layernorm_geometry(64, 12, out) == 0
        assert lib.chana_layernorm_geometry(64, 1032, out) == 0
    dy, x, scale = _layernorm_inputs(1024, 256, cuda, 4)
    g = fk.layernorm_geometry(1024, 256)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    y = torch.empty_like(x)
    lib, tlib = libs
    invalid = 1  # cudaErrorInvalidValue
    assert lib.chana_layernorm(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                               1024, 256, fk.EPS, g.blocks + 1,
                               stream) == invalid
    partial = torch.zeros(g.clusters * 256, device=cuda)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    ds = torch.empty(256, device=cuda)
    for bad in ((g.blocks, 1, g.grid, g.bwd_smem),
                (g.blocks, g.cluster, g.grid + 8, g.bwd_smem),
                (g.blocks, g.cluster, g.grid, g.bwd_smem + 4)):
        assert tlib.chana_layernorm_bwd(
            dy.data_ptr(), x.data_ptr(), scale.data_ptr(), y.data_ptr(),
            partial.data_ptr(), ds.data_ptr(), counter.data_ptr(), 1024, 256,
            fk.EPS, *bad, stream) == invalid


def test_layernorm_bwd_reuses_its_scratch(cuda):
    """100 calls at the training batch's 1,024 rows and at 2,049 rows, each
    dscale right, through one counter that every launch leaves zero; a
    call launches the kernel and nothing else (``torch.profiler``)."""
    calls = []
    for i in range(100):
        rows = 1024 if i % 2 == 0 else 2049
        dy, x, scale = _layernorm_inputs(rows, 256, cuda, 100 + i)
        dx, ds = fk.layernorm_bwd(dy, x, scale)
        calls.append((dy, x, scale, ds))
    torch.cuda.synchronize()
    for dy, x, scale, ds in calls:
        _, want = fk.layernorm_bwd_ref(dy, x, scale)
        assert float((ds - want).abs().max()) <= _dscale_limit(dy, x)
    key = (cuda.index, torch.cuda.current_stream(cuda).cuda_stream)
    partial, counter = fk._LN_SCRATCH[key]
    assert int(counter.item()) == 0
    assert partial.numel() >= fk.layernorm_geometry(2049, 256).clusters * 256
    dy, x, scale, _ = calls[0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fk.layernorm_bwd(dy, x, scale)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "layernorm_bwd_kernel" in names[0], names
    assert fk._LN_SCRATCH[key][1] is counter


def test_update_kernel_without_clip(cuda):
    """``clip_norm=None``: one launch, s = 1, and the update bit for bit
    with the plain version."""
    cfg = port_fc.ForecasterConfig(seq_len=8, d_model=32, n_heads=4, d_ff=64)
    params, momentum, grads, lr, _ = chip_smoke.train_inputs(
        torch.Generator().manual_seed(5), cfg, 1, cuda)["clip_momentum_sgd"]
    p_k, m_k = [p.clone() for p in params], [m.clone() for m in momentum]
    before = upd.clip_momentum_sgd.launches
    s = upd.clip_momentum_sgd(p_k, m_k, grads, lr, None)
    torch.cuda.synchronize()
    assert upd.clip_momentum_sgd.launches == before + 1 and float(s) == 1.0
    assert float(upd.clip_momentum_sgd_ref(params, momentum, grads, lr,
                                           None)) == 1.0
    for a, b in zip(p_k + m_k, params + momentum):
        assert torch.equal(a, b)


def test_update_split_launches_match_plain(cuda):
    """The update's two launches apart, as the sharded step makes them, at
    the flagship's 29 tensors split into its sharded and replicated
    leaves: each sum of squares within float32 rounding of the plain one
    (``chip_smoke.SCALE_RTOL``), one launch each, and the update from the
    caller's ``sq`` bit for bit with the plain update at the kernel's clip
    scale, which is the plain scale from that ``sq`` within
    ``SCALE_RTOL``."""
    from chanamq_tpu_torch.models.forecaster import param_shapes
    from chanamq_tpu_torch.parallel.mesh import _spec_for

    cfg = port_fc.ForecasterConfig()
    params, momentum, grads, lr, clip = chip_smoke.train_inputs(
        torch.Generator().manual_seed(6), cfg, 16, cuda)["clip_momentum_sgd"]
    names = sorted(param_shapes(cfg))
    split = [i for i, n in enumerate(names) if _spec_for(n)]
    rest = [i for i in range(len(names)) if i not in split]
    before = (upd.sum_of_squares.launches, upd.momentum_sgd.launches)
    parts = []
    for idx in (split, rest):
        out = torch.empty(1, device=cuda)
        upd.sum_of_squares([grads[i] for i in idx], out)
        want = upd.sum_of_squares_ref([grads[i] for i in idx])
        assert abs(float(out) - float(want)) <= chip_smoke.SCALE_RTOL * float(
            want)
        parts.append(out)
    sq = parts[0] + parts[1]
    p_k, m_k = [p.clone() for p in params], [m.clone() for m in momentum]
    s_k = upd.momentum_sgd(p_k, m_k, grads, lr, sq, clip)
    p_r, m_r = [p.clone() for p in params], [m.clone() for m in momentum]
    s_r = upd.momentum_sgd_ref([p.clone() for p in params],
                               [m.clone() for m in momentum], grads, lr, sq,
                               clip)
    upd.momentum_sgd_ref(p_r, m_r, grads, lr, sq, clip, scale=s_k)
    torch.cuda.synchronize()
    assert (upd.sum_of_squares.launches, upd.momentum_sgd.launches) == (
        before[0] + 2, before[1] + 1)
    assert abs(float(s_k) - float(s_r)) <= chip_smoke.SCALE_RTOL * float(s_r)
    assert float(s_k) < 1.0
    for a, b in zip(p_k + m_k, p_r + m_r):
        assert torch.equal(a, b)


def test_train_kernels_reject_bad_input(cuda):
    bf16 = torch.bfloat16
    x = torch.zeros(2, 64, 256, device=cuda)
    scale = torch.ones(256, device=cuda)
    with pytest.raises(TypeError):  # bf16 only
        fk.layernorm_bwd(x, x, scale)
    with pytest.raises(TypeError):
        fk.gelu_tanh_bwd(x, x)
    xb = x.to(bf16)
    with pytest.raises(ValueError):  # dy's shape is not x's
        fk.gelu_tanh_bwd(xb[:1].contiguous(), xb)
    with pytest.raises(ValueError):  # scale on the wrong device
        fk.layernorm_bwd(xb, xb, torch.ones(256))
    qkv = torch.zeros(2, 64, 768, dtype=bf16, device=cuda)
    _, stats = fk.causal_attention_with_stats(qkv, 4)
    with pytest.raises(ValueError):  # dout is not [B, T, D]
        fk.causal_attention_bwd(qkv, torch.zeros(2, 64, 128, dtype=bf16,
                                                 device=cuda), 4, stats)
    dout = torch.zeros(2, 64, 256, dtype=bf16, device=cuda)
    with pytest.raises(ValueError):  # no row statistics from the forward
        fk.causal_attention_bwd(qkv, dout, 4)
    with pytest.raises(ValueError):  # statistics of another shape
        fk.causal_attention_bwd(qkv, dout, 4, stats[:-1])
    # any window: T=400 at head width 64 runs (its shared memory does not
    # depend on T); a head of 400 runs with slots of two tiles; only a
    # head too wide for slots of one tile (past 880, or past 1,776 in a
    # window of one tile) is refused
    for t, d, heads in ((400, 256, 4), (16, 400, 1)):
        qkv = torch.zeros(1, t, 3 * d, dtype=bf16, device=cuda)
        out, stats = fk.causal_attention_with_stats(qkv, heads)
        dout = torch.zeros(1, t, d, dtype=bf16, device=cuda)
        dqkv = fk.causal_attention_bwd(qkv, dout, heads, stats, out)
        torch.cuda.synchronize()
        assert dqkv.shape == (1, t, 3 * d) and not dqkv.any()
        if t >= fk.WG_MIN_T:  # the long-window pair reads the output
            with pytest.raises(ValueError, match="no forward output"):
                fk.causal_attention_bwd(qkv, dout, heads, stats)
    for t, hd in ((32, 896), (16, 1792)):  # over 227 KB
        with pytest.raises(ValueError):
            fk.causal_attention_bwd(
                torch.zeros(1, t, 3 * hd, dtype=bf16, device=cuda),
                torch.zeros(1, t, hd, dtype=bf16, device=cuda), 1)
    p = [torch.zeros(4, device=cuda)]
    with pytest.raises(TypeError):  # float32 only
        upd.clip_momentum_sgd([p[0].double()], [p[0].double()],
                              [p[0].double()], 1e-3)
    with pytest.raises(ValueError):  # a gradient of another shape
        upd.clip_momentum_sgd(p, p, [torch.zeros(5, device=cuda)], 1e-3)
    with pytest.raises(ValueError):  # a gradient on the CPU
        upd.clip_momentum_sgd(p, p, [torch.zeros(4)], 1e-3)
    many = [torch.zeros(4, device=cuda) for _ in range(97)]
    with pytest.raises(ValueError):  # more tensors than the table holds
        upd.clip_momentum_sgd(many, many, many, 1e-3)


def test_train_step_matches_jax(cuda, record_property):
    """The flagship train step through the kernels on the card against
    the JAX package's jitted ``step`` on the CPU beside it, from the JAX
    package's ``init_params(PRNGKey(0))`` on one ``synthetic_batch`` (B =
    16) with the service's clip, after 1 and 5 steps, within the limits of
    ``tests/test_torch_forecaster_train.py::compare_train_steps`` (the
    same the CPU holds the plain versions to)."""
    import jax

    from chanamq_tpu.models import forecaster as ref
    from test_torch_forecaster_train import compare_train_steps, configs

    port_fc.set_matmul_precision()
    jcfg, tcfg = configs("bfloat16")
    params = ref.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = port_fc.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, tcfg, cuda)
    x, y = (np.array(a) for a in ref.synthetic_batch(
        jax.random.PRNGKey(1), jcfg, 16))
    counted = chip_smoke.counted_wrappers()
    before = {k: w.launches for k, w in counted.items()}
    worst = compare_train_steps(jcfg, tcfg, params, tparams, x, y, 1.0)
    for kind, (ratio, step, name) in worst.items():
        record_property(f"{kind}_of_limit", ratio)
        record_property(f"{kind}_worst", f"{name} after {step}")
    # 5 steps, and the bias bound's two gradient passes (forward and
    # backward kernels, no update); the second asks for no weight's
    # gradient, so its products compute no dW (the embed's, four a
    # layer's, the head's)
    per_step = chip_smoke.train_per_step(tcfg)
    no_dw = {"bf16_product": 1 + 4 * tcfg.n_layers, "f32_product": 1}
    for name, w in counted.items():
        n = per_step[name] * 5
        if name != "clip_momentum_sgd":
            n += 2 * per_step[name] - no_dw.get(name, 0)
        assert w.launches - before[name] == n, name


# -- the Moonlight backbone's kernels (kernels/moonlight.py) -----------------
#
# Each held to its plain version at the cell's shapes (moonlight-forecaster
# .w2048: B = 4 windows of T = 2,048, d_model 2,048, 16 heads of 192/128,
# 64 experts, top 6): one bf16 step at the largest output (two for
# attention), as the forecaster's kernels are.

from chanamq_tpu_torch.kernels import moonlight as mk  # noqa: E402
from chanamq_tpu_torch.models import moonlight as moon  # noqa: E402


def _held(name: str, got: torch.Tensor, want: torch.Tensor,
          steps: float = 1.0) -> None:
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= steps * chip_smoke.bf16_ulp(top), (name, err, top)


def _close(name: str, got: torch.Tensor, want: torch.Tensor,
           rel: float) -> None:
    """Float32 sums in another order: the largest gap within ``rel`` of
    the largest value."""
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * top, (name, err, top)


@pytest.mark.parametrize("rows,full,width", [(8192, 2048, 2048),
                                             (8192, 576, 512), (77, 512, 512)])
def test_moonlight_rmsnorm_matches_plain(cuda, rows, full, width):
    gen = torch.Generator(device=cuda).manual_seed(rows + width)
    x = torch.randn(rows, full, generator=gen, device=cuda).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(width, generator=gen, device=cuda)
    dy = torch.randn(rows, width, generator=gen, device=cuda).to(
        torch.bfloat16)
    _held("rmsnorm", mk.rmsnorm(x, w, 1e-5),
          mk.rmsnorm_ref(x[:, :width], w, 1e-5))
    dx, dw = mk.rmsnorm_bwd(dy, x, w, 1e-5, full)
    want_dx, want_dw = mk._vjp(
        lambda a, b: mk.rmsnorm_ref(a[..., :width], b, 1e-5), (x, w), dy)
    _held("rmsnorm_bwd dx", dx, want_dx)
    _close("rmsnorm_bwd dw", dw, want_dw, 1e-4)
    again = mk.rmsnorm_bwd(dy, x, w, 1e-5, full)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    if width == 2048:  # a strided view: the final norm's last positions
        last = x.reshape(4, rows // 4, full)[:, -1]
        _held("rmsnorm last rows", mk.rmsnorm(last, w, 1e-5),
              mk.rmsnorm_ref(last, w, 1e-5))


@pytest.mark.parametrize("b,t", [(4, 2048), (1, 128)])
def test_moonlight_mla_qkv_matches_plain(cuda, b, t):
    gen = torch.Generator(device=cuda).manual_seed(t)
    dims = mk.MlaDims(16)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, kv, kva = rnd(b, t, 16 * 192), rnd(b, t, 16 * 256), rnd(b, t, 576)
    cs = mk.rope_table(t, 64, 50000.0, cuda)
    got = mk.mla_qkv(q, kv, kva, cs, dims)
    want = mk.mla_qkv_ref(q, kv, kva, cs, dims)
    assert torch.equal(got, want)
    d = rnd(b, t, 3 * 16 * 192)
    got = mk.mla_qkv_bwd(d, cs, dims)
    want = mk._vjp(lambda a, c, e: mk.mla_qkv_ref(a, c, e, cs, dims),
                   (q, kv, kva), d)
    _held("mla dq", got[0], want[0])
    _held("mla dkv", got[1], want[1])
    _held("mla dkva", got[2], want[2])


@pytest.mark.parametrize("b,t", [(4, 2048), (1, 2048), (2, 300)])
def test_moonlight_attention_matches_plain(cuda, b, t):
    gen = torch.Generator(device=cuda).manual_seed(b * t)
    dims = mk.MlaDims(16)
    qkv = (torch.randn(b, t, 3 * 16 * 192, generator=gen, device=cuda)
           ).to(torch.bfloat16)
    qkv.view(b, t, 3, 16, 192)[:, :, 2, :, 128:] = 0
    before = fk.causal_attention.warpgroup_launches
    out, stats = fk.causal_attention_with_stats(qkv, 16, 128)
    assert fk.causal_attention.warpgroup_launches == before + 1
    want = fk.causal_attention_ref(qkv, 16, 128)
    _held("mla attention", out, want, 2.0)
    dout = torch.randn(b, t, 16 * 128, generator=gen, device=cuda).to(
        torch.bfloat16)
    leaf = qkv.detach().requires_grad_()
    got = torch.autograd.grad(mk.MlaAttention.apply(leaf, dims), leaf,
                              dout)[0]
    want = torch.autograd.grad(mk.mla_attention_plain(leaf, dims), leaf,
                               dout)[0]
    _held("mla attention bwd", got, want, 2.0)


def test_moonlight_attention_refuses_narrow_windows(cuda):
    qkv = torch.zeros(1, 64, 3 * 16 * 192, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="v width 128"):
        fk.causal_attention(qkv, 16, 128)


@pytest.mark.parametrize("rows,f", [(8192, 11264), (49152, 1408),
                                    (8192, 2816), (5, 8)])
def test_moonlight_swiglu_matches_plain(cuda, rows, f):
    gen = torch.Generator(device=cuda).manual_seed(rows + f)
    gu = (2 * torch.randn(rows, 2 * f, generator=gen, device=cuda)).to(
        torch.bfloat16)
    dy = torch.randn(rows, f, generator=gen, device=cuda).to(torch.bfloat16)
    _held("swiglu", mk.swiglu(gu), mk.swiglu_ref(gu))
    _held("swiglu_bwd", mk.swiglu_bwd(dy, gu),
          mk._vjp(mk.swiglu_ref, (gu,), dy)[0])


def _routing(cuda, t=8192, e=64, k=6, d=2048, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scores = torch.sigmoid(torch.randn(t, e, generator=gen, device=cuda))
    idx = torch.topk(scores, k, dim=-1).indices.sort(-1).values
    return gen, scores, idx


def test_moonlight_routing_matches_plain(cuda):
    gen, scores, idx = _routing(cuda)
    w = mk.route_weights(scores, idx, 2.446)
    _close("route_weights", w, mk.route_weights_ref(scores, idx, 2.446),
           1e-6)
    dw = torch.randn(w.shape, generator=gen, device=cuda)
    _close("route_weights_bwd", mk.route_weights_bwd(dw, scores, idx, 2.446),
           mk._vjp(lambda s: mk.route_weights_ref(s, idx, 2.446), (scores,),
                   dw)[0], 1e-5)
    d = mk.dispatch(idx, 64)
    assert int(d.counts.sum()) == idx.numel()
    assert torch.equal(d.offsets[1:].long(), torch.cumsum(d.counts, 0))
    x = torch.randn(8192, 2048, generator=gen, device=cuda).to(torch.bfloat16)
    xs = mk.gather_rows(x, d.src)
    assert torch.equal(xs, mk.gather_ref(x, d))
    ys = torch.randn(xs.shape, generator=gen, device=cuda).to(torch.bfloat16)
    back = mk.token_sum(ys, d.pos, 6)
    want = ys[d.pos.long()].float().reshape(8192, 6, -1).sum(1)
    _held("token_sum", back, want.to(torch.bfloat16))
    sh, res = (torch.randn(8192, 2048, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    _held("combine", mk.combine(ys, w, d.pos, sh, res),
          mk.combine_ref(ys, w, d, sh, res))
    dout = torch.randn(8192, 2048, generator=gen, device=cuda).to(
        torch.bfloat16)
    dys, dwt = mk.combine_bwd(dout, ys, w, d.pos)
    zero = torch.zeros_like(dout)
    want_ys, want_w = mk._vjp(
        lambda a, b: mk.combine_ref(a, b, d, zero, zero), (ys, w), dout)
    _held("combine_bwd dys", dys, want_ys)
    _close("combine_bwd dw", dwt, want_w, 1e-4)


def _groups(cuda, counts):
    counts = torch.tensor(counts, device=cuda)
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int32, device=cuda)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return offsets, int(counts.sum())


GROUPED_CASES = [
    # (group sizes, K, N): the cell's gate | up and down products
    ([768] * 64, 2048, 2816),
    ([768] * 64, 1408, 2048),
    # uneven and empty groups, a group of one row, ragged tiles
    ([0, 1, 300, 0, 1000, 129, 0, 2] + [0] * 56, 2048, 2816),
    ([5000, 0, 0, 3] + [17] * 60, 1408, 2048),
]


@pytest.mark.parametrize("sizes,k,n", GROUPED_CASES)
def test_moonlight_grouped_products_match_plain(cuda, sizes, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(k + n + len(sizes))
    offsets, rows = _groups(cuda, sizes)
    e = len(sizes)
    x = torch.randn(rows, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(e, k, n, generator=gen, device=cuda) / k ** 0.5).to(
        torch.bfloat16)
    dy = torch.randn(rows, n, generator=gen, device=cuda).to(torch.bfloat16)
    for layout, a, b in (("nn", x, w), ("nt", dy, w), ("tn", x, dy)):
        got = mk.grouped_product(a, b, offsets, layout)
        want = mk.grouped_product_ref(a, b, offsets, layout)
        _held(f"grouped {layout}", got, want)
        assert torch.equal(got, mk.grouped_product(a, b, offsets, layout))
    empty = [i for i, s in enumerate(sizes) if s == 0]
    if empty:
        dw = mk.grouped_product(x, dy, offsets, "tn")
        assert not dw[empty].any()


def _moon_cfg(**kw):
    small = dict(seq_len=256, n_layers=2, n_experts=64)
    small.update(kw)
    return moon.MoonlightConfig(**small)


def test_moonlight_forward_and_step_match_plain(cuda):
    moon.set_matmul_precision()
    cfg = _moon_cfg()
    params = moon.init_params(3, cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, cfg.seq_len, 8, generator=gen, device=cuda)
    y = torch.randn(2, 8, generator=gen, device=cuda)
    with torch.no_grad():
        got = moon.forward(params, x, cfg)
        want = moon.forward(params, x, cfg, ops=mk.PLAIN)
    assert float((got - want).abs().max()) <= chip_smoke.FORWARD_LIMIT
    names = sorted(params)
    out = {}
    for label, ops in (("kernels", mk.KERNELS), ("plain", mk.PLAIN)):
        leaves = {n: params[n].detach().clone().requires_grad_()
                  for n in names}
        loss = moon.loss_fn(leaves, (x, y), cfg, ops=ops)
        out[label] = (float(loss), torch.autograd.grad(
            loss, [leaves[n] for n in names]))
    assert abs(out["kernels"][0] - out["plain"][0]) <= 1e-2 * abs(
        out["plain"][0])
    for n, a, b in zip(names, out["kernels"][1], out["plain"][1]):
        gap = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert gap <= 0.05, (n, gap)


def test_moonlight_service_round_counts_rows(cuda):
    from chanamq_tpu_torch.models.service import ForecastService

    cfg = _moon_cfg()
    svc = ForecastService(None, seq_len=cfg.seq_len, history=600, batch=2,
                          steps_per_round=2, device="cuda",
                          model_kwargs={"backbone": "moonlight",
                                        "n_layers": 2})
    hist = np.random.default_rng(0).random((600, 8)).astype(np.float32) * 10
    steps, loss, forecast = svc._round(hist)
    assert steps == 2 and np.isfinite(loss) and forecast is not None
    assert svc.moe_routed_rows == 6 * 2 * cfg.seq_len * 1 * 2
    assert svc.moonlight_launches > 0 and svc.snapshot()["backbone"] == \
        "moonlight"


@pytest.mark.parametrize("layout,m,n,k", [("nn", 8192, 64, 2048),
                                          ("nt", 8192, 2048, 64),
                                          ("tn", 2048, 64, 8192),
                                          ("nn", 2048, 64, 2048),
                                          ("tn", 100, 37, 1000)])
def test_moonlight_router_product_matches_plain(cuda, layout, m, n, k):
    moon.set_matmul_precision()
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=gen,
                    device=cuda)
    b = torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=gen,
                    device=cuda)
    got = mk.router_product(a, b, layout)
    want = pk.f32_product_ref(a.double(), b.double(), layout)
    # float32 sums of K terms: a few ulps of the terms' magnitudes
    assert float((got.double() - want).abs().max()) <= 2e-5 * k ** 0.5
    assert torch.equal(got, mk.router_product(a, b, layout))
