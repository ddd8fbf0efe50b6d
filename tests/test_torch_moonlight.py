"""The Moonlight backbone (``models/moonlight.py``, ``kernels/moonlight.py``)
against the plain reference (``tests/moonlight_reference.py``), on the
CPU at a small size: d_model 64, 4 heads of q and k width 24 (16 plain,
8 rotated) and v width 16, a 32-wide latent, a dense layer and two
layers of 8 experts (top 2) beside one shared expert, T = 32.

The forward, the loss, every leaf's gradient and three train steps through
the port's plain versions (``PLAIN``, and the kernel op set ``KERNELS``,
whose wrappers run the plain versions on CPU tensors) are held to the
reference's, each within a written tolerance; then each plain version
alone: the grouped products with uneven and empty groups, the routing
(with a tie at the last chosen score), RMSNorm and its backward, the
rotation and its gradient, and attention whose keys and values differ in
width against a float32 causal softmax; the forecast service's round
with the backbone (its routing counters, launch counts and profile
stages); and the reference's record of expert choices, which the cell's
comparison forces on it.
"""

import json
import math
import types

import numpy as np
import pytest
import torch

import moonlight_reference as ref
from chanamq_tpu_torch import profile
from chanamq_tpu_torch.kernels import forecaster as fk
from chanamq_tpu_torch.kernels import moonlight as mk
from chanamq_tpu_torch.models import moonlight as moon
from chanamq_tpu_torch.models.service import ForecastService

SMALL = dict(d_model=64, n_heads=4, qk_nope=16, qk_rope=8, v_dim=16,
             kv_rank=32, d_ff=128, expert_ff=32, n_experts=8, top_k=2,
             n_shared=1, n_layers=3, seq_len=32)
CFG = moon.MoonlightConfig(**SMALL)
RCFG = {**ref.MOONLIGHT, **SMALL}

# bf16 activations: the port and the reference round at the same points but
# sum in other orders (and the reference's products are bf16 matmuls), so
# a rounding can flip, and at this size a flip in an early layer moves the
# output visibly. Measured over seeds 0-5: the forecast 1.4e-2 of its
# largest value, the loss 5.7e-3, a leaf's gradient 2.0e-2 and its change
# over three steps 1.3e-2 of its norm. A fault is of another order (the
# shared expert left out moves the loss by tens of percent).
FORWARD_TOL = 0.03     # of the largest forecast value
LOSS_TOL = 0.01        # relative
GRAD_TOL = 0.04        # of the leaf's norm
STEP_TOL = 0.03        # each leaf's change over three steps, of its norm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=0, b=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, CFG.seq_len, CFG.n_features, generator=gen)
    y = torch.randn(b, CFG.n_features, generator=gen)
    return x, y


def _grads(forward, params, x, y):
    names = sorted(params)
    leaves = {n: params[n].detach().clone().requires_grad_() for n in names}
    loss = torch.mean((forward(leaves, x) - y) ** 2)
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names])))


def _port(ops):
    return lambda p, x: moon.forward(p, x, CFG, ops=ops)


def _reference(p, x):
    return ref.forward(p, x, RCFG)


def test_reference_and_port_share_the_parameters():
    assert moon.param_shapes(CFG) == ref.param_shapes(RCFG)
    full = moon.MoonlightConfig()
    assert moon.param_shapes(full) == ref.param_shapes(ref.MOONLIGHT)
    # Moonlight-16B-A3B's block, cut to five layers: the dense layer (83 M)
    # and four expert layers (584.8 M each)
    assert moon.n_params(full) == 2_422_401_544


@pytest.mark.parametrize("ops", ["plain", "kernels"])
def test_forward_matches_reference(ops):
    params = moon.init_params(1, CFG, "cpu")
    x, _ = _inputs()
    with torch.no_grad():
        got = _port(mk.PLAIN if ops == "plain" else mk.KERNELS)(params, x)
        want = _reference(params, x)
    assert float((got - want).abs().max()) <= \
        FORWARD_TOL * float(want.abs().max())


@pytest.mark.parametrize("ops", ["plain", "kernels"])
def test_loss_and_every_gradient_match_reference(ops):
    params = moon.init_params(2, CFG, "cpu")
    x, y = _inputs(1)
    loss, grads = _grads(_port(mk.PLAIN if ops == "plain" else mk.KERNELS),
                         params, x, y)
    want_loss, want = _grads(_reference, params, x, y)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    assert set(grads) == set(want)
    for n in want:
        gap = float((grads[n] - want[n]).norm()) / float(want[n].norm())
        assert gap <= GRAD_TOL, (n, gap)


def test_kernel_op_set_equals_plain_on_the_cpu():
    """On CPU tensors the kernels' wrappers run the plain versions, and
    their backward passes are the plain forward's autograd: one result."""
    params = moon.init_params(3, CFG, "cpu")
    x, y = _inputs(2)
    la, ga = _grads(_port(mk.KERNELS), params, x, y)
    lb, gb = _grads(_port(mk.PLAIN), params, x, y)
    assert float(la) == float(lb)
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=1e-5, atol=1e-7)


def test_three_train_steps_match_reference():
    params = moon.init_params(4, CFG, "cpu")
    start = {n: p.clone() for n, p in params.items()}
    x, y = _inputs(3)
    port_p = {n: p.clone() for n, p in params.items()}
    port_m = moon.init_momentum(port_p)
    step = moon.make_train_step(CFG, lr=1e-3, ops=mk.PLAIN)
    ref_p = {n: p.clone() for n, p in params.items()}
    ref_m = {n: torch.zeros_like(p) for n, p in ref_p.items()}
    for _ in range(3):
        _, _, loss = step(port_p, port_m, (x, y))
        want = ref.train_step(ref_p, ref_m, (x, y), RCFG, lr=1e-3)
        assert abs(float(loss) - float(want)) <= LOSS_TOL * float(want)
    for n in start:
        d_port, d_ref = port_p[n] - start[n], ref_p[n] - start[n]
        if float(d_ref.norm()) == 0:
            continue
        gap = float((d_port - d_ref).norm()) / float(d_ref.norm())
        assert gap <= STEP_TOL, (n, gap)


# -- each plain version alone ------------------------------------------------


def _offsets(sizes):
    off = torch.zeros(len(sizes) + 1, dtype=torch.int32)
    off[1:] = torch.cumsum(torch.tensor(sizes), 0).to(torch.int32)
    return off


@pytest.mark.parametrize("sizes", [[3, 0, 5, 1, 0, 0, 7, 2], [0, 0, 16, 0],
                                   [1, 1, 1, 1]])
def test_grouped_products_with_uneven_and_empty_groups(sizes):
    gen = torch.Generator().manual_seed(len(sizes))
    e, rows, k, n = len(sizes), sum(sizes), 16, 24
    off = _offsets(sizes)
    x = torch.randn(rows, k, generator=gen).to(torch.bfloat16)
    w = torch.randn(e, k, n, generator=gen).to(torch.bfloat16)
    dy = torch.randn(rows, n, generator=gen).to(torch.bfloat16)
    bounds = off.tolist()

    def each(fn):
        return [fn(e_, lo, hi) for e_, (lo, hi) in
                enumerate(zip(bounds[:-1], bounds[1:]))]

    fwd = mk.grouped_product(x, w, off, "nn")
    want = torch.cat(each(lambda e_, lo, hi: (
        x[lo:hi].double() @ w[e_].double()).to(torch.bfloat16)))
    assert torch.equal(fwd, want)
    dx = mk.grouped_product(dy, w, off, "nt")
    want = torch.cat(each(lambda e_, lo, hi: (
        dy[lo:hi].double() @ w[e_].double().t()).to(torch.bfloat16)))
    assert torch.equal(dx, want)
    dw = mk.grouped_product(x, dy, off, "tn")
    want = torch.stack(each(lambda e_, lo, hi: (
        x[lo:hi].double().t() @ dy[lo:hi].double()).to(torch.bfloat16)))
    assert torch.equal(dw, want)
    for e_, size in enumerate(sizes):
        if size == 0:
            assert not dw[e_].any()
    # the autograd Function's backward takes the same kernel's layouts
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(mk.Grouped.apply(xl, wl, off), (xl, wl), dy)
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


def test_routing_matches_reference_with_a_tie():
    """The port's choice (top-k of the scores, slots in expert order) and
    weights against the reference's router, with the last chosen score
    tied between two experts: both take torch's top-k on the same
    scores, so they choose the same one."""
    gen = torch.Generator().manual_seed(5)
    t, e, k = 64, 8, 2
    hs = torch.randn(t, 16, generator=gen)
    weight = torch.randn(16, e, generator=gen)
    # token 0's logits are weight's first row: experts 3 and 5 tie for
    # the second place
    hs[0] = 0.0
    hs[0, 0] = 1.0
    weight[0] = torch.tensor([-4.0, -3.0, -2.0, 1.0, 3.0, 1.0, -5.0, -6.0])
    cfg = {**RCFG, "n_experts": e, "top_k": k}
    idx_ref, w_ref, _ = ref.router(hs, weight, cfg)
    order = idx_ref.argsort(-1)
    idx_ref, w_ref = idx_ref.gather(1, order), w_ref.gather(1, order)
    scores = torch.sigmoid(hs @ weight)
    idx = torch.topk(scores, k, dim=-1, sorted=False).indices.sort(-1).values
    assert torch.equal(idx, idx_ref)
    w = mk.route_weights(scores, idx, cfg["route_scale"])
    torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-7)
    assert 4 in idx[0].tolist() and set(idx[0].tolist()) - {4} <= {3, 5}
    assert torch.allclose(w.sum(-1), torch.full((t,), cfg["route_scale"]))
    # dispatch: every (token, slot) once, sorted by expert, and back
    d = mk.dispatch(idx, e)
    assert torch.equal(d.offsets[1:].long(), torch.cumsum(d.counts, 0))
    experts = idx.reshape(-1)[torch.argsort(d.pos.long())]
    assert torch.equal(experts, experts.sort().values)
    assert torch.equal(d.src.long()[d.pos.long()],
                       torch.arange(t).repeat_interleave(k))


def test_rmsnorm_and_its_backward():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(9, 48, generator=gen).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(40, generator=gen)
    got = mk.rmsnorm(x, w, 1e-5)      # the first 40 of 48 columns
    want = ref.rmsnorm(x[:, :40], w, 1e-5, "bf16")
    assert torch.equal(got, want)
    dy = torch.randn(9, 40, generator=gen).to(torch.bfloat16)
    dx, dw = mk.rmsnorm_bwd(dy, x, w, 1e-5, 48)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    want_dx, want_dw = torch.autograd.grad(
        ref.rmsnorm(xl[:, :40], wl, 1e-5, "bf16"), (xl, wl), dy)
    assert torch.equal(dx, want_dx) and not dx[:, 40:].any()
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-6)
    # the closed form in float64: dx = r dn - x r^3 mean(dn x)
    xf = x.double()[:, :40]
    r = 1 / torch.sqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-5)
    dn = (dy.double() * w.double()).to(torch.bfloat16).double()
    closed = r * dn - xf * r ** 3 * (dn * xf).mean(-1, keepdim=True)
    assert float((dx[:, :40].double() - closed).abs().max()) <= \
        2 ** -7 * float(closed.abs().max())


def test_rotation_and_its_inverse_gradient():
    """The port's rotation is the reference's (pairs taken apart, then
    rotated), and in float32 its gradient rotates back: the cotangent of
    the rotated values, pushed through, is the rotation by minus the
    angle, put back into pairs."""
    t, rope = 12, 8
    cs = mk.rope_table(t, rope, 50000.0, "cpu")
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, t, 3, rope, generator=gen).to(torch.bfloat16)
    cos, sin = ref.rotary(t, rope, 50000.0, "bf16", "cpu")
    want = ref.rope_interleave(x.transpose(1, 2), cos, sin,
                               "bf16").transpose(1, 2)
    assert torch.equal(mk.rotate_ref(x, cs), want)
    xf = x.float().requires_grad_()
    csf = cs.float()
    out = mk.rotate_ref(xf, csf)
    g = torch.randn(out.shape, generator=gen)
    (dx,) = torch.autograd.grad(out, xf, g)
    c, s = csf[:t, :rope // 2], csf[:t, rope // 2:]
    c, s = c[None, :, None], s[None, :, None]
    ga, gb = g[..., :rope // 2], g[..., rope // 2:]
    back = torch.stack([ga * c + gb * s, gb * c - ga * s], dim=-1)
    torch.testing.assert_close(dx, back.reshape(dx.shape), rtol=1e-6,
                               atol=1e-6)


def test_attention_with_wider_keys_than_values():
    """Attention over the fused operand with q and k 24 wide and v 16
    (padded to 24 in the operand) against a float32 causal softmax over
    q, k and the first 16 columns of v; its gradient at width 16 through
    the forecaster's attention backward matches autograd's, the v heads'
    columns past 16 zero."""
    b, t, h, qk, v = 2, 20, 4, 24, 16
    gen = torch.Generator().manual_seed(8)
    q, k, vv = (torch.randn(b, t, h, qk, generator=gen) for _ in range(3))
    vv[..., v:] = 0
    fused = torch.cat([q, k, vv], dim=2).reshape(b, t, 3 * h * qk)
    got = fk.causal_attention_ref(fused.to(torch.bfloat16), h, v).float()
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(qk)
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -1e30)
    want = torch.einsum("bhts,bshd->bthd", s.softmax(-1), vv[..., :v])
    assert float((got - want.reshape(b, t, h * v)).abs().max()) <= 0.05
    dims = mk.MlaDims(h, 16, 8, v, 32)
    leaf = fused.clone().requires_grad_()
    dout = torch.randn(b, t, h * v, generator=gen)
    (want_g,) = torch.autograd.grad(mk.mla_attention_plain(leaf, dims), leaf,
                                    dout)
    got_g = fk.causal_attention_bwd_ref(fused, dout, h)
    torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-5)
    assert not got_g.view(b, t, 3, h, qk)[:, :, 2, :, v:].any()


# -- the forecast service with the backbone --------------------------------


def _history(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return (10 + 5 * np.sin(t / 7 + rng.random(8)) + rng.random((n, 8))
            ).astype(np.float32)


def _service(steps=2):
    return ForecastService(
        types.SimpleNamespace(), seq_len=CFG.seq_len, history=128, batch=3,
        steps_per_round=steps, device="cpu",
        model_kwargs={"backbone": "moonlight",
                      **{k: v for k, v in SMALL.items() if k != "seq_len"}})


def test_service_trains_and_forecasts_with_the_backbone():
    svc = _service(steps=2)
    steps, loss, forecast = svc._round(_history(100, 0))
    assert steps == 2 and np.isfinite(loss)
    assert set(forecast) == set(svc.feature_names)
    assert svc._torch_state["backbone"] == "moonlight"
    assert isinstance(svc._torch_state["cfg"], moon.MoonlightConfig)
    snap = svc.snapshot()
    assert snap["backbone"] == "moonlight"
    # every token's top-k rows in each mixture layer of each step
    moe_layers = CFG.n_layers - CFG.first_dense
    assert snap["moe_routed_rows"] == \
        CFG.top_k * 3 * CFG.seq_len * moe_layers * 2
    assert 0 < snap["moe_max_expert_rows"] <= 3 * CFG.seq_len
    assert svc.moe_max_rows_sum >= \
        snap["moe_routed_rows"] / CFG.n_experts
    svc._round(_history(100, 1))
    assert svc.snapshot()["moe_routed_rows"] == \
        CFG.top_k * 3 * CFG.seq_len * moe_layers * 4


def test_service_keeps_the_forecaster_by_default():
    svc = ForecastService(types.SimpleNamespace(), device="cpu")
    assert svc.backbone == "forecaster"
    assert svc.model_kwargs == {"d_model": 64, "n_heads": 4, "d_ff": 256,
                                "n_layers": 2}
    assert svc.snapshot()["backbone"] == "forecaster"
    with pytest.raises(ValueError, match="backbone"):
        ForecastService(types.SimpleNamespace(), device="cpu",
                        model_kwargs={"backbone": "nope"})


def test_round_counts_the_moonlight_launches(monkeypatch):
    svc = _service(steps=1)
    svc._torch_state = svc._torch_setup()
    step = svc._torch_state["step"]

    def counted(*args):
        monkeypatch.setattr(mk.grouped_product, "launches",
                            mk.grouped_product.launches + 6)
        return step(*args)

    svc._torch_state["step"] = counted
    svc._round(_history(100, 2))
    assert svc.snapshot()["moonlight_launches"] == 6


def test_round_records_the_backbone_stages():
    rt = profile.install(profile.ProfileRuntime(gc_hook=False))
    try:
        svc = _service(steps=1)
        svc._round(_history(100, 3))
        calls = {name: int(rt.stage_calls[profile.STAGES.index(name)])
                 for name in ("mla-attention", "moe-route", "moe-dispatch",
                              "moe-experts", "moe-combine")}
        moe_layers = CFG.n_layers - CFG.first_dense
        # one train step and one forecast, each a forward
        assert calls == {"mla-attention": 2 * CFG.n_layers,
                         **dict.fromkeys(("moe-route", "moe-dispatch",
                                          "moe-experts", "moe-combine"),
                                         2 * moe_layers)}
        (entry,) = rt.snapshot()["forecast"]["rounds"]
        stages = [s["stage"] for s in entry["spans"]]
        assert stages.count("moe-experts") == 2 * moe_layers
    finally:
        profile.clear()


def test_reference_routes_record_force_and_measure_choices():
    """The reference's ``Routes``: a round's own choices recorded and
    forced back give the same forward and a margin of 0; forcing each
    token's lowest-scored experts gives the shortfall of the best expert
    left out over them; a forced choice covering fewer rows than the layer
    has leaves the rest to the reference's own top k."""
    params = moon.init_params(9, CFG, "cpu")
    x, _ = _inputs(4)
    own = ref.Routes()
    with torch.no_grad():
        want = ref.forward(params, x, RCFG, routes=own)
        forced = ref.Routes(own.taken)
        got = ref.forward(params, x, RCFG, routes=forced)
    moe_layers = CFG.n_layers - CFG.first_dense
    assert len(own.taken) == moe_layers and forced.margin == 0.0
    assert torch.equal(got, want)
    scores = torch.tensor([[0.9, 0.1, 0.5, 0.7], [0.2, 0.3, 0.8, 0.6]])
    low = ref.Routes([torch.tensor([[1, 2]])])
    idx = low.choose(scores, 2)
    assert idx.tolist() == [[1, 2], [2, 3]]
    assert low.margin == pytest.approx(0.9 - 0.1)


def test_chip_smoke_moonlight_phase_rehearsed():
    """``chip_smoke.py``'s ``[moonlight]`` phase on the CPU at the small
    size: every wrapper's calls in one train step as
    ``moonlight_per_step`` counts them, each kept call held against its
    plain version, and a bound for each."""
    import chip_smoke

    res = chip_smoke.phase_moonlight(torch.device("cpu"), 0, cfg=CFG,
                                     batch=2)
    rows = res["by_wrapper"]
    assert set(rows) == set(mk.WRAPPERS) | set(chip_smoke.MOON_SHARED) | \
        set(chip_smoke.PRODUCT_KERNELS)
    want = chip_smoke.moonlight_per_step(CFG, 2)
    for name, row in rows.items():
        assert row["calls"] == want[name][0] and row["shapes"], name
        assert sum(row["shapes"].values()) == row["calls"], name
        # the CPU runs the plain versions themselves; the router's plain
        # version sums in float64
        assert row["max_abs_err"] == 0.0 or name == "router_product", name
        assert row["of_limit"] <= 1.0 and row["bound_ms"] > 0, name
    assert len(rows["causal_attention_with_stats"]["forecast"]) == 2
    assert sum(res["groups"]) == CFG.top_k * 2 * CFG.seq_len
    # the kernels line: the shared kernels' rows gain the step's figures,
    # each Moonlight wrapper has a row of its own
    line = [{"name": name} for name in (
        "causal_attention", "causal_attention_bwd", "layernorm",
        "clip_momentum_sgd") + chip_smoke.PRODUCT_KERNELS]
    chip_smoke.moonlight_line(line, res, {"grouped_product": {"HMMA": 1}})
    by_name = {row["name"]: row for row in line}
    assert "forecast" in by_name["causal_attention"]["moonlight_step"]
    assert by_name["clip_momentum_sgd"]["moonlight_step"] == {
        "launches": res["update_launches"]}
    assert "moonlight_step" not in by_name["layernorm"]
    assert set(mk.WRAPPERS) <= set(by_name)
    assert by_name["grouped_product"]["hmma"] == {"HMMA": 1}
    json.dumps(line)
