"""A second backbone for the telemetry forecaster: Moonlight-16B-A3B's
block (``model_type`` deepseek_v3), trained and forecast by the forecast
service (``models/service.py``, ``model_kwargs={"backbone": "moonlight",
...}``).

Input and output are the forecaster's (``models/forecaster.py``): the
product of the telemetry features into ``d_model`` plus a bias, and a
float32 head on the last position, here after a final RMSNorm. There is
no position table: rotary positions carry position, 0 .. T-1 in each
window. Each layer is the modeling file's decoder layer
(transformers' ``modeling_deepseek_v3.py``):

- RMSNorm (eps ``eps``) and latent attention without query compression:
  ``q = x W_q`` (each head ``qk_nope`` plain and ``qk_rope`` rotated
  columns), ``x W_kv_a`` = a ``kv_rank`` latent (its own RMSNorm, eps
  ``kv_eps``) | one rotated key shared by every head, the latent's
  ``W_kv_b`` = each head's plain key | value; rotary positions on
  adjacent pairs (``rope_interleave``) at ``rope_theta``; causal softmax
  attention at scale ``1/sqrt(qk_nope + qk_rope)``; ``W_o``; the
  residual add;
- RMSNorm and, in the first ``first_dense`` layers, a SwiGLU of width
  ``d_ff``, else the mixture: a float32 router with sigmoid scores, the
  top ``top_k`` of the scores plus ``e_score_correction_bias`` (a buffer
  held at zero: the balancing update outside the gradient is not run),
  the chosen scores normalised and scaled by ``route_scale``, each
  token's rows through its experts' SwiGLUs of width ``expert_ff`` and
  summed with those weights in float32, plus ``n_shared`` shared experts
  as one SwiGLU of width ``n_shared * expert_ff``; the residual add.

Activations are bf16; parameters and product sums float32; the router is
float32. Every product, norm, attention, rotation and expert computation
goes through the hand-written kernels of ``kernels/moonlight.py`` and
``kernels/products.py`` (``ops``: ``KERNELS``, or ``PLAIN`` to compare),
torch only for the router's sigmoid and top-k, the dispatch's index
bookkeeping (sort, counts, offsets), the casts of the weights and of the
router's input to float32, and the loss.

Parameters are a flat ``{name: float32 tensor}`` set in ``[in, out]``
layout (each expert layer's experts stacked ``[E, in, out]``; gate and up
side by side, ``[.., in, 2 F]``); ``init_params`` draws them from a seed
(normal with ``1/sqrt(fan_in)``, norms at one, biases zero). The train
step is the service's: the MSE of the next tick, gradients by autograd,
then the global-norm clip, momentum and SGD update (``kernels/update.py``).
With profiling on, each layer's attention and its mixture's route,
dispatch, experts and combine are the ``mla-attention`` and ``moe-*``
stages (``profile.span``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import profile
from ..kernels import moonlight as kernels
from .forecaster import (  # noqa: F401 — the forecaster's, shared
    _check_matmul_precision, init_momentum, set_matmul_precision,
)

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """Moonlight-16B-A3B's widths (its config.json), five layers: the
    dense layer and four expert layers."""
    n_features: int = 8
    seq_len: int = 2048
    d_model: int = 2048        # hidden_size
    n_heads: int = 16          # num_attention_heads
    qk_nope: int = 128         # qk_nope_head_dim
    qk_rope: int = 64          # qk_rope_head_dim
    v_dim: int = 128           # v_head_dim
    kv_rank: int = 512         # kv_lora_rank
    d_ff: int = 11264          # intermediate_size (the dense layers)
    expert_ff: int = 1408      # moe_intermediate_size
    n_experts: int = 64        # n_routed_experts
    top_k: int = 6             # num_experts_per_tok
    n_shared: int = 2          # n_shared_experts
    n_layers: int = 5          # num_hidden_layers, cut from 27
    first_dense: int = 1       # first_k_dense_replace
    route_scale: float = 2.446  # routed_scaling_factor
    rope_theta: float = 50000.0
    eps: float = 1e-5          # rms_norm_eps
    kv_eps: float = 1e-6       # the latent's norm: the modeling file's default
    dtype: Any = torch.bfloat16

    @property
    def dims(self) -> kernels.MlaDims:
        return kernels.MlaDims(self.n_heads, self.qk_nope, self.qk_rope,
                               self.v_dim, self.kv_rank)

    def dense(self, layer: int) -> bool:
        return layer < self.first_dense


def param_shapes(cfg: MoonlightConfig) -> dict[str, tuple]:
    """Every parameter's name and shape, in draw order."""
    d, h, e = cfg.d_model, cfg.n_heads, cfg.n_experts
    shapes = {"embed/kernel": (cfg.n_features, d), "embed/bias": (d,)}
    for layer in range(cfg.n_layers):
        pre = f"layer{layer}"
        shapes[f"{pre}/attn_norm/scale"] = (d,)
        shapes[f"{pre}/attn/q"] = (d, h * (cfg.qk_nope + cfg.qk_rope))
        shapes[f"{pre}/attn/kv_a"] = (d, cfg.kv_rank + cfg.qk_rope)
        shapes[f"{pre}/attn/kv_norm/scale"] = (cfg.kv_rank,)
        shapes[f"{pre}/attn/kv_b"] = (cfg.kv_rank,
                                      h * (cfg.qk_nope + cfg.v_dim))
        shapes[f"{pre}/attn/o"] = (h * cfg.v_dim, d)
        shapes[f"{pre}/mlp_norm/scale"] = (d,)
        if cfg.dense(layer):
            shapes[f"{pre}/mlp/gate_up"] = (d, 2 * cfg.d_ff)
            shapes[f"{pre}/mlp/down"] = (cfg.d_ff, d)
        else:
            shared = cfg.n_shared * cfg.expert_ff
            shapes[f"{pre}/moe/router"] = (d, e)
            shapes[f"{pre}/moe/gate_up"] = (e, d, 2 * cfg.expert_ff)
            shapes[f"{pre}/moe/down"] = (e, cfg.expert_ff, d)
            shapes[f"{pre}/moe/shared_gate_up"] = (d, 2 * shared)
            shapes[f"{pre}/moe/shared_down"] = (shared, d)
    shapes["final_norm/scale"] = (d,)
    shapes["out/kernel"] = (d, cfg.n_features)
    shapes["out/bias"] = (cfg.n_features,)
    return shapes


def n_params(cfg: MoonlightConfig) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(cfg).values())


def init_params(seed: int, cfg: MoonlightConfig, device="cuda") -> Params:
    """Float32 parameters from ``seed``: each matrix normal with
    ``1/sqrt(fan_in)`` (its second-last dimension), drawn in
    ``param_shapes`` order by one ``torch.Generator`` on ``device``;
    norms at one, biases zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    out: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("/bias"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("/scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            out[name] = t.mul_(np.float32(1.0 / math.sqrt(shape[-2])))
    return out


def cast_names(cfg: MoonlightConfig) -> list[str]:
    """The parameters that ``forward`` reads in ``cfg.dtype``: every
    product's weight but the router's and the head's (float32)."""
    return [n for n in param_shapes(cfg)
            if not n.endswith("/scale") and n not in (
                "out/kernel", "out/bias") and not n.endswith("/router")]


def cast_weights(params: Params, cfg: MoonlightConfig) -> Params:
    return {n: params[n].to(cfg.dtype) for n in cast_names(cfg)}


def rope_table(cfg: MoonlightConfig, t: int, device) -> torch.Tensor:
    """The rotary table (``kernels.rope_table``) for windows of ``t``
    rows."""
    return kernels.rope_table(t, cfg.qk_rope, cfg.rope_theta, device)


def _moe(h2: torch.Tensor, m: torch.Tensor, params: Params, w: Params,
         pre: str, cfg: MoonlightConfig, ops: kernels.Ops,
         counters: Optional[torch.Tensor]) -> torch.Tensor:
    """One mixture layer on the normed rows ``m [R, D]``, its output added
    to the residual ``h2`` in the combine."""
    base = ops.base
    with profile.span(profile.MOE_ROUTE):
        logits = ops.router(m.to(torch.float32), params[f"{pre}/moe/router"])
        scores = torch.sigmoid(logits)
        with torch.no_grad():
            # e_score_correction_bias is held at zero: the choice is on the
            # scores themselves; slots in each token's expert order
            idx = torch.topk(scores, cfg.top_k, dim=-1,
                             sorted=False).indices.sort(dim=-1).values
        weights = ops.route_weights(scores, idx, cfg.route_scale)
    with profile.span(profile.MOE_DISPATCH):
        d = kernels.dispatch(idx, cfg.n_experts)
        xs = ops.gather(m, d)
    with profile.span(profile.MOE_EXPERTS):
        gu = ops.grouped(xs, w[f"{pre}/moe/gate_up"], d.offsets)
        ys = ops.grouped(ops.swiglu(gu), w[f"{pre}/moe/down"], d.offsets)
        sh = base.product(ops.swiglu(base.product(
            m, w[f"{pre}/moe/shared_gate_up"])), w[f"{pre}/moe/shared_down"])
    with profile.span(profile.MOE_COMBINE):
        out = ops.combine(ys, weights, d, sh, h2)
    if counters is not None:
        with torch.no_grad():
            top = d.counts.max()
            counters[0] += d.counts.sum()
            counters[1] += top
            torch.maximum(counters[2], top, out=counters[2])
    return out


def forward(params: Params, x: torch.Tensor, cfg: MoonlightConfig, *,
            weights: Optional[Params] = None,
            ops: kernels.Ops = kernels.KERNELS,
            counters: Optional[torch.Tensor] = None,
            cs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [batch, seq_len, n_features] float32 -> forecast [batch,
    n_features] float32. ``weights`` is ``cast_weights(params, cfg)``,
    cast here when not given; ``ops`` the kernels or the plain versions;
    ``counters`` (int64 ``[3]`` on the device, or None) adds each mixture
    layer's routed rows, its largest expert group, and keeps the largest
    group of all; ``cs`` is ``rope_table(cfg, seq_len, device)``, made
    here when not given. On a card it raises unless
    ``set_matmul_precision()`` holds."""
    if x.is_cuda:
        _check_matmul_precision()
    w = cast_weights(params, cfg) if weights is None else weights
    base = ops.base
    dims = cfg.dims
    b, t, _ = x.shape
    d = cfg.d_model
    if cs is None:
        cs = rope_table(cfg, t, x.device)
    h = base.product(x.to(cfg.dtype), w["embed/kernel"])
    h = (h + w["embed/bias"]).reshape(b * t, d)
    for layer in range(cfg.n_layers):
        pre = f"layer{layer}"
        with profile.span(profile.MLA_ATTENTION):
            a = ops.rmsnorm(h, params[f"{pre}/attn_norm/scale"], cfg.eps)
            q = base.product(a, w[f"{pre}/attn/q"])
            kva = base.product(a, w[f"{pre}/attn/kv_a"])
            lat = ops.rmsnorm(kva, params[f"{pre}/attn/kv_norm/scale"],
                              cfg.kv_eps)
            kv = base.product(lat, w[f"{pre}/attn/kv_b"])
            fused = ops.mla_qkv(q.reshape(b, t, -1), kv.reshape(b, t, -1),
                                kva.reshape(b, t, -1), cs, dims)
            att = ops.attention(fused, dims)
            h = base.product(att.reshape(b * t, -1), w[f"{pre}/attn/o"], h)
        m = ops.rmsnorm(h, params[f"{pre}/mlp_norm/scale"], cfg.eps)
        if cfg.dense(layer):
            g = ops.swiglu(base.product(m, w[f"{pre}/mlp/gate_up"]))
            h = base.product(g, w[f"{pre}/mlp/down"], h)
        else:
            h = _moe(h, m, params, w, pre, cfg, ops, counters)
    last = ops.rmsnorm(h.reshape(b, t, d)[:, -1],
                       params["final_norm/scale"], cfg.eps)
    return base.head(last.to(torch.float32), params["out/kernel"]) \
        + params["out/bias"]


def loss_fn(params: Params, batch: tuple, cfg: MoonlightConfig, *,
            ops: kernels.Ops = kernels.KERNELS,
            counters: Optional[torch.Tensor] = None,
            cs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error of ``forward`` on ``batch = (x, y)``."""
    x, y = batch
    pred = forward(params, x, cfg, ops=ops, counters=counters, cs=cs)
    return torch.mean((pred - y) ** 2)


def new_counters(device) -> torch.Tensor:
    """The routing counters ``forward`` adds to: routed rows, the sum of
    each layer's largest expert group, the largest group (int64)."""
    return torch.zeros(3, dtype=torch.int64, device=device)


def make_train_step(cfg: MoonlightConfig, lr: float = 1e-3,
                    clip_norm: Optional[float] = 1.0, *,
                    ops: kernels.Ops = kernels.KERNELS,
                    counters: Optional[torch.Tensor] = None) -> Callable:
    """The service's SGD-with-momentum step, as ``forecaster.py``'s
    ``make_train_step``: ``step(params, momentum, batch) -> (params,
    momentum, loss)``, in place, the weights cast inside the graph, the
    gradients in sorted-name order clipped, into momentum 0.9 and applied
    with ``lr`` (``ops.base.update``). ``counters`` gathers the routing
    counters of every step's forward."""
    names = sorted(param_shapes(cfg))
    tables: dict = {}  # the rotary table of each window length seen

    def step(params: Params, momentum: Params, batch: tuple) -> tuple:
        with profile.span(profile.TRAIN_STEP):
            leaves = {n: params[n].detach().requires_grad_() for n in names}
            t = batch[0].shape[1]
            if t not in tables:
                tables[t] = rope_table(cfg, t, batch[0].device)
            with profile.span(profile.TRAIN_FORWARD):
                loss = loss_fn(leaves, batch, cfg, ops=ops,
                               counters=counters, cs=tables[t])
            with profile.span(profile.TRAIN_BACKWARD):
                grads = torch.autograd.grad(loss,
                                            [leaves[n] for n in names])
            with profile.span(profile.TRAIN_UPDATE):
                ops.base.update([params[n] for n in names],
                                [momentum[n] for n in names],
                                [g.contiguous() for g in grads], lr,
                                clip_norm)
        return params, momentum, loss.detach()

    return step
