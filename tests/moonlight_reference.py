"""Plain PyTorch reference of the Moonlight backbone of the telemetry
forecaster and its training round.

Moonlight-16B-A3B's block (``model_type`` deepseek_v3,
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json),
written equation by equation from transformers 4.57.6's
``models/deepseek_v3/modeling_deepseek_v3.py`` (read as text, not
imported): ``DeepseekV3RMSNorm``, the default rotary embedding with
``apply_rotary_pos_emb_interleave``, ``DeepseekV3Attention`` without query
compression (``q_lora_rank`` null) and its eager attention,
``DeepseekV3MLP``, ``DeepseekV3TopkRouter`` (``n_group`` 1, so the group
choice keeps every expert), ``DeepseekV3MoE`` and ``DeepseekV3DecoderLayer``.
Parameters, the router, the loss, clip and update are float32; activations
are rounded to ``act`` (bfloat16, the configuration's dtype) where the
modeling file's bf16 operations round them, and every bf16 product
accumulates in float32. ``act="fp8"`` rounds those same activations to 3
mantissa bits (float8 e4m3) instead: the control, one precision below the
stated one. TF32 is off (``set_precision``).

Departures from the modeling file, each the forecast service's:

- the input is the product of the telemetry features into ``d_model``
  plus a bias, not a token embedding, and the output a float32 head
  (``out/kernel``, ``out/bias``) on the last position after the final
  RMSNorm, not the 163,840-token LM head;
- positions restart at 0 in each window;
- ``e_score_correction_bias`` is a buffer held at zero (its balancing
  update runs outside the gradient and is not run), and there is no
  auxiliary loss;
- the loss is the mean squared error of the next tick, and a step is SGD
  with momentum 0.9 after a global-norm clip at 1.0;
- the attention logits are the bf16 product ``q k^T`` divided by
  ``sqrt(192)`` in float32 (the modeling file multiplies by ``192**-0.5``
  in bf16), as the forecaster's attention forms them;
- parameters are float32 in ``[in, out]`` layout, each expert layer's
  experts stacked, gate and up side by side (``[.., in, 2 F]``); the
  weights are cast to ``act`` for each product.

A round is what the forecast service does with a telemetry history:
z-score it per feature, draw ``batch`` windows and their next vectors
(numpy ``default_rng(0)``), train ``steps`` steps on them, and forecast the
next vector from the newest window. Its faults, for the calibration of a
cell's limits: ``rows`` (train on the first rows of each batch),
``update=False`` (steps that leave the state unchanged), ``drop="sixth"``
(each token's sixth routed expert left out of the combine) and
``drop="shared"`` (the shared experts left out). ``Routes`` records a
round's expert choices, or forces another run's on it and measures how far
they fall short of its own scores.

Nothing here imports the program, JAX or transformers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# Moonlight-16B-A3B's config.json, five layers (the dense one and four with
# experts), and the forecaster's eight features
MOONLIGHT = {
    "n_features": 8, "seq_len": 2048, "d_model": 2048, "n_heads": 16,
    "qk_nope": 128, "qk_rope": 64, "v_dim": 128, "kv_rank": 512,
    "d_ff": 11264, "expert_ff": 1408, "n_experts": 64, "top_k": 6,
    "n_shared": 2, "n_layers": 5, "first_dense": 1, "route_scale": 2.446,
    "rope_theta": 50000.0, "eps": 1e-5, "kv_eps": 1e-6,
}


def set_precision() -> None:
    """Products in full float32 (no TF32) and bfloat16 products that
    accumulate in float32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def param_shapes(cfg: dict) -> dict:
    """Every parameter's name and shape (``[in, out]``; experts ``[E, in,
    out]``)."""
    d, h, e = cfg["d_model"], cfg["n_heads"], cfg["n_experts"]
    qk = cfg["qk_nope"] + cfg["qk_rope"]
    shapes = {"embed/kernel": (cfg["n_features"], d), "embed/bias": (d,)}
    for layer in range(cfg["n_layers"]):
        pre = f"layer{layer}"
        shapes[f"{pre}/attn_norm/scale"] = (d,)
        shapes[f"{pre}/attn/q"] = (d, h * qk)
        shapes[f"{pre}/attn/kv_a"] = (d, cfg["kv_rank"] + cfg["qk_rope"])
        shapes[f"{pre}/attn/kv_norm/scale"] = (cfg["kv_rank"],)
        shapes[f"{pre}/attn/kv_b"] = (cfg["kv_rank"],
                                      h * (cfg["qk_nope"] + cfg["v_dim"]))
        shapes[f"{pre}/attn/o"] = (h * cfg["v_dim"], d)
        shapes[f"{pre}/mlp_norm/scale"] = (d,)
        if layer < cfg["first_dense"]:
            shapes[f"{pre}/mlp/gate_up"] = (d, 2 * cfg["d_ff"])
            shapes[f"{pre}/mlp/down"] = (cfg["d_ff"], d)
        else:
            shared = cfg["n_shared"] * cfg["expert_ff"]
            shapes[f"{pre}/moe/router"] = (d, e)
            shapes[f"{pre}/moe/gate_up"] = (e, d, 2 * cfg["expert_ff"])
            shapes[f"{pre}/moe/down"] = (e, cfg["expert_ff"], d)
            shapes[f"{pre}/moe/shared_gate_up"] = (d, 2 * shared)
            shapes[f"{pre}/moe/shared_down"] = (shared, d)
    shapes["final_norm/scale"] = (d,)
    shapes["out/kernel"] = (d, cfg["n_features"])
    shapes["out/bias"] = (cfg["n_features"],)
    return shapes


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3's 4 significant bits (no saturation),
    kept in bfloat16."""
    m, e = torch.frexp(t.float())
    return torch.ldexp(torch.round(m * 16.0) / 16.0, e).to(torch.bfloat16)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g.float()


def cast(t: torch.Tensor, act: str) -> torch.Tensor:
    """An activation (or a weight, cast for a product) at ``act``."""
    if act == "bf16":
        return t.to(torch.bfloat16)
    if act == "fp8":
        return _Fp8.apply(t)
    raise ValueError(f"unknown activation precision {act!r}")


def linear(x: torch.Tensor, w: torch.Tensor, act: str) -> torch.Tensor:
    """``nn.Linear`` without bias in the model's dtype: ``x`` at ``act``
    times the weight cast to ``act`` (``[in, out]``), rounded to ``act``."""
    return cast(x @ cast(w, act), act)


def rmsnorm(h: torch.Tensor, weight: torch.Tensor, eps: float,
            act: str) -> torch.Tensor:
    """``DeepseekV3RMSNorm.forward``: float32 statistics, the row rounded
    to the input's dtype, times the (float32) weight, rounded to ``act``."""
    hs = h.to(torch.float32)
    variance = hs.pow(2).mean(-1, keepdim=True)
    hs = hs * torch.rsqrt(variance + eps)
    return cast(weight * cast(hs, act).float(), act)


def rotary(t: int, dim: int, theta: float, act: str, device) -> tuple:
    """``DeepseekV3RotaryEmbedding.forward`` (the default rope type,
    attention scaling 1) at positions 0..t-1: cos and sin ``[t, dim]`` in
    float32, cast to the activations' dtype."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64)
                                .to(torch.float) / dim))
    freqs = torch.arange(t, dtype=torch.float)[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return (cast(emb.cos().to(device), act).detach(),
            cast(emb.sin().to(device), act).detach())


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def rope_interleave(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    act: str) -> torch.Tensor:
    """``apply_rotary_pos_emb_interleave`` on ``x [b, h, s, d]``: the
    adjacent pairs taken apart (evens, then odds), then ``x cos +
    rotate_half(x) sin``, each product and the sum rounded to ``act``."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    c, si = cos[None, None, :s], sin[None, None, :s]
    return cast(cast(x.float() * c.float(), act).float()
                + cast(rotate_half(x).float() * si.float(), act).float(), act)


def attention(hs: torch.Tensor, params: dict, pre: str, cfg: dict,
              cos, sin, act: str) -> torch.Tensor:
    """``DeepseekV3Attention.forward`` (no query compression) with eager
    causal attention, then ``o_proj``."""
    b, s, _ = hs.shape
    h = cfg["n_heads"]
    nope, rope, vd = cfg["qk_nope"], cfg["qk_rope"], cfg["v_dim"]
    qk = nope + rope
    q_states = linear(hs, params[f"{pre}/attn/q"], act)
    q_states = q_states.view(b, s, h, qk).transpose(1, 2)
    q_pass, q_rot = torch.split(q_states, [nope, rope], dim=-1)
    compressed_kv = linear(hs, params[f"{pre}/attn/kv_a"], act)
    k_pass, k_rot = torch.split(compressed_kv, [cfg["kv_rank"], rope],
                                dim=-1)
    k_pass = linear(rmsnorm(k_pass, params[f"{pre}/attn/kv_norm/scale"],
                            cfg["kv_eps"], act),
                    params[f"{pre}/attn/kv_b"], act)
    k_pass = k_pass.view(b, s, h, nope + vd).transpose(1, 2)
    k_pass, value_states = torch.split(k_pass, [nope, vd], dim=-1)
    k_rot = k_rot.reshape(b, 1, s, rope)
    q_rot = rope_interleave(q_rot, cos, sin, act)
    k_rot = rope_interleave(k_rot, cos, sin, act)
    k_rot = k_rot.expand(*k_pass.shape[:-1], -1)
    query_states = torch.cat((q_pass, q_rot), dim=-1)
    key_states = torch.cat((k_pass, k_rot), dim=-1)
    logits = cast(query_states @ key_states.transpose(2, 3), act).float() \
        / math.sqrt(qk)
    causal = torch.ones(s, s, dtype=torch.bool, device=hs.device).tril()
    logits = logits.masked_fill(~causal, -1e30)
    weights = cast(torch.softmax(logits, dim=-1), act)
    out = cast(weights @ value_states, act)
    out = out.transpose(1, 2).reshape(b, s, h * vd)
    return linear(out, params[f"{pre}/attn/o"], act)


def mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
        act: str) -> torch.Tensor:
    """``DeepseekV3MLP.forward``: ``down(silu(gate(x)) * up(x))``, the
    gate and up weights side by side in ``gate_up``."""
    f = gate_up.shape[-1] // 2
    gate = linear(x, gate_up[..., :f], act)
    up = linear(x, gate_up[..., f:], act)
    s = cast(F.silu(gate.float()), act)
    return linear(cast(s.float() * up.float(), act), down, act)


class Routes:
    """The expert choices of a round's mixture layers, in the order they
    are made (each step's forward, layer by layer, then the forecast's).

    Without ``forced`` each choice is this run's own top-k, recorded in
    ``taken``. With ``forced`` (another run's ``taken``: the program's
    choices) the router takes those in turn instead, for as many rows as
    they cover, and ``margin`` keeps the largest shortfall of a forced
    choice against this run's own choice criterion: the best score left
    out minus the least score chosen, 0 where the forced choice is a top
    k of these scores. Routing is discrete: at bf16 two runs of this
    reference at the same precision but another summation order choose
    differently for 2-15% of the tokens of a layer, and each such flip
    moves the loss and gradients by far more than rounding does. So a
    comparison holds the choices to the margin and everything else to
    the run that follows them."""

    def __init__(self, forced: Optional[list] = None) -> None:
        self.forced = forced
        self.taken: list = []
        self.margin = 0.0

    def choose(self, choice: torch.Tensor, k: int) -> torch.Tensor:
        own = torch.topk(choice, k=k, dim=-1, sorted=True)[1]
        i = len(self.taken)
        if self.forced is None or i >= len(self.forced):
            idx = own
        else:
            given = self.forced[i].to(choice.device)
            n = min(len(given), len(own))
            idx = torch.cat([given[:n], own[n:]])
            chosen = choice.gather(1, idx).amin(-1)
            out = choice.scatter(1, idx, float("-inf")).amax(-1)
            self.margin = max(self.margin,
                              float((out - chosen).clamp(min=0).max()))
        self.taken.append(idx.detach())
        return idx


def router(hs: torch.Tensor, weight: torch.Tensor, cfg: dict,
           routes: Optional[Routes] = None) -> tuple:
    """``DeepseekV3TopkRouter.forward``: float32 logits, sigmoid scores,
    the top-k of the scores plus the (zero) correction bias (or the
    choice ``routes`` gives), the chosen scores normalised and scaled.
    Returns the indices (own choices in the order of their scores,
    highest first), the weights and the scores."""
    logits = hs.type(torch.float32) @ weight.type(torch.float32)
    scores = logits.sigmoid()
    bias = torch.zeros(cfg["n_experts"], device=hs.device)
    with torch.no_grad():
        choice = scores + bias.unsqueeze(0)
        if routes is None:
            topk_indices = torch.topk(choice, k=cfg["top_k"], dim=-1,
                                      sorted=True)[1]
        else:
            topk_indices = routes.choose(choice, cfg["top_k"])
    topk_weights = scores.gather(1, topk_indices)
    topk_weights = topk_weights / (topk_weights.sum(dim=-1, keepdim=True)
                                   + 1e-20)
    return topk_indices, topk_weights * cfg["route_scale"], scores


def moe(hs: torch.Tensor, params: dict, pre: str, cfg: dict, act: str,
        drop: Optional[str] = None,
        routes: Optional[Routes] = None) -> torch.Tensor:
    """``DeepseekV3MoE.forward`` on ``hs [b, s, d]``: the routed experts'
    float32 ``index_add_`` over the experts in turn, cast to ``act``,
    plus the shared experts. ``drop`` leaves out each token's sixth
    routed expert (``"sixth"``, the lowest scored of the ``top_k`` chosen,
    the sixth of Moonlight's six) or the
    shared experts (``"shared"``): faults to be caught."""
    orig_shape = hs.shape
    flat = hs.reshape(-1, hs.shape[-1])
    topk_indices, topk_weights, scores = router(
        flat, params[f"{pre}/moe/router"], cfg, routes)
    if drop == "sixth":  # the lowest scored chosen: the sixth at top 6
        low = scores.gather(1, topk_indices).argmin(-1, keepdim=True)
        topk_weights = topk_weights.scatter(1, low, 0.0)
    final = torch.zeros(flat.shape, dtype=topk_weights.dtype,
                        device=hs.device)
    gate_up, down = params[f"{pre}/moe/gate_up"], params[f"{pre}/moe/down"]
    for e in range(cfg["n_experts"]):
        token_indices, weight_indices = torch.where(topk_indices == e)
        if token_indices.numel() > 0:
            expert_weights = topk_weights[token_indices, weight_indices]
            expert_out = mlp(flat[token_indices], gate_up[e], down[e], act)
            weighted = expert_out.float() * expert_weights.unsqueeze(-1)
            final = final.index_add(0, token_indices, weighted)
    out = cast(final, act).view(*orig_shape)
    if drop == "shared":
        return out
    shared = mlp(hs, params[f"{pre}/moe/shared_gate_up"],
                 params[f"{pre}/moe/shared_down"], act)
    return cast(out.float() + shared.float(), act)


def forward(params: dict, x: torch.Tensor, cfg: dict, act: str = "bf16",
            drop: Optional[str] = None,
            routes: Optional[Routes] = None) -> torch.Tensor:
    """``x [batch, seq_len, n_features]`` float32 -> ``[batch,
    n_features]`` float32."""
    h = cast(cast(x, act) @ cast(params["embed/kernel"], act), act)
    h = cast(h.float() + cast(params["embed/bias"], act).float(), act)
    cos, sin = rotary(x.shape[1], cfg["qk_rope"], cfg["rope_theta"], act,
                      x.device)
    for layer in range(cfg["n_layers"]):
        pre = f"layer{layer}"
        residual = h
        hs = rmsnorm(h, params[f"{pre}/attn_norm/scale"], cfg["eps"], act)
        hs = attention(hs, params, pre, cfg, cos, sin, act)
        h = cast(residual.float() + hs.float(), act)
        residual = h
        hs = rmsnorm(h, params[f"{pre}/mlp_norm/scale"], cfg["eps"], act)
        if layer < cfg["first_dense"]:
            hs = mlp(hs, params[f"{pre}/mlp/gate_up"],
                     params[f"{pre}/mlp/down"], act)
        else:
            hs = moe(hs, params, pre, cfg, act, drop, routes)
        h = cast(residual.float() + hs.float(), act)
    last = rmsnorm(h[:, -1, :], params["final_norm/scale"], cfg["eps"], act)
    return last.float() @ params["out/kernel"] + params["out/bias"]


def train_step(params: dict, momentum: dict, batch: tuple, cfg: dict, *,
               lr: float, clip_norm: float = 1.0, act: str = "bf16",
               update: bool = True, drop: Optional[str] = None,
               routes: Optional[Routes] = None):
    """One step, in place on ``params`` and ``momentum`` (left as they
    are without ``update``): returns the float32 loss before the update.
    The parameters are the graph's leaves themselves (no copies: at the
    published widths they are most of the card)."""
    names = sorted(params)
    x, y = batch
    for n in names:
        params[n].requires_grad_(True)
    try:
        loss = torch.mean((forward(params, x, cfg, act, drop, routes)
                           - y) ** 2)
        # (a fault's unused leaves get zero gradients)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, torch.autograd.grad(
                     loss, [params[n] for n in names], allow_unused=True))]
    finally:
        for n in names:
            params[n].requires_grad_(False)
    if update:
        with torch.no_grad():
            sq = sum(torch.sum(g.float() ** 2) for g in grads)
            scale = torch.clamp(clip_norm * torch.rsqrt(sq + 1e-12), max=1.0)
            for n, g in zip(names, grads):
                momentum[n].mul_(0.9).add_(g.float() * scale)
                params[n].sub_(lr * momentum[n])
    return loss.detach()


def normalization(history: np.ndarray) -> tuple:
    """Per-feature mean and standard deviation (floored at 1e-3)."""
    mean = history.mean(axis=0)
    std = np.maximum(history.std(axis=0), 1e-3)
    return mean.astype(np.float32), std.astype(np.float32)


def training_pairs(normed: np.ndarray, seq_len: int, batch: int,
                   rng: np.random.Generator) -> tuple:
    """``batch`` windows at uniform starts and the vector after each."""
    starts = rng.integers(0, len(normed) - seq_len, size=batch)
    x = np.stack([normed[s:s + seq_len] for s in starts])
    y = np.stack([normed[s + seq_len] for s in starts])
    return x.astype(np.float32), y.astype(np.float32)


def first_round(params: dict, history: np.ndarray, cfg: dict, *,
                batch: int, steps: int, lr: float, keep_steps: int = 3,
                act: str = "bf16", rows: Optional[int] = None,
                update: bool = True, drop: Optional[str] = None,
                observe: Optional[Callable] = None,
                routes: Optional[Routes] = None, device="cuda") -> dict:
    """The service's first round from ``params`` (updated in place):
    each of the first ``keep_steps`` losses, the forecast in real units
    (clamped at 0) and, unless ``observe`` is given, the momentum after
    the first step (the clipped gradient) and the parameters after
    ``keep_steps`` steps; ``observe(k, params, momentum)`` is called after
    each step ``k`` instead (to keep less than whole copies). ``rows``,
    ``update`` and ``drop`` are the faults; ``routes`` takes (or forces)
    every expert choice of the round, the forecast's included."""
    mean, std = normalization(history)
    normed = (history - mean) / std
    x, y = training_pairs(normed, cfg["seq_len"], batch,
                          np.random.default_rng(0))
    if rows is not None:
        x, y = x[:rows], y[:rows]
    data = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"losses": [], "grads": None, "params": None}
    for k in range(1, steps + 1):
        loss = train_step(params, momentum, data, cfg, lr=lr, act=act,
                          update=update, drop=drop, routes=routes)
        if k <= keep_steps:
            out["losses"].append(float(loss))
        if observe is not None:
            observe(k, params, momentum)
            continue
        if k == 1:
            out["grads"] = {n: m.clone() for n, m in momentum.items()}
        if k == keep_steps:
            out["params"] = {n: p.clone() for n, p in params.items()}
    del momentum
    window = torch.from_numpy(
        normed[-cfg["seq_len"]:][None].astype(np.float32)).to(device)
    with torch.no_grad():
        pred = forward(params, window, cfg, act, drop,
                       routes)[0].float().cpu().numpy()
    out["forecast"] = np.maximum(pred * std + mean, 0.0)
    out["std"] = std
    return out
