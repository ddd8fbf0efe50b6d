"""Plain PyTorch reference of the flagship forecaster and its training round.

Written from the model's equations, independent of the program: a causal
transformer over telemetry windows (``embed`` + ``pos``, then per layer a
scale-only layernorm with eps 1e-6, causal multi-head attention and a
tanh-GELU MLP, each added to the residual), a float32 head on the last
position, the mean squared error, and a step of SGD with momentum 0.9 after
a global-norm clip at 1.0. Parameters, loss, clip and update are float32;
activations are rounded to ``act`` (bfloat16, as the configuration states)
where the model rounds them, and every product accumulates in float32.
``act="fp8"`` rounds those same activations to 3 mantissa bits (float8
e4m3) instead: the control, one precision below the stated one.

A round is what the forecast service does with a telemetry history:
z-score it per feature, draw ``batch`` windows and their next vectors
(numpy ``default_rng(0)``: the service's generator, one draw a round),
train ``steps`` steps on them, and forecast the next vector from the
newest window. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

def set_precision() -> None:
    """Products in full float32 (no TF32) and bfloat16 products that
    accumulate in float32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def param_shapes(cfg: dict) -> dict:
    """Every parameter's name and ``[in, out]`` shape."""
    d, f, ff = cfg["d_model"], cfg["n_features"], cfg["d_ff"]
    shapes = {"embed/kernel": (f, d), "embed/bias": (d,),
              "pos": (cfg["seq_len"], d), "out/kernel": (d, f),
              "out/bias": (f,)}
    for layer in range(cfg["n_layers"]):
        pre = f"layer{layer}"
        shapes[f"{pre}/ln1/scale"] = (d,)
        shapes[f"{pre}/ln2/scale"] = (d,)
        shapes[f"{pre}/attn/qkv"] = (d, 3 * d)
        shapes[f"{pre}/attn/proj"] = (d, d)
        shapes[f"{pre}/mlp/w1"] = (d, ff)
        shapes[f"{pre}/mlp/w2"] = (ff, d)
    return shapes


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3's 4 significant bits (no saturation:
    the activations stay far below its 448), kept in bfloat16."""
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


def _layernorm(h: torch.Tensor, scale: torch.Tensor, act: str):
    x = h.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return cast((x - mu) * torch.rsqrt(var + 1e-6) * scale, act)


def _gelu(x: torch.Tensor, act: str) -> torch.Tensor:
    return cast(F.gelu(x.float(), approximate="tanh"), act)


def _attention(a, qkv, proj, n_heads: int, act: str):
    b, t, d = a.shape
    hd = d // n_heads
    fused = cast(a @ cast(qkv, act), act)
    q, k, v = (z.reshape(b, t, n_heads, hd).transpose(1, 2)
               for z in fused.split(d, dim=-1))
    logits = cast(q @ k.transpose(-1, -2), act).float() / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    logits = logits.masked_fill(~causal, -1e30)
    weights = cast(torch.softmax(logits, dim=-1), act)
    out = cast(weights @ v, act).transpose(1, 2).reshape(b, t, d)
    return cast(out @ cast(proj, act), act)


def forward(params: dict, x: torch.Tensor, cfg: dict,
            act: str = "bf16") -> torch.Tensor:
    """``x [batch, seq_len, n_features]`` float32 -> ``[batch,
    n_features]`` float32."""
    h = cast(cast(x, act) @ cast(params["embed/kernel"], act), act)
    h = cast(h + cast(params["embed/bias"], act), act)
    h = cast(h + cast(params["pos"], act)[None, :x.shape[1]], act)
    for layer in range(cfg["n_layers"]):
        pre = f"layer{layer}"
        a = _layernorm(h, params[f"{pre}/ln1/scale"], act)
        h = cast(h + _attention(a, params[f"{pre}/attn/qkv"],
                                params[f"{pre}/attn/proj"],
                                cfg["n_heads"], act), act)
        m = _layernorm(h, params[f"{pre}/ln2/scale"], act)
        m = _gelu(cast(m @ cast(params[f"{pre}/mlp/w1"], act), act), act)
        m = cast(m @ cast(params[f"{pre}/mlp/w2"], act), act)
        h = cast(h + m, act)
    last = h[:, -1, :].float()
    return last @ params["out/kernel"] + params["out/bias"]


def train_step(params: dict, momentum: dict, batch: tuple, cfg: dict, *,
               lr: float, clip_norm: float = 1.0, act: str = "bf16",
               update: bool = True) -> torch.Tensor:
    """One step, in place on ``params`` and ``momentum`` (left as they
    are without ``update``: a fault to be caught): returns the float32
    loss before the update."""
    names = sorted(params)
    leaves = {n: params[n].detach().clone().requires_grad_()
              for n in names}
    x, y = batch
    loss = torch.mean((forward(leaves, x, cfg, act) - y) ** 2)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
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
                update: bool = True, device="cuda") -> dict:
    """The service's first round from ``params`` (updated in place):
    each of the first ``keep_steps`` losses, the momentum after the first
    step (the clipped gradient: it starts at zero), the parameters after
    ``keep_steps`` steps, and the forecast in real units (clamped at 0).
    ``rows`` < ``batch`` trains on the first ``rows`` pairs alone, and
    ``update=False`` leaves the state as it was (faults to be caught)."""
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
                          update=update)
        if k <= keep_steps:
            out["losses"].append(float(loss))
        if k == 1:
            out["grads"] = {n: m.clone() for n, m in momentum.items()}
        if k == keep_steps:
            out["params"] = {n: p.clone() for n, p in params.items()}
    window = torch.from_numpy(
        normed[-cfg["seq_len"]:][None].astype(np.float32)).to(device)
    with torch.no_grad():
        pred = forward(params, window, cfg, act)[0].float().cpu().numpy()
    out["forecast"] = np.maximum(pred * std + mean, 0.0)
    out["std"] = std
    return out
