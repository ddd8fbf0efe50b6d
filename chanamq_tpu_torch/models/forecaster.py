"""Broker-metrics forecaster: a small causal transformer in PyTorch.

The port of ``chanamq_tpu/models/forecaster.py``. Input: a window of
per-tick broker telemetry vectors (models/telemetry.py's FEATURES);
output: the forecast telemetry vector for the next tick. Used for backlog
and capacity prediction, never on the message path; models/service.py runs
the live loop.

``forward`` computes what the reference's ``forward`` computes, at its
rounding points: activations in ``cfg.dtype`` (bf16 by default), and
every step through the hand-written kernels of ``kernels/forecaster.py``
and ``kernels/products.py`` (``ops``; on CPU tensors those run their
plain versions): the embed, the four products of each layer (the residual
adds in ``proj``'s and ``w2``'s epilogue, the tanh-GELU in ``w1``'s) and
the float32 head, the layernorm and the attention core. The plain
versions on a card take bf16 products that accumulate in float32, as the
reference's do, and float32 products, not TF32: ``set_matmul_precision``
sets both, and ``forward`` refuses CUDA tensors while torch allows less.

``make_train_step`` is the reference's SGD-with-momentum step: the MSE
loss's gradients by torch autograd (every op's backward pass is a kernel
too, ``kernels.KERNELS``, the products' gradients among them), then the
global-norm clip, momentum and SGD update as two kernel launches
(``kernels/update.py``), in place.

Parameters are the reference's flat ``{name: tensor}`` set, float32, in its
``[in, out]`` layout and under its names. ``init_params`` draws the
reference's numbers from the same key (``prng``, numpy's threefry), and
``params_from_numpy`` carries any other JAX parameters (and a momentum
tree) across. The reference casts each weight matrix to ``cfg.dtype`` on
every call (forecaster.py:106-117); ``cast_weights`` does that once per
parameter set for a caller that forwards many times between updates, and
the train step casts inside its autograd graph on every step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import profile
from ..kernels import forecaster as kernels
from . import prng


@dataclasses.dataclass(frozen=True)
class ForecasterConfig:
    n_features: int = 8
    seq_len: int = 64
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 1024
    n_layers: int = 4
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


Params = dict[str, torch.Tensor]

_CAST = ("attn/qkv", "attn/proj", "mlp/w1", "mlp/w2")


def param_shapes(cfg: ForecasterConfig) -> dict[str, tuple]:
    """Every parameter's name and shape, in the reference's draw order."""
    shapes = {
        "embed/kernel": (cfg.n_features, cfg.d_model),
        "embed/bias": (cfg.d_model,),
        "pos": (cfg.seq_len, cfg.d_model),
        "out/kernel": (cfg.d_model, cfg.n_features),
        "out/bias": (cfg.n_features,),
    }
    for layer in range(cfg.n_layers):
        pre = f"layer{layer}"
        shapes[f"{pre}/ln1/scale"] = (cfg.d_model,)
        shapes[f"{pre}/ln2/scale"] = (cfg.d_model,)
        shapes[f"{pre}/attn/qkv"] = (cfg.d_model, 3 * cfg.d_model)
        shapes[f"{pre}/attn/proj"] = (cfg.d_model, cfg.d_model)
        shapes[f"{pre}/mlp/w1"] = (cfg.d_model, cfg.d_ff)
        shapes[f"{pre}/mlp/w2"] = (cfg.d_ff, cfg.d_model)
    return shapes


def init_params(key, cfg: ForecasterConfig, device="cuda") -> Params:
    """Flat ``{name: float32 tensor}`` parameters, the reference's
    ``init_params(key, cfg)`` (forecaster.py:48-74): ``key`` is a
    ``jax.random`` key as ``prng.key`` gives it (uint32 ``[2]``) or a seed
    for one. The draws are the reference's (``prng``): the same split of
    the key, the keys taken in the same order, and the same float32 scale
    multiply, made on the host and moved to ``device``."""
    if np.ndim(key) == 0:
        key = prng.key(key)
    keys = iter(prng.split(key, 4 + 6 * cfg.n_layers))
    p: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("/bias"):
            p[name] = torch.zeros(shape)
        elif name.endswith("/scale"):
            p[name] = torch.ones(shape)
        else:
            std = 0.02 if name == "pos" else 1.0 / math.sqrt(shape[0])
            p[name] = torch.from_numpy(
                prng.normal(next(keys), shape) * np.float32(std))
    return {k: v.to(device) for k, v in p.items()}


def params_from_numpy(params: dict, cfg: ForecasterConfig,
                      device="cuda") -> Params:
    """Parameters given as ``{name: array}`` (the JAX package's, through
    ``np.asarray``) as float32 tensors on ``device``. Raises unless the
    names and shapes are exactly those ``cfg`` needs. A momentum tree has
    the parameters' names and shapes and crosses the same way."""
    shapes = param_shapes(cfg)
    if set(params) != set(shapes):
        raise ValueError(
            f"parameter names differ: missing "
            f"{sorted(set(shapes) - set(params))}, unexpected "
            f"{sorted(set(params) - set(shapes))}")
    out: Params = {}
    for name, shape in shapes.items():
        arr = np.asarray(params[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(arr.copy()).to(device)
    return out


def cast_weights(params: Params, cfg: ForecasterConfig) -> Params:
    """What ``forward`` reads in ``cfg.dtype``: the embedding, the position
    table and each layer's four product weights, cast once. The layernorm
    scales and the head stay float32, as the reference uses them."""
    names = ["embed/kernel", "embed/bias", "pos"] + [
        f"layer{layer}/{w}" for layer in range(cfg.n_layers) for w in _CAST]
    return {name: params[name].to(cfg.dtype) for name in names}


def set_matmul_precision() -> None:
    """Matrix products on the card as the reference computes them: bf16
    products accumulate in float32 and float32 products do not round
    through TF32. These are process-wide torch flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _check_matmul_precision() -> None:
    flags = torch.backends.cuda.matmul
    if flags.allow_tf32 or flags.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "the forecaster's products would accumulate below float32 "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "allow_bf16_reduced_precision_reduction is set); call "
            "set_matmul_precision() first")


class TensorParallel(NamedTuple):
    """One rank's part of a tensor-parallel forward (``parallel/mesh.py``):
    its ``params`` hold its columns of ``attn/qkv`` (as q | k | v blocks of
    its ``n_heads`` heads) and ``mlp/w1`` and its rows of ``attn/proj`` and
    ``mlp/w2``; ``enter`` is applied to each column-split product's input
    and ``leave`` to each row-split product's output (the collectives)."""
    n_heads: int
    enter: Callable
    leave: Callable


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def forward(params: Params, x: torch.Tensor, cfg: ForecasterConfig, *,
            weights: Optional[Params] = None,
            ops: kernels.Ops = kernels.KERNELS,
            tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x: [batch, seq_len, n_features] float32 -> forecast [batch,
    n_features] float32. ``weights`` is ``cast_weights(params, cfg)``,
    cast here when not given; ``ops`` the products, layernorm and
    attention to run (the kernels' ops, or ``kernels.PLAIN`` to compare);
    ``tp`` this rank's part when the products are split over ranks (None:
    the whole model here). On a card it raises unless
    ``set_matmul_precision()`` holds."""
    if x.is_cuda:
        _check_matmul_precision()
    tp = tp or TensorParallel(cfg.n_heads, _same, _same)
    w = cast_weights(params, cfg) if weights is None else weights
    b, t, _ = x.shape

    def residual(h: torch.Tensor, y: torch.Tensor, name: str):
        """``h + y @ w[name]``: in the product's epilogue on one device; a
        tp rank's row-split product is a partial sum, added up over the
        ranks (``tp.leave``) before the add."""
        if tp.leave is _same:
            return ops.product(y, w[name], h)
        return h + tp.leave(ops.product(y, w[name]))

    h = ops.product(x.to(cfg.dtype), w["embed/kernel"])
    h = h + w["embed/bias"]
    h = h + w["pos"][None, :t]
    for layer in range(cfg.n_layers):
        pre = f"layer{layer}"
        a = tp.enter(ops.layernorm(h, params[f"{pre}/ln1/scale"]))
        fused = ops.product(a, w[f"{pre}/attn/qkv"])
        att = ops.causal_attention(fused, tp.n_heads)
        h = residual(h, att, f"{pre}/attn/proj")
        m = tp.enter(ops.layernorm(h, params[f"{pre}/ln2/scale"]))
        m = ops.product_gelu(m, w[f"{pre}/mlp/w1"])
        h = residual(h, m, f"{pre}/mlp/w2")
    last = h[:, -1, :].to(torch.float32)
    return ops.head(last, params["out/kernel"]) + params["out/bias"]


def loss_fn(params: Params, batch: tuple, cfg: ForecasterConfig, *,
            weights: Optional[Params] = None,
            ops: kernels.Ops = kernels.KERNELS,
            tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Mean squared error of ``forward`` on ``batch = (x, y)``."""
    x, y = batch
    pred = forward(params, x, cfg, weights=weights, ops=ops, tp=tp)
    return torch.mean((pred - y) ** 2)


def init_momentum(params: Params) -> Params:
    """Zero momentum for ``params``: same names, shapes and device."""
    return {name: torch.zeros_like(p) for name, p in params.items()}


def make_train_step(cfg: ForecasterConfig, lr: float = 1e-3,
                    clip_norm: Optional[float] = 1.0, *,
                    ops: kernels.Ops = kernels.KERNELS) -> Callable:
    """The reference's SGD-with-momentum train step (forecaster.py:130-157):
    ``step(params, momentum, batch) -> (params, momentum, loss)``.

    The loss and its gradients come from ``loss_fn`` under torch autograd,
    the weights cast to ``cfg.dtype`` inside the graph on every step; the
    gradients, in the reference's ``tree_leaves`` order (sorted names),
    are clipped by their global norm (``clip_norm``, None for none), fed
    into momentum 0.9 and applied with ``lr`` by ``ops.update``. ``params``
    and ``momentum`` are updated in place, as the reference donates both
    buffers, and returned; ``loss`` is the step's loss before the update,
    a float32 tensor on the device (reading it is the caller's sync).
    ``ops`` picks the kernels (``kernels.KERNELS``) or the plain versions
    under torch autograd (``kernels.PLAIN``). With profiling on, the step
    and its forward, backward and update are the ``train-*`` stages
    (``profile.span``)."""
    names = sorted(param_shapes(cfg))

    def step(params: Params, momentum: Params, batch: tuple) -> tuple:
        with profile.span(profile.TRAIN_STEP):
            leaves = {n: params[n].detach().requires_grad_() for n in names}
            with profile.span(profile.TRAIN_FORWARD):
                loss = loss_fn(leaves, batch, cfg, ops=ops)
            with profile.span(profile.TRAIN_BACKWARD):
                grads = torch.autograd.grad(loss,
                                            [leaves[n] for n in names])
            with profile.span(profile.TRAIN_UPDATE):
                ops.update([params[n] for n in names],
                           [momentum[n] for n in names],
                           [g.contiguous() for g in grads], lr, clip_norm)
        return params, momentum, loss.detach()

    return step


def synthetic_batch(rng: np.random.Generator, cfg: ForecasterConfig,
                    batch: int, device="cuda") -> tuple:
    """Synthetic telemetry, noisy seasonal rates (for tests and smoke
    runs): ``(x [batch, seq_len, n_features], y [batch, n_features])``
    float32 on ``device``, drawn from a numpy generator."""
    t = np.arange(cfg.seq_len + 1, dtype=np.float32)
    phase = rng.uniform(size=(batch, 1, cfg.n_features)) * 2 * np.pi
    freq = 0.1 + rng.uniform(size=(batch, 1, cfg.n_features)) * 0.3
    series = np.sin(t[None, :, None] * freq + phase) + 1.5
    series = series + rng.normal(size=series.shape) * 0.05
    series = torch.from_numpy(series.astype(np.float32)).to(device)
    return series[:, :-1, :].contiguous(), series[:, -1, :].contiguous()
