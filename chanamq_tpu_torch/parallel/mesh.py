"""Mesh construction, sharding rules and the sharded train step for the
forecaster, over ``torch.distributed``.

The port of ``chanamq_tpu/parallel/mesh.py``. The reference annotates
shardings and lets GSPMD insert the collectives; here each rank holds its
shards and the collectives are written out (the Megatron pairing):

- mesh: ``world = dp * tp`` ranks, rank ``dp_index * tp + tp_index`` (the
  order of ``mesh_utils.create_device_mesh((dp, tp))``), one process group
  along each axis. The backend (``nccl`` or ``gloo``) and the device are
  the caller's, never chosen here;
- batch: split over ``dp`` on the leading axis;
- ``attn/qkv`` [d, 3d] and ``mlp/w1`` [d, f]: split by column over ``tp``;
  ``attn/proj`` [d, d] and ``mlp/w2`` [f, d]: split by row; everything
  else replicated (``_spec_for``, the reference's rule);
- ``attn/qkv``'s columns are regrouped before they are split: the
  attention kernel reads a fused product as q | k | v blocks
  (``kernels/forecaster.py``), so rank r holds [q | k | v columns of its
  heads], ``n_heads / tp`` whole heads. ``gather_params`` undoes it;
  momentum is laid out alike;
- forward: ``_EnterTP`` (identity; its backward all-reduces over tp)
  before each column-split product, ``_LeaveTP`` (all-reduce over tp;
  identity backward) after each row-split one. A partial product comes in
  the activations' type (bf16), is cast up to float32 for the all-reduce
  and rounded back once, as one product over all its rows rounds once;
  the backward's all-reduce does the same;
- gradients: one float32 all-reduce over dp of every gradient and the
  loss, divided by dp (the global loss is the dp mean of the ranks'
  losses); then the global norm, ``all_reduce_tp(sum g^2 over the
  sharded leaves) + sum g^2 over the replicated leaves``, the replicated
  leaves counted once, and the update (``kernels/update.py``'s two
  launches apart), in place, as the reference donates its buffers.

A replicated leaf sees the same inputs and the same all-reduced values on
every tp rank, so it ends each step bit-equal on all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..kernels import forecaster as kernels
from ..models.forecaster import (
    ForecasterConfig, Params, TensorParallel, loss_fn, param_shapes)

BACKENDS = ("nccl", "gloo")
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, tp) mesh and its two process groups."""
    dp: int
    tp: int
    rank: int
    backend: str
    device: torch.device
    dp_group: Any
    tp_group: Any

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def mesh_shape(world: int, tp: Optional[int] = None) -> tuple[int, int]:
    """``(dp, tp)`` for ``world`` ranks. With no ``tp``, the reference's
    rule (``mesh.py:34-40``): the widest of 4 and 2 that divides the world
    while leaving dp >= 2, else 1."""
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if world % cand == 0 and world // cand >= 2:
                tp = cand
                break
    if world < 1 or tp < 1 or world % tp:
        raise ValueError(f"tp {tp} does not divide a world of {world}")
    return world // tp, tp


def make_mesh(world: Optional[int] = None, tp: Optional[int] = None, *,
              backend: str, device="cuda") -> Mesh:
    """Build this rank's (dp, tp) mesh over the ``world`` ranks of the
    default process group (``init_process_group``, which the caller
    starts with the same ``backend``). Every rank must call it, in the
    same order: it makes every dp and tp group. ``device`` holds this
    rank's tensors (a card for ``nccl``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first")
    if dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group's backend is "
                         f"{dist.get_backend()!r}, not {backend!r}")
    size = dist.get_world_size()
    world = size if world is None else world
    if world != size:
        raise ValueError(f"make_mesh: world {world}, process group {size}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: nccl needs a card, not {device}")
    dp, tp = mesh_shape(world, tp)
    rank = dist.get_rank()
    dp_group = tp_group = None
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        group = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            tp_group = group
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        group = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            dp_group = group
    return Mesh(dp, tp, rank, backend, device, dp_group, tp_group)


def _spec_for(name: str) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple: the mesh axis each
    dimension is split over (``()``: replicated)."""
    if name.endswith("attn/qkv") or name.endswith("mlp/w1"):
        return (None, "tp")
    if name.endswith("attn/proj") or name.endswith("mlp/w2"):
        return ("tp", None)
    return ()  # replicated: norms, biases, embed, pos, head


def param_shardings(mesh: Mesh, params: Params) -> dict[str, tuple]:
    return {name: _spec_for(name) for name in params}


def batch_sharding(mesh: Mesh) -> tuple:
    return ("dp",)


def _param_names(cfg: ForecasterConfig) -> list[str]:
    names = ["embed/kernel", "embed/bias", "pos", "out/kernel", "out/bias"]
    for layer in range(cfg.n_layers):
        pre = f"layer{layer}"
        names += [
            f"{pre}/ln1/scale", f"{pre}/ln2/scale",
            f"{pre}/attn/qkv", f"{pre}/attn/proj",
            f"{pre}/mlp/w1", f"{pre}/mlp/w2",
        ]
    return names


# -- the qkv regroup --------------------------------------------------------------


def regroup_qkv(qkv: torch.Tensor, tp: int) -> torch.Tensor:
    """``qkv`` [d, 3d] (q | k | v) with its columns reordered so that the
    r-th of ``tp`` equal column blocks is [q | k | v columns of the r-th
    ``d / tp`` columns of each]: rank r's heads, as the kernel reads
    them."""
    d = qkv.shape[0]
    return qkv.reshape(d, 3, tp, -1).transpose(1, 2).reshape(d, 3 * d)


def ungroup_qkv(qkv: torch.Tensor, tp: int) -> torch.Tensor:
    """The inverse of ``regroup_qkv``: the reference's q | k | v layout."""
    d = qkv.shape[0]
    return qkv.reshape(d, tp, 3, -1).transpose(1, 2).reshape(d, 3 * d)


# -- placement --------------------------------------------------------------------


def _shard(mesh: Mesh, name: str, full: torch.Tensor) -> torch.Tensor:
    spec = _spec_for(name)
    if name.endswith("attn/qkv"):
        full = regroup_qkv(full, mesh.tp)
    if spec:
        dim = spec.index("tp")
        if full.shape[dim] % mesh.tp:
            raise ValueError(f"{name}: {full.shape[dim]} does not split "
                             f"over tp {mesh.tp}")
        full = full.chunk(mesh.tp, dim=dim)[mesh.tp_index]
    return full.to(mesh.device, _F32).contiguous().clone()


def place_params(mesh: Mesh, params: Params) -> Params:
    """This rank's shards of full float32 parameters (or a momentum tree),
    on ``mesh.device``."""
    return {name: _shard(mesh, name, value) for name, value in params.items()}


def place_batch(mesh: Mesh, batch: Any) -> tuple:
    """This rank's dp part of an ``(x, y)`` batch, on ``mesh.device``."""
    out = []
    for part in batch:
        if part.shape[0] % mesh.dp:
            raise ValueError(f"batch of {part.shape[0]} does not split over "
                             f"dp {mesh.dp}")
        out.append(part.chunk(mesh.dp)[mesh.dp_index].to(
            mesh.device).contiguous())
    return tuple(out)


def place(mesh: Mesh, params: Params, batch: Any):
    """``place_params`` and ``place_batch``."""
    return place_params(mesh, params), place_batch(mesh, batch)


def gather_params(mesh: Mesh, params: Params) -> Params:
    """The full parameters (or momentum) in the reference's layout from
    every tp rank's shards; every rank of a tp group calls it."""
    out = {}
    for name, local in params.items():
        spec = _spec_for(name)
        if not spec:
            out[name] = local.clone()
            continue
        parts = [torch.empty_like(local) for _ in range(mesh.tp)]
        dist.all_gather(parts, local.contiguous(), group=mesh.tp_group)
        full = torch.cat(parts, dim=spec.index("tp"))
        out[name] = ungroup_qkv(full, mesh.tp) if name.endswith(
            "attn/qkv") else full
    return out


# -- collectives ------------------------------------------------------------------


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, added in float32 and rounded to
    ``t``'s type once."""
    buf = t.to(_F32, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


class _EnterTP(torch.autograd.Function):
    """Before a column-split product: identity forward; the backward adds
    the ranks' partial input gradients over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_f32(dy, ctx.group), None


class _LeaveTP(torch.autograd.Function):
    """After a row-split product: the ranks' partial products added over
    tp; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def tensor_parallel(mesh: Mesh, cfg: ForecasterConfig) -> TensorParallel:
    """The forward's hooks for this rank: its heads and the collectives."""
    if cfg.n_heads % mesh.tp or cfg.d_ff % mesh.tp:
        raise ValueError(f"{cfg.n_heads} heads and d_ff {cfg.d_ff} must "
                         f"split over tp {mesh.tp}")
    group = mesh.tp_group
    return TensorParallel(cfg.n_heads // mesh.tp,
                          lambda t: _EnterTP.apply(t, group),
                          lambda t: _LeaveTP.apply(t, group))


# -- the step ---------------------------------------------------------------------


def make_sharded_train_step(mesh: Mesh, cfg: ForecasterConfig,
                            lr: float = 1e-3,
                            clip_norm: Optional[float] = 1.0, *,
                            ops: kernels.Ops = kernels.KERNELS) -> Callable:
    """The reference's train step (``forecaster.py:130-157``) on this
    rank's shards: ``step(params, momentum, batch) -> (params, momentum,
    loss)`` with ``place_params``' shards and ``place_batch``'s part.
    Forward and backward run through ``ops`` (the kernels and their
    autograd Functions), the update through ``ops.sum_of_squares`` and
    ``ops.momentum_sgd``; ``params`` and ``momentum`` are updated in place
    and returned; ``loss`` is the global loss before the update, a float32
    tensor on the device, the same on every rank."""
    tp = tensor_parallel(mesh, cfg)
    names = sorted(param_shapes(cfg))  # the reference's tree_leaves order
    sharded = [n for n in names if _spec_for(n)]
    replicated = [n for n in names if not _spec_for(n)]

    def step(params: Params, momentum: Params, batch: tuple) -> tuple:
        leaves = {n: params[n].detach().requires_grad_() for n in names}
        loss = loss_fn(leaves, batch, cfg, ops=ops, tp=tp)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=mesh.dp_group)
        flat.div_(mesh.dp)
        g, at = {}, 0
        for n, grad in zip(names, grads):
            g[n] = flat[at:at + grad.numel()].view(grad.shape)
            at += grad.numel()
        sq = None
        if clip_norm is not None:
            sq_sharded = torch.empty(1, dtype=_F32, device=flat.device)
            sq_replicated = torch.empty(1, dtype=_F32, device=flat.device)
            ops.sum_of_squares([g[n] for n in sharded], sq_sharded)
            ops.sum_of_squares([g[n] for n in replicated], sq_replicated)
            dist.all_reduce(sq_sharded, group=mesh.tp_group)
            sq = sq_sharded + sq_replicated
        ops.momentum_sgd([params[n] for n in names],
                         [momentum[n] for n in names],
                         [g[n] for n in names], lr, sq, clip_norm)
        return params, momentum, flat[at:].reshape(())

    return step
