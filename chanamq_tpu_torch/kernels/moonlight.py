"""The Moonlight backbone's kernels: CUDA wrappers, launch counts, plain
versions, and the differentiable ops its forward and train step take.

The backbone (``models/moonlight.py``) is DeepSeek-V3's block as
Moonlight-16B-A3B sizes it: latent attention (queries and keys 192 wide,
128 plain and 64 rotated, values 128, a 512-wide key-value latent), one
dense SwiGLU layer, then layers of 64 sigmoid-routed SwiGLU experts (top
6) beside shared experts. Besides ``products.py``'s bf16 and float32
products and ``forecaster.py``'s attention (the warpgroup forward and
the long-window backward pair at q and k width 192 with v width 128), it
takes the kernels of ``csrc/moonlight.cu``:

- ``rmsnorm`` (and ``rmsnorm_bwd``): ``bf16(w * float(bf16(x *
  rsqrt(mean(x^2) + eps))))``, the modeling file's RMSNorm with a float32
  weight, over the first ``width`` columns of rows that may be wider;
- ``mla_qkv`` (``mla_qkv_bwd``): the attention's fused ``[B, T, 3, H,
  192]`` operand from the query product, the latent's key-value product
  and the shared rotated key, with the rotary positions (adjacent pairs,
  the config's ``rope_interleave``) and the values padded with zeros;
- ``swiglu`` (``swiglu_bwd``): ``bf16(bf16(silu(g)) * u)`` over a gate |
  up product;
- ``route_weights`` (``route_weights_bwd``): the chosen sigmoid scores,
  normalised and scaled;
- ``gather_rows`` / ``token_sum``: each token's row copied to its experts'
  rows (sorted by expert) and the sum of their gradients back;
- ``combine`` (``combine_bwd``): the experts' rows weighted and summed in
  float32, plus the shared experts and the residual;
- ``router_product``: the router's float32 logits and their gradients;
- ``grouped_product``: every expert's product in one launch over rows
  sorted by expert, the groups' offsets read on the device (forward, dX,
  dW).

On CUDA tensors each wrapper launches its kernel (built on first use,
``build.py``) or raises; on CPU tensors it runs its plain version
(``*_ref``), which rounds where the kernel rounds. Nothing falls back from
one to the other. Each wrapper's ``launches`` counts its kernel launches
(``launch_count`` sums them). ``KERNELS`` and ``PLAIN`` are the two op sets
(``Ops``): the autograd Functions over the kernels, and the plain versions
that torch autograd differentiates.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from . import build, products
from . import forecaster as fk

_BF16 = torch.bfloat16
_F32 = torch.float32
_ptr = ctypes.c_void_p
_int = ctypes.c_int
_ll = ctypes.c_longlong
_float = ctypes.c_float

NOPE = 128     # qk_nope_head_dim
ROPE = 64      # qk_rope_head_dim
QK = NOPE + ROPE  # 192
V = 128        # v_head_dim
LATENT = 512   # kv_lora_rank
KVA = LATENT + ROPE  # the latent product's width
RMS_WIDTHS = (256, 512, 1024, 2048)  # rows the RMSNorm kernels take
GROUP_TILE = 128  # the grouped product's output tile (rows and columns)
GROUP_DEPTH = 32  # its K depth a stage


def library() -> ctypes.CDLL:
    """The built ``csrc/moonlight.cu`` with its C signatures declared."""
    lib, _ = build.load("moonlight")
    if not getattr(lib, "_chana_typed", False):
        sig = {
            "chana_rmsnorm_blocks": [_int],
            "chana_rmsnorm": [_ptr, _ll, _ptr, _ptr, _ll, _int, _int,
                              _float, _ptr],
            "chana_rmsnorm_bwd": [_ptr, _ptr, _ll, _ptr, _ptr, _ll, _ptr,
                                  _ptr, _int, _int, _float, _ptr],
            "chana_mla_qkv": [_ptr] * 5 + [_ll, _int, _int, _ptr],
            "chana_mla_qkv_bwd": [_ptr] * 5 + [_ll, _int, _int, _ptr],
            "chana_swiglu": [_ptr, _ptr, _ll, _int, _ptr],
            "chana_swiglu_bwd": [_ptr] * 3 + [_ll, _int, _ptr],
            "chana_route_weights": [_ptr] * 3 + [_int] * 3 + [_float, _ptr],
            "chana_route_weights_bwd": [_ptr] * 4 + [_int] * 3 + [_float,
                                                                  _ptr],
            "chana_gather_rows": [_ptr] * 3 + [_ll, _int, _ptr],
            "chana_token_sum": [_ptr] * 3 + [_ll, _int, _int, _ptr],
            "chana_combine": [_ptr] * 6 + [_ll, _int, _int, _ptr],
            "chana_combine_bwd": [_ptr] * 6 + [_ll, _int, _int, _ptr],
            "chana_grouped_product": [_ptr] * 5 + [_int] * 6 + [_ptr],
            "chana_router_product": [_ptr] * 4 + [_int] * 5 + [_ptr],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_typed = True
    return lib


def _launch(name: str, device, fn_name: str, *args) -> None:
    lib = library()
    build.launcher(lib, getattr(lib, fn_name), name, device, *args)()


def _counted(fn: Callable) -> Callable:
    fn.launches = 0
    return fn


def _vjp(fn: Callable, inputs: tuple, cotangent: torch.Tensor) -> tuple:
    """The gradients of ``fn(*inputs)`` for ``cotangent`` by torch autograd:
    a backward wrapper's plain version, from its forward's."""
    with torch.enable_grad():  # a Function's backward runs without it
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, cotangent)


# -- RMSNorm -------------------------------------------------------------------


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain RMSNorm (any device, any float dtype): float32 statistics,
    the normalised row rounded to ``x``'s dtype before the float32 weight
    multiplies it, the product rounded again (the modeling file's
    ``weight * hidden_states.to(input_dtype)``)."""
    xf = x.to(_F32)
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (w * (xf * r).to(x.dtype)).to(x.dtype)


def _check_rms(name: str, x, w, width: int, device) -> None:
    if x.dtype != _BF16:
        raise TypeError(f"{name}: x dtype {x.dtype}, expected {_BF16}")
    build.check("w", w, _F32, 1, device)
    if width not in RMS_WIDTHS or w.shape[0] != width:
        raise ValueError(f"{name}: width {width}, weight {tuple(w.shape)}; "
                         f"the kernels take widths {RMS_WIDTHS}")


@_counted
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of the rows of a 2-d ``x`` over its ``w.shape[0]`` first
    columns (``x`` may be wider and a view: a row stride is taken) into a
    new ``[R, width]``. One launch."""
    width = w.shape[0]
    if x.device.type == "cpu":
        return rmsnorm_ref(x[..., :width], w, eps)
    device = build.cuda_device("rmsnorm", x)
    _check_rms("rmsnorm", x, w, width, device)
    r, ld = x.shape[0], x.stride(0)
    if x.dim() != 2 or x.stride(1) != 1 or x.shape[1] < width or ld % 8:
        raise ValueError("rmsnorm: x must be [R, >= width] rows, 16-byte "
                         "aligned, unit column stride")
    out = torch.empty((r, width), dtype=_BF16, device=device)
    if r:
        build.aligned("rmsnorm", x, out)
        _launch("rmsnorm", device, "chana_rmsnorm", x.data_ptr(), ld,
                w.data_ptr(), out.data_ptr(), width, r, width, float(eps))
        rmsnorm.launches += 1
    return out


@_counted
def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                eps: float, full: int) -> tuple:
    """(dx ``[R, full]``, zeros past ``width``; dw ``[width]`` float32) of
    ``rmsnorm(x, w, eps)`` for the cotangent ``dy [R, width]``. Two
    launches (dx and the blocks' partial dw, then their sum)."""
    width = w.shape[0]
    if x.device.type == "cpu":
        return _vjp(lambda a, b: rmsnorm_ref(a[..., :width], b, eps),
                    (x, w), dy)
    device = build.cuda_device("rmsnorm_bwd", x)
    _check_rms("rmsnorm_bwd", x, w, width, device)
    build.check("dy", dy, _BF16, 2, device)
    r, ld = x.shape[0], x.stride(0)
    build.check_shape("dy", dy, (r, width))
    dx = (torch.empty if full == width else torch.zeros)(
        (r, full), dtype=_BF16, device=device)
    dw = torch.empty(width, dtype=_F32, device=device)
    lib = library()
    partial = torch.empty((lib.chana_rmsnorm_blocks(max(r, 1)), width),
                          dtype=_F32, device=device)
    build.aligned("rmsnorm_bwd", dy, x, dx)
    _launch("rmsnorm_bwd", device, "chana_rmsnorm_bwd", dy.data_ptr(),
            x.data_ptr(), ld, w.data_ptr(), dx.data_ptr(), full,
            partial.data_ptr(), dw.data_ptr(), r, width, float(eps))
    rmsnorm_bwd.launches += 2
    return dx, dw


class RmsNorm(torch.autograd.Function):
    """``rmsnorm`` whose backward is ``rmsnorm_bwd``: ``x [R, full]``,
    normalised over its first ``w.shape[0]`` columns."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(dy.contiguous(), x, w, ctx.eps, x.shape[-1])
        return dx, dw, None


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float):
    """``RmsNorm``'s plain version, for torch autograd."""
    return rmsnorm_ref(x[..., :w.shape[0]], w, eps)


# -- rotary positions and latent attention's operands -------------------------


class MlaDims(NamedTuple):
    """Latent attention's widths: heads, each q and k head's plain and
    rotated columns, each v head's, and the key-value latent's."""
    n_heads: int
    nope: int = NOPE
    rope: int = ROPE
    v: int = V
    latent: int = LATENT

    @property
    def qk(self) -> int:
        return self.nope + self.rope


def rope_table(t: int, rope: int, theta: float, device) -> torch.Tensor:
    """``[T, rope]`` bf16: cos | sin of position p at the ``rope / 2``
    frequencies ``theta ** (-2i / rope)``, computed in float32 and rounded
    to bf16 (the modeling file's default rotary embedding)."""
    inv = 1.0 / (theta ** (torch.arange(0, rope, 2, dtype=torch.int64)
                           .to(_F32) / rope))
    pos = torch.arange(t, dtype=_F32)
    freqs = pos[:, None] * inv[None, :]
    return torch.cat([freqs.cos(), freqs.sin()], dim=-1).to(_BF16).to(device)


def rotate_ref(x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """The rotary positions on ``x [B, T, ..., rope]`` (adjacent pairs,
    taken apart into evens then odds first, as the modeling file's
    ``apply_rotary_pos_emb_interleave``), each product and the sum
    rounded to ``x``'s dtype; ``cs`` is ``rope_table``."""
    t, rope = x.shape[1], x.shape[-1]
    half = rope // 2
    lead = x.shape[:-1]
    xp = x.reshape(*lead, half, 2).transpose(-1, -2).reshape(*lead, rope)
    shape = (1, t) + (1,) * (x.dim() - 3) + (half,)
    cos = cs[:t, :half].reshape(shape)
    sin = cs[:t, half:].reshape(shape)
    cos = torch.cat([cos, cos], dim=-1).to(x.dtype)
    sin = torch.cat([sin, sin], dim=-1).to(x.dtype)
    rot = torch.cat([-xp[..., half:], xp[..., :half]], dim=-1)
    return xp * cos + rot * sin


def mla_qkv_ref(q: torch.Tensor, kv: torch.Tensor, kva: torch.Tensor,
                cs: torch.Tensor, dims: MlaDims) -> torch.Tensor:
    """Plain version of ``mla_qkv``: ``q [B, T, H*qk]``, ``kv [B, T,
    H*(nope + v)]``, ``kva [B, T, latent + rope]`` -> ``[B, T, 3*H*qk]``
    (q | k | v, the v heads padded with zeros to qk)."""
    b, t = q.shape[:2]
    h, nope, qk = dims.n_heads, dims.nope, dims.qk
    qh = q.reshape(b, t, h, qk)
    kvh = kv.reshape(b, t, h, nope + dims.v)
    q_rot = rotate_ref(qh[..., nope:], cs)
    k_rot = rotate_ref(kva[..., dims.latent:].reshape(b, t, 1, dims.rope),
                       cs)
    qq = torch.cat([qh[..., :nope], q_rot], dim=-1)
    kk = torch.cat([kvh[..., :nope], k_rot.expand(b, t, h, dims.rope)],
                   dim=-1)
    vv = torch.cat([kvh[..., nope:], kvh.new_zeros(b, t, h, qk - dims.v)],
                   dim=-1)
    return torch.cat([qq, kk, vv], dim=2).reshape(b, t, 3 * h * qk)


def _check_mla(name, q, kv, kva, cs, dims: MlaDims, device) -> tuple:
    if dims != MlaDims(dims.n_heads):
        raise ValueError(f"{name}: widths {dims}; the kernels take "
                         f"{MlaDims(dims.n_heads)}")
    n_heads = dims.n_heads
    for nm, z in (("q", q), ("kv", kv), ("kva", kva)):
        build.check(nm, z, _BF16, 3, device)
    b, t = q.shape[:2]
    build.check_shape("q", q, (b, t, n_heads * QK))
    build.check_shape("kv", kv, (b, t, n_heads * (NOPE + V)))
    build.check_shape("kva", kva, (b, t, KVA))
    build.check("cs", cs, _BF16, 2, device)
    if cs.shape[0] < t or cs.shape[1] != ROPE:
        raise ValueError(f"{name}: rope table {tuple(cs.shape)} for T={t}")
    return b, t


@_counted
def mla_qkv(q, kv, kva, cs, dims: MlaDims) -> torch.Tensor:
    """The fused attention operand ``[B, T, 3*H*192]``. One launch."""
    if q.device.type == "cpu":
        return mla_qkv_ref(q, kv, kva, cs, dims)
    device = build.cuda_device("mla_qkv", q)
    b, t = _check_mla("mla_qkv", q, kv, kva, cs, dims, device)
    n_heads = dims.n_heads
    out = torch.empty((b, t, 3 * n_heads * QK), dtype=_BF16, device=device)
    if b * t:
        _launch("mla_qkv", device, "chana_mla_qkv", q.data_ptr(),
                kv.data_ptr(), kva.data_ptr(), cs.data_ptr(), out.data_ptr(),
                b * t, t, n_heads)
        mla_qkv.launches += 1
    return out


@_counted
def mla_qkv_bwd(dqkv: torch.Tensor, cs: torch.Tensor,
                dims: MlaDims) -> tuple:
    """(dq, dkv, dkva) of ``mla_qkv`` for the cotangent ``dqkv``; dkva is
    zero in its first 512 columns (the latent's gradient comes from its
    own norm). One launch."""
    n_heads = dims.n_heads
    if dqkv.device.type == "cpu":  # a linear map: any point will do
        b, t = dqkv.shape[:2]
        zeros = (dqkv.new_zeros(b, t, n_heads * dims.qk),
                 dqkv.new_zeros(b, t, n_heads * (dims.nope + dims.v)),
                 dqkv.new_zeros(b, t, dims.latent + dims.rope))
        return _vjp(lambda q, kv, kva: mla_qkv_ref(q, kv, kva, cs, dims),
                    zeros, dqkv)
    device = build.cuda_device("mla_qkv_bwd", dqkv)
    build.check("dqkv", dqkv, _BF16, 3, device)
    b, t = dqkv.shape[:2]
    build.check_shape("dqkv", dqkv, (b, t, 3 * n_heads * QK))
    dq = torch.empty((b, t, n_heads * QK), dtype=_BF16, device=device)
    dkv = torch.empty((b, t, n_heads * (NOPE + V)), dtype=_BF16,
                      device=device)
    dkva = torch.zeros((b, t, KVA), dtype=_BF16, device=device)
    if b * t:
        _launch("mla_qkv_bwd", device, "chana_mla_qkv_bwd", dqkv.data_ptr(),
                cs.data_ptr(), dq.data_ptr(), dkv.data_ptr(), dkva.data_ptr(),
                b * t, t, n_heads)
        mla_qkv_bwd.launches += 1
    return dq, dkv, dkva


class MlaQkv(torch.autograd.Function):
    """``mla_qkv`` whose backward is ``mla_qkv_bwd``."""

    @staticmethod
    def forward(ctx, q, kv, kva, cs, dims):
        ctx.save_for_backward(cs)
        ctx.dims = dims
        return mla_qkv(q, kv, kva, cs, dims)

    @staticmethod
    def backward(ctx, dqkv):
        (cs,) = ctx.saved_tensors
        dq, dkv, dkva = mla_qkv_bwd(dqkv.contiguous(), cs, ctx.dims)
        return dq, dkv, dkva, None, None


class MlaAttention(torch.autograd.Function):
    """Causal attention over the fused ``[B, T, 3*H*192]`` operand with v
    width 128: ``forecaster.py``'s warpgroup forward at those widths,
    keeping the row statistics and the output; backward: the long-window
    pair at q and k 192, v and the output's gradient 128 (the v heads'
    columns past 128 get zeros)."""

    @staticmethod
    def forward(ctx, qkv, dims):
        n_heads = dims.n_heads
        if ctx.needs_input_grad[0]:
            out, ctx.stats = fk.causal_attention_with_stats(qkv, n_heads,
                                                            dims.v)
        else:
            out, ctx.stats = fk.causal_attention(qkv, n_heads, dims.v), None
        ctx.save_for_backward(qkv, out)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out = ctx.saved_tensors
        return fk.causal_attention_bwd(qkv, dout.contiguous(), ctx.n_heads,
                                       ctx.stats, out), None


def mla_attention_plain(qkv: torch.Tensor, dims: MlaDims) -> torch.Tensor:
    """``MlaAttention``'s plain version, for torch autograd."""
    return fk.causal_attention_ref(qkv, dims.n_heads, dims.v)


# -- SwiGLU --------------------------------------------------------------------


def swiglu_ref(gu: torch.Tensor) -> torch.Tensor:
    """``bf16(bf16(silu(g)) * u)`` (``gu``'s dtype) over ``gu [..., 2F] =
    g | u``, silu in float32."""
    f = gu.shape[-1] // 2
    g, u = gu[..., :f], gu[..., f:]
    s = torch.nn.functional.silu(g.to(_F32)).to(gu.dtype)
    return s * u


def _check_swiglu(name, gu, device) -> tuple:
    build.check("gu", gu, _BF16, 2, device)
    r, f2 = gu.shape
    if f2 % 16:
        raise ValueError(f"{name}: width {f2}; the kernel takes g | u of "
                         "widths that are multiples of 8")
    return r, f2 // 2


@_counted
def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """SwiGLU of ``gu [R, 2F]`` -> ``[R, F]``. One launch."""
    if gu.device.type == "cpu":
        return swiglu_ref(gu)
    device = build.cuda_device("swiglu", gu)
    r, f = _check_swiglu("swiglu", gu, device)
    out = torch.empty((r, f), dtype=_BF16, device=device)
    if r:
        _launch("swiglu", device, "chana_swiglu", gu.data_ptr(),
                out.data_ptr(), r, f)
        swiglu.launches += 1
    return out


@_counted
def swiglu_bwd(dy: torch.Tensor, gu: torch.Tensor) -> torch.Tensor:
    """dgu ``[R, 2F]`` of ``swiglu`` for the cotangent ``dy [R, F]``. One
    launch."""
    if gu.device.type == "cpu":
        return _vjp(swiglu_ref, (gu,), dy)[0]
    device = build.cuda_device("swiglu_bwd", gu)
    r, f = _check_swiglu("swiglu_bwd", gu, device)
    build.check("dy", dy, _BF16, 2, device)
    build.check_shape("dy", dy, (r, f))
    dgu = torch.empty_like(gu)
    if r:
        _launch("swiglu_bwd", device, "chana_swiglu_bwd", dy.data_ptr(),
                gu.data_ptr(), dgu.data_ptr(), r, f)
        swiglu_bwd.launches += 1
    return dgu


class SwiGlu(torch.autograd.Function):
    """``swiglu`` whose backward is ``swiglu_bwd``."""

    @staticmethod
    def forward(ctx, gu):
        ctx.save_for_backward(gu)
        return swiglu(gu)

    @staticmethod
    def backward(ctx, dy):
        (gu,) = ctx.saved_tensors
        return swiglu_bwd(dy.contiguous(), gu)


# -- routing -------------------------------------------------------------------


def route_weights_ref(scores: torch.Tensor, idx: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """The chosen scores normalised and scaled, as the modeling file's
    router: ``scale * s / (sum(s) + 1e-20)``."""
    w = scores.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * scale


def _check_route(name, scores, idx, device) -> tuple:
    build.check("scores", scores, _F32, 2, device)
    build.check("idx", idx, torch.int64, 2, device)
    r, e = scores.shape
    k = idx.shape[1]
    if idx.shape[0] != r or not 0 < k <= min(e, 16):
        raise ValueError(f"{name}: scores {tuple(scores.shape)}, idx "
                         f"{tuple(idx.shape)}; 1 to 16 chosen a token")
    return r, e, k


@_counted
def route_weights(scores: torch.Tensor, idx: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """``[R, K]`` float32 routing weights. One launch."""
    if scores.device.type == "cpu":
        return route_weights_ref(scores, idx, scale)
    device = build.cuda_device("route_weights", scores)
    r, e, k = _check_route("route_weights", scores, idx, device)
    out = torch.empty((r, k), dtype=_F32, device=device)
    if r:
        _launch("route_weights", device, "chana_route_weights",
                scores.data_ptr(), idx.data_ptr(), out.data_ptr(), r, e, k,
                float(scale))
        route_weights.launches += 1
    return out


@_counted
def route_weights_bwd(dw: torch.Tensor, scores: torch.Tensor,
                      idx: torch.Tensor, scale: float) -> torch.Tensor:
    """dscores ``[R, E]`` of ``route_weights`` (zero off the chosen). One
    launch."""
    if scores.device.type == "cpu":
        return _vjp(lambda s: route_weights_ref(s, idx, scale), (scores,),
                    dw)[0]
    device = build.cuda_device("route_weights_bwd", scores)
    r, e, k = _check_route("route_weights_bwd", scores, idx, device)
    build.check("dw", dw, _F32, 2, device)
    build.check_shape("dw", dw, (r, k))
    ds = torch.empty_like(scores)
    if r:
        _launch("route_weights_bwd", device, "chana_route_weights_bwd",
                dw.data_ptr(), scores.data_ptr(), idx.data_ptr(),
                ds.data_ptr(), r, e, k, float(scale))
        route_weights_bwd.launches += 1
    return ds


class RouteWeights(torch.autograd.Function):
    """``route_weights`` whose backward is ``route_weights_bwd``."""

    @staticmethod
    def forward(ctx, scores, idx, scale):
        ctx.save_for_backward(scores, idx)
        ctx.scale = scale
        return route_weights(scores, idx, scale)

    @staticmethod
    def backward(ctx, dw):
        scores, idx = ctx.saved_tensors
        return route_weights_bwd(dw.contiguous(), scores, idx,
                                 ctx.scale), None, None


class Dispatch(NamedTuple):
    """Where each token's chosen experts' rows are, sorted by expert:
    ``src [R*K]`` (int32) the token of each sorted row, ``pos [R*K]``
    (int32) the sorted row of each (token, slot), ``offsets [E + 1]``
    (int32) each expert's first row, ``counts [E]`` (int64) its rows. All
    on the device; made by torch's sort and bincount, no host sync."""
    src: torch.Tensor
    pos: torch.Tensor
    offsets: torch.Tensor
    counts: torch.Tensor
    k: int


def dispatch(idx: torch.Tensor, n_experts: int) -> Dispatch:
    """The sorted rows of ``idx [R, K]`` (each row's experts ascending)."""
    r, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    offsets = torch.zeros(n_experts + 1, dtype=torch.int32,
                          device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(r * k, device=idx.device)
    return Dispatch(src=(order // k).to(torch.int32),
                    pos=pos.to(torch.int32), offsets=offsets, counts=counts,
                    k=k)


def gather_ref(x: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """Plain gather: ``x [R, D]``'s rows in sorted order."""
    return x[d.src.long()]


@_counted
def gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x [src]`` ``[Rs, D]``. One launch."""
    if x.device.type == "cpu":
        return x[src.long()]
    device = build.cuda_device("gather_rows", x)
    build.check("x", x, _BF16, 2, device)
    build.check("src", src, torch.int32, 1, device)
    rs, dd = src.shape[0], x.shape[1]
    out = torch.empty((rs, dd), dtype=_BF16, device=device)
    if rs:
        _launch("gather_rows", device, "chana_gather_rows", x.data_ptr(),
                src.data_ptr(), out.data_ptr(), rs, dd)
        gather_rows.launches += 1
    return out


@_counted
def token_sum(rows: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """``[T, D]``: each token's ``k`` sorted rows summed in float32,
    rounded once. One launch."""
    if rows.device.type == "cpu":
        t = pos.shape[0] // k
        return rows[pos.long()].to(_F32).reshape(t, k, -1).sum(1).to(
            rows.dtype)
    device = build.cuda_device("token_sum", rows)
    build.check("rows", rows, _BF16, 2, device)
    build.check("pos", pos, torch.int32, 1, device)
    t, dd = pos.shape[0] // k, rows.shape[1]
    out = torch.empty((t, dd), dtype=_BF16, device=device)
    if t:
        _launch("token_sum", device, "chana_token_sum", rows.data_ptr(),
                pos.data_ptr(), out.data_ptr(), t, dd, k)
        token_sum.launches += 1
    return out


class Gather(torch.autograd.Function):
    """``gather_rows`` whose backward is ``token_sum``."""

    @staticmethod
    def forward(ctx, x, src, pos, k):
        ctx.save_for_backward(pos)
        ctx.k = k
        return gather_rows(x, src)

    @staticmethod
    def backward(ctx, dy):
        (pos,) = ctx.saved_tensors
        return token_sum(dy.contiguous(), pos, ctx.k), None, None, None


def gather_kernels(x: torch.Tensor, d: Dispatch) -> torch.Tensor:
    return Gather.apply(x, d.src, d.pos, d.k)


def combine_ref(ys: torch.Tensor, w: torch.Tensor, d: Dispatch,
                shared: torch.Tensor, residual: torch.Tensor):
    """Plain combine: ``bf16(bf16(bf16(m) + shared) + residual)``, ``m``
    the float32 sum over each token's slots (its experts ascending) of ``w
    * y``, the modeling file's ``index_add_`` over the experts in turn."""
    return _combine_pos(ys, w, d.pos, shared, residual)


def _combine_pos(ys, w, pos, shared, residual):
    t, k = w.shape
    pos = pos.long().reshape(t, k)
    acc = torch.zeros(t, ys.shape[1], dtype=_F32, device=ys.device)
    for j in range(k):
        acc = acc + ys[pos[:, j]].to(_F32) * w[:, j:j + 1]
    return (acc.to(ys.dtype) + shared) + residual


def _check_combine(name, ys, w, pos, device) -> tuple:
    build.check("ys", ys, _BF16, 2, device)
    build.check("w", w, _F32, 2, device)
    build.check("pos", pos, torch.int32, 1, device)
    t, k = w.shape
    if pos.shape[0] != t * k or ys.shape[0] != t * k:
        raise ValueError(f"{name}: ys {tuple(ys.shape)}, w {tuple(w.shape)}"
                         f", pos {tuple(pos.shape)} do not meet")
    return t, ys.shape[1], k


@_counted
def combine(ys, w, pos, shared, residual) -> torch.Tensor:
    """The combine ``[T, D]``. One launch."""
    if ys.device.type == "cpu":
        return _combine_pos(ys, w, pos, shared, residual)
    device = build.cuda_device("combine", ys)
    t, dd, k = _check_combine("combine", ys, w, pos, device)
    for nm, z in (("shared", shared), ("residual", residual)):
        build.check(nm, z, _BF16, 2, device)
        build.check_shape(nm, z, (t, dd))
    out = torch.empty((t, dd), dtype=_BF16, device=device)
    if t:
        _launch("combine", device, "chana_combine", ys.data_ptr(),
                w.data_ptr(), pos.data_ptr(), shared.data_ptr(),
                residual.data_ptr(), out.data_ptr(), t, dd, k)
        combine.launches += 1
    return out


@_counted
def combine_bwd(dout, ys, w, pos) -> tuple:
    """(dys ``[T*K, D]`` bf16, dw ``[T, K]`` float32) of ``combine``. One
    launch."""
    if ys.device.type == "cpu":
        zero = dout.new_zeros(dout.shape)
        return _vjp(lambda y, v: _combine_pos(y, v, pos, zero, zero),
                    (ys, w), dout)
    device = build.cuda_device("combine_bwd", ys)
    t, dd, k = _check_combine("combine_bwd", ys, w, pos, device)
    build.check("dout", dout, _BF16, 2, device)
    build.check_shape("dout", dout, (t, dd))
    dys = torch.empty_like(ys)
    dw = torch.empty_like(w)
    if t:
        _launch("combine_bwd", device, "chana_combine_bwd", dout.data_ptr(),
                ys.data_ptr(), w.data_ptr(), pos.data_ptr(), dys.data_ptr(),
                dw.data_ptr(), t, dd, k)
        combine_bwd.launches += 1
    return dys, dw


class Combine(torch.autograd.Function):
    """``combine`` whose backward is ``combine_bwd``; the shared experts'
    output and the residual take the cotangent as it is."""

    @staticmethod
    def forward(ctx, ys, w, pos, shared, residual):
        ctx.save_for_backward(ys, w, pos)
        return combine(ys, w, pos, shared, residual)

    @staticmethod
    def backward(ctx, dout):
        ys, w, pos = ctx.saved_tensors
        dout = dout.contiguous()
        dys, dw = combine_bwd(dout, ys, w, pos)
        return dys, dw, None, dout, dout


def combine_kernels(ys, w, d: Dispatch, shared, residual):
    return Combine.apply(ys, w, d.pos, shared, residual)


# -- the router's float32 products ------------------------------------------------


ROUTER_TILE = 64  # outputs a block of the router product, each way


def router_splits(m: int, n: int, k: int) -> int:
    """Runs of K the router product splits into: enough that the grid
    fills two waves of the card's ``products.SMS`` where its tiles alone
    do not, each run at least 256 deep."""
    tiles = -(-m // ROUTER_TILE) * -(-n // ROUTER_TILE)
    return max(1, min(64, 2 * products.SMS // tiles, k // 256))


@_counted
def router_product(a: torch.Tensor, b: torch.Tensor,
                   layout: str = "nn") -> torch.Tensor:
    """``op(a) op(b)`` in float32 (``products.dims``' layouts), the
    router's logits and their gradients. One launch, two where K is
    split (``router_splits``)."""
    if a.device.type == "cpu":
        return products.f32_product_ref(a, b, layout)
    device = build.cuda_device("router_product", a)
    build.check("a", a, _F32, 2, device)
    build.check("b", b, _F32, 2, device)
    m, n, k = products.dims(layout, a, b)
    out = torch.empty((m, n), dtype=_F32, device=device)
    if m * n == 0:
        return out
    if k == 0:
        return out.zero_()
    splits = router_splits(m, n, k)
    partial = torch.empty((splits, m, n), dtype=_F32, device=device) \
        if splits > 1 else None
    _launch("router_product", device, "chana_router_product", a.data_ptr(),
            b.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), m, n, k,
            products.LAYOUTS[layout], splits)
    router_product.launches += 1 + (splits > 1)
    return out


class RouterProduct(torch.autograd.Function):
    """``x @ w`` in float32 through ``router_product``; its backward the
    same kernel in the other layouts."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return router_product(x, w, "nn")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        return (router_product(dy, w, "nt") if ctx.needs_input_grad[0]
                else None,
                router_product(x, dy, "tn") if ctx.needs_input_grad[1]
                else None)


# -- grouped products ------------------------------------------------------------


LAYOUTS = {"nn": 0, "nt": 1, "tn": 2}  # csrc/moonlight.cu's grouped layouts


def grouped_product_ref(a: torch.Tensor, b: torch.Tensor,
                        offsets: torch.Tensor, layout: str = "nn",
                        ) -> torch.Tensor:
    """Plain grouped product (any device): ``nn`` ``a [Rs, K]`` rows of
    group e times ``b [E, K, N]``'s e-th; ``nt`` times its transpose (``b
    [E, N, K]``); ``tn`` ``[E, M, N]``, each group's ``a^T b`` (``a [Rs,
    M]``, ``b [Rs, N]``). Float32 sums of the operands, rounded to ``a``'s
    dtype. Reads the offsets on the host."""
    bounds = [int(v) for v in offsets.tolist()]
    af = a.to(_F32)
    if layout == "tn":
        bf = b.to(_F32)
        return torch.stack([
            af[lo:hi].t() @ bf[lo:hi]
            for lo, hi in zip(bounds[:-1], bounds[1:])]).to(a.dtype)
    n = b.shape[2] if layout == "nn" else b.shape[1]
    out = torch.empty(a.shape[0], n, dtype=_F32, device=a.device)
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        w = b[e].to(_F32)
        out[lo:hi] = af[lo:hi] @ (w if layout == "nn" else w.t())
    return out.to(a.dtype)


@_counted
def grouped_product(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                    layout: str = "nn") -> torch.Tensor:
    """The grouped product (see ``grouped_product_ref``), one launch; on a
    card the widths are multiples of ``GROUP_TILE`` (outputs) and
    ``GROUP_DEPTH`` (sums)."""
    if a.device.type == "cpu":
        return grouped_product_ref(a, b, offsets, layout)
    device = build.cuda_device("grouped_product", a)
    if layout not in LAYOUTS:
        raise ValueError(f"grouped_product: layout {layout!r}")
    build.check("a", a, _BF16, 2, device)
    build.check("offsets", offsets, torch.int32, 1, device)
    e = offsets.shape[0] - 1
    rs = a.shape[0]
    if layout == "tn":
        build.check("b", b, _BF16, 2, device)
        m, n, k = a.shape[1], b.shape[1], rs
        if b.shape[0] != rs:
            raise ValueError("grouped_product (tn): a and b rows differ")
        out = torch.empty((e, m, n), dtype=_BF16, device=device)
        ok = m % GROUP_TILE == 0 and n % GROUP_TILE == 0
        # the largest groups' blocks first (the order leaves every sum
        # as it is)
        order = torch.argsort(offsets[1:] - offsets[:-1],
                              descending=True).to(torch.int32)
    else:
        build.check("b", b, _BF16, 3, device)
        k = a.shape[1]
        kb, n = (b.shape[1], b.shape[2]) if layout == "nn" else (
            b.shape[2], b.shape[1])
        if b.shape[0] != e or kb != k:
            raise ValueError(f"grouped_product ({layout}): a "
                             f"{tuple(a.shape)}, b {tuple(b.shape)}, "
                             f"{e} groups do not meet")
        m, order = 0, None
        out = torch.empty((rs, n), dtype=_BF16, device=device)
        ok = n % GROUP_TILE == 0 and k % GROUP_DEPTH == 0
    if not ok:
        raise ValueError(f"grouped_product ({layout}): M={m}, N={n}, K={k}; "
                         f"outputs a multiple of {GROUP_TILE} wide, sums "
                         f"of {GROUP_DEPTH}")
    if out.numel():
        build.aligned("grouped_product", a, b, out)
        _launch("grouped_product", device, "chana_grouped_product",
                a.data_ptr(), b.data_ptr(), out.data_ptr(),
                offsets.data_ptr(),
                None if order is None else order.data_ptr(), e, rs, m, n, k,
                LAYOUTS[layout])
        grouped_product.launches += 1
    return out


class Grouped(torch.autograd.Function):
    """``grouped_product`` (``nn``) whose backward takes dX (``nt``) and dW
    (``tn``) from the same kernel."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return grouped_product(x, w, offsets, "nn")

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_product(dy, w, offsets, "nt") \
            if ctx.needs_input_grad[0] else None
        dw = grouped_product(x, dy, offsets, "tn") \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_plain(x, w, offsets):
    """``Grouped``'s plain version, for torch autograd: each expert's
    product on its rows, in float32 rounded to ``x``'s dtype."""
    bounds = [int(v) for v in offsets.tolist()]
    parts = []
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        parts.append(products.bf16_product_ref(x[lo:hi], w[e]))
    return torch.cat(parts, dim=0)


# -- op sets ---------------------------------------------------------------------


class Ops(NamedTuple):
    rmsnorm: Callable        # (x [R, >= width], w [width], eps) -> [R, width]
    router: Callable         # (x [R, D] float32, w [D, E]) -> logits [R, E]
    mla_qkv: Callable        # (q, kv, kva, cs, MlaDims) -> fused operand
    attention: Callable      # (fused, MlaDims) -> [B, T, H * v]
    swiglu: Callable         # gu [R, 2F] -> [R, F]
    route_weights: Callable  # (scores, idx, scale) -> [R, K]
    gather: Callable         # (x [R, D], Dispatch) -> [R*K, D]
    grouped: Callable        # (xs, w [E, K, N], offsets) -> [R*K, N]
    combine: Callable        # (ys, w, Dispatch, shared, residual) -> [R, D]
    # the forecaster's products, head and update (kernels/forecaster.py)
    base: fk.Ops


KERNELS = Ops(RmsNorm.apply, RouterProduct.apply, MlaQkv.apply, MlaAttention.apply, SwiGlu.apply,
              RouteWeights.apply, gather_kernels, Grouped.apply,
              combine_kernels, fk.KERNELS)
PLAIN = Ops(rmsnorm_plain, products.head_ref, mla_qkv_ref, mla_attention_plain, swiglu_ref,
            route_weights_ref, gather_ref, grouped_plain, combine_ref,
            fk.PLAIN)


# every wrapper here that counts its launches
WRAPPERS = ("rmsnorm", "rmsnorm_bwd", "mla_qkv", "mla_qkv_bwd", "swiglu",
            "swiglu_bwd", "route_weights", "route_weights_bwd", "gather_rows",
            "token_sum", "combine", "combine_bwd", "grouped_product",
            "router_product")


def launch_count() -> int:
    """Kernel launches of every wrapper here so far (the products,
    attention and update the backbone also takes count in
    ``forecaster.launch_count``)."""
    return sum(globals()[name].launches for name in WRAPPERS)

