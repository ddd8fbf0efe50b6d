"""Forecaster kernels: CUDA wrappers, launch counts, plain versions.

``layernorm``, ``causal_attention`` and ``gelu_tanh`` compute the three
non-product steps of ``chanamq_tpu/models/forecaster.py::forward``:
``_layernorm`` (scale only, float32 statistics, eps 1e-6), the core of
``_attention`` between its two projections (causal mask, float32 softmax,
bf16 logits and weights), and ``jax.nn.gelu``'s default tanh form.

On CUDA tensors they launch the hand-written kernels of
``csrc/forecaster.cu`` (built on first use, see ``build.py``) or raise; the
kernels take bf16 activations only. On CPU tensors they run the plain
PyTorch versions ``layernorm_ref``, ``causal_attention_ref`` and
``gelu_tanh_ref``, in any float dtype. Nothing falls back from one to the
other.

Each plain version rounds where the reference rounds: float32 inside, the
input's dtype out; attention also rounds ``q . k`` and the softmax weights
to the input's dtype, as the reference's bf16 einsums do.

Each wrapper's ``launches`` attribute counts its kernel launches, and only
those. ``prepare_*`` check a call's CUDA inputs and bind its launch; the
wrappers launch what they return, and a timing loop can launch it again
without the checks (and without counting). ``KERNELS`` and ``PLAIN`` name
the wrappers and the plain versions as one set of ops, so a caller can run
the same forward through either.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch

from . import build

EPS = 1e-6  # forecaster.py:81
GELU_K = math.sqrt(2.0 / math.pi)

_BF16 = torch.bfloat16
_F32 = torch.float32

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built ``csrc/forecaster.cu`` with its C signatures declared."""
    lib, _ = build.load("forecaster")
    if not getattr(lib, "_chana_typed", False):
        lib.chana_layernorm.argtypes = [_ptr] * 3 + [_int] * 2 + [
            ctypes.c_float, _ptr]
        lib.chana_layernorm.restype = _int
        lib.chana_causal_attention.argtypes = [_ptr] * 2 + [_int] * 4 + [
            ctypes.c_float, _ptr]
        lib.chana_causal_attention.restype = _int
        lib.chana_causal_attention_smem.argtypes = [_int, _int]
        lib.chana_causal_attention_smem.restype = ctypes.c_size_t
        lib.chana_gelu_tanh.argtypes = [_ptr, _ptr, ctypes.c_int64, _ptr]
        lib.chana_gelu_tanh.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_typed = True
    return lib


def _cuda_device(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device


def _aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned (the "
                             "kernel reads 16 bytes at a time)")


# -- layernorm ---------------------------------------------------------------


def layernorm_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the layernorm kernel (any device)."""
    x32 = x.to(_F32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + EPS) * scale).to(x.dtype)


def prepare_layernorm(x: torch.Tensor, scale: torch.Tensor):
    """Check the layernorm kernel's CUDA inputs and bind its launch:
    ``(out, launch)``; ``launch`` is None when there is no row."""
    device = _cuda_device("layernorm", x)
    build.check("x", x, _BF16, x.dim(), device)
    build.check("scale", scale, _F32, 1, device)
    d = x.shape[-1] if x.dim() else 0
    build.check_shape("scale", scale, (d,))
    if d % 8 or not 0 < d <= 1024:
        raise ValueError(f"layernorm: width {d}; the kernel takes a "
                         "multiple of 8 up to 1024")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out, None
    _aligned("layernorm", x, out)
    lib = library()
    return out, build.launcher(
        lib, lib.chana_layernorm, "layernorm", device, x.data_ptr(),
        scale.data_ptr(), out.data_ptr(), rows, d, EPS)


def layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Scale-only layernorm over the last axis: ``x [..., D]`` (bf16 on a
    card), ``scale [D]`` float32, out in ``x``'s dtype."""
    if x.device.type == "cpu":
        return layernorm_ref(x, scale)
    out, launch = prepare_layernorm(x, scale)
    if launch is not None:
        launch()
        layernorm.launches += 1
    return out


layernorm.launches = 0


# -- causal attention --------------------------------------------------------


def causal_attention_ref(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the attention kernel (any device):
    forecaster.py:89-99 without the two projections."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = (z.reshape(b, t, n_heads, hd).transpose(1, 2)
               for z in qkv.split(d, dim=-1))                 # [B,H,T,hd]
    logits = torch.matmul(q, k.transpose(-1, -2)).to(_F32) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=qkv.device).tril()
    logits = torch.where(causal, logits, torch.full_like(logits, -1e30))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    out = torch.matmul(weights, v)                            # [B,H,T,hd]
    return out.transpose(1, 2).reshape(b, t, d)


def prepare_causal_attention(qkv: torch.Tensor, n_heads: int):
    """Check the attention kernel's CUDA input and bind its launch:
    ``(out, launch)``; ``launch`` is None for an empty batch."""
    device = _cuda_device("causal_attention", qkv)
    build.check("qkv", qkv, _BF16, 3, device)
    b, t, d3 = qkv.shape
    if n_heads <= 0 or d3 % (3 * n_heads):
        raise ValueError(f"causal_attention: qkv shape {tuple(qkv.shape)} "
                         f"is not [B, T, 3 * {n_heads} * head_dim]")
    hd = d3 // 3 // n_heads
    out = torch.empty((b, t, n_heads * hd), dtype=_BF16, device=device)
    if b == 0 or t == 0:
        return out, None
    lib = library()
    smem = lib.chana_causal_attention_smem(t, hd)
    if smem == 0 or smem > 227 * 1024:
        raise ValueError(f"causal_attention: T={t}, head_dim={hd} does not "
                         "fit the kernel (even head_dim, shared memory "
                         "up to 227 KB)")
    _aligned("causal_attention", qkv, out)
    return out, build.launcher(
        lib, lib.chana_causal_attention, "causal_attention", device,
        qkv.data_ptr(), out.data_ptr(), b, t, n_heads, hd, math.sqrt(hd))


def causal_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Causal self-attention core: the fused ``qkv [B, T, 3D]`` product
    (q | k | v, heads contiguous in each third) to ``[B, T, D]``, heads
    contiguous, the layout the output projection takes."""
    if qkv.device.type == "cpu":
        return causal_attention_ref(qkv, n_heads)
    out, launch = prepare_causal_attention(qkv, n_heads)
    if launch is not None:
        launch()
        causal_attention.launches += 1
    return out


causal_attention.launches = 0


# -- tanh-GELU ---------------------------------------------------------------


def gelu_tanh_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the GELU kernel (any device), in
    jax.nn.gelu's (approximate=True) order of operations."""
    x32 = x.to(_F32)
    cdf = 0.5 * (1.0 + torch.tanh(GELU_K * (x32 + 0.044715 * (x32 * x32 * x32))))
    return (x32 * cdf).to(x.dtype)


def prepare_gelu_tanh(x: torch.Tensor):
    """Check the GELU kernel's CUDA input and bind its launch:
    ``(out, launch)``; ``launch`` is None for an empty tensor."""
    device = _cuda_device("gelu_tanh", x)
    build.check("x", x, _BF16, x.dim(), device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, None
    _aligned("gelu_tanh", x, out)
    lib = library()
    return out, build.launcher(
        lib, lib.chana_gelu_tanh, "gelu_tanh", device, x.data_ptr(),
        out.data_ptr(), x.numel())


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU, elementwise, out in ``x``'s dtype."""
    if x.device.type == "cpu":
        return gelu_tanh_ref(x)
    out, launch = prepare_gelu_tanh(x)
    if launch is not None:
        launch()
        gelu_tanh.launches += 1
    return out


gelu_tanh.launches = 0


# -- op sets -----------------------------------------------------------------


class Ops(NamedTuple):
    layernorm: Callable
    causal_attention: Callable
    gelu_tanh: Callable


KERNELS = Ops(layernorm, causal_attention, gelu_tanh)
PLAIN = Ops(layernorm_ref, causal_attention_ref, gelu_tanh_ref)
