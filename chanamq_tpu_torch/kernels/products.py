"""The forecaster's matrix products: CUDA wrappers, launch counts, plain
versions, and the differentiable ops built on them.

``bf16_product`` and ``f32_product`` compute every product of
``chanamq_tpu/models/forecaster.py::forward`` and their gradients in the
train step (``forecaster.py:141``):

- ``bf16_product(a, b, layout, residual, gelu, keep_preact)``: ``op(a)
  op(b)`` from bf16 operands, float32 sums, rounded to bf16 once (the
  reference's bf16 einsums); then, for the forward, the residual add
  (``h +`` after ``proj`` and ``w2``: the rounded product plus
  ``residual``, rounded again) or the tanh-GELU after ``w1`` (on the
  rounded product, rounded again; ``keep_preact`` also returns the
  rounded product, which the GELU backward takes);
- ``f32_product(a, b, layout)``: the same in float32, no TF32 (the head,
  ``last @ out/kernel``).

``layout`` names how the operands are stored: ``"nn"`` ``a [M, K]``,
``b [K, N]`` (a forward product, the weight in its ``[in, out]``
layout); ``"nt"`` ``b [N, K]`` (``dX = dY W^T``); ``"tn"`` ``a [K, M]``
(``dW = X^T dY``, the sum over the batch's rows).

On CUDA tensors they launch the kernels of ``csrc/products.cu`` (built on
first use, see ``build.py``) or raise: the bf16 kernel takes bf16, N a
multiple of 8 (M and K any: the embed's K is the feature count),
16-byte aligned contiguous 2-D tensors, and epilogues only with
``"nn"``. Its launch plan is a pure function of the shape, computed
here and passed to the launcher: ``tile_rows`` (64 x 64 or 128 x 128
outputs a block) and ``split_k`` (the blocks, a thread-block cluster,
that share one tile's K). On CPU tensors they run the
plain versions (``*_ref``), in any float dtype: ``torch.matmul`` in
float32 on the operands as float32, rounded to the input's dtype at the
kernel's points. Nothing falls back from one to the other. Each wrapper's
``launches`` counts its kernel launches, and only those; ``prepare_*``
check a call and bind its launch, so a timing loop can launch it again.

``Product`` and ``Head`` are differentiable ops the forward and the
train step call (``kernels/forecaster.py``'s ``KERNELS``, beside its
``ProductGelu``, whose backward also takes the GELU backward kernel;
``PLAIN`` holds ``product_ref``, ``product_gelu_ref`` and ``head_ref``,
which torch autograd differentiates). Each backward takes dX and dW from
the same kernel in the other layouts, and only those an input needs: the
embed's input is the data.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .gelu import gelu_tanh_ref

_BF16 = torch.bfloat16
_F32 = torch.float32

_ptr = ctypes.c_void_p
_int = ctypes.c_int

LAYOUTS = {"nn": 0, "nt": 1, "tn": 2}  # csrc/products.cu's Layout
_NONE, _GELU, _RESIDUAL = 0, 1, 2     # its Epilogue
CHUNK = 8  # bf16 values in 16 bytes: N a multiple of it
SMS = 132        # the H100's streaming multiprocessors: one wave of blocks
K_STAGE = 64     # K depth of a ring stage (csrc/products.cu's kBK)
MAX_SPLITS = 8   # blocks of a cluster (the portable limit)


def library() -> ctypes.CDLL:
    """The built ``csrc/products.cu`` with its C signatures declared."""
    lib, _ = build.load("products")
    if not getattr(lib, "_chana_typed", False):
        lib.chana_bf16_product.argtypes = [_ptr] * 5 + [_int] * 7 + [_ptr]
        lib.chana_bf16_product.restype = _int
        lib.chana_f32_product.argtypes = [_ptr] * 3 + [_int] * 4 + [_ptr]
        lib.chana_f32_product.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_typed = True
    return lib


def dims(layout: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``(M, N, K)`` of ``op(a) op(b)`` for 2-D operands stored as
    ``layout`` says; raises on another layout or on shapes that do not
    meet."""
    if layout not in LAYOUTS:
        raise ValueError(f"product: layout {layout!r}; the kernels take "
                         f"{sorted(LAYOUTS)}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"product: operands of {a.dim()} and {b.dim()} "
                         "dimensions, expected 2 each")
    m, ka = (a.shape[1], a.shape[0]) if layout[0] == "t" else a.shape
    n, kb = (b.shape[0], b.shape[1]) if layout[1] == "t" else (
        b.shape[1], b.shape[0])
    if ka != kb:
        raise ValueError(f"product ({layout}): a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not meet")
    return m, n, ka


def _as_nn(layout: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    return (a.t() if layout[0] == "t" else a,
            b.t() if layout[1] == "t" else b)


# -- the bf16 product ----------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_rows(m: int, n: int, k: int) -> int:
    """Output rows (and columns) of one block of the bf16 kernel: 128 (two
    consumer warpgroups) where those tiles alone number at least 96 (about
    three quarters of a wave, so K is not split) and K spans more than one
    ring stage, so each loaded stage feeds twice the outputs; else 64."""
    if _cdiv(m, 128) * _cdiv(n, 128) >= 96 and k > K_STAGE:
        return 128
    return 64


def split_k(m: int, n: int, k: int) -> int:
    """Blocks (1, 2, 4 or 8: one cluster) that share each output tile's
    K, each a contiguous 1/S of it and at least two ring stages: the most
    that keep the grid within one wave of ``SMS`` blocks for S = 2, and
    within half a wave for S = 4 or 8 (a cluster of 4 or 8 costs more to
    schedule and to sum, which a fuller card does not repay); 1 where the
    tiles already fill the card."""
    tile = tile_rows(m, n, k)
    tiles = _cdiv(m, tile) * _cdiv(n, tile)
    stages = _cdiv(k, K_STAGE)
    s = 1
    for cand in (2, 4, MAX_SPLITS):
        grid = SMS if cand == 2 else SMS // 2
        if tiles * cand <= grid and stages // cand >= 2:
            s = cand
    return s


def bf16_product_ref(a: torch.Tensor, b: torch.Tensor, layout: str = "nn",
                     residual: Optional[torch.Tensor] = None,
                     gelu: bool = False, keep_preact: bool = False):
    """Plain PyTorch version of the bf16 product kernel (any device, any
    float dtype): ``op(a) op(b)`` in float32, rounded to ``a``'s dtype;
    plus ``residual`` (rounded again), or through GELU (``(out,
    preact)`` with ``keep_preact``)."""
    dims(layout, a, b)
    x, w = _as_nn(layout, a, b)
    p = torch.matmul(x.to(_F32), w.to(_F32)).to(a.dtype)
    if gelu:
        out = gelu_tanh_ref(p)
        return (out, p) if keep_preact else out
    return p if residual is None else residual + p


def prepare_bf16_product(a: torch.Tensor, b: torch.Tensor,
                         layout: str = "nn",
                         residual: Optional[torch.Tensor] = None,
                         gelu: bool = False, keep_preact: bool = False,
                         splits: Optional[int] = None):
    """Check the bf16 product kernel's CUDA inputs and bind its launch:
    ``(out, launch)``, ``out`` being ``(out, preact)`` with
    ``keep_preact``; ``launch`` is None when the product is empty.
    ``splits`` overrides ``split_k`` (1 to ``MAX_SPLITS``), for tests of
    the kernel at every split; ``bf16_product`` never passes it."""
    device = build.cuda_device("bf16_product", a)
    build.check("a", a, _BF16, 2, device)
    build.check("b", b, _BF16, 2, device)
    m, n, k = dims(layout, a, b)
    epilogue = _GELU if gelu else _RESIDUAL if residual is not None \
        else _NONE
    if gelu and residual is not None:
        raise ValueError("bf16_product: GELU or a residual, not both")
    if keep_preact and not gelu:
        raise ValueError("bf16_product: keep_preact needs the GELU")
    if epilogue != _NONE and layout != "nn":
        raise ValueError(f"bf16_product: an epilogue only with layout "
                         f"'nn', not {layout!r}")
    if residual is not None:
        build.check("residual", residual, _BF16, 2, device)
        build.check_shape("residual", residual, (m, n))
    if k == 0 or n % CHUNK:
        raise ValueError(
            f"bf16_product ({layout}): M={m}, N={n}, K={k}; the kernel "
            f"takes K > 0 and N a multiple of {CHUNK}")
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"bf16_product: splits={splits}; the kernel takes "
                         f"1 to {MAX_SPLITS}")
    out = torch.empty((m, n), dtype=_BF16, device=device)
    preact = torch.empty_like(out) if keep_preact else None
    outs = (out, preact) if keep_preact else out
    if m == 0 or n == 0:
        return outs, None
    build.aligned("bf16_product", *(t for t in (a, b, out, residual, preact)
                                    if t is not None))
    lib = library()
    return outs, build.launcher(
        lib, lib.chana_bf16_product, "bf16_product", device, a.data_ptr(),
        b.data_ptr(), out.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if preact is None else preact.data_ptr(), m, n, k,
        LAYOUTS[layout], epilogue, tile_rows(m, n, k),
        split_k(m, n, k) if splits is None else splits)


def bf16_product(a: torch.Tensor, b: torch.Tensor, layout: str = "nn",
                 residual: Optional[torch.Tensor] = None, gelu: bool = False,
                 keep_preact: bool = False):
    """``op(a) op(b)`` (bf16 on a card, 2-D operands stored as ``layout``
    says), rounded to bf16; plus ``residual [M, N]``, or through GELU
    (``(out, preact)`` with ``keep_preact``). One launch a call."""
    if a.device.type == "cpu":
        return bf16_product_ref(a, b, layout, residual, gelu, keep_preact)
    out, launch = prepare_bf16_product(a, b, layout, residual, gelu,
                                       keep_preact)
    if launch is not None:
        launch()
        bf16_product.launches += 1
    return out


bf16_product.launches = 0


# -- the float32 product (the head) --------------------------------------------


def f32_product_ref(a: torch.Tensor, b: torch.Tensor,
                    layout: str = "nn") -> torch.Tensor:
    """Plain PyTorch version of the float32 product kernel (any device):
    ``torch.matmul`` of the operands as stored (float32 products need
    ``set_matmul_precision`` on a card, or they round through TF32)."""
    dims(layout, a, b)
    return torch.matmul(*_as_nn(layout, a, b))


def prepare_f32_product(a: torch.Tensor, b: torch.Tensor,
                        layout: str = "nn"):
    """Check the float32 product kernel's CUDA inputs and bind its launch:
    ``(out, launch)``; ``launch`` is None when the product is empty."""
    device = build.cuda_device("f32_product", a)
    build.check("a", a, _F32, 2, device)
    build.check("b", b, _F32, 2, device)
    m, n, k = dims(layout, a, b)
    if k == 0:
        raise ValueError("f32_product: K=0; the kernel takes K > 0")
    out = torch.empty((m, n), dtype=_F32, device=device)
    if m == 0 or n == 0:
        return out, None
    lib = library()
    return out, build.launcher(
        lib, lib.chana_f32_product, "f32_product", device, a.data_ptr(),
        b.data_ptr(), out.data_ptr(), m, n, k, LAYOUTS[layout])


def f32_product(a: torch.Tensor, b: torch.Tensor,
                layout: str = "nn") -> torch.Tensor:
    """``op(a) op(b)`` in float32 (2-D operands stored as ``layout``
    says). One launch a call."""
    if a.device.type == "cpu":
        return f32_product_ref(a, b, layout)
    out, launch = prepare_f32_product(a, b, layout)
    if launch is not None:
        launch()
        f32_product.launches += 1
    return out


f32_product.launches = 0


# -- differentiable ops ---------------------------------------------------------
#
# Each takes ``x [..., K]`` and a weight ``[K, N]`` and flattens x's leading
# dimensions into the product's rows. The wrappers are looked up on this
# module's names at call time, so a caller may stand in for them.


def rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def weight_grads(ctx, x2, w, dy2) -> tuple:
    """dX (shaped as x) and dW of ``x @ w`` for the cotangent ``dy2``, each
    only where an input needs it."""
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = bf16_product(dy2, w, "nt").reshape(ctx.x_shape)
    if ctx.needs_input_grad[1]:
        dw = bf16_product(x2, dy2, "tn")
    return dx, dw


class Product(torch.autograd.Function):
    """``x @ w`` through ``bf16_product``, plus ``residual`` (x's leading
    shape, ``N`` wide) in the epilogue when given. Backward: the cotangent
    goes to the residual as it is, dX and dW through ``bf16_product``."""

    @staticmethod
    def forward(ctx, x, w, residual=None):
        ctx.save_for_backward(x, w)
        ctx.x_shape = x.shape
        n = w.shape[1]
        out = bf16_product(rows(x), w, "nn",
                           None if residual is None
                           else residual.reshape(-1, n))
        return out.reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = rows(dy.contiguous())
        dx, dw = weight_grads(ctx, rows(x), w, dy2)
        if len(ctx.needs_input_grad) == 2:  # called without a residual
            return dx, dw
        return dx, dw, dy if ctx.needs_input_grad[2] else None


class Head(torch.autograd.Function):
    """``last @ w`` in float32 through ``f32_product``; its backward the
    same kernel in the other layouts."""

    @staticmethod
    def forward(ctx, last, w):
        ctx.save_for_backward(last, w)
        return f32_product(last, w, "nn")

    @staticmethod
    def backward(ctx, dy):
        last, w = ctx.saved_tensors
        dy = dy.contiguous()
        return (f32_product(dy, w, "nt") if ctx.needs_input_grad[0] else None,
                f32_product(last, dy, "tn") if ctx.needs_input_grad[1]
                else None)


def product_ref(x: torch.Tensor, w: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Product``'s plain version, for torch autograd."""
    n = w.shape[1]
    out = bf16_product_ref(rows(x), w, "nn",
                           None if residual is None
                           else residual.reshape(-1, n))
    return out.reshape(*x.shape[:-1], n)


def product_gelu_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``ProductGelu``'s plain version, for torch autograd."""
    out = bf16_product_ref(rows(x), w, "nn", None, True)
    return out.reshape(*x.shape[:-1], w.shape[1])


def head_ref(last: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Head``'s plain version, for torch autograd."""
    return f32_product_ref(last, w, "nn")

