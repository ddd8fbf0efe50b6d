"""Forecaster kernels: CUDA wrappers, launch counts, plain versions.

``layernorm``, ``causal_attention`` and ``gelu_tanh`` compute the three
non-product steps of ``chanamq_tpu/models/forecaster.py::forward``:
``_layernorm`` (scale only, float32 statistics, eps 1e-6), the core of
``_attention`` between its two projections (causal mask, float32 softmax,
bf16 logits and weights), and ``jax.nn.gelu``'s default tanh form.
``layernorm_bwd``, ``causal_attention_bwd`` and ``gelu_tanh_bwd`` compute
their gradients as JAX's autodiff of the reference does, for
``make_train_step`` (forecaster.py:130-157).

On CUDA tensors they launch the hand-written kernels of
``csrc/forecaster.cu`` and ``csrc/forecaster_train.cu`` (built on first
use, see ``build.py``) or raise; the kernels take bf16 activations only.
On CPU tensors they run the plain PyTorch versions (``*_ref``), in any
float dtype. Nothing falls back from one to the other.

Each plain version rounds where the reference rounds: float32 inside, the
input's dtype out; attention also rounds ``q . k`` and the softmax weights
to the input's dtype, as the reference's bf16 einsums do, and its backward
the cotangents of those two einsums.

Each wrapper's ``launches`` attribute counts its kernel launches, and only
those (``launch_count`` sums them, with the products' and the update's);
``causal_attention.warpgroup_launches`` counts the forwards that took the
long-window (warpgroup) kernel, which ``launches`` also counts, and
``causal_attention_bwd.warpgroup_launches`` the backward calls that took
the long-window pair (two launches each in ``launches``).
``prepare_*`` check a call's CUDA inputs and bind its launch; the
wrappers launch what they return, and a timing loop can launch it again
without the checks (and without counting). ``LayerNorm``,
``CausalAttention`` and ``GeluTanh`` are the differentiable ops: each
forward launches the forward kernel, each backward the backward kernel.
``KERNELS`` names them, the update kernel (``update.py``) and the matrix
products (``products.py``'s ``Product`` and ``Head``, and ``ProductGelu``
here, which joins the ``w1`` product's GELU epilogue to
``gelu_tanh_bwd``) as one set of ops, ``PLAIN`` the plain versions (torch
autograd differentiates those), so a caller can run the same forward or
train step through either. The forward takes GELU in ``w1``'s epilogue
and never calls ``gelu_tanh``; ``GeluTanh`` stays in the sets as GELU
alone, forward and backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from . import build, products, update
from .gelu import GELU_K, gelu_tanh_ref

EPS = 1e-6  # forecaster.py:81

_BF16 = torch.bfloat16
_F32 = torch.float32

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library() -> ctypes.CDLL:
    """The built ``csrc/forecaster.cu`` with its C signatures declared."""
    lib, _ = build.load("forecaster")
    if not getattr(lib, "_chana_typed", False):
        lib.chana_layernorm_geometry.argtypes = [_int, _int, _ptr]
        lib.chana_layernorm_geometry.restype = _int
        lib.chana_layernorm.argtypes = [_ptr] * 3 + [_int] * 2 + [
            ctypes.c_float, _int, _ptr]
        lib.chana_layernorm.restype = _int
        lib.chana_empty.argtypes = [_int, _int, _ptr]
        lib.chana_empty.restype = _int
        lib.chana_causal_attention.argtypes = [_ptr] * 3 + [_int] * 10 + [
            ctypes.c_size_t, ctypes.c_float, _ptr]
        lib.chana_causal_attention.restype = _int
        lib.chana_causal_attention_smem.argtypes = [_int, _int]
        lib.chana_causal_attention_smem.restype = ctypes.c_size_t
        lib.chana_causal_attention_warpgroup.argtypes = [_ptr] * 3 + [
            _int] * 6 + [ctypes.c_size_t, ctypes.c_float, _ptr]
        lib.chana_causal_attention_warpgroup.restype = _int
        lib.chana_causal_attention_warpgroup_smem.argtypes = [_int]
        lib.chana_causal_attention_warpgroup_smem.restype = ctypes.c_size_t
        lib.chana_gelu_tanh.argtypes = [_ptr, _ptr, ctypes.c_int64, _ptr]
        lib.chana_gelu_tanh.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_typed = True
    return lib


# -- layernorm ---------------------------------------------------------------
#
# Both layernorm kernels (``csrc/layernorm_rows.cuh``) give a warp one row
# and lane l the 8 values at columns 8 * (32 c + l) of it; the backward's
# blocks meet in clusters to add their dscale rows. ``layernorm_geometry``
# is their launch geometry, by the same rules as the C launchers, which
# refuse any other.

LN_WARPS = 8             # warps a block, both kernels: one row each
LN_MAX_CHUNKS = 4        # 16-byte chunks a lane holds a row: D <= 1024
LN_MAX_CLUSTER = 8       # the portable thread-block cluster size


class LayerNormGeometry(NamedTuple):
    chunks: int    # ceil(D / 256): 16-byte chunks a lane holds a row
    blocks: int    # blocks that hold rows (the forward's grid):
                   # ceil(rows / LN_WARPS)
    cluster: int   # the backward's blocks a cluster: the largest power of
                   # two up to 8 not over ``blocks``
    grid: int      # the backward's grid: ``blocks`` rounded up to whole
                   # clusters (the blocks past the rows add zero)
    bwd_smem: int  # the backward's dynamic shared memory: a float row of D
                   # a warp and one a block of its cluster

    @property
    def clusters(self) -> int:
        """The backward's clusters: partial dscale rows (none with one)."""
        return self.grid // self.cluster

    def row(self, block: int, warp: int) -> int:
        """The row warp ``warp`` of block ``block`` takes (none when it is
        past the last)."""
        return block * LN_WARPS + warp


def layernorm_geometry(rows: int, d: int) -> LayerNormGeometry:
    """The layernorm kernels' launch geometry for ``rows`` rows of width
    ``d`` (a multiple of 8 up to 1024)."""
    if rows <= 0 or d % 8 or not 0 < d <= 256 * LN_MAX_CHUNKS:
        raise ValueError(f"layernorm: {rows} rows of width {d}; the kernels "
                         "take a width that is a multiple of 8 up to 1024 "
                         "and at least one row")
    blocks = -(-rows // LN_WARPS)
    cluster = LN_MAX_CLUSTER
    while cluster > blocks:
        cluster //= 2
    return LayerNormGeometry(
        chunks=-(-d // 256), blocks=blocks, cluster=cluster,
        grid=-(-blocks // cluster) * cluster,
        bwd_smem=4 * (LN_WARPS + cluster) * d)


def layernorm_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the layernorm kernel (any device)."""
    x32 = x.to(_F32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + EPS) * scale).to(x.dtype)


def _layernorm_width(name: str, x: torch.Tensor) -> int:
    d = x.shape[-1] if x.dim() else 0
    if d % 8 or not 0 < d <= 256 * LN_MAX_CHUNKS:
        raise ValueError(f"{name}: width {d}; the kernel takes a multiple "
                         "of 8 up to 1024")
    return d


def prepare_layernorm(x: torch.Tensor, scale: torch.Tensor):
    """Check the layernorm kernel's CUDA inputs and bind its launch:
    ``(out, launch)``; ``launch`` is None when there is no row."""
    device = build.cuda_device("layernorm", x)
    build.check("x", x, _BF16, x.dim(), device)
    build.check("scale", scale, _F32, 1, device)
    d = _layernorm_width("layernorm", x)
    build.check_shape("scale", scale, (d,))
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out, None
    build.aligned("layernorm", x, scale, out)
    g = layernorm_geometry(rows, d)
    lib = library()
    return out, build.launcher(
        lib, lib.chana_layernorm, "layernorm", device, x.data_ptr(),
        scale.data_ptr(), out.data_ptr(), rows, d, EPS, g.blocks)


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
#
# Both attention kernels (``csrc/attention_tiles.cuh``) cut a head into
# 16-row tiles, the m16 of the tensor cores' mma, and run one block of four
# warps per (batch, head, tile); each keeps its own tiles in shared memory
# and streams the others through a ring of two slots of four tiles (two or
# one for the widest heads), so its shared memory depends on the head
# width alone. ``attention_geometry`` is their launch geometry, by the same
# rules as the C launchers, which refuse any other. In training the
# forward also keeps each row's max and sum of exponentials
# (``causal_attention_with_stats``), and the backward reads them.

ATT_TILE = 16
ATT_WARPS = 4    # warps a block of the forward and the backward's row
                 # pass; its main kernel has two sets of four
ATT_STAGES = (ATT_WARPS, 2, 1)  # tiles a ring slot may hold, the most first
ATT_COLS = 64    # output columns summed at a time
ATT_STATS = 3    # float32 statistics a row: max, sum (the forward's) and
                 # sum of y dW (the backward's row pass) or, from T = 128,
                 # dout . out (the long-window backward's first kernel)
ATT_BWD_LAUNCHES = 2  # the backward's row pass, then its main kernel; or
                      # the long-window pair (dq, then dk and dv)
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block can have (H100)


class AttentionGeometry(NamedTuple):
    tiles: int       # 16-row tiles covering T; rows past T are masked
    hd_pad: int      # head_dim rounded up to 16 with zero columns
    ld: int          # shared-memory row stride in bf16: hd_pad + 8, which
                     # keeps ldmatrix free of bank conflicts (hd_pad at 16,
                     # where the rows stay unpadded)
    copy_bytes: int  # cp.async width: the largest of 16, 8, 4 dividing
                     # 2 * head_dim, so every row's copies stay aligned
    stage: int       # tiles a ring slot holds: four (one a warp), or two or
                     # one where four do not fit
    slots: int       # slots a ring has: two, or one in a window of one
                     # tile whose head is too wide for two (the backward's
                     # rings are then its own tiles)
    fwd_smem: int    # the forward's row max and sum of each warp, a
                     # float32 [16, 64 + 8] output tile, the query tile and
                     # the k and v rings
    stats_smem: int  # the backward's row pass: sum of y dW of each warp,
                     # the q and dout tiles, the k and v rings
    bwd_smem: int    # the backward's own four tiles (k, v, q, dout of its
                     # tile), two rings, and the dlog and W [16, 16 + 8]
                     # tiles of a slot (dlog alone for the dq half)

    def grid(self, b: int, n_heads: int) -> int:
        """Blocks of any of the kernels: one per (batch, head, tile)."""
        return b * n_heads * self.tiles


def attention_geometry(t: int, hd: int) -> AttentionGeometry:
    """The attention kernels' launch geometry for windows of ``t`` rows
    and heads of width ``hd`` (even, and narrow enough that a block's
    tiles fit its shared memory: slots of four tiles up to 336, of two up
    to 576, of one up to 880 at any window; up to 1,776 in a window of one
    tile, 16 rows, with a ring of one slot)."""
    if t <= 0 or hd <= 0 or hd % 2:
        raise ValueError(f"attention: T={t}, head_dim={hd}; the kernels "
                         "take T >= 1 and an even head_dim")
    hd_pad = -(-hd // ATT_TILE) * ATT_TILE
    ld = hd_pad if hd_pad == ATT_TILE else hd_pad + 8
    tiles = -(-t // ATT_TILE)
    for stage in ATT_STAGES:
        # a ring of one slot only where it is needed: one tile, slots of one
        for slots in (2, 1) if stage == 1 and tiles == 1 else (2,):
            ring = slots * stage * ATT_TILE * ld  # bf16 of a ring
            g = AttentionGeometry(
                tiles=tiles, hd_pad=hd_pad, ld=ld,
                copy_bytes=math.gcd(2 * hd, 16), stage=stage, slots=slots,
                fwd_smem=4 * ATT_TILE * (2 * ATT_WARPS + ATT_COLS + 8)
                + 2 * (ATT_TILE * ld + 2 * ring),
                stats_smem=4 * ATT_TILE * ATT_WARPS
                + 2 * (2 * ATT_TILE * ld + 2 * ring),
                bwd_smem=2 * (4 * ATT_TILE * ld
                              + (2 * ring if slots == 2 else 0)
                              + 3 * stage * ATT_TILE * (ATT_TILE + 8)))
            smem = max(g.fwd_smem, g.stats_smem, g.bwd_smem)
            if smem <= SMEM_LIMIT:
                return g
    raise ValueError(f"attention: T={t}, head_dim={hd} needs {smem} B of "
                     f"shared memory with slots of one tile, over the "
                     f"{SMEM_LIMIT} B a block can have")


def attention_bwd_warps(blocks: int, sms: int) -> int:
    """Warps a block of the backward's main kernel: eight (its two halves
    side by side, two blocks an SM) while the grid fits the card at two
    blocks an SM, else four (one warp does both halves; four blocks an
    SM, so a larger grid takes fewer waves)."""
    return 2 * ATT_WARPS if blocks <= 2 * sms else ATT_WARPS


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- causal attention for long windows ----------------------------------------
#
# From a window of ``WG_MIN_T`` rows at head widths that are multiples of
# 16 up to ``WG_MAX_HD``, the forward takes ``csrc/forecaster.cu``'s
# warpgroup kernel: a block of 64 query rows (one warpgroup, wgmma's m64),
# a ring of 64-key tiles filled by TMA, and two passes over the keys. Every
# other shape keeps the 16-row kernel: at T <= 64 it is bound by launch
# latency, and a 64-row block would leave most of the card idle. Both write
# the same row statistics for the backward. ``attention_warpgroup_geometry``
# is the rule, from the shape alone.

WG_MIN_T = 128   # the shortest window the warpgroup kernel takes
WG_MAX_HD = 128  # its widest head (a multiple of 16)
WG_ROWS = 64     # query rows a block: one warpgroup
WG_KEYS = 64     # keys a ring tile
WG_STAGES = 4    # ring stages
WG_BOX = 64 * 128  # bytes of a TMA box: 64 rows of 64 bf16


WG_KV_WIDTHS = (192, 128)  # latent attention's q and k width, v width


class WarpgroupGeometry(NamedTuple):
    blocks: int  # B * H * ceil(T / 64), longest rows first
    smem: int    # dynamic shared memory: the block's q rows and the ring's
                 # four stages of a key and a value tile, each in boxes of
                 # 64 columns, and 1 KB to align them

    @staticmethod
    def of(b: int, t: int, hd: int, n_heads: int,
           hdv: Optional[int] = None) -> "WarpgroupGeometry":
        boxes = -(-hd // 64)  # 64-column boxes a q or k row
        vboxes = boxes if hdv is None else -(-hdv // 64)
        return WarpgroupGeometry(
            blocks=b * n_heads * -(-t // WG_ROWS),
            smem=(boxes + WG_STAGES * (boxes + vboxes)) * WG_BOX + 1024)


def _warpgroup_width(hd: int, hdv: Optional[int] = None) -> bool:
    """Whether the warpgroup kernel takes q and k heads of width ``hd``
    and v heads of width ``hdv`` (``hd`` when None), at any window: one
    width, a multiple of 16 up to ``WG_MAX_HD``, or ``WG_KV_WIDTHS``."""
    if hdv is not None and hdv != hd:
        return (hd, hdv) == WG_KV_WIDTHS
    return hd % 16 == 0 and 0 < hd <= WG_MAX_HD


def attention_warpgroup_geometry(b: int, t: int, hd: int, n_heads: int,
                                 hdv: Optional[int] = None):
    """The warpgroup kernel's geometry for ``b`` windows of ``t`` rows of
    ``n_heads`` heads, q and k of width ``hd`` and v of ``hdv`` (``hd``
    when None), or None where the 16-row kernel runs: a window under
    ``WG_MIN_T`` rows, or widths the warpgroup kernel does not take. The
    backward follows the same rule (``WarpgroupBwdGeometry``)."""
    if t < WG_MIN_T or not _warpgroup_width(hd, hdv):
        return None
    return WarpgroupGeometry.of(b, t, hd, n_heads, hdv)


# The backward takes the long-window pair of ``csrc/forecaster_train.cu``
# wherever the forward takes the warpgroup kernel: a query-major kernel
# (D = dout . out of its rows, then dq over the key prefix) and a key-major
# one (dk and dv over the query tiles at and below its rows), 64 rows a
# block each, every tile on a TMA ring (four stages up to width 64,
# three above).

WG_STAT_BYTES = 1024  # a key-major stage's m, l and D of 64 rows, aligned


class WarpgroupBwdGeometry(NamedTuple):
    blocks: int    # B * H * ceil(T / 64) for each kernel, longest first
    dq_smem: int   # the query-major kernel: its q and dout rows and the
                   # ring's stages of a key and a value tile, in 64-column
                   # boxes, and 1 KB to align them
    dkv_smem: int  # the key-major kernel: its k and v rows and the ring's
                   # stages of a q and a dout tile and their rows' m, l, D

    @staticmethod
    def of(b: int, t: int, hd: int, n_heads: int,
           hdv: Optional[int] = None) -> "WarpgroupBwdGeometry":
        boxes = -(-hd // 64) + -(-(hd if hdv is None else hdv) // 64)
        stages = 4 if boxes == 2 else 3  # up to width 64: four
        own = boxes * WG_BOX
        return WarpgroupBwdGeometry(
            blocks=b * n_heads * -(-t // WG_ROWS),
            dq_smem=own + stages * own + 1024,
            dkv_smem=own + stages * (own + WG_STAT_BYTES) + 1024)


def causal_attention_ref(qkv: torch.Tensor, n_heads: int,
                         v_width: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the attention kernel (any device):
    forecaster.py:89-99 without the two projections. With ``v_width``,
    each v head is read to its first ``v_width`` columns (the rest is
    padding) and the output is ``[B, T, n_heads * v_width]``."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = (z.reshape(b, t, n_heads, hd).transpose(1, 2)
               for z in qkv.split(d, dim=-1))                 # [B,H,T,hd]
    if v_width is not None:
        v = v[..., :v_width]
    logits = torch.matmul(q, k.transpose(-1, -2)).to(_F32) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=qkv.device).tril()
    logits = torch.where(causal, logits, torch.full_like(logits, -1e30))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    out = torch.matmul(weights, v)                            # [B,H,T,hd]
    return out.transpose(1, 2).reshape(b, t, n_heads * v.shape[-1])


def _attention_dims(name: str, qkv: torch.Tensor, n_heads: int) -> tuple:
    """``(b, t, hd)`` of a fused ``qkv [B, T, 3 * n_heads * hd]``."""
    b, t, d3 = qkv.shape
    if n_heads <= 0 or d3 % (3 * n_heads):
        raise ValueError(f"{name}: qkv shape {tuple(qkv.shape)} is not "
                         f"[B, T, 3 * {n_heads} * head_dim]")
    return b, t, d3 // 3 // n_heads


def prepare_causal_attention(qkv: torch.Tensor, n_heads: int, *,
                             keep_stats: bool = False,
                             warpgroup: bool | None = None,
                             v_width: Optional[int] = None):
    """Check the attention kernel's CUDA input and bind its launch:
    ``(out, launch)``; ``launch`` is None for an empty batch. With
    ``keep_stats``, ``(out, stats)`` in place of ``out``: the launch also
    writes each row's max and sum of exponentials into ``stats`` (float32,
    ``ATT_STATS`` planes of B * H * tiles * 16 rows; the backward's row
    pass fills the third). The kernel is the shape's
    (``attention_warpgroup_geometry``); ``launch.warpgroup`` says which.
    ``warpgroup`` forces one, for the GPU tests and timing only.
    ``v_width`` (below the head width: latent attention's values, padded
    in ``qkv``) reads each v head to its first ``v_width`` columns and
    gives ``[B, T, n_heads * v_width]``; only the warpgroup kernel takes
    it, at ``WG_KV_WIDTHS``."""
    device = build.cuda_device("causal_attention", qkv)
    build.check("qkv", qkv, _BF16, 3, device)
    b, t, hd = _attention_dims("causal_attention", qkv, n_heads)
    hdv = hd if v_width is None else v_width
    if hdv != hd and (warpgroup is False or t < WG_MIN_T
                      or not _warpgroup_width(hd, hdv)):
        raise ValueError(
            f"causal_attention: q and k width {hd}, v width {hdv} at T={t}; "
            f"differing widths take the warpgroup kernel alone, at widths "
            f"{WG_KV_WIDTHS} and T >= {WG_MIN_T}")
    out = torch.empty((b, t, n_heads * hdv), dtype=_BF16, device=device)
    stat_rows = 0  # rows of the statistics: the 16-row tiles' rows
    if b and t:
        g = attention_geometry(t, hd)
        stat_rows = g.grid(b, n_heads) * ATT_TILE
    stats = torch.empty(ATT_STATS * stat_rows, dtype=_F32,
                        device=device) if keep_stats else None
    outs = (out, stats) if keep_stats else out
    if stat_rows == 0:
        return outs, None
    build.aligned("causal_attention", qkv, out)
    if warpgroup is None:
        wg = attention_warpgroup_geometry(b, t, hd, n_heads, hdv)
    elif not warpgroup:
        wg = None
    elif _warpgroup_width(hd, hdv):
        wg = WarpgroupGeometry.of(b, t, hd, n_heads, hdv)
    else:
        raise ValueError(f"causal_attention: the warpgroup kernel does not "
                         f"take q and k width {hd} with v width {hdv}")
    lib = library()
    stats_ptr = stats.data_ptr() if keep_stats else None
    if wg is None:
        launch = build.launcher(
            lib, lib.chana_causal_attention, "causal_attention", device,
            qkv.data_ptr(), out.data_ptr(), stats_ptr, b, t, n_heads, hd,
            g.hd_pad, g.ld, g.tiles, g.copy_bytes, g.stage, g.slots,
            g.fwd_smem, math.sqrt(hd))
    else:
        launch = build.launcher(
            lib, lib.chana_causal_attention_warpgroup, "causal_attention",
            device, qkv.data_ptr(), out.data_ptr(), stats_ptr, b, t,
            n_heads, hd, hdv, g.tiles * ATT_TILE, wg.smem, math.sqrt(hd))
    launch.warpgroup = wg is not None
    return outs, launch


def causal_attention(qkv: torch.Tensor, n_heads: int,
                     v_width: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention core: the fused ``qkv [B, T, 3D]`` product
    (q | k | v, heads contiguous in each third) to ``[B, T, D]``, heads
    contiguous, the layout the output projection takes (``[B, T, n_heads
    * v_width]`` with ``v_width``: see ``prepare_causal_attention``)."""
    if qkv.device.type == "cpu":
        return causal_attention_ref(qkv, n_heads, v_width)
    out, launch = prepare_causal_attention(qkv, n_heads, v_width=v_width)
    if launch is not None:
        _launch_attention(launch)
    return out


def _launch_attention(launch) -> None:
    """Launch a bound attention forward and count it: ``launches`` counts
    both kernels, ``warpgroup_launches`` the warpgroup kernel's."""
    launch()
    causal_attention.launches += 1
    causal_attention.warpgroup_launches += launch.warpgroup


causal_attention.launches = 0
causal_attention.warpgroup_launches = 0


def causal_attention_with_stats(qkv: torch.Tensor, n_heads: int,
                                v_width: Optional[int] = None) -> tuple:
    """``causal_attention`` for training: ``(out, stats)``, where
    ``stats`` holds each row's softmax max and sum for
    ``causal_attention_bwd`` (None on the CPU, whose backward recomputes
    them), which from T = 128 also reads ``out``. One launch of the
    forward kernel, counted as its launches."""
    if qkv.device.type == "cpu":
        return causal_attention_ref(qkv, n_heads, v_width), None
    (out, stats), launch = prepare_causal_attention(qkv, n_heads,
                                                    keep_stats=True,
                                                    v_width=v_width)
    if launch is not None:
        _launch_attention(launch)
    return out, stats


# -- tanh-GELU ---------------------------------------------------------------


def prepare_gelu_tanh(x: torch.Tensor):
    """Check the GELU kernel's CUDA input and bind its launch:
    ``(out, launch)``; ``launch`` is None for an empty tensor."""
    device = build.cuda_device("gelu_tanh", x)
    build.check("x", x, _BF16, x.dim(), device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, None
    build.aligned("gelu_tanh", x, out)
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


# -- training: backward passes -------------------------------------------------
#
# ``csrc/forecaster_train.cu`` holds the backward kernels of the three ops
# (a source of its own, so the forward library keeps its hash). Each
# computes what JAX's autodiff of the reference computes, at its rounding
# points: the bf16 cotangent read as float32, float32 inside, one rounding
# to the input's dtype out; attention also rounds the cotangents of its two
# bf16 einsums (``dout . v`` and the logits) where the reference does.


def train_library() -> ctypes.CDLL:
    """The built ``csrc/forecaster_train.cu``'s backward launchers, typed."""
    lib, _ = build.load("forecaster_train")
    if not getattr(lib, "_chana_bwd_typed", False):
        lib.chana_layernorm_geometry.argtypes = [_int, _int, _ptr]
        lib.chana_layernorm_geometry.restype = _int
        lib.chana_layernorm_bwd.argtypes = [_ptr] * 7 + [_int] * 2 + [
            ctypes.c_float] + [_int] * 4 + [_ptr]
        lib.chana_layernorm_bwd.restype = _int
        dims = [_int] * 10 + [ctypes.c_size_t]
        lib.chana_causal_attention_bwd_stats.argtypes = [_ptr] * 3 + dims + [
            ctypes.c_float, _ptr]
        lib.chana_causal_attention_bwd_stats.restype = _int
        lib.chana_causal_attention_bwd.argtypes = [_ptr] * 4 + dims + [
            _int, ctypes.c_float, _ptr]
        lib.chana_causal_attention_bwd.restype = _int
        for smem in (lib.chana_causal_attention_bwd_smem,
                     lib.chana_causal_attention_bwd_stats_smem):
            smem.argtypes = [_int, _int]
            smem.restype = ctypes.c_size_t
        wg = [_int] * 6 + [ctypes.c_size_t, ctypes.c_float, _ptr]
        lib.chana_causal_attention_bwd_dq.argtypes = [_ptr] * 5 + wg
        lib.chana_causal_attention_bwd_dq.restype = _int
        lib.chana_causal_attention_bwd_dkv.argtypes = [_ptr] * 4 + wg
        lib.chana_causal_attention_bwd_dkv.restype = _int
        lib.chana_causal_attention_bwd_warpgroup_smem.argtypes = [_int] * 3
        lib.chana_causal_attention_bwd_warpgroup_smem.restype = \
            ctypes.c_size_t
        lib.chana_gelu_tanh_bwd.argtypes = [_ptr] * 3 + [ctypes.c_int64, _ptr]
        lib.chana_gelu_tanh_bwd.restype = _int
        lib.chana_cuda_error_string.argtypes = [_int]
        lib.chana_cuda_error_string.restype = ctypes.c_char_p
        lib._chana_bwd_typed = True
    return lib


def layernorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor,
                      scale: torch.Tensor) -> tuple:
    """Plain PyTorch version of the layernorm backward kernel (any
    device): ``(dx in x's dtype, dscale float32)`` for the cotangent ``dy``
    of ``layernorm(x, scale)``."""
    x32 = x.to(_F32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (x32 - mu) * rstd
    dy32 = dy.to(_F32)
    dscale = (dy32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    g = dy32 * scale
    dx = rstd * (g - g.mean(-1, keepdim=True)
                 - xhat * (g * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dscale


# the layernorm backward's scratch for each (device, stream): a counter the
# kernel leaves zero and partial dscale rows, grown to the most clusters seen
_LN_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _layernorm_bwd_scratch(device: torch.device, floats: int) -> tuple:
    """``(partial, counter)`` for a launch on ``device``'s current stream,
    with room for ``floats`` partial sums. One counter serves every launch
    on a stream: it is zero before the first (``torch.zeros``), each launch
    leaves it zero (its last block resets it), and launches on one stream
    run one after another, so none sees another's count or partials."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    got = _LN_SCRATCH.get(key)
    if got is None or got[0].numel() < floats:
        counter = got[1] if got is not None else torch.zeros(
            1, dtype=torch.int32, device=device)
        partial = torch.empty(max(floats, 1), dtype=_F32, device=device)
        got = _LN_SCRATCH[key] = (partial, counter)
    return got


def prepare_layernorm_bwd(dy: torch.Tensor, x: torch.Tensor,
                          scale: torch.Tensor):
    """Check the layernorm backward kernel's CUDA inputs and bind its
    launch: ``((dx, dscale), launch)``; ``launch`` is None when there is no
    row (dscale is then 0). The launch takes its stream's scratch
    (``_layernorm_bwd_scratch``) and allocates nothing else."""
    device = build.cuda_device("layernorm_bwd", x)
    build.check("x", x, _BF16, x.dim(), device)
    build.check("dy", dy, _BF16, x.dim(), device)
    build.check_shape("dy", dy, tuple(x.shape))
    build.check("scale", scale, _F32, 1, device)
    d = _layernorm_width("layernorm_bwd", x)
    build.check_shape("scale", scale, (d,))
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return (dx, torch.zeros(d, dtype=_F32, device=device)), None
    dscale = torch.empty(d, dtype=_F32, device=device)
    build.aligned("layernorm_bwd", dy, x, scale, dx, dscale)
    g = layernorm_geometry(rows, d)
    partial, counter = _layernorm_bwd_scratch(device, g.clusters * d)
    lib = train_library()
    launch = build.launcher(
        lib, lib.chana_layernorm_bwd, "layernorm_bwd", device,
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), counter.data_ptr(), rows, d,
        EPS, g.blocks, g.cluster, g.grid, g.bwd_smem)
    launch.scratch = (partial, counter)  # alive while the launch is
    return (dx, dscale), launch


def layernorm_bwd(dy: torch.Tensor, x: torch.Tensor,
                  scale: torch.Tensor) -> tuple:
    """Backward of ``layernorm``: ``(dx, dscale)`` for the cotangent ``dy``
    (bf16 on a card, ``x``'s shape); ``dscale`` is summed over every row in
    a fixed order. On a card: one launch a call and no other (the kernel's
    counter and partial rows are kept for the stream and reused, which is
    safe because the kernel leaves the counter zero and launches on one
    stream do not overlap)."""
    if x.device.type == "cpu":
        return layernorm_bwd_ref(dy, x, scale)
    out, launch = prepare_layernorm_bwd(dy, x, scale)
    if launch is not None:
        launch()
        layernorm_bwd.launches += 1
    return out


layernorm_bwd.launches = 0


def _heads(z: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = z.shape
    return z.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def causal_attention_bwd_ref(qkv: torch.Tensor, dout: torch.Tensor,
                             n_heads: int, stats=None,
                             out=None) -> torch.Tensor:
    """Plain PyTorch version of the attention backward kernels (any
    device): the cotangent of the fused ``qkv`` product for the cotangent
    ``dout [B, T, H * v_width]`` of ``causal_attention(qkv, n_heads,
    v_width)`` (``v_width`` read from ``dout``; the v heads' columns past
    it get zeros). It takes the kernels' arguments but recomputes the row
    statistics (``stats`` and ``out`` are not read)."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = (_heads(z, n_heads) for z in qkv.split(d, dim=-1))
    do = _heads(dout, n_heads)
    hdv = do.shape[-1]
    v = v[..., :hdv]
    logits = torch.matmul(q, k.transpose(-1, -2)).to(_F32) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=qkv.device).tril()
    logits = torch.where(causal, logits, torch.full_like(logits, -1e30))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    y = e / e.sum(-1, keepdim=True)
    dw = torch.matmul(do, v.transpose(-1, -2)).to(_F32)
    u = y * dw
    dl = u - y * u.sum(-1, keepdim=True)
    dl = torch.where(causal, dl, torch.zeros_like(dl)) / math.sqrt(hd)
    dlog = dl.to(qkv.dtype)
    dq = torch.matmul(dlog, k)
    dk = torch.matmul(dlog.transpose(-1, -2), q)
    dv = torch.matmul(y.to(qkv.dtype).transpose(-1, -2), do)
    dv = torch.nn.functional.pad(dv, (0, hd - hdv))
    return torch.cat([z.transpose(1, 2).reshape(b, t, d)
                      for z in (dq, dk, dv)], dim=-1)


def prepare_causal_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                                 n_heads: int, stats=None, out=None, *,
                                 warps: int | None = None,
                                 warpgroup: bool | None = None):
    """Check the attention backward kernels' CUDA inputs and bind their
    launch: ``(dqkv, launch)``; ``launch()`` runs ``ATT_BWD_LAUNCHES``
    launches, and is None for an empty batch. ``stats`` and ``out`` are
    what ``causal_attention_with_stats`` returned for this ``qkv``. The
    pair is the shape's, the forward's rule
    (``attention_warpgroup_geometry``); ``launch.warpgroup`` says which:
    - the 16-row pair: the row pass reads the max and sum in ``stats`` and
      writes the third plane, then the main kernel; ``warps`` (4 or 8)
      overrides ``attention_bwd_warps``;
    - the long-window pair, which also reads ``out`` (D = dout . out into
      the third plane, then dq), then dk and dv. ``dout`` may be narrower
      than the v heads (``[B, T, n_heads * v_width]``, latent attention's
      values): the pair alone takes that, at ``WG_KV_WIDTHS``.
    ``warpgroup`` forces one pair, for the GPU tests and timing only;
    ``launch.parts`` are the two launches, each alone, for timing."""
    device = build.cuda_device("causal_attention_bwd", qkv)
    build.check("qkv", qkv, _BF16, 3, device)
    b, t, hd = _attention_dims("causal_attention_bwd", qkv, n_heads)
    build.check("dout", dout, _BF16, 3, device)
    hdv = dout.shape[-1] // n_heads
    build.check_shape("dout", dout, (b, t, n_heads * hdv))
    if hdv != hd and (warpgroup is False or t < WG_MIN_T
                      or not _warpgroup_width(hd, hdv)):
        raise ValueError(
            f"causal_attention_bwd: q and k width {hd}, v width {hdv} at "
            f"T={t}; differing widths take the long-window pair alone, at "
            f"widths {WG_KV_WIDTHS} and T >= {WG_MIN_T}")
    dqkv = torch.empty_like(qkv)
    if b == 0 or t == 0:
        return dqkv, None
    g = attention_geometry(t, hd)
    if stats is None:
        raise ValueError("causal_attention_bwd: no row statistics; run the "
                         "forward with causal_attention_with_stats")
    build.check("stats", stats, _F32, 1, device)
    build.check_shape("stats", stats,
                      (ATT_STATS * g.grid(b, n_heads) * ATT_TILE,))
    build.aligned("causal_attention_bwd", qkv, dout, dqkv)
    if warpgroup is None:
        warpgroup = attention_warpgroup_geometry(b, t, hd, n_heads,
                                                 hdv) is not None
    elif warpgroup and not _warpgroup_width(hd, hdv):
        raise ValueError(f"causal_attention_bwd: the long-window pair does "
                         f"not take q and k width {hd} with v width {hdv}")
    lib = train_library()
    if not warpgroup:
        dims = (b, t, n_heads, hd, g.hd_pad, g.ld, g.tiles, g.copy_bytes,
                g.stage, g.slots)
        first = build.launcher(
            lib, lib.chana_causal_attention_bwd_stats,
            "causal_attention_bwd", device, qkv.data_ptr(), dout.data_ptr(),
            stats.data_ptr(), *dims, g.stats_smem, math.sqrt(hd))
        second = build.launcher(
            lib, lib.chana_causal_attention_bwd, "causal_attention_bwd",
            device, qkv.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            dqkv.data_ptr(), *dims, g.bwd_smem,
            warps or attention_bwd_warps(g.grid(b, n_heads),
                                         _sm_count(device)),
            math.sqrt(hd))
    else:
        if out is None:
            raise ValueError("causal_attention_bwd: no forward output; the "
                             "long-window pair reads it (D = dout . out)")
        build.check("out", out, _BF16, 3, device)
        build.check_shape("out", out, (b, t, n_heads * hdv))
        build.aligned("causal_attention_bwd", out)
        bg = WarpgroupBwdGeometry.of(b, t, hd, n_heads, hdv)
        dims = (b, t, n_heads, hd, hdv, g.tiles * ATT_TILE)
        first = build.launcher(
            lib, lib.chana_causal_attention_bwd_dq, "causal_attention_bwd",
            device, qkv.data_ptr(), dout.data_ptr(), out.data_ptr(),
            stats.data_ptr(), dqkv.data_ptr(), *dims, bg.dq_smem,
            math.sqrt(hd))
        second = build.launcher(
            lib, lib.chana_causal_attention_bwd_dkv, "causal_attention_bwd",
            device, qkv.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            dqkv.data_ptr(), *dims, bg.dkv_smem, math.sqrt(hd))

    def launch() -> None:
        first()
        second()

    launch.parts = (first, second)  # each alone, for timing
    launch.warpgroup = warpgroup
    return dqkv, launch


def causal_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                         n_heads: int, stats=None, out=None) -> torch.Tensor:
    """Backward of ``causal_attention``: dq | dk | dv in the fused ``[B, T,
    3D]`` layout of ``qkv``, the cotangent of the qkv product. ``stats``
    and ``out`` are the two outputs of ``causal_attention_with_stats(qkv,
    n_heads)`` (None on the CPU); ``dout`` is ``[B, T, n_heads *
    v_width]``. On a card: two launches a call, the shape's pair
    (``prepare_causal_attention_bwd``)."""
    if qkv.device.type == "cpu":
        return causal_attention_bwd_ref(qkv, dout, n_heads)
    dqkv, launch = prepare_causal_attention_bwd(qkv, dout, n_heads, stats,
                                                out)
    if launch is not None:
        launch()
        causal_attention_bwd.launches += ATT_BWD_LAUNCHES
        causal_attention_bwd.warpgroup_launches += launch.warpgroup
    return dqkv


causal_attention_bwd.launches = 0
causal_attention_bwd.warpgroup_launches = 0


def gelu_tanh_bwd_ref(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the GELU backward kernel (any device):
    ``dy * gelu'(x)`` in float32, rounded once to ``x``'s dtype."""
    x32 = x.to(_F32)
    x2 = x32 * x32
    t = torch.tanh(GELU_K * (x32 + 0.044715 * (x2 * x32)))
    grad = 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * GELU_K * (
        1.0 + 0.134145 * x2)
    return (dy.to(_F32) * grad).to(x.dtype)


def prepare_gelu_tanh_bwd(dy: torch.Tensor, x: torch.Tensor):
    """Check the GELU backward kernel's CUDA inputs and bind its launch:
    ``(dx, launch)``; ``launch`` is None for an empty tensor."""
    device = build.cuda_device("gelu_tanh_bwd", x)
    build.check("x", x, _BF16, x.dim(), device)
    build.check("dy", dy, _BF16, x.dim(), device)
    build.check_shape("dy", dy, tuple(x.shape))
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, None
    build.aligned("gelu_tanh_bwd", dy, x, dx)
    lib = train_library()
    return dx, build.launcher(
        lib, lib.chana_gelu_tanh_bwd, "gelu_tanh_bwd", device, dy.data_ptr(),
        x.data_ptr(), dx.data_ptr(), x.numel())


def gelu_tanh_bwd(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Backward of ``gelu_tanh``: ``dy * gelu'(x)``, in ``x``'s dtype."""
    if x.device.type == "cpu":
        return gelu_tanh_bwd_ref(dy, x)
    dx, launch = prepare_gelu_tanh_bwd(dy, x)
    if launch is not None:
        launch()
        gelu_tanh_bwd.launches += 1
    return dx


gelu_tanh_bwd.launches = 0


def launch_count() -> int:
    """Kernel launches of every forecaster wrapper so far: the forward's
    and backward's kernels here, the products' (``products.py``) and the
    update's (``update.py``), the sum of their ``launches``."""
    return (layernorm.launches + causal_attention.launches
            + gelu_tanh.launches + layernorm_bwd.launches
            + causal_attention_bwd.launches + gelu_tanh_bwd.launches
            + products.bf16_product.launches + products.f32_product.launches
            + update.clip_momentum_sgd.launches
            + update.sum_of_squares.launches + update.momentum_sgd.launches)


# -- differentiable ops ----------------------------------------------------------


class LayerNorm(torch.autograd.Function):
    """``layernorm`` whose backward is ``layernorm_bwd``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return layernorm(x, scale)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return layernorm_bwd(dy.contiguous(), x, scale)


class CausalAttention(torch.autograd.Function):
    """``causal_attention`` whose backward is ``causal_attention_bwd``,
    from the row statistics and the output the forward kept (only when
    ``qkv`` needs a gradient: a forecast keeps none)."""

    @staticmethod
    def forward(ctx, qkv, n_heads):
        if ctx.needs_input_grad[0]:
            out, ctx.stats = causal_attention_with_stats(qkv, n_heads)
        else:
            out, ctx.stats = causal_attention(qkv, n_heads), None
        ctx.save_for_backward(qkv, out)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out = ctx.saved_tensors
        return causal_attention_bwd(qkv, dout.contiguous(), ctx.n_heads,
                                    ctx.stats, out), None


class GeluTanh(torch.autograd.Function):
    """``gelu_tanh`` whose backward is ``gelu_tanh_bwd``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_tanh(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return gelu_tanh_bwd(dy.contiguous(), x)


class ProductGelu(torch.autograd.Function):
    """``gelu(x @ w)`` through ``products.bf16_product``'s GELU epilogue,
    keeping the rounded product when an input needs a gradient. Backward:
    ``gelu_tanh_bwd`` on it, then dX and dW through the product kernel."""

    @staticmethod
    def forward(ctx, x, w):
        keep = any(ctx.needs_input_grad)
        got = products.bf16_product(products.rows(x), w, "nn", None, True,
                                    keep)
        out, preact = got if keep else (got, None)
        ctx.save_for_backward(x, w, preact)
        ctx.x_shape = x.shape
        return out.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w, preact = ctx.saved_tensors
        du = gelu_tanh_bwd(products.rows(dy.contiguous()), preact)
        return products.weight_grads(ctx, products.rows(x), w, du)


# -- op sets -----------------------------------------------------------------


class Ops(NamedTuple):
    layernorm: Callable
    causal_attention: Callable
    gelu_tanh: Callable
    update: Callable  # clip + momentum + SGD, kernels/update.py
    sum_of_squares: Callable  # the update's two launches apart (sharded)
    momentum_sgd: Callable
    # the matrix products, kernels/products.py: x @ w (plus a residual),
    # gelu(x @ w), and the float32 head
    product: Callable
    product_gelu: Callable
    head: Callable


KERNELS = Ops(LayerNorm.apply, CausalAttention.apply, GeluTanh.apply,
              update.clip_momentum_sgd, update.sum_of_squares,
              update.momentum_sgd, products.Product.apply,
              ProductGelu.apply, products.Head.apply)
PLAIN = Ops(layernorm_ref, causal_attention_ref, gelu_tanh_ref,
            update.clip_momentum_sgd_ref, update.sum_of_squares_ref,
            update.momentum_sgd_ref, products.product_ref,
            products.product_gelu_ref, products.head_ref)
