"""What surrounds the tensor-core attention kernels, on the CPU.

The forward (``csrc/forecaster.cu``) and backward
(``csrc/forecaster_train.cu``) attention kernels cut a head into 16-row
tiles (``csrc/attention_tiles.cuh``). They run only on a card
(``tests/test_torch_kernels_gpu.py``), so two things they rest on are
held here:

- **The launch geometry** that ``kernels/forecaster.py`` computes and
  passes to the C launchers (which refuse any other): padded widths,
  tile count, grid, copy width and shared memory, for every shape the
  ``gpu`` tests run and for the flagship.
- **A plain tile-order model** of each kernel, kept in this file: the same
  split into 16-row query tiles and 16-key tiles, the diagonal tile masked,
  the head width and the window zero-padded as the kernels stage them, and
  ``W`` and ``dlog`` held in the working dtype, as the kernels hold them in
  shared memory; and of the long-window kernels (from T = 128), 64-row
  blocks over 64-row tiles, the backward pair with D = dout . out. Each
  model is held against the plain versions (``causal_attention_ref``,
  ``causal_attention_bwd_ref``) and, as a differentiable op, against
  ``jax.vjp`` of the JAX package's ``_attention`` on the same numpy
  inputs.

Tolerances, max abs error, those ``tests/test_torch_forecaster_train.py``
states for attention: float32 within 1e-5 of the largest value (the same
arithmetic, summed in another order); bfloat16 within two bf16 steps at
the largest value (the model rounds where the reference rounds, so a sum
taken in another order moves a value by about a step).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from chanamq_tpu.models import forecaster as ref
from chanamq_tpu_torch.kernels import forecaster as fk
from test_torch_forecaster_train import assert_close, configs, op_tol
from test_torch_kernels_gpu import FORECASTER_SHAPES, TRAIN_SHAPES

TILE = fk.ATT_TILE
FLAGSHIP = (1, 64, 256, 4, 1024)
# (B, T, d_model, heads): one tile; three tiles at head width 32; two tiles
# at head width 6 (zero columns, 4-byte copies); the flagship's four tiles
MODEL_SHAPES = [(2, 8, 32, 4), (3, 33, 64, 2), (2, 17, 12, 2),
                (1, 64, 256, 4)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: these tests run beside other files on every
    core (see tests/test_torch_forecaster_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the launch geometry ---------------------------------------------------------


def _old_fwd_smem(t: int, hd: int) -> int:
    """Shared memory the first forward design (one block per (batch, head),
    CUDA cores) took: q, k, v as bf16 pairs at an odd row stride and eight
    warps' float rows of weights."""
    hw = hd // 2
    ld = hw + 1 if hw % 2 == 0 else hw
    return 3 * t * ld * 4 + 8 * t * 4


def _old_bwd_smem(t: int, hd: int) -> int:
    """... and the first backward design: q, k, v, dout and two float
    [T, T] matrices."""
    hw = hd // 2
    ld = hw + 1 if hw % 2 == 0 else hw
    return 4 * t * ld * 4 + 2 * t * t * 4


def _largest_t(smem_of, hd: int) -> int:
    t = 1
    while smem_of(t + 1, hd) <= fk.SMEM_LIMIT:
        t += 1
    return t


# every shape the gpu tests give each kernel, and the flagship
GEOMETRY_CASES = sorted(
    {(s[:4], "fwd_smem") for s in FORECASTER_SHAPES + [FLAGSHIP]}
    | {(s[:4], "bwd_smem") for s in TRAIN_SHAPES + [FLAGSHIP]})


@pytest.mark.parametrize("shape,smem", GEOMETRY_CASES)
def test_geometry_covers_the_shape(shape, smem):
    b, t, d, heads = shape
    hd = d // heads
    g = fk.attention_geometry(t, hd)
    assert g.hd_pad % TILE == 0 and hd <= g.hd_pad < hd + TILE
    assert (g.tiles - 1) * TILE < t <= g.tiles * TILE
    assert g.grid(b, heads) == b * heads * g.tiles
    assert getattr(g, smem) <= fk.SMEM_LIMIT
    assert g.stats_smem <= fk.SMEM_LIMIT
    # every row's copies aligned, at the widest width that divides it
    assert g.copy_bytes in (4, 8, 16) and (2 * hd) % g.copy_bytes == 0
    assert g.copy_bytes == 16 or (2 * hd) % (2 * g.copy_bytes)
    # ldmatrix reads 16-byte rows; an odd count of 16-byte units a row puts
    # eight rows in eight bank groups (the narrowest width stays unpadded)
    assert (2 * g.ld) % 16 == 0 and g.ld >= g.hd_pad
    assert g.ld == TILE or (2 * g.ld // 16) % 2 == 1


def test_geometry_at_the_flagship():
    """T = 64, head_dim = 64: four tiles, 16 blocks at the service's batch
    of 1, 256 at the training batch of 16; the forward and the backward's
    row pass under the 48 KB a block has without opting in, the
    backward's main kernel (its own four tiles and both streams staged at
    once) opted in but still four blocks an SM; and the four key tiles of
    the longest prefix in one ring slot (staged once, as when the kernels
    held a head whole)."""
    g = fk.attention_geometry(64, 64)
    assert (g.tiles, g.hd_pad, g.ld, g.copy_bytes) == (4, 64, 72, 16)
    assert g.grid(1, 4) == 16 and g.grid(16, 4) == 256
    assert max(g.fwd_smem, g.stats_smem) <= 48 * 1024
    assert 4 * g.bwd_smem <= fk.SMEM_LIMIT
    assert g.tiles <= g.stage == fk.ATT_WARPS


@pytest.mark.parametrize("hd", [4, 6, 8, 12, 16, 32, 64, 128, 256])
def test_geometry_keeps_the_first_designs_shapes(hd):
    """The longest window the first designs took at each head width still
    fits the tensor-core kernels' shared memory."""
    for old, new in ((_old_fwd_smem, "fwd_smem"),
                     (_old_bwd_smem, "bwd_smem")):
        t = _largest_t(old, hd)
        assert getattr(fk.attention_geometry(t, hd), new) <= fk.SMEM_LIMIT


def test_geometry_refuses():
    with pytest.raises(ValueError):
        fk.attention_geometry(64, 7)  # odd head width
    with pytest.raises(ValueError):
        fk.attention_geometry(0, 64)
    # a head too wide for a block's tiles at a slot of one: past 880 at a
    # window of more than one tile, past 1,776 at one tile
    with pytest.raises(ValueError):
        fk.attention_geometry(17, 896)
    with pytest.raises(ValueError):
        fk.attention_geometry(16, 1792)
    assert fk.attention_geometry(100, 880).bwd_smem <= fk.SMEM_LIMIT
    assert fk.attention_geometry(16, 1776).bwd_smem <= fk.SMEM_LIMIT
    # the window of 400 at head width 64 the gpu tests once saw refused
    # now fits
    g = fk.attention_geometry(400, 64)
    assert max(g.fwd_smem, g.stats_smem, g.bwd_smem) <= fk.SMEM_LIMIT


def test_backward_warps_by_grid():
    """The backward's main kernel runs its two halves side by side (eight
    warps, two blocks an SM) while its grid fits the card at two blocks an
    SM, else on four warps (four blocks an SM): the flagship's training
    batch of 16 takes eight on an H100 (132 SMs), a batch of 32 four."""
    g = fk.attention_geometry(64, 64)
    assert fk.attention_bwd_warps(g.grid(16, 4), 132) == 2 * fk.ATT_WARPS
    assert fk.attention_bwd_warps(g.grid(32, 4), 132) == fk.ATT_WARPS
    assert fk.attention_bwd_warps(264, 132) == 8
    assert fk.attention_bwd_warps(265, 132) == 4


@pytest.mark.parametrize("hd,stage", [(2, 4), (16, 4), (336, 4), (352, 2),
                                      (384, 2), (576, 2), (592, 1),
                                      (880, 1)])
def test_geometry_slot_size_by_head_width(hd, stage):
    """A ring slot holds four tiles (one a warp) while the three kernels'
    shared memory fits, else two, else one: every head width the first
    tensor-core kernels took at windows of 32 and more (up to 880) still
    runs, at every window."""
    g = fk.attention_geometry(64, hd)
    assert g.stage == stage
    assert max(g.fwd_smem, g.stats_smem, g.bwd_smem) <= fk.SMEM_LIMIT
    if stage > 1:
        wider = fk.attention_geometry(64, hd + 16)
        assert wider.stage <= stage


def _held_whole_smem(t: int, hd: int) -> int:
    """The shared memory the tensor-core kernels took when they held a
    head whole (PRs 4-5): the larger of the forward's (a q tile, k and v
    of the whole prefix) and the backward's (q, k, v and dout of the whole
    window, with dlog and W rows)."""
    rows = -(-t // TILE) * TILE
    hd_pad = -(-hd // TILE) * TILE
    ld = hd_pad if hd_pad == TILE else hd_pad + 8
    fwd = 4 * TILE * (2 * fk.ATT_WARPS + fk.ATT_COLS + 8) \
        + 2 * ld * (TILE + 2 * rows)
    bwd = 2 * (4 * rows * ld + 2 * rows * (TILE + 8) + TILE * (rows + 8))
    return max(fwd, bwd)


@pytest.mark.parametrize("t", [1, 16, 17, 32, 48, 64, 128, 256, 320])
def test_geometry_keeps_the_widths_of_the_whole_head_kernels(t):
    """Every head width the kernels that held a head whole took at a
    window still runs there: up to 1,776 at one tile (a ring of one slot,
    the backward's rings its own tiles), 880 at 32, 416 at 64."""
    widest = max(hd for hd in range(2, 2000, 2)
                 if _held_whole_smem(t, hd) <= fk.SMEM_LIMIT)
    g = fk.attention_geometry(t, widest)
    assert max(g.fwd_smem, g.stats_smem, g.bwd_smem) <= fk.SMEM_LIMIT
    assert (g.slots == 1) == (widest > 880)
    assert g.slots == 2 or g.tiles == 1


@pytest.mark.parametrize("hd", [2, 6, 16, 32, 64, 128, 256, 336, 384, 880])
def test_geometry_smem_does_not_depend_on_the_window(hd):
    """Every kernel keeps its own tiles and streams the rest through a
    ring of fixed size, so its shared memory is one number a head width:
    the same for one row, the flagship's 64 and windows far past every
    limit the kernels had when they held a head whole."""
    smem = {t: fk.attention_geometry(t, hd)[4:] for t in
            (1, 15, 16, 17, 64, 65, 400, 897, 1024, 4096, 100_000)}
    assert len(set(smem.values())) == 1, smem
    assert max(smem[1]) <= fk.SMEM_LIMIT
    assert fk.attention_geometry(100_000, hd).tiles == 6250


# -- the tile-order models ---------------------------------------------------------


def _heads(z: torch.Tensor, n_heads: int, g) -> torch.Tensor:
    """[B, T, D] -> [B, H, rows, hd_pad], zero rows past T and zero columns
    past head_dim: the kernels' shared-memory staging."""
    b, t, d = z.shape
    hd = d // n_heads
    z = z.reshape(b, t, n_heads, hd).transpose(1, 2)
    return F.pad(z, (0, g.hd_pad - hd, 0, g.tiles * TILE - t))


def _unheads(z: torch.Tensor, t: int, hd: int) -> torch.Tensor:
    b, h = z.shape[:2]
    return z[:, :, :t, :hd].transpose(1, 2).reshape(b, t, h * hd)


def _mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A tensor-core product: exact products of the inputs, summed in
    float64 and rounded to float32. Products of bf16 values are exact and
    so, at these widths, are their sums, so a product's bits do not depend
    on the shape it was taken in (a tile of it gives the same values as
    the whole)."""
    return torch.matmul(a.double(), b.double()).float()


def _row_softmax(q, k, i: int, t: int, hd: int, dtype) -> torch.Tensor:
    """The float32 softmax y of query tile i's rows over the key tiles it
    sees (keys < 16 (i + 1)): logits rounded to ``dtype`` and divided by
    sqrt(hd), keys past the row or past T masked (the diagonal tile)."""
    keys = (i + 1) * TILE
    s = _mma(q[:, :, i * TILE:keys], k[:, :, :keys].transpose(-1, -2))
    s = s.to(dtype).float() / math.sqrt(hd)
    row = torch.arange(i * TILE, keys)[:, None]
    key = torch.arange(keys)[None, :]
    s = s.masked_fill((key > row) | (key >= t), float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def attention_tiles(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The forward kernel's order: each 16-row query tile against its key
    prefix, W = the weights in qkv's dtype, out = W . V rounded once."""
    b, t, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    g = fk.attention_geometry(t, hd)
    q, k, v = (_heads(z, n_heads, g) for z in qkv.split(d3 // 3, dim=-1))
    out = torch.zeros_like(q)
    for i in range(g.tiles):
        keys = (i + 1) * TILE
        w = _row_softmax(q, k, i, t, hd, qkv.dtype).to(qkv.dtype)
        out[:, :, i * TILE:keys] = _mma(w, v[:, :, :keys]).to(qkv.dtype)
    return _unheads(out, t, hd)


def attention_bwd_tiles(qkv: torch.Tensor, dout: torch.Tensor,
                        n_heads: int) -> torch.Tensor:
    """The backward kernel's order: a block per tile t recomputes the full
    softmax rows of query tiles i >= t, keeps dlog and W of key tile t (and
    the whole dlog row of tile t) in qkv's dtype, zero in padded rows, then
    dq = dlog . K over key tiles <= t and dk = dlog^T . Q, dv = W^T . dout
    over query tiles >= t, each rounded once."""
    b, t, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    dtype = qkv.dtype
    g = fk.attention_geometry(t, hd)
    q, k, v = (_heads(z, n_heads, g) for z in qkv.split(d3 // 3, dim=-1))
    do = _heads(dout, n_heads, g)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    real = (torch.arange(g.tiles * TILE) < t)[:, None]
    for tt in range(g.tiles):
        own = slice(tt * TILE, (tt + 1) * TILE)
        dl_t, w_t = [], []
        for i in range(tt, g.tiles):
            keys = (i + 1) * TILE
            rows = slice(i * TILE, keys)
            y = _row_softmax(q, k, i, t, hd, dtype)
            dw = _mma(do[:, :, rows], v[:, :, :keys].transpose(-1, -2))
            dw = dw.to(dtype).float()
            su = (y * dw).sum(-1, keepdim=True)
            dlog = ((y * dw - y * su) / math.sqrt(hd)).to(dtype)
            dlog = torch.where(real[rows], dlog, torch.zeros_like(dlog))
            w = torch.where(real[rows], y.to(dtype), torch.zeros_like(dlog))
            dl_t.append(dlog[..., own])
            w_t.append(w[..., own])
            if i == tt:
                dq[:, :, own] = _mma(dlog, k[:, :, :keys]).to(dtype)
        below = slice(tt * TILE, None)
        dk[:, :, own] = _mma(torch.cat(dl_t, -2).transpose(-1, -2),
                             q[:, :, below]).to(dtype)
        dv[:, :, own] = _mma(torch.cat(w_t, -2).transpose(-1, -2),
                             do[:, :, below]).to(dtype)
    return torch.cat([_unheads(z, t, hd) for z in (dq, dk, dv)], dim=-1)


class TileAttention(torch.autograd.Function):
    """``attention_tiles`` whose backward is ``attention_bwd_tiles``."""

    @staticmethod
    def forward(ctx, qkv, n_heads):
        ctx.save_for_backward(qkv)
        ctx.n_heads = n_heads
        return attention_tiles(qkv, n_heads)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return attention_bwd_tiles(qkv, dout.contiguous(), ctx.n_heads), None


# -- the streamed models: the ring of a slot's tiles (the geometry's stage) -----


def _slots(first: int, last: int, stage: int) -> list:
    """Tiles [first, last) as the ring streams them: slots of ``stage``."""
    return [(a, min(a + stage, last)) for a in range(first, last, stage)]


def _logits(q_rows, k_rows, row0: int, key0: int, t: int, hd: int,
            dtype) -> torch.Tensor:
    """Logits of query rows row0.. against keys key0..: rounded to
    ``dtype``, divided by sqrt(hd), -inf past the row or past T."""
    s = _mma(q_rows, k_rows.transpose(-1, -2)).to(dtype).float() \
        / math.sqrt(hd)
    row = torch.arange(row0, row0 + q_rows.shape[-2])[:, None]
    key = torch.arange(key0, key0 + k_rows.shape[-2])[None, :]
    return s.masked_fill((key > row) | (key >= t), float("-inf"))


def _row_pass(q, k, v, do, i: int, t: int, hd: int, dtype,
              stage: int, kept=None) -> tuple:
    """Query tile i's max, sum of exponentials and (with ``do``) sum of
    y dW, over its key prefix slot by slot, each sum added in slot order:
    the forward's passes (the max and the sum, which it keeps for
    training) and the backward's row pass (the sum of y dW). ``kept``: the
    max and sum a forward kept for every row ([B, H, rows, 1] each), read
    in place of the first two."""
    rows = slice(i * TILE, (i + 1) * TILE)
    keys = [slice(a * TILE, b * TILE) for a, b in _slots(0, i + 1, stage)]
    s = [_logits(q[:, :, rows], k[:, :, ks], i * TILE, ks.start, t, hd,
                 dtype) for ks in keys]
    if kept is not None:
        m, l = (z[:, :, rows] for z in kept)
        e = [torch.exp(x - m) for x in s]
    else:
        m = s[0].amax(-1, keepdim=True)
        for x in s[1:]:
            m = torch.maximum(m, x.amax(-1, keepdim=True))
        e = [torch.exp(x - m) for x in s]
        l = sum(x.sum(-1, keepdim=True) for x in e)
    if do is None:
        return m, l, e, keys
    su = sum(((x / l) * _mma(do[:, :, rows], v[:, :, ks].transpose(
        -1, -2)).to(dtype).float()).sum(-1, keepdim=True)
        for x, ks in zip(e, keys))
    return m, l, su


def attention_stream(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The forward kernel's streamed order: a query tile's key prefix in
    ring slots, the max and the exponentials' sum slot by slot, then W =
    the weights in qkv's dtype and W . V slot by slot, the slots' partial
    sums added in order and rounded once."""
    b, t, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    g = fk.attention_geometry(t, hd)
    q, k, v = (_heads(z, n_heads, g) for z in qkv.split(d3 // 3, dim=-1))
    out = torch.zeros_like(q)
    for i in range(g.tiles):
        _, l, e, keys = _row_pass(q, k, None, None, i, t, hd, qkv.dtype,
                                  g.stage)
        o = sum(_mma((x / l).to(qkv.dtype), v[:, :, ks])
                for x, ks in zip(e, keys))
        out[:, :, i * TILE:(i + 1) * TILE] = o.to(qkv.dtype)
    return _unheads(out, t, hd)


def _dlog(q_rows, k_rows, do_rows, v_rows, row0: int, key0: int, stats,
          t: int, hd: int, dtype) -> tuple:
    """dlog and W of one block of query rows row0.. and keys key0.., from
    the row pass's statistics alone; zero in rows past T."""
    m, l, su = stats
    y = torch.exp(_logits(q_rows, k_rows, row0, key0, t, hd, dtype) - m) / l
    dw = _mma(do_rows, v_rows.transpose(-1, -2)).to(dtype).float()
    real = (torch.arange(row0, row0 + q_rows.shape[-2]) < t)[:, None]
    dlog = ((y * dw - y * su) / math.sqrt(hd)).to(dtype)
    zero = torch.zeros_like(dlog)
    return (torch.where(real, dlog, zero),
            torch.where(real, y.to(dtype), zero))


def attention_bwd_stream(qkv: torch.Tensor, dout: torch.Tensor,
                         n_heads: int, kept=None) -> torch.Tensor:
    """The backward kernels' streamed order: the row pass's max, sum and
    sum of y dW of every query tile (the max and sum from ``kept``, what
    a forward kept, when given); then for each tile t, dk and dv over
    the query tiles >= t and dq over the key tiles <= t, a ring slot at a
    time, dlog and W rebuilt from the statistics, the slots' partial
    products added in order and rounded once."""
    b, t, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    dtype = qkv.dtype
    g = fk.attention_geometry(t, hd)
    q, k, v = (_heads(z, n_heads, g) for z in qkv.split(d3 // 3, dim=-1))
    do = _heads(dout, n_heads, g)
    stats = [_row_pass(q, k, v, do, i, t, hd, dtype, g.stage, kept)
             for i in range(g.tiles)]
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for tt in range(g.tiles):
        own = slice(tt * TILE, (tt + 1) * TILE)
        dk_t = dv_t = dq_t = 0
        for i0, i1 in _slots(tt, g.tiles, g.stage):
            rows = slice(i0 * TILE, i1 * TILE)
            st = [torch.cat([stats[i][n] for i in range(i0, i1)], -2)
                  for n in range(3)]
            dl, w = _dlog(q[:, :, rows], k[:, :, own], do[:, :, rows],
                          v[:, :, own], rows.start, own.start, st, t, hd,
                          dtype)
            dk_t = dk_t + _mma(dl.transpose(-1, -2), q[:, :, rows])
            dv_t = dv_t + _mma(w.transpose(-1, -2), do[:, :, rows])
        for j0, j1 in _slots(0, tt + 1, g.stage):
            keys = slice(j0 * TILE, j1 * TILE)
            dl, _ = _dlog(q[:, :, own], k[:, :, keys], do[:, :, own],
                          v[:, :, keys], own.start, keys.start, stats[tt],
                          t, hd, dtype)
            dq_t = dq_t + _mma(dl, k[:, :, keys])
        dq[:, :, own], dk[:, :, own], dv[:, :, own] = (
            z.to(dtype) for z in (dq_t, dk_t, dv_t))
    return torch.cat([_unheads(z, t, hd) for z in (dq, dk, dv)], dim=-1)


def _inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, t, 3 * d)).astype(np.float32)
    dout = rng.normal(size=(b, t, d)).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", MODEL_SHAPES)
def test_forward_tiles_match_plain(b, t, d, heads, dtype):
    qkv_np, _ = _inputs(b, t, d, 100 + t)
    qkv = torch.from_numpy(qkv_np).to(DTYPES[dtype])
    got = attention_tiles(qkv, heads)
    want = fk.causal_attention_ref(qkv, heads)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert_close(got, want.float(), op_tol(dtype, "attention", _np(want)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", MODEL_SHAPES)
def test_backward_tiles_match_plain(b, t, d, heads, dtype):
    qkv_np, dout_np = _inputs(b, t, d, 200 + t)
    qkv = torch.from_numpy(qkv_np).to(DTYPES[dtype])
    dout = torch.from_numpy(dout_np).to(DTYPES[dtype])
    got = attention_bwd_tiles(qkv, dout, heads)
    want = fk.causal_attention_bwd_ref(qkv, dout, heads)
    assert got.dtype == want.dtype and got.shape == want.shape
    for part in range(3):  # dq, dk, dv, each within its own tolerance
        cols = slice(part * d, (part + 1) * d)
        w = want[..., cols]
        assert_close(got[..., cols], w.float(),
                     op_tol(dtype, "attention", _np(w)), f"part {part}")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,d,heads", [(8, 32, 4), (17, 12, 2), (33, 64, 2)])
def test_tiles_match_jax_vjp(t, d, heads, dtype):
    """qkv product -> the tile-order attention -> identity proj against
    jax.vjp of the reference's ``_attention`` with an identity ``proj``, as
    ``test_attention_vjp_matches_jax`` holds the plain versions."""
    jcfg, tcfg = configs(dtype, seq_len=t, d_model=d, n_heads=heads,
                         d_ff=4 * d, n_layers=1)
    rng = np.random.default_rng(300 + t)
    a = rng.normal(size=(2, t, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) / math.sqrt(d)).astype(np.float32)
    dy = rng.normal(size=(2, t, d)).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)
    out, vjp = jax.vjp(lambda a, w: ref._attention(a, w, eye, jcfg),
                       jnp.asarray(a, jcfg.dtype), jnp.asarray(w))
    want_da, want_dw = vjp(jnp.asarray(dy, jcfg.dtype))
    ta = torch.from_numpy(a).to(tcfg.dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fused = torch.matmul(ta, tw.to(tcfg.dtype))
    got = torch.matmul(TileAttention.apply(fused, heads),
                       torch.from_numpy(eye).to(tcfg.dtype))
    assert_close(got, np.asarray(out, np.float32),
                 op_tol(dtype, "attention", np.asarray(out, np.float32)),
                 "out")
    da, dw = torch.autograd.grad(got, (ta, tw),
                                 torch.from_numpy(dy).to(tcfg.dtype))
    assert_close(da, want_da, op_tol(dtype, "attention", want_da), "da")
    assert_close(dw, want_dw, op_tol(dtype, "attention", want_dw), "dw")


# -- the streamed models against the unstreamed ones and the plain versions ----


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", MODEL_SHAPES)
def test_streamed_models_are_the_unstreamed_within_one_slot(b, t, d, heads,
                                                            dtype):
    """At T <= 64 every stream is one ring slot, so the streamed order is
    the one the kernels had when they held a head whole: the same bits."""
    assert -(-t // TILE) <= fk.attention_geometry(t, d // heads).stage
    qkv_np, dout_np = _inputs(b, t, d, 400 + t)
    qkv = torch.from_numpy(qkv_np).to(DTYPES[dtype])
    dout = torch.from_numpy(dout_np).to(DTYPES[dtype])
    assert torch.equal(attention_stream(qkv, heads),
                       attention_tiles(qkv, heads))
    assert torch.equal(attention_bwd_stream(qkv, dout, heads),
                       attention_bwd_tiles(qkv, dout, heads))


# windows past the old limits (896 rows at head width 16 in the backward,
# 320 at 64): ragged last tiles, many slots; and a head of 384, whose slots
# hold two tiles
LONG_SHAPES = [(1, 1000, 32, 2), (1, 330, 128, 2), (1, 70, 768, 2)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", LONG_SHAPES)
def test_streamed_models_match_plain_past_the_old_limit(b, t, d, heads,
                                                        dtype):
    qkv_np, dout_np = _inputs(b, t, d, 500 + t)
    qkv = torch.from_numpy(qkv_np).to(DTYPES[dtype])
    dout = torch.from_numpy(dout_np).to(DTYPES[dtype])
    want = fk.causal_attention_ref(qkv, heads)
    assert_close(attention_stream(qkv, heads), want.float(),
                 op_tol(dtype, "attention", _np(want)), "out")
    got = attention_bwd_stream(qkv, dout, heads)
    want = fk.causal_attention_bwd_ref(qkv, dout, heads)
    for part in range(3):
        cols = slice(part * d, (part + 1) * d)
        w = want[..., cols]
        assert_close(got[..., cols], w.float(),
                     op_tol(dtype, "attention", _np(w)), f"part {part}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_attention_matches_jax_past_the_old_limit(dtype):
    """The plain forward and backward at a window of 1,000 (head width 16,
    two heads, B = 1), the CPU path of a service at a long window, against
    jax.vjp of the reference's ``_attention`` with an identity ``proj``."""
    t, d, heads = 1000, 32, 2
    jcfg, tcfg = configs(dtype, seq_len=t, d_model=d, n_heads=heads,
                         d_ff=4 * d, n_layers=1)
    rng = np.random.default_rng(600)
    a = rng.normal(size=(1, t, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) / math.sqrt(d)).astype(np.float32)
    dy = rng.normal(size=(1, t, d)).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)
    out, vjp = jax.vjp(lambda a, w: ref._attention(a, w, eye, jcfg),
                       jnp.asarray(a, jcfg.dtype), jnp.asarray(w))
    want_da, want_dw = vjp(jnp.asarray(dy, jcfg.dtype))
    ta = torch.from_numpy(a).to(tcfg.dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fused = torch.matmul(ta, tw.to(tcfg.dtype))
    got = torch.matmul(fk.KERNELS.causal_attention(fused, heads),
                       torch.from_numpy(eye).to(tcfg.dtype))
    want = np.asarray(out, np.float32)
    assert_close(got, want, op_tol(dtype, "attention", want), "out")
    da, dw = torch.autograd.grad(got, (ta, tw),
                                 torch.from_numpy(dy).to(tcfg.dtype))
    assert_close(da, want_da, op_tol(dtype, "attention", want_da), "da")
    assert_close(dw, want_dw, op_tol(dtype, "attention", want_dw), "dw")


# -- the long-window (warpgroup) kernel: its shape rule and its order -----------


# (case, B, T, d_model, heads, whether the warpgroup kernel takes it): the
# flagship's training call and its forecast at window 2,048, the service's
# default window 64 (training and forecast), run_node's compact model (4
# heads of 16) at its window 64 and at 1,024, a tensor-parallel rank of the
# flagship (one head of four at tp = 4; two at tp = 2), the shortest window
# and one short of it, and widths the warpgroup kernel does not take (not
# a multiple of 16, or over 128)
SHAPE_RULE = [
    ("flagship-train-w2048", 16, 2048, 256, 4, True),
    ("flagship-forecast-w2048", 1, 2048, 256, 4, True),
    ("flagship-train-w64", 16, 64, 256, 4, False),
    ("flagship-forecast-w64", 1, 64, 256, 4, False),
    ("node-compact-w64", 16, 64, 64, 4, False),
    ("node-compact-train-w1024", 16, 1024, 64, 4, True),
    ("node-compact-forecast-w1024", 1, 1024, 64, 4, True),
    ("tp4-rank-train-w2048", 16, 2048, 64, 1, True),
    ("tp4-rank-forecast-w2048", 1, 2048, 64, 1, True),
    ("tp2-rank-train-w1024", 16, 1024, 128, 2, True),
    ("shortest-window", 16, 128, 256, 4, True),
    ("one-short", 16, 127, 256, 4, False),
    ("width-24", 16, 2048, 96, 4, False),
    ("width-128", 16, 2048, 256, 2, True),
    ("width-144", 16, 2048, 288, 2, False),
]


@pytest.mark.parametrize("case,b,t,d,heads,taken", SHAPE_RULE,
                         ids=[c[0] for c in SHAPE_RULE])
def test_warpgroup_shape_rule(case, b, t, d, heads, taken):
    """Which forward kernel a shape takes, and the warpgroup kernel's
    blocks (64 query rows each) and shared memory."""
    hd = d // heads
    g = fk.attention_warpgroup_geometry(b, t, hd, heads)
    assert (g is not None) == taken
    if g is None:
        return
    assert g.blocks == b * heads * -(-t // 64)
    # the q rows of the block and four stages of a key and a value tile,
    # in 8 KB boxes of 64 columns, and 1 KB to align them: three blocks an
    # SM up to width 64 (228 KB, 1 KB of it reserved a block), else one
    boxes = -(-hd // 64)
    assert g.smem == (1 + 2 * 4) * boxes * 8192 + 1024
    assert (3 if hd <= 64 else 1) * (g.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("t", [1, 64, 127, 128, 129, 4096])
def test_warpgroup_rule_at_the_window_edges(t):
    """The rule reads the window: under ``WG_MIN_T`` rows the 16-row
    kernel runs at any batch, from it the warpgroup kernel in a block of
    64 rows for every 64 rows or part of them."""
    for b in (1, 16):
        g = fk.attention_warpgroup_geometry(b, t, 64, 4)
        if t < fk.WG_MIN_T:
            assert g is None
        else:
            assert g.blocks == b * 4 * -(-t // 64)


def attention_warpgroup(qkv: torch.Tensor, n_heads: int,
                        v_width=None) -> tuple:
    """The warpgroup kernel's order: blocks of 64 query rows, each over the
    64-key tiles its rows see, in order; pass 1 a running max of the
    logits and a running sum of exponentials it rescales at every new max
    (the kernel takes these exponentials as 2^(x log2 e) on its special
    function unit); pass 2 the kernel's W = exp(logit - m) / l in float32,
    rounded to qkv's dtype, and O += W . V a tile at a time, rounded once.
    With ``v_width``, each v head is read to its first ``v_width``
    columns. Returns ``(out, (m, l))``, m and l of every row of the 16-row
    tiles ([B, H, tiles * 16, 1], the rows the kernel writes)."""
    b, t, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    hdv = hd if v_width is None else v_width
    rows, keys = fk.WG_ROWS, fk.WG_KEYS
    dtype = qkv.dtype
    padded = -(-t // rows) * rows
    q, k, v = (F.pad(z.reshape(b, t, n_heads, hd).transpose(1, 2),
                     (0, 0, 0, padded - t))
               for z in qkv.split(d3 // 3, dim=-1))
    v = v[..., :hdv]
    out = torch.zeros_like(v)
    m_all = torch.zeros(b, n_heads, padded, 1)
    l_all = torch.zeros_like(m_all)
    for r0 in range(0, padded, rows):  # a block's rows
        own = slice(r0, r0 + rows)
        tiles = [slice(j * keys, (j + 1) * keys)
                 for j in range(-(-min(r0 + rows, t) // keys))]
        m = torch.full((b, n_heads, rows, 1), float("-inf"))
        l = torch.zeros_like(m)
        for ks in tiles:
            s = _logits(q[:, :, own], k[:, :, ks], r0, ks.start, t, hd,
                        dtype)
            top = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - top) + torch.exp(s - top).sum(
                -1, keepdim=True)
            m = top
        o = 0
        for ks in tiles:
            s = _logits(q[:, :, own], k[:, :, ks], r0, ks.start, t, hd,
                        dtype)
            o = o + _mma((torch.exp(s - m) / l).to(dtype), v[:, :, ks])
        out[:, :, own] = o.to(dtype)
        m_all[:, :, own], l_all[:, :, own] = m, l
    stat_rows = -(-t // TILE) * TILE
    out = out[:, :, :t].transpose(1, 2).reshape(b, t, n_heads * hdv)
    return out, (m_all[:, :, :stat_rows], l_all[:, :, :stat_rows])


class WarpgroupTileAttention(torch.autograd.Function):
    """``attention_warpgroup`` whose backward is ``attention_bwd_stream``
    reading the max and sum the forward kept, as the backward kernels read
    the warpgroup kernel's statistics."""

    @staticmethod
    def forward(ctx, qkv, n_heads):
        out, ctx.kept = attention_warpgroup(qkv, n_heads)
        ctx.save_for_backward(qkv)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return attention_bwd_stream(qkv, dout.contiguous(), ctx.n_heads,
                                    ctx.kept), None


def attention_bwd_warpgroup(qkv: torch.Tensor, dout: torch.Tensor,
                            out: torch.Tensor, n_heads: int, kept,
                            v_width=None) -> torch.Tensor:
    """The long-window backward pair's order. The query-major kernel: D =
    dout . out of each row in float32 (FlashAttention-2's D, in place of
    the 16-row pair's sum of y dW over the prefix), then for each block of
    64 query rows dQ over the 64-key tiles its rows see. The key-major
    kernel: for each block of 64 key rows, dK and dV over the 64-row query
    tiles at and below it. Both rebuild a tile's y = exp(logit - m) / l
    from the m and l the forward kept (``kept``, [B, H, rows, 1] each),
    dlog = (y dW - y D) / sqrt(hd) and W = y in qkv's dtype, zero for
    rows past T; each tile's partial product is added in order and
    rounded once. With ``v_width``, v and dout heads are ``v_width`` wide
    (v read to its first ``v_width`` columns) and dv is padded with zeros
    to the head width."""
    b, t, d3 = qkv.shape
    hd = d3 // 3 // n_heads
    hdv = hd if v_width is None else v_width
    rows = fk.WG_ROWS
    dtype = qkv.dtype
    padded = -(-t // rows) * rows

    def heads(z, width):
        return F.pad(z.reshape(b, t, n_heads, width).transpose(1, 2),
                     (0, 0, 0, padded - t))

    q, k, v = (heads(z, hd) for z in qkv.split(d3 // 3, dim=-1))
    v = v[..., :hdv]
    do, o = heads(dout, hdv), heads(out, hdv)
    dd = (do.float() * o.float()).sum(-1, keepdim=True)
    # rows past the kept ones read m 0 and l 1, as the kernels guard them
    m, l = (F.pad(z, (0, 0, 0, padded - z.shape[-2]), value=fill)
            for z, fill in zip(kept, (0.0, 1.0)))
    blocks = [slice(r0, r0 + rows) for r0 in range(0, padded, rows)]

    def tile(rs, ks):  # dlog and W of query rows rs against keys ks
        y = torch.exp(_logits(q[:, :, rs], k[:, :, ks], rs.start, ks.start,
                              t, hd, dtype) - m[:, :, rs]) / l[:, :, rs]
        dw = _mma(do[:, :, rs], v[:, :, ks].transpose(-1, -2)).to(dtype)
        dl = (y * dw.float() - y * dd[:, :, rs]) / math.sqrt(hd)
        real = (torch.arange(rs.start, rs.stop) < t)[:, None]
        zero = torch.zeros_like(y).to(dtype)
        return (torch.where(real, dl.to(dtype), zero),
                torch.where(real, y.to(dtype), zero))

    dq, dk = torch.zeros_like(q), torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for n, own in enumerate(blocks):
        acc = 0
        for ks in blocks[:n + 1]:  # the key tiles the rows see
            acc = acc + _mma(tile(own, ks)[0], k[:, :, ks])
        dq[:, :, own] = acc.to(dtype)
        acc_k = acc_v = 0
        for rs in blocks[n:]:  # the query tiles at and below the keys
            dl, w = tile(rs, own)
            acc_k = acc_k + _mma(dl.transpose(-1, -2), q[:, :, rs])
            acc_v = acc_v + _mma(w.transpose(-1, -2), do[:, :, rs])
        dk[:, :, own], dv[:, :, own] = acc_k.to(dtype), acc_v.to(dtype)
    dv = F.pad(dv, (0, hd - hdv))
    return torch.cat([z[:, :, :t].transpose(1, 2).reshape(b, t, n_heads * hd)
                      for z in (dq, dk, dv)], dim=-1)


class WarpgroupBwdAttention(torch.autograd.Function):
    """``attention_warpgroup`` whose backward is ``attention_bwd_warpgroup``
    on the statistics and the output it kept, as the training op runs the
    long-window pair."""

    @staticmethod
    def forward(ctx, qkv, n_heads):
        out, ctx.kept = attention_warpgroup(qkv, n_heads)
        ctx.save_for_backward(qkv, out)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out = ctx.saved_tensors
        return attention_bwd_warpgroup(qkv, dout.contiguous(), out,
                                       ctx.n_heads, ctx.kept), None


# (B, T, d_model, heads): a ragged window of four blocks at width 16; the
# shortest window at width 32; a window of 64 (one block, which the timing
# forces) at width 32; a ragged last block at widths 48 and 64; the widest
# head, 128 (two 64-column boxes), ragged; width 80 (two boxes, the second
# mostly zeros); and a window of 257 (a last block of one row)
WG_SHAPES = [(2, 200, 32, 2), (1, 128, 64, 2), (1, 64, 64, 2),
             (1, 192, 48, 1), (1, 400, 128, 2), (1, 150, 256, 2),
             (1, 160, 80, 1), (2, 257, 64, 1)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", WG_SHAPES)
def test_warpgroup_model_matches_plain(b, t, d, heads, dtype):
    qkv_np, _ = _inputs(b, t, d, 700 + t)
    qkv = torch.from_numpy(qkv_np).to(DTYPES[dtype])
    got, (m, l) = attention_warpgroup(qkv, heads)
    want = fk.causal_attention_ref(qkv, heads)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert_close(got, want.float(), op_tol(dtype, "attention", _np(want)))
    # its statistics are the 16-row tiles' (the backward reads either):
    # the same max, the sum within float32 rounding of the rescales
    g = fk.attention_geometry(t, d // heads)
    q, k, _ = (_heads(z, heads, g) for z in qkv.split(d, dim=-1))
    for i in range(g.tiles):
        rows_i = slice(i * TILE, (i + 1) * TILE)
        m16, l16, _, _ = _row_pass(q, k, None, None, i, t, d // heads,
                                   qkv.dtype, g.stage)
        assert torch.equal(m[:, :, rows_i], m16)
        torch.testing.assert_close(l[:, :, rows_i], l16, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,d,heads", [(200, 32, 2), (130, 64, 2)])
def test_warpgroup_model_matches_jax_vjp(t, d, heads, dtype):
    """qkv product -> the warpgroup order (its backward the streamed
    backward on the statistics it kept) -> identity proj against jax.vjp
    of the reference's ``_attention`` with an identity ``proj``."""
    jcfg, tcfg = configs(dtype, seq_len=t, d_model=d, n_heads=heads,
                         d_ff=4 * d, n_layers=1)
    rng = np.random.default_rng(800 + t)
    a = rng.normal(size=(2, t, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) / math.sqrt(d)).astype(np.float32)
    dy = rng.normal(size=(2, t, d)).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)
    out, vjp = jax.vjp(lambda a, w: ref._attention(a, w, eye, jcfg),
                       jnp.asarray(a, jcfg.dtype), jnp.asarray(w))
    want_da, want_dw = vjp(jnp.asarray(dy, jcfg.dtype))
    ta = torch.from_numpy(a).to(tcfg.dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fused = torch.matmul(ta, tw.to(tcfg.dtype))
    got = torch.matmul(WarpgroupTileAttention.apply(fused, heads),
                       torch.from_numpy(eye).to(tcfg.dtype))
    assert_close(got, np.asarray(out, np.float32),
                 op_tol(dtype, "attention", np.asarray(out, np.float32)),
                 "out")
    da, dw = torch.autograd.grad(got, (ta, tw),
                                 torch.from_numpy(dy).to(tcfg.dtype))
    assert_close(da, want_da, op_tol(dtype, "attention", want_da), "da")
    assert_close(dw, want_dw, op_tol(dtype, "attention", want_dw), "dw")


# latent attention's widths at a small window: q and k 192 wide, v 128
# (zeros past it in the operand), two heads
MLA_SHAPE = (1, 130, 2, 192, 128)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", WG_SHAPES)
def test_warpgroup_backward_model_matches_plain(b, t, d, heads, dtype):
    """The long-window backward pair's order, on the statistics and the
    output of the warpgroup forward's, against ``causal_attention_bwd_ref``
    within the attention tolerances, dq, dk and dv each within its own."""
    qkv_np, dout_np = _inputs(b, t, d, 900 + t)
    qkv = torch.from_numpy(qkv_np).to(DTYPES[dtype])
    dout = torch.from_numpy(dout_np).to(DTYPES[dtype])
    out, kept = attention_warpgroup(qkv, heads)
    got = attention_bwd_warpgroup(qkv, dout, out, heads, kept)
    want = fk.causal_attention_bwd_ref(qkv, dout, heads)
    assert got.dtype == want.dtype and got.shape == want.shape
    for part in range(3):
        cols = slice(part * d, (part + 1) * d)
        w = want[..., cols]
        assert_close(got[..., cols], w.float(),
                     op_tol(dtype, "attention", _np(w)), f"part {part}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_warpgroup_backward_model_at_latent_widths(dtype):
    """The same at latent attention's widths (q and k 192, v and dout 128):
    dq, dk and the first 128 columns of each dv head within the attention
    tolerances of the plain version, the rest of each dv head zero."""
    b, t, heads, hd, hdv = MLA_SHAPE
    rng = np.random.default_rng(950)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3, heads, hd)).astype(
        np.float32))
    qkv[:, :, 2, :, hdv:] = 0
    qkv = qkv.reshape(b, t, 3 * heads * hd).to(DTYPES[dtype])
    dout = torch.from_numpy(rng.normal(size=(b, t, heads * hdv)).astype(
        np.float32)).to(DTYPES[dtype])
    out, kept = attention_warpgroup(qkv, heads, hdv)
    torch.testing.assert_close(out, fk.causal_attention_ref(qkv, heads, hdv),
                               rtol=0, atol=op_tol(dtype, "attention",
                                                   _np(out)))
    got = attention_bwd_warpgroup(qkv, dout, out, heads, kept, hdv)
    want = fk.causal_attention_bwd_ref(qkv, dout, heads)
    d = heads * hd
    for part in range(3):
        cols = slice(part * d, (part + 1) * d)
        w = want[..., cols]
        assert_close(got[..., cols], w.float(),
                     op_tol(dtype, "attention", _np(w)), f"part {part}")
    assert not got[..., 2 * d:].reshape(b, t, heads, hd)[..., hdv:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,d,heads", [(200, 32, 2), (130, 64, 2)])
def test_warpgroup_backward_model_matches_jax_vjp(t, d, heads, dtype):
    """qkv product -> the warpgroup order with the long-window backward's
    order -> identity proj against jax.vjp of the reference's
    ``_attention`` with an identity ``proj``."""
    jcfg, tcfg = configs(dtype, seq_len=t, d_model=d, n_heads=heads,
                         d_ff=4 * d, n_layers=1)
    rng = np.random.default_rng(1000 + t)
    a = rng.normal(size=(2, t, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) / math.sqrt(d)).astype(np.float32)
    dy = rng.normal(size=(2, t, d)).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)
    out, vjp = jax.vjp(lambda a, w: ref._attention(a, w, eye, jcfg),
                       jnp.asarray(a, jcfg.dtype), jnp.asarray(w))
    want_da, want_dw = vjp(jnp.asarray(dy, jcfg.dtype))
    ta = torch.from_numpy(a).to(tcfg.dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fused = torch.matmul(ta, tw.to(tcfg.dtype))
    got = torch.matmul(WarpgroupBwdAttention.apply(fused, heads),
                       torch.from_numpy(eye).to(tcfg.dtype))
    assert_close(got, np.asarray(out, np.float32),
                 op_tol(dtype, "attention", np.asarray(out, np.float32)),
                 "out")
    da, dw = torch.autograd.grad(got, (ta, tw),
                                 torch.from_numpy(dy).to(tcfg.dtype))
    assert_close(da, want_da, op_tol(dtype, "attention", want_da), "da")
    assert_close(dw, want_dw, op_tol(dtype, "attention", want_dw), "dw")


def test_warpgroup_backward_geometry():
    """The long-window pair's blocks and shared memory: 64 rows a block
    for each kernel; its own tiles and a ring of four stages up to width
    64 (three above) of a key and a value tile (query-major) or a q and a
    dout tile and 1 KB of their rows' m, l and D (key-major), in 8 KB
    boxes of 64 columns, and 1 KB to align them; two query-major blocks an
    SM up to width 64, and every instance within a block's 227 KB."""
    for hd, hdv in [(hd, hd) for hd in range(16, 129, 16)] + [
            fk.WG_KV_WIDTHS]:
        g = fk.WarpgroupBwdGeometry.of(4, 2048, hd, 16, hdv)
        boxes = -(-hd // 64) + -(-hdv // 64)
        stages = 4 if boxes == 2 else 3
        assert g.blocks == 4 * 16 * 32
        assert g.dq_smem == (1 + stages) * boxes * 8192 + 1024
        assert g.dkv_smem == (1 + stages) * boxes * 8192 + stages * 1024 \
            + 1024
        assert max(g.dq_smem, g.dkv_smem) <= fk.SMEM_LIMIT
        if boxes == 2:
            assert 2 * (g.dq_smem + 1024) <= 228 * 1024
    assert fk.WarpgroupBwdGeometry.of(2, 257, 64, 1).blocks == 2 * 5
