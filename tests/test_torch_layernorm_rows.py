"""What surrounds the layernorm kernels, on the CPU.

The forward (``csrc/forecaster.cu``) and backward
(``csrc/forecaster_train.cu``) layernorm kernels share one row geometry
(``csrc/layernorm_rows.cuh``). They run only on a card
(``tests/test_torch_kernels_gpu.py``), so two things they rest on are held
here:

- **The launch geometry** that ``kernels/forecaster.py``'s
  ``layernorm_geometry`` computes and passes to the C launchers (which
  refuse any other): every row taken by exactly one warp, the lanes'
  chunks within what a lane holds, the clusters and the padded grid of the
  backward, and the last block's phases within its shared memory.
- **A plain row-and-block-order model** of each kernel, kept in this file:
  lane l's 8 values at columns 8 * (32 c + l), its partial sums in the
  kernels' order, the warp's butterfly of xor 16, 8, 4, 2, 1, and dscale
  added over the block's warps, the cluster's blocks and, by the last
  block, the clusters' rows in phases, each in its fixed order. Each
  model is held against the plain versions (``layernorm_ref``,
  ``layernorm_bwd_ref``) and, as a differentiable op, against the JAX
  package's ``_layernorm`` and its ``jax.vjp`` on the same numpy inputs.
  (The kernels also contract some multiply-adds into fused multiply-adds
  and take ``rsqrtf``, so the model and a kernel can differ in the last
  bits of a float32 value; the card's tests hold the kernels.)

Tolerances, max abs error:
- bfloat16: y and dx within one bf16 step at the largest output
  (``chip_smoke.forecaster_limit`` and ``TRAIN_STEPS``: the same float32
  math summed in another order, rounded once);
- float32: y and dx within 1e-5 of the largest value
  (``tests/test_torch_forecaster_train.py``'s ``F32_RTOL``);
- dscale (float32 in both): within the float32 error of a sum over its
  rows, rows * 2^-24 of the largest column's sum of |dy * xhat|, as
  ``chip_smoke.hold_train_kernel`` states it, plus 4 * 2^-24 of it for the
  error each term carries from its row's statistics (a sum of one row has
  no rounding of its own but still a few ulp in xhat).
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

WARPS = fk.LN_WARPS
THREADS = 32 * WARPS
F32_RTOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (rows, width): one row and 7 rows (one block); the service's batch of 1
# (8 blocks, one cluster); a width of 24 (5 blocks in two clusters of 4,
# the grid padded to 8; 42 phases of 6 column groups in the last block);
# 130 rows at the widest width (17 blocks, three clusters, the grid padded
# to 24); the service's training batch of 16 (128 blocks, 16 clusters); a
# ragged 2,049 rows (257 blocks padded to 264); 563 blocks at a width of
# 512; a width of 136 that fills no chunk (65 blocks padded to 72, 7
# phases of 34 column groups)
MODEL_SHAPES = [(1, 8), (7, 256), (64, 256), (33, 24), (130, 1024),
                (1024, 256), (2049, 256), (4500, 512), (520, 136)]
GEOMETRY_ROWS = [1, 7, 64, 1024, 2048, 2049, 16384]
GEOMETRY_WIDTHS = [8, 256, 1024]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: these tests run beside other files on every
    core (see tests/test_torch_forecaster_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the launch geometry ---------------------------------------------------------


def _phases(d: int) -> int:
    """Thread groups the backward's last block splits the clusters' rows
    over: one a float4 column group each, as many as fit its threads."""
    return max(1, THREADS // (d // 4))


@pytest.mark.parametrize("d", GEOMETRY_WIDTHS)
@pytest.mark.parametrize("rows", GEOMETRY_ROWS)
def test_geometry_covers_every_row_once(rows, d):
    g = fk.layernorm_geometry(rows, d)
    taken = [g.row(b, w) for b in range(g.grid) for w in range(WARPS)
             if g.row(b, w) < rows]
    assert sorted(taken) == list(range(rows))
    # the blocks past ``blocks`` (the backward's padding) take no row, and
    # one block fewer would leave a row out
    assert all(g.row(b, w) >= rows for b in range(g.blocks, g.grid)
               for w in range(WARPS))
    assert (g.blocks - 1) * WARPS < rows
    # a lane holds at most four 16-byte chunks of x and of dy
    assert g.chunks == -(-d // 256) <= fk.LN_MAX_CHUNKS
    # clusters: a power of two up to 8, not over the blocks, whole in the
    # grid, padded by fewer blocks than a cluster
    assert g.cluster in (1, 2, 4, 8) and g.cluster <= g.blocks
    assert g.grid % g.cluster == 0 and 0 <= g.grid - g.blocks < g.cluster
    # shared memory: a float row a warp and one a block of the cluster,
    # within what a block can have; the last block's phases fit its float4
    # a thread
    assert g.bwd_smem == 4 * (WARPS + g.cluster) * d <= fk.SMEM_LIMIT
    assert _phases(d) == 1 or _phases(d) * (d // 4) <= THREADS


@pytest.mark.parametrize("d", range(8, 1025, 8))
def test_geometry_at_every_width(d):
    """Every width the kernels take has a kernel instance (1 to 4 chunks),
    and the last block's threads take each float4 column group once in
    each phase."""
    for rows in (1, 64, 1024, 2048):
        assert fk.layernorm_geometry(rows, d).chunks in (1, 2, 3, 4)
    groups, phases = d // 4, _phases(d)
    taken = [(t // groups, gcol) for t in range(THREADS)
             if t // groups < phases
             for gcol in range(t % groups, groups, THREADS)]
    assert sorted(taken) == [(p, gcol) for p in range(phases)
                             for gcol in range(groups)]


def test_geometry_at_the_service_batches():
    """d_model 256, T = 64: the service's forecast (B = 1, 64 rows) on 8
    blocks of one cluster; its training batch (B = 16, 1,024 rows) on 128
    blocks and __graft_entry__'s batch (B = 32) on 256, one row a warp, in
    clusters of 8. The old backward took 32 rows a block: 2, 32 and 64
    blocks."""
    assert fk.layernorm_geometry(64, 256)[:4] == (1, 8, 8, 8)
    assert fk.layernorm_geometry(1024, 256)[:4] == (1, 128, 8, 128)
    assert fk.layernorm_geometry(2048, 256)[:4] == (1, 256, 8, 256)
    assert [fk.layernorm_geometry(b * 64, 256).clusters
            for b in (1, 16, 32)] == [1, 16, 32]


def test_geometry_refuses():
    for rows, d in ((64, 12), (64, 1032), (64, 0), (0, 256), (-1, 256)):
        with pytest.raises(ValueError):
            fk.layernorm_geometry(rows, d)


# -- the row-and-block-order models ----------------------------------------------


def _lanes(v: torch.Tensor, g) -> torch.Tensor:
    """[rows, D] -> [grid * warps, chunks, 32 lanes, 8]:
    lane l's 8 values at columns 8 * (32 c + l), zero past D and in the
    rows past R, as the kernels load them."""
    rows, d = v.shape
    padded = g.grid * WARPS
    v = F.pad(v, (0, g.chunks * 256 - d, 0, padded - rows))
    return v.reshape(padded, g.chunks, 32, 8)


def _scale_lanes(scale: torch.Tensor, g) -> torch.Tensor:
    """[D] -> [chunks, 32, 8], the scale as each lane loads it."""
    d = scale.shape[0]
    return F.pad(scale.float(), (0, g.chunks * 256 - d)).reshape(
        g.chunks, 32, 8)


def _held(d: int, g) -> torch.Tensor:
    """[chunks, 32]: whether lane l holds chunk c (its columns are < D)."""
    col = (torch.arange(g.chunks)[:, None] * 32 + torch.arange(32)) * 8
    return col < d


def _butterfly(lane: torch.Tensor) -> torch.Tensor:
    """The warp's sum of one float a lane, [..., 32] -> [...]: xor 16, 8, 4,
    2, 1, as ``warp_sums`` adds it (every lane ends with the same total)."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[..., idx ^ o]
    assert bool((lane == lane[..., :1]).all())
    return lane[..., 0]


def _lane_sum(terms: torch.Tensor, held: torch.Tensor, pairs: bool):
    """A lane's running sum of its held chunks' 8 values, chunk by chunk,
    [rows, chunks, 32, 8] -> [rows, 32]; with ``pairs`` two neighbours are
    added first (``sum += v[2k] + v[2k + 1]``)."""
    s = torch.zeros(terms.shape[0], 32, dtype=terms.dtype)
    zero = torch.zeros((), dtype=terms.dtype)
    for c in range(terms.shape[1]):
        if pairs:
            for k in range(4):
                pair = terms[:, c, :, 2 * k] + terms[:, c, :, 2 * k + 1]
                s = s + torch.where(held[c], pair, zero)
        else:
            for k in range(8):
                s = s + torch.where(held[c], terms[:, c, :, k], zero)
    return s


def _row_stats(xv: torch.Tensor, held: torch.Tensor, d: int):
    """Each row's mean and rstd, [rows, 1, 1, 1]: the mean, then the mean
    of squared deviations from it, each a lane sum and a butterfly."""
    mu = _butterfly(_lane_sum(xv, held, pairs=True)) / d
    mu = mu[:, None, None, None]
    sq = _butterfly(_lane_sum((xv - mu) ** 2, held, pairs=False)) / d
    return mu, torch.rsqrt(sq[:, None, None, None] + fk.EPS)


def _columns(v: torch.Tensor, d: int) -> torch.Tensor:
    """[rows, chunks, 32, 8] -> [rows, D]."""
    return v.reshape(v.shape[0], -1)[:, :d]


def layernorm_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The forward kernel's order: each row's statistics from its lanes,
    out = (x - mean) * rstd * scale rounded once to x's dtype."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    g = fk.layernorm_geometry(rows, d)
    xv = _lanes(x2.float(), g)
    mu, rstd = _row_stats(xv, _held(d, g), d)
    out = (xv - mu) * rstd * _scale_lanes(scale, g)
    return _columns(out, d)[:rows].to(x.dtype).reshape(x.shape)


def layernorm_bwd_rows(dy: torch.Tensor, x: torch.Tensor,
                       scale: torch.Tensor) -> tuple:
    """The backward kernel's order: dx from each row's lanes, dscale added
    over a block's warps in warp order, over a cluster's blocks in rank
    order and, with more than one cluster, by the last block over the
    clusters' rows: phase p adds rows p, p + phases, ..., and the phases
    are added in order."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    g = fk.layernorm_geometry(rows, d)
    held = _held(d, g)
    xv = _lanes(x2.float(), g)
    dv = _lanes(dy.reshape(-1, d).float(), g)
    mu, rstd = _row_stats(xv, held, d)
    xh = (xv - mu) * rstd
    gv = dv * _scale_lanes(scale, g)
    mg = _butterfly(_lane_sum(gv, held, pairs=False)) / d
    mgx = _butterfly(_lane_sum(gv * xh, held, pairs=False)) / d
    dx = rstd * (gv - mg[:, None, None, None] - xh * mgx[:, None, None, None])
    dx = _columns(dx, d)[:rows].to(x.dtype).reshape(x.shape)

    terms = (dv * xh).reshape(g.grid, WARPS, -1)
    block = torch.zeros(g.grid, terms.shape[-1])
    for w in range(WARPS):
        block = block + terms[:, w]
    block = block[:, :d].reshape(g.clusters, g.cluster, d)
    cluster = torch.zeros(g.clusters, d)
    for rank in range(g.cluster):
        cluster = cluster + block[:, rank]
    if g.clusters == 1:
        return dx, cluster[0]
    phases = _phases(d)
    dscale = torch.zeros(d)
    for p in range(phases):
        s = torch.zeros(d)
        for r in range(p, g.clusters, phases):
            s = s + cluster[r]
        dscale = dscale + s
    return dx, dscale


class RowLayerNorm(torch.autograd.Function):
    """``layernorm_rows`` whose backward is ``layernorm_bwd_rows``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return layernorm_rows(x, scale)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return layernorm_bwd_rows(dy.contiguous(), x, scale)


# -- the models against the plain versions and JAX --------------------------------


def _inputs(rows: int, d: int, seed: int):
    """x with an offset (the mean matters), dy, and a scale near 1, as
    ``chip_smoke.train_inputs`` makes them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=(rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    return x, dy, scale


def _out_limit(dtype: str, want) -> float:
    """One bf16 step at the largest output, or F32_RTOL of it."""
    top = float(np.abs(np.asarray(want, np.float64)).max())
    if dtype == "float32":
        return F32_RTOL * top
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _dscale_limit(dy, x) -> float:
    """The float32 error of dscale's sum over its rows, and of each term's
    xhat: (rows + 4) * 2^-24 of the largest column's sum of |dy * xhat|."""
    x = torch.as_tensor(np.asarray(x, np.float32)).reshape(-1, x.shape[-1])
    dy = torch.as_tensor(np.asarray(dy, np.float32)).reshape(x.shape)
    xhat = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
        x.var(-1, unbiased=False, keepdim=True) + fk.EPS)
    terms = (dy * xhat).abs().sum(0)
    return (x.shape[0] + 4) * 2.0 ** -24 * float(terms.max())


def _err(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d", MODEL_SHAPES)
def test_forward_rows_match_plain(rows, d, dtype):
    tdt = DTYPES[dtype][1]
    x, _, scale = _inputs(rows, d, 10 + rows + d)
    tx, ts = torch.from_numpy(x).to(tdt), torch.from_numpy(scale)
    got = layernorm_rows(tx, ts)
    want = fk.layernorm_ref(tx, ts)
    assert got.dtype == want.dtype == tdt
    assert _err(got.float(), want.float()) <= _out_limit(dtype, want.float())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d", MODEL_SHAPES)
def test_backward_rows_match_plain(rows, d, dtype):
    tdt = DTYPES[dtype][1]
    x, dy, scale = _inputs(rows, d, 20 + rows + d)
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    ts = torch.from_numpy(scale)
    dx, ds = layernorm_bwd_rows(tdy, tx, ts)
    want_dx, want_ds = fk.layernorm_bwd_ref(tdy, tx, ts)
    assert dx.dtype == tdt and ds.dtype == torch.float32
    assert _err(dx.float(), want_dx.float()) <= _out_limit(
        dtype, want_dx.float())
    assert _err(ds, want_ds) <= _dscale_limit(tdy.float(), tx.float())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 32), (3, 64, 256), (1, 3, 1024)])
def test_rows_match_jax_vjp(shape, dtype):
    """The models as one differentiable op against the reference's
    ``_layernorm`` and ``jax.vjp`` of it: y, dx and dscale."""
    jdt, tdt = DTYPES[dtype]
    d = shape[-1]
    rows = math.prod(shape[:-1])
    x, dy, scale = _inputs(rows, d, 30 + rows + d)
    x, dy = x.reshape(shape), dy.reshape(shape)
    out, vjp = jax.vjp(ref._layernorm, jnp.asarray(x, jdt),
                       jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy, jdt))
    out = np.asarray(out.astype(jnp.float32))
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    got = RowLayerNorm.apply(tx, ts)
    tdy = torch.from_numpy(dy).to(tdt)
    dx, ds = torch.autograd.grad(got, (tx, ts), tdy)
    assert _err(got.float(), out) <= _out_limit(dtype, out)
    assert _err(dx.float(), want_dx) <= _out_limit(dtype, want_dx)
    assert _err(ds, np.asarray(want_ds)) <= _dscale_limit(
        tdy.float().numpy(), tx.detach().float().numpy())
