"""Published peaks of one NVIDIA H100 and the operations and bytes that a
kernel's inputs need, counted from shapes and data.

The router's counts are copied from ``chip_smoke.py`` (``topic_work``,
``headers_work``, ``_bound``), the forecaster's are written from the
model's shapes. Rules: each input byte is counted read once and each
output byte written once, whatever a kernel reads again; an operation is
counted where these inputs need it (a causal product over the lower
triangle, a compare loop up to its first differing cell); nothing
recomputed counts.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INT32_OPS = 16.7e12
HBM_BYTES = 3.35e12

# the router's token codes (chanamq_tpu_torch/router/compile.py)
PAD = -2
MISS = -3


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES, ops / peak_ops)


# -- router kernels -------------------------------------------------------------


def _before_first(flags: np.ndarray) -> np.ndarray:
    """True at every cell up to and including the first True along the
    last axis (all True where there is none)."""
    return (np.cumsum(flags, axis=-1) - flags) == 0


def _or_work(ok: np.ndarray, w: int) -> tuple:
    """ORs to merge each message's matched mask rows: ``(hits - 1) * W``
    a message. Returns (operations, matched pairs)."""
    hits = ok.sum(axis=1)
    return int(np.maximum(hits - 1, 0).sum()) * w, int(hits.sum())


def topic_work(pre, suf, plen, slen, has_hash, masks, pre_m, suf_m,
               mlen) -> tuple:
    """(int32 operations, matched pairs) that the topic match needs on
    these inputs (numpy arrays). Only real messages (mlen > 0) and real
    rows (a non-zero mask) count; a pair costs its length test and, when
    that passes, its literal pattern cells up to and including the first
    that differs."""
    real = masks.any(axis=1)
    msg = mlen > 0
    cells = np.concatenate([pre[real], suf[real]], axis=1)
    toks = np.concatenate([pre_m[msg], suf_m[msg]], axis=1)
    m = mlen[msg][:, None]
    pl, sl = plen[real][None, :], slen[real][None, :]
    len_ok = np.where(has_hash[real][None, :], m >= pl + sl, m == pl)
    lit = cells >= 0
    differ = lit[None] & (cells[None] != toks[:, None])
    compares = (lit[None] & _before_first(differ)).sum(axis=2)
    ops = len_ok.size + int(compares[len_ok].sum())
    or_ops, matched = _or_work(len_ok & ~differ.any(axis=2),
                               masks.shape[1])
    return ops + or_ops, matched


def headers_work(req, rcount, is_all, masks, pids) -> tuple:
    """(int32 operations, matched pairs) that the headers match needs on
    these inputs (numpy arrays): a required pair id searched for among the
    message's known ids up to the first equal one, a row stopping at its
    first deciding cell, then its count test."""
    real = masks.any(axis=1)
    known = pids != MISS
    msg = known.any(axis=1)
    req, rcount, is_all = req[real], rcount[real], is_all[real]
    known = known[msg]
    eq = ((req[None, :, :, None] == pids[msg][:, None, None, :])
          & known[:, None, None, :])
    present = eq.any(axis=3)
    rank = np.cumsum(known, axis=1)[:, None, None, :]
    nknown = known.sum(axis=1)[:, None, None]
    searched = np.where(eq, rank, nknown[..., None]).min(axis=3)
    cell = (req != PAD)[None]
    decides = np.where(is_all[None, :, None], ~present, present) & cell
    ops = int((searched * (cell & _before_first(decides))).sum())
    ops += present.shape[0] * present.shape[1]
    cnt = (present & cell).sum(axis=2)
    ok = np.where(is_all[None, :], cnt == rcount[None, :], cnt > 0)
    or_ops, matched = _or_work(ok, masks.shape[1])
    return ops + or_ops, matched


# -- forecaster -----------------------------------------------------------------


def _product(m: int, k: int, n: int, extra_out: int = 0,
             extra_in: int = 0) -> tuple:
    """(flops, bytes) of a bfloat16 ``[m, k] @ [k, n]``: both operands
    read once, the output written once, plus ``extra_in`` more ``[m, n]``
    inputs (a residual) and ``extra_out`` more outputs (a kept
    pre-activation)."""
    return (2 * m * k * n,
            2 * (m * k + k * n + m * n * (1 + extra_in + extra_out)))


def product_sites(cfg: dict, batch: int, train: bool) -> list:
    """(flops, bytes) of each bfloat16 product launch in one forward at
    ``batch`` windows of ``cfg["seq_len"]`` rows, and with ``train`` in
    its backward too (each weight's dX and dW; the embedding's dW alone,
    its input being data)."""
    n = batch * cfg["seq_len"]
    d, ff, f = cfg["d_model"], cfg["d_ff"], cfg["n_features"]
    layer = [(d, 3 * d, 0, 0), (d, d, 0, 1), (d, ff, int(train), 0),
             (ff, d, 0, 1)]
    sites = [_product(n, f, d)]
    for _ in range(cfg["n_layers"]):
        for k, out, keep, res in layer:
            sites.append(_product(n, k, out, keep, res))
            if train:
                sites.append(_product(n, out, k))
                sites.append(_product(k, n, out))
    if train:
        sites.append(_product(f, n, d))
    return sites


def product_counts(cfg: dict, batch: int, train: bool) -> tuple:
    """(flops, bytes) of ``product_sites`` summed."""
    sites = product_sites(cfg, batch, train)
    return sum(a for a, _ in sites), sum(b for _, b in sites)


def least_s(sites: list, peak: float = BF16_FLOPS) -> float:
    """The sum of each launch's least time."""
    return sum(bound_s(b, a, peak) for a, b in sites)


def attention_sites(cfg: dict, batch: int, train: bool) -> list:
    """(flops, bytes) of each layer's causal attention call: the
    forward's two products over the lower triangle (``q k^T`` and ``p
    v``), and with ``train`` the backward's four (dV, dP, dQ, dK), the
    recomputed scores not counted. Bytes: the fused qkv and the output
    (bfloat16), the backward's output gradient and row statistics
    (float32) read and its qkv gradient written."""
    b, t, d = batch, cfg["seq_len"], cfg["d_model"]
    h = cfg["n_heads"]
    hd = d // h
    tri = b * h * hd * t * (t + 1)   # 2 flops a multiply-add, T(T+1)/2 pairs
    fwd = (2 * tri, 2 * (b * t * 3 * d + b * t * d) + 4 * b * h * t * train)
    bwd = (4 * tri, 2 * (b * t * 3 * d + 2 * b * t * d) + 4 * b * h * t
           + 2 * b * t * 3 * d)
    return [fwd] * cfg["n_layers"] + ([bwd] * cfg["n_layers"] if train
                                      else [])


def attention_counts(cfg: dict, batch: int, train: bool) -> tuple:
    """(flops, bytes) of ``attention_sites`` summed."""
    sites = attention_sites(cfg, batch, train)
    return sum(a for a, _ in sites), sum(b for _, b in sites)


def model_flops(cfg: dict, batch: int, train: bool) -> int:
    """Every product's flops in a forward (``train``: and its backward),
    the float32 head's included."""
    f = product_counts(cfg, batch, train)[0] \
        + attention_counts(cfg, batch, train)[0]
    head = 2 * batch * cfg["d_model"] * cfg["n_features"]
    return f + head * (3 if train else 1)
