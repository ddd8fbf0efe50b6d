"""The Moonlight backbone's operations and bytes, counted from its shapes
(``mqbench/configs/moonlight-forecaster.json``, as the driver's
``model_cfg`` gives them), by ``roofline.py``'s rules: each input byte
read once, each output byte written once, an operation counted where the
inputs need it (attention over the causal pairs), nothing recomputed.
Routed experts count ``top_k`` rows a token.
"""

from __future__ import annotations

from mqbench.frozen import roofline


def _tri(cfg: dict, batch: int) -> int:
    """Causal (query, key) pairs of every head: T (T + 1) / 2 a window."""
    t = cfg["seq_len"]
    return batch * cfg["n_heads"] * t * (t + 1) // 2


def forward_flops(cfg: dict, batch: int) -> int:
    """Every product's flops in one forward of ``batch`` windows: the
    embed, each layer's latent attention (its four projections and the
    two products over the causal pairs), the dense SwiGLU or the router,
    ``top_k`` routed experts a token and the shared experts, and the
    float32 head."""
    n = batch * cfg["seq_len"]
    d, h = cfg["d_model"], cfg["n_heads"]
    qk = cfg["qk_nope"] + cfg["qk_rope"]
    proj = 2 * d * (h * qk) + 2 * d * (cfg["kv_rank"] + cfg["qk_rope"]) \
        + 2 * cfg["kv_rank"] * h * (cfg["qk_nope"] + cfg["v_dim"]) \
        + 2 * h * cfg["v_dim"] * d
    attn = n * proj + 2 * _tri(cfg, batch) * (qk + cfg["v_dim"])
    dense = n * 6 * d * cfg["d_ff"]
    moe = n * (2 * d * cfg["n_experts"]
               + cfg["top_k"] * 6 * d * cfg["expert_ff"]
               + 6 * d * cfg["n_shared"] * cfg["expert_ff"])
    layers = cfg["n_layers"]
    dense_layers = cfg["first_dense"]
    return (n * 2 * cfg["n_features"] * d + layers * attn
            + dense_layers * dense + (layers - dense_layers) * moe
            + batch * 2 * d * cfg["n_features"])


def model_flops(cfg: dict, batch: int, train: bool) -> int:
    """A forward's flops, and with ``train`` its backward's too (two
    products for each of the forward's)."""
    return forward_flops(cfg, batch) * (3 if train else 1)


def attention_sites(cfg: dict, batch: int, train: bool) -> list:
    """(flops, bytes) of each layer's attention calls: the forward's two
    products over the causal pairs (q k^T at width 192, p v at 128) and
    with ``train`` the backward's four (dV and dP at 128, dQ and dK at
    192). Bytes: the fused operand (q, k and v padded to 192) and the
    output read and written, the row statistics; the backward's output
    gradient (padded to 192) and statistics read, its operand's gradient
    written."""
    b, t, h = batch, cfg["seq_len"], cfg["n_heads"]
    qk = cfg["qk_nope"] + cfg["qk_rope"]
    v = cfg["v_dim"]
    tri = _tri(cfg, batch)
    fused = 2 * b * t * 3 * h * qk
    fwd = (2 * tri * (qk + v), fused + 2 * b * t * h * v
           + 8 * b * h * t * train)
    bwd = (4 * tri * (qk + v), fused + 2 * b * t * h * qk + 12 * b * h * t
           + fused)
    return [fwd] * cfg["n_layers"] + ([bwd] * cfg["n_layers"] if train
                                      else [])


def expert_sites(cfg: dict, batch: int, train: bool) -> list:
    """(flops, bytes) of each grouped expert product launch: per expert
    layer the gate | up and down products over the ``top_k`` rows of every
    token, and with ``train`` each one's dX and dW. Bytes: the rows and
    every expert's weights read, the output written."""
    rows = batch * cfg["seq_len"] * cfg["top_k"]
    e, d, f = cfg["n_experts"], cfg["d_model"], cfg["expert_ff"]
    sites = []
    for k, n in ((d, 2 * f), (f, d)):
        fwd = (2 * rows * k * n, 2 * (rows * k + e * k * n + rows * n))
        sites.append(fwd)
        if train:
            sites.append((2 * rows * n * k,
                          2 * (rows * n + e * k * n + rows * k)))
            sites.append((2 * rows * k * n,
                          2 * (rows * k + rows * n + e * k * n)))
    return sites * (cfg["n_layers"] - cfg["first_dense"])


def least_s(sites: list) -> float:
    return roofline.least_s(sites, roofline.BF16_FLOPS)
