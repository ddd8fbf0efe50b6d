"""The tanh-GELU's plain version: ``jax.nn.gelu`` (approximate=True) in
float32, rounded to the input's dtype, as ``csrc/gelu.cuh`` computes it
for the standalone kernel (``forecaster.py``'s ``gelu_tanh``) and for the
``w1`` product's epilogue (``products.py``'s ``bf16_product``)."""

from __future__ import annotations

import math

import torch

GELU_K = math.sqrt(2.0 / math.pi)


def gelu_tanh_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the GELU kernel (any device), in
    jax.nn.gelu's (approximate=True) order of operations."""
    x32 = x.to(torch.float32)
    cdf = 0.5 * (1.0 + torch.tanh(GELU_K * (x32 + 0.044715 * (x32 * x32 * x32))))
    return (x32 * cdf).to(x.dtype)
