"""Heatmap primitives on (B, K, H, W) tensors.

Port of ``probpose_code_tpu/ops/heatmap.py:gather_hw`` (``:82``).
"""

from __future__ import annotations

import torch


def gather_hw(maps: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """maps[b, k, y[b, k], x[b, k]] from (B, K, H, W) and (B, K) int coords."""
    B, K, H, W = maps.shape
    idx = (y * W + x).to(torch.int64)
    return torch.gather(maps.reshape(B, K, H * W), 2, idx[..., None])[..., 0]
