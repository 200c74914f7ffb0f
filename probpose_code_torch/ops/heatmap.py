"""Heatmap primitives on (B, K, H, W) tensors.

Port of ``probpose_code_tpu/ops/heatmap.py``: ``gaussian_blur_batch``
(``:32``), ``heatmap_maximum_batch`` (``:53``) and ``gather_hw`` (``:82``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from probpose_code_torch.codecs.utils.post_processing import gaussian_kernel1d


@lru_cache(maxsize=16)
def _blur_kernel(ksize: int) -> np.ndarray:
    return gaussian_kernel1d(ksize).astype(np.float32)


def gaussian_blur_batch(heatmaps: torch.Tensor, kernel_size: int = 11) -> torch.Tensor:
    """DARK modulation blur: a separable zero-padded gaussian, then each
    (b, k) map rescaled to its original maximum."""
    if kernel_size % 2 != 1:
        raise ValueError(f"gaussian_blur_batch: kernel_size {kernel_size} must be odd")
    B, K, H, W = heatmaps.shape
    k1d = torch.as_tensor(_blur_kernel(kernel_size), device=heatmaps.device)
    r = (kernel_size - 1) // 2
    x = heatmaps.reshape(B * K, 1, H, W)
    x = F.conv2d(x, k1d.reshape(1, 1, kernel_size, 1), padding=(r, 0))
    x = F.conv2d(x, k1d.reshape(1, 1, 1, kernel_size), padding=(0, r))
    blurred = x.reshape(B, K, H, W)
    origin_max = heatmaps.amax(dim=(2, 3), keepdim=True)
    blur_max = blurred.amax(dim=(2, 3), keepdim=True)
    return blurred * (origin_max / (blur_max + 1e-12))


def heatmap_maximum_batch(heatmaps: torch.Tensor):
    """Argmax of (B, K, H, W) -> locs (B, K, 2) xy float, vals (B, K). The
    first maximum wins a tie; locs are -1 where the maximum is <= 0."""
    B, K, H, W = heatmaps.shape
    flat = heatmaps.reshape(B, K, H * W)
    vals, idx = flat.max(dim=-1)  # documented to return the first maximal index
    locs = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    locs = torch.where((vals <= 0.0)[..., None], torch.full_like(locs, -1.0), locs)
    return locs, vals


def gather_hw(maps: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """maps[b, k, y[b, k], x[b, k]] from (B, K, H, W) and (B, K) int coords,
    read as ``jnp.take_along_axis`` reads the flat index y * W + x: a
    negative index counts from the end once, and one outside the map gives
    NaN."""
    B, K, H, W = maps.shape
    n = H * W
    idx = (y * W + x).to(torch.int64)
    valid = (idx >= -n) & (idx < n)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = torch.gather(maps.reshape(B, K, n), 2, idx[..., None])[..., 0]
    return torch.where(valid, out, torch.full_like(out, float("nan")))
