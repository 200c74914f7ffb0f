"""Flip test-time augmentation on heatmaps and SimCC vectors.

Port of ``probpose_code_tpu/ops/tta.py``: ``flip_heatmaps`` (``:15``) in
heatmap mode, which mirrors the W axis back and swaps left/right channels,
and ``flip_vectors`` (``:52``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def flip_heatmaps(
    heatmaps: torch.Tensor,
    flip_indices: Optional[List[int]] = None,
    shift_heatmap: bool = False,
) -> torch.Tensor:
    """Flip (B, C, H, W) heatmaps back from a horizontally flipped input."""
    heatmaps = torch.flip(heatmaps, dims=[-1])
    if flip_indices is not None:
        heatmaps = heatmaps[:, torch.as_tensor(flip_indices, device=heatmaps.device)]
    if shift_heatmap:
        heatmaps = torch.cat([heatmaps[..., :1], heatmaps[..., :-1]], dim=-1)
    return heatmaps


def flip_vectors(x_labels: torch.Tensor, y_labels: torch.Tensor,
                 flip_indices: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """SimCC vectors (B, K, Wx) / (B, K, Wy) back from a horizontally
    flipped input: both permuted by ``flip_indices``, only x mirrored."""
    idx = torch.as_tensor(flip_indices, device=x_labels.device)
    return torch.flip(x_labels[:, idx], dims=[-1]), y_labels[:, idx]
