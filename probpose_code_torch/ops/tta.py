"""Flip test-time augmentation on heatmaps.

Port of ``probpose_code_tpu/ops/tta.py:flip_heatmaps`` (``:15``) in heatmap
mode: mirror the W axis back and swap left/right channels.
"""

from __future__ import annotations

from typing import List, Optional

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
