"""Training targets encoded on the device (expected-OKS maps).

Port of ``probpose_code_tpu/ops/encode.py``: ``probmap_encode_scales``
(``:27``) and ``generate_probmaps_device`` (``:44``). The host ships (B, K, 2)
heatmap-space keypoints; the (B, K, H, W) maps are built on the device as two
separable exponential factors and their outer product, from the same
per-keypoint spread table as the host encoder (``oks_kernel_scales``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from probpose_code_torch.codecs.utils.oks_map import oks_kernel_scales


def probmap_encode_scales(
    K: int, heatmap_size: Tuple[int, int], sigma: float = -1.0, kpt_sigmas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The per-keypoint spread ``s``: ``sigma`` when it is > 0, else the OKS
    spread table."""
    W, H = heatmap_size
    if sigma is not None and sigma > 0:
        return np.full(K, float(sigma), np.float32)
    return oks_kernel_scales(K, H, W, kpt_sigmas).astype(np.float32)


def generate_probmaps_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], scales: np.ndarray,
) -> torch.Tensor:
    """(B, K, 2) heatmap-space keypoints and a (B, K) visibility gate ->
    (B, K, H, W) f32 maps ``exp(-d^2 / 2s)``, zero for keypoints whose
    visibility is below 0.5."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    s2 = torch.as_tensor(2.0 * np.asarray(scales, np.float64), dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    kpts = kpts_hm.float()
    fx = torch.exp(-((xs[None, None, :] - kpts[..., 0:1]) ** 2) / s2[None, :, None])  # (B, K, W)
    fy = torch.exp(-((ys[None, None, :] - kpts[..., 1:2]) ** 2) / s2[None, :, None])  # (B, K, H)
    maps = fy[..., :, None] * fx[..., None, :]
    return maps * (visible >= 0.5).float()[..., None, None]
