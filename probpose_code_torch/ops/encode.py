"""Training targets encoded on the device (expected-OKS and UDP maps).

Port of ``probpose_code_tpu/ops/encode.py``: ``probmap_encode_scales``
(``:27``), ``generate_probmaps_device`` (``:44``) and
``generate_udp_gaussian_device`` (``:74``). The host ships (B, K, 2)
heatmap-space keypoints; the (B, K, H, W) maps are built on the device as two
separable factors and their outer product, from the same per-keypoint spread
table as the host encoder (``oks_kernel_scales``) or the UDP codec's sigma.
The DoubleProbMap codec's two windows (``probpose_code_tpu/codecs/
double_probmap.py:29-131``, which the JAX package encodes on the host) are
two such renders of the keypoints in each window's frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from probpose_code_torch.codecs.utils.oks_map import oks_kernel_scales


def probmap_encode_scales(
    K: int, heatmap_size: Tuple[int, int], sigma: float = -1.0, kpt_sigmas: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> np.ndarray:
    """The per-keypoint spread ``s``: ``sigma`` when it is > 0, else the OKS
    spread table; in ``dtype`` (the host codec's is float64)."""
    W, H = heatmap_size
    if sigma is not None and sigma > 0:
        return np.full(K, float(sigma), dtype)
    return oks_kernel_scales(K, H, W, kpt_sigmas).astype(dtype)


def generate_probmaps_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], scales: np.ndarray,
) -> torch.Tensor:
    """(B, K, 2) heatmap-space keypoints and a (B, K) visibility gate ->
    (B, K, H, W) f32 maps ``exp(-d^2 / 2s)``, zero for keypoints whose
    visibility is below 0.5. Float64 keypoints (the DoubleProbMap windows,
    ``datasets/transforms/common.py``) are rendered in float64, as the host
    codec computes them (``codecs/double_probmap.py:96-101``), and rounded to
    f32 once."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    dtype = torch.float64 if kpts_hm.dtype == torch.float64 else torch.float32
    s2 = torch.as_tensor(2.0 * np.asarray(scales, np.float64), dtype=dtype, device=dev)
    xs = torch.arange(W, dtype=dtype, device=dev)
    ys = torch.arange(H, dtype=dtype, device=dev)
    kpts = kpts_hm.to(dtype)
    fx = torch.exp(-((xs[None, None, :] - kpts[..., 0:1]) ** 2) / s2[None, :, None])  # (B, K, W)
    fy = torch.exp(-((ys[None, None, :] - kpts[..., 1:2]) ** 2) / s2[None, :, None])  # (B, K, H)
    maps = fy[..., :, None] * fx[..., None, :]
    return (maps * (visible >= 0.5).to(dtype)[..., None, None]).float()


def generate_udp_gaussian_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], sigma: float,
) -> torch.Tensor:
    """(B, K, 2) heatmap-space keypoints and a (B, K) visibility gate ->
    (B, K, H, W) f32 UDP targets: a unit-peak gaussian ``exp(-d^2 /
    (2 sigma^2))`` at the sub-pixel keypoint, cut to the window [mu - 3 sigma,
    mu + 3 sigma + 1) around the rounded centre mu = trunc(kpt + 0.5) (the
    bounds truncated toward zero, as the host encoder's int casts), zero for
    keypoints whose visibility is below 0.5. A keypoint whose window misses
    the map gets an all-zero map; its weight is the host's business."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    radius = float(sigma) * 3.0
    s2 = torch.tensor(2.0 * float(sigma) ** 2, dtype=torch.float32)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    kpts = kpts_hm.float()
    mu = torch.trunc(kpts + 0.5)
    lt = torch.trunc(mu - radius)
    rb = torch.trunc(mu + radius + 1.0)
    wx = (xs[None, None, :] >= lt[..., 0:1]) & (xs[None, None, :] < rb[..., 0:1])
    wy = (ys[None, None, :] >= lt[..., 1:2]) & (ys[None, None, :] < rb[..., 1:2])
    fx = torch.exp(-((xs[None, None, :] - kpts[..., 0:1]) ** 2) / s2.to(dev)) * wx
    fy = torch.exp(-((ys[None, None, :] - kpts[..., 1:2]) ** 2) / s2.to(dev)) * wy
    maps = fy[..., :, None] * fx[..., None, :]
    return maps * (visible >= 0.5).float()[..., None, None]
