"""The MSRA heatmap codec (SimpleBaselines gaussians, and DARK with ``unbiased``).

The port's own copy of ``probpose_code_tpu/codecs/msra_heatmap.py:MSRAHeatmap``
(``:28``), whose keypoint scale is ``input_size / heatmap_size``. ``encode``
runs on the host (``codecs/utils/gaussian_heatmap.py``); the training path
renders the same maps on the device (``ops/encode.py:
generate_gaussian_device``, ``generate_unbiased_gaussian_device``) from the
keypoints that ``heatmap_keypoints`` gives. ``decode`` is the device decode
of the predict program on one instance: argmax, then the quarter-pixel step,
or DARK with ``unbiased``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .utils.gaussian_heatmap import generate_gaussian_heatmaps, generate_unbiased_gaussian_heatmaps


class MSRAHeatmap:
    def __init__(
        self,
        input_size: Tuple[int, int],
        heatmap_size: Tuple[int, int],
        sigma: float,
        unbiased: bool = False,
        blur_kernel_size: int = 11,
    ) -> None:
        self.input_size = input_size
        self.heatmap_size = heatmap_size
        self.sigma = sigma
        self.unbiased = unbiased
        self.blur_kernel_size = blur_kernel_size
        self.scale_factor = (np.array(input_size) / heatmap_size).astype(np.float32)

    def heatmap_keypoints(self, keypoints: np.ndarray) -> np.ndarray:
        """Input-space keypoints (N, K, 2) in heatmap pixels, in float64:
        the codec's division (in the keypoints' own type) made exact, so
        that the device rounds the centre as the host does."""
        return (keypoints / self.scale_factor).astype(np.float64)

    def encode(self, keypoints: np.ndarray, keypoints_visible: Optional[np.ndarray] = None) -> dict:
        assert keypoints.shape[0] == 1, f"{type(self).__name__} only supports single-instance encoding"
        if keypoints_visible is None:
            keypoints_visible = np.ones(keypoints.shape[:2], dtype=np.float32)
        gen = generate_unbiased_gaussian_heatmaps if self.unbiased else generate_gaussian_heatmaps
        heatmaps, keypoint_weights = gen(
            heatmap_size=self.heatmap_size,
            keypoints=self.heatmap_keypoints(keypoints),
            keypoints_visible=keypoints_visible,
            sigma=self.sigma,
        )
        return dict(heatmaps=heatmaps, keypoint_weights=keypoint_weights)

    def decode(self, encoded: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(K, H, W) maps -> keypoints (1, K, 2) in input space, scores (1, K)."""
        from probpose_code_torch.ops.decode import dark_refine_batch, quarter_offset_refine_batch
        from probpose_code_torch.ops.heatmap import heatmap_maximum_batch

        heatmaps = torch.from_numpy(np.ascontiguousarray(encoded, dtype=np.float32))[None]
        locs, vals = heatmap_maximum_batch(heatmaps)
        if self.unbiased:
            locs = dark_refine_batch(locs, heatmaps, self.blur_kernel_size)
        else:
            locs = quarter_offset_refine_batch(locs, heatmaps)
        return locs.numpy() * self.scale_factor, vals.numpy()
