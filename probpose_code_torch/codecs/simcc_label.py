"""The SimCC label codec (RTMPose): 1-D x and y classification vectors.

The port's own copy of ``probpose_code_tpu/codecs/simcc_label.py:SimCCLabel``
(``:21``), its ``gaussian`` and ``standard`` smoothing. Keypoints go to bins
as ``around(kpt * simcc_split_ratio)`` (half to even); the vectors are
``around(w * ratio)`` and ``around(h * ratio)`` long. ``encode`` runs on the
host; the training path renders the same labels on the device (``ops/
encode.py:generate_simcc_labels_device``) from the bins that ``bins``
gives. ``decode`` is the predict program's: the joint argmax over both
vectors, over the split ratio. Its DARK refinement (``use_dark``) and
visibility decode are not ported; no shipped config of the port sets them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


class SimCCLabel:
    def __init__(
        self,
        input_size: Tuple[int, int],
        smoothing_type: str = "gaussian",
        sigma: Union[float, int, Tuple[float, float]] = 6.0,
        simcc_split_ratio: float = 2.0,
        label_smooth_weight: float = 0.0,
        normalize: bool = True,
        use_dark: bool = False,
        decode_visibility: bool = False,
        decode_beta: float = 150.0,
    ) -> None:
        if smoothing_type not in {"gaussian", "standard"}:
            raise ValueError(f"invalid smoothing_type {smoothing_type}")
        if smoothing_type == "gaussian" and label_smooth_weight > 0:
            raise ValueError("label_smooth_weight only applies to 'standard' smoothing")
        if not 0.0 <= label_smooth_weight <= 1.0:
            raise ValueError("label_smooth_weight should be in [0, 1]")
        if use_dark or decode_visibility:
            raise NotImplementedError("SimCCLabel: use_dark and decode_visibility are not ported yet")
        self.input_size = input_size
        self.smoothing_type = smoothing_type
        self.simcc_split_ratio = simcc_split_ratio
        self.label_smooth_weight = label_smooth_weight
        self.normalize = normalize
        self.sigma = np.array([sigma, sigma]) if isinstance(sigma, (float, int)) else np.array(sigma)

    def split_sizes(self) -> Tuple[int, int]:
        w, h = self.input_size
        return int(np.around(w * self.simcc_split_ratio)), int(np.around(h * self.simcc_split_ratio))

    def bins(self, keypoints: np.ndarray) -> np.ndarray:
        """Input-space keypoints (N, K, 2) -> their bins, int64."""
        return np.around(keypoints * self.simcc_split_ratio).astype(np.int64)

    def in_bounds(self, kpts: np.ndarray) -> np.ndarray:
        """(N, K) bool of the bins ``kpts``: the 3-sigma window touches the
        vectors (``gaussian``), or the bin lies inside them (``standard``)."""
        W, H = self.split_sizes()
        if self.smoothing_type == "standard":
            return (kpts[..., 0] >= 0) & (kpts[..., 0] < W) & (kpts[..., 1] >= 0) & (kpts[..., 1] < H)
        radius = self.sigma * 3
        left_top, right_bottom = kpts - radius, kpts + radius + 1
        return ~((left_top[..., 0] >= W) | (left_top[..., 1] >= H) | (right_bottom[..., 0] < 0)
                 | (right_bottom[..., 1] < 0))

    def keypoint_weights(self, keypoints: np.ndarray, keypoints_visible: np.ndarray) -> np.ndarray:
        """``keypoints_visible`` with 0 for a visible keypoint out of bounds."""
        keypoint_weights = keypoints_visible.copy()
        keypoint_weights[(keypoints_visible >= 0.5) & ~self.in_bounds(self.bins(keypoints))] = 0
        return keypoint_weights

    def encode(self, keypoints: np.ndarray, keypoints_visible: Optional[np.ndarray] = None) -> dict:
        if keypoints_visible is None:
            keypoints_visible = np.ones(keypoints.shape[:2], dtype=np.float32)
        N, K, _ = keypoints.shape
        W, H = self.split_sizes()
        kpts = self.bins(keypoints)
        keypoint_weights = self.keypoint_weights(keypoints, keypoints_visible)
        active = (keypoints_visible >= 0.5) & self.in_bounds(kpts)
        if self.smoothing_type == "gaussian":
            xs = np.arange(W, dtype=np.float32)
            ys = np.arange(H, dtype=np.float32)
            gx = np.exp(-((xs[None, None] - kpts[..., 0][..., None]) ** 2) / (2 * self.sigma[0] ** 2))
            gy = np.exp(-((ys[None, None] - kpts[..., 1][..., None]) ** 2) / (2 * self.sigma[1] ** 2))
            target_x = np.where(active[..., None], gx, 0.0).astype(np.float32)
            target_y = np.where(active[..., None], gy, 0.0).astype(np.float32)
            if self.normalize:
                norm_value = self.sigma * np.sqrt(np.pi * 2)
                target_x /= np.float32(norm_value[0])
                target_y /= np.float32(norm_value[1])
        else:
            target_x = np.zeros((N, K, W), dtype=np.float32)
            target_y = np.zeros((N, K, H), dtype=np.float32)
            n_idx, k_idx = np.nonzero(active)
            if self.label_smooth_weight > 0:
                target_x[n_idx, k_idx] = self.label_smooth_weight / (W - 1)
                target_y[n_idx, k_idx] = self.label_smooth_weight / (H - 1)
            target_x[n_idx, k_idx, kpts[n_idx, k_idx, 0]] = 1.0 - self.label_smooth_weight
            target_y[n_idx, k_idx, kpts[n_idx, k_idx, 1]] = 1.0 - self.label_smooth_weight
        return dict(keypoint_x_labels=target_x, keypoint_y_labels=target_y, keypoint_weights=keypoint_weights)

    def decode(self, simcc_x: np.ndarray, simcc_y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N, K, Wx), (N, K, Wy) -> keypoints (N, K, 2) in input space, scores (N, K)."""
        from probpose_code_torch.ops.decode import simcc_maximum_batch

        locs, vals = simcc_maximum_batch(torch.from_numpy(np.asarray(simcc_x, np.float32)),
                                         torch.from_numpy(np.asarray(simcc_y, np.float32)))
        return locs.numpy() / self.simcc_split_ratio, vals.numpy()
