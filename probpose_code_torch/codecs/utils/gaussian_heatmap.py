"""MSRA gaussian heatmaps on the host (NumPy).

The port's own copy of ``probpose_code_tpu/codecs/utils/gaussian_heatmap.py``:
``generate_gaussian_heatmaps`` (``:35``) and
``generate_unbiased_gaussian_heatmaps`` (``:84``), and their weight gates
as functions of their own (``gaussian_weights``), which
``GenerateTarget`` runs in the loader's workers while the maps are rendered
on the device (``ops/encode.py``).

- The MSRA form centres the gaussian on the rounded keypoint
  ``trunc(kpt + 0.5)`` (float64) and cuts it to the integer window
  ``[mu - int(3 sigma), mu + int(3 sigma) + 1)``.
- The unbiased (DARK) form puts it at the sub-pixel keypoint, in f32, over
  the whole map; its window ``[kpt - 3 sigma, kpt + 3 sigma + 1)`` is float.
- A visible keypoint whose window misses the map gets weight 0; instances
  combine by their elementwise maximum.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def _as_sigma_array(sigma: Union[float, Tuple[float, ...], np.ndarray], N: int) -> np.ndarray:
    if isinstance(sigma, (int, float)):
        return np.full(N, float(sigma))
    return np.asarray(sigma, dtype=np.float64)


def _rounded_center(keypoints: np.ndarray) -> np.ndarray:
    # (kpt + 0.5).astype(int64): truncation toward zero
    return np.trunc(keypoints + 0.5).astype(np.int64)


def _windows(keypoints: np.ndarray, sigma: float, unbiased: bool):
    """(centre, left-top, right-bottom) of each keypoint's window, (K, 2) each."""
    radius = sigma * 3
    if unbiased:
        return keypoints, keypoints - radius, keypoints + radius + 1
    mu = _rounded_center(keypoints)
    return mu, mu - np.int64(radius), mu + np.int64(radius) + 1


def _in_bounds(left_top: np.ndarray, right_bottom: np.ndarray, W: int, H: int) -> np.ndarray:
    return ~((left_top[:, 0] >= W) | (left_top[:, 1] >= H) | (right_bottom[:, 0] < 0) | (right_bottom[:, 1] < 0))


def gaussian_weights(
    heatmap_size: Tuple[int, int], keypoints: np.ndarray, keypoints_visible: np.ndarray,
    sigma: Union[float, Tuple[float, ...], np.ndarray], unbiased: bool = False,
) -> np.ndarray:
    """The keypoint weights of either form: ``keypoints_visible``, with 0
    for a visible keypoint whose window misses the map."""
    keypoints = np.asarray(keypoints, dtype=np.float64)
    W, H = heatmap_size
    sigmas = _as_sigma_array(sigma, keypoints.shape[0])
    keypoint_weights = keypoints_visible.copy()
    for n in range(keypoints.shape[0]):
        _, left_top, right_bottom = _windows(keypoints[n], sigmas[n], unbiased)
        keypoint_weights[n, (keypoints_visible[n] >= 0.5) & ~_in_bounds(left_top, right_bottom, W, H)] = 0
    return keypoint_weights


def generate_gaussian_heatmaps(
    heatmap_size: Tuple[int, int],
    keypoints: np.ndarray,
    keypoints_visible: np.ndarray,
    sigma: Union[float, Tuple[float, ...], np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """MSRA-style gaussians centred at the rounded keypoint location."""
    keypoints = np.asarray(keypoints, dtype=np.float64)
    N, K, _ = keypoints.shape
    W, H = heatmap_size
    sigmas = _as_sigma_array(sigma, N)
    heatmaps = np.zeros((K, H, W), dtype=np.float32)
    ys = np.arange(H, dtype=np.float64)[:, None]
    xs = np.arange(W, dtype=np.float64)[None, :]
    for n in range(N):
        mu, left_top, right_bottom = _windows(keypoints[n], sigmas[n], unbiased=False)
        active = (keypoints_visible[n] >= 0.5) & _in_bounds(left_top, right_bottom, W, H)
        if not active.any():
            continue
        dx = xs[None] - mu[:, 0][:, None, None]
        dy = ys[None] - mu[:, 1][:, None, None]
        g = np.exp(-(dx * dx + dy * dy) / (2 * sigmas[n] ** 2))
        window = (
            (xs[None] >= left_top[:, 0][:, None, None])
            & (xs[None] < right_bottom[:, 0][:, None, None])
            & (ys[None] >= left_top[:, 1][:, None, None])
            & (ys[None] < right_bottom[:, 1][:, None, None])
        )
        g = np.where(window, g, 0.0).astype(np.float32)
        g[~active] = 0.0
        np.maximum(heatmaps, g, out=heatmaps)
    return heatmaps, gaussian_weights(heatmap_size, keypoints, keypoints_visible, sigma)


def generate_unbiased_gaussian_heatmaps(
    heatmap_size: Tuple[int, int],
    keypoints: np.ndarray,
    keypoints_visible: np.ndarray,
    sigma: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """DARK-style gaussians: full-map evaluation at the sub-pixel centre."""
    keypoints = np.asarray(keypoints, dtype=np.float64)
    N, K, _ = keypoints.shape
    W, H = heatmap_size
    heatmaps = np.zeros((K, H, W), dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    for n in range(N):
        mu, left_top, right_bottom = _windows(keypoints[n], sigma, unbiased=True)
        active = (keypoints_visible[n] >= 0.5) & _in_bounds(left_top, right_bottom, W, H)
        if not active.any():
            continue
        dx = xs[None] - mu[:, 0][:, None, None].astype(np.float32)
        dy = ys[None] - mu[:, 1][:, None, None].astype(np.float32)
        g = np.exp(-(dx * dx + dy * dy) / (2 * sigma**2)).astype(np.float32)
        g[~active] = 0.0
        np.maximum(heatmaps, g, out=heatmaps)
    return heatmaps, gaussian_weights(heatmap_size, keypoints, keypoints_visible, sigma, unbiased=True)
