"""Bounding-box geometry for the top-down crop (NumPy, host side).

The port's own copy of the parts of ``probpose_code_tpu/structures/bbox.py``
that the predict path needs: ``bbox_xywh2xyxy``, ``bbox_xyxy2cs`` and the
UDP warp matrix (``get_udp_warp_matrix``, ``:123``; reference
``bbox/transforms.py:315-360``), vectorised over boxes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bbox_xywh2xyxy(bbox_xywh: np.ndarray) -> np.ndarray:
    out = bbox_xywh.copy()
    out[..., 2] = out[..., 2] + out[..., 0]
    out[..., 3] = out[..., 3] + out[..., 1]
    return out


def bbox_xyxy2cs(bbox: np.ndarray, padding: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """xyxy -> (center, scale). ``scale`` is (w, h) * padding."""
    dim = bbox.ndim
    if dim == 1:
        bbox = bbox[None, :]
    scale = (bbox[..., 2:4] - bbox[..., :2]) * padding
    center = (bbox[..., 2:4] + bbox[..., :2]) * 0.5
    if dim == 1:
        center, scale = center[0], scale[0]
    return center, scale


def fix_aspect_ratio(scale: np.ndarray, aspect_ratio: float) -> np.ndarray:
    """Grow (N, 2) box sizes to the model's w/h ratio (``TopdownAffine``)."""
    w, h = np.hsplit(scale, [1])
    return np.where(w > h * aspect_ratio, np.hstack([w, w / aspect_ratio]), np.hstack([h * aspect_ratio, h]))


def get_udp_warp_matrix(
    center: np.ndarray,
    scale: np.ndarray,
    rot: float,
    output_size: Tuple[int, int],
) -> np.ndarray:
    """UDP-unbiased affine matrix mapping the bbox area to the output grid:
    pixel-grid-aligned scaling ``(out-1)/scale`` with rotation about the
    bbox center."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    input_size = center * 2
    rot_rad = np.deg2rad(rot)
    warp_mat = np.zeros((2, 3), dtype=np.float32)
    scale_x = (output_size[0] - 1) / scale[0]
    scale_y = (output_size[1] - 1) / scale[1]
    cos_r, sin_r = np.cos(rot_rad), np.sin(rot_rad)
    warp_mat[0, 0] = cos_r * scale_x
    warp_mat[0, 1] = -sin_r * scale_x
    warp_mat[0, 2] = scale_x * (-0.5 * input_size[0] * cos_r + 0.5 * input_size[1] * sin_r + 0.5 * scale[0])
    warp_mat[1, 0] = sin_r * scale_y
    warp_mat[1, 1] = cos_r * scale_y
    warp_mat[1, 2] = scale_y * (-0.5 * input_size[0] * sin_r - 0.5 * input_size[1] * cos_r + 0.5 * scale[1])
    return warp_mat
