"""Bounding-box geometry for the top-down crop (NumPy, host side).

The port's own copy of the parts of ``probpose_code_tpu/structures/bbox.py``
that the predict, evaluation and training paths need: ``bbox_xywh2xyxy``,
``bbox_xyxy2xywh``, ``bbox_xyxy2cs``, ``bbox_cs2xyxy`` (``:58``),
``flip_bbox`` (``:94``), the UDP
warp matrix (``get_udp_warp_matrix``, ``:123``; reference
``bbox/transforms.py:315-360``) and the standard one (``get_warp_matrix``,
``:198``; reference ``bbox/transforms.py:362``), for ``TopdownAffine`` with
and without ``use_udp``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def bbox_xywh2xyxy(bbox_xywh: np.ndarray) -> np.ndarray:
    out = bbox_xywh.copy()
    out[..., 2] = out[..., 2] + out[..., 0]
    out[..., 3] = out[..., 3] + out[..., 1]
    return out


def bbox_xyxy2xywh(bbox_xyxy: np.ndarray) -> np.ndarray:
    out = bbox_xyxy.copy()
    out[..., 2] = out[..., 2] - out[..., 0]
    out[..., 3] = out[..., 3] - out[..., 1]
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


def bbox_cs2xyxy(center: np.ndarray, scale: np.ndarray, padding: float = 1.0) -> np.ndarray:
    dim = center.ndim
    if dim == 1:
        center, scale = center[None, :], scale[None, :]
    wh = scale / padding
    xy = center - 0.5 * wh
    bbox = np.concatenate((xy, xy + wh), axis=-1)
    if dim == 1:
        bbox = bbox[0]
    return bbox


def flip_bbox(bbox: np.ndarray, image_size: Tuple[int, int], bbox_format: str = "xywh",
              direction: str = "horizontal") -> np.ndarray:
    """Mirror boxes (xywh, xyxy or centers) in an image of ``image_size`` (w, h)."""
    assert direction in {"horizontal", "vertical", "diagonal"}
    assert bbox_format in {"xywh", "xyxy", "center"}
    out = bbox.copy()
    w, h = image_size
    if direction == "horizontal":
        if bbox_format in ("xywh", "center"):
            out[..., 0] = w - bbox[..., 0] - 1
        else:
            out[..., ::2] = w - bbox[..., -2::-2] - 1
    elif direction == "vertical":
        if bbox_format in ("xywh", "center"):
            out[..., 1] = h - bbox[..., 1] - 1
        else:
            out[..., 1::2] = h - bbox[..., ::-2] - 1
    else:  # diagonal
        if bbox_format in ("xywh", "center"):
            out[..., :2] = np.asarray([w, h]) - bbox[..., :2] - 1
        else:
            out = np.asarray([w, h, w, h]) - bbox - 1
            out = np.concatenate((out[..., 2:], out[..., :2]), axis=-1)
    return out


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
    # math's cos and sin in float64, also for a float32 angle, as the JAX package takes them
    cos_r, sin_r = math.cos(rot_rad), math.sin(rot_rad)
    warp_mat[0, 0] = cos_r * scale_x
    warp_mat[0, 1] = -sin_r * scale_x
    warp_mat[0, 2] = scale_x * (-0.5 * input_size[0] * cos_r + 0.5 * input_size[1] * sin_r + 0.5 * scale[0])
    warp_mat[1, 0] = sin_r * scale_y
    warp_mat[1, 1] = cos_r * scale_y
    warp_mat[1, 2] = scale_y * (-0.5 * input_size[0] * sin_r - 0.5 * input_size[1] * cos_r + 0.5 * scale[1])
    return warp_mat


def _rotate_point(pt: np.ndarray, angle_rad: float) -> np.ndarray:
    sn, cs = np.sin(angle_rad), np.cos(angle_rad)
    rot_mat = np.array([[cs, -sn], [sn, cs]])
    return rot_mat @ pt


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direction = a - b
    return b + np.r_[-direction[1], direction[0]]


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The affine map of three points onto three (cv2.getAffineTransform's
    system, solved exactly in float64)."""
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros(6, dtype=np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1.0
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    return np.linalg.solve(a, b).reshape(2, 3)


def get_warp_matrix(
    center: np.ndarray,
    scale: np.ndarray,
    rot: float,
    output_size: Tuple[int, int],
) -> np.ndarray:
    """Standard (non-UDP) affine matrix mapping the bbox area to the output
    size, float32: the bbox center, the middle of its left edge (rotated by
    ``rot`` degrees about the center) and a third point at a right angle go
    to the output's center, left-edge middle and third point."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    dst_w, dst_h = output_size[:2]
    src_dir = _rotate_point(np.array([scale[0] * -0.5, 0.0]), np.deg2rad(rot))
    src = np.zeros((3, 2), dtype=np.float64)
    src[0] = center
    src[1] = center + src_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst = np.zeros((3, 2), dtype=np.float64)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + np.array([dst_w * -0.5, 0.0])
    dst[2] = _get_3rd_point(dst[0], dst[1])
    return _solve_affine(src, dst).astype(np.float32)
