"""Keypoint geometry of the ProbPose activation window (NumPy, host side).

The port's own copy of ``flip_keypoints`` (``:20``; reference
``keypoint/transforms.py:7``), for ``RandomFlip``, and of
``fix_bbox_aspect_ratio`` (``:90``) and ``find_min_padding_exact``
(``:140``) from ``probpose_code_tpu/structures/keypoint.py`` (reference
``keypoints_min_padding.py:4,68``): the extended-bbox machinery of the
dataset parser and the Ex-OKS evaluator.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def flip_keypoints(keypoints: np.ndarray, keypoints_visible: Optional[np.ndarray], image_size: Tuple[int, int],
                   flip_indices: List[int], direction: str = "horizontal") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Mirror keypoints (and their visibility) in an image of ``image_size``
    (w, h), swapping left and right through ``flip_indices``."""
    ndim = keypoints.ndim
    assert direction in {"horizontal", "vertical", "diagonal"}
    if direction in ("horizontal", "vertical"):
        keypoints = keypoints.take(flip_indices, axis=ndim - 2)
        if keypoints_visible is not None:
            keypoints_visible = keypoints_visible.take(flip_indices, axis=ndim - 2)
    else:
        keypoints = keypoints.copy()
    w, h = image_size
    if direction == "horizontal":
        keypoints[..., 0] = w - 1 - keypoints[..., 0]
    elif direction == "vertical":
        keypoints[..., 1] = h - 1 - keypoints[..., 1]
    else:
        keypoints = np.asarray([w, h]) - keypoints - 1
    return keypoints, keypoints_visible


def fix_bbox_aspect_ratio(
    bbox: np.ndarray, aspect_ratio: float = 3 / 4, padding: float = 1.25, bbox_format: str = "xywh"
) -> np.ndarray:
    """Expand boxes to the target aspect ratio about their center, then pad.

    Vectorized over boxes, with the reference's quirk: a zero width/height
    counts as 1 in the ratio test while the zero extent is kept for the axis
    that is not adjusted.
    """
    assert bbox_format.lower() in ("xywh", "xyxy")
    in_shape = bbox.shape
    bbox = np.asarray(bbox, dtype=np.float64).reshape(-1, 4)

    if bbox_format.lower() == "xywh":
        xyxy = np.stack([bbox[:, 0], bbox[:, 1], bbox[:, 0] + bbox[:, 2], bbox[:, 1] + bbox[:, 3]], axis=1)
    else:
        xyxy = bbox.copy()

    centers = xyxy[:, :2] + (xyxy[:, 2:] - xyxy[:, :2]) / 2
    widths = xyxy[:, 2] - xyxy[:, 0]
    heights = xyxy[:, 3] - xyxy[:, 1]
    widths = np.where(widths == 0, 1.0, widths)
    heights = np.where(heights == 0, 1.0, heights)

    wide = widths / heights > aspect_ratio
    new_widths = np.where(wide, widths, heights * aspect_ratio).astype(np.float32) * padding
    new_heights = np.where(wide, widths / aspect_ratio, heights).astype(np.float32) * padding

    x0, y0 = centers[:, 0] - new_widths / 2, centers[:, 1] - new_heights / 2
    x1, y1 = centers[:, 0] + new_widths / 2, centers[:, 1] + new_heights / 2
    if bbox_format.lower() == "xywh":
        out = np.stack([x0, y0, x1 - x0, y1 - y0], axis=1)
    else:
        out = np.stack([x0, y0, x1, y1], axis=1)
    return out.reshape(in_shape)


def find_min_padding_exact(
    bbox: np.ndarray, kpts: np.ndarray, aspect_ratio: float = 3 / 4, bbox_format: str = "xywh"
) -> np.ndarray:
    """Per-keypoint padding factor the (aspect-fixed) bbox needs to contain
    the keypoint; -1 for keypoints that are not annotated. ``kpts`` is (K,
    2) or (K, 3) rows, or flat: a flat vector of an even length is read as
    (x, y) pairs. The JAX function (``structures/keypoint.py:140``) reads
    rows by their count too, so it takes the (x, y, v) rows of an even
    number of keypoints (CrowdPose's 14, MPII's 16) for pairs; the port
    reads rows as rows."""
    assert bbox_format.lower() in ("xywh", "xyxy")
    kpts = np.asarray(kpts, dtype=np.float64)
    if kpts.ndim == 2 and kpts.shape[1] == 3:
        vis = kpts[:, 2].copy()
        kpts = kpts[:, :2]
    elif kpts.size % 2 == 0:
        kpts = kpts.reshape(-1, 2)
        vis = np.ones(kpts.shape[0])
    elif kpts.size % 3 == 0:
        kpts = kpts.reshape(-1, 3)
        vis = kpts[:, 2].flatten()
        kpts = kpts[:, :2]
    else:
        raise ValueError("Keypoints should have 2 or 3 values each")

    bbox = np.asarray(bbox, dtype=np.float64)
    if bbox_format.lower() == "xyxy":
        bbox = np.array([bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]])
    if aspect_ratio is not None:
        bbox = fix_bbox_aspect_ratio(bbox, aspect_ratio=aspect_ratio, padding=1.0, bbox_format="xywh")

    x0, y0, w, h = np.asarray(bbox).reshape(-1)[:4]
    x1, y1 = x0 + w, y0 + h
    x_d = np.maximum(np.clip(x0 - kpts[:, 0], 0, None), np.clip(kpts[:, 0] - x1, 0, None))
    y_d = np.maximum(np.clip(y0 - kpts[:, 1], 0, None), np.clip(kpts[:, 1] - y1, 0, None))

    padding = np.asarray(1 + np.maximum(2 * x_d / w, 2 * y_d / h), dtype=np.float64).flatten()
    padding[vis <= 0] = -1.0
    return padding
