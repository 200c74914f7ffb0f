"""The DoubleProbMap family's bbox coverage mask, rendered on the device.

The JAX route that the DoubleProbPose config takes (``LoadImage``, then the
cv2 branch of ``TopdownAffine``, ``probpose_code_tpu/datasets/transforms/
topdown.py:203-215``) fills the clipped, int-cast ``bbox_xyxy_wrt_input``
rectangle of the (flipped) image with 1 in a uint8 image and warps it with
``cv2.warpAffine(..., INTER_LINEAR)`` (constant border 0) by the crop's own
warp matrix. The port never warps on the host: its ``TopdownAffine`` ships
the rectangle as NumPy's slice fills it (``mask_rect``: x0, y0, x1, y1,
end-exclusive, inside the image) and that matrix, and ``render_bbox_mask``
renders the (B, 1, h, w) uint8 masks of a batch on its device.

The arithmetic is the one of the OpenCV that the JAX route runs (5.0, whose
INTER_LINEAR warp of 8-bit images computes in float32, not in the 1/32-pixel
fixed point of older releases, which differs from it on a few border pixels
of one box in five): the matrix is inverted in float64 and rounded to
float32; destination pixel (x, y) samples the source at ``sx = fma(m00, x,
m01 * y + m02)`` (``sy`` alike), the four taps about ``floor(sx),
floor(sy)`` (0 outside the image) are blended by ``a = sx - floor(sx)``
and ``b`` as ``lerp(lerp(p00, p01, a), lerp(p10, p11, a), b)`` in float32,
and the value is rounded half to even. The fused multiply-add is a float64
product and sum rounded to float32 once. ``render_bbox_mask_numpy`` is the
same in NumPy: ``tests/test_torch_double_probmap.py`` holds it bit for bit
against cv2, and the device version bit for bit against it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def mask_rect(bbox_xyxy: np.ndarray, image_shape: Tuple[int, int]) -> np.ndarray:
    """The pixels the JAX route sets to 1: the box clipped to the image,
    cast to int, then ``mask[y0:y1, x0:x1] = 1`` (a negative end counts from
    the far side, as NumPy's slicing does). Returns (x0, y0, x1, y1) int32,
    end-exclusive, within [0, W] x [0, H]; empty where x1 <= x0 or y1 <= y0."""
    img_h, img_w = image_shape
    box = np.asarray(bbox_xyxy, np.float64).flatten()[:4].copy()
    box[:2] = np.maximum(box[:2], 0)
    box[2:4] = np.minimum(box[2:4], [img_w, img_h])
    x0, y0, x1, y1 = box.astype(int)
    xs, ys = slice(x0, x1).indices(img_w), slice(y0, y1).indices(img_h)
    return np.array([xs[0], ys[0], max(xs[1], xs[0]), max(ys[1], ys[0])], np.int32)


def _inverse(m, xp):
    """(B, 2, 3) float64 source -> crop affines inverted as
    ``cv2.invertAffineTransform`` does (a singular one gives 0), in the
    array module ``xp`` (NumPy or torch: the same IEEE float64 operations in
    the same order, so the same bits)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b * d
    det = xp.where(det != 0, 1.0 / xp.where(det != 0, det, xp.ones_like(det)), xp.zeros_like(det))
    a11, a22, a12, a21 = e * det, a * det, -b * det, -d * det
    return xp.stack([xp.stack([a11, a12, -a11 * c - a12 * f], -1), xp.stack([a21, a22, -a21 * c - a22 * f], -1)], 1)


def render_bbox_mask_numpy(rects: np.ndarray, mats: np.ndarray, out_size: Tuple[int, int]) -> np.ndarray:
    """(B, 4) ``mask_rect`` rectangles and (B, 2, 3) source -> crop matrices
    -> (B, 1, h, w) uint8 masks; ``out_size`` is (w, h)."""
    w, h = out_size
    f32, f64 = np.float32, np.float64
    inv = _inverse(np.asarray(mats, np.float64), np).astype(np.float32)
    rects = np.asarray(rects, np.int64)
    xs = np.arange(w, dtype=f32)[None, None, :]
    ys = np.arange(h, dtype=f32)[None, :, None]

    def coord(row):
        m = inv[:, row, :, None, None]
        rest = m[:, 1] * ys + m[:, 2]  # (B, h, 1) float32
        return (m[:, 0].astype(f64) * xs.astype(f64) + rest.astype(f64)).astype(f32)

    sx, sy = coord(0), coord(1)
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = sx - fx, sy - fy
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    x0, y0, x1, y1 = (rects[:, i, None, None] for i in range(4))

    def tap(dy, dx):
        return (((ix + dx) >= x0) & ((ix + dx) < x1) & ((iy + dy) >= y0) & ((iy + dy) < y1)).astype(f32)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = p00 + a * (p01 - p00)
    v1 = p10 + a * (p11 - p10)
    v = v0 + b * (v1 - v0)
    return np.rint(v).astype(np.uint8)[:, None]


def render_bbox_mask(rects: torch.Tensor, mats: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """``render_bbox_mask_numpy`` on ``rects``' device, in the same float32
    operations: (B, 4) int rectangles, (B, 2, 3) matrices -> (B, 1, h, w)
    uint8 masks."""
    w, h = out_size
    dev = rects.device
    f32, f64 = torch.float32, torch.float64
    inv = _inverse(mats.to(device=dev, dtype=f64), torch).to(f32)
    rects = rects.to(torch.int64)
    xs = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=f32, device=dev)[None, :, None]

    def coord(row):
        m = inv[:, row, :, None, None]
        rest = m[:, 1] * ys + m[:, 2]
        return (m[:, 0].to(f64) * xs.to(f64) + rest.to(f64)).to(f32)

    sx, sy = coord(0), coord(1)
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    ix, iy = fx.to(torch.int64), fy.to(torch.int64)
    x0, y0, x1, y1 = (rects[:, i, None, None] for i in range(4))

    def tap(dy, dx):
        return (((ix + dx) >= x0) & ((ix + dx) < x1) & ((iy + dy) >= y0) & ((iy + dy) < y1)).to(f32)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = p00 + a * (p01 - p00)
    v1 = p10 + a * (p11 - p10)
    v = v0 + b * (v1 - v0)
    return torch.round(v).to(torch.uint8)[:, None]
