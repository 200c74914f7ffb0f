"""TopdownAffine: the bbox region as a canvas and the warp onto the model input.

The port's own ``TopdownAffine`` (``probpose_code_tpu/datasets/transforms/
topdown.py:28``, reference ``topdown_transforms.py:14``, the ProbPose fork
that re-derives center and scale from the padded ``bbox_xyxy_wrt_input``
and records ``input_center`` / ``input_scale`` / ``input_size``).

Why the port has no host warp: the JAX package warps each crop on the host
with ``cv2.warpAffine`` unless ``device_warp`` is set, and the card's machine
has no OpenCV. The port therefore always takes the JAX package's own
deferred-warp form (``_make_canvas``, ``:66-113``): the warp's source region
of interest is pasted into a fixed uint8 ``canvas`` and the composed
``warp_mat`` (canvas -> crop) goes with it, and
``PoseModel.device_preprocess_batch`` warps the batch on the device
(``ops/warp.py``), where the val path rounds the crops to uint8 values as
``cv2.warpAffine`` does. A region larger than the canvas is first downscaled
as ``cv2.resize(INTER_LINEAR)`` does it (``resize_linear``), with the scale
folded into the matrix; a rotated crop (``bbox_rotation`` from
``RandomBBoxTransform``) widens the region, and takes that path sooner. The
keypoints are warped into the crop (``transformed_keypoints``, ``:209-216``)
for ``GenerateTarget``.

The bbox coverage mask (``with_bbox_mask``, ``:203-215``, on as in the JAX
transform): the JAX route warps a 0/1 image of the clipped box with
``cv2.warpAffine``; here the sample carries the pixels that image sets
(``bbox_mask_rect``, ``ops/bbox_mask.py:mask_rect``) and the matrix cv2
warps it by (``bbox_mask_mat``: the flipped image -> crop, before any flip
is folded in or any canvas composed), and the device renders the mask
(``ops/bbox_mask.py``) for a head that reads it: only a DoubleProbMap
training batch carries them (``datasets/loader.py``).

A JPEG sample (``img_bytes`` from ``LoadImage``) takes no canvas: its
``warp_mat`` maps the image (as ``cv2.imread`` returns it) to the crop, with
a recorded flip folded in (``x -> W - 1 - x`` horizontally, ``y -> H - 1 -
y`` vertically, both for the diagonal flip), and the bytes go on to the
model's device, which decodes and warps the batch: the JAX ``lazy`` design
(``topdown.py:124-185``) moved to the card. Its reference is the JAX
pipeline's ``cv2.imread`` and ``cv2.warpAffine`` of the flipped image with
a zero border.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from probpose_code_torch.ops.bbox_mask import mask_rect
from probpose_code_torch.registry import TRANSFORMS
from probpose_code_torch.structures.bbox import (
    bbox_xyxy2cs,
    fix_aspect_ratio,
    get_udp_warp_matrix,
    get_warp_matrix,
)


def invert_affine_transform(mat: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64 (a singular matrix gives 0)."""
    (a, b, c), (d, e, f) = np.asarray(mat, np.float64)
    det = a * e - b * d
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = e * det, a * det, -b * det, -d * det
    return np.array([[a11, a12, -a11 * c - a12 * f], [a21, a22, -a21 * c - a22 * f]], np.float64)


def _linear_taps(dst: int, src: int):
    """cv2.resize's INTER_LINEAR source taps along one axis: pixel centres
    aligned (``(d + 0.5) * src / dst - 0.5``), clamped at both ends."""
    pos = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    frac[lo < 0] = 0
    lo[lo < 0] = 0
    top = lo >= src - 1
    frac[top] = 0
    lo[top] = src - 1
    return lo, np.minimum(lo + 1, src - 1), frac


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` of an
    (H, W, C) uint8 image to ``size`` (w, h), in float32 and rounded."""
    w, h = size
    y0, y1, fy = _linear_taps(h, img.shape[0])
    x0, x1, fx = _linear_taps(w, img.shape[1])
    src = img.astype(np.float32)
    rows = src[y0] * (1 - fy)[:, None, None] + src[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# the JAX transform's default ``canvas_size`` (w, h), which no config changes
CANVAS_SIZE = (640, 640)


@TRANSFORMS.register_module()
class TopdownAffine:
    """The canvas form, or the JPEG form, with the bbox mask's rectangle and
    matrix (see the module). The JAX transform's ``device_warp`` and
    ``canvas_size`` are set by no config and are not ported; ``fast_decode``
    (its DCT-domain downscale of lazy JPEGs) raises ``NotImplementedError``
    when set."""

    def __init__(self, input_size: Tuple[int, int], input_padding: float = 1.25, use_udp: bool = False,
                 fast_decode: bool = False, with_bbox_mask: bool = True):
        assert len(input_size) == 2
        if fast_decode:
            raise NotImplementedError("TopdownAffine: fast_decode (the DCT-domain downscale of JPEGs) is not "
                                      "ported yet (ROADMAP.md section 1, item 3)")
        self.input_size = input_size
        self.use_udp = use_udp
        self.input_padding = input_padding
        self.with_bbox_mask = with_bbox_mask

    @staticmethod
    def _make_canvas(img: np.ndarray, warp_mat: np.ndarray, dst_size: Tuple[int, int]):
        """Extract the warp's source ROI into the fixed canvas and compose
        the canvas -> crop affine. Returns (canvas uint8 (Hc, Wc, 3),
        mat (2, 3) float32)."""
        cw, ch = CANVAS_SIZE
        img_h, img_w = img.shape[:2]
        w, h = dst_size

        inv = invert_affine_transform(warp_mat)
        corners = np.array([[-0.5, -0.5], [w - 0.5, -0.5], [w - 0.5, h - 0.5], [-0.5, h - 0.5]], np.float64)
        src = corners @ inv[:, :2].T + inv[:, 2]
        x0 = int(np.clip(np.floor(src[:, 0].min()) - 1, 0, img_w))
        y0 = int(np.clip(np.floor(src[:, 1].min()) - 1, 0, img_h))
        x1 = int(np.clip(np.ceil(src[:, 0].max()) + 2, 0, img_w))
        y1 = int(np.clip(np.ceil(src[:, 1].max()) + 2, 0, img_h))

        roi = img[y0:y1, x0:x1]
        rh, rw = roi.shape[:2]
        canvas = np.zeros((ch, cw, 3), np.uint8)
        f_x = f_y = 1.0
        if rh > 0 and rw > 0:
            if rh > ch or rw > cw:
                f = min(ch / rh, cw / rw)
                roi = resize_linear(roi, (max(1, int(rw * f)), max(1, int(rh * f))))
                # the integer resize target defines the true scale
                f_x = roi.shape[1] / rw
                f_y = roi.shape[0] / rh
            canvas[: roi.shape[0], : roi.shape[1]] = roi

        # src <- canvas with cv2.resize pixel-center alignment:
        # x_src = (x_c + 0.5) / f_x - 0.5 + x0 ; compose with warp (src -> dst)
        A = np.array([[1.0 / f_x, 0.0, x0 + 0.5 / f_x - 0.5], [0.0, 1.0 / f_y, y0 + 0.5 / f_y - 0.5]], np.float64)
        R = warp_mat[:, :2].astype(np.float64) @ A[:, :2]
        t = warp_mat[:, :2].astype(np.float64) @ A[:, 2] + warp_mat[:, 2]
        mat = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
        return canvas, mat

    @staticmethod
    def _image_warp(warp_mat: np.ndarray, shape: Tuple[int, int], results: Dict) -> np.ndarray:
        """The image -> crop affine of a JPEG sample: ``warp_mat`` (flipped
        image -> crop) after the recorded flip of the (H, W) image."""
        if not results.get("flip"):
            return warp_mat
        H, W = shape
        direction = results.get("flip_direction") or "horizontal"
        sx = -1.0 if direction in ("horizontal", "diagonal") else 1.0
        sy = -1.0 if direction in ("vertical", "diagonal") else 1.0
        flip = np.array([[sx, 0.0, (W - 1) * (sx < 0)], [0.0, sy, (H - 1) * (sy < 0)], [0.0, 0.0, 1.0]])
        return (warp_mat.astype(np.float64) @ flip).astype(np.float32)

    def __call__(self, results: Dict) -> Optional[dict]:
        w, h = self.input_size
        if isinstance(results["img"], list):
            raise NotImplementedError("TopdownAffine: multi-frame samples are not ported yet")

        # re-derive center/scale from the (possibly cropped) activation bbox
        _c, _s = bbox_xyxy2cs(np.asarray(results["bbox_xyxy_wrt_input"]), padding=self.input_padding)
        results["bbox_center"] = np.asarray(_c).reshape(1, 2)
        results["bbox_scale"] = fix_aspect_ratio(np.asarray(_s).reshape(1, 2), aspect_ratio=w / h)

        assert results["bbox_center"].shape[0] == 1, "top-down affine supports single instance only"
        center = results["bbox_center"][0]
        scale = results["bbox_scale"][0]
        rot = results["bbox_rotation"][0] if "bbox_rotation" in results else 0.0

        warp_matrix = get_udp_warp_matrix if self.use_udp else get_warp_matrix
        warp_mat = warp_matrix(center, scale, rot, output_size=(w, h)).astype(np.float32)

        img = results.pop("img")
        if self.with_bbox_mask:
            results["bbox_mask_rect"] = mask_rect(results["bbox_xyxy_wrt_input"], img.shape[:2])
            results["bbox_mask_mat"] = warp_mat
        if "img_bytes" in results:
            results["warp_mat"] = self._image_warp(warp_mat, img.shape[:2], results)
        else:
            results["canvas"], results["warp_mat"] = self._make_canvas(img, warp_mat, (w, h))

        if results.get("keypoints", None) is not None:
            transformed = results.get("transformed_keypoints")
            transformed = (results["keypoints"] if transformed is None else transformed).copy()
            transformed[..., :2] = transformed[..., :2] @ warp_mat[:, :2].T + warp_mat[:, 2]
            results["transformed_keypoints"] = transformed

        if results.get("bbox_xyxy_wrt_input", None) is not None:
            corners = np.asarray(results["bbox_xyxy_wrt_input"], dtype=np.float64).reshape(2, 2)
            corners = corners @ warp_mat[:, :2].T.astype(np.float64) + warp_mat[:, 2]
            results["bbox_xyxy_wrt_input"] = corners.reshape(1, 4)

        results["input_size"] = (w, h)
        results["input_center"] = center
        results["input_scale"] = scale
        return results
