"""The photometric augmentations of the RTMPose recipes' train pipelines:
the plain PyTorch versions.

The JAX pipeline applies ``YOLOXHSVRandomAug`` (``probpose_code_tpu/
datasets/transforms/common.py:490-510``), ``PhotometricDistortion``
(``:368-406``, the body8 and halpe26 recipes) and ``Albumentation``'s
native Blur, MedianBlur and CoarseDropout (``:792-871``) to each uint8 crop
on the host with OpenCV and NumPy. The port's crop exists only on the device
(``PoseModel.device_preprocess_batch``), so the transforms split in two:
the worker draws the parameters (``datasets/transforms/common.py``) and
these functions apply them to the rounded crops of a batch, (B, H, W, 3)
BGR float tensors of integer values 0..255, in the JAX order. Every result
is again integer-valued and equals OpenCV 5.0's bit for bit:

- ``bgr_to_hsv``: ``cv2.COLOR_BGR2HSV`` on 8 bits is fixed point: the
  saturation and hue divide through tables of ``round((255 << 12) / v)``
  and ``round((180 << 12) / (6 * diff))`` with a 12-bit shift. Integer
  arithmetic here, exact on every device.
- ``hsv_to_bgr``: ``cv2.COLOR_HSV2BGR`` on 8 bits goes through float32.
  OpenCV's vector path contracts ``1 - s * h`` into a fused multiply-add
  and truncates the final ``x * 255``. It takes a row in blocks of 32
  pixels and the rest in a scalar tail that rounds otherwise, so
  ``yolox_hsv`` and ``photometric_distortion`` take crops whose width is a
  multiple of 32 (the recipes' 192 and 288 are) and refuse any other. The
  fused multiply-add is a float64 product and sum rounded to float32 once
  (``ops/bbox_mask.py`` does the same); every other step is one float32
  operation, which rounds alike on the CPU and the card. A hue of 180
  (``PhotometricDistortion``'s hue step gives it) falls in the vector
  path's sector 6, which it wraps to sector 0 with the fraction ``180 *
  (6 / 180) - 6`` in float32, not 0: not hue 0's bytes.
- ``photometric_distortion``: ``PhotometricDistortion``'s steps in float32
  as NumPy computes them: the brightness and the first contrast on the
  unclipped values, each ``clip(0, 255).astype(uint8)`` a truncation, the
  hue step NumPy's float32 remainder (an exact ``fmod``, plus 180 where it
  is negative), which gives 180 for sums just below 0.
- ``box_blur``: ``cv2.blur`` with BORDER_REFLECT_101 rounds the window's
  sum over k² to the nearest integer (k² is odd: no ties); OpenCV 5.0 no
  longer uses the older ``divScale`` / ``divDelta`` fixed point, which is
  off by one on some sums for k = 5 and 7.
- ``median_blur``: ``cv2.medianBlur`` with BORDER_REPLICATE, the exact
  median of k² values.
- ``coarse_dropout``: each hole's rectangle, clipped to the crop as NumPy's
  slice clips it, set to 0.

``tests/test_torch_rtmpose_train.py`` holds each one against cv2 on the
CPU: the colour conversions on all 2^24 BGR colours and all 181 x 256 x 256
HSV triples, the blur on every window sum for each k
(``tests/test_torch_body8.py`` holds ``photometric_distortion`` against
the JAX transform). ``ops/kernels/photometric.py`` applies them to a batch
(``augment``): these functions for a CPU batch; for a batch on the card,
the HSV jitter through the two tables that these conversions fill
(``hsv_tables``, ``yolox_hsv_lookup``), the distortion and the median as
the CUDA kernels of ``csrc/photometric.cu`` (the distortion through the
same tables) and the blur and the dropout as these.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
INV255 = float(_F32(1) / _F32(255))  # OpenCV's float constants, each one float32 division
HSCALE = float(_F32(6) / _F32(180))
# cv2's ``saturate_cast<int>`` of a double quotient, round half to even as Python's ``round``
SDIV = [0] + [round((255 << 12) / i) for i in range(1, 256)]
HDIV = [0] + [round((180 << 12) / (6.0 * i)) for i in range(1, 256)]
# the parameters a batch carries (``augment``'s arguments in ``ops/kernels/photometric.py``), from
# the worker halves
AUGMENT_KEYS = ("hsv_gains", "photometric", "blur_ksize", "median_ksize", "dropout_rects")
HSV_ROW_BLOCK = 32  # the pixels of a row cv2's vector HSV -> BGR takes at a time
# which of the four tabulated values gives b, g and r in each sixth of the hue circle
_SECTORS = [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]]


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR integer values 0..255 -> (..., 3) int32 HSV (hue
    0..179), as ``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8."""
    b, g, r = img.to(torch.int32).unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    sdiv = torch.tensor(SDIV, dtype=torch.int32, device=img.device)
    hdiv = torch.tensor(HDIV, dtype=torch.int32, device=img.device)
    s = (diff * sdiv[v] + 2048) >> 12
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + 2048) >> 12
    return torch.stack([torch.where(h < 0, h + 180, h), s, v], -1)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV integer values (hue 0..179) -> (..., 3) float32 BGR
    integer values, as ``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` on uint8."""
    h, s, v = hsv.to(torch.float32).unbind(-1)
    s, v = s * INV255, v * INV255
    hue = h * HSCALE
    sector = torch.trunc(hue)  # 0..5 for a hue below 180, 6 for 180
    frac = hue - sector

    def one_minus_s_times(x):  # fma(-s, x, 1) in float32
        return (1 - s.double() * x.double()).float()

    tab = torch.stack([v, v * (1 - s), v * one_minus_s_times(frac), v * one_minus_s_times(1 - frac)], -1)
    pick = torch.tensor(_SECTORS, device=hsv.device)[sector.long() % 6]
    return torch.trunc(torch.gather(tab, -1, pick) * 255.0)


def check_width(img: torch.Tensor, name: str) -> None:
    width = img.shape[2]
    if width % HSV_ROW_BLOCK:
        raise ValueError(f"{name}: a crop width of {width} is not a multiple of {HSV_ROW_BLOCK}; cv2 converts the "
                         f"last {width % HSV_ROW_BLOCK} pixels of each row in a scalar tail that rounds otherwise, "
                         "which the port does not reproduce")


def _jitter(hsv: torch.Tensor, gains: torch.Tensor):
    """(B, H, W, 3) int32 HSV with (B, 3) int gains: the hue ``+ gain %
    180``, saturation and value clipped to 0..255, as three (B, H, W)."""
    check_width(hsv, "yolox_hsv")
    g = gains.to(torch.int32)[:, None, None, :]
    return (torch.remainder(hsv[..., 0] + g[..., 0], 180), (hsv[..., 1] + g[..., 1]).clamp(0, 255),
            (hsv[..., 2] + g[..., 2]).clamp(0, 255))


def yolox_hsv(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """``YOLOXHSVRandomAug`` on (B, H, W, 3) crops with (B, 3) int gains."""
    return hsv_to_bgr(torch.stack(_jitter(bgr_to_hsv(img), gains), -1))


def _packed(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (h << 16) | (s << 8) | v


def hsv_tables(device) -> tuple:
    """Both conversions of every 8-bit input on ``device``, as uint8
    tables: (2^24, 3) HSV at the index ``r << 16 | g << 8 | b`` and (181 *
    2^16, 3) BGR at ``h << 16 | s << 8 | v``, hue 180 included (the order
    of ``chip_smoke.all_bgr_colours`` and of ``all_hsv_triples``, then hue
    180)."""
    i = torch.arange(1 << 24, dtype=torch.int32, device=device)
    to_hsv = bgr_to_hsv(torch.stack([i & 255, (i >> 8) & 255, i >> 16], -1)).to(torch.uint8)
    i = i[:181 << 16]
    return to_hsv, hsv_to_bgr(torch.stack([i >> 16, (i >> 8) & 255, i & 255], -1)).to(torch.uint8)


def yolox_hsv_lookup(img: torch.Tensor, gains: torch.Tensor, tables: tuple) -> torch.Tensor:
    """``yolox_hsv`` through ``hsv_tables``: two gathers and the gains in
    between, the same bytes in a few passes over the crops."""
    to_hsv, to_bgr = tables
    b, g, r = img.to(torch.int32).unbind(-1)
    h, s, v = _jitter(to_hsv[_packed(r, g, b)].to(torch.int32), gains)
    return to_bgr[_packed(h, s, v)].to(torch.float32)


def numpy_remainder(a: torch.Tensor, m: float) -> torch.Tensor:
    """NumPy's float remainder ``a % m`` for ``m > 0`` in ``a``'s dtype:
    the exact ``fmod``, plus ``m`` (one rounding) where it is negative."""
    r = torch.fmod(a, m)
    return torch.where(r < 0, r + m, r)


def _distort(img: torch.Tensor, params: torch.Tensor, to_hsv, to_bgr) -> torch.Tensor:
    """``photometric_distortion`` with the given colour conversions (the
    card kernel's route takes them from ``hsv_tables``)."""
    check_width(img, "photometric_distortion")
    p = params.to(device=img.device, dtype=torch.float32)
    brightness, contrast, saturation, hue, contrast_after = (p[:, i, None, None, None] for i in range(5))
    x = (img + brightness) * contrast
    h, s, v = to_hsv(torch.trunc(x.clamp(0, 255))).to(torch.float32).unbind(-1)
    h = torch.trunc(numpy_remainder(h + hue[..., 0], 180.0).clamp(0, 255))
    s = torch.trunc((s * saturation[..., 0]).clamp(0, 255))
    x = torch.trunc((to_bgr(torch.stack([h, s, v], -1)) * contrast_after).clamp(0, 255))
    return torch.gather(x, -1, p[:, None, None, 5:].long().expand(x.shape))


def photometric_distortion(img: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """``PhotometricDistortion`` on (B, H, W, 3) crops with (B, 8) float32
    rows (``datasets/transforms/common.py:PhotometricDistortion``): the
    brightness delta added and the first contrast factor multiplied in,
    clipped and truncated to uint8 values, to HSV, the saturation factor
    and the hue delta (NumPy's float32 remainder by 180), clipped and
    truncated, back to BGR, the second contrast factor, clipped and
    truncated, the channels reordered. Each step is one float32 operation,
    as NumPy takes a float32 image and a float scalar."""
    return _distort(img, params, bgr_to_hsv, hsv_to_bgr)




def _windows(img: torch.Tensor, k: int, border: str) -> torch.Tensor:
    """(n, H, W, 3) -> (n, H, W, 3, k, k) views of each pixel's k x k window
    over the border-extended crops: ``reflect101`` (gfedcb|abcdefgh|gfedcba)
    or ``replicate`` (aaaaaa|abcdefgh|hhhhhhh)."""
    r = k // 2

    def index(n):
        i = torch.arange(-r, n + r, device=img.device)
        if border == "replicate":
            return i.clamp(0, n - 1)
        i = i.abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    padded = img[:, index(img.shape[1])][:, :, index(img.shape[2])]
    return padded.unfold(1, k, 1).unfold(2, k, 1)


def box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.blur(img, (k, k))`` of (n, H, W, 3) crops: the window's sum
    (exact in float32) over k², rounded to the nearest integer."""
    total = _windows(img, k, "reflect101").sum(dim=(-2, -1)).to(torch.int32)
    return ((2 * total + k * k) // (2 * k * k)).to(img.dtype)


def median_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur(img, k)`` of (n, H, W, 3) crops."""
    windows = _windows(img, k, "replicate")
    return windows.reshape(*windows.shape[:4], k * k).median(dim=-1).values


def coarse_dropout(img: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) crops with (B, n, 4) holes (y, x, h, w) set to 0; a hole
    of zero size sets nothing."""
    y, x, h, w = (rects.to(torch.int64)[..., i, None, None] for i in range(4))  # (B, n, 1, 1)
    rows = torch.arange(img.shape[1], device=img.device)[:, None]
    cols = torch.arange(img.shape[2], device=img.device)
    hole = ((rows >= y) & (rows < y + h) & (cols >= x) & (cols < x + w)).any(dim=1)
    return img.masked_fill(hole[..., None], 0)
