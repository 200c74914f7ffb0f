"""The RTMPose recipes' photometric augmentations on a batch of crops: the
median blur and ``PhotometricDistortion`` as CUDA kernels
(``csrc/photometric.cu``), the rest in PyTorch.

They replace no TPU kernel: the JAX pipeline runs ``YOLOXHSVRandomAug``,
``PhotometricDistortion`` and ``Albumentation`` with OpenCV and NumPy on
the host (``probpose_code_tpu/datasets/transforms/common.py:368-406,
490-510, 792-871``). Their plain PyTorch versions (``ops/photometric.py``,
each cv2's bytes) cost about 25 ms of a 256-crop batch on the card, 14 ms
of it the median's sorts (H100 80GB HBM3, 700 W), so the median is a
kernel: a bit-by-bit selection in registers. The distortion's steps in
PyTorch around two gathers from the tables took 3.46 ms of a 256-crop
batch there (7.7 ms through the plain conversions), 2% of a body8 step, so
it is a kernel too: one pass, its float32 steps in registers. Both colour
conversions go through tables of cv2's results over every 8-bit input,
filled once a device by the plain conversions (``hsv_tables``: the same
bytes, exact by construction): two gathers in the distortion's kernel, and
two PyTorch gathers with the gains between them for the HSV jitter. The
blur (a window sum and a rounding division) and the dropout (a mask) are
the plain versions.

A CPU tensor goes to the plain version, a CUDA tensor to the card's form;
there is no fallback from one to the other. Each kernel's wrapper counts
its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from probpose_code_torch.ops import photometric as plain

from . import _build

_SIGNATURES = {
    "photometric_median": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "photometric_distortion": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
MEDIAN_KSIZES = (3, 5, 7)


@lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return _build.load("photometric", _SIGNATURES)


@lru_cache(maxsize=4)
def hsv_tables(device_index: int) -> tuple:
    """``ops/photometric.py:hsv_tables`` on card ``device_index``, filled
    once (86 MB)."""
    return plain.hsv_tables(torch.device("cuda", device_index))


def yolox_hsv(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """``YOLOXHSVRandomAug`` on (B, H, W, 3) crops with (B, 3) int gains
    (``ops/photometric.py:yolox_hsv``), through the tables on the card."""
    if img.device.type == "cpu":
        return plain.yolox_hsv(img, gains)
    if img.device.type != "cuda":
        raise ValueError(f"yolox_hsv: unsupported device {img.device}")
    return plain.yolox_hsv_lookup(img, gains.to(img.device), hsv_tables(img.device.index))


def photometric_distortion(img: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """``PhotometricDistortion`` on (B, H, W, 3) crops with (B, 8) float32
    rows (``ops/photometric.py:photometric_distortion``): the kernel of
    ``csrc/photometric.cu`` on the card."""
    if img.device.type == "cpu":
        return plain.photometric_distortion(img, params)
    if img.device.type != "cuda":
        raise ValueError(f"photometric_distortion: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"photometric_distortion: expected float32 (n, H, W, 3) crops, got {img.dtype} "
                         f"{tuple(img.shape)}")
    plain.check_width(img, "photometric_distortion")
    params = params.to(device=img.device, dtype=torch.float32).contiguous()
    if params.shape != (img.shape[0], 8):
        raise ValueError(f"photometric_distortion: expected ({img.shape[0]}, 8) rows, got {tuple(params.shape)}")
    img = img.contiguous()
    out = torch.empty_like(img)
    to_hsv, to_bgr = hsv_tables(img.device.index)
    n, H, W, _ = img.shape
    lib = _library()
    with torch.cuda.device(img.device):
        code = lib.photometric_distortion(img.data_ptr(), out.data_ptr(), params.data_ptr(), to_hsv.data_ptr(),
                                          to_bgr.data_ptr(), n, H, W,
                                          torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(lib, "photometric", code)
    photometric_distortion.launches += 1
    return out


photometric_distortion.launches = 0


def median_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur(img, k)`` of (n, H, W, 3) crops, k 3, 5 or 7 on the
    card (``Albumentation``'s default ``blur_limit`` draws no other)."""
    if img.device.type == "cpu":
        return plain.median_blur(img, k)
    if k not in MEDIAN_KSIZES:
        raise ValueError(f"median_blur: the kernel takes k in {MEDIAN_KSIZES}, got {k}")
    if img.device.type != "cuda":
        raise ValueError(f"median_blur: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"median_blur: expected float32 (n, H, W, 3) crops, got {img.dtype} {tuple(img.shape)}")
    img = img.contiguous()
    out = torch.empty_like(img)
    n, H, W, _ = img.shape
    lib = _library()
    with torch.cuda.device(img.device):
        code = lib.photometric_median(img.data_ptr(), out.data_ptr(), n, H, W, k,
                                      torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(lib, "photometric", code)
    median_blur.launches += 1
    return out


median_blur.launches = 0


def _per_ksize(img: torch.Tensor, ksize: torch.Tensor, op) -> torch.Tensor:
    """``op(crops, k)`` on the crops whose ``ksize`` is k, for each k > 0."""
    for k in sorted(set(ksize.tolist()) - {0}):
        chosen = (ksize == k).nonzero()[:, 0]
        img = img.index_copy(0, chosen, op(img[chosen], k))
    return img


def augment(img: torch.Tensor, hsv_gains: Optional[torch.Tensor] = None, photometric: Optional[torch.Tensor] = None,
            blur_ksize: Optional[torch.Tensor] = None, median_ksize: Optional[torch.Tensor] = None,
            dropout_rects: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batch's photometric augmentations in the JAX pipeline's order
    (``datasets/transforms/common.py:PHOTOMETRIC_ORDER``): the HSV gains of
    ``YOLOXHSVRandomAug``, ``PhotometricDistortion``'s row, then
    ``Albumentation``'s Blur, MedianBlur and CoarseDropout (a kernel size
    of 0: the op did not fire on that crop). Each argument is the collated
    batch's array of that name (``datasets/loader.py``), absent when the
    pipeline has no such transform: the body8 recipes give all of them,
    the halpe26 recipes all but the HSV gains."""
    if hsv_gains is not None:
        img = yolox_hsv(img, hsv_gains)
    if photometric is not None:
        img = photometric_distortion(img, photometric)
    if blur_ksize is not None:
        img = _per_ksize(img, blur_ksize, plain.box_blur)
    if median_ksize is not None:
        img = _per_ksize(img, median_ksize, median_blur)
    if dropout_rects is not None and dropout_rects.shape[1]:
        img = plain.coarse_dropout(img, dropout_rects)
    return img
