"""Batched affine crop-warp on the device (replaces cv2.warpAffine).

Port of ``probpose_code_tpu/ops/warp.py``: ``invert_affine`` (``:21``) and
``warp_affine_batch`` (``:37``). Its ``warp_affine_separable`` (``:100``),
two banded products for rotation-free crops, exists because a TPU runs a
gather on its scalar unit; it is not ported, and every crop takes the gather.
Bilinear sampling with a constant zero border, as cv2.warpAffine's
defaults; ``mats`` map source -> crop (the UDP warp matrices) and sampling
uses their inverse.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def invert_affine(mats: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices."""
    a, b, tx = mats[..., 0, 0], mats[..., 0, 1], mats[..., 0, 2]
    c, d, ty = mats[..., 1, 0], mats[..., 1, 1], mats[..., 1, 2]
    det = a * d - b * c
    inv_a = d / det
    inv_b = -b / det
    inv_c = -c / det
    inv_d = a / det
    inv_tx = -(inv_a * tx + inv_b * ty)
    inv_ty = -(inv_c * tx + inv_d * ty)
    row0 = torch.stack([inv_a, inv_b, inv_tx], dim=-1)
    row1 = torch.stack([inv_c, inv_d, inv_ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def warp_affine_batch(images: torch.Tensor, mats: torch.Tensor, out_size: Tuple[int, int],
                      image_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp (Bi, Hs, Ws, C) images with (B, 2, 3) source -> crop affines to
    (B, h, w, C) float32; ``out_size`` is (w, h). Crop i comes from image
    ``image_index[i]`` where it is given, else ``Bi`` is B (crop i from image
    i), or 1 (every crop from the one image)."""
    Bi, Hs, Ws, C = images.shape
    B = mats.shape[0]
    if image_index is None and Bi not in (1, B):
        raise ValueError(f"warp_affine_batch: {Bi} images for {B} matrices")
    w, h = out_size
    dev = images.device
    inv = invert_affine(mats.to(device=dev, dtype=torch.float32))  # crop -> source

    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    sx = inv[:, 0, 0, None, None] * gx + inv[:, 0, 1, None, None] * gy + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * gx + inv[:, 1, 1, None, None] * gy + inv[:, 1, 2, None, None]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    # gather from the source as it is (a uint8 batch stays 1 byte a value:
    # a padded 64 x 640 x 640 x 3 batch would be 315 MB in f32), the four
    # taps then in f32: the same values
    src = images
    if image_index is not None:
        bidx = image_index.to(device=dev, dtype=torch.int64)[:, None, None]
    elif Bi == B:
        bidx = torch.arange(B, device=dev)[:, None, None]
    else:
        bidx = torch.zeros(1, 1, 1, dtype=torch.int64, device=dev)

    def sample(xi, yi):
        valid = (xi >= 0) & (xi < Ws) & (yi >= 0) & (yi < Hs)
        vals = src[bidx, yi.clamp(0, Hs - 1), xi.clamp(0, Ws - 1)].float()
        return vals * valid[..., None]

    v00 = sample(x0i, y0i)
    v01 = sample(x0i + 1, y0i)
    v10 = sample(x0i, y0i + 1)
    v11 = sample(x0i + 1, y0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
