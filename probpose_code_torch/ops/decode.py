"""Keypoint decodes on (B, K, H, W) tensors.

Port of ``probpose_code_tpu/ops/decode.py``: ``subpixel_refine_batch``
(``:58``), ``heatmap_expected_value_batch`` (``:83``, separable method),
``dark_udp_refine_batch`` (``:123``), ``argmax_probmap_decode_batch``
(``:184``), the MSRA codec's ``quarter_offset_refine_batch`` (``:197``) and
``dark_refine_batch`` (``:214``), ``simcc_maximum_batch`` (``:244``) and
``expected_oks_decode_to_input_space`` (``:257``); and, batched on the
device, the decode of ``probpose_code_tpu/codecs/megvii_heatmap.py``
(``:63-77``, ``megvii_decode_batch``).

The expected-OKS decode is the plain twin of the K2 CUDA kernel
(``ops/kernels/expected_oks.py``): the CPU path runs it, and the card's
kernel is held against it. Per keypoint: convolve the heatmap with its OKS
kernel (reflect border) as two banded products, take the argmax (first index
on ties), shift it by a 1-D Taylor step, and score it with the raw heatmap at
the integer peak.

The fast decode (argmax + DARK-UDP) gives the training loss its heatmap-space
coordinates for the OKS and error targets.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from probpose_code_torch.codecs.utils.oks_map import separable_oks_operators

from .heatmap import gather_hw, gaussian_blur_batch, heatmap_maximum_batch


@lru_cache(maxsize=8)
def oks_separable_bank(K: int, H: int, W: int):
    """(Ay (K, H, H+2R), Ax (K, W, W+2R), R), host-side numpy."""
    return separable_oks_operators(K, H, W)


def oks_filter_taps(K: int, H: int, W: int) -> np.ndarray:
    """The per-keypoint 1-D factor of the OKS kernel: (K, 2R+1) float32, the
    band of the separable operators."""
    Ay, _, R = oks_separable_bank(K, H, W)
    return np.ascontiguousarray(Ay[:, 0, : 2 * R + 1])


def symmetric_pad(maps: torch.Tensor, r: int) -> torch.Tensor:
    """Pad the last two axes by ``r`` with ``jnp.pad(mode="symmetric")``."""
    H, W = maps.shape[-2:]

    def idx(n):
        i = torch.arange(-r, n + r, device=maps.device)
        i = torch.where(i < 0, -i - 1, i)
        return torch.where(i >= n, 2 * n - 1 - i, i)

    return maps.index_select(-2, idx(H)).index_select(-1, idx(W))


def oks_convolve_plain(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) -> the OKS-kernel-convolved maps, reflect border."""
    B, K, H, W = heatmaps.shape
    Ay, Ax, r = oks_separable_bank(K, H, W)
    padded = symmetric_pad(heatmaps.float(), r)
    Ay = torch.as_tensor(Ay, device=heatmaps.device)
    Ax = torch.as_tensor(Ax, device=heatmaps.device)
    rowed = torch.einsum("khp,bkpw->bkhw", Ay, padded)
    return torch.einsum("bkhw,kxw->bkhx", rowed, Ax)


def subpixel_refine_batch(maps: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """1-D Taylor sub-pixel shift at integer peaks; border peaks stay."""
    B, K, H, W = maps.shape
    x = locs[..., 0].to(torch.int64)
    y = locs[..., 1].to(torch.int64)
    valid = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
    xc = x.clamp(1, W - 2)
    yc = y.clamp(1, H - 2)

    c = gather_hw(maps, xc, yc)
    dx = (gather_hw(maps, xc + 1, yc) - gather_hw(maps, xc - 1, yc)) / 2.0
    dy = (gather_hw(maps, xc, yc + 1) - gather_hw(maps, xc, yc - 1)) / 2.0
    dxx = gather_hw(maps, xc + 1, yc) + gather_hw(maps, xc - 1, yc) - 2 * c
    dyy = gather_hw(maps, xc, yc + 1) + gather_hw(maps, xc, yc - 1) - 2 * c
    dxx = torch.where(dxx != 0, dxx, torch.full_like(dxx, 1e-6))
    dyy = torch.where(dyy != 0, dyy, torch.full_like(dyy, 1e-6))

    shift = torch.stack([-dx / dxx, -dy / dyy], dim=-1)
    return torch.where(valid[..., None], locs + shift, locs)


def heatmap_expected_value_batch(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected-OKS decode of (B, K, H, W) -> locs (B, K, 2) in heatmap
    pixels, vals (B, K)."""
    B, K, H, W = heatmaps.shape
    convolved = oks_convolve_plain(heatmaps)
    idx = torch.argmax(convolved.reshape(B, K, H * W), dim=-1)
    xi = idx % W
    yi = idx // W
    locs = torch.stack([xi, yi], dim=-1).float()
    locs = subpixel_refine_batch(convolved, locs)
    vals = gather_hw(heatmaps.float(), xi, yi)  # the score reads the raw heatmap
    return locs, vals


def input_space_scale(input_size: Tuple[int, int], H: int, W: int) -> Tuple[float, float]:
    """Heatmap pixels -> model input pixels (reference ``probmap.py:218``)."""
    return input_size[0] / (W - 1), input_size[1] / (H - 1)


def expected_oks_decode_to_input_space(
    heatmaps: torch.Tensor, input_size: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expected-OKS decode scaled to input space: locs (B, K, 2), vals."""
    B, K, H, W = heatmaps.shape
    locs, vals = heatmap_expected_value_batch(heatmaps)
    scale = torch.tensor(input_space_scale(input_size, H, W), dtype=torch.float32, device=locs.device)
    return locs * scale, vals


def dark_udp_refine_batch(keypoints: torch.Tensor, heatmaps: torch.Tensor, blur_kernel_size: int = 11) -> torch.Tensor:
    """DARK-UDP refinement of (B, K, 2) peaks over (B, K, H, W) heatmaps: blur,
    log, edge padding, and a Newton step through the pseudo-inverse of the
    2x2 Hessian (directions of a near-zero eigenvalue are dropped, as
    ``np.linalg.pinv`` drops them, not inverted)."""
    hm = torch.log(torch.clamp(gaussian_blur_batch(heatmaps, blur_kernel_size), 1e-3, 50.0))
    pad = torch.nn.functional.pad(hm, (1, 1, 1, 1), mode="replicate")
    x = (keypoints[..., 0] + 1).to(torch.int32)  # truncation toward zero, as astype(int32)
    y = (keypoints[..., 1] + 1).to(torch.int32)

    def tap(dx_, dy_):
        return gather_hw(pad, x + dx_, y + dy_)

    i_ = tap(0, 0)
    ix1, iy1, ix1y1 = tap(1, 0), tap(0, 1), tap(1, 1)
    ix1_y1_, ix1_, iy1_ = tap(-1, -1), tap(-1, 0), tap(0, -1)

    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2 * i_ + ix1_
    dyy = iy1 - 2 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2 * i_ - ix1_ - iy1_ + ix1_y1_)

    eps = float(np.finfo(np.float32).eps)
    a, b, d = dxx + eps, dxy, dyy + eps
    tr = a + d
    disc = torch.sqrt((a - d) ** 2 + 4.0 * b * b)
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    # eigenvector of l1: (b, l1 - a), or an axis when it degenerates
    v1x, v1y = b, l1 - a
    n1 = torch.sqrt(v1x * v1x + v1y * v1y)
    degen = n1 < 1e-20
    a_ge_d = (a >= d).to(a.dtype)
    v1x = torch.where(degen, a_ge_d, v1x / torch.clamp(n1, min=1e-30))
    v1y = torch.where(degen, 1.0 - a_ge_d, v1y / torch.clamp(n1, min=1e-30))
    v2x, v2y = -v1y, v1x
    rcond = 1e-15 * torch.maximum(l1.abs(), l2.abs())
    zero = torch.zeros_like(l1)
    il1 = torch.where(l1.abs() > rcond, 1.0 / l1, zero)
    il2 = torch.where(l2.abs() > rcond, 1.0 / l2, zero)
    c1 = v1x * dx + v1y * dy
    c2 = v2x * dx + v2y * dy
    off_x = il1 * c1 * v1x + il2 * c2 * v2x
    off_y = il1 * c1 * v1y + il2 * c2 * v2y
    return keypoints - torch.stack([off_x, off_y], dim=-1)


def argmax_probmap_decode_batch(
    heatmaps: torch.Tensor, blur_kernel_size: int = 11
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast decode (argmax + DARK-UDP) in heatmap space: locs (B, K, 2), vals."""
    locs, vals = heatmap_maximum_batch(heatmaps)
    return dark_udp_refine_batch(locs, heatmaps, blur_kernel_size), vals


def quarter_offset_refine_batch(keypoints: torch.Tensor, heatmaps: torch.Tensor) -> torch.Tensor:
    """The MSRA step: each peak moves 0.25 px toward its larger neighbour on
    each axis. The x step needs 1 < x < W - 1 and 0 < y < H, the y step
    1 < y < H - 1 and 0 < x < W (the codec's own asymmetric test)."""
    B, K, H, W = heatmaps.shape
    x = keypoints[..., 0].to(torch.int32)  # truncation toward zero, as astype(int32)
    y = keypoints[..., 1].to(torch.int32)
    xc = x.clamp(0, W - 1)
    yc = y.clamp(0, H - 1)
    valid_x = (x > 1) & (x < W - 1) & (y > 0) & (y < H)
    valid_y = (y > 1) & (y < H - 1) & (x > 0) & (x < W)
    dx = gather_hw(heatmaps, (x + 1).clamp(0, W - 1), yc) - gather_hw(heatmaps, (x - 1).clamp(0, W - 1), yc)
    dy = gather_hw(heatmaps, xc, (y + 1).clamp(0, H - 1)) - gather_hw(heatmaps, xc, (y - 1).clamp(0, H - 1))
    shift_x = torch.where(valid_x, torch.sign(dx) * 0.25, 0.0)
    shift_y = torch.where(valid_y, torch.sign(dy) * 0.25, 0.0)
    return keypoints + torch.stack([shift_x, shift_y], dim=-1)


def megvii_decode_batch(heatmaps: torch.Tensor, kernel_size: int,
                        input_size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Megvii (CPN / MSPN) decode of each (b, k) map: the modulation
    blur of ``kernel_size`` (``gaussian_blur_batch``: zero border, rescaled
    to the map's maximum), the first maximum, and at peaks with 1 < x < W - 1
    and 1 < y < H - 1 a quarter pixel toward the larger neighbour on each
    axis plus 0.5; the keypoints times input / heatmap size, the scores the
    maximum / 255 + 0.5. Returns keypoints (B, K, 2) and scores (B, K)."""
    B, K, H, W = heatmaps.shape
    hm = gaussian_blur_batch(heatmaps, kernel_size)
    locs, vals = heatmap_maximum_batch(hm)
    x = locs[..., 0].to(torch.int32)
    y = locs[..., 1].to(torch.int32)
    valid = (x > 1) & (x < W - 1) & (y > 1) & (y < H - 1)
    xc, yc = x.clamp(1, W - 2), y.clamp(1, H - 2)
    dx = gather_hw(hm, xc + 1, yc) - gather_hw(hm, xc - 1, yc)
    dy = gather_hw(hm, xc, yc + 1) - gather_hw(hm, xc, yc - 1)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25 + 0.5
    keypoints = locs + torch.where(valid[..., None], shift, 0.0)
    scale = torch.tensor([input_size[0] / W, input_size[1] / H], dtype=torch.float32, device=locs.device)
    return keypoints * scale, vals / 255.0 + 0.5


def dark_refine_batch(keypoints: torch.Tensor, heatmaps: torch.Tensor, blur_kernel_size: int = 11) -> torch.Tensor:
    """DARK (the MSRA codec's ``unbiased`` decode): the modulation blur, the
    log of ``max(blur, 1e-10)``, and a full 2x2 Newton step at peaks at least
    two pixels inside the map, where the Hessian's determinant is not 0."""
    B, K, H, W = heatmaps.shape
    hm = torch.log(torch.clamp(gaussian_blur_batch(heatmaps, blur_kernel_size), min=1e-10))
    x = keypoints[..., 0].to(torch.int32)
    y = keypoints[..., 1].to(torch.int32)
    valid = (x > 1) & (x < W - 2) & (y > 1) & (y < H - 2)
    xc = x.clamp(2, W - 3)
    yc = y.clamp(2, H - 3)

    def v(dx_, dy_):
        return gather_hw(hm, xc + dx_, yc + dy_)

    dx = 0.5 * (v(1, 0) - v(-1, 0))
    dy = 0.5 * (v(0, 1) - v(0, -1))
    dxx = 0.25 * (v(2, 0) - 2 * v(0, 0) + v(-2, 0))
    dxy = 0.25 * (v(1, 1) - v(-1, 1) - v(1, -1) + v(-1, -1))
    dyy = 0.25 * (v(0, 2) - 2 * v(0, 0) + v(0, -2))
    det = dxx * dyy - dxy * dxy
    solvable = valid & (det != 0)
    inv_det = torch.where(det != 0, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    off_x = -(dyy * dx - dxy * dy) * inv_det
    off_y = -(-dxy * dx + dxx * dy) * inv_det
    shift = torch.stack([off_x, off_y], dim=-1)
    return keypoints + torch.where(solvable[..., None], shift, 0.0)


def simcc_maximum_batch(simcc_x: torch.Tensor, simcc_y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SimCC's joint argmax: (B, K, Wx), (B, K, Wy) -> locs (B, K, 2) in bins
    (the first maximum of each vector; -1 where the score is <= 0), vals =
    min(max_x, max_y)."""
    max_x, x_locs = simcc_x.max(dim=-1)  # documented to return the first maximal index
    max_y, y_locs = simcc_y.max(dim=-1)
    vals = torch.minimum(max_x, max_y)
    locs = torch.stack([x_locs.float(), y_locs.float()], dim=-1)
    return torch.where((vals <= 0.0)[..., None], -1.0, locs), vals
