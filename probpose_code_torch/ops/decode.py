"""Expected-OKS keypoint decode on (B, K, H, W) tensors: the plain version.

Port of ``probpose_code_tpu/ops/decode.py``: ``subpixel_refine_batch``
(``:58``), ``heatmap_expected_value_batch`` (``:83``, separable method) and
``expected_oks_decode_to_input_space`` (``:257``). This is the plain twin of
the K2 CUDA kernel (``ops/kernels/expected_oks.py``): the CPU path runs it,
and the card's kernel is held against it.

Per keypoint: convolve the heatmap with its OKS kernel (reflect border) as
two banded products, take the argmax (first index on ties), shift it by a
1-D Taylor step, and score it with the raw heatmap at the integer peak.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from probpose_code_torch.codecs.utils.oks_map import separable_oks_operators

from .heatmap import gather_hw


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
