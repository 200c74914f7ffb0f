"""K2: the expected-OKS decode as a CUDA kernel (and K2b, its convolution).

Replaces the TPU kernels ``probpose_code_tpu/ops/pallas/expected_oks.py:
heatmap_expected_value_pallas_fused`` (``_fused_decode_kernel``) and
``oks_convolve_pallas`` (``_conv_kernel``). The source is
``probpose_code_torch/csrc/expected_oks.cu``; the plain twin is
``ops/decode.py``.

What bounds it on the H100: bytes and operations about equally. At B = 64,
K = 17, 64 x 48 the decode reads 13.4 MB of heatmaps (4.0 us at 3.35 TB/s)
and filters with 0.290 GFLOP of f32 multiply-adds (4.3 us at 67 TFLOP/s).
What the design does about it: one block per heatmap reads the map once
with reflect indexing straight into shared memory (no padded copy in device
memory), filters along W then along H there (38 taps a pixel, not 361), reduces
the argmax and takes the Taylor step on chip, and writes 12 bytes per
keypoint.

A CPU tensor goes to the plain twin, a CUDA tensor to the kernel; there is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from probpose_code_torch.ops.decode import (
    expected_oks_decode_to_input_space,
    input_space_scale,
    oks_convolve_plain,
    oks_filter_taps,
)

from . import _build

_SIGNATURES = {
    "expected_oks_run": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}


@lru_cache(maxsize=16)
def _taps(K: int, H: int, W: int, device: str) -> torch.Tensor:
    return torch.as_tensor(oks_filter_taps(K, H, W), device=device)


def _launch(heatmaps: torch.Tensor, scale, want_decode: bool, want_conv: bool):
    if heatmaps.device.type != "cuda":
        raise ValueError(f"expected_oks: unsupported device {heatmaps.device}")
    if heatmaps.dtype != torch.float32 or heatmaps.dim() != 4 or not heatmaps.is_contiguous():
        raise ValueError("expected_oks: heatmaps must be contiguous (B, K, H, W) float32")
    B, K, H, W = heatmaps.shape
    taps = _taps(K, H, W, str(heatmaps.device))
    D = taps.shape[1]
    if D // 2 > min(H, W):
        raise ValueError(f"expected_oks: a {H}x{W} map is smaller than the filter radius {D // 2}")
    dev = heatmaps.device
    locs = torch.empty(B, K, 2, dtype=torch.float32, device=dev) if want_decode else None
    vals = torch.empty(B, K, dtype=torch.float32, device=dev) if want_decode else None
    conv = torch.empty_like(heatmaps) if want_conv else None
    lib = _build.load("expected_oks", _SIGNATURES)

    def p(t):
        return _build.ptr(t) if t is not None else ctypes.c_void_p(None)

    with torch.cuda.device(dev):
        code = lib.expected_oks_run(
            p(heatmaps), p(taps), p(locs), p(vals), p(conv), B * K, K, H, W, D,
            ctypes.c_float(scale[0]), ctypes.c_float(scale[1]), _build.stream_of(heatmaps),
        )
    _build.check(lib, "expected_oks", code)
    return locs, vals, conv


def expected_oks_decode(
    heatmaps: torch.Tensor, input_size: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, H, W) heatmaps -> keypoints in input space (B, K, 2) and the
    raw-heatmap scores (B, K)."""
    if heatmaps.device.type == "cpu":
        return expected_oks_decode_to_input_space(heatmaps, input_size)
    H, W = heatmaps.shape[-2:]
    locs, vals, _ = _launch(heatmaps, input_space_scale(input_size, H, W), True, False)
    expected_oks_decode.launches += 1
    return locs, vals


def oks_convolve(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) -> the OKS-convolved maps (the conv-only entry, K2b)."""
    if heatmaps.device.type == "cpu":
        return oks_convolve_plain(heatmaps)
    _, _, conv = _launch(heatmaps, (1.0, 1.0), False, True)
    oks_convolve.launches += 1
    return conv


expected_oks_decode.launches = 0
oks_convolve.launches = 0
