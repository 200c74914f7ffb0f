"""Training targets encoded on the device (expected-OKS, UDP, MSRA maps and SimCC labels).

Port of ``probpose_code_tpu/ops/encode.py``: ``probmap_encode_scales``
(``:27``), ``generate_probmaps_device`` (``:44``) and
``generate_udp_gaussian_device`` (``:74``). The host ships (B, K, 2)
heatmap-space keypoints; the (B, K, H, W) maps are built on the device as two
separable factors and their outer product, from the same per-keypoint spread
table as the host encoder (``oks_kernel_scales``) or the UDP codec's sigma.
The DoubleProbMap codec's two windows (``probpose_code_tpu/codecs/
double_probmap.py:29-131``, which the JAX package encodes on the host) are
two such renders of the keypoints in each window's frame.

The MSRA codec's gaussians (``probpose_code_tpu/codecs/utils/
gaussian_heatmap.py:generate_gaussian_heatmaps``, ``:35``, and
``generate_unbiased_gaussian_heatmaps``, ``:84``) and the SimCC labels
(``codecs/simcc_label.py:_generate_gaussian`` / ``_generate_standard``),
which the JAX package encodes on the host, are rendered here in the host
codec's own arithmetic: float64 for the MSRA and SimCC gaussians, float32
for the unbiased form, so that the maps equal the codec's (the port's copy,
``probpose_code_torch/codecs/``) to the last bit or two of exp. The
regression codec's labels (``probpose_code_tpu/codecs/regression_label.py:
encode``, ``:33-40``) are the input-space keypoints over the input size,
divided in float64 and rounded once, as the host codec divides them. The
integral regression codec (``codecs/integral_regression_label.py:22-58``) is
those labels and the MSRA gaussians of the same keypoints, each map divided
by its sum (``+ 1e-24``) where ``normalize``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from probpose_code_torch.codecs.utils.oks_map import oks_kernel_scales

# the codecs whose targets are rendered here, on the device
DEVICE_CODECS = ("ProbMap", "ArgMaxProbMap", "UDPHeatmap", "DoubleProbMap", "MSRAHeatmap", "SimCCLabel",
                 "RegressionLabel", "IntegralRegressionLabel")


def probmap_encode_scales(
    K: int, heatmap_size: Tuple[int, int], sigma: float = -1.0, kpt_sigmas: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> np.ndarray:
    """The per-keypoint spread ``s``: ``sigma`` when it is > 0, else the OKS
    spread table; in ``dtype`` (the host codec's is float64)."""
    W, H = heatmap_size
    if sigma is not None and sigma > 0:
        return np.full(K, float(sigma), dtype)
    return oks_kernel_scales(K, H, W, kpt_sigmas).astype(dtype)


def generate_probmaps_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], scales: np.ndarray,
) -> torch.Tensor:
    """(B, K, 2) heatmap-space keypoints and a (B, K) visibility gate ->
    (B, K, H, W) f32 maps ``exp(-d^2 / 2s)``, zero for keypoints whose
    visibility is below 0.5. Float64 keypoints (the DoubleProbMap windows,
    ``datasets/transforms/common.py``) are rendered in float64, as the host
    codec computes them (``codecs/double_probmap.py:96-101``), and rounded to
    f32 once."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    dtype = torch.float64 if kpts_hm.dtype == torch.float64 else torch.float32
    s2 = torch.as_tensor(2.0 * np.asarray(scales, np.float64), dtype=dtype, device=dev)
    xs = torch.arange(W, dtype=dtype, device=dev)
    ys = torch.arange(H, dtype=dtype, device=dev)
    kpts = kpts_hm.to(dtype)
    fx = torch.exp(-((xs[None, None, :] - kpts[..., 0:1]) ** 2) / s2[None, :, None])  # (B, K, W)
    fy = torch.exp(-((ys[None, None, :] - kpts[..., 1:2]) ** 2) / s2[None, :, None])  # (B, K, H)
    maps = fy[..., :, None] * fx[..., None, :]
    return (maps * (visible >= 0.5).to(dtype)[..., None, None]).float()


def generate_udp_gaussian_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], sigma: float,
) -> torch.Tensor:
    """(B, K, 2) heatmap-space keypoints and a (B, K) visibility gate ->
    (B, K, H, W) f32 UDP targets: a unit-peak gaussian ``exp(-d^2 /
    (2 sigma^2))`` at the sub-pixel keypoint, cut to the window [mu - 3 sigma,
    mu + 3 sigma + 1) around the rounded centre mu = trunc(kpt + 0.5) (the
    bounds truncated toward zero, as the host encoder's int casts), zero for
    keypoints whose visibility is below 0.5. A keypoint whose window misses
    the map gets an all-zero map; its weight is the host's business."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    radius = float(sigma) * 3.0
    s2 = torch.tensor(2.0 * float(sigma) ** 2, dtype=torch.float32)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    kpts = kpts_hm.float()
    mu = torch.trunc(kpts + 0.5)
    lt = torch.trunc(mu - radius)
    rb = torch.trunc(mu + radius + 1.0)
    wx = (xs[None, None, :] >= lt[..., 0:1]) & (xs[None, None, :] < rb[..., 0:1])
    wy = (ys[None, None, :] >= lt[..., 1:2]) & (ys[None, None, :] < rb[..., 1:2])
    fx = torch.exp(-((xs[None, None, :] - kpts[..., 0:1]) ** 2) / s2.to(dev)) * wx
    fy = torch.exp(-((ys[None, None, :] - kpts[..., 1:2]) ** 2) / s2.to(dev)) * wy
    maps = fy[..., :, None] * fx[..., None, :]
    return maps * (visible >= 0.5).float()[..., None, None]


def _gaussian_window_gate(kpts: torch.Tensor, visible: torch.Tensor, lt: torch.Tensor, rb: torch.Tensor,
                          heatmap_size: Tuple[int, int]) -> torch.Tensor:
    """(B, K) bool: visible (>= 0.5) and the window [lt, rb) touches the map
    (``gaussian_heatmap.py``'s ``in_bounds``)."""
    W, H = heatmap_size
    in_bounds = ~((lt[..., 0] >= W) | (lt[..., 1] >= H) | (rb[..., 0] < 0) | (rb[..., 1] < 0))
    return (visible >= 0.5) & in_bounds


def generate_gaussian_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], sigma: float,
) -> torch.Tensor:
    """(B, K, 2) heatmap-space keypoints (float64, as the MSRA codec rounds
    them) and a (B, K) visibility gate -> (B, K, H, W) f32 MSRA targets: a
    unit-peak gaussian ``exp(-d^2 / (2 sigma^2))`` centred on the rounded
    keypoint mu = trunc(kpt + 0.5), cut to the integer window [mu - int(3
    sigma), mu + int(3 sigma) + 1), computed in float64 and rounded to f32
    once; zero for keypoints whose visibility is below 0.5 or whose window
    misses the map."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    radius = float(int(float(sigma) * 3))  # np.int64(radius): truncated toward zero
    mu = torch.trunc(kpts_hm.double() + 0.5)
    lt, rb = mu - radius, mu + radius + 1
    active = _gaussian_window_gate(mu, visible, lt, rb, (W, H))
    xs = torch.arange(W, dtype=torch.float64, device=dev)
    ys = torch.arange(H, dtype=torch.float64, device=dev)
    dx = xs[None, None, None, :] - mu[..., 0, None, None]
    dy = ys[None, None, :, None] - mu[..., 1, None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2 * float(sigma) ** 2))
    wx = (xs[None, None, :] >= lt[..., 0:1]) & (xs[None, None, :] < rb[..., 0:1])
    wy = (ys[None, None, :] >= lt[..., 1:2]) & (ys[None, None, :] < rb[..., 1:2])
    window = wy[..., :, None] & wx[..., None, :] & active[..., None, None]
    return torch.where(window, g, 0.0).float()


def generate_unbiased_gaussian_device(
    kpts_hm: torch.Tensor, visible: torch.Tensor, heatmap_size: Tuple[int, int], sigma: float,
) -> torch.Tensor:
    """The DARK (``unbiased``) form: the gaussian at the sub-pixel keypoint
    over the whole map, in f32 as the codec computes it (the keypoint cast
    to f32 first); zero for keypoints whose visibility is below 0.5 or whose
    float window [kpt - 3 sigma, kpt + 3 sigma + 1) misses the map (tested in
    float64)."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    dev = kpts_hm.device
    radius = float(sigma) * 3
    mu64 = kpts_hm.double()
    active = _gaussian_window_gate(mu64, visible, mu64 - radius, mu64 + radius + 1, (W, H))
    mu = kpts_hm.float()
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    dx = xs[None, None, None, :] - mu[..., 0, None, None]
    dy = ys[None, None, :, None] - mu[..., 1, None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2 * float(sigma) ** 2))
    return torch.where(active[..., None, None], g, 0.0)


def simcc_split_sizes(input_size: Tuple[int, int], ratio: float) -> Tuple[int, int]:
    """The label lengths ``around(w * ratio)``, ``around(h * ratio)``."""
    return int(np.around(input_size[0] * ratio)), int(np.around(input_size[1] * ratio))


def generate_simcc_labels_device(
    kpts_bins: torch.Tensor, visible: torch.Tensor, input_size: Tuple[int, int], simcc_split_ratio: float,
    sigma, smoothing_type: str = "gaussian", normalize: bool = True, label_smooth_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 2) keypoints in SimCC bins (``around(kpt * ratio)``, integer
    values) and a (B, K) visibility gate -> the (B, K, Wx) x labels and the
    (B, K, Wy) y labels of ``SimCCLabel``, f32. ``gaussian``: ``exp(-(i -
    bin)^2 / (2 sigma^2))`` per axis (``sigma`` a float or an (x, y) pair)
    in float64, over the whole vector, divided by ``sigma sqrt(2 pi)`` with
    ``normalize``; ``standard``: one-hot, ``label_smooth_weight`` spread over
    the other bins. Keypoints below 0.5 visibility, or out of bounds (the
    3-sigma window misses the vector for ``gaussian``, the bin outside it for
    ``standard``), get zero labels."""
    Wx, Wy = simcc_split_sizes(input_size, simcc_split_ratio)
    dev = kpts_bins.device
    sig = np.broadcast_to(np.asarray(sigma, np.float64), (2,))
    kpts = kpts_bins.double()
    if smoothing_type == "gaussian":
        radius = torch.as_tensor(sig * 3, device=dev)
        active = _gaussian_window_gate(kpts, visible, kpts - radius, kpts + radius + 1, (Wx, Wy))
    elif smoothing_type == "standard":
        active = (visible >= 0.5) & (kpts[..., 0] >= 0) & (kpts[..., 0] < Wx) & (kpts[..., 1] >= 0) & (kpts[..., 1] < Wy)
    else:
        raise ValueError(f"invalid smoothing_type {smoothing_type}")
    labels = []
    for axis, n in enumerate((Wx, Wy)):
        bins = torch.arange(n, dtype=torch.float64, device=dev)
        if smoothing_type == "gaussian":
            d = bins[None, None, :] - kpts[..., axis, None]
            label = torch.exp(-(d * d) / (2 * float(sig[axis]) ** 2)).float()
            if normalize:  # divided by the f32 rounding of sigma sqrt(2 pi), as the codec divides
                label = label / float(np.float32(sig[axis] * np.sqrt(np.pi * 2)))
        else:
            hit = bins[None, None, :] == kpts[..., axis, None]
            rest = label_smooth_weight / (n - 1) if label_smooth_weight > 0 else 0.0
            label = torch.full(hit.shape, rest, dtype=torch.float32, device=dev)
            label[hit] = 1.0 - label_smooth_weight
        labels.append(torch.where(active[..., None], label, 0.0))
    return labels[0], labels[1]


def regression_labels_device(kpts: torch.Tensor, input_size: Tuple[int, int]) -> torch.Tensor:
    """(B, K, 2) input-space keypoints -> f32 labels ``kpts / (w, h)``,
    divided in float64 as the host codec does (its float32 keypoints over
    an integer array) and rounded to f32 once."""
    wh = torch.tensor([float(input_size[0]), float(input_size[1])], dtype=torch.float64, device=kpts.device)
    return (kpts.double() / wh).float()


def integral_regression_labels_device(
    kpts: torch.Tensor, visible: torch.Tensor, input_size: Tuple[int, int], heatmap_size: Tuple[int, int],
    sigma: float, normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 2) input-space keypoints and a (B, K) visibility gate -> the
    ``IntegralRegressionLabel`` codec's (B, K, 2) labels and (B, K, H, W)
    MSRA maps: the keypoints divided by the f32 scale ``input / heatmap`` in
    f32 (the MSRA codec's ``heatmap_keypoints``), rendered by
    ``generate_gaussian_device``, and each map divided by its sum plus 1e-24
    where ``normalize``."""
    scale = torch.as_tensor((np.array(input_size) / np.array(heatmap_size)).astype(np.float32), device=kpts.device)
    heatmaps = generate_gaussian_device((kpts.float() / scale).double(), visible, heatmap_size, sigma)
    if normalize:
        heatmaps = heatmaps / (heatmaps.sum(dim=(-1, -2), keepdim=True) + 1e-24)
    return regression_labels_device(kpts, input_size), heatmaps
