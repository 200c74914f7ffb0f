"""OKS kernels for the expected-OKS decode (NumPy, host side).

The port's own copy of ``probpose_code_tpu/codecs/utils/oks_map.py:17-137``:
the COCO sigmas, the per-keypoint OKS spread, the normalised 2-D kernels
and their separable banded operators (reference
``codecs/utils/post_processing.py:13-39``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Standard COCO per-keypoint OKS sigmas (dimensionless).
COCO_KPT_SIGMAS = np.array(
    [2.6, 2.5, 2.5, 3.5, 3.5, 7.9, 7.9, 7.2, 7.2, 6.2, 6.2, 10.7, 10.7, 8.7, 8.7, 8.9, 8.9]
) / 100.0


def oks_kernel_scales(K: int, H: int, W: int, kpt_sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-keypoint OKS spread ``s`` used by both encode and decode.

    ``s = clip(((2*sigma_k)^2) * sqrt(H/1.25 * W/1.25) * 2, 0.55, 3.0)``.
    """
    if kpt_sigmas is None:
        kpt_sigmas = COCO_KPT_SIGMAS
    kpt_sigmas = np.asarray(kpt_sigmas, dtype=np.float64)[:K]
    if kpt_sigmas.shape[0] < K:  # datasets with more keypoints than COCO
        reps = int(np.ceil(K / kpt_sigmas.shape[0]))
        kpt_sigmas = np.tile(kpt_sigmas, reps)[:K]
    bbox_area = np.sqrt(H / 1.25 * W / 1.25)
    s = (kpt_sigmas * 2) ** 2 * bbox_area * 2
    return np.clip(s, 0.55, 3.0)


def build_oks_kernels(
    K: int, H: int, W: int, kpt_sigmas: Optional[np.ndarray] = None
) -> list:
    """Normalized per-keypoint OKS convolution kernels for expected-value
    decode (reference ``post_processing.py:13-39``). Kernel k has odd side
    ``2*ceil(3*s_k)+1`` and sums to 1."""
    scales = oks_kernel_scales(K, H, W, kpt_sigmas)
    kernels = []
    for k in range(K):
        s = scales[k]
        radius = int(np.ceil(s * 3))
        diameter = 2 * radius + 1
        d = np.arange(diameter, dtype=np.float64) - diameter // 2
        dist2 = d[:, None] ** 2 + d[None, :] ** 2
        kern = np.exp(-dist2 / (2.0 * s))
        kern /= kern.sum()
        kernels.append(kern)
    return kernels


def separable_oks_operators(
    K: int, H: int, W: int, kpt_sigmas: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Banded matmul operators for the expected-OKS convolution.

    The OKS kernels are isotropic gaussians, hence exactly separable:
    ``conv2d(x, k2d) == A_y @ pad(x) @ A_x^T`` with banded (out, padded-in)
    matrices built from the normalized 1-D factors. This turns the decode's
    depthwise convolution into two MXU matmuls.

    Returns (Ay (K, H, H+2R), Ax (K, W, W+2R), R) where R is the shared
    padding radius (kernels are zero-extended to the max diameter; with
    reflect padding this is numerically identical to per-kernel radii).
    """
    kernels = build_oks_kernels(K, H, W, kpt_sigmas)
    dmax = max(k.shape[0] for k in kernels)
    R = dmax // 2
    Ay = np.zeros((K, H, H + 2 * R), dtype=np.float32)
    Ax = np.zeros((K, W, W + 2 * R), dtype=np.float32)
    for k, kern in enumerate(kernels):
        d = kern.shape[0]
        # factor the normalized 2D gaussian as f f^T: the center row equals
        # g/Z with peak 1/Z, so f = row / sqrt(peak) reproduces it exactly
        f = kern[d // 2] / np.sqrt(kern[d // 2, d // 2])
        off = (dmax - d) // 2
        fk = np.zeros(dmax, dtype=np.float64)
        fk[off:off + d] = f
        for i in range(H):
            Ay[k, i, i:i + dmax] = fk
        for i in range(W):
            Ax[k, i, i:i + dmax] = fk
    return Ay, Ax, R
