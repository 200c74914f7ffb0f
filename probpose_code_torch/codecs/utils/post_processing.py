"""Host-side kernel helpers for the heatmap ops (NumPy).

The port's own copy of ``probpose_code_tpu/codecs/utils/post_processing.py:
gaussian_kernel1d`` (``:28``).
"""

from __future__ import annotations

import numpy as np


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV-compatible 1-D gaussian kernel (sigma <= 0: derived from the size)."""
    if ksize % 2 != 1:
        raise ValueError(f"gaussian_kernel1d: ksize {ksize} must be odd")
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)
