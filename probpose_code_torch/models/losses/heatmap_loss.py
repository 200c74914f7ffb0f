"""Dense heatmap losses in PyTorch.

Port of ``probpose_code_tpu/models/losses/heatmap_loss.py``: ``_resolve_mask``
(``:30``), ``KeypointMSELoss`` (``:50``), ``AdaptiveWingLoss`` (``:121``),
``_sobel_gradients`` (``:188``) and ``OKSHeatmapLoss`` (``:201``). Shapes: output / target (B, K, H, W),
target_weights (B, K) or (B, K, H, W), optional mask (B, K|1, H, W).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from probpose_code_torch.ops.kernels.adaptive_wing import adaptive_wing_loss
from probpose_code_torch.registry import MODELS


def _resolve_mask(
    target: torch.Tensor,
    target_weights: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    skip_empty_channel: bool,
) -> Optional[torch.Tensor]:
    """Combine spatial mask, keypoint weights and empty-channel skip."""
    out = mask
    if target_weights is not None:
        w = target_weights
        while w.dim() < target.dim():
            w = w[..., None]
        out = w if out is None else out * w
    if skip_empty_channel:
        nonempty = (target != 0).any(dim=-1, keepdim=True).any(dim=-2, keepdim=True).to(target.dtype)
        out = nonempty if out is None else out * nonempty
    return out


@MODELS.register_module()
class KeypointMSELoss:
    """MSE over heatmaps with optional per-keypoint weighting."""

    def __init__(self, use_target_weight: bool = False, skip_empty_channel: bool = False, loss_weight: float = 1.0):
        self.use_target_weight = use_target_weight
        self.skip_empty_channel = skip_empty_channel
        self.loss_weight = loss_weight

    def __call__(self, output, target, target_weights=None, mask=None, per_pixel: bool = False):
        if not self.use_target_weight:
            target_weights = None
        _mask = _resolve_mask(target, target_weights, mask, self.skip_empty_channel)
        loss = (output - target) ** 2
        if _mask is not None:
            loss = loss * _mask
        if per_pixel:
            return loss * self.loss_weight
        return loss.mean() * self.loss_weight


@MODELS.register_module()
class AdaptiveWingLoss:
    """The adaptive wing loss of heatmap regression (reference
    ``heatmap_loss.py:271``): ``omega * log1p((d / epsilon) ** (alpha - y))``
    where the error d = |output - y| is below ``theta``, its tangent line
    ``A d - C`` above, the mean over every pixel (each keypoint's map
    weighed by its weight with ``use_target_weight``). On the card its
    forward and backward are CUDA kernels (``ops/kernels/adaptive_wing.py``),
    on the CPU their plain twin."""

    def __init__(self, alpha: float = 2.1, omega: float = 14.0, epsilon: float = 1.0, theta: float = 0.5,
                 use_target_weight: bool = False, loss_weight: float = 1.0):
        self.alpha = alpha
        self.omega = omega
        self.epsilon = epsilon
        self.theta = theta
        self.use_target_weight = use_target_weight
        self.loss_weight = loss_weight

    def __call__(self, output, target, target_weights=None):
        weights = target_weights if self.use_target_weight else None
        return adaptive_wing_loss(output, target, weights, self.alpha, self.omega, self.epsilon, self.theta,
                                  self.loss_weight)


_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _sobel_gradients(output: torch.Tensor) -> torch.Tensor:
    """Squared Sobel gradient magnitude per pixel, zero padding. The taps
    are applied un-flipped (cross-correlation), as torch's reference and the
    JAX package's ``lax.conv`` both do."""
    B, K, H, W = output.shape
    taps = torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=output.dtype, device=output.device)[:, None]
    g = F.conv2d(output.reshape(B * K, 1, H, W), taps, padding=1)  # (B*K, 2, H, W)
    return (g[:, 0] ** 2 + g[:, 1] ** 2).reshape(B, K, H, W)


@MODELS.register_module()
class OKSHeatmapLoss:
    """Expected-OKS risk for ProbMap heads: ``output * (1 - target)``
    ("minus"), ``(1 - output) * target`` ("plus") or their mean ("both"),
    plus a Sobel smoothness term and an optional MSE term; per-pixel,
    per-keypoint or scalar reductions."""

    def __init__(
        self,
        use_target_weight: bool = False,
        skip_empty_channel: bool = False,
        smoothing_weight: float = 0.2,
        gaussian_weight: float = 0.0,
        loss_weight: float = 1.0,
        oks_type: str = "minus",
    ):
        if oks_type.lower() not in ("minus", "plus", "both"):
            raise ValueError(f"OKSHeatmapLoss: oks_type {oks_type!r}")
        self.use_target_weight = use_target_weight
        self.skip_empty_channel = skip_empty_channel
        self.smoothing_weight = smoothing_weight
        self.gaussian_weight = gaussian_weight
        self.loss_weight = loss_weight
        self.oks_type = oks_type.lower()

    def __call__(self, output, target, target_weights=None, mask=None,
                 per_pixel: bool = False, per_keypoint: bool = False):
        B, K, H, W = output.shape
        if not self.use_target_weight:
            target_weights = None
        _mask = _resolve_mask(target, target_weights, mask, self.skip_empty_channel)

        oks_minus = output * (1 - target)
        oks_plus = (1 - output) * target
        if self.oks_type == "both":
            oks = (oks_minus + oks_plus) / 2
        elif self.oks_type == "minus":
            oks = oks_minus
        else:
            oks = oks_plus

        mse = (output - target) ** 2
        gradient = _sobel_gradients(output)
        if _mask is not None:
            oks = oks * _mask
            mse = mse * _mask
            gradient = gradient * _mask

        oks_w = 1 - self.smoothing_weight - self.gaussian_weight
        if per_pixel:
            loss = self.smoothing_weight * gradient + oks_w * oks + self.gaussian_weight * mse
        else:
            max_gradient = gradient.reshape(B, K, H * W).amax(dim=-1)
            loss = (
                oks_w * oks.sum(dim=(2, 3))
                + self.smoothing_weight * max_gradient
                + self.gaussian_weight * mse.mean(dim=(2, 3))
            )
            if not per_keypoint:
                loss = loss.mean()
        return loss * self.loss_weight
