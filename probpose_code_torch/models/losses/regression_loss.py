"""Regression losses of the ProbPose head in PyTorch.

Port of ``probpose_code_tpu/models/losses/regression_loss.py``: ``_smooth_l1``
(``:19``), ``_apply_weight_product`` (``:24``), ``L1LogLoss`` (``:46``, the
error branch) and ``MSELoss`` (``:83``, the OKS branch).
"""

from __future__ import annotations

import torch

from probpose_code_torch.registry import MODELS


def _smooth_l1(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _apply_weight_product(output, target, target_weight):
    """The reference's semantics: BOTH operands are multiplied by the weight."""
    w = target_weight
    while w.dim() < output.dim():
        w = w[..., None]
    return output * w, target * w


class _WeightedLoss:
    def __init__(self, use_target_weight: bool = False, loss_weight: float = 1.0):
        self.use_target_weight = use_target_weight
        self.loss_weight = loss_weight

    def _weighted(self, output, target, target_weight):
        if not self.use_target_weight:
            return output, target
        if target_weight is None:
            raise ValueError(f"{type(self).__name__}: use_target_weight needs target_weight")
        return _apply_weight_product(output, target, target_weight)


@MODELS.register_module()
class L1LogLoss(_WeightedLoss):
    """Smooth-L1 on log(1 + x): the relative error of the error branch."""

    def __call__(self, output, target, target_weight=None):
        output, target = self._weighted(torch.log1p(output), torch.log1p(target), target_weight)
        return _smooth_l1(output, target).mean() * self.loss_weight


@MODELS.register_module()
class MSELoss(_WeightedLoss):
    def __call__(self, output, target, target_weight=None):
        output, target = self._weighted(output, target, target_weight)
        return ((output - target) ** 2).mean() * self.loss_weight
