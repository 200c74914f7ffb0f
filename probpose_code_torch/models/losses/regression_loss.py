"""Regression losses in PyTorch: the ProbPose head's branches and the
coordinate-regression heads' losses.

Port of ``probpose_code_tpu/models/losses/regression_loss.py``: ``_smooth_l1``
(``:19``), ``_apply_weight_product`` (``:24``), ``SmoothL1Loss`` (``:33``),
``L1LogLoss`` (``:46``, the error branch), ``MSELoss`` (``:83``, the OKS
branch), ``WingLoss`` (``:96``), ``SoftWingLoss`` (``:127``) and ``RLELoss``
(``:267-318``).
"""

from __future__ import annotations

import math

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
class SmoothL1Loss(_WeightedLoss):
    def __call__(self, output, target, target_weight=None):
        output, target = self._weighted(output, target, target_weight)
        return _smooth_l1(output, target).mean() * self.loss_weight


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


@MODELS.register_module()
class WingLoss(_WeightedLoss):
    """``omega * log(1 + d / epsilon)`` for errors d below ``omega``, else
    ``d - C`` (C joins the two); the mean over the coordinates and the
    keypoints, summed over the batch."""

    def __init__(self, omega: float = 10.0, epsilon: float = 2.0, use_target_weight: bool = False,
                 loss_weight: float = 1.0):
        super().__init__(use_target_weight, loss_weight)
        self.omega = omega
        self.epsilon = epsilon
        self.C = self.omega * (1.0 - math.log(1.0 + self.omega / self.epsilon))

    def __call__(self, output, target, target_weight=None):
        output, target = self._weighted(output, target, target_weight)
        delta = (target - output).abs()
        losses = torch.where(delta < self.omega, self.omega * torch.log(1.0 + delta / self.epsilon), delta - self.C)
        return losses.mean(dim=-1).mean(dim=-1).sum() * self.loss_weight


@MODELS.register_module()
class SoftWingLoss(_WeightedLoss):
    """The error d itself below ``omega1``, else ``omega2 * log(1 + d /
    epsilon) + B`` (B joins the two); reduced as ``WingLoss``."""

    def __init__(self, omega1: float = 2.0, omega2: float = 20.0, epsilon: float = 0.5,
                 use_target_weight: bool = False, loss_weight: float = 1.0):
        super().__init__(use_target_weight, loss_weight)
        self.omega1 = omega1
        self.omega2 = omega2
        self.epsilon = epsilon
        self.B = self.omega1 - self.omega2 * math.log(1.0 + self.omega1 / self.epsilon)

    def __call__(self, output, target, target_weight=None):
        output, target = self._weighted(output, target, target_weight)
        delta = (target - output).abs()
        losses = torch.where(delta < self.omega1, delta, self.omega2 * torch.log(1.0 + delta / self.epsilon) + self.B)
        return losses.mean(dim=-1).mean(dim=-1).sum() * self.loss_weight


@MODELS.register_module()
class RLELoss:
    """Residual log-likelihood estimation (RLE): ``sigma`` is the head's raw
    output (the sigmoid is taken here), ``error = (pred - target) / (sigma +
    1e-9)``, the flow's log-density ``log_phi`` of the error (``log_phi_fn``:
    ``RLEHead.log_phi``) gives ``log sigma - log phi``, and with ``residual``
    the Laplace (``log 2 sigma + |error|``) or Gaussian (``log sqrt(2 pi)
    sigma + error^2 / 2``) term is added; the target weights multiply it,
    ``size_average`` divides by B, and the sum times ``loss_weight`` is the
    loss."""

    def __init__(self, use_target_weight: bool = False, size_average: bool = True, residual: bool = True,
                 q_distribution: str = "laplace", loss_weight: float = 1.0):
        if q_distribution not in ("laplace", "gaussian"):
            raise ValueError(f"RLELoss: q_distribution {q_distribution!r}")
        self.use_target_weight = use_target_weight
        self.size_average = size_average
        self.residual = residual
        self.q_distribution = q_distribution
        self.loss_weight = loss_weight

    def __call__(self, pred, sigma, target, target_weight=None, log_phi_fn=None):
        if log_phi_fn is None:
            raise ValueError("RLELoss needs the flow's log-density (RLEHead.log_phi)")
        sigma = torch.sigmoid(sigma)
        error = (pred - target) / (sigma + 1e-9)
        loss = torch.log(sigma) - log_phi_fn(error)[..., None]
        if self.residual:
            if self.q_distribution == "laplace":
                loss = loss + (torch.log(sigma * 2) + error.abs())
            else:
                loss = loss + (torch.log(sigma * math.sqrt(2 * math.pi)) + 0.5 * error ** 2)
        if self.use_target_weight and target_weight is not None:
            w = target_weight
            while w.dim() < loss.dim():
                w = w[..., None]
            loss = loss * w
        if self.size_average:
            loss = loss / pred.shape[0]
        return loss.sum() * self.loss_weight
