"""Binary cross entropy in PyTorch.

Port of ``probpose_code_tpu/models/losses/classification_loss.py:BCELoss``
(``:35``). The reference's ``use_sigmoid`` flag is kept as it is: True means
the input is already a probability (plain binary cross entropy), False that
it is a logit (the stable log-sigmoid form).
"""

from __future__ import annotations

import torch

from probpose_code_torch.registry import MODELS

_EPS = 1e-12


def _binary_cross_entropy(p, target):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def _bce_with_logits(logits, target):
    return torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


@MODELS.register_module()
class BCELoss:
    """Binary cross entropy with optional per-label weighting."""

    def __init__(self, use_target_weight: bool = False, loss_weight: float = 1.0,
                 reduction: str = "mean", use_sigmoid: bool = False):
        if reduction not in ("mean", "sum", "none"):
            raise ValueError(f"BCELoss: reduction {reduction!r}")
        self.use_target_weight = use_target_weight
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.use_sigmoid = use_sigmoid

    def __call__(self, output, target, target_weight=None):
        crit = _binary_cross_entropy if self.use_sigmoid else _bce_with_logits
        loss = crit(output, target)
        if self.use_target_weight:
            if target_weight is None:
                raise ValueError("BCELoss: use_target_weight needs target_weight")
            if target_weight.dim() == 1:
                target_weight = target_weight[:, None]
            loss = loss * target_weight
        if self.reduction == "sum":
            loss = loss.sum()
        elif self.reduction == "mean":
            loss = loss.mean()
        return loss * self.loss_weight
