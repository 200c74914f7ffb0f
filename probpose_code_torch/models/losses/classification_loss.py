"""Binary cross entropy and SimCC's discrete KL divergence in PyTorch.

Port of ``probpose_code_tpu/models/losses/classification_loss.py``:
``BCELoss`` (``:35``) and ``KLDiscretLoss`` (``:67``). BCELoss keeps the
reference's ``use_sigmoid`` flag as it is: True means the input is already a
probability (plain binary cross entropy), False that it is a logit (the
stable log-sigmoid form).
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


@MODELS.register_module()
class KLDiscretLoss:
    """KL divergence between the SimCC labels (softmaxed at ``label_beta``
    with ``label_softmax``) and the log-softmax of the predictions at
    ``beta``, averaged over the bins, weighted per keypoint, summed over
    both axes and the batch and divided by K; ``mask`` weighs the keypoints
    it names by ``mask_weight``."""

    def __init__(self, beta: float = 1.0, label_softmax: bool = False, label_beta: float = 10.0,
                 use_target_weight: bool = True, mask=None, mask_weight: float = 1.0):
        self.beta = beta
        self.label_softmax = label_softmax
        self.label_beta = label_beta
        self.use_target_weight = use_target_weight
        self.mask = mask
        self.mask_weight = mask_weight

    def _criterion(self, dec_outs, labels):
        log_pt = torch.log_softmax(dec_outs * self.beta, dim=1)
        if self.label_softmax:
            labels = torch.softmax(labels * self.label_beta, dim=1)
        # KLDivLoss(reduction='none') == labels * (log(labels) - log_pt)
        return (labels * (torch.log(torch.clamp(labels, min=_EPS)) - log_pt)).mean(dim=1)

    def __call__(self, pred_simcc, gt_simcc, target_weight):
        N, K, _ = pred_simcc[0].shape
        weight = target_weight.reshape(-1) if self.use_target_weight else 1.0
        loss = 0.0
        for pred, target in zip(pred_simcc, gt_simcc):
            t_loss = self._criterion(pred.reshape(-1, pred.shape[-1]), target.reshape(-1, target.shape[-1])) * weight
            if self.mask is not None:
                scale = torch.ones(K, device=t_loss.device)
                scale[torch.as_tensor(self.mask)] = self.mask_weight
                t_loss = t_loss.reshape(N, K) * scale[None]
            loss = loss + t_loss.sum()
        return loss / K
