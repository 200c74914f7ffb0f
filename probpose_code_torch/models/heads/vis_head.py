"""VisPredictHead in PyTorch: any pose head with a keypoint-visibility branch.

Port of ``probpose_code_tpu/models/heads/regression_heads.py:VisPredictHead``
(``:128-149``; reference ``mmpose/models/heads/hybrid_heads/vis_head.py``):
the wrapped head ``pose_head`` built from ``pose_cfg``, and ``vis_head``, the
spatial mean of the last feature map -> a linear layer of ``pose_cfg``'s
``out_channels`` (or ``num_joints``) -> a sigmoid, always (the JAX head's;
the config's ``BCELoss(use_sigmoid=True)`` reads a probability). Returns
``(the pose head's output, visibility (B, K))``.

Its state dict, under mmpose's names by a reading of mmpose (unchecked
against a file): ``pose_head.*`` (the wrapped head's own names) and
``vis_head.2.weight`` / ``vis_head.2.bias`` (mmpose's ``vis_head`` is
``AdaptiveAvgPool2d``, ``Flatten``, ``Linear`` and ``Sigmoid``, as here).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.registry import MODELS


@MODELS.register_module()
class VisPredictHead(nn.Module):
    def __init__(self, pose_cfg: Dict[str, Any], loss: Any = None, init_cfg: Any = None, dtype: Any = "float32"):
        super().__init__()
        cfg = dict(pose_cfg)
        self.pose_head = MODELS.build(cfg)
        out_channels = cfg.get("out_channels", cfg.get("num_joints", 17))
        self.vis_head = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(cfg["in_channels"], out_channels),
                                      nn.Sigmoid())

    def forward(self, feats) -> Tuple[Any, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats
        return self.pose_head(feats), self.vis_head(x.float())
