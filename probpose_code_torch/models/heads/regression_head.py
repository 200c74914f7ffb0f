"""Coordinate-regression head in PyTorch.

Port of ``probpose_code_tpu/models/heads/regression_heads.py:RegressionHead``
(``:27-41``) as mmpose has it (reference ``mmpose/models/heads/
regression_heads/regression_head.py``): the ``fc`` layer alone, (B, C) pooled
features -> (B, K, 2) normalized coordinates in f32; the configs pool in
their ``GlobalAveragePooling`` neck. The JAX head pools by itself as well,
so a shipped config's neck leaves it a (B, C) input it cannot pool (its
``init`` raises an ``IndexError``); the port's head equals the JAX head
built without the neck, which pools once. A 4-D input (B, C, h, w) is
refused: pooling belongs to the neck."""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from probpose_code_torch.registry import MODELS


@MODELS.register_module()
class RegressionHead(nn.Module):
    def __init__(self, in_channels: int, num_joints: int, loss: Any = None, decoder: Any = None,
                 init_cfg: Any = None, dtype: Any = "float32"):
        super().__init__()
        self.num_joints = num_joints
        self.decoder = decoder
        self.fc = nn.Linear(in_channels, num_joints * 2)

    def forward(self, feats) -> torch.Tensor:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats
        if x.dim() != 2:
            raise ValueError(f"RegressionHead: takes pooled (B, C) features (a GlobalAveragePooling neck), got "
                             f"{tuple(x.shape)}")
        return self.fc(x.float()).reshape(-1, self.num_joints, 2)
