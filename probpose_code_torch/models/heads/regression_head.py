"""Coordinate-regression heads in PyTorch: RegressionHead and RLEHead.

Port of ``probpose_code_tpu/models/heads/regression_heads.py``:
``RegressionHead`` (``:27-41``) and ``RLEHead`` (``:44-75``), under mmpose's
names (reference ``mmpose/models/heads/regression_heads/``).

``RegressionHead``: the ``fc`` layer, (B, C) features -> (B, K, 2)
normalized coordinates in f32. A 4-D input (B, C, h, w), the backbone's
map where a config has no neck (``td-reg_res{50,101,152}`` on COCO and
MPII), is pooled by its spatial mean first, as the JAX head pools
(``:38``); a (B, C) input from a ``GlobalAveragePooling`` neck (the face
configs) goes to ``fc`` as it is. The JAX head pools a second time after
such a neck and cannot build (``tests/test_torch_regression.py``); the
port's head, given the neck's output, equals the JAX head built without
the neck.

``RLEHead``: the pooled features -> ``fc`` -> (B, K, 4), the raw
coordinates and the raw sigmas, f32. It holds the RealNVP flow whose
log-density of the normalized residuals ``RLELoss`` reads (``log_phi``), so
that the flow's parameters train with the head's. Its state dict, under
mmpose's names by a reading of mmpose (unchecked against a file):
``fc.weight`` / ``fc.bias`` and the flow under ``loss.flow_model``:
``loss.flow_model.s.{i}.{0,2,4}.weight`` / ``.bias`` (the scale nets),
``loss.flow_model.t.{i}.{0,2,4}.weight`` / ``.bias`` (the translation
nets), i = 0..5, and the buffers ``loss.flow_model.loc``, ``.cov`` and
``.mask``. (mmpose 1.x names the loss ``loss_module`` and renames a file's
``loss.*`` keys to it as it loads; the port keeps the file's ``loss.*``.)
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from probpose_code_torch.registry import MODELS

from ..utils.realnvp import RealNVP


def pooled(feats) -> torch.Tensor:
    """The last feature, in f32, its spatial mean where it is a map."""
    x = feats[-1] if isinstance(feats, (tuple, list)) else feats
    x = x.float()
    return x.mean(dim=(2, 3)) if x.dim() == 4 else x


@MODELS.register_module()
class RegressionHead(nn.Module):
    def __init__(self, in_channels: int, num_joints: int, loss: Any = None, decoder: Any = None,
                 init_cfg: Any = None, dtype: Any = "float32"):
        super().__init__()
        self.num_joints = num_joints
        self.decoder = decoder
        self.fc = nn.Linear(in_channels, num_joints * 2)

    def forward(self, feats) -> torch.Tensor:
        return self.fc(pooled(feats)).reshape(-1, self.num_joints, 2)


@MODELS.register_module()
class RLEHead(nn.Module):
    def __init__(self, in_channels: int, num_joints: int, loss: Any = None, decoder: Any = None,
                 init_cfg: Any = None, dtype: Any = "float32"):
        super().__init__()
        self.num_joints = num_joints
        self.decoder = decoder
        self.fc = nn.Linear(in_channels, num_joints * 4)
        self.loss = nn.Module()
        self.loss.flow_model = RealNVP()

    def forward(self, feats) -> torch.Tensor:
        return self.fc(pooled(feats)).reshape(-1, self.num_joints, 4)

    def log_phi(self, error: torch.Tensor) -> torch.Tensor:
        """The flow's log-density of the normalized residuals (B, K, 2) -> (B, K)."""
        B, K, _ = error.shape
        return self.loss.flow_model(error.reshape(B * K, 2)).reshape(B, K)
