"""RTMPose's SimCC head (RTMCCHead) in PyTorch.

Port of ``probpose_code_tpu/models/heads/rtmcc_head.py:RTMCCHead`` (``:60``):
the last feature map -> a 7x7 conv (with bias) to one map a keypoint ->
each map flattened into a token -> ScaleNorm and a linear layer (no bias)
to ``hidden_dims`` -> one GAU (``models/utils/rtmcc_block.py``) -> the x and
y classifiers over ``input_size * simcc_split_ratio`` bins (no bias).
Returns ``(pred_x (B, K, Wx), pred_y (B, K, Wy))`` in f32. Names are
mmpose's: ``final_layer``, ``mlp.0.g`` / ``mlp.1``, ``gau.*``, ``cls_x``,
``cls_y``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.models.utils.rtmcc_block import RTMCCBlock, ScaleNorm
from probpose_code_torch.registry import MODELS

GAU_DEFAULTS = dict(hidden_dims=256, s=128, expansion_factor=2, dropout_rate=0.0, drop_path=0.0, act_fn="ReLU",
                    use_rel_bias=False, pos_enc=False)


@MODELS.register_module()
class RTMCCHead(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, input_size: Tuple[int, int],
                 in_featuremap_size: Tuple[int, int], simcc_split_ratio: float = 2.0,
                 final_layer_kernel_size: int = 7, gau_cfg: Any = None, loss: Any = None, decoder: Any = None):
        super().__init__()
        gau = dict(GAU_DEFAULTS, **dict(gau_cfg or {}))
        k = final_layer_kernel_size
        self.final_layer = nn.Conv2d(in_channels, out_channels, k, padding=k // 2)
        flat = in_featuremap_size[0] * in_featuremap_size[1]
        self.mlp = nn.Sequential(ScaleNorm(flat), nn.Linear(flat, gau["hidden_dims"], bias=False))
        self.gau = RTMCCBlock(out_channels, gau["hidden_dims"], gau["hidden_dims"], s=gau["s"],
                              expansion_factor=gau["expansion_factor"], dropout_rate=gau["dropout_rate"],
                              drop_path=gau["drop_path"], act_fn=gau["act_fn"], use_rel_bias=gau["use_rel_bias"],
                              pos_enc=gau["pos_enc"])
        self.cls_x = nn.Linear(gau["hidden_dims"], int(input_size[0] * simcc_split_ratio), bias=False)
        self.cls_y = nn.Linear(gau["hidden_dims"], int(input_size[1] * simcc_split_ratio), bias=False)

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats  # (B, C, h, w)
        x = self.final_layer(x.float())
        x = self.gau(self.mlp(torch.flatten(x, 2)))  # (B, K, h * w) tokens
        return self.cls_x(x), self.cls_y(x)
