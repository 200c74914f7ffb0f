"""ResNet backbone in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/resnet.py``: ``ResBasicBlock``
(``:52``), ``ResBottleneck`` (``:74``) and ``ResNet`` (``:113``) at depths
18-152 (``ARCH_SETTINGS``): a 7x7 stride-2 stem, a 3x3 stride-2 max pool,
then four stages of basic or bottleneck blocks, the first block of a stage
strided (on the bottleneck's 3x3 conv, mmpose's ``style="pytorch"``) and
given a 1x1 projection where the shape changes. The blocks are HRNet's
(``hrnet.py:BasicBlock``, ``Bottleneck``), which carry the same names:
``backbone.conv1`` / ``bn1`` for the stem, ``backbone.layer{s}.{i}.conv{1,2,3}``
/ ``bn{1,2,3}`` and ``.downsample.{0,1}`` for the blocks, the names the JAX
package's ``convert_torch_resnet_backbone`` (``engine/checkpoint.py:839``)
reads, so mmpose checkpoints load with ``strict=True``. BatchNorm trains as
flax's does (eps 1e-5). Convolutions run in ``dtype``, BatchNorm in f32; the
outputs (the stages of ``out_indices``) are f32.

The JAX ResNet's ``deep_stem``, grouped convolutions (ResNeXt), frozen
stages and FrozenBatchNorm are not ported: they raise.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.hrnet import BasicBlock, Blocks, Bottleneck, _bn, _conv
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import conv_in
from probpose_code_torch.registry import MODELS

ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@MODELS.register_module()
class ResNet(nn.Module):
    def __init__(self, depth: int = 50, in_channels: int = 3, stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2), out_indices: Sequence[int] = (3,),
                 deep_stem: bool = False, groups: int = 1, width_per_group: int = 64, norm_cfg: Any = None,
                 frozen_stages: int = -1, dtype: Any = "float32"):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for ResNet")
        if deep_stem or groups != 1 or width_per_group != 64 or norm_cfg or frozen_stages >= 0:
            raise NotImplementedError("ResNet: deep_stem, grouped convolutions, FrozenBatchNorm and frozen stages "
                                      "are not ported yet")
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.conv1 = _conv(in_channels, stem_channels, 7, 2)
        self.bn1 = _bn(stem_channels)
        cin, channels = stem_channels, base_channels
        self.stage_names = []
        for s in range(num_stages):
            blocks = []
            for b in range(stage_blocks[s]):
                blocks.append(block(cin, channels, strides[s] if b == 0 else 1))
                cin = channels * block.expansion
            self.stage_names.append(f"layer{s + 1}")
            setattr(self, f"layer{s + 1}", Blocks(*blocks))
            channels *= 2

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices``; ``generator`` is
        accepted for the estimator's call and unused."""
        x = torch.relu(self.bn1(conv_in(self.conv1, x, self.dtype).float()))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s, name in enumerate(self.stage_names):
            x = getattr(self, name)(x, self.dtype)
            if s in self.out_indices:
                outs.append(x.float())
        return tuple(outs)
