"""ResNet, ResNetV1d and ResNeXt backbones in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/resnet.py``: ``FrozenBatchNorm2d``
(``:28``), ``ResBasicBlock`` (``:52``), ``ResBottleneck`` (``:74``), ``ResNet``
(``:113``) at depths 18-152 (``ARCH_SETTINGS``), ``ResNeXt`` (``:175``) and
``ResNetV1d`` (``:183``): a 7x7 stride-2 stem (or, with ``deep_stem``, three
3x3 convs of ``stem_channels / 2``, ``/ 2`` and ``stem_channels``, the first
strided), a 3x3 stride-2 max pool, then ``num_stages`` stages of basic or
bottleneck blocks, the first block of a stage strided (on the bottleneck's
3x3 conv, mmpose's ``style="pytorch"``) and given a 1x1 projection where the
shape changes. A grouped bottleneck (ResNeXt: 32 groups of 4 by default) is
``int(channels * width_per_group / 64) * groups`` wide at its 3x3.

The blocks are HRNet's (``hrnet.py:BasicBlock``, ``Bottleneck``), which carry
the same names: ``backbone.conv1`` / ``bn1`` for the stem, or
``backbone.stem.{0,1,2}.conv`` / ``.bn`` for the deep stem (mmpose's
ConvModules), ``backbone.layer{s}.{i}.conv{1,2,3}`` / ``bn{1,2,3}`` and
``.downsample.{0,1}`` for the blocks, the names the JAX package's
``convert_torch_resnet_backbone`` (``engine/checkpoint.py:839``) reads for the
7x7 stem. BatchNorm trains as flax's does (eps 1e-5). Convolutions run in
``dtype``, BatchNorm in f32; the outputs (the stages of ``out_indices``) are
f32.

``norm_cfg=dict(type="FrozenBatchNorm2d")`` makes every BatchNorm
``FrozenBatchNorm2d``; another ``norm_cfg`` is BatchNorm, as in the JAX
module. ``frozen_stages = k >= 0`` freezes the stem, and stages 1..k: their
BatchNorm keeps its running statistics in training and nothing upstream of
their outputs gets a gradient (the JAX module's ``stop_gradient``; the
optimizer reads zeros). ``ResNetV1d`` is the deep stem alone: the JAX module
has no ``avg_down`` (mmpose's ResNetV1d pools before its strided
projections).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.classic import ConvModule, Stage
from probpose_code_torch.models.backbones.hrnet import BasicBlock, Blocks, Bottleneck, _bn, _conv
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d, conv_in
from probpose_code_torch.registry import MODELS

ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class FrozenBatchNorm2d(BatchNorm2d):
    """BatchNorm whose statistics and affine parameters never change: the
    running statistics in training too, and no gradient through ``weight``
    and ``bias``. The same parameters, buffers and state-dict keys as
    BatchNorm2d."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight.detach()
        return (x.float() - self.running_mean[:, None, None]) * mul[:, None, None] + self.bias.detach()[:, None, None]


def freeze_batch_norms(module: nn.Module) -> None:
    """Replace every BatchNorm2d under ``module`` by a FrozenBatchNorm2d."""
    for name, child in module.named_children():
        if isinstance(child, nn.BatchNorm2d):
            setattr(module, name, FrozenBatchNorm2d(child.num_features, eps=child.eps, momentum=child.momentum))
        else:
            freeze_batch_norms(child)


@MODELS.register_module()
class ResNet(nn.Module):
    def __init__(self, depth: int = 50, in_channels: int = 3, stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2), out_indices: Sequence[int] = (3,),
                 deep_stem: bool = False, groups: int = 1, width_per_group: int = 64, norm_cfg: Any = None,
                 frozen_stages: int = -1, dtype: Any = "float32"):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for ResNet")
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        block, stage_blocks = ARCH_SETTINGS[depth]
        if deep_stem:
            half = stem_channels // 2
            self.stem = Stage(ConvModule(in_channels, half, 3, 2), ConvModule(half, half, 3),
                              ConvModule(half, stem_channels, 3))
        else:
            self.conv1 = _conv(in_channels, stem_channels, 7, 2)
            self.bn1 = _bn(stem_channels)
        cin, channels = stem_channels, base_channels
        self.stage_names = []
        for s in range(num_stages):
            blocks = []
            for b in range(stage_blocks[s]):
                stride = strides[s] if b == 0 else 1
                if block is Bottleneck:
                    width = int(channels * (width_per_group / 64.0)) * groups
                    blocks.append(Bottleneck(cin, channels, stride, groups=groups, width=width))
                else:
                    blocks.append(BasicBlock(cin, channels, stride))
                cin = channels * block.expansion
            self.stage_names.append(f"layer{s + 1}")
            setattr(self, f"layer{s + 1}", Blocks(*blocks))
            channels *= 2
        if norm_cfg and dict(norm_cfg).get("type") == "FrozenBatchNorm2d":
            freeze_batch_norms(self)

    def frozen_modules(self) -> List[nn.Module]:
        """The stem and the first ``frozen_stages`` stages (none below 0)."""
        if self.frozen_stages < 0:
            return []
        stem = [self.stem] if hasattr(self, "stem") else [self.conv1, self.bn1]
        return stem + [getattr(self, name) for name in self.stage_names[:self.frozen_stages]]

    def train(self, mode: bool = True) -> "ResNet":
        """Training mode but for the frozen stem and stages, whose BatchNorm
        keeps its running statistics."""
        super().train(mode)
        for m in self.frozen_modules():
            m.eval()
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices``; ``generator`` is
        accepted for the estimator's call and unused."""
        if hasattr(self, "stem"):
            x = self.stem(x, self.dtype)
        else:
            x = torch.relu(self.bn1(conv_in(self.conv1, x, self.dtype).float()))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for s, name in enumerate(self.stage_names):
            x = getattr(self, name)(x, self.dtype)
            if s < self.frozen_stages:
                x = x.detach()
            if s in self.out_indices:
                outs.append(x.float())
        return tuple(outs)


@MODELS.register_module()
class ResNeXt(ResNet):
    """ResNet with grouped 3x3 bottleneck convs, 32 groups of 4 by default."""

    def __init__(self, depth: int = 50, groups: int = 32, width_per_group: int = 4, **kwargs):
        super().__init__(depth, groups=groups, width_per_group=width_per_group, **kwargs)


@MODELS.register_module()
class ResNetV1d(ResNet):
    """ResNet with the deep 3x3 stem."""

    def __init__(self, depth: int = 50, deep_stem: bool = True, **kwargs):
        super().__init__(depth, deep_stem=deep_stem, **kwargs)
