"""ResNeSt backbone in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/litehrnet.py``:
``SplitAttentionConv`` (``:221``) and ``ResNeSt`` (``:250``), depths 50, 101,
152 and 200 (the JAX module has no 269: its configs raise ``KeyError``). A
deep stem of three 3x3 ConvModules of 32, 32 and 64 channels at every depth
(the first strided), a 3x3 stride-2 max pool, then four stages of
split-attention bottlenecks at widths 64-512: a 1x1 conv, the split-attention
3x3 conv, at a stage's strided first block a 3x3 stride-2 average pool
(padding counted in the mean), a 1x1 conv to 4x the width; the projection
where the shape changes takes a 2x2 average pool first at stride 2 (floored:
the module runs only where the stage's sides are even).

The split-attention conv: a grouped 3x3 conv to ``radix`` splits of the
width, BatchNorm and ReLU; the splits' sum pooled over space, ``fc1`` (no
bias), BatchNorm over the batch (``bn1``: flax's ``fc_bn``, training
statistics over the batch of pooled vectors), ReLU, ``fc2``, a softmax over
the ``radix`` splits (sigmoid at radix 1), and the splits' sum weighted by
it (``split_attention``: the kernels of ``csrc/split_attention.cu`` on the
card, their plain twin on the CPU). ``fc1`` and ``fc2`` are the JAX
``Dense`` layers as 1x1 convs.

Names (under ``backbone.``): ``stem.{0,1,2}.conv`` / ``.bn``;
``layer{s}.{b}.conv1`` / ``bn1``, ``.conv2.conv``, ``.conv2.bn0``,
``.conv2.fc1``, ``.conv2.bn1``, ``.conv2.fc2``, ``.conv3`` / ``bn3`` and
``.downsample.{0,1}`` (``.downsample.{1,2}`` behind the pool): mmpose's, as
far as they are known here. Where the JAX module departs from mmpose's the
port follows it: the stem is 32/32/64 at every depth and ``fc1`` has no
bias. The first stem conv's "SAME" padding in the JAX module pads an even
side only after the input; the port pads one pixel on each side, as mmpose
does.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.classic import ConvModule, Stage
from probpose_code_torch.models.backbones.hrnet import Blocks, _bn, _conv, _run
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import conv_in
from probpose_code_torch.ops.kernels.split_attention import split_attention
from probpose_code_torch.registry import MODELS


class SplitAttentionConv(nn.Module):
    def __init__(self, channels: int, radix: int = 2, groups: int = 1, reduction_factor: int = 4):
        super().__init__()
        self.radix, self.channels = radix, channels
        inter = max(channels * radix // reduction_factor, 32)
        self.conv = nn.Conv2d(channels, channels * radix, 3, padding=1, groups=groups * radix, bias=False)
        self.bn0 = _bn(channels * radix)
        self.fc1 = nn.Conv2d(channels, inter, 1, bias=False)
        self.bn1 = _bn(inter)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.relu(self.bn0(conv_in(self.conv, x, dtype).float()))
        B, _, H, W = y.shape
        splits = y.view(B, self.radix, self.channels, H, W)
        gap = splits.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        g = torch.relu(self.bn1(conv_in(self.fc1, gap, dtype).float()))
        logits = conv_in(self.fc2, g, dtype).float().view(B, self.radix, self.channels)
        return split_attention(splits, logits)


class SplitAttentionBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int, radix: int, groups: int):
        super().__init__()
        out = width * self.expansion
        self.stride = stride
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = SplitAttentionConv(width, radix, groups)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or cin != out:
            pool = [nn.AvgPool2d(2, 2)] if stride != 1 else []
            self.downsample = nn.Sequential(*pool, _conv(cin, out, 1), _bn(out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.conv2(torch.relu(self.bn1(conv_in(self.conv1, x, dtype).float())), dtype)
        if self.stride > 1:
            y = F.avg_pool2d(y, 3, self.stride, 1)
        y = self.bn3(conv_in(self.conv3, y, dtype).float())
        identity = x if self.downsample is None else _run(self.downsample, x, dtype)
        return torch.relu(y + identity.float())


@MODELS.register_module()
class ResNeSt(nn.Module):
    STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3), 200: (3, 24, 36, 3)}

    def __init__(self, depth: int = 50, radix: int = 2, groups: int = 1, out_indices: Sequence[int] = (3,),
                 dtype: Any = "float32"):
        super().__init__()
        if depth not in self.STAGE_BLOCKS:
            raise KeyError(f"ResNeSt: depth {depth} is not one of the JAX module's {tuple(self.STAGE_BLOCKS)}")
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        self.stem = Stage(ConvModule(3, 32, 3, 2), ConvModule(32, 32, 3), ConvModule(32, 64, 3))
        cin, width = 64, 64
        for s, n in enumerate(self.STAGE_BLOCKS[depth]):
            blocks = []
            for b in range(n):
                blocks.append(SplitAttentionBottleneck(cin, width, 2 if s > 0 and b == 0 else 1, radix, groups))
                cin = width * 4
            setattr(self, f"layer{s + 1}", Blocks(*blocks))
            width *= 2

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W), H and W multiples of 32 -> the stages of
        ``out_indices``; ``generator`` is accepted for the estimator's call
        and unused."""
        x = F.max_pool2d(self.stem(x, self.dtype), 3, 2, 1)
        outs = []
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x, self.dtype)
            if s in self.out_indices:
                outs.append(x.float())
        return tuple(outs)
