"""The ViPNAS backbones in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/nas_and_3d.py``:
``ViPNAS_ResNet`` (``:31``) and ``ViPNAS_MobileNetV3`` (``:80``), the
NAS-searched ResNet and inverted-residual stacks, each stage with its own
width, depth, kernel size, groups (``min(group, width)``) and attention.

``ViPNAS_ResNet``: a ``ks[0]`` stride-2 stem conv of ``wid[0]`` and a 3x3
stride-2 max pool, then four stages of bottlenecks (a 1x1 conv to
``wid * expan``, a grouped ``ks`` x ``ks`` conv, strided at a stage's first
block, a 1x1 conv to ``wid``, an SE layer where ``att``, and the 1x1
projection where the shape changes). Names: ``conv1`` / ``bn1``,
``layer{s}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``, ``.attention`` (``SELayer``:
``conv1.conv``, ``conv2.conv``) and ``.downsample.{0,1}``. mmpose's ViPNAS
attention is GCNet's ContextBlock, by a reading of mmpose not checked here;
the JAX module's, and the port's, is the SE layer.

``ViPNAS_MobileNetV3``: a ``ks[0]`` stem ConvModule with the hard swish, then
six stages of inverted residuals (a 1x1 expansion to ``wid * expan``, the
grouped ``ks`` x ``ks`` conv, an SE layer with the hard sigmoid and ratio 4
where ``att``, a linear 1x1 projection, the residual where the shape holds),
each stage's activation ReLU or the hard swish. Names: ``conv1``,
``layer{n}.expand_conv``, ``.depthwise_conv``, ``.se`` and ``.linear_conv``
(n = 1, 2, ... over all blocks), mmpose's ``InvertedResidual``. The JAX
module expands at ``expan == 1`` too, where mmpose's has no ``expand_conv``;
the port follows the JAX module.

Every convolution pads ``k // 2`` on each side (mmpose's), where the JAX
modules' "SAME" pads an even side at stride 2 only after the input: the two
agree where every strided input is odd (sides 32k + 1; ViPNAS-MobileNetV3's
fifth stride meets a side of 4 at 49).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.classic import ACTIVATIONS, ConvModule, SELayer
from probpose_code_torch.models.backbones.hrnet import Blocks, _bn, _conv, _run
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import conv_in
from probpose_code_torch.registry import MODELS


class ViPNASBottleneck(nn.Module):
    def __init__(self, cin: int, width: int, expan: int, k: int, groups: int, attention: bool, stride: int):
        super().__init__()
        mid = width * expan
        self.conv1 = _conv(cin, mid, 1)
        self.bn1 = _bn(mid)
        self.conv2 = nn.Conv2d(mid, mid, k, stride, padding=k // 2, groups=min(groups, mid), bias=False)
        self.bn2 = _bn(mid)
        self.conv3 = _conv(mid, width, 1)
        self.bn3 = _bn(width)
        self.attention = SELayer(width, 16) if attention else None
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(_conv(cin, width, 1, stride), _bn(width))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.relu(self.bn1(conv_in(self.conv1, x, dtype).float()))
        y = torch.relu(self.bn2(conv_in(self.conv2, y, dtype).float()))
        y = self.bn3(conv_in(self.conv3, y, dtype).float())
        if self.attention is not None:
            y = self.attention(y, dtype)
        identity = x if self.downsample is None else _run(self.downsample, x, dtype)
        return torch.relu(y + identity.float())


@MODELS.register_module()
class ViPNAS_ResNet(nn.Module):
    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (3,), strides: Sequence[int] = (1, 2, 2, 2),
                 wid: Sequence[int] = (48, 80, 160, 304, 608), expan: Sequence[Any] = (None, 1, 1, 1, 1),
                 dep: Sequence[Any] = (None, 4, 6, 7, 3), ks: Sequence[int] = (7, 3, 5, 5, 5),
                 group: Sequence[Any] = (None, 16, 16, 16, 16), att: Sequence[Any] = (None, True, False, True, True),
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, wid[0], ks[0], 2)
        self.bn1 = _bn(wid[0])
        cin = wid[0]
        for i in range(4):
            blocks = []
            for b in range(dep[i + 1]):
                blocks.append(ViPNASBottleneck(cin, wid[i + 1], expan[i + 1], ks[i + 1], group[i + 1], att[i + 1],
                                               strides[i] if b == 0 else 1))
                cin = wid[i + 1]
            setattr(self, f"layer{i + 1}", Blocks(*blocks))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices``; ``generator`` is
        accepted for the estimator's call and unused."""
        x = F.max_pool2d(torch.relu(self.bn1(conv_in(self.conv1, x, self.dtype).float())), 3, 2, 1)
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x, self.dtype)
            if i in self.out_indices:
                outs.append(x.float())
        return tuple(outs)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, mid: int, k: int, groups: int, attention: bool, stride: int, act: str):
        super().__init__()
        self.expand_conv = ConvModule(cin, mid, 1, act=act)
        self.depthwise_conv = ConvModule(mid, mid, k, stride, groups=min(groups, mid), act=act)
        self.se = SELayer(mid, 4, hard=True) if attention else None
        self.linear_conv = ConvModule(mid, cout, 1, act=None)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.depthwise_conv(self.expand_conv(x, dtype), dtype)
        if self.se is not None:
            y = self.se(y, dtype)
        y = self.linear_conv(y, dtype)
        return x + y if self.residual else y


@MODELS.register_module()
class ViPNAS_MobileNetV3(nn.Module):
    def __init__(self, wid: Sequence[int] = (16, 16, 24, 40, 80, 112, 160), expan: Sequence[Any] = (None, 1, 5, 4, 5, 5, 6),
                 dep: Sequence[Any] = (None, 1, 4, 4, 4, 4, 4), ks: Sequence[int] = (3, 3, 7, 7, 5, 7, 5),
                 group: Sequence[Any] = (None, 8, 120, 20, 100, 280, 240),
                 att: Sequence[Any] = (None, True, True, False, True, True, True),
                 stride: Sequence[int] = (2, 1, 2, 2, 2, 1, 2),
                 act: Sequence[str] = ("HSwish", "ReLU", "ReLU", "ReLU", "HSwish", "HSwish", "HSwish"),
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        for name in act:
            if name not in ACTIVATIONS:
                raise KeyError(f"ViPNAS_MobileNetV3: activation {name} (ReLU and HSwish are ported)")
        self.conv1 = ConvModule(3, wid[0], ks[0], stride[0], act=act[0])
        self.layer_names = []
        cin = wid[0]
        for i in range(1, len(wid)):
            for b in range(dep[i]):
                self.layer_names.append(f"layer{len(self.layer_names) + 1}")
                setattr(self, self.layer_names[-1], InvertedResidual(
                    cin, wid[i], wid[i] * expan[i], ks[i], group[i], att[i], stride[i] if b == 0 else 1, act[i]))
                cin = wid[i]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> (the last block's output,); ``generator`` is
        accepted for the estimator's call and unused."""
        x = self.conv1(x, self.dtype)
        for name in self.layer_names:
            x = getattr(self, name)(x, self.dtype)
        return (x.float(),)
