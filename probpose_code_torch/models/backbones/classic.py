"""The classic CNN backbones in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/classic.py``: ``make_divisible``
(``:27``, the port's copy in ``mobilenet_v2.py``), ``channel_shuffle``
(``:36``), ``ShuffleUnitV1`` / ``ShuffleNetV1`` (``:45``, ``:75``),
``ShuffleUnitV2`` / ``ShuffleNetV2`` (``:102``, ``:127``), ``SELayer``
(``:157``) and the hard swish (``:172``), ``VGG`` (``:233``), ``AlexNet``
(``:260``), ``SEBottleneck`` (``:281``), ``SCBottleneck`` (``:312``) and
``_ResNetLike`` with ``SEResNet``, ``SEResNeXt`` and ``SCNet`` (``:345-395``).
``MobileNetV3`` and ``RegNet``, which no shipped config sets, are not ported.

Names (under ``backbone.``), mmpose's as far as its modules are known here
(no mmpose checkpoint of these families is in the repository to check them):

- ``ConvModule``: ``{name}.conv`` and ``{name}.bn`` (mmcv's ConvModule);
- ``SELayer``: ``{name}.conv1.conv`` and ``{name}.conv2.conv``, 1x1 convs with
  a bias (mmpose's ``SELayer`` of two ConvModules); the JAX layer's ``Dense``
  ``fc1`` / ``fc2`` are the same products. Its width is the JAX layer's,
  ``make_divisible(channels // ratio, 8)``, where mmpose's is
  ``int(channels / ratio)`` (they differ where that is not a multiple of 8,
  in ViPNAS-MobileNetV3);
- SEResNet / SEResNeXt: the ResNet stem ``conv1`` / ``bn1``, blocks
  ``layer{s}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``, ``.se_layer`` and
  ``.downsample.{0,1}``;
- SCNet: the same stem; blocks ``conv1`` / ``bn1`` and ``k1.{0,1}`` (the plain
  branch), ``conv2`` / ``bn2`` and ``scconv.k2.{1,2}``, ``scconv.k3.{0,1}``,
  ``scconv.k4.{0,1}`` (the self-calibrated branch), ``conv3`` / ``bn3``,
  ``downsample.{0,1}``;
- ShuffleNetV1: ``conv1``, ``layers.{i}.{b}.g_conv_1x1_compress``,
  ``.depthwise_conv3x3_bn``, ``.g_conv_1x1_expand`` (ConvModules);
- ShuffleNetV2: ``conv1``, ``layers.{i}.{b}.branch1.{0,1}`` (strided units),
  ``.branch2.{0,1,2}``, and the last 1x1 conv ``layers.3``;
- VGG: ``features.{j}``, the ConvModules and max pools of all stages in
  one sequence; AlexNet: ``features.{0,3,6,8,10}``, plain convs with a bias.

Where the JAX modules depart from mmpose, the port follows the JAX modules:
SCNet's gate resizes its pooled branch bilinearly (``jax.image.resize``,
half-pixel centres: ``F.interpolate(mode="bilinear", align_corners=False)``,
an upsample, so JAX's antialiasing does nothing; on the card the kernels of
``csrc/sc_gate.cu``) where mmpose's ``SCConv`` may take ``F.interpolate``'s
nearest; ShuffleNetV1 shuffles before the
depthwise conv, mmpose after it; VGG's convs before BatchNorm carry no bias.

Every "SAME" convolution of the JAX modules pads ``k // 2`` on each side here,
as mmpose does: at stride 2 on an even side the JAX "SAME" pads only after
the input, so the two agree only where every strided input is odd (sides
32k + 1). ResNet-style explicit paddings agree everywhere. Convolutions run in
``dtype``, BatchNorm (flax's training semantics, eps 1e-5) in f32; the outputs
are f32.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.hrnet import Blocks, Bottleneck, _bn, _conv, _run
from probpose_code_torch.models.backbones.mobilenet_v2 import make_divisible
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import conv_in
from probpose_code_torch.ops.kernels.sc_gate import self_calibration
from probpose_code_torch.ops.kernels.se_layer import hsigmoid, se_layer
from probpose_code_torch.registry import MODELS


def hswish(x: torch.Tensor) -> torch.Tensor:
    return x * hsigmoid(x)


ACTIVATIONS = {None: lambda x: x, "ReLU": torch.relu, "HSwish": hswish}


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, C, H, W): channel ``g * (C / groups) + i`` moves to ``i * groups + g``."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class ConvModule(nn.Module):
    """mmcv's ConvModule: a conv (``k // 2`` padding) under ``conv``, BatchNorm
    under ``bn`` (a conv with a bias and no BatchNorm where ``bn`` is False),
    then ``act`` (``ACTIVATIONS``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, act: Optional[str] = "ReLU",
                 bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups, bias=not bn)
        self.bn = _bn(cout) if bn else None
        self.act = ACTIVATIONS[act]

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = conv_in(self.conv, x, dtype)
        return self.act(self.bn(x.float()) if self.bn is not None else x)


class SELayer(nn.Module):
    """Squeeze and excite: the spatial mean, a 1x1 conv to ``mid`` channels
    (by default ``make_divisible(channels // ratio, 8)``; LiteHRNet's spatial
    weighting takes ``max(1, int(channels / ratio))``), ReLU, a 1x1 conv back,
    sigmoid (or the hard sigmoid), times the input."""

    def __init__(self, channels: int, ratio: int = 16, hard: bool = False, mid: Optional[int] = None):
        super().__init__()
        mid = mid or make_divisible(channels // ratio, 8)
        self.conv1 = nn.ModuleDict(dict(conv=nn.Conv2d(channels, mid, 1)))
        self.conv2 = nn.ModuleDict(dict(conv=nn.Conv2d(mid, channels, 1)))
        self.hard = hard

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``ops/kernels/se_layer.py:se_layer``: on the card its kernels, on
        the CPU its plain twin; in f32 (no config runs it in another type:
        ``ValueError``; f64 for the tests' gradients)."""
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"SELayer: the layer runs in float32, not {dtype}")
        c1, c2 = self.conv1["conv"], self.conv2["conv"]
        return se_layer(x.float(), c1.weight.flatten(1), c1.bias, c2.weight.flatten(1), c2.bias, self.hard)


# -- SEResNet, SEResNeXt, SCNet -------------------------------------------------------


class SEBottleneck(Bottleneck):
    """ResNet's bottleneck with ``se_layer`` on its residual branch; with
    ``groups > 1`` SEResNeXt's, its 3x3 ``groups * width_per_group *
    channels // 64`` wide."""

    def __init__(self, cin: int, channels: int, stride: int = 1, se_ratio: int = 16, groups: int = 1,
                 width_per_group: int = 4):
        width = channels if groups == 1 else groups * width_per_group * channels // 64
        super().__init__(cin, channels, stride, groups=groups, width=width)
        self.se_layer = SELayer(channels * self.expansion, se_ratio)

    def residual(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.se_layer(super().residual(x, dtype), dtype)


class SCConv(nn.Module):
    """The self-calibrated branch after ``conv2``: ``k4(k3(x) * gate)`` with
    ``gate = sigmoid(x + up(k2(avg_pool_r(x))))``: ``self_calibration``, the
    kernels of ``csrc/sc_gate.cu`` on the card, their plain twin on the
    CPU."""

    def __init__(self, channels: int, stride: int, pooling_r: int):
        super().__init__()
        self.k2 = nn.Sequential(nn.AvgPool2d(pooling_r, pooling_r), _conv(channels, channels, 3), _bn(channels))
        self.k3 = nn.Sequential(_conv(channels, channels, 3), _bn(channels))
        self.k4 = nn.Sequential(_conv(channels, channels, 3, stride), _bn(channels), nn.ReLU())

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        gated = self_calibration(x.float(), _run(self.k2, x, dtype).float(), _run(self.k3, x, dtype).float())
        return _run(self.k4, gated, dtype)


class SCBottleneck(nn.Module):
    """SCNet's bottleneck: the plain 3x3 branch ``k1`` and the self-calibrated
    ``scconv``, each ``channels // 2`` wide, concatenated into ``conv3``."""

    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1, pooling_r: int = 4):
        super().__init__()
        out = channels * self.expansion
        mid = channels // 2
        self.conv1 = _conv(cin, mid, 1)
        self.bn1 = _bn(mid)
        self.k1 = nn.Sequential(_conv(mid, mid, 3, stride), _bn(mid), nn.ReLU())
        self.conv2 = _conv(cin, mid, 1)
        self.bn2 = _bn(mid)
        self.scconv = SCConv(mid, stride, pooling_r)
        self.conv3 = _conv(2 * mid, out, 1)
        self.bn3 = _bn(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), _bn(out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        a = _run(self.k1, torch.relu(self.bn1(conv_in(self.conv1, x, dtype).float())), dtype)
        b = self.scconv(torch.relu(self.bn2(conv_in(self.conv2, x, dtype).float())), dtype)
        y = self.bn3(conv_in(self.conv3, torch.cat([a.float(), b.float()], dim=1), dtype).float())
        identity = x if self.downsample is None else _run(self.downsample, x, dtype)
        return torch.relu(y + identity.float())


class ResNetLike(nn.Module):
    """The JAX ``_ResNetLike``: a 7x7 stride-2 stem of 64, a 3x3 stride-2 max
    pool, and four stages of ``block`` at widths 64-512 (depths 50, 101,
    152); the first block of a stage strided."""

    block: Any = None
    STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (3,), strides: Sequence[int] = (1, 2, 2, 2),
                 dtype: Any = "float32", **block_kwargs):
        super().__init__()
        if depth not in self.STAGE_BLOCKS:
            raise KeyError(f"invalid depth {depth} for {type(self).__name__}")
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        cin, channels = 64, 64
        for s, n in enumerate(self.STAGE_BLOCKS[depth]):
            blocks = []
            for b in range(n):
                blocks.append(self.block(cin, channels, strides[s] if b == 0 else 1, **block_kwargs))
                cin = channels * self.block.expansion
            setattr(self, f"layer{s + 1}", Blocks(*blocks))
            channels *= 2

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices``; ``generator`` is
        accepted for the estimator's call and unused."""
        x = F.max_pool2d(torch.relu(self.bn1(conv_in(self.conv1, x, self.dtype).float())), 3, 2, 1)
        outs = []
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x, self.dtype)
            if s in self.out_indices:
                outs.append(x.float())
        return tuple(outs)


@MODELS.register_module()
class SEResNet(ResNetLike):
    block = SEBottleneck


@MODELS.register_module()
class SEResNeXt(ResNetLike):
    """SEResNet with grouped bottlenecks, 32x4d by default."""

    block = SEBottleneck

    def __init__(self, depth: int = 50, groups: int = 32, width_per_group: int = 4, **kwargs):
        super().__init__(depth, groups=groups, width_per_group=width_per_group, **kwargs)


@MODELS.register_module()
class SCNet(ResNetLike):
    block = SCBottleneck


# -- ShuffleNet -----------------------------------------------------------------------


class Stage(nn.Sequential):
    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for block in self:
            x = block(x, dtype)
        return x


class ShuffleUnitV1(nn.Module):
    """A grouped 1x1 to ``out_channels // 4`` (ungrouped in the first unit),
    the channel shuffle, a depthwise 3x3 and a grouped 1x1: added to the
    input, or at stride 2 concatenated after its 3x3 average pool."""

    def __init__(self, cin: int, cout: int, groups: int, first_block: bool, concat: bool):
        super().__init__()
        mid = cout // 4
        self.groups, self.concat = groups, concat
        self.g_conv_1x1_compress = ConvModule(cin, mid, 1, groups=1 if first_block else groups)
        self.depthwise_conv3x3_bn = ConvModule(mid, mid, 3, 2 if concat else 1, groups=mid, act=None)
        self.g_conv_1x1_expand = ConvModule(mid, cout - cin if concat else cout, 1, groups=groups, act=None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = channel_shuffle(self.g_conv_1x1_compress(x, dtype), self.groups)
        y = self.g_conv_1x1_expand(self.depthwise_conv3x3_bn(y, dtype), dtype).float()
        if self.concat:
            return torch.relu(torch.cat([F.avg_pool2d(x.float(), 3, 2, 1), y], dim=1))
        return torch.relu(x.float() + y)


@MODELS.register_module()
class ShuffleNetV1(nn.Module):
    CHANNELS = {1: (144, 288, 576), 2: (200, 400, 800), 3: (240, 480, 960), 4: (272, 544, 1088),
                8: (384, 768, 1536)}

    def __init__(self, groups: int = 3, widen_factor: float = 1.0, out_indices: Sequence[int] = (2,),
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        cin = int(24 * widen_factor)
        self.conv1 = ConvModule(3, cin, 3, 2)
        self.layers = nn.ModuleList()
        for i, n in enumerate((4, 8, 4)):
            cout = make_divisible(self.CHANNELS[groups][i] * widen_factor, 8)
            stage = Stage()
            for b in range(n):
                stage.append(ShuffleUnitV1(cin, cout, groups, first_block=i == 0 and b == 0, concat=b == 0))
                cin = cout
            self.layers.append(stage)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = F.max_pool2d(self.conv1(x, self.dtype), 3, 2, 1)
        outs = []
        for i, stage in enumerate(self.layers):
            x = stage(x, self.dtype)
            if i in self.out_indices:
                outs.append(x.float())
        return tuple(outs)


class ShuffleUnitV2(nn.Module):
    """Stride 1: the input's second half through ``branch2``, concatenated to
    its first; stride 2: ``branch1`` (a depthwise 3x3 and a 1x1) and
    ``branch2`` (1x1, depthwise 3x3, 1x1) on the whole input. Then the
    shuffle of two groups."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        branch = cout // 2
        self.stride = stride
        if stride > 1:
            self.branch1 = Stage(ConvModule(cin, cin, 3, stride, groups=cin, act=None), ConvModule(cin, branch, 1))
        self.branch2 = Stage(ConvModule(cin if stride > 1 else branch, branch, 1),
                             ConvModule(branch, branch, 3, stride, groups=branch, act=None),
                             ConvModule(branch, branch, 1))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.stride > 1:
            x1, x2 = self.branch1(x, dtype), x
        else:
            x1, x2 = x.chunk(2, dim=1)
        return channel_shuffle(torch.cat([x1.float(), self.branch2(x2, dtype).float()], dim=1), 2)


@MODELS.register_module()
class ShuffleNetV2(nn.Module):
    CHANNELS = {0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024), 1.5: (176, 352, 704, 1024),
                2.0: (244, 488, 976, 2048)}

    def __init__(self, widen_factor: float = 1.0, out_indices: Sequence[int] = (3,), dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.out_indices = tuple(out_indices)
        channels = self.CHANNELS[widen_factor]
        cin = 24
        self.conv1 = ConvModule(3, cin, 3, 2)
        self.layers = nn.ModuleList()
        for i, n in enumerate((4, 8, 4)):
            self.layers.append(Stage(*[ShuffleUnitV2(cin if b == 0 else channels[i], channels[i], 2 if b == 0 else 1)
                                       for b in range(n)]))
            cin = channels[i]
        if 3 in self.out_indices:  # the JAX module builds the last 1x1 conv only for its output
            self.layers.append(ConvModule(cin, channels[3], 1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = F.max_pool2d(self.conv1(x, self.dtype), 3, 2, 1)
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer(x, self.dtype)
            if i in self.out_indices:
                outs.append(x.float())
        return tuple(outs)


# -- VGG, AlexNet ---------------------------------------------------------------------


@MODELS.register_module()
class VGG(nn.Module):
    """Stages of 3x3 ConvModules (with BatchNorm, or with a bias and none)
    each ending in a 2x2 max pool, 64 * 2^i channels up to 512."""

    ARCH = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2), 16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}

    def __init__(self, depth: int = 16, num_stages: int = 5, out_indices: Sequence[int] = (4,), with_bn: bool = True,
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        layers, cin, self.stage_ends = [], 3, {}
        for i in range(num_stages):
            c = min(64 * 2 ** i, 512)
            for _ in range(self.ARCH[depth][i]):
                layers.append(ConvModule(cin, c, 3, bn=with_bn))
                cin = c
            layers.append(nn.MaxPool2d(2, 2))
            if i in out_indices:
                self.stage_ends[len(layers) - 1] = i
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        outs = []
        for j, layer in enumerate(self.features):
            x = layer(x, self.dtype) if isinstance(layer, ConvModule) else layer(x)
            if j in self.stage_ends:
                outs.append(x.float())
        return tuple(outs)


@MODELS.register_module()
class AlexNet(nn.Module):
    """AlexNet's feature extractor: five convs with a bias and ReLU, three
    3x3 stride-2 max pools."""

    def __init__(self, dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        return (_run(self.features, x, self.dtype).float(),)
