"""MobileNetV2 backbone in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/mobilenet_v2.py:29-96``
(reference ``mmpose/models/backbones/mobilenet_v2.py``): a 3x3 stride-2
stem, seven stages of inverted residual blocks (``ARCH_SETTINGS``: a 1x1
expansion by the stage's ratio but in the first, a 3x3 depthwise conv, a
linear 1x1 projection; the residual where the shape holds), then a 1x1 conv
to 1280 channels (``1280 * widen_factor`` above a factor of 1), each conv
followed by BatchNorm (eps 1e-5, flax's training semantics) and ReLU6 but
the projections; the depthwise convs are the kernels of
``csrc/depthwise.cu`` on the card (``ops/kernels/depthwise.py``), their
plain twin on the CPU. Names: ``backbone.conv1.{conv,bn}``,
``backbone.layer{s}.{b}.conv.{j}.{conv,bn}`` (j = 0 the expansion, 1 the
depthwise conv, 2 the projection; without an expansion 0 and 1) and
``backbone.conv2.{conv,bn}``.

Two departures from the JAX module, both mmpose's: ``out_indices`` count
mmpose's eight stages (0-6 the inverted-residual stages, 7 the last 1x1
conv), where the JAX module's count the stem first (its 7 is the seventh
stage, 320 channels, and 8 the last conv): the shipped configs' ``(7,)``
feed a head of ``in_channels=1280``. And the stride-2 convs pad one pixel
on each side, as mmpose's (and the JAX ResNet's and HRNet's) do, where the
JAX module's "SAME" pads an even input only after it. On an input whose
sides stay odd at every stride-2 conv (257 = 2^8 + 1 and 65, say) the two
paddings agree.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d, conv_in
from probpose_code_torch.ops.kernels.depthwise import depthwise_conv3x3
from probpose_code_torch.registry import MODELS

# expand_ratio, channels, num_blocks, stride
ARCH_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                 (6, 320, 1, 1))


def make_divisible(value: float, divisor: int = 8) -> int:
    new = max(divisor, int(value + divisor / 2) // divisor * divisor)
    return new + divisor if new < 0.9 * value else new


class ConvModule(nn.Module):
    """mmcv's conv + BatchNorm (+ ReLU6) under ``conv`` and ``bn``; a
    depthwise 3x3 conv (one group a channel) runs ``depthwise_conv3x3``, the
    kernels of ``csrc/depthwise.cu`` on the card."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-5, momentum=0.1)
        self.act = act
        self.depthwise = groups > 1

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.depthwise:
            x = depthwise_conv3x3(x, self.conv.weight, self.conv.stride[0])
        else:
            x = conv_in(self.conv, x, dtype)
        x = self.bn(x.float())
        return torch.clamp(x, 0.0, 6.0) if self.act else x


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        layers = [ConvModule(cin, hidden, 1)] if expand_ratio != 1 else []
        layers += [ConvModule(hidden, hidden, 3, stride, groups=hidden), ConvModule(hidden, cout, 1, act=False)]
        self.conv = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = x
        for layer in self.conv:
            out = layer(out, dtype)
        return x + out if self.use_res else out


class Stage(nn.ModuleList):
    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for block in self:
            x = block(x, dtype)
        return x


@MODELS.register_module()
class MobileNetV2(nn.Module):
    def __init__(self, widen_factor: float = 1.0, out_indices: Sequence[int] = (7,), frozen_stages: int = -1,
                 norm_eval: bool = False, with_cp: bool = False, dtype: Any = "float32", **kwargs):
        super().__init__()
        if frozen_stages >= 0 or norm_eval or kwargs.get("conv_cfg") or kwargs.get("norm_cfg") \
                or kwargs.get("act_cfg"):
            raise NotImplementedError("MobileNetV2: frozen stages, norm_eval and other conv, norm or activation "
                                      "layers are not ported")
        if not all(0 <= i < 8 for i in out_indices):
            raise ValueError(f"MobileNetV2: out_indices {tuple(out_indices)} out of range(8)")
        self.dtype = resolve_dtype(dtype)
        if self.dtype != torch.float32:
            raise NotImplementedError("MobileNetV2: float32 only (its depthwise kernels are f32)")
        self.out_indices = tuple(out_indices)
        cin = make_divisible(32 * widen_factor)
        self.conv1 = ConvModule(3, cin, 3, 2)
        self.stage_names = []
        for i, (expand, channels, blocks, stride) in enumerate(ARCH_SETTINGS):
            cout = make_divisible(channels * widen_factor)
            stage = Stage()
            for b in range(blocks):
                stage.append(InvertedResidual(cin, cout, stride if b == 0 else 1, expand))
                cin = cout
            self.stage_names.append(f"layer{i + 1}")
            setattr(self, f"layer{i + 1}", stage)
        self.conv2 = ConvModule(cin, int(1280 * widen_factor) if widen_factor > 1.0 else 1280, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices`` in f32;
        ``generator`` is accepted for the estimator's call and unused."""
        x = self.conv1(x, self.dtype)
        outs = []
        for i, name in enumerate(self.stage_names + ["conv2"]):
            x = getattr(self, name)(x, self.dtype)
            if i in self.out_indices:
                outs.append(x.float())
        return tuple(outs)
