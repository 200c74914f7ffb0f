"""CSPNeXt backbone in PyTorch (RTMPose), with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/cspnext.py``: ``ConvModule``
(``:27``), ``DepthwiseSeparableConv`` (``:53``), ``ChannelAttention``
(``:66``), ``CSPNeXtBlock`` (``:78``), ``SPPBottleneck`` (``:97``),
``CSPLayer`` (``:115``) and ``CSPNeXt`` (``:157``), arch ``P5`` or ``P6``.
A stem of three 3x3 ConvModules (the first strided), then each stage: a
strided 3x3 ConvModule, an SPP bottleneck in the last stage, and a CSP
layer whose blocks are a 3x3 ConvModule and a 5x5 depthwise-separable one
with a residual, its halves concatenated, weighed by channel attention
(global mean, a 1x1 conv with bias, hardsigmoid) and fused by a 1x1
ConvModule. A ConvModule is conv (no bias; torch pads ``k // 2`` on both
sides, also when strided), BatchNorm (eps 1e-3, momentum 0.03, trained as
flax's) and SiLU. ``deepen_factor`` and ``widen_factor`` pick the variant
(RTMPose-m: 0.67, 0.75). Names: ``backbone.stem.{0,1,2}.{conv,bn}``,
``backbone.stage{s}.0`` (the strided conv), ``.1`` the SPP bottleneck
(``conv1``, ``conv2``) where there is one, then the CSP layer
(``main_conv``, ``short_conv``, ``final_conv``, ``blocks.{n}.conv1``,
``blocks.{n}.conv2.depthwise_conv`` / ``pointwise_conv``, ``attention.fc``),
the names the JAX package's ``convert_torch_cspnext_backbone``
(``engine/checkpoint.py:183``) reads. f32 throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d
from probpose_code_torch.registry import MODELS


class ConvModule(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class DepthwiseSeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, k, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x))


class ChannelAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * F.hardsigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class CSPNeXtBlock(nn.Module):
    def __init__(self, cin: int, cout: int, expansion: float = 0.5, add_identity: bool = True, k: int = 5):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = ConvModule(cin, hidden, 3)
        self.conv2 = DepthwiseSeparableConv(hidden, cout, k)
        self.add_identity = add_identity and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class SPPBottleneck(nn.Module):
    """Max pools at each kernel size in parallel (not SPPF's chain), each
    over the same input, concatenated with it."""

    def __init__(self, cin: int, cout: int, kernel_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        mid = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvModule(cin, mid, 1)
        self.conv2 = ConvModule(mid * (len(self.kernel_sizes) + 1), cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in self.kernel_sizes]
        return self.conv2(torch.cat([x, *pools], dim=1))


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, expand_ratio: float = 0.5, num_blocks: int = 1,
                 add_identity: bool = True, channel_attention: bool = True):
        super().__init__()
        mid = int(cout * expand_ratio)
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.final_conv = ConvModule(2 * mid, cout, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, mid, 1.0, add_identity) for _ in range(num_blocks)])
        self.attention = ChannelAttention(2 * mid) if channel_attention else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_short = self.short_conv(x)
        x_main = self.blocks(self.main_conv(x))
        x_final = torch.cat([x_main, x_short], dim=1)
        if self.attention is not None:
            x_final = self.attention(x_final)
        return self.final_conv(x_final)


ARCH_SETTINGS = {
    # in_channels, out_channels, num_blocks, add_identity, use_spp
    "P5": [[64, 128, 3, True, False], [128, 256, 6, True, False], [256, 512, 6, True, False],
           [512, 1024, 3, False, True]],
    "P6": [[64, 128, 3, True, False], [128, 256, 6, True, False], [256, 512, 6, True, False],
           [512, 768, 3, True, False], [768, 1024, 3, False, True]],
}


@MODELS.register_module()
class CSPNeXt(nn.Module):
    def __init__(self, arch: str = "P5", deepen_factor: float = 1.0, widen_factor: float = 1.0,
                 out_indices: Sequence[int] = (4,), expand_ratio: float = 0.5,
                 spp_kernel_sizes: Sequence[int] = (5, 9, 13), channel_attention: bool = True,
                 in_channels: int = 3):
        super().__init__()
        arch_setting = ARCH_SETTINGS[arch]
        self.out_indices = tuple(out_indices)
        stem_ch = int(arch_setting[0][0] * widen_factor // 2)
        self.stem = nn.Sequential(ConvModule(in_channels, stem_ch, 3, 2), ConvModule(stem_ch, stem_ch, 3),
                                  ConvModule(stem_ch, stem_ch * 2, 3))
        cin = stem_ch * 2
        widths = [cin]
        self.num_stages = len(arch_setting)
        for i, (_, out_ch, num_blocks, add_identity, use_spp) in enumerate(arch_setting):
            out_ch = int(out_ch * widen_factor)
            num_blocks = max(round(num_blocks * deepen_factor), 1)
            stage = [ConvModule(cin, out_ch, 3, 2)]
            if use_spp:
                stage.append(SPPBottleneck(out_ch, out_ch, spp_kernel_sizes))
            stage.append(CSPLayer(out_ch, out_ch, expand_ratio, num_blocks, add_identity, channel_attention))
            setattr(self, f"stage{i + 1}", nn.Sequential(*stage))
            cin = out_ch
            widths.append(out_ch)
        # the widths of the outputs, which a neck or head takes where its config's widths differ
        self.out_channels = tuple(widths[i] for i in self.out_indices)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices`` (0 is the stem);
        ``generator`` is accepted for the estimator's call and unused."""
        x = self.stem(x.float())
        outs = [x] if 0 in self.out_indices else []
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"stage{i}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
