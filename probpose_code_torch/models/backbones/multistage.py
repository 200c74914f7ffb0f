"""Multi-stage backbones in PyTorch: HourglassNet, CPM, MSPN and RSN.

Port of ``probpose_code_tpu/models/backbones/multistage.py``: ``ConvBNReLU``
(``:29``, mmcv's ConvModule: ``classic.ConvModule``, ``k // 2`` padding),
``_ResLayer`` (``:46``), ``HourglassModule`` (``:66``), ``HourglassNet``
(``:93``), ``CPM`` (``:192-232``), ``RSB`` (``:234``), ``_UpsampleUnit``
(``:275``), ``_SingleStage`` (``:303``), ``_MultiStageBase`` (``:353``),
``MSPN`` and ``RSN`` (``:393``, ``:400``). BatchNorm trains as flax's does
(eps 1e-5); convolutions run in ``dtype``, the outputs are f32.

``HourglassNet``: a 7x7 stride-2 ``ConvModule`` to 128 channels and a
strided basic block to ``stage_channels[0]`` (the stem), then ``num_stacks``
recursive hourglasses (``up1`` beside ``low1`` (strided), ``low2`` (the next
hourglass, or blocks at the bottom) and ``low3``, its output repeated 2x2 and
added to ``up1``), each followed by a 3x3 ``ConvModule`` to ``feat_channel``
(``out_convs``); between stacks the input and the output remapped by 1x1
``ConvModule``s without ReLU, summed, ReLU and one basic block. Returns one
map a stack. Each side must be a multiple of 4 * 2 ** ``downsample_times``
(the repeat meets the skip). As in the JAX module, ``low3``'s first block
takes the channel change (mmpose's ``downsample_first=False`` puts it on the
last block, by a reading of mmpose).

``CPM``: the stem (three 9x9 ``ConvModule``s each followed by a 3x3 stride-2
max pool padded by 1, then 5x5 to 32, 9x9 to 512, 1x1 to 512, and a 1x1 conv
with a bias to ``out_channels``) gives the first belief map; the middle
branch (three 9x9 ``ConvModule``s with pools) feeds each later stage: a 5x5
``ConvModule`` to ``middle_channels`` (``middle_conv``), concatenated after
the previous belief map, three 11x11 ``ConvModule``s (``cpm_stages``), a 1x1
``ConvModule`` and a 1x1 conv with a bias (``out_convs``). Returns
``num_stages`` maps at 1/8 of the input.

``MSPN`` / ``RSN``: a 7x7 stride-2 ``ConvModule`` and a 3x3 stride-2 max pool
(``top``), then ``num_stages`` U-shaped stages. A stage's down path has
``num_units`` levels of ResNet bottlenecks (MSPN) or residual steps blocks
(RSN, ``RSB``), the first block of each level but the first strided; after
the first stage each level adds the previous stage's two skips. Its up path
runs from the lowest level: a 1x1 ``ConvModule`` without ReLU (``in_skip``),
the previous unit's output resized bilinearly to this level
(``F.interpolate``, half-pixel centres, as ``jax.image.resize``) through a
1x1 ``ConvModule`` without ReLU (``up_conv``) added, ReLU; all but the last
stage give skips (``out_skip1`` of the level's input, ``out_skip2`` of the
unit's output) and, at the last unit, the next stage's input
(``cross_conv``). Returns a list over stages of lists over units (lowest
resolution first).

Names are mmpose's, as a reading of its modules gives them (no mmpose
checkpoint of these families is in the repository, so none is checked):
``backbone.stem.{0,1}``, ``hourglass_modules.{i}.{up1,low1,low2,low3}``
(``low2`` nested), ``inters.{i}``, ``conv1x1s.{i}``, ``out_convs.{i}``,
``remap_convs.{i}`` (HourglassNet); ``stem.{0,2,4,6,7,8,9}``,
``middle.{0,2,4}``, ``middle_conv.{i}.0``, ``cpm_stages.{i}.model.{j}``,
``out_convs.{i}.{0,1}`` (CPM); ``top.top.0``,
``multi_stage_mspn.{i}`` (``multi_stage_rsn`` for RSN)
``.downsample.layer{j}.{b}`` (MSPN's bottlenecks: ``conv{1,2,3}``,
``bn{1,2,3}``, ``downsample.{conv,bn}``; RSN's blocks: ``conv_bn_relu1``,
``conv_bn_relu2_{i}_{j}``, ``conv_bn3``, ``downsample``) and
``.upsample.up{j}.{in_skip,up_conv,out_skip1,out_skip2,cross_conv}``. A
``ConvModule`` keeps ``conv`` / ``bn``, a basic block ``conv1`` / ``bn1`` /
``conv2`` / ``bn2`` / ``downsample.{0,1}``. ``engine/checkpoint.py:
state_dict_from_jax`` carries the JAX variables of each onto these names.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.classic import ConvModule
from probpose_code_torch.models.backbones.hrnet import BasicBlock, Blocks, Bottleneck
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.registry import MODELS


def res_layer(cin: int, channels: int, num_blocks: int, stride: int = 1, downsample_first: bool = True) -> Blocks:
    """``_ResLayer``: basic blocks to ``channels``, the first taking ``cin``;
    the stride on the first block, or on the last."""
    blocks = []
    for b in range(num_blocks):
        s = stride if (b == 0 if downsample_first else b == num_blocks - 1) else 1
        blocks.append(BasicBlock(cin if b == 0 else channels, channels, s))
    return Blocks(*blocks)


def run_layers(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ConvModule``s with ``dtype``, max pools as they are."""
    for m in seq:
        x = m(x, dtype) if isinstance(m, ConvModule) else m(x)
    return x


class HourglassModule(nn.Module):
    def __init__(self, depth: int, stage_channels: Sequence[int], stage_blocks: Sequence[int]):
        super().__init__()
        cur_c, next_c = stage_channels[0], stage_channels[1]
        cur_b, next_b = stage_blocks[0], stage_blocks[1]
        self.up1 = res_layer(cur_c, cur_c, cur_b)
        self.low1 = res_layer(cur_c, next_c, cur_b, stride=2)
        if depth > 1:
            self.low2 = HourglassModule(depth - 1, stage_channels[1:], stage_blocks[1:])
        else:
            self.low2 = res_layer(next_c, next_c, next_b)
        self.low3 = res_layer(next_c, cur_c, cur_b, downsample_first=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        low3 = self.low3(self.low2(self.low1(x, dtype), dtype), dtype)
        b, c, h, w = low3.shape
        up2 = low3[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)
        return self.up1(x, dtype) + up2


@MODELS.register_module()
class HourglassNet(nn.Module):
    def __init__(self, downsample_times: int = 5, num_stacks: int = 2,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4), feat_channel: int = 256, in_channels: int = 3,
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.num_stacks = num_stacks
        cur_c = stage_channels[0]
        self.stem = nn.Sequential(ConvModule(in_channels, 128, 7, 2), res_layer(128, cur_c, 1, stride=2))
        self.hourglass_modules = nn.ModuleList(
            HourglassModule(downsample_times, stage_channels, stage_blocks) for _ in range(num_stacks))
        self.inters = Blocks(*[BasicBlock(cur_c, cur_c) for _ in range(num_stacks - 1)])
        self.conv1x1s = nn.ModuleList(ConvModule(cur_c, cur_c, 1, act=None) for _ in range(num_stacks - 1))
        self.out_convs = nn.ModuleList(ConvModule(cur_c, feat_channel, 3) for _ in range(num_stacks))
        self.remap_convs = nn.ModuleList(ConvModule(feat_channel, cur_c, 1, act=None) for _ in range(num_stacks - 1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """(B, 3, H, W) -> one (B, feat_channel, H / 4, W / 4) map a stack;
        ``generator`` is accepted for the estimator's call and unused."""
        dtype = self.dtype
        inter = self.stem[1](self.stem[0](x, dtype), dtype)
        outs = []
        for i in range(self.num_stacks):
            out = self.out_convs[i](self.hourglass_modules[i](inter, dtype), dtype)
            outs.append(out.float())
            if i < self.num_stacks - 1:
                inter = torch.relu(self.conv1x1s[i](inter, dtype) + self.remap_convs[i](out, dtype))
                inter = self.inters[i](inter, dtype)
        return outs


def _pool() -> nn.MaxPool2d:
    return nn.MaxPool2d(3, 2, 1)


@MODELS.register_module()
class CPM(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 17, feat_channels: int = 128,
                 middle_channels: int = 32, num_stages: int = 6, dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.stem = nn.Sequential(
            ConvModule(in_channels, 128, 9), _pool(), ConvModule(128, 128, 9), _pool(), ConvModule(128, 128, 9),
            _pool(), ConvModule(128, 32, 5), ConvModule(32, 512, 9), ConvModule(512, 512, 1),
            ConvModule(512, out_channels, 1, act=None, bn=False))
        self.middle = nn.Sequential(ConvModule(in_channels, 128, 9), _pool(), ConvModule(128, 128, 9), _pool(),
                                    ConvModule(128, 128, 9), _pool())
        self.middle_conv = nn.ModuleList(nn.Sequential(ConvModule(128, middle_channels, 5))
                                         for _ in range(num_stages - 1))
        self.cpm_stages = nn.ModuleList()
        for _ in range(num_stages - 1):
            stage = nn.Module()
            stage.model = nn.Sequential(ConvModule(middle_channels + out_channels, feat_channels, 11),
                                        ConvModule(feat_channels, feat_channels, 11),
                                        ConvModule(feat_channels, feat_channels, 11))
            self.cpm_stages.append(stage)
        self.out_convs = nn.ModuleList(
            nn.Sequential(ConvModule(feat_channels, feat_channels, 1),
                          ConvModule(feat_channels, out_channels, 1, act=None, bn=False))
            for _ in range(num_stages - 1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """(B, 3, H, W) -> ``num_stages`` (B, out_channels, H / 8, W / 8) maps;
        ``generator`` is accepted for the estimator's call and unused."""
        dtype = self.dtype
        outs = [run_layers(self.stem, x, dtype).float()]
        middle = run_layers(self.middle, x, dtype)
        for conv, stage, out in zip(self.middle_conv, self.cpm_stages, self.out_convs):
            f = torch.cat([outs[-1].to(dtype), run_layers(conv, middle, dtype).to(dtype)], dim=1)
            outs.append(run_layers(out, run_layers(stage.model, f, dtype), dtype).float())
        return outs


class MSPNBottleneck(Bottleneck):
    """The ResNet bottleneck with mmpose's MSPN projection, a ConvModule
    without ReLU (``downsample.conv`` / ``.bn``)."""

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__(cin, channels, stride)
        if self.downsample is not None:
            self.downsample = ConvModule(cin, channels * self.expansion, 1, stride, act=None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x, dtype)
        return torch.relu(self.residual(x, dtype) + identity.float())


class RSB(nn.Module):
    """Residual steps block (``:234``): a strided 1x1 ``ConvModule`` to
    ``num_steps`` branches of ``cin * expand_times // res_top_channels``
    channels; step i runs i + 1 3x3 ``ConvModule``s in a chain, each but the
    first adding the previous step's output at its depth; the steps' last
    outputs concatenated through a 1x1 ``ConvModule`` without ReLU, plus the
    input (projected where the shape changes), ReLU."""

    expansion = 1

    def __init__(self, cin: int, out_channels: int, stride: int = 1, num_steps: int = 4, expand_times: int = 26,
                 res_top_channels: int = 64):
        super().__init__()
        self.num_steps = num_steps
        branch = cin * expand_times // res_top_channels
        self.conv_bn_relu1 = ConvModule(cin, num_steps * branch, 1, stride)
        for i in range(num_steps):
            for j in range(i + 1):
                setattr(self, f"conv_bn_relu2_{i + 1}_{j + 1}", ConvModule(branch, branch, 3))
        self.conv_bn3 = ConvModule(num_steps * branch, out_channels, 1, act=None)
        self.downsample = None
        if stride != 1 or cin != out_channels:
            self.downsample = ConvModule(cin, out_channels, 1, stride, act=None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        spx = torch.chunk(self.conv_bn_relu1(x, dtype), self.num_steps, dim=1)
        rows, last = [], []
        for i in range(self.num_steps):
            row = []
            for j in range(i + 1):
                inp = spx[i] if j == 0 else row[j - 1]
                if i > j:
                    inp = inp + rows[i - 1][j]
                row.append(getattr(self, f"conv_bn_relu2_{i + 1}_{j + 1}")(inp, dtype))
            rows.append(row)
            last.append(row[i])
        out = self.conv_bn3(torch.cat(last, dim=1), dtype)
        identity = x if self.downsample is None else self.downsample(x, dtype)
        return torch.relu(out + identity.float())


class UpsampleUnit(nn.Module):
    def __init__(self, ind: int, num_units: int, cin: int, unit_channels: int, gen_skip: bool, gen_cross_conv: bool,
                 out_channels: int = 64):
        super().__init__()
        self.ind = ind
        self.in_skip = ConvModule(cin, unit_channels, 1, act=None)
        if ind > 0:
            self.up_conv = ConvModule(unit_channels, unit_channels, 1, act=None)
        self.gen_skip = gen_skip
        if gen_skip:
            self.out_skip1 = ConvModule(cin, cin, 1)
            self.out_skip2 = ConvModule(unit_channels, cin, 1)
        self.gen_cross_conv = ind == num_units - 1 and gen_cross_conv
        if self.gen_cross_conv:
            self.cross_conv = ConvModule(unit_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, up_x: Optional[torch.Tensor], dtype: torch.dtype):
        out = self.in_skip(x, dtype)
        if self.ind > 0:
            up = F.interpolate(up_x, size=tuple(x.shape[2:]), mode="bilinear", align_corners=False)
            out = out + self.up_conv(up, dtype)
        out = torch.relu(out)
        skip1 = skip2 = cross = None
        if self.gen_skip:
            skip1, skip2 = self.out_skip1(x, dtype), self.out_skip2(out, dtype)
        if self.gen_cross_conv:
            cross = self.cross_conv(out, dtype)
        return out, skip1, skip2, cross


class SingleStage(nn.Module):
    def __init__(self, block: str, has_skip: bool, gen_skip: bool, gen_cross_conv: bool, unit_channels: int,
                 num_units: int, num_blocks: Sequence[int], num_steps: int = 4, in_channels: int = 64,
                 expand_times: int = 26):
        super().__init__()
        self.has_skip, self.num_units = has_skip, num_units
        self.downsample = nn.Module()
        cin, widths = in_channels, []
        for i in range(num_units):
            out_c = in_channels * 2 ** i
            blocks = []
            for b in range(num_blocks[i]):
                s = (1 if i == 0 else 2) if b == 0 else 1
                if block == "bottleneck":
                    blocks.append(MSPNBottleneck(cin, out_c, s))
                    cin = out_c * MSPNBottleneck.expansion
                else:
                    blocks.append(RSB(cin, out_c, s, num_steps, expand_times, in_channels))
                    cin = out_c
            setattr(self.downsample, f"layer{i + 1}", Blocks(*blocks))
            widths.append(cin)
        self.upsample = nn.Module()
        for i in range(num_units):
            setattr(self.upsample, f"up{i + 1}", UpsampleUnit(i, num_units, widths[num_units - 1 - i],
                                                               unit_channels, gen_skip, gen_cross_conv,
                                                               out_channels=in_channels))

    def forward(self, x, skip1, skip2, dtype: torch.dtype):
        downs = []
        for i in range(self.num_units):
            x = getattr(self.downsample, f"layer{i + 1}")(x, dtype)
            if self.has_skip:
                x = x + skip1[i] + skip2[i]
            downs.append(x)
        downs.reverse()
        outs, s1, s2, cross = [], [], [], None
        for i in range(self.num_units):
            o, k1, k2, c = getattr(self.upsample, f"up{i + 1}")(downs[i], outs[i - 1] if i > 0 else None, dtype)
            outs.append(o)
            s1.append(k1)
            s2.append(k2)
            if c is not None:
                cross = c
        s1.reverse()
        s2.reverse()
        return outs, s1, s2, cross


class MultiStageBase(nn.Module):
    block = "bottleneck"
    stages_name = "multi_stage_mspn"

    def __init__(self, unit_channels: int = 256, num_stages: int = 4, num_units: int = 4,
                 num_blocks: Sequence[int] = (2, 2, 2, 2), num_steps: int = 4, res_top_channels: int = 64,
                 expand_times: int = 26, in_channels: int = 3, dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.top = nn.Module()
        self.top.top = nn.Sequential(ConvModule(in_channels, res_top_channels, 7, 2), _pool())
        stages = nn.ModuleList(
            SingleStage(self.block, i > 0, i != num_stages - 1, i != num_stages - 1, unit_channels, num_units,
                        tuple(num_blocks), num_steps, res_top_channels, expand_times) for i in range(num_stages))
        setattr(self, self.stages_name, stages)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> List[List[torch.Tensor]]:
        """(B, 3, H, W) -> a list over stages of ``num_units`` maps of
        ``unit_channels`` (lowest resolution first); ``generator`` is
        accepted for the estimator's call and unused."""
        x = run_layers(self.top.top, x, self.dtype)
        skip1 = skip2 = None
        feats = []
        for stage in getattr(self, self.stages_name):
            outs, skip1, skip2, x = stage(x, skip1, skip2, self.dtype)
            feats.append([o.float() for o in outs])
        return feats


@MODELS.register_module()
class MSPN(MultiStageBase):
    block = "bottleneck"
    stages_name = "multi_stage_mspn"


@MODELS.register_module()
class RSN(MultiStageBase):
    block = "rsb"
    stages_name = "multi_stage_rsn"
