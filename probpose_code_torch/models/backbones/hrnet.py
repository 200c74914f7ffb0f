"""HRNet backbone in PyTorch, with mmpose's state-dict names.

Port of ``probpose_code_tpu/models/backbones/hrnet.py``: ``BasicBlock``
(``:30``), ``Bottleneck`` (``:51``), the nearest upsample (``:80``),
``HRModule`` (``:86``) and ``HRNet`` (``:135``). A stem of two strided 3x3
convs, the stage-1 blocks, then for stages 2-4 a transition that adapts the
existing branches and adds one at half the resolution, and HR modules whose
fuse layers exchange the branches (a 1x1 conv and a nearest upsample from a
coarser branch, strided 3x3 convs from a finer one). The config schema is
the reference's (``extra=dict(stage1=..., stage4=...)``, ``BASIC`` and
``BOTTLENECK`` blocks); the output is the finest branch, or every branch
with ``multiscale_output`` (the argument, or ``extra.stage4``).

BatchNorm trains as flax's does (``models/heads/heatmap_head.py:
BatchNorm2d``: the running variance takes the biased batch variance). The
module names are mmpose's (``backbone.layer1.{i}.conv1``,
``backbone.transition{t}.{b}.{0,1}`` for an adapted branch and
``.{b}.0.{0,1}`` for a new one, ``backbone.stage{s}.{m}.branches.{b}.{k}``,
``backbone.stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}`` from a coarser branch and
``.{i}.{j}.{k}.{0,1}`` from a finer one), the names the JAX package's
``_convert_hrnet_model`` (``engine/checkpoint.py:1012``) reads, so mmpose
checkpoints load with ``strict=True``. Convolutions run in ``dtype``
(cuDNN's on the card) and BatchNorm in f32; the output is f32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d, conv_in
from probpose_code_torch.registry import MODELS


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


def _run(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    for m in seq:
        x = conv_in(m, x, dtype) if isinstance(m, nn.Conv2d) else m(x.float() if isinstance(m, BatchNorm2d) else x)
    return x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, channels, 3, stride)
        self.bn1 = _bn(channels)
        self.conv2 = _conv(channels, channels, 3)
        self.bn2 = _bn(channels)
        self.downsample = None
        if cin != channels or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, channels, 1, stride), _bn(channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = torch.relu(self.bn1(conv_in(self.conv1, x, dtype).float()))
        out = self.bn2(conv_in(self.conv2, out, dtype).float())
        identity = x if self.downsample is None else _run(self.downsample, x, dtype)
        return torch.relu(out + identity.float())


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided; ``groups`` groups) -> 1x1 to ``channels * 4``,
    the 3x3 ``width`` wide (``channels`` unless given: ResNeXt's and
    SEResNeXt's rules are their callers')."""

    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1, groups: int = 1, width: Optional[int] = None):
        super().__init__()
        out = channels * self.expansion
        width = width or channels
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, groups=groups, bias=False)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = _bn(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), _bn(out))

    def residual(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = torch.relu(self.bn1(conv_in(self.conv1, x, dtype).float()))
        out = torch.relu(self.bn2(conv_in(self.conv2, out, dtype).float()))
        return self.bn3(conv_in(self.conv3, out, dtype).float())

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        identity = x if self.downsample is None else _run(self.downsample, x, dtype)
        return torch.relu(self.residual(x, dtype) + identity.float())


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class Blocks(nn.Sequential):
    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for block in self:
            x = block(x, dtype)
        return x


class HRModule(nn.Module):
    """Parallel branches, then the fuse layers (every branch into each
    output branch, summed, ReLU); one output branch without
    ``multiscale_output``."""

    def __init__(self, block: str, num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int], multiscale_output: bool = True):
        super().__init__()
        block_cls = BLOCKS[block]
        n = len(num_channels)
        out_channels = [c * block_cls.expansion for c in num_channels]
        self.branches = nn.ModuleList()
        for b in range(n):
            cin, blocks = in_channels[b], []
            for _ in range(num_blocks[b]):
                blocks.append(block_cls(cin, num_channels[b]))
                cin = out_channels[b]
            self.branches.append(Blocks(*blocks))
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList()
            for i in range(n if multiscale_output else 1):
                row = []
                for j in range(n):
                    if j > i:
                        row.append(nn.Sequential(_conv(out_channels[j], out_channels[i], 1), _bn(out_channels[i]),
                                                 nn.Upsample(scale_factor=2 ** (j - i), mode="nearest")))
                    elif j < i:
                        steps = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            cout = out_channels[i] if last else out_channels[j]
                            mods = [_conv(out_channels[j], cout, 3, 2), _bn(cout)] + ([] if last else [nn.ReLU()])
                            steps.append(nn.Sequential(*mods))
                        row.append(nn.Sequential(*steps))
                    else:
                        row.append(None)
                self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        outs = [branch(x, dtype) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for row in self.fuse_layers:
            acc = None
            for j, layer in enumerate(row):
                if layer is None:
                    y = outs[j]
                elif isinstance(layer[0], nn.Conv2d):  # from a coarser branch: 1x1 conv, BN, upsample
                    y = _run(layer, outs[j], dtype)
                else:  # from a finer branch: strided convs
                    y = outs[j]
                    for step in layer:
                        y = _run(step, y, dtype)
                acc = y.float() if acc is None else acc + y.float()
            fused.append(torch.relu(acc))
        return fused


@MODELS.register_module()
class HRNet(nn.Module):
    """High-Resolution Net; ``extra`` in the reference schema."""

    def __init__(self, extra: Dict[str, Any], in_channels: int = 3, multiscale_output: bool = False,
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.conv1 = _conv(in_channels, 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = _bn(64)

        s1 = extra["stage1"]
        block_cls = BLOCKS[s1["block"]]
        cin, blocks = 64, []
        for _ in range(s1["num_blocks"][0]):
            blocks.append(block_cls(cin, s1["num_channels"][0]))
            cin = s1["num_channels"][0] * block_cls.expansion
        self.layer1 = Blocks(*blocks)

        prev = [cin]
        ms_requested = multiscale_output or bool(extra.get("stage4", {}).get("multiscale_output", False))
        for stage in (2, 3, 4):
            cfg = extra[f"stage{stage}"]
            expansion = BLOCKS[cfg["block"]].expansion
            cur = [c * expansion for c in cfg["num_channels"]]
            if len(cur) != len(prev) + 1:
                raise NotImplementedError("HRNet: a stage adds one branch (as the JAX package's HRNet)")
            transition = []
            for b in range(len(cur)):
                if b < len(prev):
                    transition.append(None if prev[b] == cur[b] else nn.Sequential(
                        _conv(prev[b], cur[b], 3), _bn(cur[b]), nn.ReLU()))
                else:
                    transition.append(nn.Sequential(nn.Sequential(_conv(prev[-1], cur[b], 3, 2), _bn(cur[b]),
                                                                  nn.ReLU())))
            setattr(self, f"transition{stage - 1}", nn.ModuleList(transition))
            modules, channels = [], cur
            for m in range(cfg["num_modules"]):
                last = m == cfg["num_modules"] - 1
                ms_out = True if stage < 4 else (ms_requested or not last)
                modules.append(HRModule(cfg["block"], cfg["num_blocks"], channels, cfg["num_channels"], ms_out))
                channels = cur if ms_out else cur[:1]
            setattr(self, f"stage{stage}", nn.ModuleList(modules))
            prev = channels

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the output branches, (B, C, H / 4, W / 4) first.
        ``generator`` is accepted for the estimator's call and unused (HRNet
        draws nothing)."""
        dt = self.dtype
        x = torch.relu(self.bn1(conv_in(self.conv1, x, dt).float()))
        x = torch.relu(self.bn2(conv_in(self.conv2, x, dt).float()))
        xs = [self.layer1(x, dt)]
        for stage in (2, 3, 4):
            transition = getattr(self, f"transition{stage - 1}")
            new = []
            for b, layer in enumerate(transition):
                if b < len(xs):
                    new.append(xs[b] if layer is None else _run(layer, xs[b], dt))
                else:
                    new.append(_run(layer[0], xs[-1], dt))
            xs = new
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs, dt)
        return tuple(y.float() for y in xs)
