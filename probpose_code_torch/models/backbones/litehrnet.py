"""LiteHRNet in PyTorch, with mmpose's state-dict names where its structure is mmpose's.

Port of ``probpose_code_tpu/models/backbones/litehrnet.py``: ``SpatialWeighting``
(``:30``, ``spatial_weighting``), ``CrossResolutionWeighting`` (``:45``), ``ConditionalChannelWeighting``
(``:70``), ``LiteStem`` (``:94``) and ``LiteHRNet`` with its ``IterativeHead``
(``:126-217``). The shuffle stem (a strided 3x3 ``ConvModule``, then a strided
depthwise + pointwise branch beside an expand / strided depthwise / linear
branch, concatenated and shuffled), then per stage a transition (a 1x1
projection of a branch whose width changes, a strided depthwise + pointwise
pair for a new branch from the last), ``num_modules`` modules of
``num_blocks`` conditional channel weighting blocks each and the fuse layers
(a 1x1 conv and a nearest upsample from a coarser branch, depthwise +
pointwise pairs, strided, from a finer one; summed, ReLU), and the iterative
head: from the coarsest branch, each branch plus the previous projection
resized bilinearly, then a depthwise 3x3 and a pointwise ``ConvModule``. It
returns the finest branch, or the finest stage output without the head.

Where the port departs from the JAX module:

- the channel splits of the cross-resolution weighting are Python ints (the
  JAX module splits at ``jnp.cumsum`` of its widths, a traced value under
  ``jax.jit``: its jitted forward raises ``ConcretizationTypeError``, and only
  its eager ``apply`` runs);
- the cross-resolution weighting's two BatchNorms train (mmpose's do; the JAX
  module calls them with ``train=False``: batch statistics never used, the
  running ones never updated);
- every strided 3x3 conv pads 1 on each side, as mmpose does; the JAX "SAME"
  pads (0, 1) at an even side, and LiteHRNet runs only at even sides (its
  pools meet the coarsest branch at sides that are multiples of 32).

The nearest resizes are JAX's (half-pixel centres,
``pose_estimators/topdown.py:resize_nearest_indices``), the same as mmpose's
at the configs' 2^k ratios. The bilinear resize has half-pixel centres, as
``jax.image.resize`` and ``F.interpolate`` without corner alignment (mmpose
aligns the corners). Both resizes, at the configs' whole ratios, are written
as repeats and fixed sums, so that their backward, and a training step, is
the same from run to run on the card.

On the card every depthwise 3x3 conv runs ``ops/kernels/depthwise.py``
(``csrc/depthwise.cu``; every width of the configs is a multiple of 4) and
every spatial weighting, a ``classic.SELayer`` of the JAX module's width,
``ops/kernels/se_layer.py`` (``csrc/se_layer.cu``); their plain twins on the
CPU.
Convolutions and BatchNorm (flax's training semantics, eps 1e-5) run in f32,
the module's only type (the depthwise kernels are f32).

Names, under ``backbone.`` (mmpose's by a reading of its modules; no mmpose
checkpoint of LiteHRNet is in the repository to check them):

- ``stem.conv1``, ``stem.branch1.{0,1}``, ``stem.expand_conv``,
  ``stem.depthwise_conv``, ``stem.linear_conv`` (``ConvModule``s: ``.conv``,
  ``.bn``);
- ``transition{i}.{j}.{0,1,2,3}`` for a new branch's depthwise conv, BN,
  pointwise conv, BN (mmpose's ``transition{i}.{j}.0.{0..3}`` has one more
  level); ``transition{i}.{j}.conv`` / ``.bn`` for the 1x1 projection (mmpose
  has a depthwise + pointwise pair there, whose names these are not);
- ``stage{i}.{m}.layers.{b}.cross_resolution_weighting.conv{1,2}``,
  ``.depthwise_convs.{j}``, ``.spatial_weighting.{j}.conv{1,2}.conv`` (1x1
  convs with a bias);
- ``stage{i}.{m}.fuse_layers.{a}.{b}.{0,1}`` from a coarser branch,
  ``.{a}.{b}.{k}.{0,1,2,3}`` from a finer one (no ReLU between the steps, as
  in the JAX module; mmpose has one);
- ``head_layer.projects.{i}.depthwise_conv`` / ``.pointwise_conv``.

``engine/checkpoint.py:state_dict_from_jax`` carries the JAX variables onto
these names.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.classic import ConvModule, SELayer, channel_shuffle
from probpose_code_torch.models.backbones.hrnet import _bn
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import conv_in
from probpose_code_torch.models.pose_estimators.topdown import resize_nearest_indices
from probpose_code_torch.ops.kernels.depthwise import depthwise_conv3x3
from probpose_code_torch.registry import MODELS

DEFAULT_EXTRA = dict(
    stem=dict(stem_channels=32, out_channels=32, expand_ratio=1),
    num_stages=3,
    stages_spec=dict(
        num_modules=(2, 4, 2), num_branches=(2, 3, 4), num_blocks=(2, 2, 2),
        module_type=("LITE",) * 3, with_fuse=(True,) * 3, reduce_ratios=(8, 8, 8),
        num_channels=((40, 80), (40, 80, 160), (40, 80, 160, 320)),
    ),
    with_head=True,
)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of a (B, C, H, W) map to (h, w).
    At whole ratios (the configs') each value repeated, whose backward is a
    sum in a fixed order (the gather's would add with atomics on the card, in
    an order that changes from run to run)."""
    B, C, H, W = x.shape
    if h % H == 0 and w % W == 0:
        fh, fw = h // H, w // W
        return x[:, :, :, None, :, None].expand(B, C, H, fh, W, fw).reshape(B, C, h, w)
    rows = resize_nearest_indices(H, h, x.device)
    cols = resize_nearest_indices(W, w, x.device)
    return x.index_select(2, rows).index_select(3, cols)


def _upsample_twice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Twice the size along ``dim`` with half-pixel centres: 0.25 x[i - 1] +
    0.75 x[i], then 0.75 x[i] + 0.25 x[i + 1], the edges repeated."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    out = torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt], dim + 1)
    return out.flatten(dim, dim + 1)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of a (B, C, H, W) map up to (h,
    w): ``F.interpolate`` with half-pixel centres; at twice the size (the
    configs') the same sums written out, whose backward adds in a fixed
    order (``F.interpolate``'s adds with atomics on the card)."""
    if (h, w) == (2 * x.shape[2], 2 * x.shape[3]):
        return _upsample_twice(_upsample_twice(x, 2), 3)
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def depthwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A depthwise 3x3 conv (no bias) by ``depthwise_conv3x3``: padding 1, f32."""
    return depthwise_conv3x3(x.float(), conv.weight, conv.stride[0])


class DepthwiseConvModule(ConvModule):
    """A depthwise 3x3 ``ConvModule`` without activation (``.conv``, ``.bn``)."""

    def __init__(self, channels: int, stride: int = 1):
        super().__init__(channels, channels, 3, stride, groups=channels, act=None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.bn(depthwise(self.conv, x))


class DepthwisePointwise(nn.Sequential):
    """A depthwise 3x3 conv, BN, a 1x1 conv, BN (``.0`` to ``.3``), then ReLU
    if ``relu``."""

    def __init__(self, cin: int, cout: int, stride: int, relu: bool):
        super().__init__(nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False), _bn(cin),
                         nn.Conv2d(cin, cout, 1, bias=False), _bn(cout))
        self.relu = relu

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self[3](conv_in(self[2], self[1](depthwise(self[0], x)), dtype).float())
        return torch.relu(y) if self.relu else y


def spatial_weighting(channels: int, ratio: int) -> SELayer:
    """The JAX ``SpatialWeighting``: the mean of each plane, ``conv1`` to
    ``max(1, int(C / ratio))`` with ReLU, ``conv2`` back with a sigmoid, times
    the input; the squeeze and excite of ``se_layer``."""
    return SELayer(channels, ratio, mid=max(1, int(channels / ratio)))


class CrossResolutionWeighting(nn.Module):
    """Every branch average-pooled by ``H // h_min`` to the coarsest one's
    size, concatenated, ``conv1`` (BN, ReLU) to ``max(1, int(total / ratio))``
    and ``conv2`` (BN, sigmoid) back, split per branch, resized back (nearest)
    and multiplied into each branch."""

    def __init__(self, channels: Sequence[int], ratio: int = 16):
        super().__init__()
        self.channels = [int(c) for c in channels]
        total = sum(self.channels)
        mid = max(1, int(total / ratio))
        self.conv1 = ConvModule(total, mid, 1)
        self.conv2 = ConvModule(mid, total, 1, act=None)

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        h_min = xs[-1].shape[2]
        pooled = [F.avg_pool2d(s, s.shape[2] // h_min) for s in xs[:-1]] + [xs[-1]]
        out = torch.sigmoid(self.conv2(self.conv1(torch.cat(pooled, 1), dtype), dtype))
        return [s * resize_nearest(a, s.shape[2], s.shape[3])
                for s, a in zip(xs, torch.split(out, self.channels, 1))]


class ConditionalChannelWeighting(nn.Module):
    """Each branch split in half: the second halves through the
    cross-resolution weighting, then per branch a depthwise 3x3 conv + BN and
    the spatial weighting (ratio 4); each branch's halves concatenated again
    and shuffled (two groups)."""

    def __init__(self, in_channels: Sequence[int], reduce_ratio: int):
        super().__init__()
        self.halves = [c // 2 for c in in_channels]
        self.cross_resolution_weighting = CrossResolutionWeighting(self.halves, reduce_ratio)
        self.depthwise_convs = nn.ModuleList(DepthwiseConvModule(c) for c in self.halves)
        self.spatial_weighting = nn.ModuleList(spatial_weighting(c, 4) for c in self.halves)

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        x1 = [s[:, :c] for s, c in zip(xs, self.halves)]
        x2 = self.cross_resolution_weighting([s[:, c:] for s, c in zip(xs, self.halves)], dtype)
        x2 = [sw(dw(s, dtype), dtype) for s, dw, sw in zip(x2, self.depthwise_convs, self.spatial_weighting)]
        return [channel_shuffle(torch.cat([a, b], 1), 2) for a, b in zip(x1, x2)]


class LiteStem(nn.Module):
    """``conv1`` (3x3, stride 2) to ``stem_channels``; its first half through
    ``branch1`` (strided depthwise, pointwise to ``inc``), its second through
    ``expand_conv``, the strided ``depthwise_conv`` and ``linear_conv``;
    concatenated and shuffled: ``out_channels`` at 1/4 of the input."""

    def __init__(self, in_channels: int = 3, stem_channels: int = 32, out_channels: int = 32,
                 expand_ratio: float = 1):
        super().__init__()
        self.conv1 = ConvModule(in_channels, stem_channels, 3, 2)
        self.branch_c = branch_c = stem_channels // 2
        same = stem_channels == out_channels
        inc = out_channels - branch_c if same else out_channels - stem_channels
        mid = int(round(stem_channels * expand_ratio))
        self.branch1 = nn.Sequential(DepthwiseConvModule(branch_c, 2), ConvModule(branch_c, inc, 1))
        self.expand_conv = ConvModule(branch_c, mid, 1)
        self.depthwise_conv = DepthwiseConvModule(mid, 2)
        self.linear_conv = ConvModule(mid, branch_c if same else stem_channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.conv1(x, dtype)
        x1, x2 = x[:, :self.branch_c], x[:, self.branch_c:]
        b1 = self.branch1[1](self.branch1[0](x1, dtype), dtype)
        b2 = self.linear_conv(self.depthwise_conv(self.expand_conv(x2, dtype), dtype), dtype)
        return channel_shuffle(torch.cat([b1, b2], 1), 2)


class LiteHRModule(nn.Module):
    """``num_blocks`` conditional channel weighting blocks (``layers``), then
    the fuse layers if ``with_fuse``."""

    def __init__(self, channels: Sequence[int], num_blocks: int, reduce_ratio: int, with_fuse: bool):
        super().__init__()
        self.layers = nn.ModuleList(ConditionalChannelWeighting(channels, reduce_ratio) for _ in range(num_blocks))
        self.fuse_layers = None
        if with_fuse:
            n = len(channels)
            self.fuse_layers = nn.ModuleList()
            for a in range(n):
                row = []
                for b in range(n):
                    if b > a:  # from a coarser branch: 1x1 conv, BN, then the nearest upsample
                        row.append(nn.Sequential(nn.Conv2d(channels[b], channels[a], 1, bias=False),
                                                 _bn(channels[a])))
                    elif b < a:  # from a finer branch: strided depthwise + pointwise pairs
                        row.append(nn.ModuleList(
                            DepthwisePointwise(channels[b], channels[a] if k == a - b - 1 else channels[b], 2,
                                               relu=False) for k in range(a - b)))
                    else:
                        row.append(None)
                self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        for block in self.layers:
            xs = block(xs, dtype)
        if self.fuse_layers is None:
            return xs
        fused = []
        for a, row in enumerate(self.fuse_layers):
            acc = xs[a].float()
            for b, layer in enumerate(row):
                if layer is None:
                    continue
                if b > a:
                    y = layer[1](conv_in(layer[0], xs[b], dtype).float())
                    y = resize_nearest(y, acc.shape[2], acc.shape[3])
                else:
                    y = xs[b]
                    for step in layer:
                        y = step(y, dtype)
                acc = acc + y.float()
            fused.append(torch.relu(acc))
        return fused


class DepthwiseSeparable(nn.Module):
    """The iterative head's projection: ``depthwise_conv`` (3x3 + BN) and
    ``pointwise_conv`` (1x1 + BN + ReLU)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.depthwise_conv = DepthwiseConvModule(cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x, dtype), dtype)


class IterativeHead(nn.Module):
    def __init__(self, channels: Sequence[int]):
        super().__init__()
        rev = list(channels)[::-1]
        self.projects = nn.ModuleList(
            DepthwiseSeparable(c, rev[i + 1] if i + 1 < len(rev) else c) for i, c in enumerate(rev))

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        last = None
        for s, project in zip(xs[::-1], self.projects):
            if last is not None:
                s = s + resize_bilinear(last, s.shape[2], s.shape[3])
            last = project(s, dtype)
        return last


@MODELS.register_module()
class LiteHRNet(nn.Module):
    """``extra`` in the reference schema (``DEFAULT_EXTRA``, LiteHRNet-18);
    only ``LITE`` modules (``NAIVE`` is not in the JAX module)."""

    def __init__(self, extra: Optional[Dict[str, Any]] = None, in_channels: int = 3, dtype: Any = "float32"):
        super().__init__()
        extra = extra or DEFAULT_EXTRA
        self.dtype = resolve_dtype(dtype)
        if self.dtype != torch.float32:
            raise NotImplementedError("LiteHRNet: float32 only (its depthwise kernels are f32)")
        spec = extra["stages_spec"]
        if any(t != "LITE" for t in spec.get("module_type", ())):
            raise NotImplementedError(f"LiteHRNet: module types {spec['module_type']}: only LITE is ported")
        stem = extra["stem"]
        self.stem = LiteStem(in_channels, stem["stem_channels"], stem["out_channels"], stem["expand_ratio"])
        self.num_stages = extra["num_stages"]
        prev = [stem["out_channels"]]
        for i in range(self.num_stages):
            chans = list(spec["num_channels"][i])
            transition = []
            for j in range(spec["num_branches"][i]):
                if j < len(prev):
                    transition.append(None if prev[j] == chans[j] else ConvModule(prev[j], chans[j], 1))
                else:
                    transition.append(DepthwisePointwise(prev[-1], chans[j], 2, relu=True))
            setattr(self, f"transition{i}", nn.ModuleList(transition))
            setattr(self, f"stage{i}", nn.ModuleList(
                LiteHRModule(chans, spec["num_blocks"][i], spec["reduce_ratios"][i], spec["with_fuse"][i])
                for _ in range(spec["num_modules"][i])))
            prev = chans
        self.head_layer = IterativeHead(prev) if extra.get("with_head", False) else None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor]:
        """(B, 3, H, W) -> ((B, C, H / 4, W / 4) f32,); ``generator`` is
        accepted for the estimator's call and unused."""
        dt = self.dtype
        ys = [self.stem(x, dt)]
        for i in range(self.num_stages):
            xs = []
            for j, layer in enumerate(getattr(self, f"transition{i}")):
                src = ys[j] if j < len(ys) else ys[-1]
                xs.append(src if layer is None else layer(src, dt))
            for module in getattr(self, f"stage{i}"):
                xs = module(xs, dt)
            ys = xs
        if self.head_layer is not None:
            return (self.head_layer(ys, dt).float(),)
        return (ys[0].float(),)
