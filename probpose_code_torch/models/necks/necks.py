"""Necks in PyTorch: the parameter-free ones and RTMW's CSPNeXtPAFPN.

Port of ``probpose_code_tpu/models/necks/necks.py:FeatureMapProcessor``
(``:35-75``) with ``_resize_bilinear`` (``:30``): select, concatenate and
rescale (B, C, h, w) feature maps, then an optional ReLU; and
``GlobalAveragePooling`` (``:79-92``, registered as ``GAP`` too): each
map's spatial mean, (B, C, h, w) -> (B, C). ``jax.image.resize``
with ``method="bilinear"`` samples at half-pixel centres and renormalises its
weights at the border, which for upsampling is torch's bilinear
interpolation with ``align_corners=False``. ``CSPNeXtPAFPN`` (``:186-239``)
is the path-aggregation neck of RTMW.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.registry import MODELS


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, size[0], size[1]), half-pixel centres."""
    if size[0] < x.shape[2] or size[1] < x.shape[3]:
        # jax.image.resize antialiases when it shrinks; torch's bilinear does not
        raise NotImplementedError("resize_bilinear: downsampling is not ported yet")
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


@MODELS.register_module()
class FeatureMapProcessor(nn.Module):
    """Select / concat / rescale multi-scale features (no parameters)."""

    def __init__(
        self,
        select_index: Optional[Union[int, Sequence[int]]] = None,
        concat: bool = False,
        scale_factor: float = 1.0,
        apply_relu: bool = False,
        align_corners: bool = False,
    ):
        super().__init__()
        if align_corners:
            raise NotImplementedError("FeatureMapProcessor: align_corners=True is not ported")
        self.select_index = select_index
        self.concat = concat
        self.scale_factor = scale_factor
        self.apply_relu = apply_relu

    def forward(self, inputs):
        sequential_input = isinstance(inputs, (tuple, list))
        if not sequential_input:
            inputs = (inputs,)
        if self.select_index is not None:
            if isinstance(self.select_index, int):
                inputs = (inputs[self.select_index],)
            else:
                inputs = tuple(inputs[i] for i in self.select_index)
        if self.concat and len(inputs) > 1:
            size = inputs[0].shape[2:]
            inputs = (torch.cat([inputs[0]] + [resize_bilinear(x, size) for x in inputs[1:]], dim=1),)
        if self.scale_factor != 1.0:
            inputs = tuple(
                resize_bilinear(x, (int(x.shape[2] * self.scale_factor), int(x.shape[3] * self.scale_factor)))
                for x in inputs
            )
        if self.apply_relu:
            inputs = tuple(torch.relu(x) for x in inputs)
        if not sequential_input and len(inputs) == 1:
            return inputs[0]
        return tuple(inputs)


@MODELS.register_module(name="GAP")
@MODELS.register_module()
class GlobalAveragePooling(nn.Module):
    """The spatial mean of each feature map: (B, C, h, w) -> (B, C)."""

    def forward(self, inputs):
        if isinstance(inputs, (tuple, list)):
            return tuple(x.mean(dim=(2, 3)) for x in inputs)
        return inputs.mean(dim=(2, 3))


@MODELS.register_module()
class CSPNeXtPAFPN(nn.Module):
    """Path aggregation with CSP layers (the RTMW neck). Port of
    ``probpose_code_tpu/models/necks/necks.py:CSPNeXtPAFPN`` (``:186-239``):
    top-down, from the highest level, a 1x1 ``ConvModule`` to
    ``in_channels[i - 1]`` (``reduce_layers``), a nearest resize to the next
    level's size (half-pixel centres, as ``jax.image.resize``; torch's
    ``nearest-exact``), the two concatenated and a ``CSPLayer`` without
    identity or channel attention (``top_down_blocks``); bottom-up a strided
    3x3 ``ConvModule`` (``downsamples``), the concatenation with the
    top-down map and a ``CSPLayer`` to ``in_channels[i + 1]``
    (``bottom_up_blocks``); then, where ``out_channels`` is set, a 3x3
    ``ConvModule`` a level (``out_convs``), before ``out_indices`` selects.
    The ConvModules are CSPNeXt's (eps 1e-3, SiLU). mmpose's names, which
    ``convert_torch_cspnext_pafpn`` (``engine/checkpoint.py:573``) reads:
    ``neck.reduce_layers.{j}`` and ``top_down_blocks.{j}`` with j = 0 for the
    highest level, ``downsamples.{k}`` and ``bottom_up_blocks.{k}`` from the
    lowest, ``out_convs.{i}``.

    The flax module takes its input widths from the data and reads
    ``in_channels`` only as the widths of its outputs. ``feat_channels``
    gives the widths the backbone gives (``PoseModel`` passes them; by default
    ``in_channels``): RTMW-m's config sets ``in_channels=[512, 768]`` where
    CSPNeXt-m gives 384 and 768 channels, so its ``top_down_blocks.0`` takes
    896 channels and ``bottom_up_blocks.0`` 1,024."""

    def __init__(self, in_channels: Sequence[int], out_channels: Optional[int] = None,
                 out_indices: Optional[Sequence[int]] = None, num_csp_blocks: int = 3, expand_ratio: float = 0.5,
                 feat_channels: Optional[Sequence[int]] = None):
        super().__init__()
        from probpose_code_torch.models.backbones.cspnext import ConvModule, CSPLayer

        in_channels = tuple(in_channels)
        feat = tuple(feat_channels or in_channels)
        if len(feat) != len(in_channels):
            raise ValueError(f"CSPNeXtPAFPN: {len(feat)} input levels, {len(in_channels)} in_channels")
        n = len(in_channels)
        self.out_indices = None if out_indices is None else tuple(out_indices)

        def csp(cin, cout):
            return CSPLayer(cin, cout, expand_ratio, num_csp_blocks, add_identity=False, channel_attention=False)

        self.reduce_layers, self.top_down_blocks = nn.ModuleList(), nn.ModuleList()
        top = feat[-1]
        for i in range(n - 1, 0, -1):  # j = n - 1 - i
            self.reduce_layers.append(ConvModule(top, in_channels[i - 1], 1))
            self.top_down_blocks.append(csp(in_channels[i - 1] + feat[i - 1], in_channels[i - 1]))
            top = in_channels[i - 1]
        inner = [top] + [in_channels[i] for i in range(n - 1)] if n > 1 else [feat[-1]]
        self.downsamples, self.bottom_up_blocks = nn.ModuleList(), nn.ModuleList()
        widths = [inner[0]]
        for i in range(n - 1):
            self.downsamples.append(ConvModule(widths[-1], in_channels[i], 3, 2))
            self.bottom_up_blocks.append(csp(in_channels[i] + inner[i + 1], in_channels[i + 1]))
            widths.append(in_channels[i + 1])
        self.out_convs = None
        if out_channels is not None:
            self.out_convs = nn.ModuleList(ConvModule(c, out_channels, 3) for c in widths)
            widths = [out_channels] * len(widths)
        self.out_channels = tuple(widths if self.out_indices is None else [widths[i] for i in self.out_indices])

    def forward(self, inputs):
        feats = [x.float() for x in inputs]
        n = len(feats)
        inner = [feats[-1]]
        for j, i in enumerate(range(n - 1, 0, -1)):
            high = self.reduce_layers[j](inner[0])
            inner[0] = high
            up = F.interpolate(high, size=tuple(feats[i - 1].shape[2:]), mode="nearest-exact")
            inner.insert(0, self.top_down_blocks[j](torch.cat([up, feats[i - 1]], dim=1)))
        outs = [inner[0]]
        for i in range(n - 1):
            down = self.downsamples[i](outs[-1])
            outs.append(self.bottom_up_blocks[i](torch.cat([down, inner[i + 1]], dim=1)))
        if self.out_convs is not None:
            outs = [conv(o) for conv, o in zip(self.out_convs, outs)]
        if self.out_indices is not None:
            outs = [outs[i] for i in self.out_indices]
        return tuple(outs)
