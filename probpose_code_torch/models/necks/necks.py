"""Parameter-free feature-map neck in PyTorch.

Port of ``probpose_code_tpu/models/necks/necks.py:FeatureMapProcessor``
(``:35-75``) with ``_resize_bilinear`` (``:30``): select, concatenate and
rescale (B, C, h, w) feature maps, then an optional ReLU. ``jax.image.resize``
with ``method="bilinear"`` samples at half-pixel centres and renormalises its
weights at the border, which for upsampling is torch's bilinear
interpolation with ``align_corners=False``.
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
