"""Integral regression heads in PyTorch: IntegralRegressionHead and DSNTHead.

Port of ``probpose_code_tpu/models/heads/regression_heads.py:
IntegralRegressionHead`` (``:78-119``) and ``DSNTHead`` (``:122``), under
mmpose's names (``deconv_layers``, ``conv_layers``, ``final_layer``, as
``HeatmapHead``'s): the deconv and conv stacks of the heatmap head, the
``final_layer`` conv, then a softmax of ``beta * map`` over the H * W cells
in f32 (the maximum shifted out, so ``beta = 10``, the debias configs',
takes no ``exp`` of a raw map) and the soft-argmax expectation of x and y,
normalised by W and H (not W - 1, H - 1), as ``RegressionLabel``'s
coordinates are. Returns ``(coords (B, K, 2), heatmaps (B, K, H, W))``.
``debias`` is taken and not read, as in the JAX head (a reading of the JAX
package that mmpose, which debiases the expectation, does not share).
DSNTHead runs the same forward; its configs' losses differ.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.registry import MODELS

from .heatmap_head import make_conv_stack, make_deconv_stack, run_sequential


def soft_argmax(heatmaps: torch.Tensor, beta: float) -> torch.Tensor:
    """(B, K, H, W) maps -> (B, K, 2) the expected (x / W, y / H) under the
    softmax of ``beta * map`` over each map, in f32."""
    B, K, H, W = heatmaps.shape
    probs = torch.softmax(heatmaps.reshape(B, K, H * W).float() * beta, dim=-1).reshape(B, K, H, W)
    xs = torch.arange(W, dtype=torch.float32, device=heatmaps.device)
    ys = torch.arange(H, dtype=torch.float32, device=heatmaps.device)
    ex = (probs.sum(dim=2) * xs).sum(dim=-1)
    ey = (probs.sum(dim=3) * ys).sum(dim=-1)
    return torch.stack([ex / W, ey / H], dim=-1)


@MODELS.register_module()
class IntegralRegressionHead(nn.Module):
    def __init__(
        self,
        in_channels: int,
        in_featuremap_size: Tuple[int, int],
        num_joints: int,
        debias: bool = False,
        beta: float = 1.0,
        deconv_out_channels: Optional[Sequence[int]] = (256, 256, 256),
        deconv_kernel_sizes: Optional[Sequence[int]] = (4, 4, 4),
        conv_out_channels: Optional[Sequence[int]] = None,
        conv_kernel_sizes: Optional[Sequence[int]] = None,
        final_layer_kernel_size: int = 1,
        loss: Any = None,
        decoder: Any = None,
        init_cfg: Any = None,
        dtype: Any = "float32",
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.decoder = decoder
        self.debias = debias
        self.beta = float(beta)
        channels = in_channels
        self.deconv_layers = nn.Sequential()
        if deconv_out_channels:
            self.deconv_layers = make_deconv_stack(channels, deconv_out_channels, deconv_kernel_sizes)
            channels = deconv_out_channels[-1]
        self.conv_layers = nn.Sequential()
        if conv_out_channels:
            self.conv_layers = make_conv_stack(channels, conv_out_channels, conv_kernel_sizes)
            channels = conv_out_channels[-1]
        self.final_layer = nn.Conv2d(channels, num_joints, final_layer_kernel_size, padding="same")

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats
        x = run_sequential(self.deconv_layers, x, self.dtype)
        x = run_sequential(self.conv_layers, x, self.dtype)
        heatmaps = self.final_layer(x.float()).float()
        return soft_argmax(heatmaps, self.beta), heatmaps


@MODELS.register_module()
class DSNTHead(IntegralRegressionHead):
    """IntegralRegressionHead's forward; the DSNT configs supervise it with
    ``JSDiscretLoss``."""
