"""Deconvolutional heatmap head and the conv stacks of the heatmap heads.

Port of ``probpose_code_tpu/models/heads/heatmap_head.py``: ``DeconvStack``
(``:19``), ``ConvStack`` (``:40``) and ``HeatmapHead`` (``:57-92``); and of
``ViPNASHead`` (``heads/multistage_heads.py:139``), the head with grouped
deconvolutions.
DeconvStack: ConvTranspose(k4, s2) + BN(eps 1e-5) + ReLU blocks (kernel size
4, the ProbPose heads' size; 2 and 3 are not ported yet). Torch's
``ConvTranspose2d(k=4, s=2, padding=1)`` takes the reference weights as they
are (only the flax side flips the taps, ``engine/checkpoint.py:768``).
ConvStack: Conv(k, "SAME", bias) + BN + ReLU blocks. Sequential indices
follow the reference keys: ``deconv_layers.{0, 3, ...}`` deconvs and
``{1, 4, ...}`` BN, ``conv_layers.{0, 3, ...}`` convs and ``{1, 4, ...}``
BN, then ``final_layer``. ``BatchNorm2d`` trains as flax's ``nn.BatchNorm``
does.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.registry import MODELS


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's training semantics (``nn.BatchNorm``,
    ``momentum=0.9``): batch statistics in f32 with var = E[x^2] - mean^2
    clipped at 0, and the running variance updated with that BIASED variance
    (torch's own BatchNorm2d updates it with the unbiased one, which drifts
    by n/(n-1) a step). Evaluation uses the running statistics, as torch's
    does. Same buffers and state-dict keys as ``nn.BatchNorm2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def conv_in(module: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run a Conv2d / ConvTranspose2d with operands in ``dtype`` (flax
    ``Conv(dtype=...)``); the result stays in ``dtype``."""
    w = module.weight.to(dtype)
    b = module.bias.to(dtype) if module.bias is not None else None
    x = x.to(dtype)
    if isinstance(module, nn.ConvTranspose2d):
        return F.conv_transpose2d(
            x, w, b, module.stride, module.padding, module.output_padding, module.groups, module.dilation
        )
    return F.conv2d(x, w, b, module.stride, module.padding, module.dilation, module.groups)


def run_sequential(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Convs compute in ``dtype``; BatchNorm and the rest in f32."""
    for m in seq:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            x = conv_in(m, x, dtype)
        else:
            x = m(x.float())
    return x


def make_deconv_stack(in_channels: int, out_channels: Sequence[int], kernel_sizes: Sequence[int],
                      groups: Optional[Sequence[int]] = None) -> nn.Sequential:
    layers = []
    for c, k, g in zip(out_channels, kernel_sizes, groups or (1,) * len(out_channels)):
        if k != 4:
            raise NotImplementedError(f"deconv kernel size {k} is not ported yet (4 is)")
        layers += [
            nn.ConvTranspose2d(in_channels, c, 4, stride=2, padding=1, groups=g, bias=False),
            BatchNorm2d(c, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=False),
        ]
        in_channels = c
    return nn.Sequential(*layers)


def make_conv_stack(in_channels: int, out_channels: Sequence[int], kernel_sizes: Sequence[int]) -> nn.Sequential:
    layers = []
    for c, k in zip(out_channels, kernel_sizes):
        layers += [
            nn.Conv2d(in_channels, c, k, padding="same"),
            BatchNorm2d(c, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=False),
        ]
        in_channels = c
    return nn.Sequential(*layers)


@MODELS.register_module()
class HeatmapHead(nn.Module):
    """SimpleBaselines-style head: deconv stack -> conv stack -> final conv
    ("SAME" padding) -> heatmaps (B, K, H, W) in f32. As in the JAX head,
    ``final_layer`` is a dict with ``kernel_size`` (its ``padding`` is
    "SAME"), or False for none; None keeps ``final_layer_kernel_size``. The
    stacks compute in ``dtype``, the final conv in f32."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        deconv_out_channels: Optional[Sequence[int]] = (256, 256, 256),
        deconv_kernel_sizes: Optional[Sequence[int]] = (4, 4, 4),
        conv_out_channels: Optional[Sequence[int]] = None,
        conv_kernel_sizes: Optional[Sequence[int]] = None,
        has_final_layer: bool = True,
        final_layer_kernel_size: int = 1,
        final_layer: Any = None,
        keypoint_loss: Any = None,
        loss: Any = None,
        decoder: Any = None,
        dtype: Any = "float32",
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.decoder = decoder
        channels = in_channels
        self.deconv_layers = nn.Sequential()
        if deconv_out_channels:
            self.deconv_layers = make_deconv_stack(channels, deconv_out_channels, deconv_kernel_sizes)
            channels = deconv_out_channels[-1]
        self.conv_layers = nn.Sequential()
        if conv_out_channels:
            self.conv_layers = make_conv_stack(channels, conv_out_channels, conv_kernel_sizes)
            channels = conv_out_channels[-1]
        self.final_layer = None
        if has_final_layer and final_layer is not False:
            k = final_layer_kernel_size
            if isinstance(final_layer, dict):
                k = final_layer.get("kernel_size", k)
            self.final_layer = nn.Conv2d(channels, out_channels, k, padding="same")

    def forward(self, feats) -> torch.Tensor:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats  # (B, C, h, w)
        x = run_sequential(self.deconv_layers, x, self.dtype)
        x = run_sequential(self.conv_layers, x, self.dtype)
        if self.final_layer is not None:
            x = self.final_layer(x.float())
        return x.float()


@MODELS.register_module()
class ViPNASHead(HeatmapHead):
    """HeatmapHead whose deconvolutions are grouped: each stage one
    ``ConvTranspose2d(groups=g)`` of ``deconv_num_groups``, where the JAX head
    (``heads/multistage_heads.py:139``) runs g transposed convs on the
    channel groups and concatenates them (``deconv{i}_g{j}``, carried across
    by ``engine/checkpoint.py:state_dict_from_jax``); then BatchNorm and
    ReLU, and the 1x1 ``final_layer``. mmpose's names:
    ``deconv_layers.{0,3,...}`` with weights (in, out / g, 4, 4)."""

    def __init__(self, in_channels: int, out_channels: int, deconv_out_channels: Sequence[int] = (144, 144, 144),
                 deconv_num_groups: Sequence[int] = (16, 16, 16), loss: Any = None, decoder: Any = None,
                 dtype: Any = "float32"):
        kernel_sizes = (4,) * len(deconv_out_channels)
        super().__init__(in_channels, out_channels, deconv_out_channels, kernel_sizes, loss=loss, decoder=decoder,
                         dtype=dtype)
        self.deconv_layers = make_deconv_stack(in_channels, deconv_out_channels, kernel_sizes, deconv_num_groups)
