"""Deconvolution stack of the heatmap heads.

Port of ``probpose_code_tpu/models/heads/heatmap_head.py:DeconvStack``
(``:19``): ConvTranspose(k4, s2) + BN(eps 1e-5) + ReLU blocks (kernel size
4, the ProbPose heads' size; 2 and 3 are not ported yet). Torch's
``ConvTranspose2d(k=4, s=2, padding=1)`` takes the reference weights as they
are (only the flax side flips the taps, ``engine/checkpoint.py:768``).
Sequential indices follow the reference keys: ``{0, 3}`` deconvs,
``{1, 4}`` BN. ``BatchNorm2d`` trains as flax's ``nn.BatchNorm`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


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


def make_deconv_stack(in_channels: int, out_channels: Sequence[int], kernel_sizes: Sequence[int]) -> nn.Sequential:
    layers = []
    for c, k in zip(out_channels, kernel_sizes):
        if k != 4:
            raise NotImplementedError(f"deconv kernel size {k} is not ported yet (4 is)")
        layers += [
            nn.ConvTranspose2d(in_channels, c, 4, stride=2, padding=1, bias=False),
            BatchNorm2d(c, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=False),
        ]
        in_channels = c
    return nn.Sequential(*layers)
