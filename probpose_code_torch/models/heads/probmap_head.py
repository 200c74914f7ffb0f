"""ProbMapHead, the ProbPose five-branch head, in PyTorch.

Port of ``probpose_code_tpu/models/heads/probmap_head.py``: ``ProbMapHead``
(``:63``) and ``ScalarBranchTower`` (``:37``). From the backbone's (B, C, h, w)
feature map:

1. heatmaps      deconv stack -> 1x1 conv -> sparsemax(x / T) over H*W,
                 scaled by ``normalize``, clamped to [0, 1]
2. probabilities tower -> sigmoid
3. visibilities  tower -> sigmoid
4. oks           tower -> sigmoid
5. errors        tower -> ReLU

The gradient switches are the JAX head's (``probmap_head.py:113-150``):
``detach_probability`` / ``detach_visibility`` cut the gradient into those
towers' input, the oks and error towers always see a detached input, and
``freeze_*`` cut it at each output.

Module indices follow the reference keys (``head.deconv_layers.{0,1,3,4}``,
``head.final_layer``, ``head.<tower>.{0,1,4,5,8,9,12}``), so reference
checkpoints load with ``strict=True``. The loss configs are kept as given:
``models/builder.py:build_loss_modules`` builds them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.ops.sparsemax import sparsemax
from probpose_code_torch.registry import MODELS

from .heatmap_head import BatchNorm2d, make_deconv_stack, run_sequential


class ClampedMaxPool(nn.Module):
    """Max-pool whose window is clamped to the input's extent
    (``probmap_head.py:50-54``), so grids smaller than 16x12 still pool to a
    non-empty map."""

    def __init__(self, window):
        super().__init__()
        self.window = tuple(window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        win = (min(self.window[0], x.shape[2]), min(self.window[1], x.shape[3]))
        return nn.functional.max_pool2d(x, win, win)


def make_scalar_tower(channels: int, out_channels: int, pool_sizes=((4, 3), (2, 2), (2, 2))) -> nn.Sequential:
    """conv3x3 -> BN -> max-pool -> ReLU, three times, then a 1x1 conv."""
    layers = []
    for pool in pool_sizes:
        layers += [
            nn.Conv2d(channels, channels, 3, padding=1),
            BatchNorm2d(channels, eps=1e-5, momentum=0.1),
            ClampedMaxPool(pool),
            nn.ReLU(inplace=False),
        ]
    layers.append(nn.Conv2d(channels, out_channels, 1))
    return nn.Sequential(*layers)


def run_tower(tower: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The 3x3 convs compute in ``dtype``; the 1x1 conv and BN in f32. The
    residual grid is averaged to one logit per channel: (B, K)."""
    x = run_sequential(tower[:-1], x, dtype)
    x = tower[-1](x.float())
    return x.mean(dim=(2, 3)).float()


@MODELS.register_module()
class ProbMapHead(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        deconv_out_channels: Optional[Sequence[int]] = (256, 256, 256),
        deconv_kernel_sizes: Optional[Sequence[int]] = (4, 4, 4),
        conv_out_channels: Optional[Sequence[int]] = None,
        conv_kernel_sizes: Optional[Sequence[int]] = None,
        temperature: float = 0.5,
        normalize: Optional[float] = None,
        detach_probability: bool = True,
        detach_visibility: bool = True,
        learn_heatmaps_from_zeros: bool = False,
        freeze_heatmaps: bool = False,
        freeze_probability: bool = False,
        freeze_visibility: bool = False,
        freeze_oks: bool = False,
        freeze_error: bool = False,
        keypoint_loss: Any = None,
        probability_loss: Any = None,
        visibility_loss: Any = None,
        oks_loss: Any = None,
        error_loss: Any = None,
        decoder: Any = None,
        dtype: Any = "float32",
    ):
        super().__init__()
        if conv_out_channels:
            raise NotImplementedError("ProbMapHead conv_out_channels is not ported yet")
        self.temperature = temperature
        self.normalize = normalize
        self.dtype = resolve_dtype(dtype)
        self.detach_probability = detach_probability
        self.detach_visibility = detach_visibility
        self.freeze_heatmaps = freeze_heatmaps
        self.freeze_probability = freeze_probability
        self.freeze_visibility = freeze_visibility
        self.freeze_oks = freeze_oks
        self.freeze_error = freeze_error
        self.loss_cfgs = dict(
            keypoint=keypoint_loss, probability=probability_loss, visibility=visibility_loss,
            oks=oks_loss, error=error_loss,
        )
        self.decoder = decoder
        head_in = in_channels
        if deconv_out_channels:
            self.deconv_layers = make_deconv_stack(in_channels, deconv_out_channels, deconv_kernel_sizes)
            head_in = deconv_out_channels[-1]
        else:
            self.deconv_layers = nn.Sequential()
        self.final_layer = nn.Conv2d(head_in, out_channels, 1)
        self.probability_layers = make_scalar_tower(in_channels, out_channels)
        self.visibility_layers = make_scalar_tower(in_channels, out_channels)
        self.oks_layers = make_scalar_tower(in_channels, out_channels)
        self.error_layers = make_scalar_tower(in_channels, out_channels)

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats  # (B, C, h, w) f32
        h = run_sequential(self.deconv_layers, x, self.dtype)
        h = self.final_layer(h.float())  # (B, K, H, W) f32
        B, K, H, W = h.shape
        h = h.reshape(B, K, H * W)
        if self.normalize is not None:
            h = sparsemax(h / self.temperature) * self.normalize
        else:
            h = h / self.temperature
        heatmaps = torch.clamp(h, 0.0, 1.0).reshape(B, K, H, W)

        def cut(t, stop):
            return t.detach() if stop else t

        x_det = x.detach()
        return dict(
            heatmaps=cut(heatmaps, self.freeze_heatmaps),
            probabilities=cut(torch.sigmoid(run_tower(
                self.probability_layers, cut(x, self.detach_probability), self.dtype)), self.freeze_probability),
            visibilities=cut(torch.sigmoid(run_tower(
                self.visibility_layers, cut(x, self.detach_visibility), self.dtype)), self.freeze_visibility),
            oks=cut(torch.sigmoid(run_tower(self.oks_layers, x_det, self.dtype)), self.freeze_oks),
            errors=cut(torch.relu(run_tower(self.error_layers, x_det, self.dtype)), self.freeze_error),
        )
