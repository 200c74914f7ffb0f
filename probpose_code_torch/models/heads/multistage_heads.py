"""The multi-stage heatmap heads in PyTorch: CPMHead and MSPNHead, and their losses.

Port of ``probpose_code_tpu/models/heads/multistage_heads.py``: ``CPMHead``
(``:33``), ``PRM`` (``:62``), ``MSPNHead`` (``:98``), ``cpm_head_loss``
(``:169``) and ``mspn_head_loss`` (``:178``).

``CPMHead``: for each stage's map an optional deconv stack (the heatmap
heads' ``make_deconv_stack``) and a final conv ("SAME", with bias). Returns
a list of (B, K, h, w) maps in f32; predict decodes the last. mmpose's
names: ``multi_deconv_layers.{i}.{0, 3, ...}`` / ``{1, 4, ...}`` and
``multi_final_layers.{i}``.

``MSPNHead``: for each (stage, unit), stage-major, a 1x1 ``ConvModule``
(BatchNorm eps 1e-5, ReLU) and a 3x3 ``ConvModule`` without ReLU to one map
a keypoint, a bilinear resize to ``out_shape`` (half-pixel centres, as
``jax.image.resize``) and, with ``use_prm``, the pose refine machine: a 3x3
``ConvModule``, its output times ``1 + g * b``, g the global mean through
two linears with BatchNorm and ReLU and a sigmoid, b a 1x1 ``ConvModule``, a
9x9 depthwise and a 1x1 pointwise ``ConvModule`` to one channel and a
sigmoid. mmpose's names, as a reading of its modules gives them:
``predict_layers.{n}.conv_layers.{0,1}.{conv,bn}`` and
``predict_layers.{n}.prm.{conv_bn_relu_prm_1, middle_path.{0,1,3,4},
bottom_path.0, bottom_path.1.depthwise_conv, bottom_path.1.pointwise_conv}``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.classic import ConvModule
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import BatchNorm2d, make_deconv_stack, run_sequential
from probpose_code_torch.registry import MODELS


@MODELS.register_module()
class CPMHead(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_stages: int,
                 deconv_out_channels: Optional[Sequence[int]] = None,
                 deconv_kernel_sizes: Optional[Sequence[int]] = None, final_layer: Optional[dict] = None,
                 loss: Any = None, decoder: Any = None, dtype: Any = "float32"):
        super().__init__()
        self.num_stages, self.dtype = num_stages, resolve_dtype(dtype)
        channels = in_channels
        self.multi_deconv_layers = nn.ModuleList()
        if deconv_out_channels:
            kernel_sizes = deconv_kernel_sizes or (4,) * len(deconv_out_channels)
            self.multi_deconv_layers.extend(make_deconv_stack(in_channels, deconv_out_channels, kernel_sizes)
                                            for _ in range(num_stages))
            channels = deconv_out_channels[-1]
        k = (final_layer or {"kernel_size": 1}).get("kernel_size", 1)
        self.multi_final_layers = nn.ModuleList(nn.Conv2d(channels, out_channels, k, padding="same")
                                                for _ in range(num_stages))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(feats) != self.num_stages:
            raise ValueError(f"CPMHead: {len(feats)} feature maps for {self.num_stages} stages")
        outs = []
        for i, x in enumerate(feats):
            if len(self.multi_deconv_layers):
                x = run_sequential(self.multi_deconv_layers[i], x, self.dtype)
            outs.append(self.multi_final_layers[i](x.float()).float())
        return outs


class PRM(nn.Module):
    def __init__(self, out_channels: int):
        super().__init__()
        c = out_channels
        self.conv_bn_relu_prm_1 = ConvModule(c, c, 3)
        self.middle_path = nn.Sequential(nn.Linear(c, c), BatchNorm2d(c, eps=1e-5, momentum=0.1), nn.ReLU(),
                                         nn.Linear(c, c), BatchNorm2d(c, eps=1e-5, momentum=0.1), nn.ReLU())
        pair = nn.Module()
        pair.depthwise_conv = ConvModule(c, c, 9, groups=c)
        pair.pointwise_conv = ConvModule(c, 1, 1)
        self.bottom_path = nn.Sequential(ConvModule(c, c, 1), pair)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_bn_relu_prm_1(x, torch.float32)
        g = out.mean(dim=(2, 3))
        for m in self.middle_path:  # BatchNorm over (B, C) as over (B, C, 1, 1)
            g = m(g[:, :, None, None])[:, :, 0, 0] if isinstance(m, BatchNorm2d) else m(g)
        b = self.bottom_path[0](out, torch.float32)
        b = self.bottom_path[1].pointwise_conv(self.bottom_path[1].depthwise_conv(b, torch.float32), torch.float32)
        return out * (1 + torch.sigmoid(g)[:, :, None, None] * torch.sigmoid(b))


class PredictHeatmap(nn.Module):
    def __init__(self, unit_channels: int, out_channels: int, out_shape: Tuple[int, int], use_prm: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.out_shape, self.dtype = tuple(out_shape), dtype
        self.conv_layers = nn.Sequential(ConvModule(unit_channels, unit_channels, 1),
                                         ConvModule(unit_channels, out_channels, 3, act=None))
        self.prm = PRM(out_channels) if use_prm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_layers[1](self.conv_layers[0](x, self.dtype), self.dtype)
        x = F.interpolate(x, size=self.out_shape, mode="bilinear", align_corners=False)
        return x if self.prm is None else self.prm(x)


@MODELS.register_module()
class MSPNHead(nn.Module):
    def __init__(self, num_stages: int = 4, num_units: int = 4, out_shape: Tuple[int, int] = (64, 48),
                 unit_channels: int = 256, out_channels: int = 17, use_prm: bool = False,
                 level_indices: Sequence[int] = (), loss: Any = None, decoder: Any = None, dtype: Any = "float32"):
        super().__init__()
        self.num_stages, self.num_units = num_stages, num_units
        self.level_indices = tuple(level_indices)
        self.predict_layers = nn.ModuleList(PredictHeatmap(unit_channels, out_channels, out_shape, use_prm,
                                                           resolve_dtype(dtype)) for _ in range(num_stages * num_units))

    def forward(self, feats: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        if len(feats) != self.num_stages or any(len(stage) != self.num_units for stage in feats):
            raise ValueError(f"MSPNHead: features of {[len(s) for s in feats]} units, expected "
                             f"{self.num_stages} stages of {self.num_units}")
        layers = iter(self.predict_layers)
        return [next(layers)(f.float()).float() for stage in feats for f in stage]


def cpm_head_loss(outputs: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
                  loss_module: Any) -> Dict[str, torch.Tensor]:
    """The stages' losses against the one target, summed (``:169``)."""
    total = 0.0
    for heatmaps in outputs:
        total = total + loss_module(heatmaps, batch["heatmaps"], batch.get("keypoint_weights"))
    return {"loss_kpt": total}


def mspn_head_loss(outputs: Sequence[torch.Tensor], batch: Dict[str, Any], loss_module: Any,
                   level_indices: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Each (stage, unit) map against the target level ``level_indices``
    picks (``:178``): ``batch["multilevel_heatmaps"]``, a list over levels of
    (B, K, H, W), and ``multilevel_keypoint_weights`` (B, L, K) where given."""
    targets = batch["multilevel_heatmaps"]
    weights = batch.get("multilevel_keypoint_weights")
    total = 0.0
    for i, heatmaps in enumerate(outputs):
        level = level_indices[i]
        total = total + loss_module(heatmaps, targets[level], None if weights is None else weights[:, level])
    return {"loss_kpt": total}
