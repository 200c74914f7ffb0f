"""ProbMapHead, the ProbPose five-branch head, and DoubleProbMapHead, in PyTorch.

Port of ``probpose_code_tpu/models/heads/probmap_head.py``: ``ProbMapHead``
(``:63``), ``ScalarBranchTower`` (``:37``), ``HeatmapTower`` (``:161``, here a
``HeatmapHead``) and ``DoubleProbMapHead`` (``:193``). ProbMapHead, from the backbone's
(B, C, h, w) feature map:

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

DoubleProbMapHead has two heatmap towers, ``first_head`` (the tight "in"
window) and ``second_head`` (the expanded "out" window), each a deconv
stack, an optional conv stack, a 1x1 ``final_layer`` and, with
``normalize``, a sigmoid; and the same four scalar towers.
``detach_second_heatmaps`` cuts the gradient into the second tower's input
and ``freeze_second_heatmaps`` at its output. Its windows are merged in the
loss and predict programs (``models/pose_estimators/topdown.py``).

Module indices follow the reference keys (``head.deconv_layers.{0,1,3,4}``,
``head.final_layer``, ``head.<tower>.{0,1,4,5,8,9,12}``; DoubleProbMapHead's
``head.first_head.deconv_layers.{0,1,3,4}``, ``head.first_head.final_layer``
and the same under ``second_head``), so reference checkpoints load with
``strict=True``. The loss configs are kept as given:
``models/builder.py:build_loss_modules`` builds them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.ops.sparsemax import sparsemax
from probpose_code_torch.registry import MODELS

from .heatmap_head import BatchNorm2d, HeatmapHead, make_deconv_stack, run_sequential


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
        add_scalar_towers(self, in_channels, out_channels)

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
        return dict(heatmaps=_cut(heatmaps, self.freeze_heatmaps), **scalar_outputs(self, x))


def _cut(t: torch.Tensor, stop: bool) -> torch.Tensor:
    return t.detach() if stop else t


def add_scalar_towers(head: nn.Module, in_channels: int, out_channels: int) -> None:
    """The four scalar towers of the ProbMap heads, in reference order."""
    head.probability_layers = make_scalar_tower(in_channels, out_channels)
    head.visibility_layers = make_scalar_tower(in_channels, out_channels)
    head.oks_layers = make_scalar_tower(in_channels, out_channels)
    head.error_layers = make_scalar_tower(in_channels, out_channels)


def scalar_outputs(head: nn.Module, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The four scalar outputs with the head's detach / freeze switches."""
    x_det = x.detach()
    return dict(
        probabilities=_cut(torch.sigmoid(run_tower(
            head.probability_layers, _cut(x, head.detach_probability), head.dtype)), head.freeze_probability),
        visibilities=_cut(torch.sigmoid(run_tower(
            head.visibility_layers, _cut(x, head.detach_visibility), head.dtype)), head.freeze_visibility),
        oks=_cut(torch.sigmoid(run_tower(head.oks_layers, x_det, head.dtype)), head.freeze_oks),
        errors=_cut(torch.relu(run_tower(head.error_layers, x_det, head.dtype)), head.freeze_error),
    )


@MODELS.register_module()
class DoubleProbMapHead(nn.Module):
    """The dual-window ProbPose head (see the module). ``split_heatmaps_by``
    and the loss and decoder configs are read by the loss and predict
    programs."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        deconv_out_channels: Optional[Sequence[int]] = (256, 256, 256),
        deconv_kernel_sizes: Optional[Sequence[int]] = (4, 4, 4),
        conv_out_channels: Optional[Sequence[int]] = None,
        conv_kernel_sizes: Optional[Sequence[int]] = None,
        normalize: bool = False,
        detach_probability: bool = True,
        detach_visibility: bool = True,
        detach_second_heatmaps: bool = False,
        learn_heatmaps_from_zeros: bool = False,
        split_heatmaps_by: str = "in/all",
        freeze_heatmaps: bool = False,
        freeze_second_heatmaps: bool = False,
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
        if split_heatmaps_by not in ("visibility", "in/out", "in/all"):
            raise ValueError(f"split_heatmaps_by {split_heatmaps_by!r}")
        self.dtype = resolve_dtype(dtype)
        self.detach_probability = detach_probability
        self.detach_visibility = detach_visibility
        self.detach_second_heatmaps = detach_second_heatmaps
        self.freeze_heatmaps = freeze_heatmaps
        self.freeze_second_heatmaps = freeze_second_heatmaps
        self.freeze_probability = freeze_probability
        self.freeze_visibility = freeze_visibility
        self.freeze_oks = freeze_oks
        self.freeze_error = freeze_error
        self.decoder = decoder
        self.normalize = normalize
        # each tower is a HeatmapHead: deconv stack, conv stack, 1x1 final layer
        tower = dict(in_channels=in_channels, out_channels=out_channels, deconv_out_channels=deconv_out_channels,
                     deconv_kernel_sizes=deconv_kernel_sizes, conv_out_channels=conv_out_channels,
                     conv_kernel_sizes=conv_kernel_sizes, dtype=dtype)
        self.first_head = HeatmapHead(**tower)
        self.second_head = HeatmapHead(**tower)
        add_scalar_towers(self, in_channels, out_channels)

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats  # (B, C, h, w) f32

        def tower(head, inputs):
            h = head(inputs)
            return torch.sigmoid(h) if self.normalize else h

        heatmaps = _cut(tower(self.first_head, x), self.freeze_heatmaps)
        out_heatmaps = _cut(tower(self.second_head, _cut(x, self.detach_second_heatmaps)),
                            self.freeze_second_heatmaps)
        return dict(heatmaps=heatmaps, out_heatmaps=out_heatmaps, **scalar_outputs(self, x))
