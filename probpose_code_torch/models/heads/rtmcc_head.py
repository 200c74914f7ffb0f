"""The SimCC heads in PyTorch: RTMCCHead (RTMPose), SimCCHead and RTMWHead.

Port of ``probpose_code_tpu/models/heads/rtmcc_head.py:RTMCCHead`` (``:60``):
the last feature map -> a 7x7 conv (with bias) to one map a keypoint ->
each map flattened into a token -> ScaleNorm and a linear layer (no bias)
to ``hidden_dims`` -> one GAU (``models/utils/rtmcc_block.py``) -> the x and
y classifiers over ``input_size * simcc_split_ratio`` bins (no bias).
Returns ``(pred_x (B, K, Wx), pred_y (B, K, Wy))`` in f32. Names are
mmpose's: ``final_layer``, ``mlp.0.g`` / ``mlp.1``, ``gau.*``, ``cls_x``,
``cls_y``.

``SimCCHead`` (``:27-57``): the heatmap heads' deconv stack
(``make_deconv_stack``; none with ``deconv_out_channels=None``) -> the final
conv ("SAME", with bias) -> each map flattened -> the ``mlp_head_x`` /
``mlp_head_y`` linears (with bias) over the bins. mmpose's names:
``deconv_layers.{0, 3, ...}`` / ``{1, 4, ...}``, ``final_layer``,
``mlp_head_x``, ``mlp_head_y``.

``RTMWHead`` (``:113-190``): the top level through a k x k ``ConvModule``
(conv without bias, BatchNorm eps 1e-5, ReLU) to one map a keypoint, its
tokens through ScaleNorm and a linear to ``hidden_dims / 2``; the top level
pixel-shuffled (``nn.PixelShuffle(2)``, NCHW) through a ``ConvModule`` to
``in_channels / 4``, concatenated with the level below, through a third
``ConvModule`` and the second token MLP; both halves concatenated into one
GAU, then ``cls_x`` / ``cls_y``. mmpose's names, which the JAX package's
``_convert_rtmw_head`` (``engine/checkpoint.py:621``) reads:
``final_layer.{conv,bn}``, ``conv_dec``, ``final_layer2``, ``mlp.0.g`` /
``mlp.1``, ``mlp2.0.g`` / ``mlp2.1``, ``gau.*``, ``cls_x``, ``cls_y``.
``feat_channels`` gives the widths of the two levels (``PoseModel`` passes
the neck's; by default ``in_channels / 2`` and ``in_channels``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from probpose_code_torch.models.backbones.classic import ConvModule
from probpose_code_torch.models.backbones.vit import resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import make_deconv_stack, run_sequential
from probpose_code_torch.models.utils.rtmcc_block import RTMCCBlock, ScaleNorm
from probpose_code_torch.registry import MODELS

GAU_DEFAULTS = dict(hidden_dims=256, s=128, expansion_factor=2, dropout_rate=0.0, drop_path=0.0, act_fn="ReLU",
                    use_rel_bias=False, pos_enc=False)


@MODELS.register_module()
class RTMCCHead(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, input_size: Tuple[int, int],
                 in_featuremap_size: Tuple[int, int], simcc_split_ratio: float = 2.0,
                 final_layer_kernel_size: int = 7, gau_cfg: Any = None, loss: Any = None, decoder: Any = None):
        super().__init__()
        gau = dict(GAU_DEFAULTS, **dict(gau_cfg or {}))
        k = final_layer_kernel_size
        self.final_layer = nn.Conv2d(in_channels, out_channels, k, padding=k // 2)
        flat = in_featuremap_size[0] * in_featuremap_size[1]
        self.mlp = nn.Sequential(ScaleNorm(flat), nn.Linear(flat, gau["hidden_dims"], bias=False))
        self.gau = RTMCCBlock(out_channels, gau["hidden_dims"], gau["hidden_dims"], s=gau["s"],
                              expansion_factor=gau["expansion_factor"], dropout_rate=gau["dropout_rate"],
                              drop_path=gau["drop_path"], act_fn=gau["act_fn"], use_rel_bias=gau["use_rel_bias"],
                              pos_enc=gau["pos_enc"])
        self.cls_x = nn.Linear(gau["hidden_dims"], int(input_size[0] * simcc_split_ratio), bias=False)
        self.cls_y = nn.Linear(gau["hidden_dims"], int(input_size[1] * simcc_split_ratio), bias=False)

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats  # (B, C, h, w)
        x = self.final_layer(x.float())
        x = self.gau(self.mlp(torch.flatten(x, 2)))  # (B, K, h * w) tokens
        return self.cls_x(x), self.cls_y(x)


@MODELS.register_module()
class SimCCHead(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, input_size: Tuple[int, int],
                 in_featuremap_size: Tuple[int, int], simcc_split_ratio: float = 2.0,
                 deconv_out_channels: Optional[Sequence[int]] = (256, 256, 256),
                 deconv_kernel_sizes: Optional[Sequence[int]] = (4, 4, 4), final_layer_kernel_size: int = 1,
                 loss: Any = None, decoder: Any = None, dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        channels, (w, h) = in_channels, in_featuremap_size
        self.deconv_layers = nn.Sequential()
        if deconv_out_channels:
            self.deconv_layers = make_deconv_stack(channels, deconv_out_channels, deconv_kernel_sizes)
            channels = deconv_out_channels[-1]
            w, h = w * 2 ** len(deconv_out_channels), h * 2 ** len(deconv_out_channels)
        self.final_layer = nn.Conv2d(channels, out_channels, final_layer_kernel_size, padding="same")
        self.mlp_head_x = nn.Linear(w * h, int(input_size[0] * simcc_split_ratio))
        self.mlp_head_y = nn.Linear(w * h, int(input_size[1] * simcc_split_ratio))

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats  # (B, C, h, w)
        x = run_sequential(self.deconv_layers, x, self.dtype)
        x = torch.flatten(self.final_layer(x.float()), 2)  # (B, K, h * w)
        return self.mlp_head_x(x), self.mlp_head_y(x)


@MODELS.register_module()
class RTMWHead(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, input_size: Tuple[int, int],
                 in_featuremap_size: Tuple[int, int], simcc_split_ratio: float = 2.0,
                 final_layer_kernel_size: int = 1, gau_cfg: Any = None, loss: Any = None, decoder: Any = None,
                 feat_channels: Optional[Sequence[int]] = None, dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        gau = dict(GAU_DEFAULTS, **dict(gau_cfg or {}))
        hidden, k = gau["hidden_dims"], final_layer_kernel_size
        low, top = tuple(feat_channels or (in_channels // 2, in_channels))[-2:]
        flat = in_featuremap_size[0] * in_featuremap_size[1]
        self.final_layer = ConvModule(top, out_channels, k)
        self.mlp = nn.Sequential(ScaleNorm(flat), nn.Linear(flat, hidden // 2, bias=False))
        self.shuffle = nn.PixelShuffle(2)
        self.conv_dec = ConvModule(top // 4, in_channels // 4, k)
        self.final_layer2 = ConvModule(in_channels // 4 + low, out_channels, k)
        self.mlp2 = nn.Sequential(ScaleNorm(4 * flat), nn.Linear(4 * flat, hidden // 2, bias=False))
        self.gau = RTMCCBlock(out_channels, hidden, hidden, s=gau["s"], expansion_factor=gau["expansion_factor"],
                              act_fn=gau["act_fn"], use_rel_bias=gau["use_rel_bias"], pos_enc=gau["pos_enc"])
        self.cls_x = nn.Linear(hidden, int(input_size[0] * simcc_split_ratio), bias=False)
        self.cls_y = nn.Linear(hidden, int(input_size[1] * simcc_split_ratio), bias=False)

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        enc_b, enc_t = feats[-2].float(), feats[-1].float()  # (B, C / 2, 2h, 2w), (B, C, h, w)
        ft = self.mlp(torch.flatten(self.final_layer(enc_t, self.dtype), 2))
        dec = self.conv_dec(self.shuffle(enc_t), self.dtype)
        fb = self.final_layer2(torch.cat([dec, enc_b], dim=1), self.dtype)
        tokens = self.gau(torch.cat([ft, self.mlp2(torch.flatten(fb, 2))], dim=-1))  # (B, K, hidden)
        return self.cls_x(tokens), self.cls_y(tokens)
