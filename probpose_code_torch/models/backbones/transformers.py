"""The transformer backbones in PyTorch: SwinTransformer, HRFormer, PVT and PVTv2.

Port of ``probpose_code_tpu/models/backbones/transformers.py``: ``Mlp``
(``:26``), ``WindowAttention`` (``:38``), ``window_partition`` /
``window_reverse`` (``:76``, ``:82``), ``SwinBlock`` (``:88``),
``SwinTransformer`` (``:132``), ``SRAttention`` (``:170``), ``MixFFN``
(``:198``), ``PyramidVisionTransformer`` (``:223``) and
``PyramidVisionTransformerV2`` (``:278``); and of ``HRFormerBlock`` and
``HRFormer`` (``probpose_code_tpu/models/backbones/nas_and_3d.py:188-291``).
LayerNorm is flax's (eps 1e-6, statistics in f32: ``ops/kernels/layer_norm.py``,
on the card the kernels of ``csrc/layer_norm.cu``),
GELU the exact (erf) one, products in ``dtype`` (f32 in every config),
softmax in f32; the outputs are f32 maps (B, C, h, w).

Parameters sized by the input. The flax modules size some parameters from
the data, so these take the input's size, ``img_size`` (H, W), when they are
built (``sized_by_input``: ``models/builder.py`` passes the codec's ``input_size``), and refuse another
size with a ``ValueError`` (no interpolation):

- a window's side is ``min(window_size, h, w)`` of its map, and its relative
  position table ``(2 ws - 1) ** 2`` rows: Swin-T at 256 x 192 has 169 rows
  in stages 1-3 and 121 in stage 4 (8 x 6, ``ws`` 6), HRFormer's fourth
  branch the same; mmpose keeps the window and pads, by a reading of mmpose;
- PVT's ``pos_embed`` is (1, h * w, C) for each stage's grid.

Swin: a 4x4 stride-4 patch embed and its LayerNorm, then per stage ``depth``
blocks (LayerNorm, window attention with the relative position bias, every
other block on a map rolled by ``window_size // 2`` with the nine-region
mask (0 / -100), unless the window covers the map and the shift is not under
it; zero padding at the bottom and right to whole windows; the residual MLP),
``norm{i}`` at ``out_indices`` and patch merging between stages (odd sides
padded; the 2 x 2 neighbours in the order (0, 0), (1, 0), (0, 1), (1, 1);
LayerNorm; a reduction without bias).

HRFormer: two strided 3x3 ``ConvModule``s to 64, two bottlenecks of width
16 (``hrnet.Bottleneck``), a 3x3 transition to ``base_channels`` beside a
strided one to twice that, then three stages of ``num_modules`` modules, each
``depths[s]`` blocks a branch (LayerNorm, non-shifted window attention with
``num_heads[j]`` heads, LayerNorm, the conv FFN: pointwise, GELU, depthwise
3x3 with bias, GELU, pointwise) and HRNet's fuse (a 1x1 conv, BN and the
nearest resize from a coarser branch, JAX's half-pixel rule; strided 3x3
``ConvModule``s from a finer one, no ReLU on the last); a strided 3x3
``ConvModule`` adds a branch after the first two stages. It returns the
finest branch (every branch with ``multiscale_output``); without it the last
module fuses into the finest branch alone (the rest is never read). The
JAX module's per-module projections of a branch whose width is not its
stage's are never built: every branch is made at its stage's width.

PVT / PVTv2: per stage a patch embed ("VALID", or the explicit padding) and
its LayerNorm, ``pos_embed`` (PVT), pre-norm blocks of spatial-reduction
attention (``q``; keys and values from the map reduced by a stride-``sr``
conv and LayerNorm where ``sr > 1``) and the FFN (PVTv2: a depthwise 3x3 with
bias between its products), and a LayerNorm after the stage (PVTv2).
``embed_dims`` is a per-stage tuple, or an int times ``num_heads[i]``.

On the card the depthwise convs of HRFormer's and PVTv2's FFNs run
``ops/kernels/depthwise.py`` (``csrc/depthwise.cu``; their bias is added
after it), f32 only; the plain twin on the CPU.

Every strided conv here pads nothing or pads 1 on each side (mmpose's
layout): the JAX "SAME" agrees where the strided inputs' sides are multiples
of the stride (Swin and PVT at sides that are multiples of 32) or odd
(HRFormer's strided 3x3 convs, e.g. at 257 x 193).

Names, under ``backbone.`` (mmpose's by a reading of its modules where the
structure is the same; no mmpose checkpoint of these families is in the
repository to check them):

- Swin: ``patch_embed.projection`` / ``.norm``,
  ``stages.{i}.blocks.{b}.norm1``, ``.attn.w_msa.qkv``, ``.attn.w_msa.proj``,
  ``.attn.w_msa.relative_position_bias_table``, ``.norm2``,
  ``.ffn.layers.0.0`` / ``.ffn.layers.1``, ``stages.{i}.downsample.norm`` /
  ``.reduction`` (mmpose's unfold orders the merged channels channel-major,
  these are neighbour-major, as in the JAX module), ``norm{i}``;
- HRFormer: ``conv1`` / ``bn1``, ``conv2`` / ``bn2``,
  ``layer1.{b}.conv{1,2,3}`` / ``bn{1,2,3}``, ``transition1.0.{0,1}``,
  ``transition{t}.{j}.0.{0,1}`` for a new branch,
  ``stage{s}.{m}.branches.{j}.{b}.norm1``, ``.attn.attn.qkv`` / ``.proj`` /
  ``.relative_position_bias_table``, ``.norm2``, ``.ffn.fc1``,
  ``.ffn.dw3x3``, ``.ffn.fc2`` (mmpose's FFN has 1x1 convs and a BatchNorm
  after each step: these names are not its structure),
  ``stage{s}.{m}.fuse_layers.{a}.{b}.{0,1}`` and ``.{a}.{b}.{k}.{0,1}``;
- PVT: ``layers.{i}.0.projection`` / ``.norm``, ``layers.{i}.1.0.pos_embed``
  (PVT; its blocks then from ``layers.{i}.1.1``), ``layers.{i}.1.{k}.norm1``,
  ``.attn.attn.in_proj_weight`` / ``in_proj_bias`` (q, k and v stacked),
  ``.attn.attn.out_proj``, ``.attn.sr``, ``.attn.norm``, ``.norm2``,
  ``.ffn.layers.0`` (fc1), ``.ffn.layers.1`` (the depthwise conv, PVTv2),
  ``.ffn.layers.4`` (PVTv2) or ``.3`` (fc2), ``layers.{i}.2`` (PVTv2's
  norm); mmpose's fc1 and fc2 are 1x1 convs, (out, in, 1, 1).

``engine/checkpoint.py:state_dict_from_jax`` carries the JAX variables onto
these names.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.models.backbones.hrnet import Blocks, Bottleneck, _bn
from probpose_code_torch.models.backbones.litehrnet import resize_nearest
from probpose_code_torch.models.backbones.vit import FFN, linear, resolve_dtype
from probpose_code_torch.models.heads.heatmap_head import conv_in
from probpose_code_torch.ops.kernels.depthwise import depthwise_conv3x3
from probpose_code_torch.ops.kernels.layer_norm import layer_norm
from probpose_code_torch.registry import MODELS


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def _check_size(name: str, built: Tuple[int, int], got: Tuple[int, int]) -> None:
    if tuple(built) != tuple(got):
        raise ValueError(f"{name} was built for inputs of {tuple(built)} (H, W), whose sizes set its parameters' "
                         f"shapes; got {tuple(got)}: build it with img_size={tuple(got)}")


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H / ws * W / ws, ws * ws, C), windows row-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(N, N) rows of the relative position table, N = ws * ws."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + ws - 1
    return rel[0] * (2 * ws - 1) + rel[1]


def shift_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N): 0 within one of the nine regions of the rolled map, -100
    across two."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws)[..., 0].numpy()
    return np.where(mw[:, None, :] == mw[:, :, None], 0.0, -100.0).astype(np.float32)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B_, h, N, D) scaled q, k, v; ``bias`` (h, N, N); ``mask`` (nW, N, N)
    or None, the windows of an image consecutive in B_ -> (B_, h, N, D):
    softmax(q k^T + bias + mask) v, the softmax in f32."""
    B_, heads, N, _ = q.shape
    attn = q @ k.transpose(-2, -1) + bias[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.view(B_ // nW, nW, heads, N, N) + mask[None, :, None]).view(B_, heads, N, N)
    return torch.softmax(attn.float(), dim=-1).to(q.dtype) @ v


class WindowMSA(nn.Module):
    """Multi-head self-attention within windows of ``ws * ws`` tokens with the
    relative position bias (``relative_position_bias_table``, (2 ws - 1) ** 2
    rows, one column a head), an optional mask, then ``proj``."""

    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(ws).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        B_, N, C = x.shape
        D = C // self.num_heads
        qkv = linear(x, self.qkv, dtype).reshape(B_, N, 3, self.num_heads, D).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[self.relative_position_index].view(N, N, -1).permute(2, 0, 1)
        out = window_attention_plain(qkv[0] * D ** -0.5, qkv[1], qkv[2], bias.to(dtype), mask)
        return linear(out.transpose(1, 2).reshape(B_, N, C), self.proj, dtype)


def mlp(ffn: FFN, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX ``Mlp``: fc1, exact GELU, fc2."""
    return linear(F.gelu(linear(x, ffn.fc1, dtype)), ffn.fc2, dtype)


class _Container(nn.Module):
    """A module that only names its children (mmpose's wrappers)."""


def windowed_attention(x: torch.Tensor, norm: nn.LayerNorm, attn: WindowMSA, ws: int, shift: int,
                       mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) -> the attention branch: LayerNorm, bottom / right zero
    padding to whole windows, the roll by ``shift``, the windows' attention,
    the roll back and the crop."""
    B, H, W, C = x.shape
    y = layer_norm(x, norm).to(dtype)
    pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
    y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    y = window_reverse(attn(window_partition(y, ws), mask, dtype), ws, H + pad_b, W + pad_r)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y[:, :H, :W]


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int, mlp_ratio: float,
                 hw: Tuple[int, int]):
        super().__init__()
        H, W = self.hw = tuple(hw)
        self.ws = ws = min(window_size, H, W)
        self.shift = shift if ws < min(H, W) or shift < ws else 0
        self.norm1 = _ln(dim)
        self.attn = _Container()
        self.attn.w_msa = WindowMSA(dim, num_heads, ws)
        self.norm2 = _ln(dim)
        self.ffn = FFN(dim, int(dim * mlp_ratio))
        mask = None
        if self.shift:
            Hp, Wp = H + (ws - H % ws) % ws, W + (ws - W % ws) % ws
            mask = torch.from_numpy(shift_mask(Hp, Wp, ws, self.shift))
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C)."""
        x = x + windowed_attention(x, self.norm1, self.attn.w_msa, self.ws, self.shift,
                                   None if self.attn_mask is None else self.attn_mask.to(dtype), dtype)
        return x + mlp(self.ffn, layer_norm(x, self.norm2).to(dtype), dtype)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = _ln(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return linear(layer_norm(x, self.norm).to(dtype), self.reduction, dtype)


@MODELS.register_module()
class SwinTransformer(nn.Module):
    sized_by_input = True  # built for one img_size: the builder passes the codec's input_size

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7, mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (3,), img_size: Tuple[int, int] = (256, 192), in_channels: int = 3,
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.img_size = tuple(img_size)
        self.out_indices = tuple(out_indices)
        self.patch_embed = _Container()
        self.patch_embed.projection = nn.Conv2d(in_channels, embed_dims, 4, 4)
        self.patch_embed.norm = _ln(embed_dims)
        H, W = self.img_size[0] // 4, self.img_size[1] // 4
        dim = embed_dims
        self.stages = nn.ModuleList()
        for i, depth in enumerate(depths):
            stage = _Container()
            stage.blocks = nn.ModuleList(
                SwinBlock(dim, num_heads[i], window_size, 0 if b % 2 == 0 else window_size // 2, mlp_ratio, (H, W))
                for b in range(depth))
            if i < len(depths) - 1:
                stage.downsample = PatchMerging(dim)
            self.stages.append(stage)
            if i in self.out_indices:
                setattr(self, f"norm{i}", _ln(dim))
            if i < len(depths) - 1:
                H, W, dim = -(-H // 2), -(-W // 2), 2 * dim

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices``, (B, C, h, w) f32;
        ``generator`` is accepted for the estimator's call and unused."""
        _check_size("SwinTransformer", self.img_size, x.shape[2:])
        dt = self.dtype
        x = conv_in(self.patch_embed.projection, x, dt).permute(0, 2, 3, 1)
        x = layer_norm(x, self.patch_embed.norm).to(dt)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x, dt)
            if i in self.out_indices:
                outs.append(layer_norm(x, getattr(self, f"norm{i}")).permute(0, 3, 1, 2).contiguous())
            if hasattr(stage, "downsample"):
                x = stage.downsample(x, dt)
        return tuple(outs)


# -- HRFormer -------------------------------------------------------------------------------


def depthwise_with_bias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A depthwise 3x3 conv with a bias (padding 1): ``depthwise_conv3x3``,
    then the bias."""
    return depthwise_conv3x3(x.float(), conv.weight, conv.stride[0]) + conv.bias[:, None, None]


class HRFormerFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dw3x3 = nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C)."""
        h = F.gelu(linear(x, self.fc1, dtype))
        h = F.gelu(depthwise_with_bias(self.dw3x3, h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return linear(h, self.fc2, dtype)


class HRFormerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, hw: Tuple[int, int], mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = min(window_size, *hw)
        self.norm1 = _ln(dim)
        self.attn = _Container()
        self.attn.attn = WindowMSA(dim, num_heads, self.ws)
        self.norm2 = _ln(dim)
        self.ffn = HRFormerFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C)."""
        x = x + windowed_attention(x, self.norm1, self.attn.attn, self.ws, 0, None, dtype)
        return x + self.ffn(layer_norm(x, self.norm2).to(dtype), dtype)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, relu: bool = True) -> nn.Sequential:
    mods = [nn.Conv2d(cin, cout, k, stride, k // 2, bias=False), _bn(cout)]
    return nn.Sequential(*mods, nn.ReLU()) if relu else nn.Sequential(*mods)


def _run(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conv, BN (and ReLU) sequence: the conv in ``dtype``, the rest in f32."""
    x = seq[1](conv_in(seq[0], x, dtype).float())
    return torch.relu(x) if len(seq) > 2 else x


def _strided(hw: Tuple[int, int]) -> Tuple[int, int]:
    """A map's side after a 3x3 stride-2 conv padded by 1."""
    return (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1


class HRFormerModule(nn.Module):
    def __init__(self, channels: Sequence[int], heads: Sequence[int], depth: int, window_size: int,
                 sizes: Sequence[Tuple[int, int]], fuse_rows: int):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.ModuleList(HRFormerBlock(channels[j], heads[j], window_size, sizes[j]) for _ in range(depth))
            for j in range(n))
        self.fuse_layers = nn.ModuleList()
        for a in range(n):
            row = []
            for b in range(n):
                if b > a:
                    row.append(_conv_bn(channels[b], channels[a], 1, relu=False))
                elif b < a:
                    row.append(nn.Sequential(*(
                        _conv_bn(channels[b], channels[a] if k == a - b - 1 else channels[b], 3, 2,
                                 relu=k != a - b - 1) for k in range(a - b))))
                else:
                    row.append(None)
            self.fuse_layers.append(nn.ModuleList(row))
        self.fuse_rows = fuse_rows

    def forward(self, xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        ys = []
        for x, blocks in zip(xs, self.branches):
            t = x.permute(0, 2, 3, 1)
            for block in blocks:
                t = block(t, dtype)
            ys.append(t.permute(0, 3, 1, 2))
        fused = []
        for a, row in enumerate(self.fuse_layers[:self.fuse_rows]):
            acc = ys[a].float()
            for b, layer in enumerate(row):
                if layer is None:
                    continue
                if b > a:
                    y = resize_nearest(_run(layer, ys[b], dtype), acc.shape[2], acc.shape[3])
                else:
                    y = ys[b]
                    for step in layer:
                        y = _run(step, y, dtype)
                acc = acc + y.float()
            fused.append(torch.relu(acc))
        return fused


@MODELS.register_module()
class HRFormer(nn.Module):
    sized_by_input = True  # built for one img_size: the builder passes the codec's input_size

    def __init__(self, base_channels: int = 32, num_heads: Sequence[int] = (1, 2, 4, 8),
                 depths: Sequence[int] = (2, 2, 2), num_modules: Sequence[int] = (1, 1, 1), window_size: int = 7,
                 multiscale_output: bool = False, img_size: Tuple[int, int] = (256, 192), in_channels: int = 3,
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        if self.dtype != torch.float32:
            raise NotImplementedError("HRFormer: float32 only (its FFNs' depthwise kernels are f32)")
        self.img_size = tuple(img_size)
        self.multiscale_output = multiscale_output
        self.conv1 = nn.Conv2d(in_channels, 64, 3, 2, 1, bias=False)
        self.bn1 = _bn(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = _bn(64)
        self.layer1 = Blocks(Bottleneck(64, 16), Bottleneck(64, 16))
        c = base_channels
        chans = [c, 2 * c, 4 * c, 8 * c]
        sizes = [_strided(_strided(self.img_size))]
        sizes.append(_strided(sizes[0]))
        self.transition1 = nn.ModuleList([_conv_bn(64, chans[0], 3), nn.Sequential(_conv_bn(64, chans[1], 3, 2))])
        for stage in range(3):
            nb = stage + 2
            last_stage = stage == 2
            setattr(self, f"stage{stage + 2}", nn.ModuleList(
                HRFormerModule(chans[:nb], num_heads[:nb], depths[stage], window_size, sizes[:nb],
                               1 if last_stage and m == num_modules[stage] - 1 and not multiscale_output else nb)
                for m in range(num_modules[stage])))
            if stage < 2:
                setattr(self, f"transition{stage + 2}", nn.ModuleList(
                    [None] * nb + [nn.Sequential(_conv_bn(chans[nb - 1], chans[nb], 3, 2))]))
                sizes.append(_strided(sizes[-1]))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> ((B, C, H / 4, W / 4) f32,), or every branch with
        ``multiscale_output``; ``generator`` is accepted for the estimator's
        call and unused."""
        _check_size("HRFormer", self.img_size, x.shape[2:])
        dt = self.dtype
        x = torch.relu(self.bn1(conv_in(self.conv1, x, dt).float()))
        x = torch.relu(self.bn2(conv_in(self.conv2, x, dt).float()))
        x = self.layer1(x, dt).contiguous(memory_format=torch.channels_last)
        xs = [_run(self.transition1[0], x, dt), _run(self.transition1[1][0], x, dt)]
        for stage in (2, 3, 4):
            xs = [t.contiguous(memory_format=torch.channels_last) for t in xs]
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs, dt)
            if stage < 4:
                new = getattr(self, f"transition{stage}")[len(xs)][0]
                xs = xs + [_run(new, xs[-1], dt)]
        return tuple(t.float().contiguous() for t in xs)


# -- PVT / PVTv2 -------------------------------------------------------------------------------


def sr_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, h, N, D) q, (B, h, M, D) k and v -> softmax(q k^T / sqrt(D)) v,
    the softmax in f32."""
    attn = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return torch.softmax(attn.float(), dim=-1).to(q.dtype) @ v


class _InProjection(nn.Module):
    """nn.MultiheadAttention's names: q, k and v stacked in ``in_proj_weight``
    (3C, C) and ``in_proj_bias``, then ``out_proj``."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class SRAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.attn = _InProjection(dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = _ln(dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
        B, N, C = x.shape
        D = C // self.num_heads
        w, b = self.attn.in_proj_weight.to(dtype), self.attn.in_proj_bias.to(dtype)
        q = F.linear(x.to(dtype), w[:C], b[:C]).reshape(B, N, self.num_heads, D).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            fm = conv_in(self.sr, x.transpose(1, 2).reshape(B, C, *hw), dtype)
            kv_in = layer_norm(fm.flatten(2).transpose(1, 2), self.norm).to(dtype)
        kv = F.linear(kv_in.to(dtype), w[C:], b[C:]).reshape(B, -1, 2, self.num_heads, D).permute(2, 0, 3, 1, 4)
        out = sr_attention_plain(q, kv[0], kv[1])
        return linear(out.transpose(1, 2).reshape(B, N, C), self.attn.out_proj, dtype)


class MixFFN(nn.Module):
    """``layers.0`` fc1, ``layers.1`` the depthwise 3x3 with bias (with
    ``use_conv``), GELU, fc2 (``layers.4``, or ``layers.3`` without the conv)."""

    def __init__(self, dim: int, hidden: int, use_conv: bool):
        super().__init__()
        mods = [nn.Linear(dim, hidden)]
        if use_conv:
            mods.append(nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden))
        self.layers = nn.Sequential(*mods, nn.GELU(), nn.Dropout(0.0), nn.Linear(hidden, dim))
        self.use_conv = use_conv

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
        B, N, _ = x.shape
        h = linear(x, self.layers[0], dtype)
        if self.use_conv:
            h = depthwise_with_bias(self.layers[1], h.view(B, *hw, -1).permute(0, 3, 1, 2))
            h = h.permute(0, 2, 3, 1).reshape(B, N, -1)
        return linear(F.gelu(h), self.layers[-1], dtype)


class PVTEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int, use_conv: bool):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = _ln(dim)
        self.ffn = MixFFN(dim, dim * mlp_ratio, use_conv)

    def forward(self, t: torch.Tensor, hw: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
        t = t + self.attn(layer_norm(t, self.norm1).to(dtype), hw, dtype)
        return t + self.ffn(layer_norm(t, self.norm2).to(dtype), hw, dtype)


class AbsolutePositionEmbedding(nn.Module):
    def __init__(self, tokens: int, dim: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))


@MODELS.register_module()
class PyramidVisionTransformer(nn.Module):
    sized_by_input = True  # built for one img_size: the builder passes the codec's input_size

    def __init__(self, embed_dims: Any = (64, 128, 320, 512), num_layers: Sequence[int] = (3, 4, 6, 3),
                 num_heads: Sequence[int] = (1, 2, 5, 8), sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4), patch_sizes: Sequence[int] = (4, 2, 2, 2),
                 strides: Sequence[int] = (4, 2, 2, 2), paddings: Sequence[int] = (0, 0, 0, 0),
                 out_indices: Sequence[int] = (0, 1, 2, 3), use_abs_pos_embed: bool = True,
                 norm_after_stage: bool = False, use_conv_ffn: bool = False, img_size: Tuple[int, int] = (256, 192),
                 in_channels: int = 3, dtype: Any = "float32"):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        if use_conv_ffn and self.dtype != torch.float32:
            raise NotImplementedError("PyramidVisionTransformer: the conv FFN runs in float32 only (its depthwise "
                                      "kernels are f32)")
        self.img_size = tuple(img_size)
        self.out_indices = tuple(out_indices)
        self.use_abs_pos_embed = use_abs_pos_embed
        self.layers = nn.ModuleList()
        self.grids = []
        H, W = self.img_size
        cin = in_channels
        for i in range(len(num_layers)):
            dim = embed_dims * num_heads[i] if isinstance(embed_dims, int) else embed_dims[i]
            p, s, pad = patch_sizes[i], strides[i], paddings[i]
            H, W = (H + 2 * pad - p) // s + 1, (W + 2 * pad - p) // s + 1
            self.grids.append((H, W))
            embed = _Container()
            embed.projection = nn.Conv2d(cin, dim, p, s, pad)
            embed.norm = _ln(dim)
            blocks = [AbsolutePositionEmbedding(H * W, dim)] if use_abs_pos_embed else []
            blocks += [PVTEncoderLayer(dim, num_heads[i], sr_ratios[i], mlp_ratios[i], use_conv_ffn)
                       for _ in range(num_layers[i])]
            self.layers.append(nn.ModuleList([embed, nn.ModuleList(blocks),
                                              _ln(dim) if norm_after_stage else nn.Identity()]))
            cin = dim

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, 3, H, W) -> the stages of ``out_indices``, (B, C, h, w) f32;
        ``generator`` is accepted for the estimator's call and unused."""
        _check_size(type(self).__name__, self.img_size, x.shape[2:])
        dt = self.dtype
        outs = []
        for i, (embed, blocks, norm) in enumerate(self.layers):
            x = conv_in(embed.projection, x, dt)
            B, C, H, W = x.shape
            t = layer_norm(x.flatten(2).transpose(1, 2), embed.norm).to(dt)
            if self.use_abs_pos_embed:
                t = t + blocks[0].pos_embed.to(dt)
            for block in blocks[int(self.use_abs_pos_embed):]:
                t = block(t, (H, W), dt)
            if isinstance(norm, nn.LayerNorm):
                t = layer_norm(t, norm).to(dt)
            x = t.transpose(1, 2).reshape(B, C, H, W)
            if i in self.out_indices:
                outs.append(x.float().contiguous())
        return tuple(outs)


@MODELS.register_module()
class PyramidVisionTransformerV2(PyramidVisionTransformer):
    """PVTv2's defaults: overlapping patch embeds (7 / 3 / 3 / 3 kernels,
    padded 3 / 1 / 1 / 1), no position embedding, the depthwise conv FFN and
    a LayerNorm after every stage; ``embed_dims`` 64 times the heads."""

    def __init__(self, embed_dims: Any = 64, patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 paddings: Sequence[int] = (3, 1, 1, 1), use_abs_pos_embed: bool = False,
                 norm_after_stage: bool = True, use_conv_ffn: bool = True, **kwargs):
        super().__init__(embed_dims=embed_dims, patch_sizes=patch_sizes, paddings=paddings,
                         use_abs_pos_embed=use_abs_pos_embed, norm_after_stage=norm_after_stage,
                         use_conv_ffn=use_conv_ffn, **kwargs)
