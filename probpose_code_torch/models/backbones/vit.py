"""Vision Transformer backbone (mmpretrain layout) in PyTorch.

Port of ``probpose_code_tpu/models/backbones/vit.py``: ``VisionTransformer``
(``:343``), ``TransformerBlock`` (``:183``) and ``Attention`` (``:126``).
Patch conv k16 s16 with padding 2, a learned ``pos_embed``, no cls token,
pre-norm blocks with LayerNorm eps 1e-6, a final LayerNorm in f32, and a
feature map out in f32. ``dtype`` sets the residual stream's type (bf16 on
the card keeps the products fast; the parameters stay f32).

Which code runs a layer:
- K1 (``ops/kernels/vit_layer.py``), the whole layer for serving: with
  ``fused_layers`` None (auto) or True, whenever its shape rule ``fits``
  holds, in evaluation mode without autograd;
- K3 (``ops/kernels/vit_layer_train.py``), the differentiable whole layer:
  the same, but in training or whenever autograd needs the layer's
  gradient, and only with tanh-GELU (as in the JAX package, ``vit.py:
  215-218``);
- otherwise the eager block: ``fused_layers=False``, a shape that fails
  ``fits``, or training with exact (erf) GELU. Its products are torch's and
  its attention core is K4 (``ops/kernels/attention.py``, the JAX
  ``Attention`` with the fused kernel selected, ``vit.py:160``): a
  max-shifted softmax in f32.

Stochastic depth (``drop_path_rate``, linear over the blocks)
acts in training only, with per-image masks drawn from the generator the
caller passes. State-dict names are mmpretrain's, so reference checkpoints
load as they are.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.ops.kernels.attention import fused_attention
from probpose_code_torch.ops.kernels.vit_layer import fits, prepare_weights, vit_layer_prepared
from probpose_code_torch.ops.kernels.vit_layer_train import vit_layer_train
from probpose_code_torch.registry import MODELS

VIT_ARCH_ZOO = {
    "small": dict(embed_dims=384, num_layers=12, num_heads=12, feedforward_channels=1536),
    "base": dict(embed_dims=768, num_layers=12, num_heads=12, feedforward_channels=3072),
    "large": dict(embed_dims=1024, num_layers=24, num_heads=16, feedforward_channels=4096),
    "huge": dict(embed_dims=1280, num_layers=32, num_heads=16, feedforward_channels=5120),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Any) -> torch.dtype:
    if dtype is None:
        return torch.float32
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"dtype {dtype!r}: the port computes in float32 or bfloat16")
    return _DTYPES[name]


def layer_norm_f32(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax LayerNorm: statistics in f32 with var = E[x^2] - mean^2 clipped
    at 0; the result in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + ln.eps) * ln.weight + ln.bias


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense with ``dtype``: operands and bias in ``dtype``."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection; its core is K4
    (pre-scaled q, max-shifted softmax in f32), fed the qkv projection's
    strided views."""

    def __init__(self, embed_dims: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims, bias=qkv_bias)
        self.proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, N, C = x.shape
        D = C // self.num_heads
        qkv = linear(x, self.qkv, dtype).reshape(B, N, 3, self.num_heads, D)
        q, k, v = qkv.unbind(2)  # (B, N, h, D) views
        o = fused_attention(q, k, v, D ** -0.5).reshape(B, N, C)
        return linear(o, self.proj, dtype)


class FFN(nn.Module):
    """mmpretrain FFN naming: ``layers.0.0`` is fc1, ``layers.1`` is fc2."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels)),
            nn.Linear(feedforward_channels, embed_dims),
        )

    @property
    def fc1(self) -> nn.Linear:
        return self.layers[0][0]

    @property
    def fc2(self) -> nn.Linear:
        return self.layers[1]


class TransformerBlock(nn.Module):
    def __init__(
        self,
        embed_dims: int,
        num_heads: int,
        feedforward_channels: int,
        qkv_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        approximate_gelu: bool = False,
        fused_layers: Optional[bool] = None,
        drop_path_rate: float = 0.0,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.approximate_gelu = approximate_gelu
        self.fused_layers = fused_layers
        self.ln1 = nn.LayerNorm(embed_dims, eps=1e-6)
        self.attn = Attention(embed_dims, num_heads, qkv_bias)
        self.ln2 = nn.LayerNorm(embed_dims, eps=1e-6)
        self.ffn = FFN(embed_dims, feedforward_channels)
        self._prepared = None  # (key, K1's operands), see kernel_weights

    def layer_params(self) -> Tuple[torch.Tensor, ...]:
        """The twelve parameters in the kernels' order, weights as (in, out)."""
        qkv, proj, fc1, fc2 = self.attn.qkv, self.attn.proj, self.ffn.fc1, self.ffn.fc2
        C = qkv.in_features
        b_qkv = qkv.bias if qkv.bias is not None else torch.zeros(3 * C, device=qkv.weight.device)
        return (
            self.ln1.weight, self.ln1.bias, qkv.weight.t(), b_qkv, proj.weight.t(), proj.bias,
            self.ln2.weight, self.ln2.bias, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias,
        )

    def kernel_weights(self) -> Tuple[torch.Tensor, ...]:
        """K1's operands (``prepare_weights``). Without autograd they are kept
        and reused until a parameter is replaced or changed in place."""

        def prepare():
            return prepare_weights(*self.layer_params(), num_heads=self.num_heads, dtype=self.dtype)

        if torch.is_grad_enabled():
            return prepare()
        key = (self.dtype,) + tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._prepared is None or self._prepared[0] != key:
            self._prepared = (key, prepare())
        return self._prepared[1]

    def drop_masks(self, batch: int, generator: Optional[torch.Generator], device=None):
        """Per-image stochastic-depth multipliers for the two branches, 0 or
        1/keep (``vit.py:DropPath``, ``:39-52``), on ``device``, or
        (None, None) at rate 0."""
        if self.drop_path_rate == 0.0:
            return None, None
        if generator is None:
            raise ValueError("drop_path_rate > 0 in training needs a torch.Generator")
        keep = 1.0 - self.drop_path_rate
        u = torch.rand(2, batch, generator=generator, device=generator.device).to(device)
        m1, m2 = ((u < keep).float() / keep).unbind(0)
        return m1, m2

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        B, N, C = x.shape
        kernel = self.fused_layers is not False and fits(N, C, self.num_heads)
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())
        )
        m1 = m2 = None
        if self.training or needs_grad:
            if self.training:
                m1, m2 = self.drop_masks(B, generator, x.device)
            if kernel and self.approximate_gelu:
                return vit_layer_train(
                    x, *self.layer_params(), m1, m2, num_heads=self.num_heads, eps=self.ln1.eps,
                    dtype=self.dtype,
                )
        elif kernel:
            return vit_layer_prepared(
                x, self.kernel_weights(), num_heads=self.num_heads, eps=self.ln1.eps,
                approximate_gelu=self.approximate_gelu, dtype=self.dtype,
            )
        dt = self.dtype
        h = self.attn(layer_norm_f32(x, self.ln1).to(dt), dt)
        x = x + (h if m1 is None else h * m1[:, None, None].to(dt))
        h = linear(layer_norm_f32(x, self.ln2).to(dt), self.ffn.fc1, dt)
        h = F.gelu(h, approximate="tanh" if self.approximate_gelu else "none")
        h = linear(h, self.ffn.fc2, dt)
        return x + (h if m2 is None else h * m2[:, None, None].to(dt))


@MODELS.register_module()
class VisionTransformer(nn.Module):
    """ViT backbone: NCHW image in, tuple of one (B, C, h, w) f32 map out.

    ``arch`` is a preset name or a dict with embed_dims/num_layers/num_heads/
    feedforward_channels; ``img_size`` is (H, W) like mmpretrain.
    ``drop_path_rate`` is the last block's stochastic-depth rate; block i
    gets ``rate * i / (num_layers - 1)`` (``vit.py:398``).
    """

    def __init__(
        self,
        arch: Any = "small",
        img_size: Tuple[int, int] = (256, 192),
        patch_size: int = 16,
        patch_padding: int = 2,
        in_channels: int = 3,
        qkv_bias: bool = True,
        drop_path_rate: float = 0.0,
        with_cls_token: bool = False,
        out_type: str = "featmap",
        final_norm: bool = True,
        out_indices: Sequence[int] = (-1,),
        dtype: Any = "float32",
        approximate_gelu: bool = False,
        fused_layers: Optional[bool] = None,
    ):
        super().__init__()
        if with_cls_token or out_type != "featmap" or tuple(out_indices) != (-1,) or not final_norm:
            raise NotImplementedError(
                "the port's ViT emits the final featmap only (no cls token, out_indices=(-1,))"
            )
        arch = VIT_ARCH_ZOO[arch] if isinstance(arch, str) else dict(arch)
        self.embed_dims = C = arch["embed_dims"]
        self.num_layers = arch["num_layers"]
        self.dtype = resolve_dtype(dtype)
        H, W = img_size
        self.grid_h = (H + 2 * patch_padding - patch_size) // patch_size + 1
        self.grid_w = (W + 2 * patch_padding - patch_size) // patch_size + 1

        self.patch_embed = nn.Module()
        self.patch_embed.projection = nn.Conv2d(
            in_channels, C, kernel_size=patch_size, stride=patch_size, padding=patch_padding
        )
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid_h * self.grid_w, C))
        L = self.num_layers
        self.layers = nn.ModuleList(
            TransformerBlock(
                C, arch["num_heads"], arch["feedforward_channels"], qkv_bias=qkv_bias,
                dtype=self.dtype, approximate_gelu=approximate_gelu, fused_layers=fused_layers,
                drop_path_rate=drop_path_rate * i / max(L - 1, 1),
            )
            for i in range(L)
        )
        self.ln1 = nn.LayerNorm(C, eps=1e-6)  # the final norm, mmpretrain's name

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor]:
        """x: (B, 3, H, W) normalised image -> ((B, C, h, w) f32,).
        ``generator`` draws the stochastic-depth masks in training."""
        dt = self.dtype
        proj = self.patch_embed.projection
        x = F.conv2d(x.to(dt), proj.weight.to(dt), proj.bias.to(dt), proj.stride, proj.padding)
        B, C, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C), row-major over the grid
        x = x + self.pos_embed.to(dt)
        for layer in self.layers:
            x = layer(x.contiguous(), generator)
        y = layer_norm_f32(x, self.ln1)
        return (y.transpose(1, 2).reshape(B, C, gh, gw).contiguous(),)
