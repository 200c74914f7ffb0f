"""LayerNorm over the last axis (flax's semantics) as CUDA kernels, and its plain twin.

Replaces no TPU kernel: the JAX package's LayerNorm (``flax.linen.LayerNorm``
in ``probpose_code_tpu/models/backbones/transformers.py`` and
``nas_and_3d.py``) is XLA's. By the 2% rule (``PERF.md`` §6) it became a
kernel: in PyTorch it took 17% of Swin-T's B = 32 training step, 17% of
HRFormer-small's and 23% of PVTv2-b2's B = 64 on the card (H100 80GB HBM3,
700 W). The source ``probpose_code_torch/csrc/layer_norm.cu`` computes the
forward (statistics in f32, var = E[x^2] - mean^2 clipped at 0) and the
backward, f32, rows of C; it says what bounds them.

``layer_norm`` takes a CPU tensor to the plain twin (``layer_norm_plain``,
the port's ``models/backbones/vit.py:layer_norm_f32``, which torch autograd
differentiates) and a CUDA tensor to a ``torch.autograd.Function`` whose
forward and backward are the kernels; there is no fallback from one to the
other. The transformer backbones (``models/backbones/transformers.py``) call
it; the ViT's eager block keeps ``layer_norm_f32``. Each launching function
counts its calls in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_SIGNATURES = {
    "layer_norm_forward": [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "layer_norm_backward": [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "layer_norm_scratch": ([ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong),
}


def _lib():
    return _build.load("layer_norm", _SIGNATURES)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax LayerNorm over the last axis: statistics in f32 with var = E[x^2]
    - mean^2 clipped at 0; the result in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps) * weight + bias


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    C = x.shape[-1] if x.dim() else -1
    if x.dtype != torch.float32 or any(v.dtype != torch.float32 or v.shape != (C,) or v.device != x.device
                                       for v in (weight, bias)):
        raise ValueError(f"layer_norm: expected a float32 (..., C) tensor and float32 (C,) weight and bias on its "
                         f"device; got {x.dtype} {tuple(x.shape)}, {weight.dtype} {tuple(weight.shape)}, "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _call(entry: str, ref: torch.Tensor, *args) -> None:
    lib = _lib()
    with torch.cuda.device(ref.device):
        code = getattr(lib, entry)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                                   _build.stream_of(ref))
    _build.check(lib, "layer_norm", code)


def layer_norm_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward on a CUDA tensor, one launch: returns (y, mean, inv), the
    last two one a row."""
    _check(x, weight, bias)
    x = x.contiguous()
    C = x.shape[-1]
    R = x.numel() // C
    y = torch.empty_like(x)
    mean, inv = x.new_empty(R), x.new_empty(R)
    _call("layer_norm_forward", x, x, weight.contiguous(), bias.contiguous(), y, mean, inv, R, C, float(eps))
    layer_norm_forward.launches += 1
    return y, mean, inv


layer_norm_forward.launches = 0


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                        inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on CUDA tensors, three launches (dx a row; the column sums
    of dy x^ and dy, their finish): returns the gradients of x, the weight
    and the bias."""
    _check(x, weight, weight)
    if dy.shape != x.shape:
        raise ValueError(f"layer_norm: the gradient's shape {tuple(dy.shape)} is not the output's {tuple(x.shape)}")
    x, dy = x.contiguous(), dy.to(torch.float32).contiguous()
    C = x.shape[-1]
    R = x.numel() // C
    dx = torch.empty_like(x)
    dw, db = x.new_empty(C), x.new_empty(C)
    partial = x.new_empty(_lib().layer_norm_scratch(R, C))
    _call("layer_norm_backward", x, dy, x, weight.contiguous(), mean, inv, dx, dw, db, partial, R, C)
    layer_norm_backward.launches += 1
    return dx, dw, db


layer_norm_backward.launches = 0


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, inv = layer_norm_forward(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, inv = ctx.saved_tensors
        return (*layer_norm_backward(dy, x, weight, mean, inv), None)


def layer_norm(x: torch.Tensor, ln: torch.nn.LayerNorm) -> torch.Tensor:
    """``ln`` (its weight, bias and eps) over the last axis of ``x`` with
    flax's semantics, in f32: the plain twin on a CPU tensor, the kernels on
    a CUDA one."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, ln.weight, ln.bias, ln.eps)
    return _LayerNorm.apply(x.float(), ln.weight, ln.bias, ln.eps)


def layer_norm_bytes(elements: int, rows: int, channels: int) -> Tuple[int, int]:
    """The bytes the forward and the backward must move, each input read once
    and each output written once: x, w, b -> y (and a mean and inv a row);
    dy, x, w (and the row statistics) -> dx, dw, db."""
    return 4 * (2 * elements + 2 * channels + 2 * rows), 4 * (3 * elements + 3 * channels + 2 * rows)
