"""MobileNetV2's depthwise 3x3 convolutions as CUDA kernels, and their plain
twin.

Replaces no TPU kernel: the JAX package's ``MobileNetV2``
(``probpose_code_tpu/models/backbones/mobilenet_v2.py:45-47``) runs them as
XLA's grouped convolution. On the card cuDNN's depthwise kernels (forward,
input and weight gradients) took more than 2% of the hand recipe's step
(H100 80GB HBM3, 700 W), so the source ``probpose_code_torch/csrc/
depthwise.cu`` computes them, f32, padding 1, stride 1 or 2, on
channels-last activations of a channel count that is a multiple of 4 (every
MobileNetV2 width; another raises); it says what bounds them.

``depthwise_conv3x3`` takes a CPU tensor to the plain twin (``F.conv2d``
with one group a channel, which torch autograd differentiates) and a CUDA
tensor to a ``torch.autograd.Function`` whose forward and backward are the
kernels; there is no fallback from one to the other. Each launching
function counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "depthwise_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "depthwise_backward": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "depthwise_scratch": ([ctypes.c_int] * 4, ctypes.c_longlong),
}
STRIDES = (1, 2)


def _lib():
    return _build.load("depthwise", _SIGNATURES)


def depthwise_conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, C, H, W) and (C, 1, 3, 3) -> the depthwise convolution, padding 1."""
    return F.conv2d(x, weight, None, stride, 1, 1, x.shape[1])


def _out_size(H: int, W: int, stride: int) -> Tuple[int, int]:
    return (H - 1) // stride + 1, (W - 1) // stride + 1


def _check(x: torch.Tensor, weight: torch.Tensor, stride: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"depthwise: unsupported device {x.device}")
    C = x.shape[1] if x.dim() == 4 else -1
    if x.dtype != torch.float32 or x.dim() != 4 or weight.dtype != torch.float32 or weight.shape != (C, 1, 3, 3):
        raise ValueError(f"depthwise: expected float32 (B, C, H, W) and (C, 1, 3, 3), got {x.dtype} "
                         f"{tuple(x.shape)} and {weight.dtype} {tuple(weight.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"depthwise: the kernels take strides {STRIDES}, got {stride}")
    if C % 4:
        raise ValueError(f"depthwise: the kernels take channel counts that are multiples of 4, got {C}")
    if x.numel() >= 2**31:
        raise ValueError(f"depthwise: the kernels index tensors of under 2^31 elements, got {x.numel()}")


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` channels last, its data 16-byte aligned (the kernels' float4
    loads): a copy where a view's offset breaks the alignment."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.channels_last)


def depthwise_forward(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """The forward launch on CUDA tensors: (B, C, Ho, Wo), channels last."""
    _check(x, weight, stride)
    x = _channels_last(x)
    weight = weight.contiguous()
    B, C, H, W = x.shape
    Ho, Wo = _out_size(H, W, stride)
    y = torch.empty((B, C, Ho, Wo), device=x.device, dtype=torch.float32, memory_format=torch.channels_last)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.depthwise_forward(x.data_ptr(), weight.data_ptr(), y.data_ptr(), B, C, H, W, Ho, Wo, stride,
                                     _build.stream_of(x))
    _build.check(lib, "depthwise", code)
    depthwise_forward.launches += 1
    return y


depthwise_forward.launches = 0


def depthwise_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                       stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward launch on CUDA tensors: the gradients of the input
    (channels last) and of the weight from the output's gradient ``dy``."""
    _check(x, weight, stride)
    x = _channels_last(x)
    dy = _channels_last(dy.to(torch.float32))
    weight = weight.contiguous()
    B, C, H, W = x.shape
    Ho, Wo = _out_size(H, W, stride)
    if dy.shape != (B, C, Ho, Wo):
        raise ValueError(f"depthwise: expected a {(B, C, Ho, Wo)} gradient, got {tuple(dy.shape)}")
    lib = _lib()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dw = torch.empty_like(weight)
    scratch = torch.empty(lib.depthwise_scratch(B, C, Ho, Wo), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        code = lib.depthwise_backward(dy.data_ptr(), x.data_ptr(), weight.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                                      scratch.data_ptr(), B, C, H, W, Ho, Wo, stride, _build.stream_of(x))
    _build.check(lib, "depthwise", code)
    depthwise_backward.launches += 1
    return dx, dw


depthwise_backward.launches = 0


class _Depthwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        return depthwise_forward(x, weight, stride)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = depthwise_backward(dy, x, weight, ctx.stride)
        return dx, dw, None


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """The depthwise 3x3 convolution (padding 1): the plain twin on a CPU
    tensor, the kernels on a CUDA one."""
    if x.device.type == "cpu":
        return depthwise_conv3x3_plain(x, weight, stride)
    return _Depthwise.apply(x, weight, stride)


def depthwise_bytes(B: int, C: int, H: int, W: int, stride: int) -> Tuple[int, int]:
    """The bytes the forward and the backward must move, each input read
    once and each output written once: x, w -> y; dy, x, w -> dx, dw."""
    Ho, Wo = _out_size(H, W, stride)
    x, y, w = B * C * H * W, B * C * Ho * Wo, C * 9
    return 4 * (x + w + y), 4 * (y + x + w + x + w)
