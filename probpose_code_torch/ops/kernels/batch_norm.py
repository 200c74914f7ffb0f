"""BatchNorm in training mode (flax's semantics) as CUDA kernels, and its plain twin.

Replaces no TPU kernel: the JAX package's BatchNorm (``flax.linen.BatchNorm``,
``probpose_code_tpu/models/backbones/resnet.py:_bn``) is XLA's. By the 2% rule
(``PERF.md`` §6) it became a kernel: in PyTorch it took 43% of LiteHRNet-18's
B = 64 training step and 17% of HRFormer-small's on the card (H100 80GB HBM3,
700 W). The source ``probpose_code_torch/csrc/batch_norm.cu`` computes the
batch statistics, the normalisation, the running statistics' update (with
the biased variance, as flax's) and the backward, f32, on NCHW or
channels-last maps; it says what bounds them.

``batch_norm_train`` takes a CPU tensor to the plain twin
(``batch_norm_train_plain``, which torch autograd differentiates) and a CUDA
tensor to a ``torch.autograd.Function`` whose forward and backward are the
kernels; there is no fallback from one to the other. ``models/heads/
heatmap_head.py:BatchNorm2d`` calls it in training mode (in evaluation mode
it normalises by the running statistics, as torch's BatchNorm2d does). Each
launching function counts its calls in ``launches`` (three kernel launches
each).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_SIGNATURES = {
    "batch_norm_forward": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "batch_norm_backward": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "batch_norm_scratch": ([ctypes.c_int] * 4, ctypes.c_longlong),
}


def _lib():
    return _build.load("batch_norm", _SIGNATURES)


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                           running_var: torch.Tensor, momentum: float, eps: float) -> torch.Tensor:
    """flax's ``nn.BatchNorm`` in training mode on (B, C, H, W): batch
    statistics in f32 with var = E[x^2] - mean^2 clipped at 0, the running
    statistics updated in place with that biased variance (``running = (1 -
    momentum) running + momentum stat``), the result in f32."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(momentum * var)
    mul = torch.rsqrt(var + eps) * weight
    return (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]


def _layout(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """``x`` dense in NCHW or channels last (a copy in NCHW otherwise), and
    whether it is channels last."""
    if x.is_contiguous():
        return x, False
    if x.is_contiguous(memory_format=torch.channels_last):
        return x, True
    return x.contiguous(), False


def _check(x: torch.Tensor, *vectors: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm: unsupported device {x.device}")
    C = x.shape[1] if x.dim() == 4 else -1
    if x.dtype != torch.float32 or x.dim() != 4 or any(
            v.dtype != torch.float32 or v.shape != (C,) or v.device != x.device or not v.is_contiguous()
            for v in vectors):
        raise ValueError(f"batch_norm: expected a float32 (B, C, H, W) map and contiguous float32 (C,) vectors on its "
                         f"device; got {x.dtype} {tuple(x.shape)}, "
                         f"{[(v.dtype, tuple(v.shape), str(v.device)) for v in vectors]}")
    if x.numel() >= 2**31:
        raise ValueError(f"batch_norm: the kernels take maps of under 2^31 elements, got {x.numel()}")


def _call(entry: str, ref: torch.Tensor, *args) -> None:
    lib = _lib()
    with torch.cuda.device(ref.device):
        code = getattr(lib, entry)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                                   _build.stream_of(ref))
    _build.check(lib, "batch_norm", code)


def batch_norm_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                       running_var: torch.Tensor, momentum: float,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward on a CUDA map, three launches (the channels' sums, their
    finish with the running statistics' update in place, the
    normalisation): returns (y in ``x``'s layout, mean, inv)."""
    _check(x, weight, bias, running_mean, running_var)
    x, last = _layout(x)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    mean, inv, coef = x.new_empty(C), x.new_empty(C), x.new_empty(2 * C)
    partial = x.new_empty(_lib().batch_norm_scratch(B, C, H * W, int(last)))
    _call("batch_norm_forward", x, x, weight, bias, y, mean, inv, running_mean, running_var, coef, partial, B, C,
          H * W, int(last), float(momentum), float(eps))
    batch_norm_forward.launches += 1
    return y, mean, inv


batch_norm_forward.launches = 0


def batch_norm_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                        inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on CUDA tensors, three launches (the sums of dy and dy (x
    - mean), their finish, dx): returns the gradients of x (in its layout),
    the weight and the bias."""
    _check(x, weight, mean, inv)
    x, last = _layout(x)
    if dy.shape != x.shape:
        raise ValueError(f"batch_norm: the gradient's shape {tuple(dy.shape)} is not the output's {tuple(x.shape)}")
    dy = dy.to(torch.float32).contiguous(memory_format=torch.channels_last if last else torch.contiguous_format)
    B, C, H, W = x.shape
    dx = torch.empty_like(x)
    dw, db, coef = x.new_empty(C), x.new_empty(C), x.new_empty(3 * C)
    partial = x.new_empty(_lib().batch_norm_scratch(B, C, H * W, int(last)))
    _call("batch_norm_backward", x, dy, x, weight, mean, inv, dx, dw, db, coef, partial, B, C, H * W, int(last))
    batch_norm_backward.launches += 1
    return dx, dw, db


batch_norm_backward.launches = 0


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        y, mean, inv = batch_norm_forward(x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, inv = ctx.saved_tensors
        return (*batch_norm_backward(dy, x, weight, mean, inv), None, None, None, None)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float, eps: float) -> torch.Tensor:
    """BatchNorm in training mode: the plain twin on a CPU tensor, the
    kernels on a CUDA one (f32; the running statistics updated in place)."""
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, weight, bias, running_mean, running_var, momentum, eps)
    return _BatchNorm.apply(x.float(), weight, bias, running_mean, running_var, momentum, eps)


def batch_norm_bytes(elements: int, channels: int) -> Tuple[int, int]:
    """The bytes the forward and the backward must move, each input read once
    and each output written once: x, w, b -> y (and the statistics); dy, x,
    w -> dx, dw, db."""
    return 4 * (2 * elements + 6 * channels), 4 * (3 * elements + 5 * channels)
