"""``AdaptiveWingLoss`` over heatmaps as CUDA kernels, and its plain twin.

Replaces no TPU kernel: the JAX package computes the loss with XLA's
elementwise operations (``probpose_code_tpu/models/losses/heatmap_loss.py:
121-157``). In PyTorch the loss and its backward over HRNetV2-w18's WFLW
maps (64 x 98 x 64 x 64) took 1.96% of that step's device time (H100 80GB
HBM3, 700 W), at the 2% bar, so the source ``probpose_code_torch/csrc/
adaptive_wing.cu`` computes each in one pass; it says what bounds them.

``adaptive_wing_loss`` takes CPU tensors to the plain twin (which torch
autograd differentiates) and CUDA tensors to a ``torch.autograd.Function``
whose forward and backward are the kernels; there is no fallback from one
to the other. Each launching function counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_SIGNATURES = {
    "adaptive_wing_forward": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 5
    + [ctypes.c_void_p],
    "adaptive_wing_backward": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 5
    + [ctypes.c_void_p],
    "adaptive_wing_partials": ([], ctypes.c_int),
}


def _lib():
    return _build.load("adaptive_wing", _SIGNATURES)


def adaptive_wing_loss_plain(output: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor],
                             alpha: float, omega: float, epsilon: float, theta: float,
                             loss_weight: float) -> torch.Tensor:
    """The loss in PyTorch (``heatmap_loss.py:139-157``): (B, K, H, W) maps,
    (B, K) weights or None; the weighted mean times ``loss_weight``."""
    delta = (output - target).abs()
    a_minus_y = alpha - target
    ratio = theta / epsilon
    A = omega * (1 / (1 + torch.pow(ratio, a_minus_y))) * a_minus_y * torch.pow(ratio, a_minus_y - 1) / epsilon
    C = theta * A - omega * torch.log1p(torch.pow(ratio, a_minus_y))
    small = omega * torch.log1p((delta / epsilon) ** a_minus_y)
    loss = torch.where(delta < theta, small, A * delta - C)
    if weights is not None:
        w = weights
        while w.dim() < loss.dim():
            w = w[..., None]
        loss = loss * w
    return loss.mean() * loss_weight


def _check(output: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor]) -> None:
    if output.device.type != "cuda":
        raise ValueError(f"adaptive_wing: unsupported device {output.device}")
    if output.dtype != torch.float32 or target.dtype != torch.float32 or output.shape != target.shape \
            or output.dim() < 3:
        raise ValueError(f"adaptive_wing: expected float32 maps of one shape, got {output.dtype} "
                         f"{tuple(output.shape)} and {target.dtype} {tuple(target.shape)}")
    if weights is not None and (weights.dtype != torch.float32 or tuple(weights.shape) != tuple(output.shape[:2])):
        raise ValueError(f"adaptive_wing: expected float32 {tuple(output.shape[:2])} weights, got {weights.dtype} "
                         f"{tuple(weights.shape)}")


def _args(output, target, weights, params):
    n = output.shape[0] * output.shape[1]
    return (output.data_ptr(), target.data_ptr(), weights.data_ptr() if weights is not None else None), \
        (n, output.numel() // n, *params)


def adaptive_wing_forward(output: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor],
                          params) -> torch.Tensor:
    """The forward launch on CUDA tensors: the loss, a 0-d tensor.
    ``params``: alpha, omega, epsilon, theta, loss_weight."""
    _check(output, target, weights)
    output, target = output.contiguous(), target.contiguous()
    weights = weights.contiguous() if weights is not None else None
    lib = _lib()
    partial = torch.empty(lib.adaptive_wing_partials(), device=output.device, dtype=torch.float32)
    loss = torch.empty((), device=output.device, dtype=torch.float32)
    pointers, sizes = _args(output, target, weights, params)
    with torch.cuda.device(output.device):
        code = lib.adaptive_wing_forward(*pointers, partial.data_ptr(), loss.data_ptr(), *sizes,
                                         _build.stream_of(output))
    _build.check(lib, "adaptive_wing", code)
    adaptive_wing_forward.launches += 1
    return loss


adaptive_wing_forward.launches = 0


def adaptive_wing_backward(dloss: torch.Tensor, output: torch.Tensor, target: torch.Tensor,
                           weights: Optional[torch.Tensor], params) -> torch.Tensor:
    """The backward launch on CUDA tensors: the output's gradient from the
    loss's upstream gradient ``dloss`` (a 0-d tensor, read on the card)."""
    _check(output, target, weights)
    output, target = output.contiguous(), target.contiguous()
    weights = weights.contiguous() if weights is not None else None
    dloss = dloss.to(torch.float32).reshape(()).contiguous()
    grad = torch.empty_like(output)
    lib = _lib()
    pointers, sizes = _args(output, target, weights, params)
    with torch.cuda.device(output.device):
        code = lib.adaptive_wing_backward(*pointers, dloss.data_ptr(), grad.data_ptr(), *sizes,
                                          _build.stream_of(output))
    _build.check(lib, "adaptive_wing", code)
    adaptive_wing_backward.launches += 1
    return grad


adaptive_wing_backward.launches = 0


class _AdaptiveWing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, output, target, weights, params):
        ctx.save_for_backward(output, target, weights)
        ctx.params = params
        return adaptive_wing_forward(output, target, weights, params)

    @staticmethod
    def backward(ctx, dloss):
        output, target, weights = ctx.saved_tensors
        return adaptive_wing_backward(dloss, output, target, weights, ctx.params), None, None, None


def adaptive_wing_loss(output: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor], alpha: float,
                       omega: float, epsilon: float, theta: float, loss_weight: float) -> torch.Tensor:
    """The loss: the plain twin on CPU tensors, the kernels on CUDA ones
    (the target and the weights take no gradient)."""
    if output.device.type == "cpu":
        return adaptive_wing_loss_plain(output, target, weights, alpha, omega, epsilon, theta, loss_weight)
    params = tuple(float(v) for v in (alpha, omega, epsilon, theta, loss_weight))
    return _AdaptiveWing.apply(output, target.detach(), None if weights is None else weights.detach(), params)


def adaptive_wing_bytes(elements: int, maps: int, weighted: bool):
    """The bytes the forward and the backward must move, each input read
    once and each output written once: output, target (and weights) -> the
    loss; output, target (and weights), the upstream scalar -> the gradient."""
    w = 4 * maps if weighted else 0
    return 8 * elements + w + 4, 8 * elements + w + 4 + 4 * elements
