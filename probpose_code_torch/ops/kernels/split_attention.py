"""ResNeSt's split attention (radix softmax and weighted sum) as CUDA kernels,
and its plain twin.

Replaces no TPU kernel: the JAX package computes it with XLA's softmax,
product and sum (``probpose_code_tpu/models/backbones/litehrnet.py:
245-247``). By the 2% rule (``PERF.md`` §6) it became a kernel: the forward
and the backward each in one pass over the splits
(``probpose_code_torch/csrc/split_attention.cu``, which says what bounds
them).

``split_attention`` takes CPU tensors to the plain twin (which torch
autograd differentiates) and CUDA tensors to a ``torch.autograd.Function``
whose forward and backward are the kernels; there is no fallback from one to
the other. Each launching function counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_SIGNATURES = {
    "split_attention_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "split_attention_backward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _lib():
    return _build.load("split_attention", _SIGNATURES)


def split_attention_plain(splits: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(B, radix, C, H, W) splits and (B, radix, C) logits -> the splits' sum
    weighted by the softmax of the logits over the radix (sigmoid at radix
    1), (B, C, H, W)."""
    att = torch.softmax(logits, dim=1) if logits.shape[1] > 1 else torch.sigmoid(logits)
    return (splits * att[..., None, None]).sum(dim=1)


def _check(splits: torch.Tensor, logits: torch.Tensor) -> None:
    if splits.device.type != "cuda":
        raise ValueError(f"split_attention: unsupported device {splits.device}")
    if splits.dtype != torch.float32 or logits.dtype != torch.float32 or splits.dim() != 5 \
            or tuple(logits.shape) != tuple(splits.shape[:3]) or not 1 <= splits.shape[1] <= 4:
        raise ValueError(f"split_attention: expected float32 (B, R, C, H, W) splits with R <= 4 and (B, R, C) "
                         f"logits, got {splits.dtype} {tuple(splits.shape)} and {logits.dtype} "
                         f"{tuple(logits.shape)}")


def _sizes(splits: torch.Tensor):
    B, R, C, H, W = splits.shape
    return B, R, C, H * W


def split_attention_forward(splits: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The forward launch on CUDA tensors: the weighted sum (B, C, H, W)."""
    _check(splits, logits)
    splits, logits = splits.contiguous(), logits.contiguous()
    B, R, C, H, W = splits.shape
    out = torch.empty((B, C, H, W), device=splits.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(splits.device):
        code = lib.split_attention_forward(splits.data_ptr(), logits.data_ptr(), out.data_ptr(), *_sizes(splits),
                                           _build.stream_of(splits))
    _build.check(lib, "split_attention", code)
    split_attention_forward.launches += 1
    return out


split_attention_forward.launches = 0


def split_attention_backward(dy: torch.Tensor, splits: torch.Tensor,
                             logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward launch on CUDA tensors: the gradients of the splits and
    of the logits from the output's ``dy``."""
    _check(splits, logits)
    B, R, C, H, W = splits.shape
    if tuple(dy.shape) != (B, C, H, W):
        raise ValueError(f"split_attention: the gradient's shape {tuple(dy.shape)} is not the output's "
                         f"{(B, C, H, W)}")
    dy, splits, logits = dy.to(torch.float32).contiguous(), splits.contiguous(), logits.contiguous()
    dsplits, dlogits = torch.empty_like(splits), torch.empty_like(logits)
    lib = _lib()
    with torch.cuda.device(splits.device):
        code = lib.split_attention_backward(dy.data_ptr(), splits.data_ptr(), logits.data_ptr(), dsplits.data_ptr(),
                                            dlogits.data_ptr(), *_sizes(splits), _build.stream_of(splits))
    _build.check(lib, "split_attention", code)
    split_attention_backward.launches += 1
    return dsplits, dlogits


split_attention_backward.launches = 0


class _SplitAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, splits, logits):
        ctx.save_for_backward(splits, logits)
        return split_attention_forward(splits, logits)

    @staticmethod
    def backward(ctx, dy):
        return split_attention_backward(dy, *ctx.saved_tensors)


def split_attention(splits: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The split attention: the plain twin on CPU tensors, the kernels on
    CUDA ones."""
    if splits.device.type == "cpu":
        return split_attention_plain(splits, logits)
    return _SplitAttention.apply(splits, logits)


def split_attention_bytes(elements: int, radix: int, logits: int):
    """The bytes the forward and the backward must move, each input read once
    and each output written once: the splits and the logits -> out; dy, the
    splits and the logits -> their gradients (``elements`` the output's
    size)."""
    return 4 * ((radix + 1) * elements + logits), 4 * ((2 * radix + 1) * elements + 2 * logits)
